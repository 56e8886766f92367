"""caption_s.stream: mean seconds of the benchmark's span around each
captioner call (prefill and 128 decode steps of a chunk-40 caption) in the
untraced window."""


def read(ctx):
    spans = ctx.spans("caption")
    return sum(s["t1"] - s["t0"] for s in spans) / len(spans) if spans else None
