"""ingest_fps.stream: frames over the seconds of the benchmark's spans
around `pipeline/ingest.encode_segment` (each ending in a device
synchronize), over the untraced window's segments."""


def read(ctx):
    spans = ctx.spans("ingest")
    busy = sum(s["t1"] - s["t0"] for s in spans)
    return sum(u.frames for u in ctx.units()) / busy if spans and busy > 0 else None
