"""ingest_host_ms.stream: per segment of the untraced window, the host's
time in ingest before the encoder: the wait on the reader's frames and the
padding, host-to-device copy and preprocessing launches (the program's
`ingest.read` and `ingest.upload` spans, host clock); the mean, in ms."""


def _spans(ctx):
    """The program's spans that started in the untraced window's requests,
    or None: a program without the recorder, or a ring that dropped any."""
    try:
        from streamchat_tpu_torch.utils import profiling

        read, intact = profiling.spans, profiling.intact_since
    except (ImportError, AttributeError):
        return None
    bounds = [(int(u.t0 * 1e9), int(u.t1 * 1e9)) for u in ctx.units()]
    if not bounds or not intact(min(b[0] for b in bounds)):
        return None
    return [s for s in read(min(b[0] for b in bounds), max(b[1] for b in bounds))
            if any(t0 <= s.start_ns < t1 for t0, t1 in bounds)]


def read(ctx):
    spans = _spans(ctx)
    segments = [u for u in ctx.units() if u.kind == "segment"]
    if spans is None or not segments:
        return None
    host = sum(s.end_ns - s.start_ns for s in spans if s.name in ("ingest.read", "ingest.upload"))
    return host / len(segments) / 1e6
