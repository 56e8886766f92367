"""step_launch_ms.qa: the host's time in each decode step's launch: the graph's
replay call, or the eager step (the program's `decode.replay` spans, host
clock), summed over the untraced window's decode steps (`decode.step` spans)
and divided by their number, in ms."""


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
    if spans is None:
        return None
    steps = sum(1 for s in spans if s.name == "decode.step")
    part = sum(s.end_ns - s.start_ns for s in spans if s.name == "decode.replay")
    return part / steps / 1e6 if steps else None
