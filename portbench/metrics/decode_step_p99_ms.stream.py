"""decode_step_p99_ms.stream: the 99th percentile (nearest rank) of the
untraced window's decode step durations (the program's `decode.step`
spans, host clock: allocator, launch, readback and the loop's own time), in
ms; nothing under MIN_STEPS steps, so that at least ten lie beyond it."""

import math

MIN_STEPS = 1000


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
    steps = sorted(s.end_ns - s.start_ns for s in spans if s.name == "decode.step")
    if len(steps) < MIN_STEPS:
        return None
    return steps[math.ceil(0.99 * len(steps)) - 1] / 1e6
