"""first_token_ms.qa: per generate call of the untraced window's answers,
the time from its start (the program's `generate` span) to the end of its
first decode step's readback (the first `decode.readback` span under it:
the first sampled token is on the host side of the card then), host clock;
the mean, in ms."""


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
    by_id = {s.id: s for s in spans}
    first = {}
    for s in spans:
        if s.name != "decode.readback":
            continue
        up = by_id.get(s.parent)
        while up is not None and up.name != "generate":
            up = by_id.get(up.parent)
        if up is not None:
            first[up.id] = min(first.get(up.id, s.end_ns), s.end_ns)
    firsts = [end - by_id[g].start_ns for g, end in first.items()]
    return sum(firsts) / len(firsts) / 1e6 if firsts else None
