"""memory_self_ms.stream: per segment of the untraced window, the memory
update's own time: its `memory.update` span less the time its
`memory.caption` and `memory.summarize` descendants cover (the short
memory, chunking and k-means, the tree's embedding and bookkeeping, the
offload), host clock; the mean, in ms."""


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
    updates = {s.id: s.end_ns - s.start_ns for s in spans if s.name == "memory.update"}
    if not updates:
        return None
    for s in spans:
        if s.name not in ("memory.caption", "memory.summarize"):
            continue
        up = by_id.get(s.parent)
        while up is not None and up.name != "memory.update":
            up = by_id.get(up.parent)
        if up is not None:
            updates[up.id] -= s.end_ns - s.start_ns
    return sum(updates.values()) / len(updates) / 1e6
