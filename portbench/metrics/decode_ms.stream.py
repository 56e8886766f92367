"""decode_ms: the program's `gen_stats` over the untraced window's generate
calls: decode seconds over decode steps, in ms (one row a step)."""


def read(ctx):
    calls = ctx.calls()
    steps = sum(c["steps"] for c in calls)
    return 1e3 * sum(c["decode_s"] for c in calls) / steps if steps else None
