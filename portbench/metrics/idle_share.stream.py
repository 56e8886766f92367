"""idle_share: 100 x (1 - the union of device-busy intervals over the
traced window's length), from the profiler's trace."""


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
