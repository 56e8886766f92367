"""memory_fps: sampled frames whose segment (ingest and memory update)
finished in the untraced window, over the window's seconds (host clock,
whole segments)."""


def read(ctx):
    segments = [u for u in ctx.units() if u.kind == "segment"]
    return sum(u.frames for u in segments) / ctx.window.seconds if segments else None
