"""mfu: the whole step's share of the card's peak. Over the untraced
window: the sum of each model step's least time (ViT batches, prefills,
decode steps; portbench/counts.py, from shapes) over the window's seconds,
in %."""

from portbench import counts


def read(ctx):
    cfg, bits, kv = ctx.cfg, ctx.bits, ctx.kv_int8
    total = 0.0
    for u in ctx.units():
        if u.frames:
            total += counts.least_time(*counts.vit_batch(cfg, u.frames))
    for c in ctx.calls():
        total += counts.least_time(*counts.prefill(cfg, bits, kv, c["seq_len"]))
        for j in range(c["steps"]):
            total += counts.least_time(*counts.decode_step(cfg, bits, kv, c["seq_len"] + j + 1))
    return 100.0 * total / ctx.window.seconds if total > 0 else None
