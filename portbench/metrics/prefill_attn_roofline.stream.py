"""prefill_attn_roofline.stream: the decoder's prefill attention kernels
(K3 and K5, `csrc/flash_prefill.cu` at head size 128) against their bound:
the causal attention FLOPs of the traced window's prefills, counted from
their prompt lengths (portbench/counts.py) at the bf16 peak, over the
kernels' device seconds in the trace, in %."""

from portbench import counts

KERNELS = r"flash_prefill_kernel<128\b"


def read(ctx):
    if ctx.trace is None:
        return None
    secs, n = ctx.trace.kernel_seconds(KERNELS)
    flops = sum(counts.attention_flops(ctx.cfg, c["seq_len"], 0) for c in ctx.calls(traced=True))
    if not n or secs <= 0 or flops <= 0:
        return None
    return 100.0 * flops / counts.PEAK_FLOPS / secs
