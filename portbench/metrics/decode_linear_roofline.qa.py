"""decode_linear_roofline.qa: the kernels that serve the decoder's
projections and head at decode (W8, `csrc/w8a16_gemv.cu`; K10 / K11,
`csrc/int4_gemv.cu`) against their bound: the bytes the configuration's
stored weights and scales, biases and activations need once a decode step
(and the head once a prefill), at the memory rate, over those kernels'
device seconds in the traced window, in %."""

from portbench import counts

KERNELS = r"w8a16_kernel|splitk_reduce_kernel|int4_gemv_kernel"


def read(ctx):
    if ctx.trace is None or ctx.bits not in (4, 8):
        return None
    secs, n = ctx.trace.kernel_seconds(KERNELS)
    calls = ctx.calls(traced=True)
    nbytes = sum(c["steps"] * counts.decode_linear_bytes(ctx.cfg, ctx.bits)
                 + counts.head_bytes(ctx.cfg, ctx.bits) for c in calls)
    if not n or secs <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / counts.PEAK_BYTES / secs
