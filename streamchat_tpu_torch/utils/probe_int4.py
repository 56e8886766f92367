"""The int4 GEMV probe (K15) on the card.

Counterpart of `scripts/probe_int4_kernel.py`, the TPU probe that split the
int4 GEMV's time (K10) into DMA, casts, bit operations and dots over the 7B
MLP-up shape (x [1, 3584] bf16, packed w [3584, 9472], scale [28, 2, 9472]
-> y [1, 18944] f32).

    python -m streamchat_tpu_torch.utils.probe_int4

`matvec(x, w_i4p, scale, variant, block_out, gpb)` launches
`csrc/int4_probe.cu`. `block_out` (a multiple of 128, at most 2048) and
`gpb` keep the TPU probe's meaning: its block of packed columns, and the
k-slices of `gpb` groups of 128 rows whose partial sums it kept. The card's
grid (`card_grid`) follows neither: 128-packed-column sub-tiles of each
k-slice, each slice split into a cluster of row ranges until two waves of
the H100's 132 SMs are busy. Variants:
dma (every packed byte loaded, y_lo = the sum over k-slices of each slice's
first n rows as signed bytes, y_hi = 0), cast (bytes as signed values, no
bit operations; lo and hi are the same dot under the two scales), cur (K10's
unpack), xor32 (one xor, then lo = d_u - 8 sum(x_g), hi = (d_b - d_u) / 16)
and xor8 (the xor32 algebra on the four bytes of a 32-bit word at once).
`matvec_plain` is the twin of every variant.

`main` runs the five variants at block_out 1024, gpb 16, prints cur's time
over dma's (the unpack's cost over the bytes' on the card), then the
nine-point sweep {512, 1024, 2048} x {8, 16, 32} on the fastest of cur,
xor32 and xor8, and prints per point the card blocks and the device time
per call
(torch.profiler, over calls that rotate through three weight copies so one
call's 34 MB of packed bytes are not in the 50 MB L2 from the call before),
the effective GB/s of the packed bytes and, for cur / xor32 / xor8, the
largest error against the dequantized matmul relative to its largest
output. Weights are random from a seed. Needs a CUDA device. K10 itself is
not changed here.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess

import torch

from streamchat_tpu_torch.kernels import counted, launched
from streamchat_tpu_torch.ops import quant
from streamchat_tpu_torch.ops.fused_vit import _check_cuda, _stream

GROUP = 128
DIN, DOUT = 3584, 18944
VARIANTS = ("dma", "cast", "cur", "xor32", "xor8")
UNPACKS = ("cur", "xor32", "xor8")
SWEEP = tuple((bo, gpb) for gpb in (8, 16, 32) for bo in (512, 1024, 2048))
# The card's grid (csrc/int4_probe.cu): packed columns per block, the blocks
# that keep two waves of the H100's 132 SMs busy, the largest cluster.
SUB, TARGET_BLOCKS, MAX_CLUSTER = 128, 2 * 132, 8
# Any value: the dma variant stores a flag (never read) when the xor of its
# loaded words equals it, which keeps every load in the compiled kernel.
_SENTINEL = 0x9E3779B9
_WEIGHT_COPIES = 3


def _geometry(w_i4p, scale, variant, block_out, gpb):
    """The TPU probe's clamps (block_out to the padded width, gpb to the
    group count) -> (block_out, gpb, k-slices); raises on a bad option."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: expected one of {VARIANTS}")
    if block_out % 128 or not 128 <= block_out <= 2048 or gpb < 1:
        raise ValueError(f"block_out {block_out} (a multiple of 128, at most 2048), "
                         f"gpb {gpb} (at least 1)")
    oh, groups = w_i4p.shape[1], scale.shape[0]
    gpb = min(gpb, groups)
    return min(block_out, -(-oh // 128) * 128), gpb, -(-groups // gpb)


def card_grid(oh: int, groups: int, gpb: int) -> dict:
    """The card's grid for a packed width `oh`, `groups` groups and `gpb`
    groups per k-slice (clamped as `_geometry` clamps it), as
    `sc_int4_probe` computes it: `tiles` sub-tiles of SUB packed columns,
    `slices` k-slices, each cut into `cluster` row ranges of
    `groups_per_range` whole groups (the last ones may be short or empty),
    `blocks` = tiles x cluster x slices."""
    gpb = min(gpb, groups)
    tiles, slices = -(-oh // SUB), -(-groups // gpb)
    c = 1
    while c < MAX_CLUSTER and 2 * c <= gpb and tiles * slices * c < TARGET_BLOCKS:
        c *= 2
    return dict(tiles=tiles, slices=slices, cluster=c, groups_per_range=-(-gpb // c),
                blocks=tiles * c * slices)


def card_blocks(oh: int, groups: int, gpb: int):
    """Every card block of `card_grid` -> [(slice, packed columns (start,
    stop), groups (start, stop))], in launch order (the cluster's ranks
    fastest)."""
    grid = card_grid(oh, groups, gpb)
    gpb, q = min(gpb, groups), grid["groups_per_range"]
    out = []
    for sl in range(grid["slices"]):
        s0, s1 = sl * gpb, min(groups, (sl + 1) * gpb)
        for t in range(grid["tiles"]):
            for rank in range(grid["cluster"]):
                g0 = min(s1, s0 + rank * q)
                out.append((sl, (t * SUB, min(oh, (t + 1) * SUB)), (g0, min(s1, g0 + q))))
    return out


def matvec_plain(x, w_i4p, scale, variant="cur", block_out=1024, gpb=16):
    """Plain PyTorch twin of `matvec` (same signature): the TPU probe's
    `make_kernel` arithmetic in f32, groups past the last skipped."""
    _, gpb, nk = _geometry(w_i4p, scale, variant, block_out, gpb)
    n, kin = x.shape
    oh, groups = w_i4p.shape[1], scale.shape[0]
    b = w_i4p.to(torch.int32)
    if variant == "dma":
        rows = (torch.arange(nk, device=b.device)[:, None] * gpb * GROUP
                + torch.arange(n, device=b.device)[None, :])
        lo = b[rows.reshape(-1)].reshape(nk, n, oh).sum(0).float()
        return torch.cat([lo, torch.zeros_like(lo)], dim=1)
    if variant == "cur":
        lo, hi = ((b & 0xF) ^ 8) - 8, b >> 4
    elif variant == "cast":
        lo = hi = b
    else:                                   # xor32, xor8: the same values
        u = b ^ 8
        lo, hi = u & 0xF, u
    xg = x.float().reshape(n, groups, kin // groups)
    p_lo = torch.einsum("ngk,gko->ngo", xg, lo.float().reshape(groups, -1, oh))
    p_hi = torch.einsum("ngk,gko->ngo", xg, hi.float().reshape(groups, -1, oh))
    if variant in ("xor32", "xor8"):
        sx = xg.sum(-1, keepdim=True)
        p_lo, p_hi = p_lo - 8.0 * sx, (p_hi - p_lo) * 0.0625
    y_lo = (p_lo * scale[:, 0]).sum(1)
    y_hi = (p_hi * scale[:, 1]).sum(1)
    return torch.cat([y_lo, y_hi], dim=1)


@counted
def matvec(x, w_i4p, scale, variant="cur", block_out=1024, gpb=16):
    """x [n <= 8, in] bf16 @ packed-int4 W -> f32 [n, out], low-nibble
    columns first, through probe variant `variant` (K15).

    CPU tensors run the plain twin; CUDA tensors launch the kernel or
    raise (K10's layout: int8 [in, out/2] with out/2 % 4 == 0, f32 scale
    [in/128, 2, out/2])."""
    if x.device.type == "cpu":
        return matvec_plain(x, w_i4p, scale, variant, block_out, gpb)
    from streamchat_tpu_torch.kernels.build import call

    bo, gpb, nk = _geometry(w_i4p, scale, variant, block_out, gpb)
    n, kin = x.shape
    oh = w_i4p.shape[1]
    if not 1 <= n <= 8 or kin % GROUP or oh % 4:
        raise ValueError(f"matvec: x {tuple(x.shape)} (n <= 8, in % {GROUP} == 0), "
                         f"packed width {oh} (% 4 == 0)")
    _check_cuda("matvec x", x, torch.bfloat16, (n, kin))
    _check_cuda("matvec w_i4p", w_i4p, torch.int8, (kin, oh))
    _check_cuda("matvec scale", scale, torch.float32, (kin // GROUP, 2, oh))
    y = torch.empty(n, 2 * oh, dtype=torch.float32, device=x.device)
    partial = torch.empty(nk, n, 2 * oh, dtype=torch.float32, device=x.device) if nk > 1 else y
    flag = torch.empty(4, dtype=torch.int32, device=x.device)
    call("sc_int4_probe", x.data_ptr(), n, kin, w_i4p.data_ptr(), scale.data_ptr(), oh,
         VARIANTS.index(variant), bo, gpb, nk, partial.data_ptr(), y.data_ptr(), _SENTINEL,
         flag.data_ptr(), _stream())
    launched(matvec, f"{variant} {bo}x{gpb}")
    return y


def attributes(variant: str, n: int = 1, oh: int = DOUT // 2) -> dict:
    """The compiled K15 kernel that `matvec` launches for `variant` at n rows
    and packed width oh: registers and local (spill) bytes per thread,
    static shared bytes, packed columns a thread loads at once."""
    import ctypes

    from streamchat_tpu_torch.kernels.build import library

    out = (ctypes.c_int * 4)()
    err = library().sc_int4_probe_attributes(VARIANTS.index(variant), n, oh, out)
    if err:
        raise RuntimeError(f"sc_int4_probe_attributes: CUDA error {err}")
    return dict(num_regs=out[0], local_bytes=out[1], static_shared_bytes=out[2],
                columns_per_load=out[3])


def make_weights(generator: torch.Generator, copies: int = _WEIGHT_COPIES, device="cuda"):
    """`copies` int4 weights of the probe's shape (N(0, 1) * 0.02, quantized
    as K10's are) -> [(w_i4p, scale)], and the first one dequantized to bf16."""
    qs = []
    for _ in range(copies):
        w = torch.randn(DIN, DOUT, generator=generator, device=device) * 0.02
        qs.append(quant.quantize_weight_int4(w))
        del w
    return [(q["w_i4p"], q["scale"]) for q in qs], quant.dequantize_weight_int4(qs[0])


def packed_gb() -> float:
    return DIN * DOUT / 2 / 1e9


def _rotating(x, weights, **kw):
    it = itertools.cycle(weights)
    return lambda: matvec(x, *next(it), **kw)


def bench(x, weights, variant, block_out, gpb, iters=50) -> float:
    """Device ms per call, rotating through the weight copies."""
    from streamchat_tpu_torch.utils.profiling import device_ms

    return device_ms(_rotating(x, weights, variant=variant, block_out=block_out, gpb=gpb),
                     iters)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_int4: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    weights, wd = make_weights(g)
    x = torch.randn(1, DIN, generator=g, device="cuda").to(torch.bfloat16)
    ref = x.float() @ wd.float()
    del wd
    results = {"variants": {}, "sweep": []}
    for variant in VARIANTS:
        rel = None
        if variant in UNPACKS:
            got = matvec(x, *weights[0], variant=variant)
            rel = ((got - ref).abs().max() / ref.abs().max()).item()
        ms = bench(x, weights, variant, 1024, 16, args.iters)
        row = {"variant": variant, "ms": ms, "eff_gbps": packed_gb() / ms * 1e3,
               "max_rel_err": rel, "blocks": card_grid(DOUT // 2, DIN // GROUP, 16)["blocks"]}
        results["variants"][variant] = row
        print(json.dumps(row), flush=True)
    results["dma_to_cur"] = results["variants"]["cur"]["ms"] / results["variants"]["dma"]["ms"]
    print(json.dumps({"dma_to_cur": results["dma_to_cur"]}), flush=True)
    best = min(UNPACKS, key=lambda v: results["variants"][v]["ms"])
    results["sweep_variant"] = best
    print(json.dumps({"sweep_variant": best}), flush=True)
    for bo, gpb in SWEEP:
        ms = bench(x, weights, best, bo, gpb, args.iters)
        row = {"gpb": gpb, "bo": bo, "ms": ms, "eff_gbps": packed_gb() / ms * 1e3,
               "blocks": card_grid(DOUT // 2, DIN // GROUP, gpb)["blocks"]}
        results["sweep"].append(row)
        print(json.dumps(row), flush=True)
    return results


if __name__ == "__main__":
    main()
