"""int4 weight-only GEMV (K10) and its fused multi-weight form (K11), with
their plain twins (`streamchat_tpu/ops/int4_matmul.py`).

Layout (ops/quant.quantize_weight_int4): w_i4p [in, out/2] int8 holds
w[i, j] in the low nibble and w[i, j + out/2] in the high nibble of byte
(i, j); scale [in/128, 2, out/2] f32. Both kernels compute the TPU kernels'
semantics: y[n, :] = sum_g scale[g] * (x[n, group g] @ w[group g]) in f32,
each group's partial scaled before it accumulates. (The JAX package's CPU
path dequantizes to the input dtype and runs one matmul instead; the port's
CPU decode keeps that path, `ops/quant.qmatmul_int4`.)

A CUDA tensor launches `csrc/int4_gemv.cu` (x bf16, at most 8 rows) or
raises; a CPU tensor runs the plain twin. `launch_plan` counts the kernel's
grid from the shapes alone and raises ValueError for a shape it does not
take, before any launch; `plan_blocks` lists its blocks and their warps.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from streamchat_tpu_torch.kernels import counted, launched
from streamchat_tpu_torch.ops.quant import MAX_KERNEL_ROWS, unpack_int4

GROUP = 128
# The kernel's geometry (csrc/int4_gemv.cu): a block covers TILE_PACKED
# packed columns (a warp's 8 lane groups x 8) over a range of whole groups,
# cut among its WARPS warps; a tile's ranges form one thread-block cluster
# of at most MAX_CLUSTER blocks; RESIDENT_BLOCKS blocks fit an SM of the
# H100's SMS when every width is a multiple of 16 (16-byte copies), else
# RESIDENT_NARROW.
TILE_PACKED, WARPS, MAX_CLUSTER = 64, 4, 8
SMS, RESIDENT_BLOCKS, RESIDENT_NARROW = 132, 4, 3


class Plan(NamedTuple):
    """A K10/K11 launch: `tiles` column tiles a part, each tile's groups cut
    into `cluster` ranges (one block each), `blocks` = sum(tiles) x
    cluster, `wave` the blocks the card holds at once."""
    groups: int
    widths: Tuple[int, ...]
    tiles: Tuple[int, ...]
    cluster: int
    blocks: int
    wave: int


@functools.lru_cache(maxsize=512)
def launch_plan(n: int, kin: int, widths: Tuple[int, ...]) -> Plan:
    """The grid of one K10/K11 launch of x [n, kin] against parts of packed
    widths `widths` (out_p / 2), as `sc_int4_gemv` runs it: each part's
    packed columns cut into TILE_PACKED-column tiles, each tile's groups
    into `cluster` near-equal ranges (range r holds groups [r G / C,
    (r + 1) G / C)), one block each; `cluster` is the largest power of two
    <= MAX_CLUSTER and <= G whose blocks stay within one resident wave
    (RESIDENT_BLOCKS or, for a width not a multiple of 16, RESIDENT_NARROW
    blocks on each of the SMS).
    Raises ValueError for a shape the kernel does not take: n outside 1..8,
    kin not a positive multiple of 128, no part or more than three, or a
    width not a positive multiple of 4."""
    widths = tuple(int(w) for w in widths)
    if not 1 <= n <= MAX_KERNEL_ROWS:
        raise ValueError(f"int4 GEMV: {n} rows, the kernel takes 1..{MAX_KERNEL_ROWS}")
    if kin <= 0 or kin % GROUP:
        raise ValueError(f"int4 GEMV: in = {kin}, expected a positive multiple of {GROUP}")
    if not 1 <= len(widths) <= 3 or any(w <= 0 or w % 4 for w in widths):
        raise ValueError(f"int4 GEMV: packed widths {widths}, expected 1-3 positive "
                         f"multiples of 4 (out / 2)")
    groups = kin // GROUP
    wave = SMS * (RESIDENT_BLOCKS if all(w % 16 == 0 for w in widths) else RESIDENT_NARROW)
    tiles = tuple(-(-w // TILE_PACKED) for w in widths)
    c = 1
    while 2 * c <= min(MAX_CLUSTER, groups) and 2 * c * sum(tiles) <= wave:
        c *= 2
    return Plan(groups, widths, tiles, c, sum(tiles) * c, wave)


def plan_blocks(n: int, kin: int, widths: Tuple[int, ...]):
    """Every block of `launch_plan`, in launch order (a tile's cluster ranks
    fastest) -> [(part, (first, end) packed columns, (first, end) groups,
    ((first, end) groups of each warp, ...))]."""
    plan = launch_plan(n, kin, widths)
    c, g = plan.cluster, plan.groups
    out = []
    for part, (width, tiles) in enumerate(zip(plan.widths, plan.tiles)):
        for t in range(tiles):
            cols = (t * TILE_PACKED, min(width, (t + 1) * TILE_PACKED))
            for rank in range(c):
                g0, g1 = rank * g // c, (rank + 1) * g // c
                warps = tuple((g0 + w * (g1 - g0) // WARPS, g0 + (w + 1) * (g1 - g0) // WARPS)
                              for w in range(WARPS))
                out.append((part, cols, (g0, g1), warps))
    return out


def qmatvec_int4_plain(x, w_i4p, scale, out_dtype=torch.float32):
    """Plain twin of `qmatvec_int4` (same signature): per-group f32 partials
    of x [N, in] against the unpacked weight, each scaled, then summed."""
    n, kin = x.shape
    g = scale.shape[0]
    out = 2 * w_i4p.shape[1]
    w = unpack_int4(w_i4p).float().reshape(g, kin // g, out)
    part = torch.einsum("ngk,gko->ngo", x.float().reshape(n, g, kin // g), w)
    return (part * scale.reshape(g, out)).sum(1).to(out_dtype)


def qmatvec_int4_fused_plain(x, *flat, out_dtype=torch.float32):
    """Plain twin of `qmatvec_int4_fused`: one `qmatvec_int4_plain` per part."""
    return tuple(qmatvec_int4_plain(x, flat[i], flat[i + 1], out_dtype)
                 for i in range(0, len(flat), 2))


def _check(x, parts, out_dtype, name) -> Plan:
    """Device, dtype and layout checks, then the launch plan (which checks
    the shapes) -> the plan."""
    if (x.device.type != "cuda" or x.dtype != torch.bfloat16 or x.dim() != 2
            or not x.is_contiguous() or x.data_ptr() % 16
            or out_dtype not in (torch.bfloat16, torch.float32)):
        raise ValueError(f"{name}: expected contiguous, 16-byte aligned CUDA bf16 x [N, in], "
                         f"got {x.device} {x.dtype} {tuple(x.shape)}, out {out_dtype}")
    n, kin = x.shape
    for w, s in parts:
        oh = w.shape[1] if w.dim() == 2 else -1
        if (w.device != x.device or w.dtype != torch.int8 or not w.is_contiguous()
                or w.shape[0] != kin or w.data_ptr() % 4 or s.data_ptr() % 4
                or s.device != x.device or s.dtype != torch.float32
                or not s.is_contiguous() or tuple(s.shape) != (kin // GROUP, 2, oh)):
            raise ValueError(f"{name}: part w {w.dtype} {tuple(w.shape)}, scale "
                             f"{s.dtype} {tuple(s.shape)} does not fit x "
                             f"{tuple(x.shape)} (int8 [in, out/2], 4-byte aligned, "
                             f"f32 [in/{GROUP}, 2, out/2], contiguous, on x's device)")
    return launch_plan(n, kin, tuple(w.shape[1] for w, _ in parts))


def _launch(x, parts, out_dtype, plan: Plan):
    """One K10/K11 launch -> y [N, sum out_p] in out_dtype."""
    from streamchat_tpu_torch.kernels.build import call

    n, kin = x.shape
    y = torch.empty(n, 2 * sum(plan.widths), dtype=out_dtype, device=x.device)
    args = []
    for i in range(3):
        if i < len(parts):
            w, s = parts[i]
            args += [w.data_ptr(), s.data_ptr(), w.shape[1]]
        else:
            args += [None, None, 0]
    call("sc_int4_gemv", x.data_ptr(), n, kin, len(parts), *args, plan.cluster,
         y.data_ptr(), int(out_dtype == torch.float32), torch.cuda.current_stream().cuda_stream)
    return y


def attributes(wide: bool = True) -> dict:
    """The compiled kernel's registers, spill bytes, shared bytes a block and
    resident blocks an SM, for its 16-byte (`wide`: every width a multiple
    of 16) or 4-byte copy instance (`sc_int4_gemv_attributes`)."""
    import ctypes

    from streamchat_tpu_torch.kernels.build import call

    out = (ctypes.c_int * 4)()
    call("sc_int4_gemv_attributes", int(wide), out)
    return dict(registers=out[0], spill_bytes=out[1], shared_bytes=out[2],
                blocks_per_sm=out[3])


@counted
def qmatvec_int4(x, w_i4p, scale, out_dtype=torch.float32):
    """x [N <= 8, in] bf16 @ packed-int4 W -> [N, out] in out_dtype (K10)."""
    if x.device.type == "cpu":
        return qmatvec_int4_plain(x, w_i4p, scale, out_dtype)
    plan = _check(x, [(w_i4p, scale)], out_dtype, "qmatvec_int4")
    y = _launch(x, [(w_i4p, scale)], out_dtype, plan)
    launched(qmatvec_int4)
    return y


@counted
def qmatvec_int4_fused(x, *flat, out_dtype=torch.float32):
    """x @ W_p for 2-3 packed-int4 weights sharing x, ONE launch (K11).

    flat = (w0, s0, w1, s1[, w2, s2]) -> one [N, out_p] tensor per part
    (column views of one [N, sum out_p] output)."""
    if x.device.type == "cpu":
        return qmatvec_int4_fused_plain(x, *flat, out_dtype=out_dtype)
    parts = [(flat[i], flat[i + 1]) for i in range(0, len(flat), 2)]
    if len(flat) % 2 or not 2 <= len(parts) <= 3:
        raise ValueError(f"qmatvec_int4_fused: expected 2-3 (w, scale) parts, got "
                         f"{len(flat)} tensors")
    plan = _check(x, parts, out_dtype, "qmatvec_int4_fused")
    y = _launch(x, parts, out_dtype, plan)
    launched(qmatvec_int4_fused)
    outs, off = [], 0
    for w, _ in parts:
        outs.append(y[:, off:off + 2 * w.shape[1]])
        off += 2 * w.shape[1]
    return tuple(outs)
