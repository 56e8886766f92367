"""int4 weight-only GEMV (K10) and its fused multi-weight form (K11), with
their plain twins (`streamchat_tpu/ops/int4_matmul.py`).

Layout (ops/quant.quantize_weight_int4): w_i4p [in, out/2] int8 holds
w[i, j] in the low nibble and w[i, j + out/2] in the high nibble of byte
(i, j); scale [in/128, 2, out/2] f32. Both kernels compute the TPU kernels'
semantics: y[n, :] = sum_g scale[g] * (x[n, group g] @ w[group g]) in f32,
each group's partial scaled before it accumulates. (The JAX package's CPU
path dequantizes to the input dtype and runs one matmul instead; the port's
CPU decode keeps that path, `ops/quant.qmatmul_int4`.)

A CUDA tensor launches `csrc/int4_gemv.cu` (x bf16, at most 8 rows); a CPU
tensor runs the plain twin.
"""

from __future__ import annotations

import torch

from streamchat_tpu_torch.kernels import counted, launched
from streamchat_tpu_torch.ops.quant import MAX_KERNEL_ROWS, TARGET_BLOCKS, unpack_int4

GROUP = 128
# Packed columns one block covers (32 lanes x 4 bytes).
TILE_PACKED = 128


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


def _check(x, parts, out_dtype, name):
    n, kin = x.shape
    if (x.device.type != "cuda" or x.dtype != torch.bfloat16 or not x.is_contiguous()
            or not 1 <= n <= MAX_KERNEL_ROWS or kin % GROUP
            or out_dtype not in (torch.bfloat16, torch.float32)):
        raise ValueError(f"{name}: expected contiguous CUDA bf16 x [N <= "
                         f"{MAX_KERNEL_ROWS}, in % {GROUP} == 0], got {x.device} "
                         f"{x.dtype} {tuple(x.shape)}, out {out_dtype}")
    for w, s in parts:
        oh = w.shape[1] if w.dim() == 2 else -1
        if (w.device != x.device or w.dtype != torch.int8 or not w.is_contiguous()
                or w.shape[0] != kin or oh % 4 or w.data_ptr() % 4
                or s.device != x.device or s.dtype != torch.float32
                or not s.is_contiguous() or tuple(s.shape) != (kin // GROUP, 2, oh)):
            raise ValueError(f"{name}: part w {w.dtype} {tuple(w.shape)}, scale "
                             f"{s.dtype} {tuple(s.shape)} does not fit x "
                             f"{tuple(x.shape)} (int8 [in, out/2] with out/2 % 4 == 0, "
                             f"f32 [in/{GROUP}, 2, out/2], contiguous, on x's device)")


def _launch(x, parts, out_dtype):
    """One K10/K11 launch -> y [N, sum out_p] in out_dtype."""
    from streamchat_tpu_torch.kernels.build import call

    n, kin = x.shape
    groups = kin // GROUP
    tiles = sum(-(-w.shape[1] // TILE_PACKED) for w, _ in parts)
    cols = sum(2 * w.shape[1] for w, _ in parts)
    per_slice = -(-groups // min(groups, -(-TARGET_BLOCKS // tiles)))
    nsplit = -(-groups // per_slice)
    y = torch.empty(n, cols, dtype=out_dtype, device=x.device)
    partial = (torch.empty(nsplit, n, cols, dtype=torch.float32, device=x.device)
               if nsplit > 1 else y)
    args = []
    for i in range(3):
        if i < len(parts):
            w, s = parts[i]
            args += [w.data_ptr(), s.data_ptr(), w.shape[1]]
        else:
            args += [None, None, 0]
    call("sc_int4_gemv", x.data_ptr(), n, kin, len(parts), *args, per_slice, nsplit,
         partial.data_ptr(), y.data_ptr(), int(out_dtype == torch.float32),
         torch.cuda.current_stream().cuda_stream)
    return y


@counted
def qmatvec_int4(x, w_i4p, scale, out_dtype=torch.float32):
    """x [N <= 8, in] bf16 @ packed-int4 W -> [N, out] in out_dtype (K10)."""
    if x.device.type == "cpu":
        return qmatvec_int4_plain(x, w_i4p, scale, out_dtype)
    _check(x, [(w_i4p, scale)], out_dtype, "qmatvec_int4")
    y = _launch(x, [(w_i4p, scale)], out_dtype)
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
    _check(x, parts, out_dtype, "qmatvec_int4_fused")
    y = _launch(x, parts, out_dtype)
    launched(qmatvec_int4_fused)
    outs, off = [], 0
    for w, _ in parts:
        outs.append(y[:, off:off + 2 * w.shape[1]])
        off += 2 * w.shape[1]
    return tuple(outs)
