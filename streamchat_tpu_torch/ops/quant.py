"""Weight-only int8 / int4 quantization of the decoder's matmuls
(`streamchat_tpu/ops/quant.py`) and the W8A16 GEMV kernel wrapper.

Storage is the JAX package's, bit for bit:
- int8: W [in, out] -> {"w_i8": int8 [in, out], "scale": f32 [out]},
  symmetric per output column, W ~= w_i8 * scale;
- int4: W [in, out] -> {"w_i4p": int8 [in, out/2], "scale": f32 [g, 2, out/2]},
  group-128 scales, COLUMN-HALF nibble packing: byte (i, j) holds w[i, j]
  in its low nibble and w[i, j + out/2] in its high nibble.

Dispatch follows the JAX regimes. A CUDA bf16 input of at most 8 rows
(decode) goes to the hand-written GEMV kernels: W8 here (`qmatvec_int8`,
csrc/w8a16_gemv.cu), K10/K11 in `ops/int4_matmul.py`. More rows on the card
(prefill) multiply the converted weight with `torch.matmul`, as the JAX
package leaves prefill to XLA. A CPU tensor takes the plain path, which is
the JAX package's CPU path: int8 as an f32 product scaled per column, int4
as a matmul against the weight dequantized to the input's dtype.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence

import torch

from streamchat_tpu_torch.kernels import counted, launched

Params = Dict[str, Any]

# Rows a GEMV kernel serves (the decode regime; JAX: `n <= 8`).
MAX_KERNEL_ROWS = 8
# Blocks a GEMV launch aims for: two per SM of the H100's 132.
TARGET_BLOCKS = 264
# W8 launch geometry (csrc/w8a16_gemv.cu): one block covers 512 output
# columns (32 lanes x 16 int8 columns); warps split the rows of its K slice.
W8_TILE_COLS = 512
W8_MIN_SLICE_ROWS = 64


def quantize_weight(w: torch.Tensor) -> Params:
    """W [in, out] -> {"w_i8": int8 [in, out], "scale": f32 [out]}."""
    w32 = w.float()
    amax = w32.abs().amax(0)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    w_i8 = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return {"w_i8": w_i8, "scale": scale}


def dequantize_weight(q: Params, dtype=torch.bfloat16) -> torch.Tensor:
    """Materialize W ~= w_i8 * scale (tests / debugging only)."""
    return (q["w_i8"].float() * q["scale"]).to(dtype)


def is_quantized(p: Any) -> bool:
    return isinstance(p, dict) and ("w_i8" in p or "w_i4p" in p)


def quantize_weight_int4(w: torch.Tensor, group_size: int = 128) -> Params:
    """W [in, out] -> {"w_i4p": int8 [in, out/2], "scale": f32 [in/gs, 2, out/2]}.

    Symmetric round-to-nearest int4 (-7..7) with one scale per (input group
    of `group_size` rows, output column); see the module note for the
    packing. `scale.reshape(g, out)` is the flat per-column layout."""
    kin, out = w.shape
    if kin % group_size:
        raise ValueError(f"in-dim {kin} not divisible by group {group_size}")
    if out % 2:
        raise ValueError(f"out-dim {out} must be even for nibble packing")
    g = kin // group_size
    w32 = w.float().reshape(g, group_size, out)
    amax = w32.abs().amax(1)                                   # [g, out]
    scale = torch.where(amax > 0, amax / 7.0, torch.ones_like(amax))
    w_i4 = torch.clamp(torch.round(w32 / scale[:, None, :]), -7, 7)
    return {"w_i4p": pack_int4(w_i4.reshape(kin, out)), "scale": scale.reshape(g, 2, out // 2)}


def pack_int4(w_i4: torch.Tensor) -> torch.Tensor:
    """int4 values [in, out] (-8..7, any integer dtype) -> packed bytes
    [in, out/2]: column j in the low nibble, column j + out/2 in the high
    one (the inverse of `unpack_int4`)."""
    w = w_i4.to(torch.int32)
    oh = w.shape[-1] // 2
    byte = (w[..., :oh] & 0xF) | ((w[..., oh:] & 0xF) << 4)     # 0..255
    return torch.where(byte >= 128, byte - 256, byte).to(torch.int8)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """Packed bytes [in, out/2] -> int8 values [in, out]: the signed low
    nibbles (columns [0, out/2)) then the signed high nibbles."""
    p32 = p.to(torch.int32)
    lo = ((p32 & 0xF) ^ 8) - 8
    hi = p32 >> 4
    return torch.cat([lo, hi], dim=-1).to(torch.int8)


def dequantize_weight_int4(q: Params, dtype=torch.bfloat16) -> torch.Tensor:
    """Materialize W ~= w_i4 * scale[group] -> [in, out]."""
    w_i4 = unpack_int4(q["w_i4p"])
    kin, out = w_i4.shape
    g = q["scale"].shape[0]
    scale = q["scale"].reshape(g, out)
    w = w_i4.float().reshape(g, kin // g, out) * scale[:, None, :]
    return w.reshape(kin, out).to(dtype)


def _kernel_rows(x: torch.Tensor, n: int) -> bool:
    """The decode regime the GEMV kernels serve."""
    return x.is_cuda and x.dtype == torch.bfloat16 and n <= MAX_KERNEL_ROWS


def qmatvec_int8_plain(x, w_i8, scale, out_dtype=None):
    """Plain twin of `qmatvec_int8` (same signature): the f32 product of x
    and the int8 weight, scaled per output column."""
    y = (x.float() @ w_i8.float()) * scale
    return y.to(out_dtype or x.dtype)


@counted
def qmatvec_int8(x, w_i8, scale, out_dtype=None):
    """W8A16 GEMV (csrc/w8a16_gemv.cu): x [N <= 8, in] bf16, w_i8 [in, out]
    int8, scale [out] f32 -> (x @ w_i8) * scale [N, out] in `out_dtype`
    (bf16 for the projections, f32 for the logits; default x.dtype), f32
    accumulation. No Pallas source: it replaces the TPU's XLA-fused
    int8 -> bf16 convert in `ops/quant.qmatmul`."""
    if x.device.type == "cpu":
        return qmatvec_int8_plain(x, w_i8, scale, out_dtype)
    from streamchat_tpu_torch.kernels.build import call

    out_dtype = out_dtype or x.dtype
    n, kin = x.shape
    out = w_i8.shape[1]
    if (x.device.type != "cuda" or x.dtype != torch.bfloat16 or not x.is_contiguous()
            or w_i8.device != x.device or w_i8.dtype != torch.int8
            or not w_i8.is_contiguous() or scale.device != x.device
            or scale.dtype != torch.float32 or not scale.is_contiguous()):
        raise ValueError("qmatvec_int8: expected contiguous CUDA x bf16, w_i8 int8, "
                         f"scale f32 on one device; got {x.device} {x.dtype}, "
                         f"{w_i8.device} {w_i8.dtype}, {scale.device} {scale.dtype}")
    if (n < 1 or n > MAX_KERNEL_ROWS or w_i8.shape[0] != kin or out % 16
            or tuple(scale.shape) != (out,) or w_i8.data_ptr() % 16
            or out_dtype not in (torch.bfloat16, torch.float32)):
        raise ValueError(f"qmatvec_int8: unsupported x {tuple(x.shape)}, w "
                         f"{tuple(w_i8.shape)}, scale {tuple(scale.shape)}, "
                         f"out {out_dtype} (N <= {MAX_KERNEL_ROWS}, out % 16 == 0)")
    tiles = -(-out // W8_TILE_COLS)
    nsplit = min(-(-TARGET_BLOCKS // tiles), max(1, kin // W8_MIN_SLICE_ROWS))
    slice_rows = -(-kin // nsplit)
    slice_rows = -(-slice_rows // 8) * 8
    nsplit = -(-kin // slice_rows)
    y = torch.empty(n, out, dtype=out_dtype, device=x.device)
    partial = (torch.empty(nsplit, n, out, dtype=torch.float32, device=x.device)
               if nsplit > 1 else y)
    call("sc_w8a16_gemv", x.data_ptr(), w_i8.data_ptr(), scale.data_ptr(), n, kin, out,
         slice_rows, nsplit, partial.data_ptr(), y.data_ptr(),
         int(out_dtype == torch.float32), torch.cuda.current_stream().cuda_stream)
    launched(qmatvec_int8)
    return y


def qmatmul(x: torch.Tensor, q: Params, out_dtype=None) -> torch.Tensor:
    """x [..., in] @ W -> [..., out] with int8-stored W: the f32 product
    scaled per column, returned in `out_dtype` (default x.dtype)."""
    lead, kin = x.shape[:-1], x.shape[-1]
    n = math.prod(x.shape[:-1])
    w, s = q["w_i8"], q["scale"]
    out_dtype = out_dtype or x.dtype
    if _kernel_rows(x, n):
        y = qmatvec_int8(x.reshape(n, kin).contiguous(), w, s, out_dtype)
    elif x.is_cuda:
        # Prefill: scale the product in place (computed in f32, stored in
        # x.dtype), so no f32 copy of a [rows, out] activation is made.
        y = x.reshape(n, kin) @ w.to(x.dtype)
        y = y.float() * s if out_dtype == torch.float32 else y.mul_(s).to(out_dtype)
    else:
        y = qmatvec_int8_plain(x.reshape(n, kin), w, s, out_dtype)
    return y.reshape(*lead, w.shape[1])


def qmatmul_int4(x: torch.Tensor, q: Params) -> torch.Tensor:
    """x [..., in] @ W -> [..., out] in x.dtype with packed-int4 W: the K10
    kernel in the decode regime, else a matmul against the dequantized W."""
    lead, kin = x.shape[:-1], x.shape[-1]
    n = math.prod(x.shape[:-1])
    if _kernel_rows(x, n):
        from streamchat_tpu_torch.ops.int4_matmul import qmatvec_int4

        y = qmatvec_int4(x.reshape(n, kin).contiguous(), q["w_i4p"], q["scale"],
                         out_dtype=x.dtype)
        return y.reshape(*lead, y.shape[-1])
    return x @ dequantize_weight_int4(q, x.dtype)


def qmatmul_int4_multi(x: torch.Tensor, qs: Sequence[Params]) -> list:
    """x @ W_p for several packed-int4 weights sharing x: ONE K11 launch in
    the decode regime, else one `qmatmul_int4` per weight."""
    qs = list(qs)
    lead, kin = x.shape[:-1], x.shape[-1]
    n = math.prod(x.shape[:-1])
    if len(qs) > 1 and _kernel_rows(x, n):
        from streamchat_tpu_torch.ops.int4_matmul import qmatvec_int4_fused

        flat = []
        for q in qs:
            flat.extend([q["w_i4p"], q["scale"]])
        ys = qmatvec_int4_fused(x.reshape(n, kin).contiguous(), *flat, out_dtype=x.dtype)
        return [y.reshape(*lead, y.shape[-1]) for y in ys]
    return [qmatmul_int4(x, q) for q in qs]


def matmul_any(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x @ w for a plain tensor OR a quantized int8/int4 dict."""
    if isinstance(w, dict) and "w_i4p" in w:
        return qmatmul_int4(x, w)
    if is_quantized(w):
        return qmatmul(x, w)
    return x @ w


def matmul_f32(x: torch.Tensor, w: Any):
    """x @ w split where `matmul_any` rounds -> (y f32 [..., out], finish):
    finish(y) gives what `matmul_any(x, w)` gives, up to the order of the
    f32 sums, and finishing the sum of row-parallel parts' y gives the
    whole product's result the same way (the tensor-parallel o and down).
    W8 and K10 write their f32 result directly at decode; a prefill
    product is taken in f32 and rounded as the single-device path rounds
    it (an int8 one before its scale, as `qmatmul` scales on the card)."""
    lead, kin = x.shape[:-1], x.shape[-1]
    n = math.prod(lead)
    x2 = x.reshape(n, kin)
    dtype, scale = x.dtype, None

    def finish(t):
        t = t.to(dtype)
        return t if scale is None else t.mul_(scale)

    if isinstance(w, dict) and "w_i4p" in w:
        if _kernel_rows(x, n):
            from streamchat_tpu_torch.ops.int4_matmul import qmatvec_int4

            y = qmatvec_int4(x2.contiguous(), w["w_i4p"], w["scale"], out_dtype=torch.float32)
        else:
            y = x2.float() @ dequantize_weight_int4(w, dtype).float()
    elif is_quantized(w):
        if _kernel_rows(x, n):
            y = qmatvec_int8(x2.contiguous(), w["w_i8"], w["scale"], torch.float32)
        elif x.is_cuda:
            y, scale = x2.float() @ w["w_i8"].float(), w["scale"]
        else:
            y = qmatvec_int8_plain(x2, w["w_i8"], w["scale"], torch.float32)
    else:
        y = x2.float() @ w.float()
    return y.reshape(*lead, y.shape[-1]), finish


def quantize_decoder_params(params: Params, quantize_embed: bool = False,
                            bits: int = 8) -> Params:
    """Quantize every decoder matmul weight (returns a new tree).

    Per-layer q/k/v/o (biases stay as they are) and gate/up/down in `bits`;
    the lm_head (and, with quantize_embed, the token table as int8 rows)
    stays int8 when bits=4: the logits are the most quantization-sensitive
    projection. The JAX package's `destructive` option, which frees each
    source weight early to fit a 16 GB chip, is not needed on 80 GB."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if "tp" in params:
        raise ValueError("quantize a decoder before it is sharded: a row-parallel slice's "
                         "int8 scales would come from its own rows only")
    qfn = quantize_weight_int4 if bits == 4 else quantize_weight

    def proj(p):
        return dict(qfn(p["w"]), **({"b": p["b"]} if "b" in p else {}))

    out = dict(params)
    out["layers"] = [{
        "input_norm": p["input_norm"], "post_norm": p["post_norm"],
        "attn": {n: proj(p["attn"][n]) for n in ("q", "k", "v", "o")},
        "mlp": {n: qfn(p["mlp"][n]) for n in ("gate", "up", "down")},
    } for p in params["layers"]]
    if "lm_head" in params:
        out["lm_head"] = quantize_weight(params["lm_head"])
    if quantize_embed:
        out["embed"] = quantize_embedding(params["embed"])
    return out


def quantize_embedding(w: torch.Tensor) -> Params:
    """Embedding table [V, D] -> int8 rows + per-ROW f32 scales."""
    w32 = w.float()
    amax = w32.abs().amax(1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    w_i8 = torch.clamp(torch.round(w32 / scale[:, None]), -127, 127).to(torch.int8)
    return {"w_i8": w_i8, "scale": scale}


def embed_dtype(params: Params) -> torch.dtype:
    """Activation dtype of the embedding output (bf16 for int8 tables)."""
    emb = params["embed"]
    return torch.bfloat16 if is_quantized(emb) else emb.dtype


def embed_dim(params: Params) -> int:
    emb = params["embed"]
    return (emb["w_i8"] if is_quantized(emb) else emb).shape[1]
