"""The decoder's elementwise glue (RMSNorm, RoPE, the KV append, the SwiGLU
gate) and the three kernel wrappers of the paged decode step
(csrc/decode_glue.cu).

No TPU kernel: XLA fuses this glue into the JAX package's decode program
(`streamchat_tpu/models/paged_kv.py:262` `decode_step_paged`). Eagerly it
is ~70-83 PyTorch kernels a layer on 1 x 3584 (or 1 x 128) tensors, so a batch-1
step pays for their launches, not their bytes. `models/paged_kv._decode_step`
runs it as four kernels a layer and one after the last:

- `add_rmsnorm`: the residual add (in place) and the next RMSNorm: the
  post-attention norm, the next layer's input norm, the final norm;
- `bias_rope_append`: the q/k/v biases, RoPE of q and k at each row's
  position, and the new token's K/V stored into its tail page (quantized
  per (token, head) for int8 pages);
- `silu_mul`: silu(gate) * up, the input of the down projection.

Each wrapper launches its kernel for CUDA tensors and runs its `_plain`
twin, the eager code the kernels replaced, for CPU tensors. On the card
it takes one token a row of any number of rows, all bf16 ([rows, 1,
width]); another dtype or shape raises ValueError, as does a head dim
other than 128 in `bias_rope_append`. Each launch counts
`launched(fn)`. Prefill, the speculative verify step and the dense
decode loop call the eager forms here (`rmsnorm`, `rope`, `quantize_kv`,
`silu_mul_plain`) directly.

Rounding: the kernels round to bf16 where the eager code does, with no
contracted multiply-adds in RoPE and full-precision cosf / sinf; only the
order of RMSNorm's f32 sum of squares differs.
"""

from __future__ import annotations

import functools

import torch

from streamchat_tpu_torch.kernels import counted, launched

# The head size `bias_rope_append`'s kernel is built for (every
# configuration here); the widest RMSNorm row its kernel holds; the most
# rows `bias_rope_append` launches (its grid's second dimension).
ROPE_HEAD_DIM = 128
MAX_NORM_WIDTH = 8192
MAX_ROPE_ROWS = 65535


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, HF rotate-half convention. x [B, H, S, Dh],
    positions [B, S]."""
    dh = x.shape[-1]
    inv_freq = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                             device=x.device) / dh))
    ang = positions[:, None, :, None].float() * inv_freq          # [B,1,S,Dh/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x32 = x.float()
    x1, x2 = x32[..., : dh // 2], x32[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


@functools.cache
def inv_freq_table(dh: int, theta: float, device: torch.device) -> torch.Tensor:
    """RoPE's inverse frequencies [dh / 2] f32 by `rope`'s own expression,
    made once a (head size, theta, device): `bias_rope_append`'s table. It
    lives as long as the process, so a graphed step may read it."""
    return 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32, device=device) / dh))


def quantize_kv(x: torch.Tensor):
    """[..., Dh] -> (int8 values, f32 scale over the trailing dim)."""
    amax = x.abs().amax(-1).float()                # exact: |x| and max need no rounding
    scale = (amax / 127.0).masked_fill_(amax == 0, 1.0)
    vals = torch.div(x, scale[..., None]).round_().clamp_(-127, 127).to(torch.int8)
    return vals, scale


def append_kv(k, v, k_pages, v_pages, k_scale, v_scale, page_table, length) -> None:
    """Write one token per row (k, v: [B, Hkv, Dh]) into its tail page of one
    layer's pool, in place: k_pages / v_pages [num_pages, Hkv, ps, Dh] at
    page page_table[row, length // ps], slot length % ps. With k_scale /
    v_scale [num_pages, Hkv, ps] (int8 pages) K and V are quantized in one
    pass, then one indexed store per tensor."""
    ps = k_pages.shape[2]
    length = length.long()
    page_idx = page_table.gather(1, (length // ps)[:, None])[:, 0].long()
    offset = length % ps
    if k_scale is None:
        k_pages[page_idx, :, offset] = k.to(k_pages.dtype)
        v_pages[page_idx, :, offset] = v.to(v_pages.dtype)
        return
    vals, sc = quantize_kv(torch.stack([k, v]))
    k_pages[page_idx, :, offset] = vals[0]
    v_pages[page_idx, :, offset] = vals[1]
    k_scale[page_idx, :, offset] = sc[0]
    v_scale[page_idx, :, offset] = sc[1]


def _on_card(fn, x: torch.Tensor, *others) -> bool:
    """Whether `fn` launches its kernel: x [rows, 1, width] and the other
    tensors of the call (None for an absent one) on the card, all bf16.
    False for CPU tensors (the plain twin runs); a card call of another
    dtype or shape raises."""
    if not x.is_cuda:
        return False
    if (x.dim() != 3 or x.shape[1] != 1 or x.shape[0] < 1
            or any(t is not None and t.dtype != torch.bfloat16 for t in (x, *others))):
        raise ValueError(f"{fn.__name__}: the kernel takes one token a row in bf16, got "
                         f"{tuple(x.shape)} "
                         f"{[None if t is None else t.dtype for t in (x, *others)]}")
    return True


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def add_rmsnorm_plain(x, delta, scale, eps):
    """Plain twin of `add_rmsnorm` (same signature): x + delta as a new
    tensor, then `rmsnorm`."""
    if delta is not None:
        x = x + delta
    return x, rmsnorm(x, scale, eps)


@counted
def add_rmsnorm(x, delta, scale, eps):
    """x + delta (x alone when delta is None) and its RMSNorm -> (x', h),
    both [B, 1, D]. In the decode regime x' is x, updated in place (the
    residual stream), and h a new tensor; on the CPU the plain twin's."""
    if not _on_card(add_rmsnorm, x, delta, scale):
        return add_rmsnorm_plain(x, delta, scale, eps)
    from streamchat_tpu_torch.kernels.build import call

    rows, _, d = x.shape
    if (not x.is_contiguous() or d % 8 or d > MAX_NORM_WIDTH or tuple(scale.shape) != (d,)
            or not scale.is_contiguous()
            or (delta is not None and (delta.shape != x.shape or not delta.is_contiguous()))
            or not _aligned(x, scale, *(() if delta is None else (delta,)))):
        raise ValueError(f"add_rmsnorm: unsupported x {tuple(x.shape)}, delta "
                         f"{None if delta is None else tuple(delta.shape)}, scale "
                         f"{tuple(scale.shape)} (contiguous, 16-byte aligned, D % 8 == 0, "
                         f"D <= {MAX_NORM_WIDTH})")
    h = torch.empty_like(x)
    call("sc_add_rmsnorm", x.data_ptr(), None if delta is None else delta.data_ptr(),
         scale.data_ptr(), h.data_ptr(), rows, d, float(eps),
         torch.cuda.current_stream().cuda_stream)
    launched(add_rmsnorm)
    return x, h


def bias_rope_append_plain(q, k, v, bias, positions, theta, k_pages, v_pages, k_scale,
                           v_scale, page_table, length):
    """Plain twin of `bias_rope_append` (same signature): the bias add, the
    heads' reshape, `rope` of q and k and `append_kv`."""
    b = q.shape[0]
    hkv, dh = k_pages.shape[1], k_pages.shape[-1]
    hq = q.shape[-1] // dh
    if bias is not None:
        q, k, v = q + bias[0], k + bias[1], v + bias[2]
    q = q.reshape(b, 1, hq, dh).transpose(1, 2)
    k = k.reshape(b, 1, hkv, dh).transpose(1, 2)
    v = v.reshape(b, 1, hkv, dh).transpose(1, 2)
    pos = (length if positions is None else positions)[:, None]
    q = rope(q, pos, theta)
    k = rope(k, pos, theta)
    append_kv(k[:, :, 0], v[:, :, 0], k_pages, v_pages, k_scale, v_scale, page_table, length)
    return q


def _rows_ok(t: torch.Tensor, width: int) -> bool:
    """t [rows, 1, width] with contiguous rows (any row stride)."""
    return t.shape[1:] == (1, width) and t.stride(-1) == 1


@counted
def bias_rope_append(q, k, v, bias, positions, theta, k_pages, v_pages, k_scale, v_scale,
                     page_table, length):
    """The new token's q/k/v products [B, 1, H * Dh] -> q [B, Hq, 1, Dh],
    roped; k (roped) and v are stored in place into one layer's pool,
    k_pages / v_pages [num_pages, Hkv, ps, Dh] (bf16, or int8 with k_scale /
    v_scale [num_pages, Hkv, ps] f32; None for bf16 pages), at each row's
    length [B] through page_table [B, maxp]. `bias` (bq, bk, bv), or None
    for a bias-free tree, is added first in q's dtype. The rotary position
    is positions [B], or the row's length when None."""
    biases = () if bias is None else tuple(bias)
    if not _on_card(bias_rope_append, q, k, v, *biases):
        return bias_rope_append_plain(q, k, v, bias, positions, theta, k_pages, v_pages,
                                      k_scale, v_scale, page_table, length)
    from streamchat_tpu_torch.kernels.build import call

    rows = q.shape[0]
    num_pages, hkv, ps, dh = k_pages.shape
    if dh != ROPE_HEAD_DIM:
        raise ValueError(f"bias_rope_append: head dim {dh}; the kernel takes {ROPE_HEAD_DIM}")
    hq = q.shape[-1] // dh
    int8 = k_scale is not None
    pools = (k_pages, v_pages) + ((k_scale, v_scale) if int8 else ())
    if (rows > MAX_ROPE_ROWS or q.shape[-1] != hq * dh or not _rows_ok(q, hq * dh)
            or not _rows_ok(k, hkv * dh) or not _rows_ok(v, hkv * dh) or k.shape[0] != rows or v.shape[0] != rows
            or any(t.shape != (hkv * dh,) or not t.is_contiguous() for t in biases[1:])
            or (biases and (biases[0].shape != (hq * dh,) or not biases[0].is_contiguous()))
            or v_pages.shape != k_pages.shape
            or any(not t.is_contiguous() or t.device != q.device for t in pools)
            or k_pages.dtype != (torch.int8 if int8 else torch.bfloat16)
            or v_pages.dtype != k_pages.dtype
            or (int8 and (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32
                          or k_scale.shape != (num_pages, hkv, ps)
                          or v_scale.shape != k_scale.shape))
            or page_table.dtype != torch.int32 or not page_table.is_contiguous()
            or page_table.shape[0] != rows or length.dtype != torch.int32
            or tuple(length.shape) != (rows,) or not length.is_contiguous()):
        raise ValueError(f"bias_rope_append: unsupported q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, pages {tuple(k_pages.shape)} "
                         f"{k_pages.dtype}, table {tuple(page_table.shape)} "
                         f"{page_table.dtype}, length {tuple(length.shape)} {length.dtype}")
    if positions is not None:
        positions = positions.to(torch.int32).reshape(rows).contiguous()
    inv_freq = inv_freq_table(dh, float(theta), q.device)
    q_out = torch.empty(rows, hq, 1, dh, dtype=torch.bfloat16, device=q.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    call("sc_bias_rope_append", q.data_ptr(), q.stride(0), k.data_ptr(), k.stride(0),
         v.data_ptr(), v.stride(0), *(ptr(t) for t in (biases or (None,) * 3)),
         inv_freq.data_ptr(), ptr(positions), length.data_ptr(), page_table.data_ptr(),
         page_table.shape[1], k_pages.data_ptr(), v_pages.data_ptr(), ptr(k_scale),
         ptr(v_scale), num_pages, hq, hkv, ps, rows, q_out.data_ptr(),
         torch.cuda.current_stream().cuda_stream)
    launched(bias_rope_append)
    return q_out


def silu_mul_plain(gate, up):
    """Plain twin of `silu_mul` (same signature): silu in f32, rounded to
    up's dtype, times up."""
    return torch.nn.functional.silu(gate.float()).to(up.dtype) * up


@counted
def silu_mul(gate, up):
    """silu(gate) * up for the gate and up products [B, 1, F] -> [B, 1, F]
    (the SwiGLU input of the down projection)."""
    if not _on_card(silu_mul, gate, up):
        return silu_mul_plain(gate, up)
    from streamchat_tpu_torch.kernels.build import call

    rows, _, f = gate.shape
    if (f % 8 or up.shape != gate.shape or not _rows_ok(gate, f) or not _rows_ok(up, f)
            or gate.stride(0) % 8 or up.stride(0) % 8 or not _aligned(gate, up)):
        raise ValueError(f"silu_mul: unsupported gate {tuple(gate.shape)} {gate.stride()}, up "
                         f"{tuple(up.shape)} {up.stride()} (F % 8 == 0, 16-byte aligned rows)")
    out = torch.empty(rows, 1, f, dtype=torch.bfloat16, device=gate.device)
    call("sc_silu_mul", gate.data_ptr(), gate.stride(0), up.data_ptr(), up.stride(0),
         out.data_ptr(), rows, f, torch.cuda.current_stream().cuda_stream)
    launched(silu_mul)
    return out
