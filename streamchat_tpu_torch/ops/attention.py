"""Prefill attention (K3), chunk-vs-cache partial attention (K5) for
Hopper, their plain twins, and plain decode.

Counterpart of `streamchat_tpu/ops/attention.py`. Layouts as there:
q [B, H, S, D], k/v [B, Hkv, S, D] (GQA: query head h reads kv head
h // (H / Hkv)), kv_length [B] masks keys at and past each row's length.

* `flash_attention` — causal or non-causal online-softmax attention. A CUDA
  tensor launches `csrc/flash_prefill.cu` (bf16, head dim 64 or 128,
  any strides with a contiguous last dim, read by TMA); a CPU tensor runs
  `flash_attention_plain`. Rows that see no key output 0, like the TPU
  kernel's `l == 0` guard. The decoder calls it for a one-pass prefill
  and for chunk 0 of a chunked one.
* `flash_attention_partial` — the same tile loop with GLOBAL causality
  (`k_offset + col <= q_offset + row`) and an unnormalized f32 result
  (acc, m, l): m is the running max in the scaled domain, clamped to
  `neg_inf`, and a row that sees no key keeps acc 0 and l 0. The chunked
  prefill (`models/decoder._chunk_cache_attention`) normalizes it. The
  same Hopper kernel template as `flash_attention`, with the partial
  epilogue.
* `decode_attention` — one query token against a contiguous cache (plain
  PyTorch, as it is plain XLA there: the dense generation loop of
  `models/generate.py` runs it; the paged decode path uses
  ops/paged_attention).
"""

from __future__ import annotations

import ctypes
import math

import torch

from streamchat_tpu_torch.kernels import counted, launched


def _scores(q, k, sm_scale):
    """f32 scores q k^T [B, H, Sq, Sk] (k already repeated over the query
    groups), divided by sqrt(D) or, when given, times sm_scale."""
    s = q.float() @ k.float().transpose(-1, -2)
    return s / math.sqrt(q.shape[-1]) if sm_scale is None else s * sm_scale


def flash_attention_plain(q, k, v, kv_length=None, *, causal: bool = True,
                          sm_scale: float | None = None):
    """Plain PyTorch twin of `flash_attention` (same signature)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
    s = _scores(q, k, sm_scale)                                      # [B,H,Sq,Sk]
    col = torch.arange(sk, device=q.device)
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        mask = col[None, :] <= torch.arange(sq, device=q.device)[:, None]
    mask = mask[None, None]
    if kv_length is not None:
        mask = mask & (col[None, None, None, :]
                       < kv_length.to(q.device)[:, None, None, None])
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = (p @ v.float()) / torch.where(l == 0, torch.ones_like(l), l)
    return o.to(q.dtype)


def flash_attention_partial_plain(q, k, v, q_offset: int, k_offset: int, kv_length=None,
                                  *, causal: bool = True, neg_inf: float = -1e30,
                                  sm_scale: float | None = None):
    """Plain PyTorch twin of `flash_attention_partial` (same signature)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
    s = _scores(q, k, sm_scale)                                      # [B,H,Sq,Sk]
    col = torch.arange(sk, device=q.device)
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        row = torch.arange(sq, device=q.device)
        mask = (k_offset + col[None, :]) <= (q_offset + row[:, None])
    mask = mask[None, None]
    if kv_length is not None:
        mask = mask & (col[None, None, None, :]
                       < kv_length.to(q.device)[:, None, None, None])
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(-1).clamp_min(neg_inf)                               # [B,H,Sq]
    p = torch.exp(s - m[..., None])
    vf = v.float()
    if kv_length is not None:       # 0 * garbage past the length stays 0
        vf = torch.where(col[None, None, :, None]
                         < kv_length.to(q.device)[:, None, None, None], vf, 0.0)
    return p @ vf, m, p.sum(-1)


def _strides(t: torch.Tensor, name: str):
    if t.stride(-1) != 1:
        raise ValueError(f"flash_attention {name}: last dim must be contiguous")
    st = t.stride()[:3]
    if any(x % 8 for x in st) or t.data_ptr() % 16:
        raise ValueError(f"flash_attention {name}: strides {st} must be "
                         "16-byte multiples")
    return (st[0], st[1], st[2])


def _checked(fn: str, q, k, v, kv_length):
    """The kernels' input contract (CUDA bf16 q/k/v, head dim 64 or 128,
    GQA, int32 kv_length [B] on the device) -> (ctypes stride arrays of q,
    k, v; contiguous kv_length or None)."""
    b, hq, _, d = q.shape
    hkv = k.shape[1]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.dtype != torch.bfloat16:
            raise ValueError(f"{fn} {name}: expected CUDA bf16, got {t.device} {t.dtype}")
    if d not in (64, 128) or hq % hkv or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"{fn}: unsupported shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if kv_length is not None:
        if (kv_length.device != q.device or kv_length.dtype != torch.int32
                or tuple(kv_length.shape) != (b,)):
            raise ValueError(f"{fn} kv_length: expected int32 [B] on the query's device")
        kv_length = kv_length.contiguous()
    strides = [(ctypes.c_int64 * 3)(*_strides(t, n)) for t, n in ((q, "q"), (k, "k"), (v, "v"))]
    return strides, kv_length


def _kernel_scale(d: int, sm_scale: float | None) -> float:
    return 1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale)


@counted
def flash_attention(q, k, v, kv_length=None, *, causal: bool = True,
                    sm_scale: float | None = None):
    """Tiled flash attention (K3), scores scaled by `sm_scale` (default
    D^-0.5) -> [B, H, Sq, D] in q's dtype.

    On CUDA the result is a [B, H, Sq, D] view of a [B, Sq, H, D] buffer,
    so the decoder's following transpose to [B, Sq, H * D] is free.
    """
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_length, causal=causal, sm_scale=sm_scale)
    from streamchat_tpu_torch.kernels.build import call

    (qs, ks, vs), kv_length = _checked("flash_attention", q, k, v, kv_length)
    out = torch.empty(b, sq, hq, d, dtype=q.dtype, device=q.device).transpose(1, 2)
    os_ = (ctypes.c_int64 * 3)(*_strides(out, "out"))
    call("sc_flash_attention", q.data_ptr(), qs, k.data_ptr(), ks,
         v.data_ptr(), vs, out.data_ptr(), os_,
         None if kv_length is None else kv_length.data_ptr(),
         b, hq, hkv, sq, sk, d, int(causal), _kernel_scale(d, sm_scale),
         torch.cuda.current_stream().cuda_stream)
    launched(flash_attention)
    return out


@counted
def flash_attention_partial(q, k, v, q_offset: int, k_offset: int, kv_length=None,
                            *, causal: bool = True, neg_inf: float = -1e30,
                            sm_scale: float | None = None):
    """Partial flash attention (K5), scores scaled by `sm_scale` (default
    D^-0.5) -> (acc f32 [B, H, Sq, D] UNNORMALIZED, m f32 [B, H, Sq], l f32
    [B, H, Sq]).

    q_offset / k_offset are the global positions of q's and k's first rows
    (host ints); causality is `k_offset + col <= q_offset + row`. The
    normalized attention is acc / l where l > 0, and 0 where l == 0.
    """
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if q.device.type == "cpu":
        return flash_attention_partial_plain(q, k, v, q_offset, k_offset, kv_length,
                                             causal=causal, neg_inf=neg_inf, sm_scale=sm_scale)
    from streamchat_tpu_torch.kernels.build import call

    (qs, ks, vs), kv_length = _checked("flash_attention_partial", q, k, v, kv_length)
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.empty(b, hq, sq, d, **f32)
    m = torch.empty(b, hq, sq, **f32)
    l = torch.empty(b, hq, sq, **f32)
    call("sc_flash_attention_partial", q.data_ptr(), qs, k.data_ptr(), ks,
         v.data_ptr(), vs, acc.data_ptr(), m.data_ptr(), l.data_ptr(),
         None if kv_length is None else kv_length.data_ptr(),
         b, hq, hkv, sq, sk, d, int(causal), _kernel_scale(d, sm_scale), int(q_offset),
         int(k_offset), float(neg_inf), torch.cuda.current_stream().cuda_stream)
    launched(flash_attention_partial)
    return acc, m, l


def decode_attention(q, k_cache, v_cache, length):
    """One-token attention against a contiguous cache.

    q [B, H, 1, D]; k_cache/v_cache [B, Hkv, Lmax, D]; length [B] valid
    entries (the new token's K/V already written). Entries at or past a
    row's length may hold any garbage, NaN included (a reused cache).
    """
    b, hq, _, d = q.shape
    hkv, lmax = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, d).float()
    # Scaled as the JAX package scales it (times 1 / sqrt(d)), so that
    # greedy ties break the same way.
    s = torch.einsum("bhgd,bhld->bhgl", qg, k_cache.float()) * (1.0 / math.sqrt(d))
    col = torch.arange(lmax, device=q.device)
    s = s.masked_fill(col[None, None, None, :] >= length[:, None, None, None],
                      float("-inf"))
    p = torch.softmax(s, dim=-1)
    v = torch.where(col[None, None, :, None] < length[:, None, None, None], v_cache.float(), 0.0)
    o = torch.einsum("bhgl,bhld->bhgd", p, v)
    return o.reshape(b, hq, 1, d).to(q.dtype)
