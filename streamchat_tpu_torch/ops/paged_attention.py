"""Paged decode attention over a sequential pool, bf16 pages (K4) and int8
pages (K6), with their plain twins.

Counterparts of `streamchat_tpu/ops/paged_attention.py`
`paged_decode_attention_pallas_seq` and `paged_decode_attention_pallas_seq_int8`:
pages are in pool order — the identity table at B = 1, and at B > 1 a
statically partitioned pool where row b owns pages [b * row_pages,
(b + 1) * row_pages), row_pages = num_pages // B — and `length` [B] masks
each row's keys. Int8 pages carry per-(token, head) f32 scales that commute
out of both contractions: s = (q . k_i8) * k_scale * D^-0.5 and
o = sum_l p_l v_scale_l v_i8_l / sum_l p_l. A CUDA tensor launches
`csrc/paged_decode.cu` (page-range split across blocks, then a merge
kernel); a CPU tensor runs the plain twin.
"""

from __future__ import annotations

import torch

from streamchat_tpu_torch.kernels import counted

# Pages per block of the split page range: 4 pages of 128 tokens give ~180
# blocks for a 23k-token context over 4 kv heads (132 SMs on the H100).
PAGES_PER_CHUNK = 4
_G_MAX = 8


def _rows(pages, b, row_pages):
    """[b * row_pages, Hkv, ps, ...] pool -> [b, Hkv, row_pages * ps, ...]."""
    _, hkv, ps = pages.shape[:3]
    x = pages.reshape(b, row_pages, hkv, ps, *pages.shape[3:]).transpose(1, 2)
    return x.reshape(b, hkv, row_pages * ps, *pages.shape[3:])


def paged_decode_attention_seq_plain(q, k_pages, v_pages, length):
    """Plain PyTorch twin of `paged_decode_attention_seq` (same signature)."""
    b, hq, _, d = q.shape
    num_pages, hkv, ps, _ = k_pages.shape
    if num_pages % b:
        raise ValueError(f"pool of {num_pages} pages not divisible into {b} rows")
    row_pages = num_pages // b
    qg = q.reshape(b, hkv, hq // hkv, d).float()
    s = torch.einsum("bhgd,bhld->bhgl", qg, _rows(k_pages, b, row_pages).float()) * d ** -0.5
    col = torch.arange(row_pages * ps, device=q.device)
    s = s.masked_fill(col[None, None, None, :]
                      >= length.to(q.device)[:, None, None, None], float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgl,bhld->bhgd", p, _rows(v_pages, b, row_pages).float())
    o = o / torch.where(l == 0, torch.ones_like(l), l)
    return o.reshape(b, hq, 1, d).to(q.dtype)


def paged_decode_attention_seq_int8_plain(q, k_pages, v_pages, k_scale, v_scale, length):
    """Plain twin of `paged_decode_attention_seq_int8` (same signature).

    Slots at or past a row's length may hold any garbage, NaN included: it
    is masked out of the scores and its values are zeroed before P V."""
    b, hq, _, d = q.shape
    num_pages, hkv, ps, _ = k_pages.shape
    if num_pages % b:
        raise ValueError(f"pool of {num_pages} pages not divisible into {b} rows")
    row_pages = num_pages // b
    valid = (torch.arange(row_pages * ps, device=q.device)[None, None, :]
             < length.to(q.device)[:, None, None])                      # [B, 1, L]
    qg = q.reshape(b, hkv, hq // hkv, d).float()
    s = torch.einsum("bhgd,bhld->bhgl", qg, _rows(k_pages, b, row_pages).float())
    s = s * _rows(k_scale, b, row_pages)[:, :, None, :] * d ** -0.5
    s = s.masked_fill(~valid[:, :, None, :], float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    v = torch.where(valid[..., None], _rows(v_pages, b, row_pages).float()
                    * _rows(v_scale, b, row_pages)[..., None], 0.0)
    o = torch.einsum("bhgl,bhld->bhgd", p, v)
    o = o / torch.where(l == 0, torch.ones_like(l), l)
    return o.reshape(b, hq, 1, d).to(q.dtype)


def _launch(name, q, k_pages, v_pages, scales, length, page_dtype):
    """Checks and one launch of the K4 / K6 entry point `name`."""
    from streamchat_tpu_torch.kernels.build import call

    b, hq, one, d = q.shape
    num_pages, hkv, ps, _ = k_pages.shape
    g = hq // hkv
    bf = torch.bfloat16
    for t_name, t, dtype in (("q", q, bf), ("k_pages", k_pages, page_dtype),
                             ("v_pages", v_pages, page_dtype)):
        if t.device.type != "cuda" or t.dtype != dtype:
            raise ValueError(f"paged decode {t_name}: expected CUDA {dtype}, got "
                             f"{t.device} {t.dtype}")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("paged decode: pages must be contiguous")
    if (one != 1 or d not in (64, 128) or hq % hkv or g > _G_MAX
            or tuple(v_pages.shape) != tuple(k_pages.shape) or num_pages % b
            or q.stride(-1) != 1):
        raise ValueError(f"paged decode: unsupported q {tuple(q.shape)} "
                         f"pages {tuple(k_pages.shape)}")
    for t in scales:
        if (t.device != q.device or t.dtype != torch.float32 or not t.is_contiguous()
                or tuple(t.shape) != (num_pages, hkv, ps)):
            raise ValueError(f"paged decode scales: expected contiguous f32 "
                             f"{(num_pages, hkv, ps)} on the query's device, got "
                             f"{t.device} {t.dtype} {tuple(t.shape)}")
    if (length.device != q.device or length.dtype != torch.int32
            or tuple(length.shape) != (b,)):
        raise ValueError("paged decode length: expected int32 [B] on the "
                         "query's device")
    length = length.contiguous()
    row_pages = num_pages // b
    nchunks = -(-row_pages // PAGES_PER_CHUNK)
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.empty(b, hkv, nchunks, g, d, **f32)
    m = torch.empty(b, hkv, nchunks, g, **f32)
    l = torch.empty(b, hkv, nchunks, g, **f32)
    out = torch.empty(b, hq, 1, d, dtype=bf, device=q.device)
    call(name, q.data_ptr(), q.stride(0), q.stride(1), k_pages.data_ptr(),
         v_pages.data_ptr(), *[t.data_ptr() for t in scales], length.data_ptr(),
         b, hq, hkv, row_pages, ps, PAGES_PER_CHUNK, d, d ** -0.5,
         acc.data_ptr(), m.data_ptr(), l.data_ptr(), out.data_ptr(),
         torch.cuda.current_stream().cuda_stream)
    return out


@counted
def paged_decode_attention_seq(q, k_pages, v_pages, length):
    """One-token decode attention (K4), scores scaled by D^-0.5: q
    [B, Hq, 1, D], one layer's pages [num_pages, Hkv, page_size, D],
    length [B] int32 -> [B, Hq, 1, D]."""
    if q.device.type == "cpu":
        return paged_decode_attention_seq_plain(q, k_pages, v_pages, length)
    out = _launch("sc_paged_decode", q, k_pages, v_pages, (), length, torch.bfloat16)
    paged_decode_attention_seq.launches += 1
    return out


@counted
def paged_decode_attention_seq_int8(q, k_pages, v_pages, k_scale, v_scale, length):
    """One-token decode attention over int8 pages (K6): q [B, Hq, 1, D]
    bf16, one layer's int8 pages [num_pages, Hkv, page_size, D] and f32
    scales [num_pages, Hkv, page_size], length [B] int32 -> [B, Hq, 1, D]."""
    if q.device.type == "cpu":
        return paged_decode_attention_seq_int8_plain(q, k_pages, v_pages, k_scale,
                                                     v_scale, length)
    out = _launch("sc_paged_decode_int8", q, k_pages, v_pages, (k_scale, v_scale),
                  length, torch.int8)
    paged_decode_attention_seq_int8.launches += 1
    return out
