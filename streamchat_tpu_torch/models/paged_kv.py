"""Paged KV cache and the paged decode step (`streamchat_tpu/models/paged_kv.py`).

One pool per layer, [L, num_pages, Hkv, page_size, Dh], a per-row page
table [B, max_pages] of pool indices (-1 = unmapped) and per-row lengths.
Prefill runs on the dense `decoder.KVCache`; `from_contiguous` pages it.
The port's generation keeps pools in row order (identity table at B = 1,
statically partitioned rows at B > 1), which is what the K4 kernel
(`ops.paged_attention.paged_decode_attention_seq`) reads.

Unlike the JAX package's immutable arrays, `append_token_kv` writes the
pools IN PLACE: one position per row per call (a single indexed store), so
a decode step never copies a pool.

`PagedKVCacheInt8` stores the pages as int8 with per-(token, head) f32
scales (`kv_int8`): half the pool bytes, read by the K6 kernel
(`ops.paged_attention.paged_decode_attention_seq_int8`) with the scales
commuted out of both contractions. `from_contiguous_int8` quantizes and
repages a dense bf16 prefill one layer at a time, so the int8 pool and one
layer's transients are live beside the dense cache, never a second whole
cache; a long prompt's `decoder.Int8KVCache` is repaged as it is.
"""

from __future__ import annotations

import dataclasses

import torch

from streamchat_tpu_torch.models import decoder
from streamchat_tpu_torch.ops.paged_attention import (
    paged_decode_attention_seq,
    paged_decode_attention_seq_int8,
)


@dataclasses.dataclass
class PagedKVCache:
    k_pages: torch.Tensor      # [L, num_pages, Hkv, page_size, Dh]
    v_pages: torch.Tensor
    page_table: torch.Tensor   # [B, max_pages] int32 (-1 = unmapped)
    length: torch.Tensor       # [B] int32 tokens stored per row

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[3]


def _pages_per_row(cache: decoder.KVCache, num_pages: int, max_pages_per_seq: int,
                   page_size: int) -> int:
    _, b, _, lmax, _ = cache.k.shape
    if lmax % page_size:
        raise ValueError(f"Lmax={lmax} not a multiple of page_size={page_size}")
    ppr = lmax // page_size
    if ppr > max_pages_per_seq:
        raise ValueError("max_pages_per_seq too small for the source cache")
    if b * ppr > num_pages:
        raise ValueError("page pool too small for the source cache")
    return ppr


def from_contiguous(cache: decoder.KVCache, num_pages: int, max_pages_per_seq: int,
                    page_size: int = 128) -> PagedKVCache:
    """Page a prefilled dense cache.

    Rows claim pages sequentially (row r: [r*ppr, (r+1)*ppr), ppr =
    Lmax / page_size); table entries past a row's pages are unmapped (-1).
    """
    l, b, hkv, lmax, dh = cache.k.shape
    ppr = _pages_per_row(cache, num_pages, max_pages_per_seq, page_size)
    dev = cache.k.device

    def repage(x):
        pages = torch.zeros(l, num_pages, hkv, page_size, dh, dtype=x.dtype, device=dev)
        src = x.reshape(l, b, hkv, ppr, page_size, dh).transpose(2, 3)
        pages[:, :b * ppr] = src.reshape(l, b * ppr, hkv, page_size, dh)
        return pages

    return PagedKVCache(k_pages=repage(cache.k), v_pages=repage(cache.v),
                        page_table=_row_table(b, ppr, max_pages_per_seq, dev),
                        length=cache.length.clone())


def _row_table(b: int, ppr: int, max_pages_per_seq: int, dev) -> torch.Tensor:
    """Rows claim pages sequentially (row r: [r*ppr, (r+1)*ppr)); the rest
    of each row's table is unmapped (-1)."""
    table = torch.full((b, max_pages_per_seq), -1, dtype=torch.int64, device=dev)
    table[:, :ppr] = (torch.arange(b, device=dev)[:, None] * ppr
                      + torch.arange(ppr, device=dev)[None])
    return table.to(torch.int32)


def append_token_kv(cache: PagedKVCache, layer: int, k: torch.Tensor,
                    v: torch.Tensor) -> None:
    """Write one token per row (k, v: [B, Hkv, Dh]) into its tail page, in place.

    The page must already be mapped; the length is bumped by `advance`."""
    ps = cache.page_size
    length = cache.length.long()
    page_idx = cache.page_table.gather(1, (length // ps)[:, None])[:, 0].long()
    offset = length % ps
    cache.k_pages[layer][page_idx, :, offset] = k.to(cache.k_pages.dtype)
    cache.v_pages[layer][page_idx, :, offset] = v.to(cache.v_pages.dtype)


def advance(cache: PagedKVCache, tokens: int = 1) -> None:
    cache.length = cache.length + tokens


def paged_decode_attention(q, k_pages, v_pages, page_table, length):
    """Single-token attention through the page table (plain PyTorch):
    q [B, H, 1, Dh], one layer's pages [P, Hkv, ps, Dh] -> [B, H, 1, Dh]."""
    b, hq, _, d = q.shape
    hkv, ps = k_pages.shape[1], k_pages.shape[2]
    safe = page_table.clamp_min(0).long()
    maxp = page_table.shape[1]

    def rows(pages):
        g = pages[safe]                                   # [B, maxp, Hkv, ps, Dh]
        return g.transpose(1, 2).reshape(b, hkv, maxp * ps, d).float()

    qg = q.reshape(b, hkv, hq // hkv, d).float()
    s = torch.einsum("bhgd,bhld->bhgl", qg, rows(k_pages)) * d ** -0.5
    col = torch.arange(maxp * ps, device=q.device)
    s = s.masked_fill(col[None, None, None, :] >= length[:, None, None, None],
                      float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgl,bhld->bhgd", p, rows(v_pages))
    return o.reshape(b, hq, 1, d).to(q.dtype)


def _decode_step(params, cfg, token_ids: torch.Tensor, cache, append, attend):
    """One decode step over a paged cache, updated in place -> (logits [B, V]
    f32, cache). append(cache, layer, k, v) writes the new token's K/V;
    attend(q, layer, length) attends over the layer's pages. The new
    token's RoPE position is the row's cache length."""
    b = token_ids.shape[0]
    x = decoder.embed_tokens(params, token_ids)[:, None, :]
    positions = cache.length[:, None]
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    new_length = (cache.length + 1).to(torch.int32)
    for i, p in enumerate(params["layers"]):
        h = decoder.rmsnorm(x, p["input_norm"], cfg.rms_eps)
        q, k, v = decoder.qkv_proj(h, p["attn"], b, 1, hq, hkv, dh)
        q = decoder.rope(q, positions, cfg.rope_theta)
        k = decoder.rope(k, positions, cfg.rope_theta)
        append(cache, i, k[:, :, 0], v[:, :, 0])
        o = attend(q, i, new_length)
        x = x + decoder._proj(o.transpose(1, 2).reshape(b, 1, hq * dh), p["attn"]["o"])
        x = x + decoder.mlp_block(decoder.rmsnorm(x, p["post_norm"], cfg.rms_eps),
                                  p["mlp"])
    x = decoder.rmsnorm(x, params["final_norm"], cfg.rms_eps)
    logits = decoder.logits_from_hidden(params, cfg, x)[:, 0]
    advance(cache)
    return logits, cache


def decode_step_paged(params, cfg, token_ids: torch.Tensor, cache: PagedKVCache,
                      sequential_pages: bool = True):
    """One decode step -> (logits [B, V] f32, cache), the cache updated in place.

    Pages for the new token must be mapped. sequential_pages=True (the
    generation path: identity / partitioned row-order pools) runs the K4
    kernel wrapper; False gathers through the page table (plain PyTorch).
    """
    def attend(q, i, length):
        if sequential_pages:
            return paged_decode_attention_seq(q, cache.k_pages[i], cache.v_pages[i], length)
        return paged_decode_attention(q, cache.k_pages[i], cache.v_pages[i],
                                      cache.page_table, length)

    return _decode_step(params, cfg, token_ids, cache, append_token_kv, attend)


# ---------------------------------------------------------------------------
# Int8-quantized paged cache (per-token-per-head scales)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PagedKVCacheInt8:
    k_pages: torch.Tensor      # [L, num_pages, Hkv, page_size, Dh] int8
    v_pages: torch.Tensor
    k_scale: torch.Tensor      # [L, num_pages, Hkv, page_size] f32
    v_scale: torch.Tensor
    page_table: torch.Tensor   # [B, max_pages] int32 (-1 = unmapped)
    length: torch.Tensor       # [B] int32 tokens stored per row

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[3]


def _quantize_kv(x: torch.Tensor):
    """[..., Dh] -> (int8 values, f32 scale over the trailing dim)."""
    amax = x.abs().amax(-1).float()                # exact: |x| and max need no rounding
    scale = (amax / 127.0).masked_fill_(amax == 0, 1.0)
    vals = torch.div(x, scale[..., None]).round_().clamp_(-127, 127).to(torch.int8)
    return vals, scale


def from_contiguous_int8(cache, num_pages: int, max_pages_per_seq: int,
                         page_size: int = 128) -> PagedKVCacheInt8:
    """Quantizing twin of `from_contiguous` (dense bf16 prefill -> int8 pages),
    one layer at a time: beside the dense cache, only the int8 pool and one
    layer's f32 transients are live. An already quantized
    `decoder.Int8KVCache` (a long kv_int8 chunked prefill) is only repaged:
    its values and scales move as they are."""
    l, b, hkv, lmax, dh = cache.k.shape
    ppr = _pages_per_row(cache, num_pages, max_pages_per_seq, page_size)
    dev = cache.k.device
    pre_quantized = isinstance(cache, decoder.Int8KVCache)
    pages = {n: torch.zeros(l, num_pages, hkv, page_size, dh, dtype=torch.int8, device=dev)
             for n in ("k", "v")}
    scales = {n: torch.zeros(l, num_pages, hkv, page_size, dtype=torch.float32, device=dev)
              for n in ("k", "v")}
    for i in range(l):
        for n, dense in (("k", cache.k[i]), ("v", cache.v[i])):
            if pre_quantized:
                vals, sc = dense, getattr(cache, f"{n}_s")[i]
            else:
                vals, sc = _quantize_kv(dense)               # [B, Hkv, Lmax(, Dh)]
            pages[n][i, :b * ppr] = vals.reshape(b, hkv, ppr, page_size, dh).transpose(
                1, 2).reshape(b * ppr, hkv, page_size, dh)
            scales[n][i, :b * ppr] = sc.reshape(b, hkv, ppr, page_size).transpose(
                1, 2).reshape(b * ppr, hkv, page_size)
    return PagedKVCacheInt8(k_pages=pages["k"], v_pages=pages["v"], k_scale=scales["k"],
                            v_scale=scales["v"],
                            page_table=_row_table(b, ppr, max_pages_per_seq, dev),
                            length=cache.length.clone())


def append_token_kv_int8(cache: PagedKVCacheInt8, layer: int, k: torch.Tensor,
                         v: torch.Tensor) -> None:
    """Quantize one token per row (k, v: [B, Hkv, Dh]) into its tail page, in
    place: K and V are quantized in one pass (a decode step is bound by the
    host's launches), then one indexed store per tensor. The length is
    bumped by `advance`."""
    ps = cache.page_size
    length = cache.length.long()
    page_idx = cache.page_table.gather(1, (length // ps)[:, None])[:, 0].long()
    offset = length % ps
    vals, sc = _quantize_kv(torch.stack([k, v]))
    cache.k_pages[layer][page_idx, :, offset] = vals[0]
    cache.v_pages[layer][page_idx, :, offset] = vals[1]
    cache.k_scale[layer][page_idx, :, offset] = sc[0]
    cache.v_scale[layer][page_idx, :, offset] = sc[1]


def paged_decode_attention_int8(q, k_pages, v_pages, k_scale, v_scale, page_table, length):
    """Single-token attention over int8 pages through the page table (plain
    PyTorch): q [B, H, 1, Dh], one layer's pages [P, Hkv, ps, Dh] int8 and
    scales [P, Hkv, ps] f32 -> [B, H, 1, Dh]."""
    b, hq, _, d = q.shape
    hkv, ps = k_pages.shape[1], k_pages.shape[2]
    safe = page_table.clamp_min(0).long()
    maxp = page_table.shape[1]

    def tokord(pages):                     # [B, maxp, Hkv, ps, ...] -> token order
        g = pages[safe].transpose(1, 2)
        return g.reshape(b, hkv, maxp * ps, *g.shape[4:])

    qg = q.reshape(b, hkv, hq // hkv, d).float()
    s = torch.einsum("bhgd,bhld->bhgl", qg, tokord(k_pages).float())
    s = s * tokord(k_scale)[:, :, None, :] * d ** -0.5
    col = torch.arange(maxp * ps, device=q.device)
    s = s.masked_fill(col[None, None, None, :] >= length[:, None, None, None],
                      float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgl,bhld->bhgd", p * tokord(v_scale)[:, :, None, :],
                     tokord(v_pages).float())
    return o.reshape(b, hq, 1, d).to(q.dtype)


def decode_step_paged_int8(params, cfg, token_ids: torch.Tensor, cache: PagedKVCacheInt8,
                           sequential_pages: bool = True):
    """Int8-cache twin of `decode_step_paged`: sequential_pages=True runs the
    K6 kernel wrapper; False gathers through the page table (plain PyTorch)."""
    def attend(q, i, length):
        scales = (cache.k_scale[i], cache.v_scale[i])
        if sequential_pages:
            return paged_decode_attention_seq_int8(q, cache.k_pages[i], cache.v_pages[i],
                                                   *scales, length)
        return paged_decode_attention_int8(q, cache.k_pages[i], cache.v_pages[i], *scales,
                                           cache.page_table, length)

    return _decode_step(params, cfg, token_ids, cache, append_token_kv_int8, attend)
