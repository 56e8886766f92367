"""Paged KV cache, its page allocator and the paged decode step
(`streamchat_tpu/models/paged_kv.py`).

One pool per layer, [L, num_pages, Hkv, page_size, Dh], a per-row page
table [B, max_pages] of pool indices (-1 = unmapped), per-row lengths and
`next_free`, the sequential allocator's next unclaimed page. Prefill runs
on the dense `decoder.KVCache`; `from_contiguous` pages it, rows claiming
pages in batch order, or with `partitioned=True` row r owning the static
slice [r * max_pages, (r + 1) * max_pages) with its table fully mapped.
`allocate_pages_checked` maps the pages a row's next tokens need, in batch
order, and flags an exhausted pool or table.

The decode step dispatches as the JAX package does: `sequential_pages=True`
(an identity-mapped single row or a statically partitioned pool, pages in
row order) runs K4 (`ops.paged_attention.paged_decode_attention_seq`),
which reads each row's pages in pool order; the default runs K8
(`paged_decode_attention_table`), which reads the pool a caller sized and
the allocator filled through the table. On the card both are the same
split-K tensor-core kernel, K8's blocks walking only the mapped slots below
each row's length.

Unlike the JAX package's immutable arrays, the decode step writes the
pools IN PLACE (`ops.decode_glue.bias_rope_append`; its plain twin's
`append_kv` is one indexed store per tensor): one position per row per
step, so a decode step never copies a pool, and `advance` adds to the length
in place. The allocator returns a new cache object with a new table and
`next_free` that shares the pools: a table a caller still holds is never
changed under it. `allocate_pages_` is its in-place form, for the graphed
decode loop (`models/step_graph.py`): the table and `next_free` keep their
addresses, and the loop calls it between steps, never inside one.

H2O eviction (batch 1, bf16 pages): `decode_step_paged(positions=,
collect_mass=True)` ropes at the caller's global positions and attends
through the plain gather `paged_decode_attention`, which also returns the
attention mass a kv head (the JAX package's XLA path: no kernel
materializes the probabilities); `compress_paged_` keeps the sink, heavy
hitter and recent slots (`ops.kv_compress.compress_kv`) in the pool's
first pages and restarts the allocator after them, writing the pages,
table, length, `next_free` and scores in place.

`PagedKVCacheInt8` stores the pages as int8 with per-(token, head) f32
scales (`kv_int8`): half the pool bytes, read by the K6 kernel
(`ops.paged_attention.paged_decode_attention_seq_int8`) or through the
table by K9, with the scales commuted out of both contractions.
`from_contiguous_int8` quantizes and repages a dense bf16 prefill one layer
at a time, so the int8 pool and one layer's transients are live beside the
dense cache, never a second whole cache; a long prompt's
`decoder.Int8KVCache` is repaged as it is.
"""

from __future__ import annotations

import dataclasses

import torch

from streamchat_tpu_torch.models import decoder
from streamchat_tpu_torch.ops import decode_glue
from streamchat_tpu_torch.ops.decode_glue import quantize_kv as _quantize_kv
from streamchat_tpu_torch.ops.paged_attention import (
    paged_decode_attention_seq,
    paged_decode_attention_seq_int8,
    paged_decode_attention_table,
    paged_decode_attention_table_int8,
)

# The JAX package's masked-score value (`ops/attention.DEFAULT_MASK_VALUE`).
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


@dataclasses.dataclass
class PagedKVCache:
    k_pages: torch.Tensor      # [L, num_pages, Hkv, page_size, Dh]
    v_pages: torch.Tensor
    page_table: torch.Tensor   # [B, max_pages] int32 (-1 = unmapped)
    length: torch.Tensor       # [B] int32 tokens stored per row
    next_free: torch.Tensor    # [] int32 next unallocated pool page

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[3]

    @classmethod
    def create(cls, cfg, batch: int, num_pages: int, max_pages_per_seq: int,
               page_size: int = 128, dtype=torch.bfloat16, device="cpu") -> "PagedKVCache":
        """An empty pool: zero pages, every table entry unmapped."""
        shape = (cfg.num_layers, num_pages, cfg.num_kv_heads, page_size, cfg.head_dim)
        return _pool_like(shape, dtype, batch, max_pages_per_seq, device)


def allocate_pages_checked(cache, tokens_per_seq: torch.Tensor):
    """Map pool pages for length + tokens per row -> (cache, overflowed).

    Sequential allocation: rows claim page ranges in batch order, starting
    at `next_free`. `overflowed` is a bool tensor: True when the pool or a
    row's table ran out; the table then holds entries past the pool, which
    no decode step may read, so callers check it first. The returned cache
    has a new table and `next_free` and shares the pools. Works on
    `PagedKVCache` and `PagedKVCacheInt8`."""
    b, max_pages = cache.page_table.shape
    ps = cache.page_size
    dev = cache.page_table.device
    length = cache.length.to(dev)
    have = (length + ps - 1) // ps
    need = (length + tokens_per_seq.to(dev) + ps - 1) // ps
    extra = need - have
    starts = cache.next_free + torch.cumsum(extra, 0) - extra
    slot = torch.arange(max_pages, device=dev)[None]
    grow = (slot >= have[:, None]) & (slot < need[:, None])
    table = torch.where(grow, starts[:, None] + slot - have[:, None],
                        cache.page_table).to(torch.int32)
    next_free = (cache.next_free + extra.sum()).to(torch.int32)
    over = (next_free > cache.k_pages.shape[1]) | (need > max_pages).any()
    return dataclasses.replace(cache, page_table=table, next_free=next_free), over


def allocate_pages_(cache, tokens_per_seq: torch.Tensor) -> torch.Tensor:
    """`allocate_pages_checked` in place -> overflowed: the cache's own table
    and `next_free` take the new values. The caller reads the flag before
    any step reads the new pages."""
    new_cache, over = allocate_pages_checked(cache, tokens_per_seq)
    cache.page_table.copy_(new_cache.page_table)
    cache.next_free.copy_(new_cache.next_free)
    return over


def allocate_pages(cache, tokens_per_seq: torch.Tensor):
    """`allocate_pages_checked` that raises ValueError on overflow."""
    new_cache, over = allocate_pages_checked(cache, tokens_per_seq)
    if bool(over):
        raise ValueError(f"paged KV overflow: pool used {int(new_cache.next_free)}"
                         f"/{cache.k_pages.shape[1]} pages "
                         f"(max {cache.page_table.shape[1]} pages/seq)")
    return new_cache


# The JAX package's int8 names: the allocator works on either cache.
allocate_pages_int8_checked = allocate_pages_checked
allocate_pages_int8 = allocate_pages


def has_overflowed(cache, need: torch.Tensor | None = None) -> bool:
    """True when the pool or a row's page table has been exhausted."""
    over = bool(cache.next_free > cache.k_pages.shape[1])
    if need is None:
        ps = cache.page_size
        need = (cache.length + ps - 1) // ps
    return over or bool((need > cache.page_table.shape[1]).any())


def _pages_per_row(cache, num_pages: int, max_pages_per_seq: int, page_size: int,
                   partitioned: bool) -> int:
    _, b, _, lmax, _ = cache.k.shape
    if lmax % page_size:
        raise ValueError(f"Lmax={lmax} not a multiple of page_size={page_size}")
    ppr = lmax // page_size
    if ppr > max_pages_per_seq:
        raise ValueError("max_pages_per_seq too small for the source cache")
    if partitioned and num_pages != b * max_pages_per_seq:
        raise ValueError(f"partitioned pool needs num_pages == B*max_pages_per_seq "
                         f"({b}*{max_pages_per_seq}), got {num_pages}")
    if b * ppr > num_pages:
        raise ValueError("page pool too small for the source cache")
    return ppr


def _row_table(b: int, ppr: int, max_pages_per_seq: int, partitioned: bool, dev):
    """(table, next_free) of a paged prefill: rows claim pages sequentially
    (row r: [r*ppr, (r+1)*ppr), the rest of its table unmapped), or with
    `partitioned` row r owns [r*maxp, (r+1)*maxp), all of it mapped."""
    rows = torch.arange(b, device=dev)[:, None]
    if partitioned:
        table = rows * max_pages_per_seq + torch.arange(max_pages_per_seq, device=dev)[None]
        return table.to(torch.int32), b * max_pages_per_seq
    table = torch.full((b, max_pages_per_seq), -1, dtype=torch.int64, device=dev)
    table[:, :ppr] = rows * ppr + torch.arange(ppr, device=dev)[None]
    return table.to(torch.int32), b * ppr


def _place(x: torch.Tensor, pages: torch.Tensor, ppr: int, stride: int) -> None:
    """Write one layer's dense rows x [B, Hkv, Lmax(, Dh)] into its pool
    `pages` [num_pages, Hkv, ps(, Dh)]: row r's pages at [r * stride,
    r * stride + ppr)."""
    b, hkv = x.shape[:2]
    ps = pages.shape[2]
    src = x.reshape(b, hkv, ppr, ps, *x.shape[3:]).transpose(1, 2)
    pages[:b * stride].view(b, stride, *pages.shape[1:])[:, :ppr] = src


def _pool_like(pages_shape, dtype, b: int, max_pages_per_seq: int, dev) -> PagedKVCache:
    """An empty bf16 / f32 pool of `pages_shape`: zero pages, no page mapped."""
    return PagedKVCache(k_pages=torch.zeros(pages_shape, dtype=dtype, device=dev),
                        v_pages=torch.zeros(pages_shape, dtype=dtype, device=dev),
                        page_table=torch.full((b, max_pages_per_seq), -1, dtype=torch.int32,
                                              device=dev),
                        length=torch.zeros(b, dtype=torch.int32, device=dev),
                        next_free=torch.zeros((), dtype=torch.int32, device=dev))


def _set_rows(into, table, length, next_free: int) -> None:
    into.page_table.copy_(table)
    into.length.copy_(length)
    into.next_free.fill_(next_free)


def from_contiguous(cache: decoder.KVCache, num_pages: int, max_pages_per_seq: int,
                    page_size: int = 128, partitioned: bool = False,
                    into: PagedKVCache | None = None) -> PagedKVCache:
    """Page a prefilled dense cache: rows claim pages sequentially, or with
    `partitioned` (num_pages == B * max_pages_per_seq) row r owns the static
    slice [r * max_pages_per_seq, (r + 1) * max_pages_per_seq), table fully
    mapped, so decode needs no allocator and reads the pool in row order.

    `into`, a pool of this shape (a decode workspace's, `models/step_graph`),
    takes the rows' pages, table, length and `next_free` in place; its pages
    past the rows' keep what they held, which no decode step reads below a
    row's length. Otherwise a new zeroed pool is made."""
    l, b, hkv, lmax, dh = cache.k.shape
    ppr = _pages_per_row(cache, num_pages, max_pages_per_seq, page_size, partitioned)
    dev = cache.k.device
    stride = max_pages_per_seq if partitioned else ppr
    if into is None:
        into = _pool_like((l, num_pages, hkv, page_size, dh), cache.k.dtype, b,
                          max_pages_per_seq, dev)
    for i in range(l):
        _place(cache.k[i], into.k_pages[i], ppr, stride)
        _place(cache.v[i], into.v_pages[i], ppr, stride)
    table, next_free = _row_table(b, ppr, max_pages_per_seq, partitioned, dev)
    _set_rows(into, table, cache.length, next_free)
    return into


def advance(cache: PagedKVCache, tokens: int = 1) -> None:
    """Add `tokens` to every row's length, in place."""
    cache.length.add_(tokens)


def _decode_step(params, cfg, token_ids: torch.Tensor, cache, attend,
                 positions: torch.Tensor | None = None):
    """One decode step over a paged cache (bf16 or int8 pages), updated in
    place -> (logits [B, V] f32, cache). attend(q, layer, length) attends
    over the layer's pages. The new token's RoPE position is `positions`
    [B], by default the row's cache length; its K/V go to the row's tail
    page. The glue between the projections and attention is
    `ops.decode_glue`'s: in the decode regime four kernels a layer (add +
    RMSNorm twice, bias + RoPE + KV append, SiLU x up) and the final add +
    RMSNorm, the residual stream updated in place."""
    b = token_ids.shape[0]
    x = decoder.embed_tokens(params, token_ids)[:, None, :]
    hq, dh = cfg.num_heads, cfg.head_dim
    new_length = (cache.length + 1).to(torch.int32)
    int8 = isinstance(cache, PagedKVCacheInt8)
    delta = None
    for i, p in enumerate(params["layers"]):
        x, h = decode_glue.add_rmsnorm(x, delta, p["input_norm"], cfg.rms_eps)
        q = decode_glue.bias_rope_append(
            *decoder.qkv_linear(h, p["attn"]), decoder.qkv_bias(p["attn"]), positions,
            cfg.rope_theta, cache.k_pages[i], cache.v_pages[i],
            cache.k_scale[i] if int8 else None, cache.v_scale[i] if int8 else None,
            cache.page_table, cache.length)
        o = attend(q, i, new_length)
        x, h = decode_glue.add_rmsnorm(
            x, decoder.attn_out(params, o.transpose(1, 2).reshape(b, 1, hq * dh), p["attn"]),
            p["post_norm"], cfg.rms_eps)
        delta = decoder.mlp_out(params, h, p["mlp"], glu=decode_glue.silu_mul)
    _, x = decode_glue.add_rmsnorm(x, delta, params["final_norm"], cfg.rms_eps)
    logits = decoder.logits_from_hidden(params, cfg, x)[:, 0]
    advance(cache)
    return logits, cache


def decode_step_paged(params, cfg, token_ids: torch.Tensor, cache: PagedKVCache,
                      positions: torch.Tensor | None = None, collect_mass: bool = False,
                      sequential_pages: bool = False):
    """One decode step -> (logits [B, V] f32, cache[, mass]), the cache
    updated in place.

    Pages for the new token must be mapped (`allocate_pages`). As in the JAX
    package, sequential_pages=True is for a pool in row order (a single
    identity-mapped row, or a statically partitioned pool) and runs the K4
    kernel wrapper; the default reads the pages through the table (K8).
    `positions` [B]: the new token's RoPE position, by default the cache
    length; after an H2O eviction the cache holds fewer slots than tokens
    seen, so the caller passes the true position (evicted keys keep their
    rotary phase). `collect_mass` also returns each layer's attention mass
    [L, B, Hkv, maxp * page_size] (query groups summed): the heavy-hitter
    statistic. Only the probabilities give it and no kernel materializes
    them, so that step attends through the plain gather
    (`paged_decode_attention`), on the card too, as the JAX package's
    dispatch takes XLA's gather whenever it collects mass.
    """
    masses = []

    def attend(q, i, length):
        if collect_mass:
            o, mass = paged_decode_attention(q, cache.k_pages[i], cache.v_pages[i],
                                             cache.page_table, length, return_mass=True)
            masses.append(mass)
            return o
        if sequential_pages:
            return paged_decode_attention_seq(q, cache.k_pages[i], cache.v_pages[i], length)
        return paged_decode_attention_table(q, cache.k_pages[i], cache.v_pages[i],
                                            cache.page_table, length)

    logits, cache = _decode_step(params, cfg, token_ids, cache, attend, positions)
    if collect_mass:
        return logits, cache, torch.stack(masses)
    return logits, cache


def paged_decode_attention(q, k_pages, v_pages, page_table, length, sm_scale=None,
                           return_mass: bool = False):
    """Single-token attention through the page table by gathering the
    table's pages (the JAX package's XLA path) -> [B, Hq, 1, Dh]; with
    return_mass also the per-kv-head attention mass [B, Hkv, maxp *
    page_size] (query groups summed). q [B, Hq, 1, Dh], one layer's pages
    [num_pages, Hkv, page_size, Dh], page_table [B, maxp] (-1 reads page 0,
    masked by `length` [B])."""
    b, hq, _, d = q.shape
    hkv, ps = k_pages.shape[1], k_pages.shape[2]
    if sm_scale is None:
        sm_scale = d ** -0.5
    maxp = page_table.shape[1]
    table = page_table.clamp_min(0).long()

    def rows(pages):                                   # [B, Hkv, maxp * ps, Dh]
        return pages[table].transpose(1, 2).reshape(b, hkv, maxp * ps, d).float()

    qg = q.reshape(b, hkv, hq // hkv, d).float()
    s = torch.einsum("bhgd,bhld->bhgl", qg, rows(k_pages)) * sm_scale
    col = torch.arange(maxp * ps, device=q.device)
    s = s.masked_fill(col[None, None, None, :] >= length.to(q.device)[:, None, None, None],
                      DEFAULT_MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    valid = col[None, None, :, None] < length.to(q.device)[:, None, None, None]
    v = torch.where(valid, rows(v_pages), 0.0)          # 0 x NaN past the length is NaN
    o = torch.einsum("bhgl,bhld->bhgd", p, v).reshape(b, hq, 1, d).to(q.dtype)
    if return_mass:
        return o, p.sum(2)
    return o


def compress_paged_(cache: PagedKVCache, hh_score: torch.Tensor, *, hh_size: int,
                    recent_size: int, sink_size: int = 4, merge=None) -> None:
    """H2O-compress a batch-1 paged cache and its scores, in place.

    Gathers the table's pages into token order, runs
    `ops.kv_compress.compress_kv` on every layer's heads at once with the
    accumulated scores hh_score [L, Hkv, maxp * page_size], and writes the
    surviving C = sink + hh + recent slots into pool pages [0,
    ceil(C / page_size)) (zeros after them in the last page). The table then
    maps just those pages, the length is the kept count, the allocator
    restarts after them (`next_free`) and the scores hold the kept slots'
    (zeros after them): every tensor keeps its address, so a graphed decode
    step reads the compressed cache where it read the old one. Decoding
    goes on with cap - C free slots. Evicted keys keep their RoPE phase: the
    caller tracks each token's global position
    (`decode_step_paged(positions=)`)."""
    from streamchat_tpu_torch.ops.kv_compress import compress_kv

    n_layers, _, hkv, ps, dh = cache.k_pages.shape
    b, maxp = cache.page_table.shape
    if b != 1:
        raise ValueError("compress_paged_ supports batch 1")
    cap = maxp * ps
    c = sink_size + hh_size + recent_size
    if c >= cap:
        raise ValueError(f"compressed size {c} must be < capacity {cap}")
    table = cache.page_table[0].clamp_min(0).long()

    def gather(pages):                                 # [L * Hkv, cap, Dh], a copy
        return pages[:, table].transpose(1, 2).reshape(n_layers * hkv, cap, dh)

    k2, v2, s2, kept = compress_kv(gather(cache.k_pages), gather(cache.v_pages),
                                   hh_score.reshape(n_layers * hkv, cap), cache.length[0],
                                   hh_size=hh_size, recent_size=recent_size,
                                   sink_size=sink_size, merge=merge)
    c_pages = -(-c // ps)

    def repage(x, pages):
        out = torch.zeros(n_layers, hkv, c_pages * ps, dh, dtype=pages.dtype, device=x.device)
        out[:, :, :c] = x.reshape(n_layers, hkv, c, dh)
        pages[:, :c_pages] = out.reshape(n_layers, hkv, c_pages, ps, dh).transpose(1, 2)

    repage(k2, cache.k_pages)
    repage(v2, cache.v_pages)
    scores = s2.reshape(n_layers, hkv, c).clone()      # s2 may view hh_score
    hh_score.zero_()
    hh_score[:, :, :c] = scores
    slots = torch.arange(maxp, device=cache.page_table.device)
    _set_rows(cache, torch.where(slots < c_pages, slots, -1)[None], kept.reshape(1), c_pages)


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
    next_free: torch.Tensor    # [] int32 next unallocated pool page

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[3]


def from_contiguous_int8(cache, num_pages: int, max_pages_per_seq: int,
                         page_size: int = 128, partitioned: bool = False,
                         into: PagedKVCacheInt8 | None = None) -> PagedKVCacheInt8:
    """Quantizing twin of `from_contiguous` (dense bf16 prefill -> int8 pages,
    `partitioned` and `into` as there), one layer at a time: beside the
    dense cache, only the int8 pool and one layer's f32 transients are
    live. An already quantized `decoder.Int8KVCache` (a long kv_int8
    chunked prefill) is only repaged: its values and scales move as they
    are."""
    l, b, hkv, lmax, dh = cache.k.shape
    ppr = _pages_per_row(cache, num_pages, max_pages_per_seq, page_size, partitioned)
    dev = cache.k.device
    stride = max_pages_per_seq if partitioned else ppr
    if into is None:
        shape = (l, num_pages, hkv, page_size, dh)
        into = PagedKVCacheInt8(
            k_pages=torch.zeros(shape, dtype=torch.int8, device=dev),
            v_pages=torch.zeros(shape, dtype=torch.int8, device=dev),
            k_scale=torch.zeros(shape[:4], dtype=torch.float32, device=dev),
            v_scale=torch.zeros(shape[:4], dtype=torch.float32, device=dev),
            page_table=torch.full((b, max_pages_per_seq), -1, dtype=torch.int32, device=dev),
            length=torch.zeros(b, dtype=torch.int32, device=dev),
            next_free=torch.zeros((), dtype=torch.int32, device=dev))
    pre_quantized = isinstance(cache, decoder.Int8KVCache)
    for i in range(l):
        for n, dense in (("k", cache.k[i]), ("v", cache.v[i])):
            if pre_quantized:
                vals, sc = dense, getattr(cache, f"{n}_s")[i]
            else:
                vals, sc = _quantize_kv(dense)               # [B, Hkv, Lmax(, Dh)]
            _place(vals, getattr(into, f"{n}_pages")[i], ppr, stride)
            _place(sc, getattr(into, f"{n}_scale")[i], ppr, stride)
    table, next_free = _row_table(b, ppr, max_pages_per_seq, partitioned, dev)
    _set_rows(into, table, cache.length, next_free)
    return into


def append_token_kv_int8(cache: PagedKVCacheInt8, layer: int, k: torch.Tensor,
                         v: torch.Tensor) -> None:
    """Quantize one token per row (k, v: [B, Hkv, Dh]) into its tail page, in
    place: K and V are quantized in one pass, then one indexed store per
    tensor. The length is bumped by `advance`."""
    decode_glue.append_kv(k, v, cache.k_pages[layer], cache.v_pages[layer],
                          cache.k_scale[layer], cache.v_scale[layer], cache.page_table,
                          cache.length)


def decode_step_paged_int8(params, cfg, token_ids: torch.Tensor, cache: PagedKVCacheInt8,
                           sequential_pages: bool = False):
    """Int8-cache twin of `decode_step_paged`: sequential_pages=True runs the
    K6 kernel wrapper; the default reads the pages through the table (K9)."""
    def attend(q, i, length):
        scales = (cache.k_scale[i], cache.v_scale[i])
        if sequential_pages:
            return paged_decode_attention_seq_int8(q, cache.k_pages[i], cache.v_pages[i],
                                                   *scales, length)
        return paged_decode_attention_table_int8(q, cache.k_pages[i], cache.v_pages[i],
                                                 *scales, cache.page_table, length)

    return _decode_step(params, cfg, token_ids, cache, attend)
