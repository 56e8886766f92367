"""Attention over a sequential page pool, with their plain twins: one-token
decode over bf16 pages (K4) and int8 pages (K6), and the multi-query
partial form of both for the speculative verify step (K7); and one-token
decode through a page table over bf16 pages (K8) and int8 pages (K9).

Counterparts of `streamchat_tpu/ops/paged_attention.py`
`paged_decode_attention_pallas_seq`, `paged_decode_attention_pallas_seq_int8`
and `paged_seq_attention_partial{,_int8}`: pages are in pool order — the identity table at B = 1, and at B > 1 a
statically partitioned pool where row b owns pages [b * row_pages,
(b + 1) * row_pages), row_pages = num_pages // B — and `length` [B] masks
each row's keys. Int8 pages carry per-(token, head) f32 scales that commute
out of both contractions: s = (q . k_i8) * k_scale * D^-0.5 and
o = sum_l p_l v_scale_l v_i8_l / sum_l p_l. K7 takes T in-flight queries
q [B, Hq, T, D] against the pool (length counts pool tokens, the block
excluded) and returns the unnormalized f32 (acc [B, Hq, T, D], m, l
[B, Hq, T]), m clamped to -1e30; a row with no live key gets acc 0 and
l 0.

K8 / K9 (`paged_decode_attention_table{,_int8}`, counterparts of
`paged_decode_attention_pallas{,_int8}`) read a shared pool through
`page_table` [B, maxp] int32 (-1 = unmapped), as the allocator fills it
(`models/paged_kv.allocate_pages_checked`). Their semantics are the Pallas
kernels', not the XLA gather's: a table slot j with table[b, j] < 0 or
j * page_size >= length[b] contributes no key (the gather reads page 0 for
-1), and a row with no live key returns 0 (the gather averages uniformly).
The two agree wherever every page below a row's length is mapped, which the
allocator guarantees. Every table entry must be -1 or a page of the pool.

A CUDA tensor launches `csrc/paged_decode.cu` (page ranges split across
blocks, then a merge kernel); a CPU tensor runs the plain twin. All six
run its Hopper kernels (TMA, wgmma; int8 tiles converted to bf16 in shared
memory) over the ranges and row tiles of `paged_split`, for any g * T: K4,
K6, K7 and K7' over a partitioned pool's pages in order, K8 and K9 over
ranges of a row's table slots, each block walking only the pages of its
slots that are mapped and start below the row's length (`table_blocks`
states that walk). The wrappers' geometry checks are `launch_plan`, which
needs no tensor.
"""

from __future__ import annotations

from typing import Optional

import torch

from streamchat_tpu_torch.kernels import counted, launched

# The H100's SMs, and the page kernels' blocks resident on each
# (csrc/paged_decode.cu paged_tc_kernel / paged_tc_i8_kernel: 128 threads
# and 97-107 KB of shared memory).
SMS, RESIDENT_BLOCKS = 132, 2
# Query rows of one block (one wgmma M tile), keys per tile (a page size
# must be a multiple of it), and the table slots a K8 / K9 block can list
# in shared memory, the most a range may hold (csrc/paged_decode.cu ROWS,
# KEYS, TABLE_SLOTS).
TILE_ROWS, KEY_TILE, TABLE_SLOTS = 64, 64, 2048


def row_tiles(rows: int):
    """A kv head's `rows` folded query rows (g for K4 / K6, g * T for K7 /
    K7') as the Hopper kernels cut them -> [(first, end)] row tiles of
    TILE_ROWS rows, the last one ragged."""
    return [(r, min(r + TILE_ROWS, rows)) for r in range(0, rows, TILE_ROWS)]


def paged_split(b: int, hkv: int, row_pages: int, rows: int = 1) -> dict:
    """The grid of the page kernels over `b` rows of `row_pages` page slots
    (K4 / K6 / K7 / K7': a partitioned pool's pages; K8 / K9: the page
    table's maxp slots), `hkv` kv heads and `rows` query rows per kv head, as
    `csrc/paged_decode.cu` walks it: each row's slots cut into `ranges`
    ranges of whole slots, range r holding slots [r * row_pages // ranges,
    (r + 1) * row_pages // ranges) (sizes differ by at most one), one block
    per (range, row tile, kv head, row). It depends on the static
    `row_pages` and `rows` only, never on the lengths or the table (on the
    device): one wave of SMS x RESIDENT_BLOCKS blocks, all resident at once,
    or a block per slot and row tile where there are fewer slots than
    that."""
    tiles = len(row_tiles(rows))
    heads = b * hkv * tiles
    ranges = max(1, min(row_pages, SMS * RESIDENT_BLOCKS // heads))
    return dict(ranges=ranges, row_tiles=tiles, blocks=heads * ranges)


def paged_blocks(b: int, hkv: int, row_pages: int, rows: int = 1):
    """Every block of `paged_split` -> [(row, kv head, first page, end page,
    first query row, end query row)], pages in the pool, in launch order
    (row tiles fastest, then ranges)."""
    n = paged_split(b, hkv, row_pages, rows)["ranges"]
    return [(r, h, r * row_pages + i * row_pages // n, r * row_pages + (i + 1) * row_pages // n,
             first, end)
            for r in range(b) for h in range(hkv) for i in range(n)
            for first, end in row_tiles(rows)]


def table_blocks(page_table, length, hkv: int, page_size: int, rows: int = 1):
    """Every block of K8 / K9 over `page_table` [B, maxp] (-1 = unmapped)
    and `length` [B], as `csrc/paged_decode.cu` walks them, in launch order
    (row tiles fastest, then ranges) -> [(row, kv head, first slot, end
    slot, first query row, end query row, live slots, live keys)]. The
    ranges are `paged_split`'s over the maxp slots. A block walks, in slot
    order, the slots of its range that are mapped and start below the row's
    length (it reads their pages and no other), and its live-key count
    masks the rest: every live page is full but the one that holds the
    length."""
    table, lengths = page_table.tolist(), length.tolist()
    b, maxp = len(table), len(table[0])
    n = paged_split(b, hkv, maxp, rows)["ranges"]
    out = []
    for r in range(b):
        walks = []
        for i in range(n):
            first, end = i * maxp // n, (i + 1) * maxp // n
            live = [s for s in range(first, end)
                    if table[r][s] >= 0 and s * page_size < lengths[r]]
            keys = len(live) * page_size - (max(0, (live[-1] + 1) * page_size - lengths[r])
                                            if live else 0)
            walks.append((first, end, live, keys))
        out += [(r, h, first, end, q0, q1, live, keys) for h in range(hkv)
                for first, end, live, keys in walks for q0, q1 in row_tiles(rows)]
    return out


def launch_plan(b: int, hq: int, hkv: int, t: int, d: int, num_pages: int, page_size: int, *,
                partial: bool = False, maxp: Optional[int] = None) -> dict:
    """The geometry checks of one launch and its grid, from shapes alone:
    q [b, hq, t, d] against a pool of `num_pages` pages of `page_size`
    slots; `partial` for K7 / K7' (any t), else one token (K4 / K6 / K8 /
    K9); `maxp` the page table's width for K8 / K9 (None: the partitioned
    pool). Raises ValueError on what the kernels do not take -> dict(
    row_pages (K8 / K9: maxp), ranges, rows per kv head, row_tiles (as
    `row_tiles`), blocks of the attention kernel)."""
    bad = f"unsupported q {(b, hq, t, d)} pages {(num_pages, hkv, page_size, d)}"
    if (b < 1 or t < 1 or hkv < 1 or hq % hkv or d not in (64, 128)
            or (t != 1 and not partial)):
        raise ValueError(bad)
    if page_size % KEY_TILE:
        raise ValueError(f"{bad}: page_size {page_size} is not a multiple of {KEY_TILE}")
    rows = hq // hkv * t
    if maxp is not None:
        if partial or maxp < 1:
            raise ValueError(f"{bad}: the table kernels take one token and maxp >= 1")
        row_pages = maxp
    else:
        if num_pages % b:
            raise ValueError(f"{bad}: pool of {num_pages} pages not divisible into {b} rows")
        row_pages = num_pages // b
    split = paged_split(b, hkv, row_pages, rows)
    if maxp is not None and -(-maxp // split["ranges"]) > TABLE_SLOTS:
        raise ValueError(f"{bad}: a range of {-(-maxp // split['ranges'])} table slots "
                         f"does not fit a block's list of {TABLE_SLOTS}")
    return dict(row_pages=row_pages, ranges=split["ranges"], rows=rows,
                row_tiles=row_tiles(rows), blocks=split["blocks"])


def attributes(d: int = 128, int8: bool = False, table: bool = False) -> dict:
    """The Hopper page kernel over bf16 pages (K4, K7; with `table`, K8) or,
    with `int8`, int8 pages (K6, K7'; with `table`, K9): registers and local
    (spill) bytes per thread, static and dynamic shared bytes, blocks
    resident on one SM (sc_paged_decode_attributes)."""
    import ctypes

    from streamchat_tpu_torch.kernels.build import library

    out = (ctypes.c_int * 5)()
    err = library().sc_paged_decode_attributes(d, int(int8), int(table), out)
    if err:
        raise RuntimeError(f"sc_paged_decode_attributes: CUDA error {err}")
    return dict(num_regs=out[0], local_bytes=out[1], static_shared_bytes=out[2],
                dynamic_shared_bytes=out[3], resident_blocks=out[4])


def _rows(pages, b, row_pages):
    """[b * row_pages, Hkv, ps, ...] pool -> [b, Hkv, row_pages * ps, ...]."""
    _, hkv, ps = pages.shape[:3]
    x = pages.reshape(b, row_pages, hkv, ps, *pages.shape[3:]).transpose(1, 2)
    return x.reshape(b, hkv, row_pages * ps, *pages.shape[3:])


def paged_decode_attention_seq_plain(q, k_pages, v_pages, length):
    """Plain PyTorch twin of `paged_decode_attention_seq` (same signature);
    slots at or past a row's length may hold any garbage, NaN included."""
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
    v = torch.where(col[None, None, :, None] < length.to(q.device)[:, None, None, None],
                    _rows(v_pages, b, row_pages).float(), 0.0)
    o = torch.einsum("bhgl,bhld->bhgd", p, v)
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


def _seq_partial_plain(q, k_pages, v_pages, k_scale, v_scale, length):
    """(acc, m, l) of q [B, Hq, T, D] against the pool; rows fold head-major
    (row g_i * T + t_i is head hk * g + g_i at token t_i) as the kernel does."""
    b, hq, t, d = q.shape
    num_pages, hkv, ps, _ = k_pages.shape
    if num_pages % b:
        raise ValueError(f"pool of {num_pages} pages not divisible into {b} rows")
    row_pages = num_pages // b
    valid = (torch.arange(row_pages * ps, device=q.device)[None, None, :]
             < length.to(q.device)[:, None, None])                      # [B, 1, L]
    qg = q.reshape(b, hkv, hq // hkv * t, d).float()
    s = torch.einsum("bhrd,bhld->bhrl", qg, _rows(k_pages, b, row_pages).float())
    if k_scale is not None:
        s = s * _rows(k_scale, b, row_pages)[:, :, None, :]
    s = (s * d ** -0.5).masked_fill(~valid[:, :, None, :], float("-inf"))
    m = s.amax(-1).clamp_min(-1e30)
    p = torch.exp(s - m[..., None])
    v = _rows(v_pages, b, row_pages).float()
    if v_scale is not None:
        v = v * _rows(v_scale, b, row_pages)[..., None]
    acc = torch.einsum("bhrl,bhld->bhrd", p, torch.where(valid[..., None], v, 0.0))
    return acc.reshape(b, hq, t, d), m.reshape(b, hq, t), p.sum(-1).reshape(b, hq, t)


def paged_seq_attention_partial_plain(q, k_pages, v_pages, length):
    """Plain twin of `paged_seq_attention_partial` (same signature)."""
    return _seq_partial_plain(q, k_pages, v_pages, None, None, length)


def paged_seq_attention_partial_int8_plain(q, k_pages, v_pages, k_scale, v_scale, length):
    """Plain twin of `paged_seq_attention_partial_int8` (same signature);
    slots at or past a row's length may hold any garbage."""
    return _seq_partial_plain(q, k_pages, v_pages, k_scale, v_scale, length)


def _table_valid(page_table, length, ps):
    """[B, maxp * ps] bool: the key at each table position is live (its slot
    is mapped and it lies below the row's length)."""
    b, maxp = page_table.shape
    col = torch.arange(maxp * ps, device=page_table.device)[None]
    return (col < length.to(page_table.device)[:, None]) & (
        page_table >= 0).repeat_interleave(ps, dim=1)


def _table_rows(pages, page_table):
    """Pool [P, Hkv, ps, ...] through table [B, maxp] -> [B, Hkv, maxp * ps,
    ...] (unmapped slots read page 0; the caller masks them)."""
    b, maxp = page_table.shape
    g = pages[page_table.clamp_min(0).long()].transpose(1, 2)
    return g.reshape(b, pages.shape[1], maxp * pages.shape[2], *pages.shape[3:])


def _table_decode_plain(q, k_pages, v_pages, k_scale, v_scale, page_table, length):
    b, hq, _, d = q.shape
    hkv, ps = k_pages.shape[1], k_pages.shape[2]
    valid = _table_valid(page_table, length, ps)[:, None]                 # [B, 1, L]
    qg = q.reshape(b, hkv, hq // hkv, d).float()
    s = torch.einsum("bhgd,bhld->bhgl", qg, _table_rows(k_pages, page_table).float())
    if k_scale is not None:
        s = s * _table_rows(k_scale, page_table)[:, :, None, :]
    s = (s * d ** -0.5).masked_fill(~valid[:, :, None, :], float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    v = _table_rows(v_pages, page_table).float()
    if v_scale is not None:
        v = v * _table_rows(v_scale, page_table)[..., None]
    o = torch.einsum("bhgl,bhld->bhgd", p, torch.where(valid[..., None], v, 0.0))
    o = o / torch.where(l == 0, torch.ones_like(l), l)
    return o.reshape(b, hq, 1, d).to(q.dtype)


def paged_decode_attention_table_plain(q, k_pages, v_pages, page_table, length):
    """Plain twin of `paged_decode_attention_table` (same signature).
    Unmapped pages and slots past a row's length may hold any garbage."""
    return _table_decode_plain(q, k_pages, v_pages, None, None, page_table, length)


def paged_decode_attention_table_int8_plain(q, k_pages, v_pages, k_scale, v_scale,
                                            page_table, length):
    """Plain twin of `paged_decode_attention_table_int8` (same signature)."""
    return _table_decode_plain(q, k_pages, v_pages, k_scale, v_scale, page_table, length)


def _launch(name, q, k_pages, v_pages, scales, length, page_dtype, partial=False,
            table=None):
    """Checks and one launch of the K4 / K6 (normalized bf16 output) or, with
    `partial`, the K7 / K7' (f32 acc, m, l) entry point `name`; with a page
    `table` [B, maxp] the K8 / K9 one."""
    from streamchat_tpu_torch.kernels.build import call

    b, hq, t, d = q.shape
    num_pages, hkv, ps, _ = k_pages.shape
    bf = torch.bfloat16
    for t_name, x, dtype in (("q", q, bf), ("k_pages", k_pages, page_dtype),
                             ("v_pages", v_pages, page_dtype)):
        if x.device.type != "cuda" or x.dtype != dtype:
            raise ValueError(f"{name} {t_name}: expected CUDA {dtype}, got "
                             f"{x.device} {x.dtype}")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()) or (
            k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16):
        raise ValueError(f"{name}: pages must be contiguous and 16-byte aligned")
    if tuple(v_pages.shape) != tuple(k_pages.shape) or q.stride(-1) != 1 or k_pages.shape[3] != d:
        raise ValueError(f"{name}: unsupported q {tuple(q.shape)} "
                         f"pages {tuple(k_pages.shape)}")
    for x in scales:
        if (x.device != q.device or x.dtype != torch.float32 or not x.is_contiguous()
                or tuple(x.shape) != (num_pages, hkv, ps) or x.data_ptr() % 16):
            raise ValueError(f"{name} scales: expected contiguous 16-byte aligned f32 "
                             f"{(num_pages, hkv, ps)} on the query's device, got "
                             f"{x.device} {x.dtype} {tuple(x.shape)}")
    if (length.device != q.device or length.dtype != torch.int32
            or tuple(length.shape) != (b,)):
        raise ValueError(f"{name} length: expected int32 [B] on the query's device")
    length, tab = length.contiguous(), ()
    if table is not None:
        if (table.device != q.device or table.dtype != torch.int32 or table.dim() != 2
                or table.shape[0] != b):
            raise ValueError(f"{name} page_table: expected int32 [B, maxp] on the "
                             f"query's device, got {table.device} {table.dtype} "
                             f"{tuple(table.shape)}")
        table = table.contiguous()
        tab = (table.data_ptr(),)
    plan = launch_plan(b, hq, hkv, t, d, num_pages, ps, partial=partial,
                       maxp=None if table is None else table.shape[1])
    rows = b * hkv * plan["ranges"] * plan["rows"]       # query rows of every range
    f32 = dict(dtype=torch.float32, device=q.device)
    scratch = torch.empty(rows * (d + 2), **f32)          # their acc, m and l
    base = scratch.data_ptr()
    pool = (num_pages,) if table is not None else ()      # K8 / K9: the TMA maps' extent
    geometry = (length.data_ptr(), b, hq, hkv, *pool, plan["row_pages"], ps, plan["ranges"], d,
                d ** -0.5, base, base + 4 * rows * d, base + 4 * rows * (d + 1))
    pages = (k_pages.data_ptr(), v_pages.data_ptr(), *[x.data_ptr() for x in scales], *tab)
    stream = torch.cuda.current_stream().cuda_stream
    if not partial:
        out = torch.empty(b, hq, 1, d, dtype=bf, device=q.device)
        call(name, q.data_ptr(), q.stride(0), q.stride(1), *pages, *geometry, out.data_ptr(),
             stream)
        return out
    n = b * hq * t
    res = torch.empty(n * (d + 2), **f32)
    acc, m, l = res[:n * d].view(b, hq, t, d), res[n * d:n * (d + 1)].view(b, hq, t), \
        res[n * (d + 1):].view(b, hq, t)
    call(name, q.data_ptr(), q.stride(0), q.stride(1), q.stride(2), t, *pages, *geometry,
         acc.data_ptr(), m.data_ptr(), l.data_ptr(), stream)
    return acc, m, l


@counted
def paged_decode_attention_seq(q, k_pages, v_pages, length):
    """One-token decode attention (K4), scores scaled by D^-0.5: q
    [B, Hq, 1, D], one layer's pages [num_pages, Hkv, page_size, D],
    length [B] int32 -> [B, Hq, 1, D]."""
    if q.device.type == "cpu":
        return paged_decode_attention_seq_plain(q, k_pages, v_pages, length)
    out = _launch("sc_paged_decode", q, k_pages, v_pages, (), length, torch.bfloat16)
    launched(paged_decode_attention_seq)
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
    launched(paged_decode_attention_seq_int8)
    return out


@counted
def paged_decode_attention_table(q, k_pages, v_pages, page_table, length):
    """One-token decode attention through a page table (K8): q [B, Hq, 1, D],
    one layer's pages [num_pages, Hkv, page_size, D], page_table [B, maxp]
    int32 (-1 = unmapped), length [B] int32 -> [B, Hq, 1, D]."""
    if q.device.type == "cpu":
        return paged_decode_attention_table_plain(q, k_pages, v_pages, page_table, length)
    out = _launch("sc_paged_decode_table", q, k_pages, v_pages, (), length, torch.bfloat16,
                  table=page_table)
    launched(paged_decode_attention_table)
    return out


@counted
def paged_decode_attention_table_int8(q, k_pages, v_pages, k_scale, v_scale, page_table,
                                      length):
    """K8 over int8 pages with f32 scales [num_pages, Hkv, page_size] (K9)."""
    if q.device.type == "cpu":
        return paged_decode_attention_table_int8_plain(q, k_pages, v_pages, k_scale, v_scale,
                                                       page_table, length)
    out = _launch("sc_paged_decode_table_int8", q, k_pages, v_pages, (k_scale, v_scale),
                  length, torch.int8, table=page_table)
    launched(paged_decode_attention_table_int8)
    return out


@counted
def paged_seq_attention_partial(q, k_pages, v_pages, length):
    """Multi-query partial attention (K7), scores scaled by D^-0.5: q
    [B, Hq, T, D] (any T) against one layer's bf16 pages, length [B]
    int32 pool tokens -> (acc f32 [B, Hq, T, D] unnormalized, m, l f32
    [B, Hq, T])."""
    if q.device.type == "cpu":
        return paged_seq_attention_partial_plain(q, k_pages, v_pages, length)
    res = _launch("sc_paged_seq_partial", q, k_pages, v_pages, (), length, torch.bfloat16,
                  partial=True)
    launched(paged_seq_attention_partial)
    return res


@counted
def paged_seq_attention_partial_int8(q, k_pages, v_pages, k_scale, v_scale, length):
    """K7 over int8 pages with f32 scales [num_pages, Hkv, page_size] (K7')."""
    if q.device.type == "cpu":
        return paged_seq_attention_partial_int8_plain(q, k_pages, v_pages, k_scale, v_scale,
                                                      length)
    res = _launch("sc_paged_seq_partial_int8", q, k_pages, v_pages, (k_scale, v_scale),
                  length, torch.int8, partial=True)
    launched(paged_seq_attention_partial_int8)
    return res
