"""The grid of the Hopper paged-decode kernels (K4, K6-K9) on the CPU.

`ops/paged_attention.paged_split` states in Python the page ranges and query
row tiles that `csrc/paged_decode.cu` gives its blocks; `paged_blocks` lists
them, and `launch_plan` is the wrappers' geometry check, from shapes alone.
Every (row, kv head, page, query row) of a partitioned pool must fall in
exactly one block, ranges hold whole pages and differ by at most one page,
and the grid is one wave of two blocks for each of the H100's 132 SMs
wherever the pool has a page for each of them. Any g * T is taken: the
verify step's folded rows at Qwen2-7B's g 7 (T up to 16) and the judge's g
4 (T up to 28), up to 112 rows, cut into 64-row tiles. The table kernels
(K8, K9) take the same grid over a table's maxp slots, for any g;
`table_blocks` states each block's walk of its live slots, which is held to
`_table_valid` over allocator-built tables (holes inside a length, rows
with no mapped slot, B 1-3): every live (row, kv head, key, query row) in
exactly one block, no dead slot walked, and the walk's partials, merged,
equal to the plain twin.
"""

import collections
import types

import numpy as np
import pytest
import torch

from streamchat_tpu_torch.models import paged_kv
from streamchat_tpu_torch.ops import paged_attention as pa

HKV = 4


def _check_grid(b, row_pages, rows):
    split = pa.paged_split(b, HKV, row_pages, rows)
    blocks = pa.paged_blocks(b, HKV, row_pages, rows)
    assert len(blocks) == split["blocks"] == b * HKV * split["ranges"] * split["row_tiles"]
    seen = collections.Counter()
    sizes = set()
    for row, head, first, end, r0, r1 in blocks:
        assert row * row_pages <= first < end <= (row + 1) * row_pages
        assert 0 <= r0 < r1 <= rows and r1 - r0 <= pa.TILE_ROWS
        sizes.add(end - first)
        seen.update((row, head, page, q) for page in range(first, end) for q in range(r0, r1))
    want = {(r, h, r * row_pages + p, q) for r in range(b) for h in range(HKV)
            for p in range(row_pages) for q in range(rows)}
    assert set(seen) == want and set(seen.values()) == {1}
    assert max(sizes) - min(sizes) <= 1
    return split


@pytest.mark.parametrize("b,row_pages", [(1, 182), (2, 91), (1, 1), (1, 17), (1, 4096)])
def test_paged_split_covers_every_page_once_and_fills_the_card(b, row_pages):
    split = _check_grid(b, row_pages, 1)
    wave = pa.SMS * pa.RESIDENT_BLOCKS
    assert wave == 2 * 132
    if b * HKV * row_pages >= wave:
        assert split["blocks"] == wave
    else:
        assert split["ranges"] == row_pages          # a block per page


@pytest.mark.parametrize("g", [7, 4])
@pytest.mark.parametrize("b,row_pages", [(1, 182), (2, 91), (1, 3)])
def test_launch_plan_takes_any_rows_in_one_wave(g, b, row_pages):
    """Every g * T up to 112 is accepted for K7 / K7' (and every g for K4 /
    K6); its row tiles cover each folded row exactly once, and the grid
    stays within one resident wave, filling it where the pool has pages."""
    wave = pa.SMS * pa.RESIDENT_BLOCKS
    for t in range(1, 112 // g + 1):
        plan = pa.launch_plan(b, g * HKV, HKV, t, 128, b * row_pages, 128, partial=True)
        rows = g * t
        assert plan["rows"] == rows and plan["row_pages"] == row_pages
        covered = [q for first, end in plan["row_tiles"] for q in range(first, end)]
        assert covered == list(range(rows))
        assert len(plan["row_tiles"]) == -(-rows // pa.TILE_ROWS)
        split = _check_grid(b, row_pages, rows)
        assert plan["blocks"] == split["blocks"] <= wave
        if b * HKV * len(plan["row_tiles"]) * row_pages >= wave:
            assert plan["blocks"] > wave - b * HKV * len(plan["row_tiles"])
    for hq in (HKV, 8 * HKV, 16 * HKV, 28 * HKV):               # K4 / K6: any g
        plan = pa.launch_plan(b, hq, HKV, 1, 64, b * row_pages, 128)
        assert plan["rows"] == hq // HKV


@pytest.mark.parametrize("kwargs", [
    dict(b=1, hq=28, hkv=4, t=2, d=128, num_pages=182, page_size=128),   # K4 / K6: one token
    dict(b=1, hq=28, hkv=4, t=1, d=96, num_pages=182, page_size=128),    # head dim
    dict(b=1, hq=30, hkv=4, t=1, d=128, num_pages=182, page_size=128),   # hq % hkv
    dict(b=2, hq=28, hkv=4, t=1, d=128, num_pages=181, page_size=128),   # B does not divide
    dict(b=1, hq=28, hkv=4, t=5, d=128, num_pages=182, page_size=96, partial=True),
    dict(b=1, hq=28, hkv=4, t=1, d=128, num_pages=182, page_size=96, maxp=50),   # K8 / K9
    dict(b=66, hq=28, hkv=4, t=1, d=128, num_pages=182, page_size=128, maxp=2049),
], ids=["decode-t2", "d96", "hq-not-multiple", "pool-not-divisible", "page-96",
        "table-page-96", "table-range-2049-slots"])
def test_launch_plan_refuses_what_the_kernels_do_not_take(kwargs):
    with pytest.raises(ValueError):
        pa.launch_plan(**kwargs)


@pytest.mark.parametrize("g", [4, 7, 16])
def test_launch_plan_of_the_table_kernels(g):
    """K8 / K9 take any g: the grid is `paged_split` over the table's maxp
    slots (whatever the pool's size), one wave at the smoke's 184 slots and
    the caller pool's 50, a range a slot where there are fewer; the range a
    block lists fits TABLE_SLOTS up to 2,048 slots a row at 66 rows."""
    wave = pa.SMS * pa.RESIDENT_BLOCKS
    for b, num_pages, maxp in ((3, 288, 184), (2, 98, 50), (1, 20, 9), (66, 9000, 2048)):
        plan = pa.launch_plan(b, g * HKV, HKV, 1, 128, num_pages, 128, maxp=maxp)
        split = pa.paged_split(b, HKV, maxp, g)
        assert plan["row_pages"] == maxp and plan["rows"] == g
        assert plan["row_tiles"] == [(0, g)] and plan["ranges"] == split["ranges"]
        assert plan["blocks"] == b * HKV * plan["ranges"] <= max(wave, b * HKV)
        assert -(-maxp // plan["ranges"]) <= pa.TABLE_SLOTS
        if b * HKV * maxp >= wave:
            assert plan["blocks"] > wave - b * HKV
        else:
            assert plan["ranges"] == maxp
    with pytest.raises(ValueError):
        pa.launch_plan(2, g * HKV, HKV, 1, 128, 98, 96, maxp=50)
    with pytest.raises(ValueError):
        pa.launch_plan(2, g * HKV, HKV, 5, 128, 98, 128, partial=True, maxp=50)


def _allocated_table(lengths, num_pages, maxp, ps, holes=(), unmapped_rows=()):
    """The allocator's table after growing the rows a token at a time (rows
    claim pages in batch order whenever they cross a page, so their pages
    interleave), then -1 at the (row, slot) `holes` and over every slot of
    the `unmapped_rows` -> [B, maxp] int32."""
    cfg = types.SimpleNamespace(num_layers=1, num_kv_heads=HKV, head_dim=8)
    cache = paged_kv.PagedKVCache.create(cfg, len(lengths), num_pages, maxp, page_size=ps)
    for t in range(max(lengths)):
        grow = torch.tensor([int(t < n) for n in lengths], dtype=torch.int32)
        cache, over = paged_kv.allocate_pages_checked(cache, grow)
        assert not bool(over)
        cache.length = cache.length + grow
    table = cache.page_table.clone()
    for r, slot in holes:
        table[r, slot] = -1
    for r in unmapped_rows:
        table[r] = -1
    return table


# (lengths, pool pages, maxp, holes inside a length, rows with no mapped slot)
TABLES = {
    "b1": ([700], 8, 9, [(0, 2)], []),
    "b2-hole-at-a-range-start": ([1000, 300], 12, 9, [(0, 0), (1, 1)], []),
    "b3-smoke-like": ([1000, 1, 300], 20, 9, [(0, 2)], []),
    "b3-unmapped-row": ([520, 380, 129], 12, 6, [(2, 1)], [1]),
    "b3-wide-table": ([4000, 2500, 64], 60, 40, [(0, 5), (0, 31), (1, 19)], [2]),
}


@pytest.mark.parametrize("g", [7, 16])
@pytest.mark.parametrize("case", list(TABLES))
def test_table_blocks_walk_every_live_key_once(case, g):
    lengths, num_pages, maxp, holes, unmapped = TABLES[case]
    ps = 128
    table = _allocated_table(lengths, num_pages, maxp, ps, holes, unmapped)
    length = torch.tensor(lengths, dtype=torch.int32)
    valid = pa._table_valid(table, length, ps)                  # [B, maxp * ps]
    blocks = pa.table_blocks(table, length, HKV, ps, g)
    split = pa.paged_split(len(lengths), HKV, maxp, g)
    assert len(blocks) == split["blocks"]
    seen = collections.Counter()
    for row, head, first, end, q0, q1, live, keys in blocks:
        assert live == sorted(live) and all(first <= s < end for s in live)
        for s in live:                                          # no dead slot walked
            assert table[row, s] >= 0 and valid[row, s * ps]
        assert (len(live) - 1) * ps < keys <= len(live) * ps or (keys == 0 and not live)
        # Key tile t reads page live[t // (ps // 64)] at key (t % 2) * 64.
        tiles = [live[t // (ps // pa.KEY_TILE)] for t in range(-(-keys // pa.KEY_TILE))]
        assert sorted(set(tiles)) == live
        walked = [live[j // ps] * ps + j % ps for j in range(keys)]
        assert all(valid[row, pos] for pos in walked)
        seen.update((row, head, pos, q) for pos in walked for q in range(q0, q1))
    want = {(r, h, int(pos), q) for r in range(len(lengths)) for h in range(HKV)
            for pos in valid[r].nonzero()[:, 0] for q in range(g)}
    assert set(seen) == want and set(seen.values()) <= {1}
    for r in unmapped:
        assert not any(live for row, *_, live, _ in blocks if row == r)


def _walked_decode(q, k_pages, v_pages, table, length):
    """K8's result as its blocks compute it, in f32: each block's partial
    (acc, m, l) over the keys of its walk, masked past its live-key count,
    then the ranges merged in order (0 for a row with no live key)."""
    b, hq, _, d = q.shape
    hkv, ps = k_pages.shape[1], k_pages.shape[2]
    g = hq // hkv
    parts = collections.defaultdict(list)
    for row, head, *_, live, keys in pa.table_blocks(table, length, hkv, ps, g):
        qh = q[row, head * g:(head + 1) * g, 0].double()
        if not live:
            parts[row, head].append(None)
            continue
        pages = table[row, live].long()
        k = k_pages[pages, head].reshape(-1, d)[:keys].double()
        v = v_pages[pages, head].reshape(-1, d)[:keys].double()
        s = qh @ k.T * d ** -0.5
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        parts[row, head].append((p @ v, m, p.sum(-1, keepdim=True)))
    out = torch.zeros(b, hq, 1, d, dtype=torch.float64)
    for (row, head), ranges in parts.items():
        done = [x for x in ranges if x is not None]
        if not done:
            continue
        mx = torch.stack([m for _, m, _ in done]).amax(0)
        acc = sum(a * torch.exp(m - mx) for a, m, _ in done)
        l = sum(li * torch.exp(m - mx) for _, m, li in done)
        out[row, head * g:(head + 1) * g, 0] = acc / l
    return out


@pytest.mark.parametrize("case", list(TABLES))
def test_table_walk_merged_equals_the_plain_twin(case):
    """The walk of `table_blocks` computes K8's function: its blocks'
    partials, merged, equal `paged_decode_attention_table_plain` (f32 in,
    f64 sums) with NaN in every pool page no row maps and past each row's
    length in its last page."""
    lengths, num_pages, maxp, holes, unmapped = TABLES[case]
    ps, hq, d = 128, 7 * HKV, 16
    table = _allocated_table(lengths, num_pages, maxp, ps, holes, unmapped)
    length = torch.tensor(lengths, dtype=torch.int32)
    rng = np.random.default_rng(len(case))
    q = torch.from_numpy(rng.standard_normal((len(lengths), hq, 1, d)).astype(np.float32))
    kp, vp = (torch.from_numpy(rng.standard_normal((num_pages, HKV, ps, d)).astype(np.float32))
              for _ in range(2))
    dead = torch.ones(num_pages, HKV, ps, dtype=torch.bool)
    valid = pa._table_valid(table, length, ps)
    for r in range(len(lengths)):
        for s in range(maxp):
            if table[r, s] >= 0:
                dead[table[r, s]] &= ~valid[r, s * ps:(s + 1) * ps][None]
    kp[dead], vp[dead] = float("nan"), float("nan")
    ref = pa.paged_decode_attention_table_plain(q, kp, vp, table, length)
    got = _walked_decode(q, kp, vp, table, length)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), ref, atol=1e-5, rtol=1e-5)
    for r in unmapped:
        assert (got[r] == 0).all()
