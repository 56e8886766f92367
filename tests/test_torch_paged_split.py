"""The grid of the Hopper paged-decode kernels (K4, K6, K7, K7') on the CPU.

`ops/paged_attention.paged_split` states in Python the page ranges and query
row tiles that `csrc/paged_decode.cu` gives its blocks; `paged_blocks` lists
them, and `launch_plan` is the wrappers' geometry check, from shapes alone.
Every (row, kv head, page, query row) of a partitioned pool must fall in
exactly one block, ranges hold whole pages and differ by at most one page,
and the grid is one wave of two blocks for each of the H100's 132 SMs
wherever the pool has a page for each of them. Any g * T is taken: the
verify step's folded rows at Qwen2-7B's g 7 (T up to 16) and the judge's g
4 (T up to 28), up to 112 rows, cut into 64-row tiles; the table kernels
(K8, K9) still serve at most 8 query heads per kv head.
"""

import collections

import pytest

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
    dict(b=1, hq=36, hkv=4, t=1, d=128, num_pages=182, page_size=128, maxp=50),  # K8: g 9
], ids=["decode-t2", "d96", "hq-not-multiple", "pool-not-divisible", "page-96",
        "table-g9"])
def test_launch_plan_refuses_what_the_kernels_do_not_take(kwargs):
    with pytest.raises(ValueError):
        pa.launch_plan(**kwargs)


def test_launch_plan_of_the_table_kernels():
    plan = pa.launch_plan(3, 28, 4, 1, 128, 288, 128, maxp=184)
    assert plan["ranges"] == -(-184 // pa.PAGES_PER_CHUNK) and plan["rows"] == 7
    assert plan["blocks"] == 3 * 4 * plan["ranges"]
