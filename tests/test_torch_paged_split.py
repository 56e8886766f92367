"""The grid of the Hopper paged-decode kernel (K4, K7) on the CPU.

`ops/paged_attention.paged_split` states in Python the page ranges that
`csrc/paged_decode.cu` gives its blocks; `paged_blocks` lists them. Every
(row, kv head, page) of a partitioned pool must fall in exactly one block,
ranges hold whole pages and differ by at most one page, and the grid is one
wave of two blocks for each of the H100's 132 SMs wherever the pool has a
page for each of them.
"""

import collections

import pytest

from streamchat_tpu_torch.ops import paged_attention as pa

HKV = 4


@pytest.mark.parametrize("b,row_pages", [(1, 182), (2, 91), (1, 1), (1, 17), (1, 4096)])
def test_paged_split_covers_every_page_once_and_fills_the_card(b, row_pages):
    split = pa.paged_split(b, HKV, row_pages)
    blocks = pa.paged_blocks(b, HKV, row_pages)
    assert len(blocks) == split["blocks"] == b * HKV * split["ranges"]
    seen = collections.Counter()
    sizes = set()
    for row, head, first, end in blocks:
        assert row * row_pages <= first < end <= (row + 1) * row_pages
        sizes.add(end - first)
        seen.update((row, head, page) for page in range(first, end))
    want = {(r, h, r * row_pages + p) for r in range(b) for h in range(HKV)
            for p in range(row_pages)}
    assert set(seen) == want and set(seen.values()) == {1}
    assert max(sizes) - min(sizes) <= 1
    wave = pa.SMS * pa.RESIDENT_BLOCKS
    assert wave == 2 * 132
    if b * HKV * row_pages >= wave:
        assert split["blocks"] == wave
    else:
        assert split["ranges"] == row_pages          # a block per page
