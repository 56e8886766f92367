"""The grid of the Hopper int4 GEMVs (K10, K11) on the CPU.

`ops/int4_matmul.launch_plan` counts in Python the blocks that
`csrc/int4_gemv.cu` launches, from shapes alone; `plan_blocks` lists them
with their warps' group ranges. Every (part, packed column, group) must fall
in exactly one warp of one block, the blocks must fit one resident wave of
the H100 and read near-equal bytes, at LongVA-7B's four decode shapes (q/k/v
3584 -> 3584 + 512 + 512, o 3584 -> 3584, gate/up 3584 -> 2 x 18944, down
18944 -> 3584) for 1, 2, 5 and 8 rows, and at the card tests' ragged widths.
A shape the kernel does not take raises ValueError before any launch. The
loader's C signatures and the kernel's geometry constants are held to the
CUDA source.
"""

import collections
import ctypes
import os
import re

import pytest

from streamchat_tpu_torch.kernels import build
from streamchat_tpu_torch.ops import int4_matmul as im

# (in, packed widths out_p / 2) of each main-path launch.
MAIN = {"qkv": (3584, (1792, 256, 256)), "o": (3584, (1792,)),
        "gate_up": (3584, (9472, 9472)), "down": (18944, (1792,))}
# The card tests' shapes (tests/test_torch_cuda.py), ragged widths included.
RAGGED = [(384, (100,)), (3584, (256,)), (128, (260,)), (896, (24,)), (384, (516,)),
          (384, (256, 64, 64)), (384, (512, 516)), (128, (4, 8, 12))]


def _bytes(block):
    """Bytes a block reads: its packed bytes and their two scales a group."""
    _, (c0, c1), (g0, g1), _ = block
    return (c1 - c0) * (g1 - g0) * (im.GROUP + 2 * 4)


def _coverage(n, kin, widths):
    plan = im.launch_plan(n, kin, widths)
    blocks = im.plan_blocks(n, kin, widths)
    assert len(blocks) == plan.blocks == sum(plan.tiles) * plan.cluster
    seen = collections.Counter()
    for part, (c0, c1), (g0, g1), warps in blocks:
        assert 0 <= c0 < c1 <= widths[part] and c1 - c0 <= im.TILE_PACKED
        assert len(warps) == im.WARPS
        assert warps[0][0] == g0 and warps[-1][1] == g1
        for (_, a1), (b0, _) in zip(warps, warps[1:]):
            assert a1 == b0
        for w0, w1 in warps:
            seen.update((part, c, g) for c in range(c0, c1) for g in range(w0, w1))
    want = {(p, c, g) for p, w in enumerate(widths) for c in range(w)
            for g in range(kin // im.GROUP)}
    assert set(seen) == want and set(seen.values()) == {1}
    return plan, blocks


@pytest.mark.parametrize("n", [1, 2, 5, 8])
@pytest.mark.parametrize("shape", list(MAIN))
def test_main_shapes_one_balanced_wave(shape, n):
    kin, widths = MAIN[shape]
    plan, blocks = _coverage(n, kin, widths)
    assert plan.wave == im.SMS * im.RESIDENT_BLOCKS == 528
    assert plan.blocks <= plan.wave
    # The largest cluster that keeps one wave: doubling it would not.
    assert plan.cluster == im.MAX_CLUSTER or 2 * plan.blocks > plan.wave
    # Every main-path tile is whole, so blocks differ by at most one group,
    # and a block's warps by at most one group each.
    nbytes = [_bytes(b) for b in blocks]
    lo, hi = plan.groups // plan.cluster, -(-plan.groups // plan.cluster)
    assert max(nbytes) * lo <= min(nbytes) * hi
    per_warp = [w1 - w0 for b in blocks for w0, w1 in b[3]]
    assert max(per_warp) - min(per_warp) <= 1


@pytest.mark.parametrize("n", [1, 2, 5, 8])
@pytest.mark.parametrize("kin,widths", RAGGED)
def test_ragged_widths_covered_once_in_one_wave(kin, widths, n):
    plan, blocks = _coverage(n, kin, widths)
    assert plan.blocks <= plan.wave
    narrow = any(w % 16 for w in widths)
    assert plan.wave == im.SMS * (im.RESIDENT_NARROW if narrow else im.RESIDENT_BLOCKS)
    full = -(-plan.groups // plan.cluster) * im.TILE_PACKED * (im.GROUP + 8)
    assert max(_bytes(b) for b in blocks) <= full


def test_cluster_sizes():
    """q/k/v, o and down: 8 ranges a tile; gate/up (296 tiles): whole
    tiles; one group: no cluster. The plan does not depend on n."""
    for shape, cluster, blocks in (("qkv", 8, 288), ("o", 8, 224), ("down", 8, 224),
                                   ("gate_up", 1, 296)):
        for n in (1, 8):
            plan = im.launch_plan(n, *MAIN[shape])
            assert (plan.cluster, plan.blocks) == (cluster, blocks)
    assert im.launch_plan(1, 128, (260,)).cluster == 1
    # More tiles than a wave holds: one range a tile, more than one wave.
    wide = im.launch_plan(8, 128 * 64, (9472 * 4,))
    assert wide.cluster == 1 and wide.blocks > wide.wave


@pytest.mark.parametrize("n,kin,widths", [
    (0, 3584, (1792,)), (9, 3584, (1792,)),             # rows
    (1, 100, (1792,)), (1, 0, (1792,)), (1, -128, (64,)),  # in
    (1, 3584, ()), (1, 3584, (64, 64, 64, 64)),          # parts
    (1, 3584, (6,)), (1, 3584, (0,)), (1, 3584, (64, 2)),  # widths
])
def test_refused_shapes_raise(n, kin, widths):
    with pytest.raises(ValueError):
        im.launch_plan(n, kin, widths)


def _c_entries():
    out = {}
    for path in sorted(os.listdir(build.SRC_DIR)):
        if path.endswith(".cu"):
            text = open(os.path.join(build.SRC_DIR, path)).read()
            for m in re.finditer(r'extern "C" int (sc_\w+)\(([^)]*)\)', text):
                out[m.group(1)] = [p.strip() for p in m.group(2).split(",") if p.strip()]
    return out


def _kind(param):
    if "*" in param:
        return "ptr"
    assert param.startswith(("int ", "unsigned ")), param
    return "i32"


def _loader_kind(argtype):
    if argtype is ctypes.c_void_p or issubclass(argtype, ctypes._Pointer):
        return "ptr"
    assert argtype in (ctypes.c_int, ctypes.c_uint), argtype
    return "i32"


@pytest.mark.parametrize("name", ["sc_int4_gemv", "sc_int4_gemv_attributes"])
def test_loader_signature_matches_the_c_entry(name):
    params = _c_entries()[name]
    assert [_loader_kind(a) for a in build.SIGNATURES[name]] == [_kind(p) for p in params]


def test_geometry_constants_match_the_kernel():
    text = open(os.path.join(build.SRC_DIR, "int4_gemv.cu")).read()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", text).group(1))

    assert const("TILE") == im.TILE_PACKED
    assert const("WARPS") == im.WARPS
    assert const("RESIDENT") == im.RESIDENT_BLOCKS
    assert const("RESIDENT_NARROW") == im.RESIDENT_NARROW
    assert const("MAX_CLUSTER") == im.MAX_CLUSTER
    assert const("GROUP") == im.GROUP
