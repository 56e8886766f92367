"""The hand-written CUDA kernels against their plain PyTorch twins, on the card.

Every test here carries the `cuda` marker and skips where there is no CUDA
device (the kernels have no CPU mode; on the CPU the wrappers run the twins,
which tests/test_torch_ops.py holds to the JAX package). The file imports
neither jax nor the JAX package, so it runs on a GPU machine without jax:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(`--noconftest` skips tests/conftest.py, which sets up jax.) Tolerance:
|kernel - plain| <= 3e-2 + 2e-2 |plain|, bf16 storage with f32
accumulation in both, summed in a different order. The quantized GEMVs
(W8, K10, K11) take ragged in / out edges and 1 or 8 rows; K10 / K11 also 2
and 5 rows, widths that are not a multiple of 16 or 8, LongVA-7B's o, down,
q/k/v and gate/up at full width, bf16 and f32 outputs, repeat themselves
bit for bit, and refuse the shapes they do not take before a launch. The paged
decode K4 / K6 and its partial form K7 / K7' (bf16 / int8 pages) run at
Qwen2-7B's 28 / 4 heads, head dims 64 and 128, lengths at the edges of
pages and 64-key tiles up to the smoke's 23,105 tokens, B = 2 partitioned
pools with a row of length 0, T = 1, 2, 5, 9, 10 and 16 in-flight queries
for K7 / K7' (up to 112 folded rows: two 64-row tiles) and T = 16 at 4
query heads per kv head, K6 also at 4 and 16, NaN in the bf16 K and V
pages and NaN / inf in the int8 scales past each length, and repeat
themselves bit for bit. The page-table decode (K8, K9) reads a shared pool
through a permuted table at 4, 7 and 16 query heads per kv head, B = 1, 3
and 66 (one range of 40 slots), with -1 past each row's pages, inside a
row's length (once at a range's first slot) and over a whole row (its
output 0), NaN in the pages no row maps and past each row's length, and
repeats itself bit for bit; every page kernel instantiation compiles
without spills at two blocks an SM. The partial kernels (K5, K7) return (acc, m, l); they are compared normalized
(acc / l, 0 where l == 0) under the same bound, m and l elementwise, and
rows with no live key must give m = -1e30, l = 0, acc = 0. K12's similarities
are held within 1e-5; K13 runs both softmax modes, the folded form and the
one-pass LayerNorm, and the clamp softmax's two edges; K14 is counted apart
from K3. K1 runs in the TPU kernel's options; the probe kernels K15 (five
int4 unpack variants at n = 1, 3, 8, packed widths 512, 496 and 500, gpb
dividing the groups, not dividing them and above them, block_out 128 to
2048, and once at the probe's full shape; dma exactly), K16 (five layer
variants) and K17 (four dot kinds at S = 64, 100, 577 over 1, 3 and 96
dots, f32 outputs held to 1e-3; refused shapes raise before a launch) run,
and K15 and K17 repeat themselves bit for bit. The wgmma GEMM
that K1, K2, K13 and K16 launch runs on its own (`fused_vit.gemm`) at
ragged M (66 and 2 x 577 rows) in every epilogue, raises GemmShapeError on
the shapes it does not take, and repeats itself bit for bit.
"""

import numpy as np
import pytest
import torch

from streamchat_tpu_torch import kernels
from streamchat_tpu_torch.ops import (attention, dedup, fused_vit, int4_matmul, paged_attention,
                                      quant, vit_attention)

ATOL, RTOL = 3e-2, 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    kernels.reset_launch_counts()
    return torch.device("cuda")


def _bf(seed, dev, *shape, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.from_numpy(x.astype(np.float32)).to(dev, torch.bfloat16)


def _close(got, ref):
    torch.testing.assert_close(got.float(), ref.float(), atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
def test_cuda_vit_layer_and_mlp(cuda):
    d, f = 128, 256
    ln1_s, ln1_b = 1 + _bf(1, cuda, d, scale=0.1), _bf(2, cuda, d, scale=0.1)
    wqkv, bqkv = _bf(3, cuda, d, 3 * d, scale=d ** -0.5), _bf(4, cuda, 3 * d, scale=0.1)
    wo, bo = _bf(5, cuda, d, d, scale=d ** -0.5), _bf(6, cuda, d, scale=0.1)
    ln2_s, ln2_b = 1 + _bf(7, cuda, d, scale=0.1), _bf(8, cuda, d, scale=0.1)
    w1, b1 = _bf(9, cuda, d, f, scale=d ** -0.5), _bf(10, cuda, f, scale=0.1)
    w2, b2 = _bf(11, cuda, f, d, scale=f ** -0.5), _bf(12, cuda, d, scale=0.1)
    args = (ln1_s, ln1_b, wqkv, bqkv, wo, bo, ln2_s, ln2_b, w1, b1, w2, b2)
    x = _bf(13, cuda, 2, 33, d)           # 66 rows: a ragged GEMM edge
    exact = dict(num_heads=2, frame_tile=1, softmax_mode="exact")
    _close(fused_vit.fused_vit_layer(x, *args, **exact),
           fused_vit.fused_vit_layer_plain(x, *args, **exact))
    flat = x.reshape(-1, d)
    mlp = (ln2_s, ln2_b, w1, b1, w2, b2)
    for act in ("quick_gelu", "gelu", "none"):
        _close(fused_vit.fused_ln_mlp(flat, *mlp, activation=act),
               fused_vit.fused_ln_mlp_plain(flat, *mlp, activation=act))
    kw = dict(activation="gelu", layernorm=False, residual=False)
    _close(fused_vit.fused_ln_mlp(flat, None, None, w1, b1, w2, b2, **kw),
           fused_vit.fused_ln_mlp_plain(flat, None, None, w1, b1, w2, b2, **kw))
    assert fused_vit.fused_vit_layer.launches == 1
    assert fused_vit.fused_ln_mlp.launches == 4


@pytest.mark.cuda
@pytest.mark.parametrize("d,causal,kv,s,hq,hkv", [
    (64, True, None, 100, 4, 2),
    (64, False, (0, 70), 100, 4, 2),            # row 0 sees no key -> 0
    (128, True, (37, 100), 100, 4, 2),          # the decoder's head dim, ragged lengths
    (128, True, None, 1, 28, 4),                # LongVA's 28 / 4 heads, one row
    (64, True, None, 127, 28, 4),
    (128, True, None, 128, 28, 4),              # exactly one 128-row tile
    (128, False, (129, 1), 129, 4, 2),          # one key past a tile
    (128, True, (128, 129), 300, 28, 4),        # kv_length at and past a tile edge
    (64, False, (128, 129), 300, 28, 4),
    (128, True, (300, 211), 300, 28, 4),
])
def test_cuda_flash_attention(cuda, d, causal, kv, s, hq, hkv):
    """Keys and values past each row's kv_length hold NaN for the kernel
    and zeros for the twin: masked keys must not reach the output."""
    q = _bf(1, cuda, 2, hq, s, d)
    k, v = _bf(2, cuda, 2, hkv, s, d), _bf(3, cuda, 2, hkv, s, d)
    kl = None if kv is None else torch.tensor(kv, dtype=torch.int32, device=cuda)
    kn, vn = k.clone(), v.clone()
    for row, n in enumerate(kv or ()):
        kn[row, :, n:] = float("nan")
        vn[row, :, n:] = float("nan")
        k[row, :, n:] = 0
        v[row, :, n:] = 0
    got = attention.flash_attention(q, kn, vn, kl, causal=causal)
    assert got.shape == (2, hq, s, d) and torch.isfinite(got).all()
    _close(got, attention.flash_attention_plain(q, k, v, kl, causal=causal))
    assert attention.flash_attention.launches == 1


# (B, lengths, pool pages) of the Hopper K4 / K7 kernel: lengths at and
# around a page's and a 64-key tile's edges, the smoke's 23,105 tokens on its
# 182-page pool, and partitioned pools at B = 2 with ragged lengths and a
# row of length 0.
_POOLS = [(1, (1,), 1), (1, (127,), 1), (1, (128,), 1), (1, (129,), 2), (1, (2049,), 17),
          (1, (23105,), 182), (2, (1000, 3), 18), (2, (129, 0), 4), (2, (23105, 0), 364)]


def _pool(seed, dev, b, lengths, pages, d, hkv=4):
    """bf16 K / V pages of a partitioned pool -> (k, v) with NaN at and past
    each row's length (for the kernel) and (k, v) with zeros there (for the
    twin, whose bf16 K4 does not zero V)."""
    k, v = _bf(seed, dev, pages, hkv, 128, d), _bf(seed + 1, dev, pages, hkv, 128, d)
    kz, vz = k.clone(), v.clone()
    rp = pages // b
    for row, n in enumerate(lengths):
        first = row * rp + n // 128
        for x, val in ((k, float("nan")), (v, float("nan")), (kz, 0.0), (vz, 0.0)):
            if n // 128 < rp:
                x[first, :, n % 128:] = val
            x[first + 1:(row + 1) * rp] = val
    return k, v, kz, vz


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,lengths,pages", _POOLS)
def test_cuda_paged_decode(cuda, d, b, lengths, pages):
    """K4 at Qwen2-7B's 28 / 4 heads: NaN in the K and V pages past each
    row's length must not reach the output, a row of length 0 gives zeros,
    and two launches give equal bits."""
    q = _bf(1, cuda, b, 28, 1, d)
    kp, vp, kz, vz = _pool(2, cuda, b, lengths, pages, d)
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    got = paged_attention.paged_decode_attention_seq(q, kp, vp, ln)
    assert torch.isfinite(got).all()
    _close(got, paged_attention.paged_decode_attention_seq_plain(q, kz, vz, ln))
    for row, n in enumerate(lengths):
        if n == 0:
            assert (got[row] == 0).all()
    assert torch.equal(got, paged_attention.paged_decode_attention_seq(q, kp, vp, ln))
    assert paged_attention.paged_decode_attention_seq.launches == 2


def _int4(seed, dev, kin, out):
    q = quant.quantize_weight_int4(torch.from_numpy(
        np.random.default_rng(seed).standard_normal((kin, out)).astype(np.float32) * 0.1).to(dev))
    return q["w_i4p"], q["scale"]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("kin,out", [(200, 528), (3584, 512), (1000, 48)])
def test_cuda_w8a16_gemv(cuda, n, kin, out):
    """Ragged in (not a multiple of the 8-row warp step or the slice) and
    out (not a multiple of the 512-column tile); bf16 and f32 outputs."""
    w = np.random.default_rng(kin).standard_normal((kin, out)).astype(np.float32) * 0.1
    q = {k: v.to(cuda) for k, v in quant.quantize_weight(torch.from_numpy(w)).items()}
    x = _bf(1, cuda, n, kin)
    for dt in (torch.bfloat16, torch.float32):
        got = quant.qmatvec_int8(x, q["w_i8"], q["scale"], dt)
        assert got.dtype == dt and got.shape == (n, out)
        _close(got, quant.qmatvec_int8_plain(x, q["w_i8"], q["scale"], dt))
    assert quant.qmatvec_int8.launches == 2


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 8, 2, 5])
@pytest.mark.parametrize("kin,out", [(384, 200), (3584, 512), (128, 520), (3584, 3584),
                                     (18944, 3584), (384, 1032), (896, 48)])
def test_cuda_int4_gemv(cuda, n, kin, out):
    """Group ranges that do not split evenly, packed widths that are not a
    multiple of the 64-column tile or of 8 (4-byte loads), the o and down
    shapes; bf16 and f32 outputs; a second launch gives equal bits."""
    w, s = _int4(kin + out, cuda, kin, out)
    x = _bf(2, cuda, n, kin)
    for dt in (torch.float32, torch.bfloat16):
        got = int4_matmul.qmatvec_int4(x, w, s, dt)
        assert got.dtype == dt and got.shape == (n, out)
        _close(got, int4_matmul.qmatvec_int4_plain(x, w, s, dt))
        assert torch.equal(got, int4_matmul.qmatvec_int4(x, w, s, dt))
    assert int4_matmul.qmatvec_int4.launches == 4


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 8, 2, 5])
@pytest.mark.parametrize("widths", [(512, 128, 128), (1024, 1032), (3584, 512, 512),
                                    (18944, 18944), (200, 48, 8)])
def test_cuda_int4_gemv_fused(cuda, n, widths):
    """k/v parts narrower than one column tile, widths that are not a
    multiple of 16 or 8, two and three parts; LongVA-7B's q/k/v and gate/up
    at full width (in 3584); bf16 and f32 outputs; equal bits twice."""
    kin = 3584 if max(widths) >= 3584 else 384
    parts = [_int4(10 + i, cuda, kin, w) for i, w in enumerate(widths)]
    flat = [t for part in parts for t in part]
    x = _bf(3, cuda, n, kin)
    for dt in (torch.bfloat16, torch.float32):
        got = int4_matmul.qmatvec_int4_fused(x, *flat, out_dtype=dt)
        want = int4_matmul.qmatvec_int4_fused_plain(x, *flat, out_dtype=dt)
        assert len(got) == len(widths)
        for g, w, width in zip(got, want, widths):
            assert g.shape == (n, width) and g.dtype == dt
            _close(g, w)
        again = int4_matmul.qmatvec_int4_fused(x, *flat, out_dtype=dt)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert int4_matmul.qmatvec_int4_fused.launches == 4


@pytest.mark.cuda
def test_cuda_int4_gemv_rejects_shapes(cuda):
    """Shapes the kernel does not take raise ValueError before any launch:
    9 rows, in not a multiple of 128, a packed width not a multiple of 4,
    x not 16-byte aligned, one part for the fused form."""
    w, s = _int4(1, cuda, 384, 512)
    with pytest.raises(ValueError):
        int4_matmul.qmatvec_int4(_bf(1, cuda, 9, 384), w, s)
    with pytest.raises(ValueError):
        int4_matmul.qmatvec_int4(_bf(1, cuda, 1, 320), w[:320].contiguous(), s[:2].contiguous())
    w6 = torch.zeros(384, 6, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        int4_matmul.qmatvec_int4(_bf(1, cuda, 1, 384), w6, torch.ones(3, 2, 6, device=cuda))
    with pytest.raises(ValueError):
        int4_matmul.qmatvec_int4(_bf(1, cuda, 1, 385)[:, 1:], w, s)
    with pytest.raises(ValueError):
        int4_matmul.qmatvec_int4_fused(_bf(1, cuda, 1, 384), w, s)
    assert int4_matmul.qmatvec_int4.launches == 0
    assert int4_matmul.qmatvec_int4_fused.launches == 0


def _int8_pool(seed, dev, b, lengths, pages, d, hkv=4):
    """int8 K / V pages of a partitioned pool with f32 scales -> (k, v,
    k_scale, v_scale), the scales NaN (k) and inf (v) at and past each row's
    length, as stale slots may hold."""
    rng = np.random.default_rng(seed)
    kp, vp = (torch.from_numpy(rng.integers(-127, 128, (pages, hkv, 128, d), dtype=np.int8)
                               ).to(dev) for _ in range(2))
    ks, vs = (torch.from_numpy(rng.uniform(0.005, 0.02, (pages, hkv, 128)).astype(np.float32)
                               ).to(dev) for _ in range(2))
    rp = pages // b
    for row, n in enumerate(lengths):
        stale = torch.arange(n, rp * 128, device=dev)     # row positions at and past n
        for x, bad in ((ks, float("nan")), (vs, float("inf"))):
            x[row * rp + stale // 128, :, stale % 128] = bad
    return kp, vp, ks, vs


@pytest.mark.cuda
@pytest.mark.parametrize("hq", [28, 16, 64])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,lengths,pages", _POOLS)
def test_cuda_paged_decode_int8(cuda, hq, d, b, lengths, pages):
    """K6 at g 7 (Qwen2-7B), 4 (the judge) and 16 query heads per kv head:
    NaN / inf scales past each row's length must not reach the output, a
    row of length 0 gives zeros, and two launches give equal bits."""
    q = _bf(1, cuda, b, hq, 1, d)
    kp, vp, ks, vs = _int8_pool(4, cuda, b, lengths, pages, d)
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    fn = paged_attention.paged_decode_attention_seq_int8
    got = fn(q, kp, vp, ks, vs, ln)
    assert torch.isfinite(got).all()
    _close(got, paged_attention.paged_decode_attention_seq_int8_plain(q, kp, vp, ks, vs, ln))
    for row, n in enumerate(lengths):
        if n == 0:
            assert (got[row] == 0).all()
    assert torch.equal(got, fn(q, kp, vp, ks, vs, ln)) and fn.launches == 2


# Shared pools for K8 / K9: (lengths, kv heads, maxp, pool pages, holes
# (row, slot) inside a length, rows whose slots are all -1). The grid's
# ranges: 3 rows x 2 heads over 9 slots give a range a slot; 3 rows x 8
# heads over 60 slots give ranges of 5-6 slots, slot 10 the first of its
# range; 66 rows x 4 heads over 40 slots give one range of all 40 slots, so
# that warp 0 lists them in two rounds of 32.
_TABLES = {
    "b3": ((1000, 1, 300), 2, 9, 20, [(0, 2)], []),
    "b1": ((1000,), 2, 9, 12, [(0, 3)], []),
    "b3-range-starts": ((7000, 2500, 129), 8, 60, 90, [(0, 10), (1, 0)], []),
    "b3-unmapped-row": ((1000, 700, 300), 2, 9, 20, [], [1]),
    "b66-one-range": ((5000,) + (1, 127, 128, 129, 300, 0) * 10 + (200,) * 5, 4, 40, 200,
                      [(0, 33), (2, 0)], [7]),
}


def _shared_table(rng, lengths, maxp, pages, holes, unmapped):
    """A seeded permutation of the pool's pages, row r's first
    ceil(length / 128) slots mapped in batch order, -1 past them, at the
    holes and over the unmapped rows -> (table, pages no slot maps)."""
    perm = rng.permutation(pages)
    table = np.full((len(lengths), maxp), -1, np.int32)
    i = 0
    for r, n in enumerate(lengths):
        need = -(-n // 128)
        table[r, :need] = perm[i:i + need]
        i += need
    for r, slot in holes:
        table[r, slot] = -1
    table[list(unmapped)] = -1
    return table, [p for p in range(pages) if p not in set(table[table >= 0].tolist())]


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("g", [4, 7, 16])
@pytest.mark.parametrize("case", list(_TABLES))
def test_cuda_paged_decode_table(cuda, int8, g, case):
    """K8 / K9 on a shared pool through a permuted table, 4, 7 (Qwen2-7B) and
    16 query heads per kv head: holes inside a length (one at a range's
    first slot), a row whose slots are all -1 (its output is 0), B = 1, and
    one range of 40 slots; the pages and scales no row maps hold NaN / inf,
    and so do the bf16 K and V past each row's length in its last page. Two
    launches give equal bits."""
    lengths, hkv, maxp, pages, holes, unmapped = _TABLES[case]
    rng = np.random.default_rng(7)
    table, free = _shared_table(rng, lengths, maxp, pages, holes, unmapped)
    b, ps = len(lengths), 128
    q = _bf(1, cuda, b, g * hkv, 1, 128)
    tab = torch.from_numpy(table).to(cuda)
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    if int8:
        kp, vp = (torch.from_numpy(rng.integers(-127, 128, (pages, hkv, ps, 128), dtype=np.int8)
                                   ).to(cuda) for _ in range(2))
        ks, vs = (torch.from_numpy(rng.uniform(0.005, 0.02, (pages, hkv, ps)).astype(np.float32)
                                   ).to(cuda) for _ in range(2))
        ks[free], vs[free] = float("nan"), float("inf")
        args = (q, kp, vp, ks, vs, tab, ln)
        fn = paged_attention.paged_decode_attention_table_int8
        ref = paged_attention.paged_decode_attention_table_int8_plain(*args)
    else:
        kp, vp = _bf(2, cuda, pages, hkv, ps, 128), _bf(3, cuda, pages, hkv, ps, 128)
        kp[free], vp[free] = float("nan"), float("nan")
        for r, n in enumerate(lengths):
            last = table[r, (n - 1) // ps] if n else -1
            if n % ps and last >= 0:
                kp[last, :, n % ps:], vp[last, :, n % ps:] = float("nan"), float("nan")
        args = (q, kp, vp, tab, ln)
        fn = paged_attention.paged_decode_attention_table
        ref = paged_attention.paged_decode_attention_table_plain(*args)
    got = fn(*args)
    assert torch.isfinite(got).all()
    _close(got, ref)
    for r in unmapped:
        assert (got[r] == 0).all()
    assert torch.equal(got, fn(*args)) and fn.launches == 2


@pytest.mark.cuda
@pytest.mark.parametrize("table", [False, True], ids=["pool", "table"])
@pytest.mark.parametrize("int8", [False, True])
def test_cuda_paged_decode_attributes(cuda, int8, table):
    """Every page kernel instantiation at D 128 (K4 / K7, K6 / K7', K8, K9)
    compiles without spills and keeps two blocks on an SM, the table ones
    with their slot list too."""
    a = paged_attention.attributes(128, int8=int8, table=table)
    assert a["local_bytes"] == 0 and a["resident_blocks"] == 2
    assert a["dynamic_shared_bytes"] >= (4 * (1 + paged_attention.TABLE_SLOTS) if table else 0)


def _close_partial(got, ref):
    acc, m, l = got
    racc, rm, rl = ref
    assert torch.isfinite(acc).all() and torch.isfinite(m).all()
    for a, b in ((m, rm), (l, rl)):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)
    norm = lambda a, n: a / torch.where(n == 0, torch.ones_like(n), n)[..., None]  # noqa: E731
    _close(norm(acc, l), norm(racc, rl))
    dead = rl == 0
    assert (m[dead] == -1e30).all() and (l[dead] == 0).all() and (acc[dead] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d,q_off,k_off,kv,causal,sq,sk,hq,hkv", [
    (128, 256, 0, (300, 511), True, 200, 511, 4, 2),   # a later chunk, ragged cache
    (128, 0, 100, None, True, 200, 511, 4, 2),         # q_offset < k_offset: rows 0-99 see no key
    (64, 64, 0, (70, 330), False, 200, 511, 4, 2),
    (128, 4133, 5, (4300, 4000), True, 129, 4300, 28, 4),   # offsets off the tile grid
    (64, 100, 250, (511, 400), True, 200, 511, 28, 4),      # rows 0-149 see no key
    (128, 37, 5, None, True, 1, 300, 28, 4),
])
def test_cuda_flash_attention_partial(cuda, d, q_off, k_off, kv, causal, sq, sk, hq, hkv):
    q = _bf(1, cuda, 2, hq, sq, d)
    k, v = _bf(2, cuda, 2, hkv, sk, d), _bf(3, cuda, 2, hkv, sk, d)
    kl = None
    if kv is not None:
        kl = torch.tensor(kv, dtype=torch.int32, device=cuda)
        for row, n in enumerate(kv):          # garbage past each row's length
            k[row, :, n:] = float("nan")
            v[row, :, n:] = float("nan")
    got = attention.flash_attention_partial(q, k, v, q_off, k_off, kl, causal=causal)
    _close_partial(got, attention.flash_attention_partial_plain(q, k, v, q_off, k_off, kl,
                                                                causal=causal))
    assert attention.flash_attention_partial.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("hq,t,d", [(28, t, d) for t in (1, 2, 5, 9, 10, 16) for d in (64, 128)]
                         + [(16, 16, 64), (16, 16, 128)])
@pytest.mark.parametrize("b,lengths,pages", _POOLS)
def test_cuda_paged_seq_partial(cuda, int8, hq, t, d, b, lengths, pages):
    """T in-flight queries against the pool, folded head-major: 7 heads per
    kv head as Qwen2-7B (T 10 and 16 give 70 and 112 rows, two 64-row tiles)
    and 4 as the judge (T 16: 64 rows); rows with no pool token give acc 0,
    l 0, m -1e30. bf16 pages (K7) hold NaN past each row's length for the
    kernel, zeros for the twin; int8 pages (K7') NaN / inf scales there for
    both. Two launches give equal bits."""
    q = _bf(1, cuda, b, hq, t, d)
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    if int8:
        pool = _int8_pool(5, cuda, b, lengths, pages, d)
        fn = paged_attention.paged_seq_attention_partial_int8
        got = fn(q, *pool, ln)
        ref = paged_attention.paged_seq_attention_partial_int8_plain(q, *pool, ln)
    else:
        kp, vp, kz, vz = _pool(2, cuda, b, lengths, pages, d)
        pool = (kp, vp)
        fn = paged_attention.paged_seq_attention_partial
        got = fn(q, *pool, ln)
        ref = paged_attention.paged_seq_attention_partial_plain(q, kz, vz, ln)
    again = fn(q, *pool, ln)
    assert all(torch.equal(x, y) for x, y in zip(got, again)) and fn.launches == 2
    assert got[0].shape == q.shape and got[1].shape == q.shape[:3]
    _close_partial(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [3584, 1024, 1000, 1001, 100, 1030])
@pytest.mark.parametrize("n,offset", [(1, 0), (60, 0), (7, 0), (60, 1)],
                         ids=["n1", "n60", "n7", "n60-unaligned"])
def test_cuda_select_changed_frames(cuda, n, offset, d, dtype):
    """K12: the similarity of each row with the one before (row 0 with row
    N - 1) within 1e-5 of the twin; the keep masks agree wherever the score
    is not within 1e-4 of the threshold; equal bits on a second launch. D
    1001, D 1030 at bf16 and a base one element past a 16-byte boundary
    take the kernel's scalar loads, the others its 16-byte ones."""
    x = np.random.default_rng(n).standard_normal((n, d)).astype(np.float32)
    for i in range(1, n, 3):
        x[i] = x[i - 1] + 0.05 * np.random.default_rng(i).standard_normal(d)
    flat = torch.empty(n * d + offset, dtype=dtype, device=cuda)
    x = flat[offset:].view(n, d).copy_(torch.from_numpy(x))
    plan = dedup.launch_plan(n, d, x.element_size(), aligned=x.data_ptr() % 16 == 0)
    assert plan["vec"] == (offset == 0 and d * x.element_size() % 16 == 0)
    keep, sim = dedup.select_changed_frames(x, threshold=0.18, return_similarity=True)
    pkeep, psim = dedup.select_changed_frames_plain(x, threshold=0.18, return_similarity=True)
    torch.testing.assert_close(sim, psim, atol=1e-5, rtol=0)
    clear = ((1 - psim) - 0.18).abs() > 1e-4
    assert keep[0] and torch.equal(keep[clear], pkeep[clear])
    _, again = dedup.select_changed_frames(x, threshold=0.18, return_similarity=True)
    assert torch.equal(sim, again) and dedup.select_changed_frames.launches == 2


def _attn_args(dev, d, seed=20):
    ln_s, ln_b = 1 + _bf(seed, dev, d, scale=0.1), _bf(seed + 1, dev, d, scale=0.1)
    wqkv, bqkv = _bf(seed + 2, dev, d, 3 * d, scale=d ** -0.5), _bf(seed + 3, dev, 3 * d,
                                                                     scale=0.1)
    wo, bo = _bf(seed + 4, dev, d, d, scale=d ** -0.5), _bf(seed + 5, dev, d, scale=0.1)
    return [ln_s, ln_b, wqkv, bqkv, wo, bo]


@pytest.mark.cuda
@pytest.mark.parametrize("d,heads", [(128, 2), (256, 2)])
@pytest.mark.parametrize("mode,folded,onepass", [
    ("clamp", False, False), ("exact", False, False), ("clamp", True, True),
    ("exact", True, False),
])
def test_cuda_fused_ln_attn(cuda, d, heads, mode, folded, onepass):
    """K13 against its twin: both softmax modes, the folded (exp2) form and
    the one-pass LayerNorm, head dims 64 and 128, 2 x 77 rows (ragged
    tiles)."""
    args = _attn_args(cuda, d)
    if folded:
        args[2], args[3] = fused_vit.fold_vit_attn_params(*args[:4], num_heads=heads)
    x = _bf(30, cuda, 2, 77, d)
    kw = dict(num_heads=heads, softmax_mode=mode, folded=folded, ln_onepass=onepass)
    _close(fused_vit.fused_ln_attn(x, *args, **kw), fused_vit.fused_ln_attn_plain(x, *args, **kw))
    assert fused_vit.fused_ln_attn.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("center", [-200.0, 140.0])
@pytest.mark.parametrize("folded", [False, True])
def test_cuda_fused_ln_attn_clamp_edges(cuda, center, folded):
    """The clamp softmax's edges on the card (tests/test_fused_vit.py,
    TestSoftmaxModes): every logit near `center`; below the underflow floor
    the output is x + bo, above 80 a uniform average, finite either way."""
    d, heads, dh, c = 128, 2, 64, 8.0
    rng = np.random.default_rng(3)
    wqkv = np.zeros((d, 3 * d), np.float32)
    bqkv = np.zeros(3 * d, np.float32)
    for h in range(heads):
        bqkv[h * dh] = c
        wqkv[:, d + h * dh] = rng.normal(0, 1, d) * (8.0 * dh ** 0.5 / (c * d ** 0.5))
        bqkv[d + h * dh] = center * dh ** 0.5 / c
    wqkv[:, 2 * d:] = np.eye(d)
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda, torch.bfloat16)  # noqa: E731
    ln_s, ln_b = torch.ones(d, device=cuda, dtype=torch.bfloat16), torch.zeros(
        d, device=cuda, dtype=torch.bfloat16)
    wqkv, bqkv = to(wqkv), to(bqkv)
    if folded:
        wqkv, bqkv = fused_vit.fold_vit_attn_params(ln_s, ln_b, wqkv, bqkv, num_heads=heads)
    wo, bo = _bf(4, cuda, d, d, scale=d ** -0.5), _bf(5, cuda, d, scale=0.1)
    x = _bf(6, cuda, 2, 40, d)
    kw = dict(num_heads=heads, softmax_mode="clamp", folded=folded, ln_onepass=folded)
    got = fused_vit.fused_ln_attn(x, ln_s, ln_b, wqkv, bqkv, wo, bo, **kw)
    assert torch.isfinite(got).all()
    _close(got, fused_vit.fused_ln_attn_plain(x, ln_s, ln_b, wqkv, bqkv, wo, bo, **kw))
    if center < 0:
        _close(got, x.float() + bo.float())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(6, 4, 77, 64), (2, 2, 130, 128), (16, 16, 577, 64),
                                   (2, 4, 577, 128)])
def test_cuda_vit_attention(cuda, shape):
    """K14 over [N, H, S, D] with no pad (ViT-L's [16, 16, 577, 64] among
    them: the last 128-row tiles hold 65 queries and 65 keys); counted apart
    from K3, whose tile loop it launches."""
    q, k, v = (_bf(40 + i, cuda, *shape) for i in range(3))
    _close(vit_attention.vit_attention(q, k, v), vit_attention.vit_attention_plain(q, k, v))
    _close(vit_attention.vit_attention(q, k, v, sm_scale=0.05),
           vit_attention.vit_attention_plain(q, k, v, sm_scale=0.05))
    assert vit_attention.vit_attention.launches == 2
    assert attention.flash_attention.launches == 0
    with pytest.raises(ValueError, match="unsupported"):
        vit_attention.vit_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                                    v[..., :32].contiguous())


def _vit_weights(dev, d, f):
    return (1 + _bf(1, dev, d, scale=0.1), _bf(2, dev, d, scale=0.1),
            _bf(3, dev, d, 3 * d, scale=d ** -0.5), _bf(4, dev, 3 * d, scale=0.1),
            _bf(5, dev, d, d, scale=d ** -0.5), _bf(6, dev, d, scale=0.1),
            1 + _bf(7, dev, d, scale=0.1), _bf(8, dev, d, scale=0.1),
            _bf(9, dev, d, f, scale=d ** -0.5), _bf(10, dev, f, scale=0.1),
            _bf(11, dev, f, d, scale=f ** -0.5), _bf(12, dev, d, scale=0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,folded,onepass,act", [
    ("clamp", True, True, "quick_gelu"),      # the ingest's form
    ("exact", True, False, "gelu"),
    ("clamp", False, True, "none"),
    ("clamp", False, False, "quick_gelu"),    # the defaults
])
def test_cuda_vit_layer_options(cuda, mode, folded, onepass, act):
    """K1 in the TPU kernel's options, folded weights from
    fold_vit_layer_params; each launch is tallied under its mode."""
    d, f, heads = 128, 256, 2
    w = list(_vit_weights(cuda, d, f))
    if folded:
        w[2], w[3], w[8], w[9] = fused_vit.fold_vit_layer_params(
            *(w[i] for i in (0, 1, 2, 3, 6, 7, 8, 9)), num_heads=heads)
    x = _bf(13, cuda, 4, 33, d)
    kw = dict(num_heads=heads, activation=act, softmax_mode=mode, folded=folded,
              ln_onepass=onepass)
    _close(fused_vit.fused_vit_layer(x, *w, **kw), fused_vit.fused_vit_layer_plain(x, *w, **kw))
    assert kernels.launch_modes() == {
        "fused_vit_layer": {fused_vit.layer_mode(mode, folded, onepass, act): 1}}


@pytest.mark.cuda
@pytest.mark.parametrize("softmax", ["clamp", "exact", "bf16s"])
def test_cuda_vit_layer_577_tokens(cuda, softmax):
    """K1 at the ViT's 577 tokens (ragged last q and key tiles in every
    frame) in the ingest's folded, one-pass form, each softmax mode of the
    attention loop; bf16s (K16's bf16 scores, softmax code 2) through
    `launch_layer` as the layer probe's bf16s variant launches it
    (unfolded: its twin takes the natural exp of the scores)."""
    d, f, heads = 128, 256, 2
    w = list(_vit_weights(cuda, d, f))
    folded = softmax != "bf16s"
    if folded:
        w[2], w[3], w[8], w[9] = fused_vit.fold_vit_layer_params(
            *(w[i] for i in (0, 1, 2, 3, 6, 7, 8, 9)), num_heads=heads)
    x = _bf(14, cuda, 2, 577, d)
    kw = dict(num_heads=heads, eps=1e-5, activation="quick_gelu", folded=folded,
              ln_onepass=folded)
    if softmax == "bf16s":
        got = fused_vit.launch_layer(x, *w, softmax=fused_vit.SOFTMAX_CLAMP_BF16, **kw)
        ref = fused_vit._layer_plain(x, *w, softmax_mode="clamp", bf16_scores=True, **kw)
    else:
        got = fused_vit.fused_vit_layer(x, *w, frame_tile=1, softmax_mode=softmax, **kw)
        ref = fused_vit.fused_vit_layer_plain(x, *w, frame_tile=1, softmax_mode=softmax, **kw)
    assert torch.isfinite(got).all()
    _close(got, ref)


def _gemm_operands(dev, m, k, n, seed=60):
    """A as the first K columns of an [m, K + 64] buffer (lda > K), B, bias,
    and a bf16 residual with a leading dim of n + 128."""
    a = _bf(seed, dev, m, k + 64)[:, :k]
    b = _bf(seed + 1, dev, k, n, scale=k ** -0.5)
    bias = _bf(seed + 2, dev, n, scale=0.1)
    res = _bf(seed + 3, dev, m, n + 128)[:, :n]
    return a, b, bias, res


@pytest.mark.cuda
@pytest.mark.parametrize("m", [66, 2 * 577])
@pytest.mark.parametrize("k,n", [(1024, 128), (1024, 3072), (4096, 128), (4096, 3072)])
def test_cuda_gemm(cuda, m, k, n):
    """The wgmma GEMM against its twin at ragged M, in each activation, with
    no / bf16 / f32 residual and bf16 / f32 output (A and the residual
    strided; 2 x 577 rows at N 3072 take the 256-wide tiles)."""
    a, b, bias, res = _gemm_operands(cuda, m, k, n)
    calls = 0
    for act in ("none", "quick_gelu", "gelu"):
        for residual in (None, res, res.float()):
            for out_dtype in (torch.bfloat16, torch.float32):
                kw = dict(activation=act, out_dtype=out_dtype)
                got = fused_vit.gemm(a, b, bias, residual, **kw)
                assert got.dtype == out_dtype and got.shape == (m, n)
                _close(got, fused_vit.gemm_plain(a, b, bias, residual, **kw))
                calls += 1
    assert fused_vit.gemm(a, b).shape == (m, n)       # no bias, no residual
    assert fused_vit.gemm.launches == calls + 1


@pytest.mark.cuda
def test_cuda_gemm_rejects_shapes(cuda):
    """K % 64, N % 128, a misaligned row stride and an odd residual leading
    dim raise GemmShapeError before any launch."""
    a = _bf(70, cuda, 66, 1024)
    b = _bf(71, cuda, 1024, 256)
    bad = [(a[:, :96], _bf(72, cuda, 96, 256), None),         # K = 96
           (a, b[:, :192].contiguous(), None),                 # N = 192
           (_bf(73, cuda, 66, 1028)[:, :1024], b, None),       # lda = 1028
           (a, b, _bf(74, cuda, 66, 257)[:, :256])]            # ldr = 257
    for aa, bb, res in bad:
        with pytest.raises(fused_vit.GemmShapeError):
            fused_vit.gemm(aa, bb, None, res)
    with pytest.raises(fused_vit.GemmShapeError):
        fused_vit.fused_ln_mlp(_bf(75, cuda, 8, 96), None, None, _bf(76, cuda, 96, 128),
                               _bf(77, cuda, 128), _bf(78, cuda, 128, 128), _bf(79, cuda, 128),
                               layernorm=False, residual=False)
    assert fused_vit.gemm.launches == 0 and fused_vit.fused_ln_mlp.launches == 0


@pytest.mark.cuda
def test_cuda_gemm_is_deterministic(cuda):
    """No split-K: two calls on the same inputs are equal bit for bit."""
    a, b, bias, res = _gemm_operands(cuda, 2 * 577, 4096, 3072, seed=80)
    first = fused_vit.gemm(a, b, bias, res.float(), activation="quick_gelu",
                           out_dtype=torch.float32)
    assert torch.equal(first, fused_vit.gemm(a, b, bias, res.float(), activation="quick_gelu",
                                             out_dtype=torch.float32))


@pytest.mark.cuda
def test_cuda_probe_layer_variants(cuda):
    """K16: each variant of the layer probe at D = 1024 against its twin."""
    from streamchat_tpu_torch.utils import probe_vit_variants as pvv

    g = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn(2, 33, pvv.D, generator=g, device=cuda) * 0.5).to(torch.bfloat16)
    for opt in pvv.VARIANTS.values():
        params = pvv.make_params(g, opt)
        _close(pvv.make_layer(opt)(x, params), pvv.probe_layer_plain(x, params, opt))
    assert pvv.probe_layer.launches == len(pvv.VARIANTS)
    assert fused_vit.fused_vit_layer.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["qk64", "qk128", "pv64", "pv128"])
@pytest.mark.parametrize("s", [64, 100, 577])
@pytest.mark.parametrize("n", [1, 3, 96])
def test_cuda_dotk(cuda, kind, s, n):
    """K17 over S on and off the 128-row tile, one dot, a few, and the
    probe's 96 (split over the dots), f32 outputs held to 1e-3."""
    from streamchat_tpu_torch.utils import probe_vit_variants as pvv

    dh = int(kind[2:])
    shapes = ((s, s), (n, s, dh)) if kind.startswith("pv") else ((n, s, dh), (dh, s))
    a, b = (_bf(50 + i, cuda, *shp, scale=0.1) for i, shp in enumerate(shapes))
    got = pvv.dotk(a, b)
    assert got.dtype == torch.float32 and got.shape == (s, dh if kind.startswith("pv") else s)
    torch.testing.assert_close(got, pvv.dotk_plain(a, b), atol=1e-3, rtol=1e-3)
    assert pvv.dotk.launches == 1


@pytest.mark.cuda
def test_cuda_dotk_rejects_shapes(cuda):
    """A head dim other than 64 / 128, or a pv row tile past the shared
    memory, raises DotShapeError before any launch."""
    from streamchat_tpu_torch.utils import probe_vit_variants as pvv

    with pytest.raises(pvv.DotShapeError):
        pvv.dotk(_bf(1, cuda, 2, 100, 96), _bf(2, cuda, 96, 100))
    with pytest.raises(pvv.DotShapeError):
        pvv.dotk(_bf(1, cuda, 800, 800), _bf(2, cuda, 2, 800, 128))
    assert pvv.dotk.launches == 0


_PROBE_SHAPES = {"even": (512, 1024), "ragged-tile": (512, 992), "ragged-4": (640, 1000)}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("block_out,gpb", [(256, 2), (256, 3), (128, 8), (2048, 4)])
@pytest.mark.parametrize("shape", list(_PROBE_SHAPES))
def test_cuda_int4_probe(cuda, n, block_out, gpb, shape):
    """K15's five variants against their twin; dma sums whole bytes, so it
    is exact. 4 (or 5) groups: gpb 3 does not divide them, 8 is above them,
    4 puts the slice in one cluster of 4 row ranges; packed widths 512, 496
    (a ragged last sub-tile) and 500 (not a multiple of 16: 4-byte loads)."""
    from streamchat_tpu_torch.utils import probe_int4

    kin, out = _PROBE_SHAPES[shape]
    w, s = _int4(7, cuda, kin, out)
    x = _bf(8, cuda, n, kin)
    for variant in probe_int4.VARIANTS:
        got = probe_int4.matvec(x, w, s, variant=variant, block_out=block_out, gpb=gpb)
        ref = probe_int4.matvec_plain(x, w, s, variant, block_out, gpb)
        if variant == "dma":
            assert torch.equal(got, ref)
        else:
            torch.testing.assert_close(got, ref, atol=1e-4 * ref.abs().max().item(), rtol=0)
    assert probe_int4.matvec.launches == len(probe_int4.VARIANTS)


@pytest.mark.cuda
def test_cuda_int4_probe_full_shape(cuda):
    """K15 at the probe's shape (3584 x 18944, n = 1), at (1024, 16) and the
    sweep's gpb 32 (one slice, a cluster of 4 row ranges): every variant
    against its twin, dma exactly."""
    from streamchat_tpu_torch.utils import probe_int4

    g = torch.Generator(device="cuda").manual_seed(3)
    (w, s), = probe_int4.make_weights(g, copies=1)[0]
    x = torch.randn(1, probe_int4.DIN, generator=g, device=cuda).to(torch.bfloat16)
    for bo, gpb in ((1024, 16), (512, 32)):
        for variant in probe_int4.VARIANTS:
            got = probe_int4.matvec(x, w, s, variant=variant, block_out=bo, gpb=gpb)
            ref = probe_int4.matvec_plain(x, w, s, variant, bo, gpb)
            if variant == "dma":
                assert torch.equal(got, ref)
            else:
                torch.testing.assert_close(got, ref, atol=1e-4 * ref.abs().max().item(), rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 8])
def test_cuda_probes_repeat_bit_for_bit(cuda, n):
    """K15 (row ranges in a cluster, slices by the split-K reduce) and K17
    (dot slices by the split-K reduce) sum in a fixed order: two launches on
    the same inputs are equal bit for bit."""
    from streamchat_tpu_torch.utils import probe_int4
    from streamchat_tpu_torch.utils import probe_vit_variants as pvv

    w, s = _int4(9, cuda, 640, 1024)
    x = _bf(10, cuda, n, 640)
    for variant in probe_int4.VARIANTS:
        for gpb in (3, 5):
            first = probe_int4.matvec(x, w, s, variant=variant, gpb=gpb)
            assert torch.equal(first, probe_int4.matvec(x, w, s, variant=variant, gpb=gpb))
    for kind in pvv.DOT_KINDS:
        a, b = (t.to(cuda) for t in pvv.make_dot_inputs(kind, torch.Generator().manual_seed(n),
                                                      device="cpu"))
        assert torch.equal(pvv.dotk(a, b), pvv.dotk(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 1])
def test_cuda_w8a16_gemv_lm_head(cuda, n):
    """W8 at the LLaMA-3-8B head: 4096 -> 128,256 columns, f32 out."""
    g = torch.Generator(device=cuda).manual_seed(n)
    w = torch.randn(4096, 128256, generator=g, device=cuda) * 0.02
    q = quant.quantize_weight(w)
    del w
    x = torch.randn(n, 4096, generator=g, device=cuda).to(torch.bfloat16)
    got = quant.qmatvec_int8(x, q["w_i8"], q["scale"], torch.float32)
    assert got.dtype == torch.float32 and got.shape == (n, 128256)
    _close(got, quant.qmatvec_int8_plain(x, q["w_i8"], q["scale"], torch.float32))
    assert quant.qmatvec_int8.launches == 1


def _judge_cfg():
    """LLaMA-3-8B's heads (32 / 8, head dim 128) on a narrow, 4-layer stack."""
    from streamchat_tpu_torch.config import DecoderConfig

    return DecoderConfig(vocab_size=2048, hidden_size=1024, intermediate_size=2048,
                         num_layers=4, num_heads=32, num_kv_heads=8, head_dim=128,
                         rope_theta=5e5, rms_eps=1e-5, qkv_bias=False, eos_token_id=1,
                         pad_token_id=0)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_cuda_dense_decode_step_g4(cuda, monkeypatch, int8):
    """Three ragged rows prefilled (K3 at g 4) and two dense decode steps
    (W8 for the int8 tree) against the same path on the kernels' plain
    twins: logits within a relative L2 error of 2e-2 (bf16 storage, four
    layers, another summation order)."""
    from streamchat_tpu_torch.models import decoder
    from streamchat_tpu_torch.ops import attention as attn_ops

    cfg = _judge_cfg()
    g = torch.Generator(device=cuda).manual_seed(0)
    params = decoder.init(cfg, g, device=cuda)
    if int8:
        params = quant.quantize_decoder_params(params)
    lengths = torch.tensor([300, 129, 17], dtype=torch.int32, device=cuda)
    embeds = (torch.randn(3, 384, cfg.hidden_size, generator=g, device=cuda) * 0.5).to(
        torch.bfloat16)
    toks = [torch.tensor(t, device=cuda) for t in ([5, 70, 900], [11, 11, 2047])]

    def run():
        cache = decoder.KVCache.create(cfg, 3, 512, device=cuda)
        logits, cache = decoder.prefill(params, cfg, embeds, cache, lengths)
        out = [logits]
        for t in toks:
            logits, cache = decoder.decode_step(params, cfg, t, cache)
            out.append(logits)
        assert cache.length.tolist() == [302, 131, 19]
        return out

    got = run()
    counts = kernels.launch_counts()
    assert counts["flash_attention"] == cfg.num_layers
    # Each decode step: seven projections a layer and the head; the prefill's
    # three last-token rows take the head's GEMV too.
    assert counts["qmatvec_int8"] == (2 * 7 * cfg.num_layers + 3 if int8 else 0)
    monkeypatch.setattr(decoder, "flash_attention", attn_ops.flash_attention_plain)
    monkeypatch.setattr(quant, "qmatvec_int8", quant.qmatvec_int8_plain)
    ref = run()
    for a, b in zip(got, ref):
        rel = ((a - b).norm() / b.norm()).item()
        assert torch.isfinite(a).all() and rel <= 2e-2, rel


# Each decode path as `generate` / `generate_paged` runs it on the card: (rows'
# valid lengths, weights, generate_paged's keywords; None for the dense loop).
GRAPH_PATHS = {
    "dense_b3": ([250, 131, 17], "bf16", None),
    "dense_b3_int8": ([250, 131, 17], "int8", None),
    "row_order_b1": ([250], "bf16", {}),
    "row_order_b1_int8": ([250], "int8", {}),
    "row_order_b1_int4_kv_int8": ([250], "int4", dict(kv_int8=True)),
    "partitioned_b2": ([250, 131], "int8", {}),
    "table_b3": ([250, 131, 17], "bf16", dict(num_pages=8, max_pages_per_seq=4)),
    "table_b3_kv_int8": ([250, 131, 17], "bf16",
                         dict(num_pages=8, max_pages_per_seq=4, kv_int8=True)),
    "spec4_b1": ([250], "bf16", dict(spec_tokens=4)),
    "spec4_b1_kv_int8": ([250], "int8", dict(spec_tokens=4, kv_int8=True)),
}
GRAPH_SAMPLING = {"greedy": dict(temperature=0.0), "temperature": dict(temperature=1.0),
                  "top_p": dict(temperature=0.8, top_p=0.9)}


@pytest.mark.cuda
@pytest.mark.parametrize("sampling", list(GRAPH_SAMPLING))
@pytest.mark.parametrize("path", list(GRAPH_PATHS))
def test_cuda_graphed_decode_bit_equal_to_eager(cuda, path, sampling):
    """Each decode loop run twice from the same generator state: its step
    replayed as a CUDA graph (the default on the card) and eager (graph=
    False). The tokens are bit-equal, the graphed run captured once and
    replayed every later step, and the launch counters of both runs agree
    (each replay counts the launches its capture recorded)."""
    from streamchat_tpu_torch.models import decoder, generate, generate_paged

    lengths, weights, paged = GRAPH_PATHS[path]
    if sampling == "top_p" and paged and paged.get("spec_tokens"):
        pytest.skip("speculative decode refuses top_p")
    cfg = _judge_cfg()
    g = torch.Generator(device=cuda).manual_seed(0)
    params = decoder.init(cfg, g, device=cuda)
    if weights != "bf16":
        params = quant.quantize_decoder_params(params, bits=4 if weights == "int4" else 8)
    b = len(lengths)
    embeds = (torch.randn(b, 256, cfg.hidden_size, generator=g, device=cuda) * 0.5).to(
        torch.bfloat16)
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    state = g.get_state()
    runs = []
    for graph in (None, False):
        g.set_state(state)
        stats = {}
        kernels.reset_launch_counts()
        kw = dict(max_new_tokens=16, stats=stats, graph=graph, **GRAPH_SAMPLING[sampling])
        if paged is None:
            toks, _ = generate.generate(params, cfg, embeds, ln, g, **kw)
            toks = toks.cpu().numpy()
        else:
            toks, _ = generate_paged.generate_paged(params, cfg, embeds, ln, g, **paged, **kw)
        runs.append((toks, kernels.launch_counts(), stats))
    (graphed, graphed_counts, gstats), (eager, eager_counts, estats) = runs
    np.testing.assert_array_equal(graphed, eager)
    assert graphed_counts == eager_counts
    assert gstats["graph_captures"] == 1 and "graph_captures" not in estats
    assert gstats["graph_replays"] == gstats["decode_steps"] - 1 >= 1
    # The bf16 dense step launches none of the counted kernels (cuBLAS and
    # plain attention); every other path's replays launch some.
    assert (gstats["replayed_launches"] > 0) == (paged is not None or weights != "bf16")


# H2O under a 2-page pool (cap 256): the 250-token prompt fits, the loop
# compresses once at length 256 (step 6) to 232 slots, collecting mass
# until then (the plain gather) and running K4 after.
GRAPH_H2O = dict(num_pages=2, max_pages_per_seq=2, hh_size=100, recent_size=128, sink_size=4)


def _graph_h2o_inputs(cuda):
    from streamchat_tpu_torch.models import decoder

    cfg = _judge_cfg()
    g = torch.Generator(device=cuda).manual_seed(0)
    params = quant.quantize_decoder_params(decoder.init(cfg, g, device=cuda))
    embeds = (torch.randn(1, 256, cfg.hidden_size, generator=g, device=cuda) * 0.5).to(
        torch.bfloat16)
    return cfg, g, params, embeds, torch.tensor([250], dtype=torch.int32, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("sampling", list(GRAPH_SAMPLING))
def test_cuda_graphed_h2o_bit_equal_to_eager(cuda, sampling):
    """The H2O loop run twice from one generator state, graphed (the
    default) and eager: tokens and launch counts bit-equal, one capture a
    step form (collect, K4) and a replay for every later step, a
    compression inside the loop."""
    from streamchat_tpu_torch.models import generate_paged, step_graph

    cfg, g, params, embeds, ln = _graph_h2o_inputs(cuda)
    state = g.get_state()
    runs = []
    for graph in (None, False):
        g.set_state(state)
        stats = {}
        kernels.reset_launch_counts()
        toks, _ = generate_paged.generate_paged(params, cfg, embeds, ln, g, max_new_tokens=16,
                                                stats=stats, graph=graph, **GRAPH_H2O,
                                                **GRAPH_SAMPLING[sampling])
        runs.append((toks, kernels.launch_counts(), stats))
    step_graph.release()
    (graphed, graphed_counts, gstats), (eager, eager_counts, estats) = runs
    np.testing.assert_array_equal(graphed, eager)
    assert graphed_counts == eager_counts
    assert gstats["compressions_in_loop"] == 1 and gstats["graph_captures"] == 2
    assert gstats["graph_replays"] == gstats["decode_steps"] - 2 >= 8
    assert graphed_counts["paged_decode_attention_seq"] == 10 * cfg.num_layers
    assert "graph_captures" not in estats


def _poison_cache(ws):
    for name, x in ws.tensors.items():
        if name == "cache":
            for f in x.__dataclass_fields__:
                t = getattr(x, f)
                t.fill_(float("nan") if t.is_floating_point() else 7)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["dense_b3_int8", "row_order_b1", "table_b3_kv_int8",
                                  "spec4_b1", "h2o"])
def test_cuda_reused_graph_replays_with_no_capture(cuda, path):
    """Call 1 at a key captures; its kept pool is poisoned (NaN, int8 7) and
    call 2 from generator state S replays with no capture and no warm-up;
    call 3 from S in a fresh workspace gives the same tokens and launches."""
    from streamchat_tpu_torch.models import decoder, generate, generate_paged, step_graph

    if path == "h2o":
        cfg, g, params, embeds, ln = _graph_h2o_inputs(cuda)
        paged = GRAPH_H2O
    else:
        lengths, weights, paged = GRAPH_PATHS[path]
        cfg = _judge_cfg()
        g = torch.Generator(device=cuda).manual_seed(0)
        params = decoder.init(cfg, g, device=cuda)
        if weights != "bf16":
            params = quant.quantize_decoder_params(params)
        embeds = (torch.randn(len(lengths), 256, cfg.hidden_size, generator=g, device=cuda)
                  * 0.5).to(torch.bfloat16)
        ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)

    def call(x):
        stats = {}
        kernels.reset_launch_counts()
        kw = dict(max_new_tokens=16, stats=stats, temperature=1.0)
        if paged is None:
            toks = generate.generate(params, cfg, x, ln, g, **kw)[0].cpu().numpy()
        else:
            toks = generate_paged.generate_paged(params, cfg, x, ln, g, **paged, **kw)[0]
        return toks, kernels.launch_counts(), stats

    step_graph.release()
    _, _, first = call(embeds.flip(1))
    assert first["graph_captures"] >= 1 and not first["graph_reuses"]
    (ws,) = step_graph.workspaces()
    _poison_cache(ws)
    state = g.get_state()
    kept, kept_counts, stats = call(embeds)
    assert stats["graph_captures"] == 0 and stats["graph_reuses"] >= 1
    assert stats["graph_replays"] == stats["decode_steps"]
    step_graph.release()
    g.set_state(state)
    fresh, fresh_counts, _ = call(embeds)
    step_graph.release()
    np.testing.assert_array_equal(kept, fresh)
    assert kept_counts == fresh_counts


# The paged decode step's glue kernels (ops/decode_glue.py): Qwen2-7B and
# LLaMA-3-8B widths and heads.
GLUE_GEOMETRIES = {"qwen2": dict(hq=28, hkv=4, bias=True, theta=1e6, d=3584, f=18944),
                   "llama3": dict(hq=32, hkv=8, bias=False, theta=5e5, d=4096, f=14336)}


def _within_tolerance(got, ref):
    """The kernels' tolerance: elementwise 3e-2 + 2e-2 |ref|, and a row
    relative L2 error <= 1e-2."""
    _close(got, ref)
    g, r = got.float().flatten(1), ref.float().flatten(1)
    rel = ((g - r).norm(dim=1) / r.norm(dim=1).clamp_min(1e-30)).max().item()
    assert rel <= 1e-2, rel


def _bf16_ulps(a, b) -> int:
    """The largest distance between two bf16 tensors in units in the last
    place (the bit patterns in order)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 3, 8, 9, 66])
@pytest.mark.parametrize("residual", [False, True], ids=["no_delta", "delta"])
@pytest.mark.parametrize("geometry", list(GLUE_GEOMETRIES))
def test_cuda_add_rmsnorm(cuda, geometry, residual, rows):
    """add_rmsnorm against its plain twin: the residual add bit-equal (it
    rounds as the twin does), in place; the norm within the kernels'
    tolerance (its sum of squares is reduced in another order)."""
    from streamchat_tpu_torch.ops import decode_glue

    d = GLUE_GEOMETRIES[geometry]["d"]
    x, scale = _bf(1, cuda, rows, 1, d, scale=4.0), 1 + _bf(2, cuda, d, scale=0.1)
    delta = _bf(3, cuda, rows, 1, d) if residual else None
    ref_x, ref_h = decode_glue.add_rmsnorm_plain(x.clone(), delta, scale, 1e-6)
    got_x, got_h = decode_glue.add_rmsnorm(x, delta, scale, 1e-6)
    assert got_x is x and torch.equal(x, ref_x)
    _within_tolerance(got_h, ref_h)
    assert kernels.launch_counts()["add_rmsnorm"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("views", [False, True], ids=["tensors", "column_views"])
@pytest.mark.parametrize("rows", [1, 3, 8, 9, 66])
@pytest.mark.parametrize("geometry", list(GLUE_GEOMETRIES))
def test_cuda_silu_mul(cuda, geometry, rows, views):
    """silu_mul against its plain twin, on separate tensors and on column
    views of one [rows, 2F] buffer (K11's gate / up output)."""
    from streamchat_tpu_torch.ops import decode_glue

    f = GLUE_GEOMETRIES[geometry]["f"]
    both = _bf(4, cuda, rows, 1, 2 * f, scale=3.0)
    gate, up = ((both[..., :f], both[..., f:]) if views
                else (both[..., :f].contiguous(), both[..., f:].contiguous()))
    got = decode_glue.silu_mul(gate, up)
    _within_tolerance(got, decode_glue.silu_mul_plain(gate, up))
    assert kernels.launch_counts()["silu_mul"] == 1


def _glue_pool(dev, rows, hkv, int8, lengths, seed, num_pages=40, maxp=8, ps=128):
    """One layer's pool (random values) mapped through a shuffled table,
    with -1 past each row's pages, at the rows' lengths -> (k_pages,
    v_pages, k_scale, v_scale, table, length); the scales None for bf16."""
    shape = (num_pages, hkv, ps, 128)
    g = torch.Generator(device=dev).manual_seed(seed)
    if int8:
        pools = [torch.randint(-127, 128, shape, dtype=torch.int8, device=dev, generator=g)
                 for _ in range(2)]
        pools += [torch.rand(shape[:3], device=dev, generator=g) for _ in range(2)]
    else:
        pools = [_bf(seed, dev, *shape), _bf(seed + 1, dev, *shape), None, None]
    perm = torch.randperm(num_pages, generator=g, device=dev)[:rows * maxp].reshape(rows, maxp)
    for r, n in enumerate(lengths):
        perm[r, n // ps + 1:] = -1
    return (*pools, perm.to(torch.int32).contiguous(),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("positions", [False, True], ids=["at_length", "positions"])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16_pages", "int8_pages"])
@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("geometry", list(GLUE_GEOMETRIES))
def test_cuda_bias_rope_append(cuda, geometry, rows, int8, positions):
    """bias_rope_append against its plain twin at lengths on and past page
    edges and positions up to 23,105: the roped q and, with bf16 pages,
    every pool value within one bf16 ulp; with int8 pages the int8 values
    and the scales equal; no other slot of the pool written."""
    from streamchat_tpu_torch.ops import decode_glue

    geo = GLUE_GEOMETRIES[geometry]
    hq, hkv = geo["hq"], geo["hkv"]
    lengths = [127, 0, 1000][:rows]
    pool = _glue_pool(cuda, rows, hkv, int8, lengths, seed=7)
    twin = [None if t is None else t.clone() for t in pool]
    q, k, v = (_bf(10 + i, cuda, rows, 1, h * 128, scale=2.0)
               for i, h in enumerate((hq, hkv, hkv)))
    bias = (tuple(_bf(20 + i, cuda, h * 128) for i, h in enumerate((hq, hkv, hkv)))
            if geo["bias"] else None)
    pos = (torch.tensor([23_105, 5, 7_000][:rows], dtype=torch.int32, device=cuda)
           if positions else None)
    ref = decode_glue.bias_rope_append_plain(q, k, v, bias, pos, geo["theta"], *twin)
    got = decode_glue.bias_rope_append(q, k, v, bias, pos, geo["theta"], *pool)
    assert got.shape == (rows, hq, 1, 128) and _bf16_ulps(got, ref) <= 1
    if int8:
        for a, b in zip(pool[:4], twin[:4]):
            assert torch.equal(a, b)
    else:
        assert _bf16_ulps(pool[0], twin[0]) <= 1 and _bf16_ulps(pool[1], twin[1]) <= 1
    assert kernels.launch_counts()["bias_rope_append"] == 1


@pytest.mark.cuda
def test_cuda_decode_glue_regime(cuda):
    """On the card every wrapper launches its kernel for one bf16 token a
    row, any number of rows, and raises ValueError before any launch for
    another dtype, more than one token a row or a head dim other than 128;
    no call runs a plain twin."""
    from streamchat_tpu_torch.ops import decode_glue

    x = _bf(3, cuda, 9, 1, 256)
    decode_glue.add_rmsnorm(x, x, torch.ones(256, device=cuda, dtype=torch.bfloat16), 1e-6)
    decode_glue.silu_mul(x, x)
    pool = _glue_pool(cuda, 9, 4, False, [5 + 113 * r for r in range(9)], seed=1,
                      num_pages=72)
    twin = [None if t is None else t.clone() for t in pool]
    q, k = _bf(1, cuda, 9, 1, 28 * 128), _bf(2, cuda, 9, 1, 4 * 128)
    ref = decode_glue.bias_rope_append_plain(q, k, k, None, None, 1e6, *twin)
    got = decode_glue.bias_rope_append(q, k, k, None, None, 1e6, *pool)
    assert _bf16_ulps(got, ref) <= 1 and _bf16_ulps(pool[0], twin[0]) <= 1
    assert {n: kernels.launch_counts()[n] for n in ("add_rmsnorm", "silu_mul",
                                                     "bias_rope_append")} == {
        "add_rmsnorm": 1, "silu_mul": 1, "bias_rope_append": 1}
    assert not any(kernels.launch_modes().get(n) for n in ("add_rmsnorm", "silu_mul",
                                                            "bias_rope_append"))
    one = torch.ones(256, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="one token a row in bf16"):
        decode_glue.add_rmsnorm(x.float(), None, one.float(), 1e-6)
    with pytest.raises(ValueError, match="one token a row in bf16"):
        decode_glue.add_rmsnorm(_bf(4, cuda, 2, 3, 256), None, one, 1e-6)
    with pytest.raises(ValueError, match="one token a row in bf16"):
        decode_glue.silu_mul(x.float(), x.float())
    with pytest.raises(ValueError, match="one token a row in bf16"):
        decode_glue.bias_rope_append(q.float(), k, k, None, None, 1e6, *pool)
    pool64 = _glue_pool(cuda, 1, 4, False, [5], seed=1)
    k_pages = pool64[0][..., :64].contiguous()
    q64, k64 = _bf(1, cuda, 1, 1, 28 * 64), _bf(2, cuda, 1, 1, 4 * 64)
    with pytest.raises(ValueError, match="head dim"):
        decode_glue.bias_rope_append(q64, k64, k64, None, None, 1e6, k_pages,
                                     k_pages.clone(), None, None, *pool64[4:])
    assert kernels.launch_counts()["add_rmsnorm"] == 1
    assert kernels.launch_counts()["bias_rope_append"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("tree", ["int8", "int4_kv_int8"])
def test_cuda_graphed_glue_step_against_eager_plain_glue(cuda, monkeypatch, tree):
    """Qwen2-7B at full width (28 layers, random q/k/v biases; a 16,384-token
    vocabulary) as the benchmark's trees quantize it: one decode step over a
    1,000-token prompt's pool with the glue kernels against the same step
    with the plain glue (logits within a relative L2 error of 1e-2), then 64
    greedy tokens graphed on the kernels against the eager plain-glue loop
    (equal), the graphed run launching 28 x 4 + 1 = 113 glue kernels a step."""
    import dataclasses

    from streamchat_tpu_torch.config import DecoderConfig
    from streamchat_tpu_torch.models import decoder, generate_paged, paged_kv, step_graph
    from streamchat_tpu_torch.ops import decode_glue

    cfg = dataclasses.replace(DecoderConfig.qwen2_7b(), vocab_size=16384)
    g = torch.Generator(device=cuda).manual_seed(0)
    params = decoder.init(cfg, g, device=cuda)
    for p in params["layers"]:
        for n in "qkv":
            p["attn"][n]["b"] = (torch.randn(p["attn"][n]["b"].shape, generator=g, device=cuda)
                                 * 0.5).to(torch.bfloat16)
    params = quant.quantize_decoder_params(params, bits=8 if tree == "int8" else 4)
    kv_int8 = tree != "int8"
    torch.cuda.empty_cache()
    embeds = (torch.randn(1, 1024, cfg.hidden_size, generator=g, device=cuda) * 0.5).to(
        torch.bfloat16)
    ln = torch.tensor([1000], dtype=torch.int32, device=cuda)
    plain = dict(add_rmsnorm=decode_glue.add_rmsnorm_plain,
                 bias_rope_append=decode_glue.bias_rope_append_plain,
                 silu_mul=decode_glue.silu_mul_plain)

    dense = decoder.KVCache.create(cfg, 1, 1024, device=cuda)
    logits, dense = decoder.prefill(params, cfg, embeds, dense, ln)
    tok = torch.argmax(logits, -1)
    page = paged_kv.from_contiguous_int8 if kv_int8 else paged_kv.from_contiguous
    step = paged_kv.decode_step_paged_int8 if kv_int8 else paged_kv.decode_step_paged
    got, _ = step(params, cfg, tok, page(dense, 8, 8), sequential_pages=True)
    with monkeypatch.context() as m:
        for name, fn in plain.items():
            m.setattr(decode_glue, name, fn)
        ref, _ = step(params, cfg, tok, page(dense, 8, 8), sequential_pages=True)
    rel = ((got - ref).norm() / ref.norm()).item()
    assert torch.isfinite(got).all() and rel <= 1e-2, rel
    del dense

    def run(graph):
        stats = {}
        kernels.reset_launch_counts()
        toks, _ = generate_paged.generate_paged(params, cfg, embeds, ln, g, max_new_tokens=64,
                                                kv_int8=kv_int8, stats=stats, graph=graph)
        return toks, stats, kernels.launch_counts()

    step_graph.release()
    fused, stats, counts = run(None)
    step_graph.release()
    with monkeypatch.context() as m:
        for name, fn in plain.items():
            m.setattr(decode_glue, name, fn)
        eager, _, _ = run(False)
    step_graph.release()
    np.testing.assert_array_equal(fused, eager)
    assert stats["graph_captures"] == 1
    steps = stats["decode_steps"]
    assert counts["add_rmsnorm"] == (2 * cfg.num_layers + 1) * steps
    assert counts["bias_rope_append"] == cfg.num_layers * steps
    assert counts["silu_mul"] == cfg.num_layers * steps
