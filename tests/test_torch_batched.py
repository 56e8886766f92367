"""The port's batched paged generation against the JAX package's, on the CPU.

Inputs are numpy arrays made from a seed and handed to both packages, at
tiny geometry in float32. Tolerances:
- The K8 / K9 twins (`paged_decode_attention_table{,_int8}_plain`) against
  the JAX Pallas kernels in interpret mode, over a B = 3 pool the allocator
  filled a token at a time (the rows' pages interleave): atol 2e-5 (sums of
  up to 48 exponentials in another order).
- The allocator, partitioned paging and the dispatch: tables, `next_free`,
  the overflow flag, pages and scales exactly; decode-step logits to atol
  1e-4.
- `prefill_chunked` when a row's last token lies before the final chunk
  (the re-run branch): logits to atol 1e-4; the cache after prefill to atol
  1e-4 (f32), or int8 values equal but at rounding ties with scales to
  rtol 1e-5 (1e-3 downstream of a tie; see test_torch_chunked).
- `generate_paged` at B = 3 (split path, caller-sized pool, caller-given
  partition), B = 2 speculative decode, `generate_with_image_embedding_batch`
  and `process_video` with caption_batch 2: greedy tokens identical.
`CHUNKED_PREFILL_THRESHOLD` is lowered to 256 in both packages where a
prompt must be chunked. On a CPU tensor no wrapper may count a kernel launch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import streamchat_tpu.models.generate as j_generate
import streamchat_tpu.models.generate_paged as j_generate_paged
from streamchat_tpu import config as jconfig
from streamchat_tpu.memory.bank import MemoryBank as JBank
from streamchat_tpu.models import decoder as jdec
from streamchat_tpu.models import paged_kv as jpkv
from streamchat_tpu.models.generate_paged import generate_paged as j_generate_paged_fn
from streamchat_tpu.models.longva import LongVA as JLongVA
from streamchat_tpu.ops.paged_attention import (
    paged_decode_attention_pallas,
    paged_decode_attention_pallas_int8,
)
from streamchat_tpu.video.reader import SyntheticVideoReader
from streamchat_tpu_torch import config, convert, kernels
from streamchat_tpu_torch.memory.bank import MemoryBank
from streamchat_tpu_torch.models import decoder, generate, paged_kv, spec_decode
from streamchat_tpu_torch.models import generate_paged as port_generate_paged
from streamchat_tpu_torch.models import longva as port_longva
from streamchat_tpu_torch.models.generate_paged import generate_paged
from streamchat_tpu_torch.models.longva import LongVA
from streamchat_tpu_torch.models.tokenizer import ByteTokenizer
from streamchat_tpu_torch.ops import paged_attention
from tests.test_torch_chunked import assert_int8_cache_matches_up_to_ties, record_prequant_ratios

ATOL = 1e-4


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture
def no_launches():
    kernels.reset_launch_counts()
    yield
    assert all(v == 0 for v in kernels.launch_counts().values()), \
        "a CPU tensor must run the plain twin, never count a launch"


@pytest.fixture(scope="module")
def tiny():
    """Tiny f32 decoder weights in both packages."""
    jcfg = jconfig.DecoderConfig.tiny()
    jparams = jdec.init(jax.random.key(0), jcfg, jnp.float32)
    return dict(jcfg=jcfg, jparams=jparams,
                cfg=config.DecoderConfig(**dataclasses.asdict(jcfg)),
                params=convert.to_torch(_np(jparams)))


@pytest.fixture
def low_threshold(monkeypatch):
    """CHUNKED_PREFILL_THRESHOLD = 256 in both packages; the JAX jit caches
    are cleared before and after, so no trace made under another threshold
    is reused, and none made under this one outlives the test."""
    jax.clear_caches()
    monkeypatch.setattr(j_generate, "CHUNKED_PREFILL_THRESHOLD", 256)
    monkeypatch.setattr(generate, "CHUNKED_PREFILL_THRESHOLD", 256)
    yield
    jax.clear_caches()


# ---------------------------------------------------------------------------
# K8 / K9 twins, the allocator and paging
# ---------------------------------------------------------------------------


def _grown_table(lengths, num_pages, maxp, ps):
    """The JAX allocator's table after growing each row a token at a time
    (rows claim pages in batch order whenever they cross a page)."""
    cache = jpkv.PagedKVCache.create(jconfig.DecoderConfig.tiny(), batch=len(lengths),
                                     num_pages=num_pages, max_pages_per_seq=maxp,
                                     page_size=ps, dtype=jnp.float32)
    for t in range(max(lengths)):
        grow = jnp.asarray([int(t < n) for n in lengths], jnp.int32)
        cache = jpkv.allocate_pages(cache, grow)
        cache = cache._replace(length=cache.length + grow)
    return np.array(cache.page_table)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_pages", "int8_pages"])
@pytest.mark.parametrize("hole", [False, True], ids=["mapped", "unmapped-inside-length"])
def test_table_twins_match_jax_kernel(no_launches, int8, hole):
    """B = 3 rows of 37, 1 and 20 tokens in 8-token pages; pool pages no row
    maps hold NaN (and inf scales). With `hole`, row 0's second table entry
    is -1 inside its length: both skip that page's keys."""
    lengths, ps, maxp, num_pages, hq, hkv, d = [37, 1, 20], 8, 6, 12, 4, 2, 32
    table = _grown_table(lengths, num_pages, maxp, ps)
    assert (table[0, :5] != np.arange(5)).any(), "the rows' pages must interleave"
    if hole:
        table[0, 1] = -1
    used = set(table[table >= 0].tolist())
    free = [p for p in range(num_pages) if p not in used]
    assert free, "some pool page must be unmapped"
    q = _rand(1, 3, hq, 1, d)
    kd, vd = _rand(2, num_pages, hkv, ps, d), _rand(3, num_pages, hkv, ps, d)
    length = np.asarray(lengths, np.int32)
    if int8:
        rng = np.random.default_rng(4)
        kq, vq = (rng.integers(-127, 128, kd.shape, dtype=np.int8) for _ in range(2))
        ks, vs = (rng.uniform(0.005, 0.02, kd.shape[:3]).astype(np.float32) for _ in range(2))
        ks[free], vs[free] = np.nan, np.inf
        ref = paged_decode_attention_pallas_int8(
            *(jnp.asarray(a) for a in (q, kq, vq, ks, vs, table, length)), interpret=True)
        out = paged_attention.paged_decode_attention_table_int8(
            *(torch.from_numpy(a) for a in (q, kq, vq, ks, vs, table, length)))
    else:
        kd[free], vd[free] = np.nan, np.nan
        ref = paged_decode_attention_pallas(
            *(jnp.asarray(a) for a in (q, kd, vd, table, length)), interpret=True)
        out = paged_attention.paged_decode_attention_table(
            *(torch.from_numpy(a) for a in (q, kd, vd, table, length)))
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


def test_table_twin_row_without_keys_is_zero(no_launches):
    """A row whose table maps nothing below its length returns 0, as the
    Pallas kernel does (the XLA gather would average page 0 uniformly)."""
    q = torch.from_numpy(_rand(5, 2, 4, 1, 32))
    kp, vp = torch.from_numpy(_rand(6, 4, 2, 8, 32)), torch.from_numpy(_rand(7, 4, 2, 8, 32))
    table = torch.tensor([[0, 1], [-1, -1]], dtype=torch.int32)
    out = paged_attention.paged_decode_attention_table(q, kp, vp, table,
                                                       torch.tensor([12, 9], dtype=torch.int32))
    ref = paged_decode_attention_pallas(*(jnp.asarray(t.numpy()) for t in (q, kp, vp, table)),
                                        jnp.asarray([12, 9], jnp.int32), interpret=True)
    assert (out[1] == 0).all() and np.abs(np.asarray(ref)[1]).max() == 0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


def _dense_pair(cfg, jcfg, lengths, lmax, seed):
    shape = (jcfg.num_layers, len(lengths), jcfg.num_kv_heads, lmax, jcfg.head_dim)
    k, v = _rand(seed, *shape), _rand(seed + 1, *shape)
    jd = jdec.KVCache(k=jnp.asarray(k), v=jnp.asarray(v), length=jnp.asarray(lengths, jnp.int32))
    pd = decoder.KVCache(k=torch.from_numpy(k), v=torch.from_numpy(v),
                         length=torch.tensor(lengths, dtype=torch.int32))
    return jd, pd


def _same_cache(pc, jc, fields):
    for name in fields:
        np.testing.assert_array_equal(getattr(pc, name).numpy(), np.asarray(getattr(jc, name)),
                                      err_msg=name)


_TABLE_FIELDS = ("page_table", "length", "next_free")


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_pages", "int8_pages"])
def test_allocator_matches_jax(tiny, int8):
    """Ragged growth from a paged prefill until the pool overflows: the
    tables, `next_free` and the overflow flag equal JAX's after every call,
    and `allocate_pages` raises ValueError on the overflowing call in both."""
    jd, pd = _dense_pair(tiny["cfg"], tiny["jcfg"], [5, 12, 1], 16, seed=10)
    with jax.disable_jit():
        jc = (jpkv.from_contiguous_int8 if int8 else jpkv.from_contiguous)(jd, 14, 5, page_size=4)
    pc = (paged_kv.from_contiguous_int8 if int8 else paged_kv.from_contiguous)(pd, 14, 5,
                                                                             page_size=4)
    _same_cache(pc, jc, _TABLE_FIELDS)
    j_alloc = jpkv.allocate_pages_int8_checked if int8 else jpkv.allocate_pages_checked
    p_alloc = paged_kv.allocate_pages_int8_checked if int8 else paged_kv.allocate_pages_checked
    flags = []
    for grow in ([3, 0, 2], [1, 1, 1], [0, 4, 0], [6, 0, 1], [0, 0, 9]):
        jc, jover = j_alloc(jc, jnp.asarray(grow, jnp.int32))
        old_table = pc.page_table
        pc2, pover = p_alloc(pc, torch.tensor(grow, dtype=torch.int32))
        assert pc2.page_table is not old_table and pc2.k_pages is pc.k_pages
        pc = pc2
        _same_cache(pc, jc, ("page_table", "next_free"))
        assert bool(pover) == bool(jover)
        flags.append(bool(pover))
        jc = jc._replace(length=jc.length + jnp.asarray(grow, jnp.int32))
        pc.length = pc.length + torch.tensor(grow, dtype=torch.int32)
    assert flags[-1] and not flags[0]
    assert paged_kv.has_overflowed(pc) == bool(jpkv.has_overflowed(jc)) is True
    grow = [0, 0, 9]
    jraise = jpkv.allocate_pages_int8 if int8 else jpkv.allocate_pages
    praise = paged_kv.allocate_pages_int8 if int8 else paged_kv.allocate_pages
    with pytest.raises(ValueError, match="overflow"):
        jraise(jc, jnp.asarray(grow, jnp.int32))
    with pytest.raises(ValueError, match="overflow"):
        praise(pc, torch.tensor(grow, dtype=torch.int32))


def test_paged_cache_create_matches_jax(tiny):
    jc = jpkv.PagedKVCache.create(tiny["jcfg"], 3, 10, 4, page_size=8, dtype=jnp.float32)
    pc = paged_kv.PagedKVCache.create(tiny["cfg"], 3, 10, 4, page_size=8, dtype=torch.float32)
    _same_cache(pc, jc, ("k_pages", "v_pages") + _TABLE_FIELDS)


@pytest.mark.parametrize("partitioned", [False, True], ids=["sequential", "partitioned"])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16_pages", "int8_pages"])
def test_from_contiguous_matches_jax(tiny, int8, partitioned):
    """Pools, scales, tables and `next_free` equal JAX's (its quantizer run
    eagerly, as the port's)."""
    jd, pd = _dense_pair(tiny["cfg"], tiny["jcfg"], [13, 30], 32, seed=20)
    maxp, num_pages = 5, 10
    with jax.disable_jit():
        fn = jpkv.from_contiguous_int8 if int8 else jpkv.from_contiguous
        jc = fn(jd, num_pages, maxp, page_size=8, partitioned=partitioned)
    fn = paged_kv.from_contiguous_int8 if int8 else paged_kv.from_contiguous
    pc = fn(pd, num_pages, maxp, page_size=8, partitioned=partitioned)
    pages = ("k_pages", "v_pages") + (("k_scale", "v_scale") if int8 else ())
    _same_cache(pc, jc, pages + _TABLE_FIELDS)
    if partitioned:
        with pytest.raises(ValueError, match="partitioned"):
            fn(pd, num_pages + 1, maxp, page_size=8, partitioned=True)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_pages", "int8_pages"])
def test_decode_step_defaults_to_the_table_as_jax(no_launches, tiny, int8):
    """A B = 2 `from_contiguous` pool that is not partitioned (Lmax 256,
    page 128, max_pages_per_seq 4, 8 pages): row 1's pages are 2-3, not its
    partition 4-7. The default decode step reads them through the table,
    as JAX's does; the pool-order kernel would read another row's KV."""
    jcfg, cfg = tiny["jcfg"], tiny["cfg"]
    embeds, length = _rand(30, 2, 256, jcfg.hidden_size, scale=0.5), np.asarray([200, 150],
                                                                               np.int32)
    jdense = jdec.KVCache.create(jcfg, 2, 256, dtype=jnp.float32)
    _, jdense = jdec.prefill(tiny["jparams"], jcfg, jnp.asarray(embeds), jdense,
                             jnp.asarray(length))
    dense = decoder.KVCache.create(cfg, 2, 256, dtype=torch.float32)
    _, dense = decoder.prefill(tiny["params"], cfg, torch.from_numpy(embeds), dense,
                               torch.from_numpy(length))
    with jax.disable_jit():
        jpaged = (jpkv.from_contiguous_int8 if int8 else jpkv.from_contiguous)(
            jdense, 8, 4, page_size=128)
    paged = (paged_kv.from_contiguous_int8 if int8 else paged_kv.from_contiguous)(
        dense, 8, 4, page_size=128)
    assert paged.page_table.tolist() == [[0, 1, -1, -1], [2, 3, -1, -1]]
    j_step = jpkv.decode_step_paged_int8 if int8 else jpkv.decode_step_paged
    p_step = paged_kv.decode_step_paged_int8 if int8 else paged_kv.decode_step_paged
    for tok in ([17, 300], [5, 9]):
        ref, jpaged = j_step(tiny["jparams"], jcfg, jnp.asarray(tok, jnp.int32), jpaged)
        out, paged = p_step(tiny["params"], cfg, torch.tensor(tok), paged)
        # int8 pages: one quantization step of a K/V entry moves logits ~1e-3.
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3 if int8 else ATOL,
                                   rtol=0)


# ---------------------------------------------------------------------------
# prefill_chunked's re-run branch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lengths", [[370, 200], [150, 370]], ids=["short-row-1", "short-row-0"])
@pytest.mark.parametrize("int8", [False, True], ids=["KVCache", "Int8KVCache"])
def test_prefill_chunked_rerun_matches_jax(no_launches, tiny, monkeypatch, int8, lengths):
    """B = 2, 384 tokens in chunks of 128: one row's last token lies before
    the final chunk, so both packages re-run a window for the logits. The
    cache after prefill equals JAX's (the re-run's K/V, which JAX writes
    into a dropped copy, must not land in the port's cache)."""
    jcfg, cfg = tiny["jcfg"], tiny["cfg"]
    embeds, length = _rand(40, 2, 384, jcfg.hidden_size, scale=0.5), np.asarray(lengths,
                                                                               np.int32)
    jcache = (jdec.Int8KVCache.create(jcfg, 2, 384) if int8 else
              jdec.KVCache.create(jcfg, 2, 384, dtype=jnp.float32))
    jlogits, jcache = jdec.prefill_chunked(tiny["jparams"], jcfg, jnp.asarray(embeds), jcache,
                                           jnp.asarray(length), chunk=128)
    reruns = []
    rerun = decoder._rerun_last
    monkeypatch.setattr(decoder, "_rerun_last", lambda *a: reruns.append(1) or rerun(*a))
    cache = (decoder.Int8KVCache.create(cfg, 2, 384) if int8 else
             decoder.KVCache.create(cfg, 2, 384, dtype=torch.float32))
    ratios = record_prequant_ratios(monkeypatch, cache) if int8 else None
    logits, cache = decoder.prefill_chunked(tiny["params"], cfg, torch.from_numpy(embeds),
                                            cache, torch.from_numpy(length), chunk=128)
    assert reruns == [1]
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL, rtol=0)
    assert cache.length.tolist() == lengths
    if int8:
        assert_int8_cache_matches_up_to_ties(cache, jcache, ratios)
    else:
        for name in ("k", "v"):
            np.testing.assert_allclose(getattr(cache, name).numpy(),
                                       np.asarray(getattr(jcache, name)), atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# generate_paged at B > 1
# ---------------------------------------------------------------------------


def _rows(tiny, s, lengths, seed):
    return _rand(seed, len(lengths), s, tiny["jcfg"].hidden_size, scale=0.5), np.asarray(
        lengths, np.int32)


def _both(tiny, embeds, length, **kw):
    """Greedy tokens and counts of both packages' generate_paged."""
    jt, jn = j_generate_paged_fn(tiny["jparams"], tiny["jcfg"], jnp.asarray(embeds),
                                 jnp.asarray(length), jax.random.key(2), temperature=0.0, **kw)
    stats = {}
    pt, pn = generate_paged(tiny["params"], tiny["cfg"], torch.from_numpy(embeds),
                            torch.from_numpy(length), temperature=0.0, stats=stats, **kw)
    return (np.asarray(jt), np.asarray(jn)), (pt, pn), stats


@pytest.mark.parametrize("kv_int8", [False, True], ids=["pages", "int8_pages"])
def test_split_path_token_exact(no_launches, low_threshold, tiny, monkeypatch, kv_int8):
    """B = 3 rows of 290, 150 and 60 valid tokens in a 300-token batch (over
    the lowered threshold: 384 padded, chunks of 128): each row prefills
    alone, the 150- and 60-token rows through the re-run branch, then one
    batched decode loop over the partitioned pool."""
    embeds, length = _rows(tiny, 300, [290, 150, 60], seed=50)
    reruns = []
    rerun = decoder._rerun_last
    monkeypatch.setattr(decoder, "_rerun_last", lambda *a: reruns.append(1) or rerun(*a))
    (jt, jn), (pt, pn), stats = _both(tiny, embeds, length, max_new_tokens=12, page_size=16,
                                      kv_int8=kv_int8)
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_array_equal(pn, jn)
    assert len(reruns) == 2
    assert stats["batched_rows"] == 3 and stats["prompt_tokens"] == 3 * 384


class _Counting:
    """Counts the calls of a module attribute while the test runs."""

    def __init__(self, monkeypatch, module, name):
        self.calls = 0
        fn = getattr(module, name)

        def wrapped(*a, **kw):
            self.calls += 1
            return fn(*a, **kw)

        monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["pages", "int8_pages"])
def test_caller_sized_pool_token_exact(no_launches, tiny, monkeypatch, kv_int8):
    """B = 3 on a pool of 18 pages of 8 tokens, 6 table slots per row (not a
    static partition): the rows prefill together, page through
    `from_contiguous` (15 pages) and map three more as they grow (a row
    whose length lies below its padded prompt's pages gets a fresh page for
    the next slot), decoding through the table (K8 / K9 twins)."""
    embeds, length = _rows(tiny, 40, [37, 20, 5], seed=60)
    table = _Counting(monkeypatch, paged_kv, "paged_decode_attention_table_int8" if kv_int8
                      else "paged_decode_attention_table")
    seq = _Counting(monkeypatch, paged_kv, "paged_decode_attention_seq_int8" if kv_int8
                    else "paged_decode_attention_seq")
    alloc = _Counting(monkeypatch, port_generate_paged, "allocate_pages_")
    (jt, jn), (pt, pn), _ = _both(tiny, embeds, length, max_new_tokens=10, page_size=8,
                                  num_pages=18, max_pages_per_seq=6, kv_int8=kv_int8)
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_array_equal(pn, jn)
    assert table.calls > 0 and seq.calls == 0 and alloc.calls > 0


def test_single_row_caller_pool_token_exact(no_launches, tiny, monkeypatch):
    """B = 1 on a caller-sized pool: a 16-token row in a 48-token padded
    prompt gets a fresh page (page 3) for its second slot when it grows, so
    decode reads through the table (the JAX package's reference path)."""
    embeds, length = _rows(tiny, 40, [16], seed=65)
    table = _Counting(monkeypatch, paged_kv, "paged_decode_attention_table")
    (jt, jn), (pt, pn), _ = _both(tiny, embeds, length, max_new_tokens=20, page_size=16,
                                  num_pages=5, max_pages_per_seq=5)
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_array_equal(pn, jn)
    assert table.calls > 0


@pytest.mark.parametrize("kv_int8", [False, True], ids=["pages", "int8_pages"])
def test_caller_given_partition_token_exact(no_launches, tiny, monkeypatch, kv_int8):
    """num_pages == B * max_pages_per_seq with max_pages_per_seq a multiple
    of 8: a static partition, prefilled row by row and read in row order."""
    embeds, length = _rows(tiny, 40, [37, 20, 5], seed=70)
    seq = _Counting(monkeypatch, paged_kv, "paged_decode_attention_seq_int8" if kv_int8
                    else "paged_decode_attention_seq")
    (jt, jn), (pt, pn), _ = _both(tiny, embeds, length, max_new_tokens=10, page_size=8,
                                  num_pages=24, max_pages_per_seq=8, kv_int8=kv_int8)
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_array_equal(pn, jn)
    assert seq.calls > 0


@pytest.mark.parametrize("num_pages,max_pages", [(17, 6), (24, 8)],
                         ids=["pool-exhausted", "partition-too-short"])
def test_undersized_pool_raises(no_launches, tiny, num_pages, max_pages):
    """A pool that holds the prompts but not the decode: RuntimeError in both."""
    embeds, length = _rows(tiny, 40, [37, 20, 5], seed=80)
    kw = dict(max_new_tokens=40 if max_pages == 8 else 10, page_size=8, num_pages=num_pages,
              max_pages_per_seq=max_pages)
    with pytest.raises(RuntimeError, match="overflow"):
        j_generate_paged_fn(tiny["jparams"], tiny["jcfg"], jnp.asarray(embeds),
                            jnp.asarray(length), jax.random.key(2), **kw)
    with pytest.raises(RuntimeError, match="overflow"):
        generate_paged(tiny["params"], tiny["cfg"], torch.from_numpy(embeds),
                       torch.from_numpy(length), **kw)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["pages", "int8_pages"])
def test_batched_spec_token_exact(no_launches, tiny, kv_int8):
    """spec_tokens 2 at B = 2 on the split path, with a lookup corpus under
    which drafts are accepted (ragged acceptance across the rows): tokens
    equal JAX's spec loop and the port's vanilla loop."""
    embeds, length = _rows(tiny, 40, [37, 22], seed=90)
    args = (tiny["params"], tiny["cfg"], torch.from_numpy(embeds), torch.from_numpy(length))
    kw = dict(max_new_tokens=16, temperature=0.0, page_size=16, kv_int8=kv_int8)
    vanilla, vcount = generate_paged(*args, **kw)
    lookup = spec_decode.build_lookup_arrays([vanilla[0][:10].tolist(),
                                              vanilla[1][2:12].tolist()])
    stats = {}
    toks, count = generate_paged(*args, **kw, spec_tokens=2, stats=stats, **lookup)
    jt, jn = j_generate_paged_fn(
        tiny["jparams"], tiny["jcfg"], jnp.asarray(embeds), jnp.asarray(length),
        jax.random.key(2), **kw, spec_tokens=2,
        lookup_tokens=jnp.asarray(lookup["lookup_tokens"].numpy(), jnp.int32),
        lookup_len=jnp.asarray(lookup["lookup_len"].numpy(), jnp.int32))
    np.testing.assert_array_equal(toks, vanilla)
    np.testing.assert_array_equal(count, vcount)
    np.testing.assert_array_equal(toks, np.asarray(jt))
    np.testing.assert_array_equal(count, np.asarray(jn))
    assert stats["verify_steps"] < 16 and stats["batched_rows"] == 2


def test_spec_on_an_allocated_batch_raises(tiny):
    """Speculative decode needs a pool in row order, as in the JAX package."""
    embeds, length = _rows(tiny, 40, [37, 20], seed=95)
    with pytest.raises(ValueError, match="row-ordered"):
        generate_paged(tiny["params"], tiny["cfg"], torch.from_numpy(embeds),
                       torch.from_numpy(length), max_new_tokens=4, page_size=8, num_pages=14,
                       max_pages_per_seq=7, spec_tokens=2)


# ---------------------------------------------------------------------------
# LongVA and the pipeline
# ---------------------------------------------------------------------------


def _longvas():
    dcfg = jconfig.DecoderConfig.tiny()
    jm = JLongVA.init_random(jax.random.key(0), jconfig.ViTConfig.tiny(
        projection_dim=dcfg.hidden_size), dcfg, dtype=jnp.float32)
    m = LongVA(vit_params=convert.vit_params(_np(jm.vit_params)),
               proj_params=convert.to_torch(_np(jm.proj_params)),
               dec_params=convert.to_torch(_np(jm.dec_params)),
               vit_cfg=config.ViTConfig(**dataclasses.asdict(jm.vit_cfg)),
               dec_cfg=config.DecoderConfig(**dataclasses.asdict(dcfg)),
               tokenizer=ByteTokenizer(), generator=torch.Generator().manual_seed(0))
    return jm, m


@pytest.mark.parametrize("kv_int8", [False, True], ids=["pages", "int8_pages"])
def test_longva_batch_matches_jax(no_launches, kv_int8):
    """Three ragged multimodal prompts in one call: the same strings as the
    JAX package's; the rows after the first are spliced at their turn."""
    jm, m = _longvas()
    jm.kv_int8 = m.kv_int8 = kv_int8
    prompts = ["<|im_start|>user\n<image>\nDescribe.<|im_end|>\n",
               "<|im_start|>user\n<image>\nWhat is here, and why?<|im_end|>\n",
               "<|im_start|>user\nNo picture.<|im_end|>\n"]
    feats = [_rand(100, 150, 128, scale=0.5), _rand(101, 20, 128, scale=0.5)]
    jembs = [[jnp.asarray(feats[0])], [jnp.asarray(feats[1])], None]
    pembs = [[torch.from_numpy(feats[0])], [torch.from_numpy(feats[1])], None]
    ref = jm.generate_with_image_embedding_batch(prompts, jembs, max_new_tokens=8,
                                                 temperature=0.0)
    splices = []
    splice = m.splice_prompt
    m.splice_prompt = lambda *a: splices.append(1) or splice(*a)
    made = []
    orig = port_longva.generate_paged

    def recording(params, cfg, rows, *a, **kw):
        made.append([callable(r) for r in rows])
        return orig(params, cfg, rows, *a, **kw)

    port_longva.generate_paged = recording
    try:
        out = m.generate_with_image_embedding_batch(prompts, pembs, max_new_tokens=8,
                                                    temperature=0.0)
    finally:
        port_longva.generate_paged = orig
    assert out == ref and any(out)
    assert made == [[False, True, True]] and len(splices) == 3
    assert m.gen_stats["batched_rows"] == 3
    assert m._splice_length(prompts[1], pembs[1]) == jm._splice_length(prompts[1], jembs[1])


def _pipelines(caption_batch):
    """Both pipelines on the same weights, caption_batch chunks per caption
    call; settings under which nothing draws random numbers."""
    from streamchat_tpu.models.embedder import TextEmbedder as JEmbedder
    from streamchat_tpu.pipeline.runner import StreamChatPipeline as JPipeline
    from streamchat_tpu_torch.models.embedder import TextEmbedder
    from streamchat_tpu_torch.pipeline import runner

    jm, m = _longvas()
    k2, k3 = jax.random.split(jax.random.key(1))
    jtree = JEmbedder.init_random(k2, jconfig.BertConfig.tiny())
    jbank = JEmbedder.init_random(
        k3, dataclasses.replace(jconfig.BertConfig.tiny(), pooling="mean"))
    jcfg = jconfig.PipelineConfig(
        memory=jconfig.MemoryConfig(chunk_size=3, num_clusters=5, interval=10,
                                    short_window=5, remember_window=5),
        sampling=jconfig.SamplingConfig(temperature=0.0, caption_temperature=0.0,
                                        max_answer_tokens=6, max_caption_tokens=6,
                                        max_summary_tokens=6, caption_batch=caption_batch))
    jp = JPipeline(jm, jtree, jbank, jcfg)

    def emb(j):
        return TextEmbedder(convert.to_torch(_np(j.params)),
                            config.BertConfig(**dataclasses.asdict(j.cfg)), ByteTokenizer(),
                            max_length=j.max_length)

    pcfg = config.PipelineConfig(
        memory=config.MemoryConfig(**dataclasses.asdict(jcfg.memory)),
        sampling=config.SamplingConfig(**dataclasses.asdict(jcfg.sampling)))
    return jp, runner.StreamChatPipeline(m, emb(jtree), emb(jbank), pcfg)


def _recording(fn, sink):
    def wrapped(*args, **kwargs):
        toks, count = fn(*args, **kwargs)[:2]
        toks, count = np.asarray(toks), np.asarray(count)
        sink.append([toks[r, : int(count[r])].tolist() for r in range(toks.shape[0])])
        return toks, count
    return wrapped


def test_process_video_caption_batch_matches_jax(tmp_path, monkeypatch):
    """caption_batch 2: chunks are captioned two to a call, the captions,
    tree texts and answers equal the JAX pipeline's, and the caption phase
    times the batched calls."""
    jp, pp = _pipelines(caption_batch=2)
    jcalls, pcalls = [], []
    monkeypatch.setattr(j_generate_paged, "generate_paged_fetch",
                        _recording(j_generate_paged.generate_paged_fetch, jcalls))
    monkeypatch.setattr(port_longva, "generate_paged",
                        _recording(port_longva.generate_paged, pcalls))
    breakpoints = [{"question": "What do I see?", "answer": "a room", "time": 2},
                   {"question": "What changed?", "answer": "nothing", "time": 5}]
    jres = jp.process_video(
        SyntheticVideoReader(total_frames=150, frame_rate=30, height=56, width=56),
        breakpoints, JBank(str(tmp_path / "j.json"), lambda t: jp.bank_embedder.embed(t)),
        user_name="User")
    pres = pp.process_video(
        SyntheticVideoReader(total_frames=150, frame_rate=30, height=56, width=56),
        breakpoints, MemoryBank(str(tmp_path / "p.json"), pp.bank_embed), user_name="User")
    assert pcalls == jcalls and sum(len(c) == 2 for c in pcalls) >= 2
    assert [p["predict"] for p in pres] == [j["predict"] for j in jres]
    assert [n.text for n in pp.last_tree.roots] == [n.text for n in jp.last_tree.roots]
    # Every call but the answers and the tree's summaries is a caption call.
    assert pp.last_phase_counts["caption"] == (
        len(pcalls) - len(breakpoints) - pp.last_phase_counts.get("summarize", 0))
