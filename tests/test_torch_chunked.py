"""The port's chunked long-prompt prefill against the JAX package's, on the CPU.

Inputs are numpy arrays made from a seed and handed to both packages, at
tiny geometry in float32. Tolerances:
- K5's twin (`flash_attention_partial_plain`) against the JAX Pallas kernel
  in interpret mode (blocks of 128 / 256): acc and l to atol 1e-4 (sums of
  up to 384 exponentials, in another order), m to atol 1e-5; a row that
  sees no key gives m = -1e30, l = 0 and acc = 0 in both, exactly.
- `prefill_chunked` (chunk 128, 384 tokens): logits and bf16-free cache
  values to atol 1e-4; into an `Int8KVCache`, the int8 values equal but at
  rounding ties and the scales to rtol 1e-5 (one f32 ulp), both to 1e-3
  downstream of a tie (`assert_int8_cache_matches_up_to_ties`). A one-pass prefill quantized
  afterwards (the port before chunked prefill) misses both bounds.
- `generate_paged` with `CHUNKED_PREFILL_THRESHOLD` lowered in both
  packages: greedy tokens identical.
On a CPU tensor no wrapper may count a kernel launch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import streamchat_tpu.models.generate as j_generate
from streamchat_tpu import config as jconfig
from streamchat_tpu.models import decoder as jdec
from streamchat_tpu.models import paged_kv as jpkv
from streamchat_tpu.models.generate_paged import generate_paged_fetch
from streamchat_tpu.ops.attention import flash_attention_partial as j_flash_partial
from streamchat_tpu.ops.quant import quantize_decoder_params
from streamchat_tpu_torch import config, convert, kernels
from streamchat_tpu_torch.models import decoder, generate, paged_kv
from streamchat_tpu_torch.models.generate_paged import generate_paged
from streamchat_tpu_torch.ops import attention

LOGITS_ATOL = 1e-4
# The f32 K/V of XLA's and torch's matmuls differ in their last bits (~3e-6
# relative after the tiny decoder's layers), so a code whose x / scale lies
# that close to a half-integer may round either way, depending on the host's
# CPU path. Such ties are rare: at most MAX_TIE_SHARE of the codes. A code
# that rounded apart moves what later tokens of its row attend to by one
# step, so their K/V in later layers differ by more (5e-5 relative seen):
# there the ties and the scales are held to DOWNSTREAM_RTOL.
TIE_RTOL = 1e-5
SCALE_RTOL = 1e-5
DOWNSTREAM_RTOL = 1e-3
MAX_TIE_SHARE = 2e-4


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def record_prequant_ratios(monkeypatch, cache):
    """Patch `decoder._write_kv` so that each int8 write of `cache` also keeps
    the port's pre-rounding x / scale per code -> {"k", "v"}: float64 arrays
    shaped as cache.k / cache.v (NaN where nothing was written). The first
    write of a position is kept: the re-run window of `prefill_chunked`
    writes again and then restores the prefill's codes."""
    ratios = {n: torch.full(getattr(cache, n).shape, float("nan"), dtype=torch.float64)
              for n in ("k", "v")}
    write = decoder._write_kv

    def recording(c, i, start, k, v, rows=slice(None)):
        write(c, i, start, k, v, rows)
        if c is not cache:
            return
        s = k.shape[2]
        for name, x in (("k", k), ("v", v)):
            scale = getattr(c, f"{name}_s")[i, rows, :, start:start + s]
            r = torch.div(x.float(), scale[..., None]).double()
            dst = ratios[name][i, rows, :, start:start + s]
            ratios[name][i, rows, :, start:start + s] = torch.where(dst.isnan(), r, dst)

    monkeypatch.setattr(decoder, "_write_kv", recording)
    return ratios


def assert_int8_cache_matches_up_to_ties(cache, jcache, ratios):
    """The port's int8 codes equal JAX's, except codes off by exactly one
    where the port's pre-rounding x / scale (`ratios`, from
    `record_prequant_ratios`) lies within TIE_RTOL of a half-integer and the
    two codes are its two neighbours; such ties are at most MAX_TIE_SHARE of
    the codes. The scales agree to SCALE_RTOL (one f32 ulp). Downstream of a
    tie (its row, later layers, positions at and after it) both bounds are
    DOWNSTREAM_RTOL."""
    codes = {n: (getattr(cache, n).numpy().astype(np.int64),
                 np.asarray(getattr(jcache, n)).astype(np.int64)) for n in ("k", "v")}
    n_layers, b, _, s = cache.k_s.shape
    downstream = np.zeros((n_layers, b, 1, s), bool)
    for got, want in codes.values():
        for layer, row, _, pos, _ in np.argwhere(got != want):
            downstream[layer + 1:, row, 0, pos:] = True
    n_off = 0
    for name, (got, want) in codes.items():
        off = got != want
        n_off += off.sum()
        r = ratios[name].numpy()[off]
        assert not np.isnan(r).any(), "a mismatching code was never written"
        half = np.floor(r) + 0.5
        rtol = np.where(np.broadcast_to(downstream[..., None], off.shape)[off],
                        DOWNSTREAM_RTOL, TIE_RTOL)
        at_tie = np.abs(r - half) <= rtol * np.abs(half)
        assert at_tie.all(), f"{name}: codes off away from a rounding tie: x/scale {r[~at_tie]}"
        np.testing.assert_array_equal(np.minimum(got[off], want[off]), np.floor(r))
        np.testing.assert_array_equal(np.abs(got[off] - want[off]), 1)
    assert n_off <= MAX_TIE_SHARE * 2 * cache.k.numel(), f"{n_off} ties"
    for name in ("k_s", "v_s"):
        got, want = getattr(cache, name).numpy(), np.asarray(getattr(jcache, name))
        mask = np.broadcast_to(downstream, got.shape)
        np.testing.assert_allclose(got[~mask], want[~mask], rtol=SCALE_RTOL, atol=0)
        np.testing.assert_allclose(got[mask], want[mask], rtol=DOWNSTREAM_RTOL, atol=0)


@pytest.fixture
def no_launches():
    kernels.reset_launch_counts()
    yield
    assert all(v == 0 for v in kernels.launch_counts().values()), \
        "a CPU tensor must run the plain twin, never count a launch"


@pytest.mark.parametrize("q_off,k_off,lengths,causal,block,heads,sq", [
    (0, 0, None, True, 128, (4, 2), 256),
    (256, 0, [300, 384], True, 128, (4, 2), 256),    # a later chunk against the cache
    (0, 128, [384, 200], True, 256, (4, 2), 256),    # q_offset < k_offset: rows 0-127 see no key
    (128, 0, [384, 256], False, 256, (4, 2), 256),
    (37, 5, [291], True, 128, (7, 1), 128),          # offsets off the tile grid, 7 heads a kv head
], ids=["aligned", "chunk-vs-cache", "fully-masked-rows", "non-causal", "odd-offsets-gqa7"])
def test_partial_twin_matches_jax_kernel(no_launches, q_off, k_off, lengths, causal, block,
                                         heads, sq):
    b = 2 if lengths is None else len(lengths)
    q = _rand(1, b, heads[0], sq, 32)
    k, v = _rand(2, b, heads[1], 384, 32), _rand(3, b, heads[1], 384, 32)
    kl = None if lengths is None else np.asarray(lengths, np.int32)
    if kl is not None:                    # large garbage past each row's length
        for row, n in enumerate(lengths):
            v[row, :, n:] = 1e4
    ref = j_flash_partial(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(q_off),
                          jnp.int32(k_off), None if kl is None else jnp.asarray(kl),
                          causal=causal, block_q=block, block_k=block, interpret=True)
    out = attention.flash_attention_partial(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), q_off, k_off,
        None if kl is None else torch.from_numpy(kl), causal=causal)
    for got, want, atol in zip(out, ref, (1e-4, 1e-5, 1e-4)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)
    dead = np.asarray(ref[2]) == 0
    assert dead.any() == (k_off > q_off)
    if dead.any():
        assert (out[1].numpy()[dead] == -1e30).all() and (out[2].numpy()[dead] == 0).all()
        assert (out[0].numpy()[dead] == 0).all()


def test_partial_twin_ignores_nan_past_the_length(no_launches):
    """NaN in V past kv_length must not reach acc (0 * NaN survives p == 0)."""
    q, k, v = _rand(4, 1, 4, 128, 32), _rand(5, 1, 2, 256, 32), _rand(6, 1, 2, 256, 32)
    kl = torch.tensor([200], dtype=torch.int32)
    clean = attention.flash_attention_partial(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 128, 0, kl)
    v[:, :, 200:] = np.nan
    dirty = attention.flash_attention_partial(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 128, 0, kl)
    for a, b in zip(clean, dirty):
        assert torch.isfinite(b).all()
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.fixture(scope="module")
def tiny():
    """Tiny f32 decoder weights in both packages."""
    jcfg = jconfig.DecoderConfig.tiny()
    jparams = jdec.init(jax.random.key(0), jcfg, jnp.float32)
    return dict(jcfg=jcfg, jparams=jparams,
                cfg=config.DecoderConfig(**dataclasses.asdict(jcfg)),
                params=convert.to_torch(jax.tree.map(np.asarray, jparams)))


def _both_chunked(tiny, int8, s=384, valid=370, seed=5, monkeypatch=None):
    """Both packages' chunked prefill; with `monkeypatch` the port's
    pre-rounding ratios of an int8 cache are recorded (4th item, else None)."""
    embeds, length = _rand(seed, 1, s, tiny["jcfg"].hidden_size, scale=0.5), np.asarray(
        [valid], np.int32)
    jcache = (jdec.Int8KVCache.create(tiny["jcfg"], 1, s) if int8 else
              jdec.KVCache.create(tiny["jcfg"], 1, s, dtype=jnp.float32))
    jlogits, jcache = jdec.prefill_chunked(tiny["jparams"], tiny["jcfg"], jnp.asarray(embeds),
                                           jcache, jnp.asarray(length), chunk=128)
    cache = (decoder.Int8KVCache.create(tiny["cfg"], 1, s) if int8 else
             decoder.KVCache.create(tiny["cfg"], 1, s, dtype=torch.float32))
    ratios = record_prequant_ratios(monkeypatch, cache) if monkeypatch else None
    logits, cache = decoder.prefill_chunked(tiny["params"], tiny["cfg"],
                                            torch.from_numpy(embeds), cache,
                                            torch.from_numpy(length), chunk=128)
    return (np.asarray(jlogits), jcache), (logits.numpy(), cache), (embeds, length), ratios


def test_prefill_chunked_matches_jax(no_launches, tiny):
    """Three 128-token chunks into a dense f32 KVCache."""
    (jlogits, jcache), (logits, cache), _, _ = _both_chunked(tiny, int8=False)
    np.testing.assert_allclose(logits, jlogits, atol=LOGITS_ATOL, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(cache, name).numpy()[..., :370, :],
                                   np.asarray(getattr(jcache, name))[..., :370, :],
                                   atol=LOGITS_ATOL, rtol=0)
    assert int(cache.length[0]) == int(jcache.length[0]) == 370


def test_prefill_chunked_int8_matches_jax_and_one_pass_does_not(no_launches, tiny,
                                                                monkeypatch):
    """Into an Int8KVCache: the int8 values equal JAX's but at rounding ties,
    the scales within one ulp (`assert_int8_cache_matches_up_to_ties`), the
    logits within LOGITS_ATOL; the int8 pool paged from it is exactly its
    layout shuffle, with JAX's pool's scales. A one-pass f32 prefill
    quantized when paged (what the port did before) misses the same
    bounds."""
    (jlogits, jcache), (logits, cache), (embeds, length), ratios = _both_chunked(
        tiny, int8=True, monkeypatch=monkeypatch)
    np.testing.assert_allclose(logits, jlogits, atol=LOGITS_ATOL, rtol=0)
    assert cache.k.dtype == torch.int8 and cache.k_s.dtype == torch.float32
    assert_int8_cache_matches_up_to_ties(cache, jcache, ratios)
    jpool = jpkv.from_contiguous_int8(jcache, 3, 3, page_size=128)
    pool = paged_kv.from_contiguous_int8(cache, 3, 3, page_size=128)
    n_layers, _, hkv, _, dh = cache.k.shape
    for pages, dense in ((pool.k_pages, cache.k), (pool.v_pages, cache.v),
                         (pool.k_scale, cache.k_s[..., None]),
                         (pool.v_scale, cache.v_s[..., None])):
        paged_from = dense[:, 0].reshape(n_layers, hkv, 3, 128, -1).transpose(1, 2)
        torch.testing.assert_close(pages, paged_from.reshape(pages.shape), atol=0, rtol=0)
    np.testing.assert_allclose(pool.v_scale.numpy(), np.asarray(jpool.v_scale), rtol=1e-5,
                               atol=0)

    one_pass = decoder.KVCache.create(tiny["cfg"], 1, 384, dtype=torch.float32)
    op_logits, one_pass = decoder.prefill(tiny["params"], tiny["cfg"], torch.from_numpy(embeds),
                                          one_pass, torch.from_numpy(length))
    op_pool = paged_kv.from_contiguous_int8(one_pass, 3, 3, page_size=128)
    assert np.abs(op_logits.numpy() - jlogits).max() > LOGITS_ATOL
    assert (op_pool.k_pages.numpy() != np.asarray(jpool.k_pages)).sum() > 100


def test_int8_cache_created_with_unit_scales(tiny):
    c = decoder.Int8KVCache.create(tiny["cfg"], 1, 256)
    j = jdec.Int8KVCache.create(tiny["jcfg"], 1, 256)
    for name in ("k", "v", "k_s", "v_s", "length"):
        got, want = getattr(c, name).numpy(), np.asarray(getattr(j, name))
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_prefill_dispatch_follows_the_threshold(monkeypatch, tiny):
    """`_prefill_inline` prefills in one pass up to the threshold and in
    chunks of threshold // 2 beyond it."""
    calls = []
    monkeypatch.setattr(decoder, "prefill_chunked",
                        lambda *a, **kw: calls.append(("chunked", kw["chunk"])))
    monkeypatch.setattr(decoder, "prefill", lambda *a, **kw: calls.append(("one", None)))
    monkeypatch.setattr(generate, "CHUNKED_PREFILL_THRESHOLD", 256)
    for s in (256, 384):
        generate._prefill_inline(None, None, torch.zeros(1, s, 8), None, None)
    assert calls == [("one", None), ("chunked", 128)]


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


@pytest.mark.parametrize("bits", [None, 8], ids=["f32", "int8"])
@pytest.mark.parametrize("kv_int8", [False, True], ids=["pages", "int8_pages"])
def test_generate_paged_chunked_token_exact(no_launches, low_threshold, tiny, kv_int8, bits):
    """A 300-token prompt over the lowered threshold: aligned to lcm(16, 128)
    = 384 and prefilled in three chunks of 128 (an Int8KVCache for int8
    pages), then 12 greedy tokens; identical to the JAX package's."""
    jparams, params = tiny["jparams"], tiny["params"]
    if bits:
        jparams = quantize_decoder_params(jparams, bits=bits)
        params = convert.to_torch(jax.tree.map(np.asarray, jparams))
    embeds, length = _rand(11, 1, 300, tiny["jcfg"].hidden_size, scale=0.5), np.asarray(
        [290], np.int32)
    ref_toks, ref_count = generate_paged_fetch(
        jparams, tiny["jcfg"], jnp.asarray(embeds), jnp.asarray(length), jax.random.key(2),
        max_new_tokens=12, temperature=0.0, page_size=16, kv_int8=kv_int8)
    stats = {}
    toks, count = generate_paged(params, tiny["cfg"], torch.from_numpy(embeds),
                                 torch.from_numpy(length), max_new_tokens=12,
                                 temperature=0.0, page_size=16, kv_int8=kv_int8, stats=stats)
    np.testing.assert_array_equal(toks, np.asarray(ref_toks))
    np.testing.assert_array_equal(count, np.asarray(ref_count))
    assert stats["prompt_tokens"] == 384
