"""The port's H2O KV eviction against the JAX package's, on the CPU.

Inputs are numpy arrays made from a seed and handed to both packages, at
tiny geometry in float32. Tolerances:
- `compress_kv`: kept slots and K/V exactly equal without a merge (the
  kept keys encode their slot, so equal K is an equal kept set), merged
  K/V within 1e-6 (sums of a few products in another order); the cases of
  `tests/test_kv_compress.py` plus planted ties (+inf sinks, -inf recent
  slots and padding, many equal masses, zeros), where `torch.topk`'s
  order among ties would differ from `lax.top_k`'s lower-index-first.
- `attention_mass`, `compress_cache`, the mass-returning gather and
  `compress_paged`: 1e-6 (masses, logits 1e-4); tables, lengths and
  `next_free` exactly.
- `generate_paged` with hh_size > 0 (page_size 16, hh 12 / recent 16 /
  sink 4, as `tests/test_paged_kv.py`): greedy tokens identical with a
  prompt over the pool and with in-loop compression firing twice (f32,
  and bf16 weights, prompt and pages); `LongVA` under
  `kv_budget_tokens`: identical text and tokens.
- The loop's step forms (collect, K4, K8; `StepGraph`s, eager here):
  sampled tokens equal to a copy of the eager loop they replaced, every
  buffer at one address across compressions, and `compress_paged_` equal
  to the functional form it replaced, bit for bit, every tensor in place.
On a CPU tensor no wrapper may count a kernel launch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import streamchat_tpu.models.generate_paged as j_generate_paged
from streamchat_tpu import config as jconfig
from streamchat_tpu.models import decoder as jdec
from streamchat_tpu.models import paged_kv as jpkv
from streamchat_tpu.models.longva import LongVA as JLongVA
from streamchat_tpu.ops import kv_compress as jkv
from streamchat_tpu_torch import config, convert, kernels
from streamchat_tpu_torch.models import decoder, paged_kv, step_graph
from streamchat_tpu_torch.models import generate_paged as port_generate_paged
from streamchat_tpu_torch.models import longva as port_longva
from streamchat_tpu_torch.models.generate_paged import generate_paged
from streamchat_tpu_torch.models.longva import LongVA
from streamchat_tpu_torch.models.tokenizer import ByteTokenizer
from streamchat_tpu_torch.ops import kv_compress, sampling

H2O = dict(hh_size=12, recent_size=16, sink_size=4)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these tiny tensors: the suite runs a worker
    per core, and torch's thread pools then contend (a step took 2.5x as
    long with the default eight)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# ---------------------------------------------------------------------------
# compress_kv
# ---------------------------------------------------------------------------


def _ties(h, l):
    """Masses drawn from {0, 1, 2} (most slots tie with many others)."""
    return np.random.default_rng(5).integers(0, 3, (h, l)).astype(np.float32)


# (heads, slots, length, hh, recent, sink, scores)
COMPRESS_CASES = {
    "heavy_hitters": (2, 16, 16, 2, 4, 0, lambda h, l: _rand(4, h, l) ** 2),
    "sinks": (2, 16, 16, 1, 4, 2, lambda h, l: _rand(6, h, l) ** 2),
    "identity_c_ge_slots": (1, 8, 5, 4, 8, 0, lambda h, l: np.ones((h, l), np.float32)),
    "runtime_length_below_capacity": (2, 64, 10, 8, 16, 4,
                                      lambda h, l: np.ones((h, l), np.float32)),
    "planted_ties": (3, 64, 53, 9, 8, 4, _ties),
}


@pytest.mark.parametrize("merge", [None, "avg", "weighted"])
@pytest.mark.parametrize("case", sorted(COMPRESS_CASES))
def test_compress_kv_matches_jax(no_launches, case, merge):
    h, l, length, hh, recent, sink, scores = COMPRESS_CASES[case]
    k, v = _rand(1, h, l, 8), _rand(2, h, l, 8)
    k[:, :, 0] = np.arange(l)                      # each key names its slot
    score = scores(h, l)
    kw = dict(hh_size=hh, recent_size=recent, sink_size=sink, merge=merge)
    ref = jkv.compress_kv(jnp.asarray(k), jnp.asarray(v), jnp.asarray(score),
                          jnp.asarray(length, jnp.int32), **kw)
    got = kv_compress.compress_kv(_t(k), _t(v), _t(score), length, **kw)
    assert int(got[3]) == int(ref[3]) == min(length, sink + hh + recent)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    if merge is None:
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    else:
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-6, rtol=0)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-6, rtol=0)
    if case == "planted_ties":
        assert (got[0][:, :sink, 0] == torch.arange(sink)).all() or merge is not None


def test_update_hh_score_and_attention_mass(no_launches):
    probs = _rand(1, 2, 3, 8) ** 2
    a = kv_compress.update_hh_score(None, _t(probs))
    np.testing.assert_allclose(a.numpy(), np.asarray(jkv.update_hh_score(None, probs)),
                               atol=1e-6)
    b = kv_compress.update_hh_score(a, _t(probs))
    np.testing.assert_allclose(b.numpy(), np.asarray(jkv.update_hh_score(a.numpy(), probs)),
                               atol=1e-6)
    q, k = _rand(2, 2, 4, 8), _rand(3, 2, 16, 8)
    ref = jkv.attention_mass(jnp.asarray(q), jnp.asarray(k), jnp.asarray(10))
    got = kv_compress.attention_mass(_t(q), _t(k), 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.sum(1).numpy(), 4.0, rtol=1e-5)


def test_compress_cache_matches_jax(no_launches, tiny):
    jcfg, cfg = tiny["jcfg"], tiny["cfg"]
    s, lmax = 48, 64
    embeds = _rand(7, 1, s, cfg.hidden_size)
    jcache = jdec.KVCache.create(jcfg, 1, lmax, dtype=jnp.float32)
    _, jcache = jdec.prefill(tiny["jparams"], jcfg, jnp.asarray(embeds), jcache,
                             jnp.array([s], jnp.int32))
    cache = decoder.KVCache.create(cfg, 1, lmax, dtype=torch.float32)
    _, cache = decoder.prefill(tiny["params"], cfg, _t(embeds), cache,
                               torch.tensor([s], dtype=torch.int32))
    probe = _rand(8, cfg.num_layers, cfg.num_heads, 4, cfg.head_dim)
    ref = jkv.compress_cache(jcache, jnp.asarray(probe), hh_size=8, recent_size=16, sink_size=4)
    got = kv_compress.compress_cache(cache, _t(probe), hh_size=8, recent_size=16, sink_size=4)
    assert int(got.length[0]) == int(ref.length[0]) == 28
    np.testing.assert_allclose(got.k.numpy(), np.asarray(ref.k), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.v.numpy(), np.asarray(ref.v), atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# The paged pieces: the mass-returning gather, the step, compress_paged
# ---------------------------------------------------------------------------


def test_gather_attention_returns_jax_mass(no_launches):
    """B = 2 rows through a table with an unmapped slot (read as page 0 and
    masked by the length): output and mass [B, Hkv, maxp * ps]."""
    q = _rand(1, 2, 4, 1, 16)
    kp, vp = _rand(2, 6, 2, 8, 16), _rand(3, 6, 2, 8, 16)
    table = np.asarray([[3, 0, 5], [1, 2, -1]], np.int32)
    length = np.asarray([21, 13], np.int32)
    ref_o, ref_m = jpkv.paged_decode_attention(*(jnp.asarray(a) for a in (q, kp, vp, table,
                                                                          length)),
                                               return_mass=True)
    o, m = paged_kv.paged_decode_attention(*(_t(a) for a in (q, kp, vp, table, length)),
                                           return_mass=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o), atol=1e-6, rtol=0)
    np.testing.assert_allclose(m.numpy(), np.asarray(ref_m), atol=1e-6, rtol=0)
    np.testing.assert_allclose(m.sum(-1).numpy(), 2.0, rtol=1e-5)   # g = 2 per kv head


def _paged_pair(tiny, s, num_pages, maxp, ps=16):
    """The same prompt prefilled and paged in both packages."""
    jcfg, cfg = tiny["jcfg"], tiny["cfg"]
    lmax = -(-s // ps) * ps
    embeds = _rand(9, 1, lmax, cfg.hidden_size)
    jcache = jdec.KVCache.create(jcfg, 1, lmax, dtype=jnp.float32)
    jlogits, jcache = jdec.prefill(tiny["jparams"], jcfg, jnp.asarray(embeds), jcache,
                                   jnp.array([s], jnp.int32))
    cache = decoder.KVCache.create(cfg, 1, lmax, dtype=torch.float32)
    logits, cache = decoder.prefill(tiny["params"], cfg, _t(embeds), cache,
                                    torch.tensor([s], dtype=torch.int32))
    return (jpkv.from_contiguous(jcache, num_pages, maxp, ps), jlogits,
            paged_kv.from_contiguous(cache, num_pages, maxp, ps), logits)


def test_collect_mass_step_at_positions_matches_jax(no_launches, tiny):
    """A step at a global position past the cache length, collecting mass."""
    jpaged, _, paged, _ = _paged_pair(tiny, 20, 4, 4)
    jpaged = jpkv.allocate_pages(jpaged, jnp.ones((1,), jnp.int32))
    paged = paged_kv.allocate_pages(paged, torch.ones(1, dtype=torch.int32))
    ref_logits, jpaged, ref_mass = jpkv.decode_step_paged(
        tiny["jparams"], tiny["jcfg"], jnp.asarray([17], jnp.int32), jpaged,
        positions=jnp.asarray([57], jnp.int32), collect_mass=True)
    logits, paged, mass = paged_kv.decode_step_paged(
        tiny["params"], tiny["cfg"], torch.tensor([17]), paged,
        positions=torch.tensor([57], dtype=torch.int32), collect_mass=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=1e-4, rtol=0)
    np.testing.assert_allclose(mass.numpy(), np.asarray(ref_mass), atol=1e-6, rtol=0)
    assert mass.shape == (tiny["cfg"].num_layers, 1, tiny["cfg"].num_kv_heads, 64)
    np.testing.assert_allclose(paged.k_pages.numpy(), np.asarray(jpaged.k_pages), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("merge", [None, "weighted"])
def test_compress_paged_matches_jax(no_launches, merge):
    """The same pool in both packages: 2 layers, 3 pages of 16 slots mapped
    out of order, 44 tokens, compressed to 32 slots in pages [0, 2)."""
    kp, vp = _rand(15, 2, 4, 2, 16, 8), _rand(16, 2, 4, 2, 16, 8)
    table, length = np.asarray([[2, 0, 3, -1]], np.int32), np.asarray([44], np.int32)
    hh = np.abs(_rand(11, 2, 2, 64))
    ref, ref_hh = jpkv.compress_paged(
        jpkv.PagedKVCache(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
                          jnp.asarray(length), jnp.asarray(4, jnp.int32)),
        jnp.asarray(hh), merge=merge, **H2O)
    got = paged_kv.PagedKVCache(_t(kp.copy()), _t(vp.copy()), _t(table), _t(length),
                                torch.tensor(4, dtype=torch.int32))
    got_hh = _t(hh.copy())
    paged_kv.compress_paged_(got, got_hh, merge=merge, **H2O)
    np.testing.assert_array_equal(got.page_table.numpy(), np.asarray(ref.page_table))
    assert int(got.length[0]) == int(ref.length[0]) == 32
    assert int(got.next_free) == int(ref.next_free) == 2
    np.testing.assert_array_equal(got_hh.numpy(), np.asarray(ref_hh))
    atol = 0 if merge is None else 1e-6
    np.testing.assert_allclose(got.k_pages[:, :2].numpy(), np.asarray(ref.k_pages[:, :2]),
                               atol=atol, rtol=0)
    np.testing.assert_allclose(got.v_pages[:, :2].numpy(), np.asarray(ref.v_pages[:, :2]),
                               atol=atol, rtol=0)


def _old_compress_paged(cache, hh_score, *, hh_size, recent_size, sink_size=4, merge=None):
    """`paged_kv.compress_paged` as it was: the kept slots written into the
    pool's first pages, a new table, length, `next_free` and scores."""
    n_layers, _, hkv, ps, dh = cache.k_pages.shape
    maxp = cache.page_table.shape[1]
    cap, c = maxp * ps, sink_size + hh_size + recent_size
    table = cache.page_table[0].clamp_min(0).long()

    def gather(pages):
        return pages[:, table].transpose(1, 2).reshape(n_layers * hkv, cap, dh)

    k2, v2, s2, kept = kv_compress.compress_kv(
        gather(cache.k_pages), gather(cache.v_pages), hh_score.reshape(n_layers * hkv, cap),
        cache.length[0], hh_size=hh_size, recent_size=recent_size, sink_size=sink_size,
        merge=merge)
    c_pages = -(-c // ps)

    def repage(x, pages):
        out = torch.zeros(n_layers, hkv, c_pages * ps, dh, dtype=pages.dtype)
        out[:, :, :c] = x.reshape(n_layers, hkv, c, dh)
        pages[:, :c_pages] = out.reshape(n_layers, hkv, c_pages, ps, dh).transpose(1, 2)

    repage(k2, cache.k_pages)
    repage(v2, cache.v_pages)
    slots = torch.arange(maxp)
    new_hh = torch.zeros(n_layers, hkv, cap, dtype=hh_score.dtype)
    new_hh[:, :, :c] = s2.reshape(n_layers, hkv, c)
    return paged_kv.PagedKVCache(
        k_pages=cache.k_pages, v_pages=cache.v_pages,
        page_table=torch.where(slots < c_pages, slots, -1)[None].to(torch.int32),
        length=kept.reshape(1).to(torch.int32),
        next_free=torch.tensor(c_pages, dtype=torch.int32)), new_hh


@pytest.mark.parametrize("merge", [None, "weighted"])
@pytest.mark.parametrize("length", [44, 23], ids=["evicts", "fits"])
def test_compress_paged_in_place_equals_the_old_output_and_keeps_addresses(no_launches, merge,
                                                                           length):
    """`compress_paged_` against the functional form it replaced, on one pool
    (3 pages of 16 slots mapped out of order, garbage in the pages it leaves
    alone): pages [0, c_pages), table, length, `next_free` and scores equal,
    and every tensor at its address."""
    kp, vp = _rand(15, 2, 4, 2, 16, 8), _rand(16, 2, 4, 2, 16, 8)
    table = np.asarray([[2, 0, 3, -1]], np.int32)
    hh = np.abs(_rand(11, 2, 2, 64))

    def pool():
        return paged_kv.PagedKVCache(_t(kp.copy()), _t(vp.copy()), _t(table.copy()),
                                     torch.tensor([length], dtype=torch.int32),
                                     torch.tensor(4, dtype=torch.int32))

    ref, ref_hh = _old_compress_paged(pool(), _t(hh.copy()), merge=merge, **H2O)
    got, got_hh = pool(), _t(hh.copy())
    before = [t.data_ptr() for t in (*step_graph.cache_tensors(got), got_hh)]
    paged_kv.compress_paged_(got, got_hh, merge=merge, **H2O)
    assert [t.data_ptr() for t in (*step_graph.cache_tensors(got), got_hh)] == before
    for name in ("page_table", "length", "next_free"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    assert torch.equal(got_hh, ref_hh)
    assert torch.equal(got.k_pages[:, :2], ref.k_pages[:, :2])
    assert torch.equal(got.v_pages[:, :2], ref.v_pages[:, :2])


def _eager_decode_loop_h2o(params, cfg, cache, hh, logits, seq_length, generator, host, *,
                           max_new_tokens, temperature, top_p, eos_ids, hh_size, recent_size,
                           sink_size, merge, **_):
    """`generate_paged._decode_loop_h2o` as it was: sample, compress
    (functional), allocate (functional), one eager step."""
    num_pages, maxp, ps = cache.k_pages.shape[1], cache.page_table.shape[1], cache.page_size
    c = sink_size + hh_size + recent_size
    eos = torch.tensor(list(eos_ids))
    out = torch.full((1, max_new_tokens), cfg.pad_token_id, dtype=torch.int64)
    done = torch.zeros(1, dtype=torch.bool)
    pos = seq_length.to(torch.int32)
    length, next_free = host["length"], host["next_free"]
    step = compressions = 0
    in_order = True
    while step < max_new_tokens:
        tok = sampling.sample_token(logits, generator, temperature=temperature, top_p=top_p)
        tok = torch.where(done, torch.full_like(tok, cfg.pad_token_id), tok)
        done = done | torch.isin(tok, eos)
        out[:, step] = tok
        extra = -(-(length + 1) // ps) - -(-length // ps)
        if next_free + extra > num_pages or -(-(length + 1) // ps) > maxp:
            cache, hh = _old_compress_paged(cache, hh, hh_size=hh_size, recent_size=recent_size,
                                            sink_size=sink_size, merge=merge)
            length, next_free = min(length, c), -(-c // ps)
            compressions += 1
            in_order = True
        have = -(-length // ps)
        reachable = (have + min(num_pages - next_free, maxp - have)) * ps
        collect = length + max_new_tokens - step > reachable
        if length % ps == 0:
            cache, _ = paged_kv.allocate_pages_checked(cache, torch.ones(1, dtype=torch.int32))
            in_order = in_order and next_free == length // ps
            next_free += 1
        if collect:
            logits, cache, mass = paged_kv.decode_step_paged(params, cfg, tok, cache,
                                                             positions=pos, collect_mass=True)
            hh = hh + mass[:, 0]
        else:
            logits, cache = paged_kv.decode_step_paged(params, cfg, tok, cache, positions=pos,
                                                       sequential_pages=in_order)
        pos = pos + 1
        length += 1
        step += 1
        if bool(done.all()):
            break
    return out.numpy(), step, compressions


@pytest.mark.parametrize("sampled", [dict(temperature=1.0), dict(temperature=0.8, top_p=0.9)],
                         ids=["temperature", "top_p"])
@pytest.mark.parametrize("s,n,max_new,merge", [
    (20, 20, 48, None),            # compresses in the loop twice, then K4
    (20, 20, 48, "avg"),
    (32, 5, 20, None),             # K4, then K8 (a slot mapped past a padded page)
], ids=["in_loop", "in_loop_avg", "padded_prompt"])
def test_h2o_step_form_matches_the_eager_loop_sampled(no_launches, tiny, monkeypatch, s, n,
                                                      max_new, merge, sampled):
    embeds = _rand(18, 1, s, tiny["cfg"].hidden_size)
    args = (tiny["params"], tiny["cfg"], _t(embeds), torch.tensor([n], dtype=torch.int32))
    kw = dict(max_new_tokens=max_new, page_size=16, num_pages=3, max_pages_per_seq=3,
              merge=merge, **H2O, **sampled)
    stats = {}
    toks, count = generate_paged(*args, torch.Generator().manual_seed(3), stats=stats, **kw)
    monkeypatch.setattr(port_generate_paged, "_decode_loop_h2o", _eager_decode_loop_h2o)
    ref, ref_count = generate_paged(*args, torch.Generator().manual_seed(3), **kw)
    np.testing.assert_array_equal(toks, ref)
    np.testing.assert_array_equal(count, ref_count)
    assert stats["compressions_in_loop"] == (2 if s == 20 else 0)
    assert len(set(toks[0].tolist())) > 8                     # the draws vary


def test_h2o_step_keeps_its_buffers_across_compressions(no_launches, tiny, monkeypatch):
    """Every call of each step form (collect, then K4) reads and writes the
    same tensors, through two in-loop compressions: the pools, table,
    length, `next_free`, scores, position and loop state."""
    seen = {}
    call = step_graph.StepGraph.__call__

    def recording(self):
        call(self)
        seen.setdefault(id(self), []).append(tuple(t.data_ptr() for t in self.bound()))

    monkeypatch.setattr(step_graph.StepGraph, "__call__", recording)
    caches = []
    loop = port_generate_paged._decode_loop_h2o
    monkeypatch.setattr(port_generate_paged, "_decode_loop_h2o",
                        lambda p, c, cache, hh, *a, **kw: caches.append((cache, hh))
                        or loop(p, c, cache, hh, *a, **kw))
    stats = {}
    generate_paged(tiny["params"], tiny["cfg"], _t(_rand(12, 1, 20, tiny["cfg"].hidden_size)),
                   torch.tensor([20], dtype=torch.int32), max_new_tokens=48, page_size=16,
                   num_pages=3, max_pages_per_seq=3, stats=stats, **H2O)
    assert stats["compressions_in_loop"] == 2
    (collect, k4), ((cache, hh),) = seen.values(), caches
    assert len(collect) == 44 and len(k4) == 4
    assert len(set(collect)) == 1 and set(k4) == set(collect)
    assert {t.data_ptr() for t in (*step_graph.cache_tensors(cache), hh)} <= set(collect[0])


# ---------------------------------------------------------------------------
# generate_paged with hh_size > 0
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,max_new,merge,at_prefill,in_loop", [
    (60, 20, None, 1, 2),          # prompt over the 48-slot pool
    (20, 48, None, 0, 2),          # in-loop compression, twice
    (20, 48, "weighted", 0, 2),
], ids=["prompt_over_budget", "in_loop", "in_loop_weighted"])
def test_generate_paged_h2o_token_exact(no_launches, tiny, s, max_new, merge, at_prefill,
                                        in_loop):
    embeds = _rand(12, 1, s, tiny["cfg"].hidden_size)
    kw = dict(max_new_tokens=max_new, page_size=16, num_pages=3, max_pages_per_seq=3,
              temperature=0.0, merge=merge, **H2O)
    ref, ref_count = j_generate_paged.generate_paged(
        tiny["jparams"], tiny["jcfg"], jnp.asarray(embeds), jnp.array([s], jnp.int32),
        jax.random.key(0), **kw)
    stats = {}
    toks, count = generate_paged(tiny["params"], tiny["cfg"], _t(embeds),
                                 torch.tensor([s], dtype=torch.int32), stats=stats, **kw)
    np.testing.assert_array_equal(toks, np.asarray(ref))
    np.testing.assert_array_equal(count, np.asarray(ref_count))
    assert stats["compressions_at_prefill"] == at_prefill
    assert stats["compressions_in_loop"] == in_loop
    assert stats["decode_steps"] == max_new


def test_h2o_step_form_token_exact_with_jax_bf16(no_launches, tiny):
    """The step forms at bf16 (weights, prompt and pages, in both packages):
    greedy tokens identical through two in-loop compressions."""
    jparams = jdec.init(jax.random.key(0), tiny["jcfg"], jnp.bfloat16)
    params = jax.tree.map(lambda x: x.to(torch.bfloat16) if x.is_floating_point() else x,
                          convert.to_torch(_np(jparams)))
    embeds = _rand(12, 1, 20, tiny["cfg"].hidden_size)
    kw = dict(max_new_tokens=48, page_size=16, num_pages=3, max_pages_per_seq=3,
              temperature=0.0, **H2O)
    ref, ref_count = j_generate_paged.generate_paged(
        jparams, tiny["jcfg"], jnp.asarray(embeds, jnp.bfloat16), jnp.array([20], jnp.int32),
        jax.random.key(0), **kw)
    stats = {}
    toks, count = generate_paged(params, tiny["cfg"], _t(embeds).to(torch.bfloat16),
                                 torch.tensor([20], dtype=torch.int32), stats=stats, **kw)
    np.testing.assert_array_equal(toks, np.asarray(ref))
    np.testing.assert_array_equal(count, np.asarray(ref_count))
    assert stats["compressions_in_loop"] == 2


def test_h2o_step_after_compression_ropes_at_the_global_position(no_launches, tiny,
                                                                monkeypatch):
    """Each step's `positions` is the token's global position, not the
    (compressed) cache length: the port's recorded positions continue from
    the prompt length through every compression."""
    seen = []
    step = port_generate_paged.decode_step_paged

    def recorded(params, cfg, tok, cache, positions=None, **kw):
        seen.append((int(positions[0]), int(cache.length[0])))
        return step(params, cfg, tok, cache, positions=positions, **kw)

    monkeypatch.setattr(port_generate_paged, "decode_step_paged", recorded)
    generate_paged(tiny["params"], tiny["cfg"], _t(_rand(12, 1, 20, tiny["cfg"].hidden_size)),
                   torch.tensor([20], dtype=torch.int32), max_new_tokens=32, page_size=16,
                   num_pages=3, max_pages_per_seq=3, **H2O)
    assert [p for p, _ in seen] == list(range(20, 52))
    assert [n for _, n in seen] == list(range(20, 48)) + list(range(32, 36))


def _attention_calls(monkeypatch):
    """Records which attention each decode step's layer 0 ran: "gather"
    (collect_mass), "K4" (pool order) or "K8" (through the table)."""
    calls = []
    for name, label in (("paged_decode_attention", "gather"),
                        ("paged_decode_attention_seq", "K4"),
                        ("paged_decode_attention_table", "K8")):
        fn = getattr(paged_kv, name)

        def wrapped(*a, _fn=fn, _label=label, **kw):
            calls.append(_label)
            return _fn(*a, **kw)
        monkeypatch.setattr(paged_kv, name, wrapped)
    return calls


@pytest.mark.parametrize("s,n,max_new,expect", [
    (20, 20, 48, ["gather"] * 44 + ["K4"] * 4),     # compresses at 28 and 44, last
    (20, 20, 8, ["K4"] * 8),                        # fits: no compression at all
    (32, 5, 20, ["K4"] * 11 + ["K8"] * 9),          # slot 16 mapped past page 1
], ids=["after_last_compression", "no_compression", "padded_prompt"])
def test_h2o_steps_collect_mass_only_before_a_compression(no_launches, tiny, monkeypatch, s, n,
                                                          max_new, expect):
    """A step collects mass only while a later compression can still fire;
    the others run the page kernel a run without a budget would (K4 while
    the row's slots sit in pool order, K8 once the allocator has mapped a
    slot past a padded prompt's unused page). Tokens stay JAX's."""
    embeds = _rand(17, 1, s, tiny["cfg"].hidden_size)
    kw = dict(max_new_tokens=max_new, page_size=16, num_pages=3, max_pages_per_seq=3,
              temperature=0.0, **H2O)
    ref, _ = j_generate_paged.generate_paged(
        tiny["jparams"], tiny["jcfg"], jnp.asarray(embeds), jnp.array([n], jnp.int32),
        jax.random.key(0), **kw)
    calls = _attention_calls(monkeypatch)
    toks, _ = generate_paged(tiny["params"], tiny["cfg"], _t(embeds),
                             torch.tensor([n], dtype=torch.int32), **kw)
    np.testing.assert_array_equal(toks, np.asarray(ref))
    layers = tiny["cfg"].num_layers
    assert calls[::layers] == expect and len(calls) == layers * max_new


@pytest.mark.parametrize("refusal", ["batch", "kv_int8", "spec"])
def test_h2o_refusals_match_jax(tiny, refusal):
    b = 2 if refusal == "batch" else 1
    embeds = _rand(13, b, 20, tiny["cfg"].hidden_size)
    kw = dict(max_new_tokens=4, page_size=16, num_pages=3 * b, max_pages_per_seq=3, **H2O)
    if refusal == "kv_int8":
        kw["kv_int8"] = True
    if refusal == "spec":
        kw["spec_tokens"] = 4
    with pytest.raises(ValueError) as jerr:
        j_generate_paged.generate_paged(tiny["jparams"], tiny["jcfg"], jnp.asarray(embeds),
                                        jnp.full((b,), 20, jnp.int32), jax.random.key(0), **kw)
    with pytest.raises(ValueError) as err:
        generate_paged(tiny["params"], tiny["cfg"], _t(embeds),
                       torch.full((b,), 20, dtype=torch.int32), **kw)
    assert str(err.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# LongVA.kv_budget_tokens
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    dcfg = jconfig.DecoderConfig.tiny()
    jm = JLongVA.init_random(jax.random.key(0),
                             jconfig.ViTConfig.tiny(projection_dim=dcfg.hidden_size), dcfg,
                             dtype=jnp.float32)
    pm = LongVA(vit_params=convert.vit_params(_np(jm.vit_params)),
                proj_params=convert.to_torch(_np(jm.proj_params)),
                dec_params=convert.to_torch(_np(jm.dec_params)),
                vit_cfg=config.ViTConfig(**dataclasses.asdict(jm.vit_cfg)),
                dec_cfg=config.DecoderConfig(**dataclasses.asdict(dcfg)),
                tokenizer=ByteTokenizer(), generator=torch.Generator().manual_seed(0))
    return jm, pm


@pytest.mark.parametrize("budget", [None, 1, 128, 300, 512, 1000, 8192, 100_000])
def test_paged_budget_matches_jax(models, budget):
    jm, pm = models
    jm.kv_budget_tokens = pm.kv_budget_tokens = budget
    try:
        got, ref = pm._paged_budget(), jm._paged_budget(640, 128)
        assert got == ref
        if budget is not None:
            assert got["hh_size"] > 0 and got["num_pages"] == got["max_pages_per_seq"]
    finally:
        jm.kv_budget_tokens = pm.kv_budget_tokens = None


def test_paged_budget_refuses_kv_int8(models):
    jm, pm = models
    for m in (jm, pm):
        m.kv_budget_tokens, m.kv_int8 = 512, True
    try:
        with pytest.raises(ValueError, match="exclusive"):
            jm._paged_budget(640, 128)
        with pytest.raises(ValueError, match="exclusive"):
            pm._paged_budget()
    finally:
        for m in (jm, pm):
            m.kv_budget_tokens, m.kv_int8 = None, False


def test_longva_budget_generation_token_exact(no_launches, models, monkeypatch):
    """Under a 256-token budget (2 pages: hh 60, recent 128, sink 4) a
    ~330-token prompt is compressed at prefill; the batch goes row by row,
    one batch-1 H2O call a row, and spec_tokens is ignored."""
    jm, pm = models
    jtoks, ptoks, calls = [], [], []
    jfetch, pgen = j_generate_paged.generate_paged_fetch, port_longva.generate_paged

    def jrec(*a, **kw):
        toks, count = jfetch(*a, **kw)
        jtoks.append(np.asarray(toks)[0, :int(count[0])].tolist())
        return toks, count

    def prec(params, cfg, embeds, lengths, *a, **kw):
        calls.append((len(lengths), kw.get("hh_size"), kw.get("spec_tokens", 0)))
        toks, count = pgen(params, cfg, embeds, lengths, *a, **kw)
        ptoks.append(toks[0, :int(count[0])].tolist())
        return toks, count

    monkeypatch.setattr(j_generate_paged, "generate_paged_fetch", jrec)
    monkeypatch.setattr(port_longva, "generate_paged", prec)
    feats = _rand(14, 300, jm.dec_cfg.hidden_size)
    prompts = ["describe <image> please", "what is in <image>?"]
    jm.kv_budget_tokens = pm.kv_budget_tokens = 256
    pm.spec_tokens = 4
    try:
        ref = [jm.generate_with_image_embedding(prompts[0], [jnp.asarray(feats)],
                                                max_new_tokens=6)]
        got = [pm.generate_with_image_embedding(prompts[0], [_t(feats)], max_new_tokens=6)]
        ref += jm.generate_with_image_embedding_batch(
            prompts, [[jnp.asarray(feats)], [jnp.asarray(feats[::-1])]], max_new_tokens=6)
        got += pm.generate_with_image_embedding_batch(
            prompts, [[_t(feats)], [_t(feats[::-1].copy())]], max_new_tokens=6)
    finally:
        jm.kv_budget_tokens = pm.kv_budget_tokens = None
        pm.spec_tokens = 0
    assert got == ref
    assert ptoks == jtoks and len(ptoks) == 3 and all(ptoks)
    assert calls == [(1, 60, 0)] * 3
    assert pm.gen_stats["compressions_at_prefill"] >= 2
