"""The decode loops in step form (`models/step_graph.py`) on the CPU.

On the card each loop replays its step as a CUDA graph; on the CPU the same
step runs eagerly, so these tests hold the step form's arithmetic and its
static buffers, at tiny geometry in float32:
- greedy generation token-exact with the JAX package's loops: the dense
  `generate` (the judge's), `generate_paged` in row order (one row; two rows
  on the partitioned pool) and through the page table (a caller-sized pool,
  the allocator called in place between steps), and the speculative loop;
- sampled generation (temperature, and top_p) token-exact with the eager
  loops the step form replaced, kept below as they were (their draw was
  `torch.multinomial`), from generators seeded alike;
- every tensor a step reads or writes at one address for the whole loop
  (what a captured graph needs), and a step that rebinds one refused;
- the launch counters' capture tally, the sampler's written-out draw, and
  the in-place allocator and length update;
- the decode workspaces kept across calls (`step_graph.workspace`): a
  second call at one key, over a pool poisoned with NaN, equal to a fresh
  workspace's call from the same generator state, for every loop form; a
  changed key field or generator object giving a new workspace; the byte
  bound's least-recently-used eviction; one cache a thread; a freed
  tree's workspace dropped.
The captured step against the eager one on the card is
`tests/test_torch_cuda.py::test_cuda_graphed_decode_bit_equal_to_eager`,
a kept graph's replay `test_cuda_reused_graph_replays_with_no_capture`.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamchat_tpu import config as jconfig
from streamchat_tpu.models import decoder as jdec
from streamchat_tpu.models import generate as jgen
from streamchat_tpu.models.generate_paged import generate_paged_fetch
from streamchat_tpu_torch import config, convert, kernels
from streamchat_tpu_torch.models import decoder, generate, paged_kv, spec_decode, step_graph
from streamchat_tpu_torch.models import generate_paged as gp
from streamchat_tpu_torch.ops import sampling


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


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
                params=convert.to_torch(jax.tree.map(np.asarray, jparams)))


def _rows(tiny, lengths, s=40, seed=0):
    return (_rand(seed, len(lengths), s, tiny["jcfg"].hidden_size, scale=0.5),
            np.asarray(lengths, np.int32))


# The paged paths: generate_paged's keywords for each.
PAGED = {
    "row_order_b1": ([37], dict(page_size=8)),
    "row_order_partitioned_b2": ([37, 20], dict(page_size=8)),
    "table_b3": ([37, 20, 5], dict(page_size=8, num_pages=22, max_pages_per_seq=7)),
}


# ---------------------------------------------------------------------------
# Greedy: token-exact with the JAX package's loops
# ---------------------------------------------------------------------------


def test_dense_loop_token_exact_with_jax(no_launches, tiny):
    embeds, lengths = _rows(tiny, [37, 12, 25], seed=4)
    ref, ref_count = jgen.generate(tiny["jparams"], tiny["jcfg"], jnp.asarray(embeds),
                                   jnp.asarray(lengths), jax.random.key(1), max_new_tokens=12)
    toks, count = generate.generate(tiny["params"], tiny["cfg"], torch.from_numpy(embeds),
                                    torch.from_numpy(lengths), max_new_tokens=12)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(count.numpy(), np.asarray(ref_count))


@pytest.mark.parametrize("kv_int8", [False, True], ids=["pages", "int8_pages"])
@pytest.mark.parametrize("path", list(PAGED))
def test_paged_loop_token_exact_with_jax(no_launches, tiny, path, kv_int8):
    lengths, kw = PAGED[path]
    embeds, lengths = _rows(tiny, lengths, seed=10)
    kw = dict(kw, max_new_tokens=14, kv_int8=kv_int8)
    ref, ref_count = generate_paged_fetch(tiny["jparams"], tiny["jcfg"], jnp.asarray(embeds),
                                          jnp.asarray(lengths), jax.random.key(2), **kw)
    toks, count = gp.generate_paged(tiny["params"], tiny["cfg"], torch.from_numpy(embeds),
                                    torch.from_numpy(lengths), **kw)
    np.testing.assert_array_equal(toks, np.asarray(ref))
    np.testing.assert_array_equal(count, np.asarray(ref_count))


@pytest.mark.parametrize("kv_int8", [False, True], ids=["pages", "int8_pages"])
def test_spec_loop_token_exact_with_jax(no_launches, tiny, kv_int8):
    """spec_tokens 3 with a lookup corpus that holds a stretch of the vanilla
    output, so drafts are accepted and the verify steps emit ragged counts."""
    embeds, lengths = _rows(tiny, [37], seed=20)
    args = (tiny["params"], tiny["cfg"], torch.from_numpy(embeds), torch.from_numpy(lengths))
    kw = dict(max_new_tokens=20, page_size=8, kv_int8=kv_int8)
    vanilla, _ = gp.generate_paged(*args, **kw)
    lookup = spec_decode.build_lookup_arrays([[7, 8] + vanilla[0][:12].tolist()])
    stats = {}
    toks, count = gp.generate_paged(*args, **kw, spec_tokens=3, stats=stats, **lookup)
    ref, ref_count = generate_paged_fetch(
        tiny["jparams"], tiny["jcfg"], jnp.asarray(embeds), jnp.asarray(lengths),
        jax.random.key(2), **kw, spec_tokens=3,
        lookup_tokens=jnp.asarray(lookup["lookup_tokens"].numpy(), jnp.int32),
        lookup_len=jnp.asarray(lookup["lookup_len"].numpy(), jnp.int32))
    np.testing.assert_array_equal(toks, np.asarray(ref))
    np.testing.assert_array_equal(count, np.asarray(ref_count))
    assert stats["verify_steps"] < 20


# ---------------------------------------------------------------------------
# Sampled: token-exact with the eager loops the step form replaced
# ---------------------------------------------------------------------------


def _eager_sample(logits, generator, *, temperature=0.0, top_p=None):
    """The sampler the eager loops called: `torch.multinomial`."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / temperature
    if top_p is not None and top_p < 1.0:
        logits = sampling.top_p_filter(logits, top_p)
    return torch.multinomial(torch.softmax(logits, dim=-1), 1, generator=generator)[:, 0]


def _eager_generate(params, cfg, embeds, lengths, generator, *, max_new_tokens, temperature,
                    top_p=None):
    """The dense loop as it was: a host loop over `decoder.decode_step`."""
    b, s, _ = embeds.shape
    cache = decoder.KVCache.create(cfg, b, -(-(s + max_new_tokens) // 128) * 128,
                                   dtype=embeds.dtype)
    logits, cache = generate._prefill_inline(params, cfg, embeds, cache, lengths)
    eos = torch.tensor([cfg.eos_token_id])
    out = torch.full((b, max_new_tokens), cfg.pad_token_id, dtype=torch.int64)
    done = torch.zeros(b, dtype=torch.bool)
    step = 0
    while step < max_new_tokens and not bool(done.all()):
        tok = _eager_sample(logits, generator, temperature=temperature, top_p=top_p)
        tok = torch.where(done, torch.full_like(tok, cfg.pad_token_id), tok)
        done = done | torch.isin(tok, eos)
        out[:, step] = tok
        logits, cache = decoder.decode_step(params, cfg, tok, cache)
        step += 1
    return out


def _eager_decode_loop(params, cfg, cache, logits, seq_length, generator, *, row_order,
                       max_new_tokens, temperature, top_p, eos_ids, kv_int8, **_):
    """`generate_paged._decode_loop` as it was (functional allocator)."""
    b = seq_length.shape[0]
    step_fn = paged_kv.decode_step_paged_int8 if kv_int8 else paged_kv.decode_step_paged
    ps = cache.page_size
    eos = torch.tensor(list(eos_ids))
    out = torch.full((b, max_new_tokens), cfg.pad_token_id, dtype=torch.int64)
    done = torch.zeros(b, dtype=torch.bool)
    lengths = seq_length.tolist()
    step = 0
    while step < max_new_tokens:
        tok = _eager_sample(logits, generator, temperature=temperature, top_p=top_p)
        tok = torch.where(done, torch.full_like(tok, cfg.pad_token_id), tok)
        done = done | torch.isin(tok, eos)
        out[:, step] = tok
        if not row_order and any(n % ps == 0 for n in lengths):
            cache, over = paged_kv.allocate_pages_checked(cache, torch.ones(b, dtype=torch.int32))
            assert not bool(over)
        logits, cache = step_fn(params, cfg, tok, cache, sequential_pages=row_order)
        lengths = [n + 1 for n in lengths]
        step += 1
        if bool(done.all()):
            break
    return out.numpy(), step


def _eager_spec_loop(params, cfg, cache, first_logits, seq_length, generator, *,
                     max_new_tokens, temperature, eos_ids, spec_tokens, spec_ngram,
                     lookup_tokens=None, lookup_len=None, **_):
    """`spec_decode.run_spec_decode_loop` as it was."""
    t_block = spec_tokens + 1
    b = seq_length.shape[0]
    eos = torch.tensor(list(eos_ids))
    hlk = 0 if lookup_tokens is None else lookup_tokens.shape[1]
    hist = torch.full((b, hlk + max_new_tokens + t_block), -1, dtype=torch.long)
    hist_len = torch.zeros(b, dtype=torch.long)
    if lookup_tokens is not None:
        hist[:, :hlk] = lookup_tokens
        hist_len = lookup_len.to(torch.long)
    trash_out, trash_hist = max_new_tokens + t_block - 1, hist.shape[1] - 1
    rows, ar = torch.arange(b)[:, None], torch.arange(t_block)[None]
    out = torch.full((b, max_new_tokens + t_block), cfg.pad_token_id, dtype=torch.long)
    written = torch.zeros(b, dtype=torch.long)
    done = torch.zeros(b, dtype=torch.bool)
    pos, logits, steps = seq_length.to(torch.long), first_logits, 0
    while bool((~done & (written < max_new_tokens)).any()):
        t0 = _eager_sample(logits, generator, temperature=temperature)
        t0 = torch.where(done, torch.full_like(t0, cfg.pad_token_id), t0)
        hist2 = hist.clone()
        hist2[rows[:, 0], hist_len.clamp_max(trash_hist)] = t0
        draft = spec_decode.ngram_propose(hist2, hist_len + 1, ngram=spec_ngram,
                                          num_draft=spec_tokens)
        tokens = torch.cat([t0[:, None], draft], dim=1)
        logits_all, cache = spec_decode.decode_step_spec(params, cfg, tokens, cache,
                                                         pos[:, None] + ar)
        uniforms = None
        if temperature > 0.0:
            uniforms = torch.rand(b, spec_tokens, generator=generator)
        n_acc, logits, any_eos = spec_decode._accept(
            logits_all, tokens, logits, done, written, temperature=temperature,
            uniforms=uniforms, eos=eos, max_new_tokens=max_new_tokens)
        live = ar < n_acc[:, None]
        out[rows, torch.where(live, written[:, None] + ar, trash_out)] = tokens
        hist[rows, torch.where(live, (hist_len[:, None] + ar).clamp_max(trash_hist),
                               trash_hist)] = tokens
        done = done | any_eos | (written + n_acc >= max_new_tokens)
        cache.length = (cache.length + n_acc).to(torch.int32)
        pos, written, hist_len = pos + n_acc, written + n_acc, hist_len + n_acc
        steps += 1
    toks = out[:, :max_new_tokens]
    count = torch.minimum((torch.cumsum(torch.isin(toks, eos).long(), 1) == 0).sum(1), written)
    return toks, count, steps, int(written.sum())


SAMPLED = {"temperature": dict(temperature=1.0), "top_p": dict(temperature=0.8, top_p=0.9)}


@pytest.mark.parametrize("sampled", list(SAMPLED))
def test_dense_step_form_matches_the_eager_loop_sampled(no_launches, tiny, sampled):
    embeds, lengths = _rows(tiny, [37, 12, 25], seed=30)
    args = (tiny["params"], tiny["cfg"], torch.from_numpy(embeds), torch.from_numpy(lengths))
    kw = dict(max_new_tokens=16, **SAMPLED[sampled])
    ref = _eager_generate(*args, torch.Generator().manual_seed(5), **kw)
    toks, _ = generate.generate(*args, torch.Generator().manual_seed(5), **kw)
    np.testing.assert_array_equal(toks.numpy(), ref.numpy())
    assert len(set(ref.flatten().tolist())) > 8               # the draws vary


@pytest.mark.parametrize("sampled", list(SAMPLED))
@pytest.mark.parametrize("kv_int8", [False, True], ids=["pages", "int8_pages"])
@pytest.mark.parametrize("path", list(PAGED))
def test_paged_step_form_matches_the_eager_loop_sampled(no_launches, tiny, monkeypatch, path,
                                                        kv_int8, sampled):
    lengths, kw = PAGED[path]
    embeds, lengths = _rows(tiny, lengths, seed=40)
    args = (tiny["params"], tiny["cfg"], torch.from_numpy(embeds), torch.from_numpy(lengths))
    kw = dict(kw, max_new_tokens=14, kv_int8=kv_int8, **SAMPLED[sampled])
    toks, count = gp.generate_paged(*args, torch.Generator().manual_seed(6), **kw)
    monkeypatch.setattr(gp, "_decode_loop", _eager_decode_loop)
    ref, ref_count = gp.generate_paged(*args, torch.Generator().manual_seed(6), **kw)
    np.testing.assert_array_equal(toks, ref)
    np.testing.assert_array_equal(count, ref_count)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["pages", "int8_pages"])
@pytest.mark.parametrize("rows", [[37], [37, 20]], ids=["b1", "partitioned_b2"])
def test_spec_step_form_matches_the_eager_loop_sampled(no_launches, tiny, monkeypatch, rows,
                                                       kv_int8):
    """Rejection sampling at temperature 1 (top_p is refused with spec)."""
    embeds, lengths = _rows(tiny, rows, seed=50)
    args = (tiny["params"], tiny["cfg"], torch.from_numpy(embeds), torch.from_numpy(lengths))
    lookup = spec_decode.build_lookup_arrays([[3, 9, 27, 81]] * len(rows))
    kw = dict(max_new_tokens=16, page_size=8, kv_int8=kv_int8, temperature=1.0, spec_tokens=3,
              **lookup)
    toks, count = gp.generate_paged(*args, torch.Generator().manual_seed(7), **kw)
    monkeypatch.setattr(gp, "run_spec_decode_loop", _eager_spec_loop)
    ref, ref_count = gp.generate_paged(*args, torch.Generator().manual_seed(7), **kw)
    np.testing.assert_array_equal(toks, ref)
    np.testing.assert_array_equal(count, ref_count)


# ---------------------------------------------------------------------------
# Static buffers
# ---------------------------------------------------------------------------


@pytest.fixture
def addresses(monkeypatch):
    """Every StepGraph call's static tensors' addresses, per loop."""
    seen = {}
    call = step_graph.StepGraph.__call__

    def recording(self):
        call(self)
        seen.setdefault(id(self), []).append(
            (tuple(t.data_ptr() for t in self.bound()), tuple(map(id, self.bound()))))

    monkeypatch.setattr(step_graph.StepGraph, "__call__", recording)
    return seen


def _fixed(seen):
    assert len(seen) == 1
    (calls,) = seen.values()
    assert len(calls) > 2
    assert all(c == calls[0] for c in calls), "a static tensor moved between steps"
    return calls[0][0]


def test_dense_step_keeps_its_buffers(no_launches, tiny, addresses, monkeypatch):
    caches = []
    create = decoder.KVCache.create
    monkeypatch.setattr(decoder.KVCache, "create",
                        classmethod(lambda cls, *a, **kw: caches.append(create(*a, **kw))
                                    or caches[-1]))
    embeds, lengths = _rows(tiny, [37, 12], seed=60)
    generate.generate(tiny["params"], tiny["cfg"], torch.from_numpy(embeds),
                      torch.from_numpy(lengths), max_new_tokens=8)
    ptrs = _fixed(addresses)
    cache = caches[-1]
    assert {cache.k.data_ptr(), cache.v.data_ptr(), cache.length.data_ptr()} <= set(ptrs)


@pytest.mark.parametrize("path", list(PAGED))
def test_paged_step_keeps_its_buffers(no_launches, tiny, addresses, monkeypatch, path):
    """The table path included: the allocator maps pages between steps into
    the same table."""
    caches = []
    loop = gp._decode_loop
    monkeypatch.setattr(gp, "_decode_loop",
                        lambda p, c, cache, *a, **kw: caches.append(cache) or loop(p, c, cache,
                                                                                  *a, **kw))
    lengths, kw = PAGED[path]
    embeds, lengths = _rows(tiny, lengths, seed=61)
    gp.generate_paged(tiny["params"], tiny["cfg"], torch.from_numpy(embeds),
                      torch.from_numpy(lengths), max_new_tokens=12, **kw)
    ptrs = _fixed(addresses)
    (cache,) = caches
    assert {cache.length.data_ptr(), cache.page_table.data_ptr(),
            cache.k_pages.data_ptr(), cache.v_pages.data_ptr()} <= set(ptrs)


def test_spec_step_keeps_its_buffers(no_launches, tiny, addresses):
    embeds, lengths = _rows(tiny, [37], seed=62)
    lookup = spec_decode.build_lookup_arrays([[1, 2, 3]])
    gp.generate_paged(tiny["params"], tiny["cfg"], torch.from_numpy(embeds),
                      torch.from_numpy(lengths), max_new_tokens=12, page_size=8,
                      spec_tokens=2, **lookup)
    assert len(_fixed(addresses)) >= 10


def test_step_graph_refuses_a_step_that_rebinds_a_buffer():
    state = {"x": torch.zeros(2)}

    def step():
        state["x"] = state["x"] + 1                # rebinds: a replay would miss it

    loop = step_graph.StepGraph(step, lambda: (state["x"],), "cpu", graphed=False)
    with pytest.raises(RuntimeError, match="moved"):
        for _ in range(3):
            loop()


def test_use_graph_defaults_to_the_card_and_refuses_what_cannot_be_graphed():
    assert step_graph.use_graph(None, "cpu", {}) is False
    assert step_graph.use_graph(False, "cpu", {}) is False
    with pytest.raises(ValueError):
        step_graph.use_graph(True, "cpu", {})
    with pytest.raises(ValueError):
        step_graph.StepGraph(lambda: None, tuple, "cpu", graphed=True)


def test_graph_keyword_refuses_a_graph_on_the_cpu(tiny):
    embeds, lengths = _rows(tiny, [37], seed=63)
    with pytest.raises(ValueError, match="graphed"):
        gp.generate_paged(tiny["params"], tiny["cfg"], torch.from_numpy(embeds),
                          torch.from_numpy(lengths), max_new_tokens=4, graph=True)


# ---------------------------------------------------------------------------
# The pieces: launch tally, sampler, in-place allocator and length
# ---------------------------------------------------------------------------


def test_recording_tallies_this_threads_launches_and_replays_count_them():
    from streamchat_tpu_torch.ops import quant

    fn = quant.qmatvec_int8
    kernels.reset_launch_counts()
    other = threading.Thread(target=lambda: kernels.launched(fn))
    with kernels.recording() as tally:
        kernels.launched(fn)
        kernels.launched(fn)
        other.start()
        other.join(timeout=10)
    assert not other.is_alive()
    assert tally == {(fn, None): 2}
    assert kernels.launch_counts()["qmatvec_int8"] == 1      # the other thread's
    kernels.add_launches(tally)
    kernels.add_launches(tally)
    assert kernels.launch_counts()["qmatvec_int8"] == 5
    kernels.reset_launch_counts()


@pytest.mark.parametrize("top_p", [None, 0.9])
def test_sampler_draws_what_multinomial_draws(top_p):
    logits = torch.from_numpy(_rand(70, 4, 300, scale=3.0))
    g1, g2 = torch.Generator().manual_seed(8), torch.Generator().manual_seed(8)
    for _ in range(20):
        got = sampling.sample_token(logits, g1, temperature=0.7, top_p=top_p)
        ref = _eager_sample(logits, g2, temperature=0.7, top_p=top_p)
        assert torch.equal(got, ref)
    assert torch.equal(g1.get_state(), g2.get_state())


def test_allocator_in_place_equals_the_functional_one(tiny):
    cache = paged_kv.PagedKVCache.create(tiny["cfg"], 3, 12, 5, page_size=8)
    cache.length = torch.tensor([8, 3, 16], dtype=torch.int32)
    table, next_free = cache.page_table, cache.next_free
    for grow in ([1, 1, 1], [8, 0, 9], [40, 1, 1]):
        tokens = torch.tensor(grow, dtype=torch.int32)
        ref, ref_over = paged_kv.allocate_pages_checked(cache, tokens)
        over = paged_kv.allocate_pages_(cache, tokens)
        assert cache.page_table is table and cache.next_free is next_free
        assert torch.equal(table, ref.page_table) and torch.equal(next_free, ref.next_free)
        assert bool(over) == bool(ref_over)
        paged_kv.advance(cache, 1)
    assert bool(over)                                # the last growth overflows


def test_decode_steps_advance_lengths_in_place(tiny):
    params, cfg = tiny["params"], tiny["cfg"]
    embeds, lengths = _rows(tiny, [37, 20], seed=71)
    dense = decoder.KVCache.create(cfg, 2, 64)
    _, dense = decoder.prefill(params, cfg, torch.from_numpy(embeds), dense,
                               torch.from_numpy(lengths))
    pool = paged_kv.from_contiguous(dense, 16, 8, page_size=8, partitioned=True)
    for cache, step in ((dense, lambda c: decoder.decode_step(params, cfg, torch.tensor([1, 2]),
                                                              c)),
                        (pool, lambda c: paged_kv.decode_step_paged(
                            params, cfg, torch.tensor([1, 2]), c, sequential_pages=True))):
        length = cache.length
        step(cache)
        assert cache.length is length and length.tolist() == [38, 21]


# ---------------------------------------------------------------------------
# Workspaces kept across calls (the jit cache's counterpart)
# ---------------------------------------------------------------------------


@pytest.fixture
def fresh_cache():
    """This thread's workspaces dropped before and after the test, which runs
    on one intra-op thread (the suite runs a worker per core; these tiny
    steps take several times as long when torch's thread pools contend)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    step_graph.release()
    yield
    step_graph.release()
    torch.set_num_threads(n)


def _poison(ws):
    """Every cache tensor of a kept workspace (pools, scales, table, lengths,
    `next_free`) and H2O's scores overwritten: NaN where floating, 7
    elsewhere. A call at its key must page its prefill in, reset the rest
    and read nothing past a row's length."""
    for name, x in ws.tensors.items():
        tensors = step_graph.cache_tensors(x) if dataclasses.is_dataclass(x) else (
            (x,) if name == "hh" else ())
        for t in tensors:
            t.fill_(float("nan") if t.is_floating_point() else 7)


# Each loop form's call: (rows' valid lengths, generate_paged keywords, or
# None for the dense loop).
FORMS = {
    "dense": ([37, 12, 25], None),
    "row_order_b1": ([37], dict(page_size=8)),
    "partitioned_b2_int8_pages": ([37, 20], dict(page_size=8, kv_int8=True)),
    "table_b3": ([37, 20, 5], dict(page_size=8, num_pages=22, max_pages_per_seq=7)),
    "spec3": ([37], dict(page_size=8, spec_tokens=3)),
    "h2o": ([20], dict(page_size=16, num_pages=3, max_pages_per_seq=3, hh_size=12,
                       recent_size=16, sink_size=4)),
}


def _form_call(tiny, form, seed, generator, **extra):
    lengths, kw = FORMS[form]
    embeds, lengths = _rows(tiny, lengths, s=40 if form != "h2o" else 20, seed=seed)
    args = (tiny["params"], tiny["cfg"], torch.from_numpy(embeds), torch.from_numpy(lengths),
            generator)
    common = dict(max_new_tokens=14 if form != "h2o" else 36, temperature=1.0, **extra)
    if kw is None:
        return generate.generate(*args, **common)[0].numpy()
    return gp.generate_paged(*args, **kw, **common)[0]


@pytest.mark.parametrize("form", list(FORMS))
def test_second_call_at_one_key_equals_a_fresh_workspace(no_launches, tiny, fresh_cache, form):
    """Call 1 at a key, its kept pool and scores poisoned, then call 2 from
    generator state S (another prompt) in the kept workspace, and call 3
    from S in a fresh one: the tokens are equal, and call 2 ran the
    workspace's own step and tensors. Sampled at temperature 1, with H2O
    compressing inside the loop."""
    g = torch.Generator().manual_seed(9)
    _form_call(tiny, form, 80, g)
    (ws,) = step_graph.workspaces()
    loops = dict(ws.loops)
    _poison(ws)
    state = g.get_state()
    stats = {}
    kept = _form_call(tiny, form, 81, g, **({} if FORMS[form][1] is None else dict(stats=stats)))
    assert step_graph.workspaces() == [ws] and ws.loops == loops
    step_graph.release()
    g.set_state(state)
    fresh = _form_call(tiny, form, 81, g)
    assert step_graph.workspaces()[0] is not ws
    np.testing.assert_array_equal(kept, fresh)
    if form == "h2o":
        assert stats["compressions_in_loop"] >= 1


# One field changed at a time against BASE (generate_paged keywords).
BASE = dict(max_new_tokens=6, page_size=8, temperature=0.0)
CHANGED = {
    "max_new_tokens": dict(max_new_tokens=7), "temperature": dict(temperature=0.5),
    "top_p": dict(temperature=0.5, top_p=0.9), "eos_ids": dict(eos_ids=(1, 2)),
    "pool": dict(num_pages=22, max_pages_per_seq=7), "kv_int8": dict(kv_int8=True),
    "spec_tokens": dict(spec_tokens=2), "spec_ngram": dict(spec_tokens=2, spec_ngram=2),
    "h2o": dict(hh_size=12, recent_size=16, num_pages=3, max_pages_per_seq=3, page_size=16),
    "h2o_merge": dict(hh_size=12, recent_size=16, num_pages=3, max_pages_per_seq=3,
                      page_size=16, merge="avg"),
}


def test_a_changed_key_field_or_generator_gives_a_new_workspace(no_launches, tiny, fresh_cache):
    embeds, lengths = _rows(tiny, [37], s=40, seed=82)
    g = torch.Generator().manual_seed(1)

    def claimed(generator=g, rows=1, **kw):
        gp.generate_paged(tiny["params"], tiny["cfg"], torch.from_numpy(embeds).repeat(rows, 1, 1),
                          torch.from_numpy(lengths).repeat(rows), generator, **dict(BASE, **kw))
        return step_graph.workspaces()[-1]

    base = claimed()
    seen = {"base": base}
    for name, kw in CHANGED.items():
        seen[name] = claimed(**kw)
    seen["rows"] = claimed(rows=2)
    seen["generator"] = claimed(generator=torch.Generator().manual_seed(1))
    seen["no_generator"] = claimed(generator=None)
    assert len({id(ws) for ws in seen.values()}) == len(seen)
    assert claimed() is base and claimed(**CHANGED["h2o"]) is seen["h2o"]


def test_the_byte_bound_evicts_the_least_recently_used(no_launches, tiny, fresh_cache,
                                                       monkeypatch):
    embeds, lengths = _rows(tiny, [37], s=40, seed=83)

    def call(max_new):
        gp.generate_paged(tiny["params"], tiny["cfg"], torch.from_numpy(embeds),
                          torch.from_numpy(lengths), max_new_tokens=max_new, page_size=8)
        return step_graph.workspaces()[-1]

    a = call(4)
    monkeypatch.setattr(step_graph, "WORKSPACE_BYTES", 2 * a.nbytes() + a.nbytes() // 2)
    b = call(5)
    assert step_graph.workspaces() == [a, b]
    assert call(4) is a                              # a is the most recent again
    c = call(6)
    assert step_graph.workspaces() == [a, c]         # b, the least recent, went
    monkeypatch.setattr(step_graph, "WORKSPACE_BYTES", 1)
    d = call(7)
    assert step_graph.workspaces() == [d]            # alone over the bound, it stays


def test_two_threads_keep_separate_caches(no_launches, tiny, fresh_cache):
    embeds, lengths = _rows(tiny, [37], s=40, seed=84)
    out = {}

    def run():
        return gp.generate_paged(tiny["params"], tiny["cfg"], torch.from_numpy(embeds),
                                 torch.from_numpy(lengths), max_new_tokens=5, page_size=8)

    def worker():
        out["toks"] = run()[0]
        out["spaces"] = step_graph.workspaces()
        step_graph.release()

    toks, _ = run()
    mine = step_graph.workspaces()
    thread = threading.Thread(target=worker)
    thread.start()
    thread.join(timeout=60)
    assert not thread.is_alive()
    assert len(mine) == 1 and len(out["spaces"]) == 1 and out["spaces"][0] is not mine[0]
    assert step_graph.workspaces() == mine
    np.testing.assert_array_equal(out["toks"], toks)


def test_a_freed_tree_drops_its_workspace(no_launches, tiny, fresh_cache):
    embeds, lengths = _rows(tiny, [37], s=40, seed=85)
    # The same leaves but one, a leaf of its own.
    copy = dict(tiny["params"], final_norm=tiny["params"]["final_norm"].clone())
    kw = dict(max_new_tokens=4, page_size=8)
    gp.generate_paged(copy, tiny["cfg"], torch.from_numpy(embeds), torch.from_numpy(lengths), **kw)
    (ws,) = step_graph.workspaces()
    assert ws.alive()
    del copy
    assert not ws.alive()
    gp.generate_paged(tiny["params"], tiny["cfg"], torch.from_numpy(embeds),
                      torch.from_numpy(lengths), **kw)
    assert ws not in step_graph.workspaces() and len(step_graph.workspaces()) == 1
