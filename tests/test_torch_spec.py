"""The port's speculative decode against the JAX package's, on the CPU.

Inputs are numpy arrays made from a seed and handed to both packages, at
tiny geometry in float32. Tolerances:
- `ngram_propose`: the same drafts, exactly.
- K7's twins (`paged_seq_attention_partial{,_int8}_plain`) against the JAX
  Pallas kernels in interpret mode, 16 and 80 folded rows a kv head: acc
  and l to atol 1e-4, m to atol 1e-5; a row with no live key gives
  m = -1e30, l = 0, acc = 0 exactly.
- `_spec_attention` and a verify step (`decode_step_spec`) against JAX's:
  outputs and logits to atol 1e-4 (1e-3 over int8 pages, one quantization
  step); the committed pool to atol 1e-5, or int8 values to one step and
  their scales to rtol 1e-5.
- Greedy speculative generation: tokens identical to the JAX spec loop and
  to the port's vanilla loop, bf16 (here f32) and int8 pages, 1 and 3
  draft tokens, with a lookup corpus under which drafts are accepted.
- The acceptance rule with injected uniforms: exact decisions; the emitted
  distribution of a one-draft step matches the model's to 0.02 over 20,000
  draws.
On a CPU tensor no wrapper may count a kernel launch.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamchat_tpu import config as jconfig
from streamchat_tpu.models import decoder as jdec
from streamchat_tpu.models import paged_kv as jpkv
from streamchat_tpu.models import spec_decode as jspec
from streamchat_tpu.models.generate_paged import generate_paged_fetch
from streamchat_tpu.models.longva import LongVA as JLongVA
from streamchat_tpu.ops.paged_attention import (
    paged_seq_attention_partial as j_partial,
    paged_seq_attention_partial_int8 as j_partial_int8,
)
from streamchat_tpu_torch import config, convert, kernels
from streamchat_tpu_torch.models import decoder, paged_kv, spec_decode
from streamchat_tpu_torch.models.embedder import TextEmbedder
from streamchat_tpu_torch.models.generate_paged import generate_paged
from streamchat_tpu_torch.models.longva import LongVA
from streamchat_tpu_torch.models.tokenizer import ByteTokenizer
from streamchat_tpu_torch.ops import paged_attention
from streamchat_tpu_torch.pipeline import runner

ATOL = 1e-4


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture
def no_launches():
    kernels.reset_launch_counts()
    yield
    assert all(v == 0 for v in kernels.launch_counts().values()), \
        "a CPU tensor must run the plain twin, never count a launch"


@pytest.mark.parametrize("hist,hist_len,ngram,num_draft", [
    ([1, 5, 6, 7, 8, 2, 5, 6, 0, 0], 8, 2, 2),      # continuation of the last match
    ([5, 6, 7, 5, 6, 9, 4, 5, 6, 0], 9, 2, 1),      # the most recent match wins
    ([1, 2, 3, 4, 0, 0], 4, 2, 3),                  # no match: repeat the last token
    ([5, 6, 7, 5, 6, 0, 0, 0], 5, 2, 3),            # continuation past the valid end
    ([9, 0, 0], 1, 3, 2),                           # too short a history
    ([3, 5, 6, 7, 1, 5, 6, 8, 3, 5, 6], 11, 3, 2),  # the longest n wins over the latest
], ids=["continuation", "most-recent", "no-match", "clamped", "short", "longest-n"])
def test_ngram_propose_matches_jax(hist, hist_len, ngram, num_draft):
    ref = jspec.ngram_propose(jnp.asarray([hist], jnp.int32), jnp.asarray([hist_len]),
                              ngram=ngram, num_draft=num_draft)
    out = spec_decode.ngram_propose(torch.tensor([hist]), torch.tensor([hist_len]),
                                    ngram=ngram, num_draft=num_draft)
    assert out.tolist() == np.asarray(ref).tolist()


def _pool(b, maxp, hkv, ps, d, seed):
    return _rand(seed, b * maxp, hkv, ps, d), _rand(seed + 1, b * maxp, hkv, ps, d)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_pages", "int8_pages"])
@pytest.mark.parametrize("lengths,hq,hkv,t", [
    pytest.param([37], 8, 2, 4, id="one-row"),
    pytest.param([37, 0], 8, 2, 4, id="row-without-keys"),
    pytest.param([64, 5], 8, 2, 4, id="partitioned"),
    pytest.param([37, 50], 16, 1, 5, id="80-rows"),
])
def test_partial_twins_match_jax_kernels(no_launches, int8, lengths, hq, hkv, t):
    """q [B, hq, T, 32] over a 4-page-per-row pool (page 16), head-major row
    fold (g * T rows a kv head: 16, and 80 past the card kernel's 64-row
    tile); lengths exclude the block."""
    b, d, ps, maxp = len(lengths), 32, 16, 4
    q = _rand(1, b, hq, t, d)
    kd, vd = _pool(b, maxp, hkv, ps, d, seed=2)
    length = np.asarray(lengths, np.int32)
    if int8:
        kq, ks = jpkv._quantize_kv(jnp.asarray(kd))
        vq, vs = jpkv._quantize_kv(jnp.asarray(vd))
        ref = j_partial_int8(jnp.asarray(q), kq, vq, ks, vs, jnp.asarray(length),
                             pages_per_block=2, interpret=True)
        args = [torch.from_numpy(np.array(a)) for a in (kq, vq, ks, vs)]
        out = paged_attention.paged_seq_attention_partial_int8(
            torch.from_numpy(q), *args, torch.from_numpy(length))
    else:
        ref = j_partial(jnp.asarray(q), jnp.asarray(kd), jnp.asarray(vd), jnp.asarray(length),
                        pages_per_block=2, interpret=True)
        out = paged_attention.paged_seq_attention_partial(
            torch.from_numpy(q), torch.from_numpy(kd), torch.from_numpy(vd),
            torch.from_numpy(length))
    for got, want, atol in zip(out, ref, (ATOL, 1e-5, ATOL)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)
    for row, n in enumerate(lengths):
        if n == 0:
            assert (out[1][row] == -1e30).all() and (out[2][row] == 0).all()
            assert (out[0][row] == 0).all()


def test_partial_int8_twin_ignores_garbage_past_the_length(no_launches):
    """NaN / inf in stale int8 scales past the length never reach the result."""
    q = torch.from_numpy(_rand(3, 1, 8, 4, 32))
    kd, vd = _pool(1, 4, 2, 16, 32, seed=4)
    kq, ks = paged_kv._quantize_kv(torch.from_numpy(kd))
    vq, vs = paged_kv._quantize_kv(torch.from_numpy(vd))
    length = torch.tensor([37], dtype=torch.int32)
    clean = paged_attention.paged_seq_attention_partial_int8(q, kq, vq, ks, vs, length)
    for sc, bad in ((ks, float("nan")), (vs, float("inf"))):
        sc[2, :, 5:] = bad                        # token 37 onwards
        sc[3] = bad
    dirty = paged_attention.paged_seq_attention_partial_int8(q, kq, vq, ks, vs, length)
    for a, b in zip(clean, dirty):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_pages", "int8_pages"])
def test_spec_attention_matches_jax(no_launches, int8):
    """Pool (K7 twin) plus the staged block, merged: against JAX's CPU path."""
    b, hq, hkv, t, d, ps, maxp = 1, 8, 2, 4, 32, 16, 4
    q, fk, fv = _rand(5, b, hq, t, d), _rand(6, b, hkv, t, d), _rand(7, b, hkv, t, d)
    kd, vd = _pool(b, maxp, hkv, ps, d, seed=8)
    length = np.asarray([37], np.int32)
    if int8:
        pool_j = [*jpkv._quantize_kv(jnp.asarray(kd)), *jpkv._quantize_kv(jnp.asarray(vd))]
        pool_j = [pool_j[0], pool_j[2], pool_j[1], pool_j[3]]     # k, v, k_scale, v_scale
    else:
        pool_j = [jnp.asarray(kd), jnp.asarray(vd), None, None]
    ref = jspec._spec_attention(jnp.asarray(q), *pool_j, jnp.asarray(length), jnp.asarray(fk),
                                jnp.asarray(fv), d ** -0.5)
    pool_t = [None if a is None else torch.from_numpy(np.array(a)) for a in pool_j]
    out = spec_decode._spec_attention(torch.from_numpy(q), *pool_t, torch.from_numpy(length),
                                      torch.from_numpy(fk), torch.from_numpy(fv))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jconfig.DecoderConfig.tiny()
    jparams = jdec.init(jax.random.key(0), jcfg, jnp.float32)
    return dict(jcfg=jcfg, jparams=jparams,
                cfg=config.DecoderConfig(**dataclasses.asdict(jcfg)),
                params=convert.to_torch(jax.tree.map(np.asarray, jparams)))


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_pages", "int8_pages"])
def test_decode_step_spec_matches_jax(no_launches, tiny, int8):
    """One verify step of T = 4 tokens after a 29-token prefill: logits and
    the committed pool (all four tokens written, the length not advanced)."""
    jcfg, cfg = tiny["jcfg"], tiny["cfg"]
    embeds, length = _rand(9, 1, 32, jcfg.hidden_size, scale=0.5), np.asarray([29], np.int32)
    jdense = jdec.KVCache.create(jcfg, 1, 32, dtype=jnp.float32)
    _, jdense = jdec.prefill(tiny["jparams"], jcfg, jnp.asarray(embeds), jdense,
                             jnp.asarray(length))
    dense = decoder.KVCache.create(cfg, 1, 32, dtype=torch.float32)
    _, dense = decoder.prefill(tiny["params"], cfg, torch.from_numpy(embeds), dense,
                               torch.from_numpy(length))
    with jax.disable_jit():               # eager quantizer scales, as the port's
        if int8:
            jpool = jpkv.from_contiguous_int8(jdense, 5, 5, page_size=8)
        else:
            jpool = jpkv.from_contiguous(jdense, 5, 5, page_size=8)
        jpool = jpkv.allocate_pages_int8(jpool, jnp.asarray([4])) if int8 else \
            jpkv.allocate_pages(jpool, jnp.asarray([4]))
    pool = (paged_kv.from_contiguous_int8 if int8 else paged_kv.from_contiguous)(
        dense, 5, 5, page_size=8)
    pool.page_table = torch.from_numpy(np.array(jpool.page_table))
    tokens = np.asarray([[17, 300, 5, 17]])
    positions = 29 + np.arange(4)[None]
    with jax.disable_jit():
        ref, jpool = jspec.decode_step_spec(tiny["jparams"], jcfg, jnp.asarray(tokens), jpool,
                                            jnp.asarray(positions))
    out, pool = spec_decode.decode_step_spec(tiny["params"], cfg, torch.from_numpy(tokens), pool,
                                             torch.from_numpy(positions))
    # With int8 pages a staged K/V entry whose f32 input differs from JAX's
    # in the last bits can round to the neighbouring int8 value (one step,
    # up to 1/254 of its slot's largest value): logits agree to 1e-3 and
    # committed int8 values to one step.
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3 if int8 else ATOL,
                               rtol=0)
    assert int(pool.length[0]) == 29
    if int8:
        np.testing.assert_allclose(pool.k_pages.numpy(), np.asarray(jpool.k_pages), atol=1,
                                   rtol=0)
        np.testing.assert_allclose(pool.v_scale.numpy(), np.asarray(jpool.v_scale),
                                   rtol=1e-5, atol=0)
    else:
        np.testing.assert_allclose(pool.k_pages.numpy(), np.asarray(jpool.k_pages),
                                   atol=1e-5, rtol=0)


def _greedy_case(tiny, valid=37, max_new=24):
    embeds = _rand(valid, 1, 40, tiny["jcfg"].hidden_size, scale=0.5)
    return embeds, np.asarray([valid], np.int32), max_new


@pytest.mark.parametrize("kv_int8", [False, True], ids=["bf16_pages", "int8_pages"])
@pytest.mark.parametrize("spec_tokens", [1, 3])
def test_greedy_spec_token_exact(no_launches, tiny, kv_int8, spec_tokens):
    """The lookup corpus holds a stretch of the vanilla output, so drafts are
    accepted; tokens equal the JAX spec loop's and the port's vanilla loop's."""
    embeds, length, max_new = _greedy_case(tiny)
    args = (tiny["params"], tiny["cfg"], torch.from_numpy(embeds), torch.from_numpy(length))
    kw = dict(max_new_tokens=max_new, temperature=0.0, page_size=16, kv_int8=kv_int8)
    vanilla, vcount = generate_paged(*args, **kw)
    corpus = [[7, 8]] + [vanilla[0][: max_new - 6].tolist()]
    lookup = spec_decode.build_lookup_arrays([corpus[0] + corpus[1]])
    stats = {}
    toks, count = generate_paged(*args, **kw, spec_tokens=spec_tokens, spec_ngram=3,
                                 stats=stats, **lookup)
    ref_toks, ref_count = generate_paged_fetch(
        tiny["jparams"], tiny["jcfg"], jnp.asarray(embeds), jnp.asarray(length),
        jax.random.key(2), **kw, spec_tokens=spec_tokens, spec_ngram=3,
        lookup_tokens=jnp.asarray(lookup["lookup_tokens"].numpy(), jnp.int32),
        lookup_len=jnp.asarray(lookup["lookup_len"].numpy(), jnp.int32))
    np.testing.assert_array_equal(toks, vanilla)
    np.testing.assert_array_equal(count, vcount)
    np.testing.assert_array_equal(toks, np.asarray(ref_toks))
    np.testing.assert_array_equal(count, np.asarray(ref_count))
    assert stats["accepted_tokens"] == max_new and stats["verify_steps"] < max_new
    assert stats["decode_steps"] == stats["verify_steps"]


def test_generate_paged_appends_past_the_prompt_pages_match_jax(no_launches, tiny):
    """20 new tokens after a 37-token prompt in 8-token pages cross three
    pages past the padded prompt's five; the identity-mapped pool must hold
    them where decode reads them (the JAX loop maps pages as it goes)."""
    embeds, length = _rand(12, 1, 40, tiny["jcfg"].hidden_size, scale=0.5), np.asarray(
        [37], np.int32)
    kw = dict(max_new_tokens=20, temperature=0.0, page_size=8)
    ref, _ = generate_paged_fetch(tiny["jparams"], tiny["jcfg"], jnp.asarray(embeds),
                                  jnp.asarray(length), jax.random.key(0), **kw)
    toks, _ = generate_paged(tiny["params"], tiny["cfg"], torch.from_numpy(embeds),
                             torch.from_numpy(length), **kw)
    np.testing.assert_array_equal(toks, np.asarray(ref))


def _logits(rows):
    return torch.tensor(rows, dtype=torch.float32).log()


def test_acceptance_with_injected_uniforms():
    """Three drafts judged against P = softmax(logits / T); draft j is kept
    while u_j < P_j(draft_j): u = (0.5, 0.9, ...) keeps the first (P 0.7)
    and rejects the second (P 0.6), whose token is masked out of the next
    logits; a rejection at j = 0 keeps t0 only; an accepted EOS stops the
    block; max_new truncates it; a done row emits nothing."""
    p = [[0.7, 0.1, 0.1, 0.1], [0.2, 0.6, 0.1, 0.1], [0.25, 0.25, 0.25, 0.25],
         [0.1, 0.1, 0.1, 0.7]]
    logits_all = _logits([p, p])                                   # [2, 4, 4]
    tokens = torch.tensor([[3, 0, 1, 2], [3, 0, 1, 2]])
    prev = torch.zeros(2, 4)
    kw = dict(temperature=1.0, eos=torch.tensor([9]), max_new_tokens=10)
    done = torch.tensor([False, False])
    written = torch.tensor([0, 0])
    u = torch.tensor([[0.5, 0.9, 0.0], [0.8, 0.0, 0.0]])
    n_acc, nxt, any_eos = spec_decode._accept(logits_all, tokens, prev, done, written,
                                              uniforms=u, **kw)
    assert n_acc.tolist() == [2, 1] and not any_eos.any()
    # Row 0: next logits are step 1's with the rejected draft (token 1) masked;
    # row 1: step 0's with its rejected draft (token 0) masked.
    assert nxt[0, 1] == spec_decode.DEFAULT_MASK_VALUE and nxt[1, 0] == nxt[0, 1]
    torch.testing.assert_close(nxt[0, [0, 2, 3]], logits_all[0, 1, [0, 2, 3]])
    torch.testing.assert_close(nxt[1, 1:], logits_all[1, 0, 1:])

    eos_tokens = torch.tensor([[3, 0, 2, 1], [3, 0, 1, 2]])
    n_acc, _, any_eos = spec_decode._accept(
        logits_all, eos_tokens, prev, torch.tensor([False, True]), torch.tensor([0, 9]),
        uniforms=torch.zeros(2, 3), temperature=1.0, eos=torch.tensor([2]), max_new_tokens=9)
    # Row 0: every draft accepted, the EOS (token 2) at slot 2 ends the block
    # after three tokens; row 1 is done and emits nothing (its own EOS still
    # flags any_eos, as in the JAX loop).
    assert n_acc.tolist() == [3, 0] and any_eos.tolist() == [True, True]
    n_acc, _, _ = spec_decode._accept(
        logits_all, tokens, prev, done, torch.tensor([8, 0]), uniforms=torch.zeros(2, 3),
        temperature=1.0, eos=torch.tensor([9]), max_new_tokens=10)
    assert n_acc.tolist() == [2, 4]          # max_new_tokens cuts row 0 at 10
    greedy, _, _ = spec_decode._accept(logits_all, tokens, prev, done, written,
                                       temperature=0.0, uniforms=None, eos=torch.tensor([9]),
                                       max_new_tokens=10)
    # Greedy: drafts 0 and 1 are the argmaxes of steps 0 and 1; step 2 is a
    # tie that argmax breaks at token 0, so draft 2 is rejected.
    assert greedy.tolist() == [3, 3]


def test_acceptance_keeps_the_model_distribution():
    """One draft d under P: accept with P(d), else draw from P with d
    masked out. The emitted token's distribution is P."""
    probs = torch.tensor([0.5, 0.3, 0.15, 0.05])
    n, d = 20000, 1
    gen = torch.Generator().manual_seed(0)
    logits_all = probs.log().expand(n, 2, 4).contiguous()
    tokens = torch.tensor([[0, d]]).expand(n, 2)
    n_acc, nxt, _ = spec_decode._accept(
        logits_all, tokens, torch.zeros(n, 4), torch.zeros(n, dtype=torch.bool),
        torch.zeros(n, dtype=torch.long), temperature=1.0, uniforms=torch.rand(n, 1, generator=gen),
        eos=torch.tensor([9]), max_new_tokens=10)
    redraw = torch.multinomial(torch.softmax(nxt, -1), 1, generator=gen)[:, 0]
    emitted = torch.where(n_acc == 2, torch.full_like(redraw, d), redraw)
    freq = torch.bincount(emitted, minlength=4).float() / n
    torch.testing.assert_close(freq, probs, atol=0.02, rtol=0)


def test_spec_rejects_top_p(tiny):
    with pytest.raises(ValueError, match="top_p"):
        generate_paged(tiny["params"], tiny["cfg"], torch.zeros(1, 16, 128),
                       torch.tensor([16]), max_new_tokens=2, spec_tokens=2, top_p=0.9)


def test_build_lookup_arrays_matches_jax():
    rows = [[1, 2, 3], list(range(300))]
    ref = jspec.build_lookup_arrays(rows)
    out = spec_decode.build_lookup_arrays(rows)
    np.testing.assert_array_equal(out["lookup_tokens"].numpy(), np.asarray(ref["lookup_tokens"]))
    np.testing.assert_array_equal(out["lookup_len"].numpy(), np.asarray(ref["lookup_len"]))
    assert out["lookup_tokens"].shape == (2, 512)


def test_longva_spec_kwargs_match_jax():
    """The lookup corpus is the prompt's text tokens, image sentinels dropped;
    spec stays off with top_p set."""
    dcfg = jconfig.DecoderConfig.tiny()
    jm = JLongVA.init_random(jax.random.key(0), jconfig.ViTConfig.tiny(
        projection_dim=dcfg.hidden_size), dcfg, dtype=jnp.float32)
    m = LongVA.init_random(config.ViTConfig.tiny(projection_dim=dcfg.hidden_size),
                           config.DecoderConfig.tiny(), device="cpu", dtype=torch.float32)
    m.tokenizer = ByteTokenizer()
    jm.spec_tokens = m.spec_tokens = 3
    prompt = "<|im_start|>user\n<image>\nWhat is here?<|im_end|>\n"
    ref, out = jm._spec_kwargs([prompt], None), m._spec_kwargs([prompt], None)
    assert out["spec_tokens"] == ref["spec_tokens"] == 3 and out["spec_ngram"] == 3
    np.testing.assert_array_equal(out["lookup_tokens"].numpy(), np.asarray(ref["lookup_tokens"]))
    assert int(out["lookup_len"][0]) == int(ref["lookup_len"][0]) > 0
    assert m._spec_kwargs([prompt], 0.9) == {} == jm._spec_kwargs([prompt], 0.9)


@pytest.mark.parametrize("cls", [LongVA, TextEmbedder])
def test_public_constructors_default_to_the_card(cls):
    assert inspect.signature(cls.init_random).parameters["device"].default == "cuda"


def test_cli_spec_tokens_runs_a_tiny_cpu_pipeline(monkeypatch, tmp_path):
    """`--spec_tokens 2` sets speculative decoding on the model as the JAX
    `main` does, and a tiny off-line run on the CPU decodes through it
    (captions sample at caption_temperature, so the rejection rule runs)."""
    from streamchat_tpu_torch.memory.bank import MemoryBank
    from streamchat_tpu_torch.video.reader import SyntheticVideoReader

    ran = []

    def tiny_run(pipe, args):
        m = pipe.model
        bank = MemoryBank(str(tmp_path / "m.json"), pipe.bank_embed)
        res = pipe.process_video(
            SyntheticVideoReader(total_frames=90, frame_rate=30, height=56, width=56),
            [{"question": "q1", "time": 2}], bank, "User")
        ran.append((m.spec_tokens, m.spec_ngram, dict(m.gen_stats), res))

    parse = runner.config_from_args

    def short_budgets(args):
        cfg = parse(args)
        return dataclasses.replace(cfg, sampling=dataclasses.replace(
            cfg.sampling, max_answer_tokens=6, max_caption_tokens=6, max_summary_tokens=6))

    monkeypatch.setattr(runner, "run_inference", tiny_run)
    monkeypatch.setattr(runner, "config_from_args", short_budgets)
    runner.main(["--video_dir", "v", "--memory_basic_dir", str(tmp_path), "--save_file",
                 str(tmp_path / "s.json"), "--annotations", "a.json", "--multi_modal_memory",
                 "--bf16", "--spec_tokens", "2", "--spec_ngram", "2", "--device", "cpu",
                 "--geometry", "tiny", "--chunk_size", "4", "--num_clusters", "2",
                 "--interval", "3", "--short_window", "6", "--remember_window", "3"])
    (spec_tokens, spec_ngram, stats, res), = ran
    assert (spec_tokens, spec_ngram) == (2, 2) and len(res) == 1
    assert stats["verify_steps"] > 0 and stats["accepted_tokens"] >= stats["verify_steps"]
