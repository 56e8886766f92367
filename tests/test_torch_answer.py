"""The port's answer options against the JAX package's, on the CPU.

Same seeded inputs and weights in both packages, at tiny geometry:
- `ops/retrieval` (cosine scores, top-k, MaxSim) within 1e-6;
  `TextEmbedder.embed_tokens` within 1e-5 with equal masks;
- teacher-forced scoring: `sequence_nll` and
  `LongVA.score_with_image_embedding` within rtol 1e-5 in float32 and 1e-4
  with int8 and int4 decoders (each package quantizing its own copy); an
  empty target scores 0;
- `answer_question_unimodal` token-exact under greedy decoding, with the
  same visual blocks; the multi-modal answer under a `max_visual_tokens`
  budget that drops a level keeps the same blocks and the same tokens;
- `process_video` and `process_video_online` with the uni-modal answer and
  `--ppl` (tree merges on, the same centroids injected into both
  packages' k-means), and `process_video` at `compress_rate` 2: captions
  and answers token for token, the same record keys, and `nll` within rtol
  1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import streamchat_tpu.models.generate_paged as j_generate_paged
import streamchat_tpu.pipeline.runner as j_runner
import streamchat_tpu.pipeline.streaming as j_streaming
from streamchat_tpu import config as jconfig
from streamchat_tpu.memory.bank import MemoryBank as JBank
from streamchat_tpu.memory.tree import VisualMemoryTree as JTree
from streamchat_tpu.models import scoring as jscoring
from streamchat_tpu.models.embedder import TextEmbedder as JEmbedder
from streamchat_tpu.models.longva import LongVA as JLongVA
from streamchat_tpu.ops import retrieval as jretrieval
from streamchat_tpu.pipeline import answer as janswer
from streamchat_tpu.video.reader import SyntheticVideoReader
from streamchat_tpu_torch import config, convert
from streamchat_tpu_torch.memory.bank import MemoryBank
from streamchat_tpu_torch.memory.tree import VisualMemoryTree
from streamchat_tpu_torch.models import longva as port_longva
from streamchat_tpu_torch.models import scoring
from streamchat_tpu_torch.models.embedder import TextEmbedder
from streamchat_tpu_torch.models.tokenizer import ByteTokenizer
from streamchat_tpu_torch.ops import retrieval
from streamchat_tpu_torch.pipeline import answer, runner, streaming
from tests.test_torch_memory import hash_embed
from tests.test_torch_models import port_longva as to_port
from tests.test_torch_pipeline import BREAKPOINTS, _pipelines, _recording

RTOL = {None: 1e-5, 8: 1e-4, 4: 1e-4}


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _models(bits=None):
    """The JAX LongVA at tiny geometry in float32 and the port's copy of its
    weights, each quantized by its own package when bits is 8 or 4."""
    dcfg = jconfig.DecoderConfig.tiny()
    jm = JLongVA.init_random(jax.random.key(0),
                             jconfig.ViTConfig.tiny(projection_dim=dcfg.hidden_size), dcfg,
                             dtype=jnp.float32)
    pm = to_port(jm)
    if bits is not None:
        jm.quantize(bits=bits)
        pm.quantize(bits=bits)
    return jm, pm


# --- ops/retrieval and embed_tokens ------------------------------------------------------

@pytest.mark.parametrize("fn", ["l2_normalize", "cosine_scores", "cosine_topk", "maxsim_score"])
def test_retrieval_matches_jax(fn):
    q, c, docs = _rand(0, 3, 16), _rand(1, 7, 16), _rand(2, 5, 6, 16)
    docs[:, 4:] = 0.0                           # zero-padded document tokens
    if fn == "l2_normalize":
        ref, out = jretrieval.l2_normalize(jnp.asarray(c)), retrieval.l2_normalize(
            torch.from_numpy(c))
    elif fn == "cosine_scores":
        ref = jretrieval.cosine_scores(jnp.asarray(q), jnp.asarray(c))
        out = retrieval.cosine_scores(torch.from_numpy(q), torch.from_numpy(c))
    elif fn == "cosine_topk":
        rs, ri = jretrieval.cosine_topk(jnp.asarray(q), jnp.asarray(c), k=3)
        s, i = retrieval.cosine_topk(torch.from_numpy(q), torch.from_numpy(c), k=3)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
        ref, out = rs, s
    else:
        ref = jretrieval.maxsim_score(jnp.asarray(q), jnp.asarray(docs))
        out = retrieval.maxsim_score(torch.from_numpy(q), torch.from_numpy(docs))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def test_embed_tokens_matches_jax():
    j = JEmbedder.init_random(jax.random.key(3), jconfig.BertConfig.tiny())
    p = TextEmbedder(convert.to_torch(jax.tree.map(np.asarray, j.params)),
                     config.BertConfig(**dataclasses.asdict(j.cfg)), ByteTokenizer(),
                     max_length=j.max_length)
    texts = ["a person walks into the room", "", "cup on a table " * 3]
    jh, jmask = j.embed_tokens(texts)
    ph, pmask = p.embed_tokens(texts)
    assert ph.shape == jh.shape and ph.dtype == torch.float32
    np.testing.assert_array_equal(pmask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), atol=1e-5, rtol=0)


# --- teacher-forced scoring --------------------------------------------------------------

@pytest.mark.parametrize("bits", [None, 8, 4], ids=["f32", "int8", "int4"])
def test_sequence_nll_matches_jax(bits):
    jm, pm = _models(bits)
    d = jm.dec_cfg.hidden_size
    prompt = _rand(4, 1, 256, d, scale=0.5)
    target = np.random.default_rng(5).integers(0, jm.dec_cfg.vocab_size, 19).astype(np.int32)
    for prompt_len in (1, 77, 256):
        ref = jscoring.sequence_nll(jm.dec_params, jm.dec_cfg, jnp.asarray(prompt), prompt_len,
                                    jnp.asarray(target))
        out = scoring.sequence_nll(pm.dec_params, pm.dec_cfg, torch.from_numpy(prompt),
                                   prompt_len, torch.from_numpy(target))
        assert out.dtype == torch.float32 and out.shape == ()
        np.testing.assert_allclose(float(out), float(ref), rtol=RTOL[bits], atol=0)
    logp = scoring.target_logprobs(pm.dec_params, pm.dec_cfg, torch.from_numpy(prompt), 77,
                                   torch.from_numpy(target))
    assert logp.shape == (19,) and bool((logp < 0).all())


def test_sequence_nll_of_an_empty_target_is_zero():
    jm, pm = _models()
    prompt = torch.from_numpy(_rand(6, 1, 128, jm.dec_cfg.hidden_size))
    empty = torch.zeros(0, dtype=torch.int64)
    assert float(scoring.sequence_nll(pm.dec_params, pm.dec_cfg, prompt, 40, empty)) == 0.0
    assert float(jscoring.sequence_nll(jm.dec_params, jm.dec_cfg, jnp.asarray(prompt.numpy()),
                                       40, jnp.zeros((0,), jnp.int32))) == 0.0


@pytest.mark.parametrize("bits", [None, 8, 4], ids=["f32", "int8", "int4"])
def test_score_with_image_embedding_matches_jax(bits):
    jm, pm = _models(bits)
    d = jm.dec_cfg.hidden_size
    blocks = [_rand(7, 48, d), _rand(8, 32, d)]
    prompt = "<|im_start|>user\n<image>\nWhat is on the table?<|im_end|>\n<|im_start|>assistant\n"
    for target in ("a red cup", "", "nothing changed at all"):
        ref = jm.score_with_image_embedding(prompt, target, [[jnp.asarray(b) for b in blocks]])
        out = pm.score_with_image_embedding(prompt, target,
                                            [[torch.from_numpy(b) for b in blocks]])
        assert all(isinstance(x, float) for x in out)
        np.testing.assert_allclose(out, ref, rtol=RTOL[bits], atol=0)
        assert (out == (0.0, 1.0)) is (target == "")


# --- the answers -------------------------------------------------------------------------

def _trees(d, interval=2, chunks=3):
    """The same tree in both packages: `chunks` captioned nodes of [3, 4, d]
    centroids, merged every `interval` (merge: the first 3 rows)."""
    def summarize(caps):
        return "summary of: " + " | ".join(caps)

    jt = JTree(3, interval, hash_embed, summarize, lambda x, k: x[:k])
    pt = VisualMemoryTree(3, interval, lambda t: torch.from_numpy(hash_embed(t)), summarize,
                          lambda x, k: x[:k])
    for i in range(chunks):
        f = _rand(20 + i, 3, 4, d)
        cap = [f"a person walks into room {i} and leaves a cup"]
        jt.add_chunks([jnp.asarray(f)], cap)
        pt.add_chunks([torch.from_numpy(f)], cap)
    return jt, pt


def _recorded(model, sink):
    """The model with generate_with_image_embedding recording each call's
    visual blocks (as numpy)."""
    gen = model.generate_with_image_embedding

    def wrapped(prompt, image_embeddings=None, **kw):
        sink.append([np.asarray(b) for b in image_embeddings[0]])
        return gen(prompt, image_embeddings=image_embeddings, **kw)

    model.generate_with_image_embedding = wrapped
    return model


def _sampling(**kw):
    base = dict(temperature=0.0, max_answer_tokens=8, max_answer_tokens_unimodal=12)
    base.update(kw)
    return jconfig.SamplingConfig(**base), config.SamplingConfig(**base)


def _same_blocks(pblocks, jblocks):
    assert len(pblocks) == len(jblocks)
    for p, j in zip(pblocks, jblocks):
        assert [b.shape for b in p] == [b.shape for b in j]
        for a, b in zip(p, j):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("history", [None, "\nEarlier: the user asked about a cup.\n"])
def test_answer_question_unimodal_token_exact(monkeypatch, history):
    jm, pm = _models()
    d = jm.dec_cfg.hidden_size
    jt, pt = _trees(d)
    assert jt.counts_by_depth() == pt.counts_by_depth() == {1: 1, 0: 1}
    short = _rand(30, 2, 4, d)
    jtoks, ptoks, jblocks, pblocks = [], [], [], []
    monkeypatch.setattr(j_generate_paged, "generate_paged_fetch",
                        _recording(j_generate_paged.generate_paged_fetch, jtoks))
    monkeypatch.setattr(port_longva, "generate_paged", _recording(port_longva.generate_paged,
                                                                  ptoks))
    js, ps = _sampling()
    for target in (None, "a cup"):
        jr = janswer.answer_question_unimodal("Where is the cup?", _recorded(jm, jblocks),
                                              jnp.asarray(short), jt, history, js,
                                              ppl_target=target)
        pr = answer.answer_question_unimodal("Where is the cup?", _recorded(pm, pblocks),
                                             torch.from_numpy(short), pt, history, ps,
                                             ppl_target=target)
        assert pr.output == jr.output and pr.timings is None and jr.timings is None
        if target is None:
            assert pr.nll is pr.ppl is None
        else:
            np.testing.assert_allclose([pr.nll, pr.ppl], [jr.nll, jr.ppl], rtol=1e-5)
    assert ptoks == jtoks and len(ptoks) == 2 and len(ptoks[0]) > 0
    _same_blocks(pblocks, jblocks)
    # Short memory, then the summarized root's centroids and its leaf.
    assert [b.shape[0] for b in pblocks[0]] == [8, 12, 12]


@pytest.mark.parametrize("budget,kept", [(None, [8, 12, 12]), (20, [8, 12]), (8, [8, 12]),
                                         (32, [8, 12, 12])])
def test_max_visual_tokens_keeps_the_same_blocks_as_jax(monkeypatch, budget, kept):
    """The multi-modal answer's path is [a root's child, the best leftover
    leaf]; a budget drops the coarsest levels first, and short memory and
    the finest level always survive."""
    jm, pm = _models()
    d = jm.dec_cfg.hidden_size
    jt, pt = _trees(d, chunks=3)
    short = _rand(31, 2, 4, d)
    jtoks, ptoks, jblocks, pblocks = [], [], [], []
    monkeypatch.setattr(j_generate_paged, "generate_paged_fetch",
                        _recording(j_generate_paged.generate_paged_fetch, jtoks))
    monkeypatch.setattr(port_longva, "generate_paged", _recording(port_longva.generate_paged,
                                                                  ptoks))
    js, ps = _sampling(max_visual_tokens=budget)
    q = "Who walked into the room?"
    jr = janswer.answer_question(q, _recorded(jm, jblocks), lambda t: jnp.asarray(
        hash_embed([t])[0]), jnp.asarray(short), jt, None, js)
    pr = answer.answer_question(q, _recorded(pm, pblocks), lambda t: torch.from_numpy(
        hash_embed([t])[0]), torch.from_numpy(short), pt, None, ps)
    assert pr.output == jr.output and ptoks == jtoks and len(ptoks[0]) > 0
    _same_blocks(pblocks, jblocks)
    assert [b.shape[0] for b in pblocks[0]] == kept
    assert set(pr.timings) == set(jr.timings) == {"embed_query_s", "tree_search_s",
                                                   "assemble_s"}


# --- the pipeline ------------------------------------------------------------------------

def _merge_by_blend(monkeypatch):
    """Tree merges on, with the same centroids (a fixed blend of the merged
    rows) in both packages' k-means."""
    def j_kmeans(x, k, key):
        return x[:k] * 0.5 + x[-k:] * 0.5, None

    def p_kmeans(x, k, *, generator=None):
        return x[:k] * 0.5 + x[-k:] * 0.5, None

    for mod in (j_streaming, j_runner):
        monkeypatch.setattr(mod, "weighted_kmeans_feature", j_kmeans)
    for mod in (streaming, runner):
        monkeypatch.setattr(mod, "weighted_kmeans_feature", p_kmeans)


def _run_both(tmp_path, monkeypatch, online=False, **changes):
    """Both pipelines of test_torch_pipeline with PipelineConfig fields
    (`memory` as a dict of MemoryConfig fields) changed -> (port records,
    JAX records, port pipeline, the port's generated tokens)."""
    jp, pp = _pipelines()
    memory = changes.pop("memory", {})
    for p in (jp, pp):
        p.cfg = p.cfg.replace(memory=dataclasses.replace(p.cfg.memory, **memory),
                              sampling=dataclasses.replace(p.cfg.sampling,
                                                           max_answer_tokens_unimodal=10),
                              **changes)
    jtoks, ptoks = [], []
    monkeypatch.setattr(j_generate_paged, "generate_paged_fetch",
                        _recording(j_generate_paged.generate_paged_fetch, jtoks))
    monkeypatch.setattr(port_longva, "generate_paged", _recording(port_longva.generate_paged,
                                                                  ptoks))

    def reader():
        return SyntheticVideoReader(total_frames=150, frame_rate=30, height=56, width=56)

    jres = (jp.process_video_online if online else jp.process_video)(
        reader(), BREAKPOINTS, JBank(str(tmp_path / "j.json"),
                                     lambda t: jp.bank_embedder.embed(t)), user_name="User")
    pres = (pp.process_video_online if online else pp.process_video)(
        reader(), BREAKPOINTS, MemoryBank(str(tmp_path / "p.json"), pp.bank_embed),
        user_name="User")
    assert len(pres) == len(jres) == len(BREAKPOINTS)
    assert ptoks == jtoks and sum(map(len, ptoks)) > 0
    for p, j in zip(pres, jres):
        assert set(p) == set(j)
        for field in ("time", "question", "label", "predict", "class"):
            assert p[field] == j[field], field
    assert [n.text for n in pp.last_tree.all_nodes()] == [
        n.text for n in jp.last_tree.all_nodes()]
    return pres, jres, pp, ptoks


@pytest.mark.parametrize("online", [False, True], ids=["off_line", "on_line"])
def test_unimodal_ppl_pipeline_matches_jax(tmp_path, monkeypatch, online):
    """multi_modal_memory=False, ppl=True, interval 2: the answers search a
    summarized tree in feature space, and every record carries nll / ppl."""
    _merge_by_blend(monkeypatch)
    searched = []
    walk = VisualMemoryTree._feature_walk

    def counting(self, q):
        out = walk(self, q)
        searched.append(len(out[0]))
        return out

    monkeypatch.setattr(VisualMemoryTree, "_feature_walk", counting)
    pres, jres, pp, _ = _run_both(tmp_path, monkeypatch, online=online,
                                  multi_modal_memory=False, ppl=True,
                                  memory=dict(interval=2))
    assert any(n.depth > 1 for n in pp.last_tree.roots)
    assert len(searched) == len(BREAKPOINTS) and max(searched) >= 3
    for p, j in zip(pres, jres):
        assert {"nll", "ppl"} <= set(p)
        np.testing.assert_allclose([p["nll"], p["ppl"]], [j["nll"], j["ppl"]], rtol=1e-4)
    if not online:
        assert not any(k.endswith("_s") for k in pp.last_phase_totals)


def test_compress_rate_2_pipeline_matches_jax(tmp_path, monkeypatch):
    """compress_rate 2 pools the tiny tower's 4 x 4 patch grid to 2 x 2:
    every node and the short memory hold 4 tokens a frame."""
    pres, _, pp, _ = _run_both(tmp_path, monkeypatch, memory=dict(compress_rate=2))
    assert {n.centroids.shape[1] for n in pp.last_tree.all_nodes()} == {4}
    assert "nll" not in pres[0]
    assert {"answer.embed_query_s", "answer.tree_search_s", "answer.assemble_s"} <= set(
        pp.last_phase_totals)
