"""The port's memory path and copied modules against the JAX package's.

Draws from jax.random cannot be reproduced by torch generators, so the
stochastic steps take injected noise: the Gumbel noise of short-memory
selection, and the k-means++ initial centroids and repair indices. The
copied pure-Python modules (config, video reader, tokenizer, prompts,
dialogue bank) are held equal to their originals over a set of inputs.
"""

import dataclasses
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamchat_tpu import config as jconfig
from streamchat_tpu.memory import bank as jbank
from streamchat_tpu.memory.tree import VisualMemoryTree as JTree
from streamchat_tpu.models import tokenizer as jtok
from streamchat_tpu.ops import forgetting as jforget
from streamchat_tpu.pipeline import prompts as jprompts
from streamchat_tpu.video import reader as jreader
from streamchat_tpu_torch import config
from streamchat_tpu_torch.memory import bank
from streamchat_tpu_torch.memory.tree import VisualMemoryTree
from streamchat_tpu_torch.models import tokenizer
from streamchat_tpu_torch.ops import forgetting, kmeans
from streamchat_tpu_torch.pipeline import prompts
from streamchat_tpu_torch.video import reader

# `streamchat_tpu.ops` re-exports a function named `kmeans`, which shadows the
# submodule as an attribute.
jkmeans = importlib.import_module("streamchat_tpu.ops.kmeans")


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def hash_embed(texts):
    """Deterministic stand-in embedder: bag of character-bigram hashes."""
    out = np.zeros((len(texts), 32), np.float32)
    for i, t in enumerate(texts):
        for a, b in zip(t, t[1:]):
            out[i, (ord(a) * 31 + ord(b)) % 32] += 1.0
        if not t:
            out[i, 0] = 1.0
    return out


@pytest.mark.parametrize("length,tau", [(5, 5.0), (20, 5.0), (7, 10.0)])
def test_forgetting_probabilities_equal(length, tau):
    ref = jforget.forgetting_probabilities(length, tau)
    out = forgetting.forgetting_probabilities(length, tau)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-7, rtol=0)


@pytest.mark.parametrize("w,r,seed", [(20, 5, 0), (12, 3, 1), (6, 5, 2)])
def test_select_short_memory_with_injected_gumbel(w, r, seed):
    key = jax.random.key(seed)
    feats = _rand(seed, w, 4, 8)
    ref = jforget.select_short_memory(key, jnp.asarray(feats), r, 5.0)
    gumbel = np.array(jax.random.gumbel(key, (w,)))       # the draw JAX makes
    out = forgetting.select_short_memory(torch.from_numpy(feats), r, 5.0,
                                         gumbel=torch.from_numpy(gumbel))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("t,k,seed", [(40, 5, 0), (12, 3, 1), (9, 4, 2)])
def test_weighted_kmeans_with_injected_init_and_repair(t, k, seed):
    key = jax.random.key(seed)
    x = _rand(seed, t, 24)
    w = np.abs(_rand(seed + 10, t)) + 0.1
    ref_c, ref_labels, ref_w = jkmeans.weighted_kmeans(
        jnp.asarray(x), jnp.asarray(w), key, num_clusters=k)
    init_key, repair_key = jax.random.split(key)
    c0 = np.array(jkmeans._kmeans_plus_plus_init(jnp.asarray(x), jnp.asarray(w),
                                                   init_key, k))
    repair = np.array(jax.random.randint(repair_key, (10, k), 0, t))
    c, labels, cw = kmeans.weighted_kmeans(
        torch.from_numpy(x), torch.from_numpy(w), num_clusters=k,
        init_centroids=torch.from_numpy(c0), repair_idx=torch.from_numpy(repair))
    np.testing.assert_allclose(c.numpy(), np.asarray(ref_c), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref_labels))
    np.testing.assert_allclose(cw.numpy(), np.asarray(ref_w), atol=1e-5, rtol=0)


def test_weighted_kmeans_repairs_an_empty_cluster():
    """A duplicated initial centroid leaves one cluster empty: it takes the
    pre-drawn repair point, as in the JAX package's Lloyd step."""
    x = np.concatenate([_rand(0, 6, 4), _rand(1, 6, 4) + 10.0])
    init = np.stack([x[0], x[0], x[7]])
    repair = np.tile(np.asarray([[0, 3, 0]]), (10, 1))
    c, labels, cw = kmeans.weighted_kmeans(
        torch.from_numpy(x), torch.ones(12), num_clusters=3,
        init_centroids=torch.from_numpy(init), repair_idx=torch.from_numpy(repair),
        num_iters=1)
    np.testing.assert_allclose(c[1].numpy(), x[3])            # repaired
    assert cw[1] == 0 and cw.sum() == 12


def test_kmeans_feature_passthrough_and_shape():
    feats = torch.from_numpy(_rand(3, 4, 6, 8))
    out, labels = kmeans.weighted_kmeans_feature(feats, 5)
    assert out is feats and labels.tolist() == [0, 1, 2, 3]
    out, labels = kmeans.weighted_kmeans_feature(
        torch.from_numpy(_rand(4, 10, 6, 8)), 3, generator=torch.Generator().manual_seed(0))
    assert out.shape == (3, 6, 8) and labels.shape == (10,)


def _grow_both(interval, chunks):
    def jmerge(combined, k):
        return combined[:k]

    jt = JTree(num_clusters=2, interval=interval, embed_fn=hash_embed,
               summarize_fn=lambda caps: "summary of: " + " | ".join(caps),
               merge_fn=jmerge)
    pt = VisualMemoryTree(num_clusters=2, interval=interval,
                          embed_fn=lambda texts: torch.from_numpy(hash_embed(texts)),
                          summarize_fn=lambda caps: "summary of: " + " | ".join(caps),
                          merge_fn=lambda combined, k: combined[:k])
    for i, batch in enumerate(chunks):
        feats = [_rand(100 * i + j, 3, 4, 8) for j in range(len(batch))]
        jt.add_chunks([jnp.asarray(f) for f in feats], batch)
        pt.add_chunks([torch.from_numpy(f) for f in feats], batch)
    return jt, pt


def _shape(nodes):
    return [(n.depth, n.text, _shape(n.children)) for n in nodes]


@pytest.mark.parametrize("interval", [2, 3])
def test_tree_build_merge_and_search_match_jax(interval):
    captions = [[f"a person walks into room {i}", f"cup number {i} on a table"]
                for i in range(6)]
    jt, pt = _grow_both(interval, captions)
    assert _shape(pt.roots) == _shape(jt.roots)
    assert len(pt) == len(jt) and pt.counts_by_depth() == jt.counts_by_depth()
    for q in ["where is the cup?", "who walked into the room", "zzz"]:
        qe = hash_embed([q])[0]
        jf, jtexts = jt.search(jnp.asarray(qe))
        pf, ptexts = pt.search(torch.from_numpy(qe))
        assert ptexts == jtexts
        for a, b in zip(pf, jf):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", ["MemoryConfig", "SamplingConfig", "VideoConfig",
                                  "RetrievalConfig", "ModelPaths", "ParallelConfig",
                                  "PipelineConfig", "ViTConfig", "DecoderConfig",
                                  "BertConfig"])
def test_config_copy_matches(name):
    ours, theirs = getattr(config, name), getattr(jconfig, name)
    assert ([(f.name, f.type) for f in dataclasses.fields(ours)]
            == [(f.name, f.type) for f in dataclasses.fields(theirs)])
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())
    for ctor in ("tiny", "qwen2_7b", "llama3_8b", "mxbai_colbert_large", "minilm_l6"):
        if hasattr(theirs, ctor):
            assert dataclasses.asdict(getattr(ours, ctor)()) == \
                dataclasses.asdict(getattr(theirs, ctor)())


@pytest.mark.parametrize("args", [(0, 10, 30.0, 600, 0.2, 40), (3, 4, 30.0, 600, 0.2, 40),
                                  (0, 40, 30.0, 1200, 1.0, 20), (5, 5, 25.0, 100, 0.5, 4)])
def test_video_reader_copy_matches(args):
    assert reader.sample_frame_indices(*args) == jreader.sample_frame_indices(*args)
    ours = reader.SyntheticVideoReader(total_frames=90, height=12, width=20, seed=3)
    theirs = jreader.SyntheticVideoReader(total_frames=90, height=12, width=20, seed=3)
    idx = jreader.sample_frame_indices(*args)[:8]
    np.testing.assert_array_equal(ours.read_frames(idx), theirs.read_frames(idx))


@pytest.mark.parametrize("text", ["", "plain ascii", "café ☕", "<image>\nhi <image>"])
def test_tokenizer_copy_matches(text):
    ours, theirs = tokenizer.ByteTokenizer(), jtok.ByteTokenizer()
    assert ours.encode(text) == theirs.encode(text)
    assert ours.decode(ours.encode(text) + [300, 257]) == theirs.decode(
        theirs.encode(text) + [300, 257])
    assert (tokenizer.tokenize_with_image_token(text, ours)
            == jtok.tokenize_with_image_token(text, theirs))
    assert ours.eos_ids == theirs.eos_ids


@pytest.mark.parametrize("history,fine", [(None, None), ("\n  past turn\n", None),
                                          ("\n  past turn\n", "a cup on a desk")])
def test_prompts_copy_matches(history, fine):
    q = "What is on the table?"
    assert (prompts.build_answer_prompt(q, history, fine)
            == jprompts.build_answer_prompt(q, history, fine))
    for mode in jprompts.CONV_TEMPLATES:
        assert prompts.wrap_user_turn(mode, q) == jprompts.wrap_user_turn(mode, q)
    assert prompts.build_caption_prompt() == jprompts.build_caption_prompt()
    caps = ["first caption", "second", "third one"]
    assert prompts.build_summary_prompt(caps) == jprompts.build_summary_prompt(caps)
    assert (prompts.build_history_prompt(history) == jprompts.build_history_prompt(history))


def test_bank_copy_matches(tmp_path):
    turns = [("what is here?", "a cup"), ("and there?", "a red chair near the door"),
             ("where are my keys?", "on the shelf")]
    banks = []
    for mod, name in ((jbank, "j.json"), (bank, "p.json")):
        b = mod.MemoryBank(str(tmp_path / name), hash_embed, top_k=2)
        assert b.enter_name("User") is None
        for i, (q, r) in enumerate(turns):
            b.save_local_memory("User", q, r, date=f"2024-01-0{1 + i % 2}")
        banks.append(b)
    jb, pb = banks
    assert json.load(open(tmp_path / "p.json")) == json.load(open(tmp_path / "j.json"))
    ji, pi = jb.enter_name("User"), pb.enter_name("User")
    for q in ["keys", "cup", "chair by the door"]:
        assert pi.search_memory(q) == ji.search_memory(q)


def test_bank_cache_keeps_hits_at_the_bound():
    """At the 4096-entry bound the JAX package evicts before it builds the
    return list, so a hit it just trimmed raises KeyError; the port's copy
    collects the rows first."""
    def fill():
        cache = {f"t{i}": np.zeros(32, np.float32) for i in range(4096)}
        return cache

    texts = ["t0", "a brand new text"]
    with pytest.raises(KeyError):
        jbank.embed_into_cache(hash_embed, fill(), texts)
    cache = fill()
    rows = bank.embed_into_cache(hash_embed, cache, texts)
    assert len(rows) == 2 and len(cache) == 4096
    np.testing.assert_array_equal(rows[1], hash_embed(["a brand new text"])[0])


# --- MaxSim, feature search, the one-shot builders, pooling ------------------------------

def hash_embed_tokens(texts):
    """Deterministic stand-in token embedder: one hash row per character
    bigram, zero-padded to the longest text -> ([N, S, 16], mask [N, S])."""
    s = max([len(t) - 1 for t in texts] + [1])
    out = np.zeros((len(texts), s, 16), np.float32)
    mask = np.zeros((len(texts), s), np.int64)
    for i, t in enumerate(texts):
        for j, (a, b) in enumerate(zip(t, t[1:])):
            out[i, j, (ord(a) * 7 + ord(b)) % 16] = 1.0
            out[i, j, ord(b) % 16] -= 0.5
            mask[i, j] = 1
    return out, mask


def _both_trees(interval=2, chunks=5, tokens=True, d=8):
    def summarize(caps):
        return "summary of: " + " | ".join(caps)

    def p_tokens(texts):
        h, m = hash_embed_tokens(texts)
        return torch.from_numpy(h), torch.from_numpy(m)

    jt = JTree(2, interval, hash_embed, summarize, lambda x, k: x[:k],
               embed_tokens_fn=hash_embed_tokens if tokens else None)
    pt = VisualMemoryTree(2, interval, lambda t: torch.from_numpy(hash_embed(t)), summarize,
                          lambda x, k: x[:k], embed_tokens_fn=p_tokens if tokens else None)
    for i in range(chunks):
        f = _rand(200 + i, 2, 4, d)
        cap = [f"the person {'sits' if i % 2 else 'walks'} by table {i}"]
        jt.add_chunks([jnp.asarray(f)], cap)
        pt.add_chunks([torch.from_numpy(f)], cap)
    return jt, pt


def _same_path(pf, jf):
    assert len(pf) == len(jf)
    for a, b in zip(pf, jf):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("interval,chunks", [(2, 5), (3, 7)])
def test_search_maxsim_matches_jax(interval, chunks):
    jt, pt = _both_trees(interval, chunks)
    for pn, jn in zip(pt.all_nodes(), jt.all_nodes()):
        np.testing.assert_array_equal(pn.token_emb, jn.token_emb)
    for q in ["where does the person sit?", "table 3", "zz"]:
        qh, qm = hash_embed_tokens([q])
        qtok = qh[0][qm[0] > 0]
        jf, jtexts = jt.search_maxsim(jnp.asarray(qtok))
        pf, ptexts = pt.search_maxsim(torch.from_numpy(qtok))
        assert ptexts == jtexts and len(ptexts) >= 2
        _same_path(pf, jf)


def test_search_maxsim_needs_token_embeddings():
    _, pt = _both_trees(tokens=False)
    assert all(n.token_emb is None for n in pt.all_nodes())
    with pytest.raises(ValueError, match="embed_tokens_fn"):
        pt.search_maxsim(torch.ones(3, 16))


@pytest.mark.parametrize("interval,chunks,seed", [(2, 5, 0), (2, 4, 1), (3, 7, 2)])
def test_search_features_matches_jax(interval, chunks, seed):
    """Depth-0 roots are skipped; each summarized root emits its centroids
    and each visited child's, down to a leaf."""
    jt, pt = _both_trees(interval, chunks, tokens=False)
    q = _rand(300 + seed, 5, 8)
    jf = jt.search_features(jnp.asarray(q))
    pf = pt.search_features(torch.from_numpy(q))
    _same_path(pf, jf)
    summarized = [r for r in pt.roots if r.depth > 0]
    assert len(pf) == sum(r.depth + 1 for r in summarized) and len(pf) > 0
    path, levels = pt._feature_walk(torch.from_numpy(q))
    assert len(levels) == len(pf) - len(summarized)
    assert all(s.dtype == np.float32 for s in levels)


def test_search_features_skips_a_tree_without_summaries():
    jt, pt = _both_trees(interval=4, chunks=3, tokens=False)
    assert pt.search_features(torch.ones(2, 8)) == [] == jt.search_features(jnp.ones((2, 8)))


@pytest.mark.parametrize("n,interval,with_text", [(5, 2, True), (7, 3, False), (4, 2, False)])
def test_build_bottom_up_matches_jax(n, interval, with_text):
    feats = [_rand(400 + i, 2, 4, 8) for i in range(n)]
    caps = [f"clip {i}: a cup moves" for i in range(n)] if with_text else None

    def summarize(c):
        return "sum(" + ",".join(c) + ")"

    def merge(x, k):
        return x[:k] * 0.5 + x[-k:] * 0.5

    jt = JTree.build_bottom_up([jnp.asarray(f) for f in feats], 3, interval, merge, caps,
                               summarize if with_text else None,
                               hash_embed if with_text else None)
    pt = VisualMemoryTree.build_bottom_up(
        [torch.from_numpy(f) for f in feats], 3, interval, merge, caps,
        summarize if with_text else None,
        (lambda t: torch.from_numpy(hash_embed(t))) if with_text else None)
    assert len(pt) == len(jt) == 1
    assert _shape(pt.roots) == _shape(jt.roots)
    for a, b in zip(pt.all_nodes(), jt.all_nodes()):
        np.testing.assert_allclose(a.centroids.numpy(), np.asarray(b.centroids), atol=1e-6,
                                   rtol=0)
        assert (a.emb is None) == (b.emb is None)
        if a.emb is not None:
            np.testing.assert_array_equal(a.emb, b.emb)
    q = _rand(450, 3, 8)
    _same_path(pt.search_features(torch.from_numpy(q)), jt.search_features(jnp.asarray(q)))
    if with_text:
        qe = hash_embed(["a cup"])[0]
        pf, ptexts = pt.search(torch.from_numpy(qe))
        jf, jtexts = jt.search(jnp.asarray(qe))
        assert ptexts == jtexts
        _same_path(pf, jf)
    with pytest.raises(ValueError, match="summarize_fn"):
        VisualMemoryTree.build_bottom_up([torch.ones(1, 4, 8)], 3, 2, merge, ["c"])


@pytest.mark.parametrize("n,chunk,rate", [(10, 4, 1), (9, 3, 2), (5, 8, 2)])
def test_build_top_down_matches_jax(n, chunk, rate):
    feats = _rand(500 + n, n, 16, 8)

    def merge(x, k):
        return x[:k] * 0.25 + x[-k:] * 0.75

    jt = JTree.build_top_down(jnp.asarray(feats), chunk, 2, merge, compress_rate=rate)
    pt = VisualMemoryTree.build_top_down(torch.from_numpy(feats), chunk, 2, merge,
                                         compress_rate=rate)
    assert len(pt) == len(jt) == -(-n // chunk) and pt.interval == jt.interval
    for a, b in zip(pt.roots, jt.roots):
        assert a.depth == b.depth == 0 and a.text == b.text == ""
        assert a.centroids.shape[1] == 16 // rate ** 2
        np.testing.assert_allclose(a.centroids.numpy(), np.asarray(b.centroids), atol=1e-6,
                                   rtol=0)


def test_tree_state_round_trips_token_embeddings():
    jt, pt = _both_trees()
    state = pt.to_state()
    jstate = jt.to_state()

    def tokens(s):
        out = []

        def walk(d):
            out.append(d["token_emb"])
            for c in d["children"]:
                walk(c)

        for r in s["roots"]:
            walk(r)
        return out

    for a, b in zip(tokens(state), tokens(jstate)):
        assert isinstance(a, np.ndarray)
        np.testing.assert_array_equal(a, b)
    back = VisualMemoryTree.from_state(state, 2, 2, None, None, None,
                                       embed_tokens_fn=pt._embed_tokens)
    assert back._embed_tokens is pt._embed_tokens
    for a, b in zip(back.all_nodes(), pt.all_nodes()):
        np.testing.assert_array_equal(a.token_emb, b.token_emb)
        assert torch.equal(a.centroids, b.centroids)
    qh, qm = hash_embed_tokens(["the person sits"])
    q = torch.from_numpy(qh[0][qm[0] > 0])
    assert back.search_maxsim(q)[1] == pt.search_maxsim(q)[1]


@pytest.mark.parametrize("shape,rate,mode", [((3, 16, 5), 2, "average"), ((3, 16, 5), 4, "max"),
                                             ((2, 36, 4), 3, "average"), ((2, 36, 4), 2, "max"),
                                             ((2, 9, 3), 1, "average")])
def test_pool_patch_grid_matches_jax(shape, rate, mode):
    jpool = importlib.import_module("streamchat_tpu.ops.pooling")
    from streamchat_tpu_torch.ops import pooling

    x = _rand(600 + rate, *shape)
    ref = jpool.pool_patch_grid(jnp.asarray(x), rate, mode=mode)
    out = pooling.pool_patch_grid(torch.from_numpy(x), rate, mode=mode)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    if mode == "average":
        np.testing.assert_allclose(
            pooling.compress_spatial_features(torch.from_numpy(x), rate).numpy(),
            np.asarray(jpool.compress_spatial_features(jnp.asarray(x), rate)), atol=1e-6)


@pytest.mark.parametrize("shape,rate,mode,match", [((1, 15, 2), 2, "average", "perfect square"),
                                                   ((1, 16, 2), 3, "average", "divisible"),
                                                   ((1, 16, 2), 2, "min", "unknown pool")])
def test_pool_patch_grid_refuses_as_jax(shape, rate, mode, match):
    jpool = importlib.import_module("streamchat_tpu.ops.pooling")
    from streamchat_tpu_torch.ops import pooling

    with pytest.raises(ValueError, match=match):
        jpool.pool_patch_grid(jnp.zeros(shape), rate, mode=mode)
    with pytest.raises(ValueError, match=match):
        pooling.pool_patch_grid(torch.zeros(shape), rate, mode=mode)


def test_summarize_copy_matches(tmp_path):
    from streamchat_tpu.memory import summarize as jsummarize
    from streamchat_tpu_torch.memory import summarize

    history = {"2024-01-01": [{"query": " what is here? ", "response": "a cup "}],
               "2024-01-02": [{"query": "and there?", "response": "a chair"},
                              {"query": "keys?", "response": "on the shelf"}]}

    def memory():
        return {"User": {"name": "User", "history": json.loads(json.dumps(history)),
                         "summary": {"2024-01-01": {"content": "kept"}}},
                "Other": {"name": "Other"}}

    def generate(prompt):
        return f"<{len(prompt)}:{prompt[-12:]}>"

    outs = []
    for mod, name in ((jsummarize, "j.json"), (summarize, "p.json")):
        out = mod.summarize_memory(memory(), generate, memory_path=str(tmp_path / name))
        outs.append(out)
        assert mod.summarize_memory(memory(), generate, name="Nobody") == memory()
    assert outs[0] == outs[1]
    assert (tmp_path / "p.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    turns = history["2024-01-02"]
    for fn in ("summarize_content_prompt", "summarize_person_prompt"):
        assert getattr(summarize, fn)(turns, "User") == getattr(jsummarize, fn)(turns, "User")
    assert (summarize.summarize_overall_prompt([("d", {"content": " x "})])
            == jsummarize.summarize_overall_prompt([("d", {"content": " x "})]))
    assert (summarize.summarize_overall_personality([("d", " y ")])
            == jsummarize.summarize_overall_personality([("d", " y ")]))
