"""The on-line mode of the port (`--mode on_line`) against the JAX package's.

- The streaming session: the JAX package's session tests
  (tests/test_streaming.py) on the port's `StreamingSession`, plus
  `all_nodes`, the short-term FIFO and the worker's error path.
- Tree persistence: `to_state` / `from_state` round-trip every node bit for
  bit (bf16 centroids included, through pickle), and the state equals the
  JAX package's for the same tree.
- Slice parity: both packages run `process_video_online` at tiny geometry
  from the same float32 weights, greedy, with settings under which nothing
  draws random numbers (short_window == remember_window, chunk_size <=
  num_clusters or `cluster_full_chunks=False`, fewer than `interval` tree
  nodes): captions and answers token for token, the records field by field,
  the tree texts, and centroids within 1e-4. Also with `dedup_threshold` set
  so that K12's keep mask drops some frames, and with k-means, tree merges
  and short-term sampling on, the same centroids and indices injected into
  both packages' modules.
- The port's on-line and off-line modes answer the first breakpoint alike.
"""

import dataclasses
import pickle
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import streamchat_tpu.memory.short_term as j_short_term
import streamchat_tpu.models.generate_paged as j_generate_paged
import streamchat_tpu.pipeline.runner as j_runner
import streamchat_tpu.pipeline.streaming as j_streaming
from streamchat_tpu.memory.bank import MemoryBank as JBank
from streamchat_tpu.memory.tree import VisualMemoryTree as JTree
from streamchat_tpu.video.reader import SyntheticVideoReader
from streamchat_tpu_torch.config import MemoryConfig, PipelineConfig, SamplingConfig, VideoConfig
from streamchat_tpu_torch.memory import short_term
from streamchat_tpu_torch.memory.bank import MemoryBank
from streamchat_tpu_torch.memory.tree import VisualMemoryTree
from streamchat_tpu_torch.models import longva as port_longva
from streamchat_tpu_torch.ops.kmeans import weighted_kmeans_feature
from streamchat_tpu_torch.pipeline import runner, streaming
from streamchat_tpu_torch.pipeline.streaming import StreamingSession
from tests.test_torch_pipeline import BREAKPOINTS, _pipelines, _recording


def hash_embed(texts):
    out = np.zeros((len(texts), 16), np.float32)
    for i, t in enumerate(texts):
        for a, b in zip(t, t[1:]):
            out[i, (ord(a) * 31 + ord(b)) % 16] += 1.0
        if not t:
            out[i, 0] = 1.0
    return out


def _feats(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32))


def make_session(chunk_size=4, num_clusters=2, interval=2, caption=None):
    g = torch.Generator().manual_seed(0)

    def merge(x, k):
        return weighted_kmeans_feature(x, k, generator=g)[0]

    tree = VisualMemoryTree(num_clusters, interval, hash_embed,
                            lambda caps: "summary: " + "|".join(caps), merge)
    cfg = MemoryConfig(chunk_size=chunk_size, num_clusters=num_clusters, interval=interval,
                       short_window=6, remember_window=3, tau=5.0)
    return StreamingSession(tree, caption or (lambda c: f"mock caption {c.shape[0]}"), cfg,
                            torch.Generator().manual_seed(1))


# --- the session ------------------------------------------------------------------

def test_incremental_tree_growth_under_streaming():
    sess = make_session(chunk_size=4, interval=2)
    feats = _feats(2, 20, 4, 8)
    for i in range(0, 20, 3):                    # small irregular pushes
        sess.push(feats[i: i + 3])
        time.sleep(0.002)
    sess.sync()
    counts = sess.tree.counts_by_depth()         # 5 full chunks, interval 2
    assert sum(counts.values()) >= 2
    assert max(counts) >= 1
    sess.close()


def test_ask_sees_all_pushed_chunks():
    captured = {}

    def answer(short, tree):
        captured["short"] = short
        captured["nodes"] = len(tree.all_nodes())
        return "answer"

    sess = make_session(chunk_size=4, interval=3)
    sess.push(_feats(3, 8, 4, 8))
    assert sess.ask(answer) == "answer"
    assert captured["short"].shape == (3, 4, 8)
    assert captured["nodes"] == 2                # two full chunks -> two leaves
    sess.close()


def test_flush_handles_partial_tail():
    sess = make_session(chunk_size=4, interval=3)
    sess.push(_feats(4, 6, 4, 8))
    sess.flush()
    sess.sync()
    assert sum(sess.tree.counts_by_depth().values()) == 2    # 4 frames + a 2-frame tail
    assert [n.centroids.shape[0] for n in sess.tree.all_nodes()] == [2, 2]
    sess.close()


def test_worker_error_surfaces_on_sync_ask_and_close():
    def bad_caption(chunk):
        raise RuntimeError("captioner exploded")

    sess = make_session(caption=bad_caption)
    sess.push(_feats(5, 4, 4, 8))
    with pytest.raises(RuntimeError, match="captioner exploded"):
        sess.sync()
    sess.push(_feats(6, 4, 4, 8))
    with pytest.raises(RuntimeError, match="captioner exploded"):
        sess.ask(lambda s, t: "never")
    sess.push(_feats(7, 4, 4, 8))
    with pytest.raises(RuntimeError, match="captioner exploded"):
        sess.close()
    assert not sess._worker.is_alive()           # close() stops the worker all the same


def test_concurrent_push_and_ask_race():
    """Push from one thread and ask from another: the tree stays consistent
    and the node count seen by the asks never goes down."""
    sess = make_session(chunk_size=2, interval=4)
    feats = _feats(6, 40, 2, 4)
    errors, answers = [], []
    sess.push(feats[:2])

    def producer():
        try:
            for i in range(2, 40, 2):
                sess.push(feats[i: i + 2])
        except BaseException as e:
            errors.append(e)

    def consumer():
        try:
            for _ in range(5):
                answers.append(sess.ask(lambda s, t: len(t.all_nodes())))
        except BaseException as e:
            errors.append(e)

    tp, tc = threading.Thread(target=producer), threading.Thread(target=consumer)
    tp.start(); tc.start(); tp.join(); tc.join()
    sess.sync()
    assert not errors
    assert answers == sorted(answers)
    assert len(sess.tree.all_nodes()) >= 20 // 2
    sess.close()


def test_all_nodes_walks_each_root_then_its_subtree():
    sess = make_session(chunk_size=2, num_clusters=2, interval=2)
    sess.push(_feats(8, 10, 2, 4))
    sess.sync()
    nodes = sess.tree.all_nodes()
    expect = []

    def walk(n):
        expect.append(n)
        for c in n.children:
            walk(c)

    for r in sess.tree.roots:
        walk(r)
    assert [id(n) for n in nodes] == [id(n) for n in expect]
    assert any(n.depth > 0 for n in nodes) and len(nodes) > len(sess.tree.roots)
    sess.close()


def test_short_term_fifo_keeps_the_last_window():
    mem = short_term.ShortTermMemory(short_window=4, remember_window=2, tau=5.0)
    with pytest.raises(ValueError, match="empty"):
        mem.sample()
    x = _feats(9, 6, 3, 2)
    mem.extend(x[:1])
    assert torch.equal(mem.sample(), x[:1])          # fewer than remember_window
    mem.extend(x[1:])
    assert len(mem) == 4 and torch.equal(torch.stack(mem.features()), x[2:])
    got = mem.sample(torch.Generator().manual_seed(0))
    assert got.shape == (2, 3, 2)
    rows = [next(i for i in range(2, 6) if torch.equal(x[i], g)) for g in got]
    assert rows == sorted(rows)                       # temporal order
    with pytest.raises(ValueError, match="remember_window"):
        short_term.ShortTermMemory(short_window=2, remember_window=3, tau=5.0)


# --- tree persistence ---------------------------------------------------------------

def _grow(tree_cls, to_array, merge):
    tree = tree_cls(2, 2, hash_embed, lambda caps: "summary: " + "|".join(caps), merge)
    x = np.random.default_rng(10).standard_normal((12, 3, 4)).astype(np.float32)
    for i in range(0, 12, 2):
        tree.add_chunks([to_array(x[i: i + 2])], [f"chunk {i}"])
    return tree


def test_tree_state_round_trip_and_matches_jax():
    port = _grow(VisualMemoryTree, torch.from_numpy, lambda c, k: c[:k] * 0.5 + c[-k:] * 0.5)
    jtree = _grow(JTree, jnp.asarray, lambda c, k: c[:k] * 0.5 + c[-k:] * 0.5)
    assert any(n.depth > 0 for n in port.all_nodes())
    p_state, j_state = port.to_state(), jtree.to_state()

    def same(p, j):
        assert set(p) == set(j) == {"centroids", "text", "depth", "emb", "token_emb",
                                    "children"}
        assert (p["text"], p["depth"], p["token_emb"]) == (j["text"], j["depth"],
                                                           j["token_emb"])
        assert isinstance(p["centroids"], torch.Tensor) and p["centroids"].device.type == "cpu"
        np.testing.assert_array_equal(p["centroids"].numpy(), j["centroids"])
        np.testing.assert_array_equal(p["emb"], j["emb"])
        assert len(p["children"]) == len(j["children"])
        for pc, jc in zip(p["children"], j["children"]):
            same(pc, jc)

    assert len(p_state["roots"]) == len(j_state["roots"])
    for p, j in zip(p_state["roots"], j_state["roots"]):
        same(p, j)

    # bf16 centroids (the card's storage) survive pickle bit for bit.
    for n in port.all_nodes():
        n.centroids = (n.centroids * 3.3).to(torch.bfloat16)
    back = VisualMemoryTree.from_state(pickle.loads(pickle.dumps(port.to_state())), 2, 2,
                                       hash_embed, lambda c: "", lambda c, k: c,
                                       device="cpu")
    a, b = port.all_nodes(), back.all_nodes()
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert y.centroids.dtype == torch.bfloat16 and torch.equal(x.centroids, y.centroids)
        assert (x.text, x.depth, len(x.children)) == (y.text, y.depth, len(y.children))
        np.testing.assert_array_equal(x.emb, y.emb)
    assert [r.text for r in back.roots] == [r.text for r in port.roots]
    assert back.search(hash_embed(["chunk 10"])[0])[1] == port.search(
        hash_embed(["chunk 10"])[0])[1]


# --- the slice against the JAX package -------------------------------------------------

def _reader():
    return SyntheticVideoReader(total_frames=150, frame_rate=30, height=56, width=56)


def _configure(pipe, memory=None, video=None):
    cfg = pipe.cfg
    pipe.cfg = dataclasses.replace(
        cfg, memory=dataclasses.replace(cfg.memory, **(memory or {})),
        video=dataclasses.replace(cfg.video, **(video or {})))


def _counting(fn, sink):
    def wrapped(features, threshold):
        out = fn(features, threshold)
        sink.append((int(features.shape[0]), int(out.shape[0])))
        return out
    return wrapped


def _run_both(tmp_path, monkeypatch, memory=None, video=None, literal_kmeans=False):
    jp, pp = _pipelines()
    for p in (jp, pp):
        _configure(p, memory, video)
        p.cluster_full_chunks = not literal_kmeans
    jtoks, ptoks, jdedup, pdedup = [], [], [], []
    monkeypatch.setattr(j_generate_paged, "generate_paged_fetch",
                        _recording(j_generate_paged.generate_paged_fetch, jtoks))
    monkeypatch.setattr(port_longva, "generate_paged",
                        _recording(port_longva.generate_paged, ptoks))
    monkeypatch.setattr(j_runner, "dedup_segment", _counting(j_runner.dedup_segment, jdedup))
    monkeypatch.setattr(runner, "dedup_segment", _counting(runner.dedup_segment, pdedup))
    jres = jp.process_video_online(
        _reader(), BREAKPOINTS, JBank(str(tmp_path / "j.json"),
                                      lambda t: jp.bank_embedder.embed(t)), user_name="User")
    pres = pp.process_video_online(
        _reader(), BREAKPOINTS, MemoryBank(str(tmp_path / "p.json"), pp.bank_embed),
        user_name="User")
    assert len(pres) == len(jres) == len(BREAKPOINTS)
    assert ptoks == jtoks and sum(map(len, ptoks)) > 0
    for p, j in zip(pres, jres):
        assert set(p) == set(j)
        for field in ("time", "question", "label", "predict", "class"):
            assert p[field] == j[field], field
    pn, jn = pp.last_tree.all_nodes(), jp.last_tree.all_nodes()
    assert [n.text for n in pn] == [n.text for n in jn]
    assert [n.depth for n in pn] == [n.depth for n in jn]
    for a, b in zip(pn, jn):
        np.testing.assert_allclose(a.centroids.numpy(), np.asarray(b.centroids),
                                   atol=1e-4, rtol=0)
    assert pdedup == jdedup and len(pdedup) == len(BREAKPOINTS)
    return pp, ptoks, pdedup


def test_online_slice_parity_with_jax(tmp_path, monkeypatch):
    pp, toks, seen = _run_both(tmp_path, monkeypatch)
    # 6 + 12 + 12 frames in chunks of 5, cut at each breakpoint by flush():
    # 2 + 3 + 3 captions, then 3 answers.
    assert len(pp.last_tree) == 8 and len(toks) == 11
    assert all(n_in == n_out for n_in, n_out in seen)


def test_online_slice_parity_with_dedup(tmp_path, monkeypatch):
    """dedup_threshold 0.22 sits among the segments' 1 - cos scores
    (0.17-0.34 on this video and these weights): K12's twin drops some
    frames of every segment and keeps others, in both packages alike."""
    pp, _, seen = _run_both(tmp_path, monkeypatch, video=dict(dedup_threshold=0.22))
    assert all(0 < n_out < n_in for n_in, n_out in seen), seen
    assert sum(n.centroids.shape[0] for n in pp.last_tree.all_nodes()) == sum(
        n_out for _, n_out in seen)


def test_online_slice_parity_literal_kmeans(tmp_path, monkeypatch):
    """cluster_full_chunks=False (--literal_kmeans) with 2 clusters: no chunk
    is clustered, so every node keeps its raw chunk and nothing draws."""
    pp, _, _ = _run_both(tmp_path, monkeypatch, memory=dict(num_clusters=2),
                         literal_kmeans=True)
    assert max(n.centroids.shape[0] for n in pp.last_tree.all_nodes()) == 5


def test_online_parity_with_injected_kmeans_and_sampling(tmp_path, monkeypatch):
    """k-means on full chunks, tree merges and short-term sampling on: the
    same centroids (a fixed blend of the chunk's rows) and the same sample
    indices are injected into both packages' modules, so the draws are the
    only thing replaced."""
    calls = {"kmeans": 0, "sample": 0}

    def j_kmeans(x, k, key):
        calls["kmeans"] += 1
        return x[:k] * 0.5 + x[-k:] * 0.5, None

    def p_kmeans(x, k, *, generator=None):
        calls["kmeans"] += 1
        return x[:k] * 0.5 + x[-k:] * 0.5, None

    def idx(w, r):
        return np.linspace(0, w - 1, r).round().astype(int)

    def j_sample(key, window, r, tau):
        calls["sample"] += 1
        return window[jnp.asarray(idx(window.shape[0], r))]

    def p_sample(window, r, tau, *, generator=None):
        calls["sample"] += 1
        return window[torch.from_numpy(idx(window.shape[0], r))]

    for mod in (j_streaming, j_runner):
        monkeypatch.setattr(mod, "weighted_kmeans_feature", j_kmeans)
    for mod in (streaming, runner):
        monkeypatch.setattr(mod, "weighted_kmeans_feature", p_kmeans)
    monkeypatch.setattr(j_short_term, "select_short_memory", j_sample)
    monkeypatch.setattr(short_term, "select_short_memory", p_sample)
    pp, _, _ = _run_both(tmp_path, monkeypatch,
                         memory=dict(num_clusters=2, interval=3, short_window=8,
                                     remember_window=3))
    assert calls["kmeans"] > 0 and calls["sample"] == 2 * len(BREAKPOINTS)
    assert any(n.depth > 0 for n in pp.last_tree.all_nodes())


def test_online_matches_offline_first_round(tmp_path):
    """The port's on-line and off-line modes give the same first answer
    where their semantics coincide (tests/test_pipeline_e2e.py): the
    persistent FIFO equals the segment's window, partial chunks skip
    k-means, so both draw the same sample from the same generator state."""
    cfg = PipelineConfig(
        memory=MemoryConfig(chunk_size=8, num_clusters=2, interval=2, short_window=6,
                            remember_window=3, tau=5.0),
        sampling=SamplingConfig(temperature=0.0, caption_temperature=0.0,
                                max_answer_tokens=4, max_caption_tokens=4,
                                max_summary_tokens=4),
        video=VideoConfig(sample_rate=0.1, image_size=56))
    bp = [{"question": "What is happening?", "answer": "x", "class": "OCP", "time": 1}]
    outs = {}
    for mode in ("off_line", "on_line"):
        pipe = runner.build_pipeline(cfg, device="cpu", geometry="tiny", dtype=torch.float32)
        bank = MemoryBank(str(tmp_path / f"mem_{mode}.json"), pipe.bank_embed)
        process = pipe.process_video_online if mode == "on_line" else pipe.process_video
        results = process(SyntheticVideoReader(total_frames=40, frame_rate=30.0, height=56,
                                               width=56), bp, bank, user_name="User")
        assert len(results) == 1
        outs[mode] = results[0]["predict"]
    assert outs["off_line"] == outs["on_line"]
