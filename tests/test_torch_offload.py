"""The port's host offload (`utils/offload.py`, the chunk and resident
offload of `pipeline/memory_update.py`, the runner's flags) against the
JAX package's semantics, on the CPU.

The offloader's round trip is exact in value and dtype, its host copy is
made once and reused, and repeated or partial offloads copy nothing more;
a tree replaced since its last restore (the ViT's lazy fold) is copied
anew. `update_memory` with residents, with `offload_chunks` and past
`offload_chunks_over` gives the same tree and short memory as without, and
the same as the JAX `update_memory`: the random draws (short-memory Gumbel
noise, k-means++ seeds and repairs) are the JAX package's, injected into
the port from the keys the JAX run used. The CLI runs with both flags and
answers as without them.
"""

import dataclasses
import importlib
import json
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamchat_tpu import config as jconfig
from streamchat_tpu.memory.tree import VisualMemoryTree as JTree
from streamchat_tpu.pipeline import memory_update as jmu
from streamchat_tpu.video.reader import SyntheticVideoReader
from streamchat_tpu_torch import config
from streamchat_tpu_torch.memory.tree import VisualMemoryTree
from streamchat_tpu_torch.models import vit
from streamchat_tpu_torch.ops import forgetting, kmeans
from streamchat_tpu_torch.pipeline import memory_update as mu
from streamchat_tpu_torch.pipeline import runner
from streamchat_tpu_torch.utils import offload
from streamchat_tpu_torch.utils.offload import WeightOffloader

jkmeans = importlib.import_module("streamchat_tpu.ops.kmeans")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these tiny tensors: the suite runs a worker
    per core, and torch's thread pools then contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


class Holder:
    def __init__(self, **trees):
        self.__dict__.update(trees)


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(4, 3, generator=g),
            "layers": [{"b": torch.randn(5, generator=g).to(torch.bfloat16),
                        "q": torch.randint(-127, 127, (3, 2), generator=g, dtype=torch.int8)}],
            "heads": 4}


def _equal(a, b):
    ta, tb = offload.tensors(a), offload.tensors(b)
    return (len(ta) == len(tb) and all(x.dtype == y.dtype and torch.equal(x, y)
                                       for x, y in zip(ta, tb))
            and a["heads"] == b["heads"])


def test_round_trip_keeps_values_and_dtypes():
    ref = _tree(0)
    h = Holder(a=_tree(0))
    device_tree = h.a
    off = WeightOffloader().register("a", h, "a")
    off.offload()
    assert h.a is not device_tree and _equal(h.a, ref) and off.offloaded == {"a"}
    assert off.host_bytes() == sum(t.nbytes for t in offload.tensors(ref))
    off.restore(block=True)
    assert _equal(h.a, ref) and off.offloaded == set()
    assert off.names == ["a"] and off.offload_s > 0 and off.restore_s > 0


def test_host_copy_is_made_once_and_reused(monkeypatch):
    copies = []
    real = offload.to_host
    monkeypatch.setattr(offload, "to_host", lambda t: copies.append(t) or real(t))
    h = Holder(a=_tree(1))
    off = WeightOffloader().register("a", h, "a")
    off.offload()
    host = h.a
    for _ in range(3):
        off.restore()
        off.offload()
        assert h.a is host
    assert len(copies) == 3                  # w, b, q: once each


def test_repeated_or_partial_offload_does_nothing_more(monkeypatch):
    copies = []
    real = offload.to_host
    monkeypatch.setattr(offload, "to_host", lambda t: copies.append(t) or real(t))
    h = Holder(a=_tree(2), b=_tree(3))
    b_tree = h.b
    off = WeightOffloader().register("a", h, "a").register("b", h, "b")
    off.offload(["a"])
    parked = h.a
    assert h.b is b_tree and len(copies) == 3
    off.offload(["a"])
    assert h.a is parked and len(copies) == 3
    off.offload()
    assert h.a is parked and h.b is not b_tree and len(copies) == 6
    off.offload()
    assert len(copies) == 6
    off.restore(["b"])
    assert off.offloaded == {"a"} and h.a is parked


def test_a_tree_replaced_since_its_restore_is_parked_anew():
    """The lazy fold swaps in a folded tree (a "fused" key a layer): the
    next offload parks that one, and the restore brings it back folded."""
    cfg = config.ViTConfig.tiny()
    params = vit.init(cfg, torch.Generator().manual_seed(0), dtype=torch.float32)
    m = Holder(vit_params=params)
    off = WeightOffloader().register("vit", m, "vit_params")
    off.offload()
    off.restore()
    m.vit_params = vit.fold_params(m.vit_params, cfg)
    off.offload()
    assert all("fused" in p for p in m.vit_params["layers"])
    off.restore()
    assert all("fused" in p for p in m.vit_params["layers"])
    pixels = torch.randn(2, 3, cfg.image_size, cfg.image_size,
                         generator=torch.Generator().manual_seed(1))
    fused = vit.encode(m.vit_params, pixels, cfg, fused=True)
    assert torch.equal(fused, vit.encode(vit.fold_params(params, cfg), pixels, cfg,
                                         fused=True))


def test_a_tree_in_use_while_parked_still_computes():
    cfg = config.ViTConfig.tiny()
    m = Holder(vit_params=vit.init(cfg, torch.Generator().manual_seed(0),
                                   dtype=torch.float32))
    pixels = torch.randn(2, 3, cfg.image_size, cfg.image_size,
                         generator=torch.Generator().manual_seed(2))
    before = vit.encode(m.vit_params, pixels, cfg)
    held = m.vit_params
    off = WeightOffloader().register("vit", m, "vit_params")
    off.offload()
    assert torch.equal(vit.encode(held, pixels, cfg), before)
    assert torch.equal(vit.encode(m.vit_params, pixels, cfg), before)


# update_memory against the JAX package's, with the JAX draws injected.

MEMORY = dict(chunk_size=4, num_clusters=2, interval=10, short_window=6, remember_window=3)


def hash_embed(texts):
    out = np.zeros((len(texts), 16), np.float32)
    for i, t in enumerate(texts):
        for a, b in zip(t, t[1:]):
            out[i, (ord(a) * 31 + ord(b)) % 16] += 1.0
    return out


def _captioner(sink):
    def caption(chunk):
        sink.append(chunk)
        return f"clip {len(sink)} of {chunk.shape[0]} frames"
    return caption


def _jax_run(feats, key):
    """The JAX update_memory -> (tree, short, the keys of its draws)."""
    keys = {"short": [], "kmeans": []}
    real_short, real_km = jmu.select_short_memory, jmu.weighted_kmeans_feature

    def short(k, window, r, tau):
        keys["short"].append(k)
        return real_short(k, window, r, tau)

    def km(chunk, k, key):
        keys["kmeans"].append(key)
        return real_km(chunk, k, key)

    jmu.select_short_memory, jmu.weighted_kmeans_feature = short, km
    try:
        tree = JTree(num_clusters=2, interval=10, embed_fn=hash_embed,
                     summarize_fn=lambda c: " | ".join(c), merge_fn=lambda c, k: c[:k])
        tree, short_mem = jmu.update_memory(jnp.asarray(feats), tree, _captioner([]),
                                            jconfig.MemoryConfig(**MEMORY), key)
    finally:
        jmu.select_short_memory, jmu.weighted_kmeans_feature = real_short, real_km
    return tree, short_mem, keys


@pytest.fixture
def injected(monkeypatch):
    """Points the port's draws at the keys of a JAX run: `keys` is filled
    by the test, and each port run takes them in order."""
    keys = {}
    taken = {"short": 0, "kmeans": 0}

    def short(window, r, tau, generator=None):
        key = keys["short"][taken["short"] % len(keys["short"])]
        taken["short"] += 1
        gumbel = np.array(jax.random.gumbel(key, (window.shape[0],)))
        return forgetting.select_short_memory(window, r, tau,
                                              gumbel=torch.from_numpy(gumbel))

    def km(chunk, k, generator=None):
        key = keys["kmeans"][taken["kmeans"] % len(keys["kmeans"])]
        taken["kmeans"] += 1
        t, p, d = chunk.shape
        flat = chunk.reshape(t, p * d)
        init_key, repair_key = jax.random.split(key)
        c0 = np.array(jkmeans._kmeans_plus_plus_init(
            jnp.asarray(flat.numpy()), jnp.ones(t), init_key, k))
        repair = np.array(jax.random.randint(repair_key, (10, k), 0, t))
        c, labels, _ = kmeans.weighted_kmeans(
            flat, torch.ones(t), num_clusters=k, init_centroids=torch.from_numpy(c0),
            repair_idx=torch.from_numpy(repair))
        return c.reshape(k, p, d).to(chunk.dtype), labels

    monkeypatch.setattr(mu, "select_short_memory", short)
    monkeypatch.setattr(mu, "weighted_kmeans_feature", km)
    return keys


def _port_tree():
    return VisualMemoryTree(num_clusters=2, interval=10,
                            embed_fn=lambda t: torch.from_numpy(hash_embed(t)),
                            summarize_fn=lambda c: " | ".join(c), merge_fn=lambda c, k: c[:k])


def _port_run(feats, residents=None, stats=None, **memory):
    """The port's update_memory over a boxed stack -> (tree, short, the
    chunks captioned, whether the stack was alive at the first caption)."""
    stack = torch.from_numpy(feats.copy())
    ref = weakref.ref(stack)
    seen, alive = [], []

    def caption(chunk):
        alive.append(ref() is not None)
        if residents is not None:
            assert residents.offloaded == set(residents.names)
        return _captioner(seen)(chunk)

    box = [stack]
    del stack
    tree, short = mu.update_memory(box, _port_tree(), caption,
                                   config.MemoryConfig(**{**MEMORY, **memory}),
                                   residents=residents, stats=stats)
    assert box == []
    return tree, short, seen, alive[0]


def _same_tree(tree, jtree, short, jshort):
    nodes, jnodes = tree.all_nodes(), jtree.all_nodes()
    assert [n.text for n in nodes] == [n.text for n in jnodes]
    for n, jn in zip(nodes, jnodes):
        np.testing.assert_allclose(n.centroids.numpy(), np.asarray(jn.centroids),
                                   atol=1e-5, rtol=0)
    np.testing.assert_array_equal(short.numpy(), np.asarray(jshort))


@pytest.mark.parametrize("memory,offloaded", [
    ({}, False),
    ({"offload_chunks": True}, True),
    ({"offload_chunks_over": 9}, True),            # 10 frames: over the guard
    ({"offload_chunks_over": 10}, False),
    ({"offload_chunks_over": None}, False),
], ids=["plain", "offload_chunks", "over-9", "over-10", "guard-off"])
@pytest.mark.parametrize("residents", [False, True], ids=["", "residents"])
def test_update_memory_with_offload_matches_jax(injected, memory, offloaded, residents):
    feats = _rand(0, 10, 4, 8)
    jtree, jshort, keys = _jax_run(feats, jax.random.key(5))
    injected.update(keys)
    stats = mu.offload_stats()
    holder = Holder(params=_tree(4))
    off = (WeightOffloader().register("emb", holder, "params") if residents else None)
    tree, short, seen, alive = _port_run(feats, off, stats, **memory)
    _same_tree(tree, jtree, short, jshort)
    assert [c.shape[0] for c in seen] == [4, 4, 2]
    if residents:
        assert off.offloaded == set() and _equal(holder.params, _tree(4))
    assert stats["chunks"] == (3 if offloaded else 0)
    assert stats["bytes"] == (2 * feats.nbytes if offloaded else 0)
    # Under the offload nothing left holds the stack once it is cut: the
    # boxed stack is gone by the first caption. Without it the raw chunks
    # are views of the stack, which lives until they are captioned.
    assert alive is not offloaded
    if offloaded:
        assert short.untyped_storage().data_ptr() not in {
            n.centroids.untyped_storage().data_ptr() for n in tree.all_nodes()}


def test_cli_runs_with_both_offload_flags(tmp_path, monkeypatch):
    """`main` with --offload_chunks --offload_residents at tiny geometry:
    the pipeline registers its four idle trees, parks and restores them
    each segment, counts the chunks it parked, and saves the records of
    the run without the flags; --shard still raises."""
    (tmp_path / "videos" / "cls").mkdir(parents=True)
    (tmp_path / "videos" / "cls" / "v.mp4").write_bytes(b"")
    anno = [{"info": {"video_path": "v.mp4", "class_1": "cls"},
             "breakpoint": [{"question": "What do I see?", "answer": "a", "class": "c",
                             "time": 2},
                            {"question": "What changed?", "answer": "b", "class": "c",
                             "time": 5}]}]
    (tmp_path / "a.json").write_text(json.dumps(anno))
    built, config_from_args, build = [], runner.config_from_args, runner.build_pipeline

    def short(args):
        cfg = config_from_args(args)
        return cfg.replace(sampling=dataclasses.replace(
            cfg.sampling, max_answer_tokens=4, max_caption_tokens=4, max_summary_tokens=4))

    monkeypatch.setattr(runner, "config_from_args", short)
    monkeypatch.setattr(runner, "build_pipeline",
                        lambda *a, **kw: built.append(build(*a, **kw)) or built[-1])
    monkeypatch.setattr(runner, "open_video", lambda path: SyntheticVideoReader(
        total_frames=150, frame_rate=30, height=56, width=56))
    saved = []
    for i, flags in enumerate([[], ["--offload_chunks", "--offload_residents"]]):
        save = tmp_path / f"s{i}.json"
        runner.main(["--video_dir", str(tmp_path / "videos"), "--memory_basic_dir",
                     str(tmp_path / f"m{i}"), "--save_file", str(save),
                     "--annotations", str(tmp_path / "a.json"), "--device", "cpu",
                     "--geometry", "tiny", "--bf16", "--chunk_size", "4",
                     "--num_clusters", "2", "--interval", "3", "--multi_modal_memory"]
                    + flags)
        saved.append([{k: v for k, v in r.items() if k != "process_time"}
                      for r in json.loads(save.read_text())])
    plain, parked = built
    assert plain.residents is None and plain.last_offload_stats["chunks"] == 0
    assert parked.cfg.memory.offload_chunks and parked.cfg.memory.offload_residents
    assert parked.residents.names == ["vit", "projector", "tree_embedder", "bank_embedder"]
    assert parked.residents.offloaded == set() and parked.residents.host_bytes() > 0
    assert parked.last_offload_stats["chunks"] > 0
    assert saved[1] == saved[0] and len(saved[0]) == 2
    args = runner.parse_args(["--video_dir", "v", "--memory_basic_dir", "m", "--save_file",
                              "s", "--annotations", "a", "--shard", "--offload_chunks"])
    with pytest.raises(NotImplementedError, match="Multi-GPU"):
        runner.config_from_args(args)
    assert runner._NOT_PORTED == (("shard", "--shard", "Multi-GPU"),)
