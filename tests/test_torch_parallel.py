"""The port's tensor parallelism against the JAX package's, on the CPU.

Four gloo ranks (`tests/torch_parallel_ranks.py`, spawned once for the
module) run every case: tp 4 over the world, tp 2 over pairs of ranks, and
the 2 x 2 (data, model) mesh. The geometry is tiny in float32, with 8
query heads over 4 kv heads so that tp 2 and tp 4 both divide (the
runner's tiny geometry has 2 kv heads, so four ranks make the 2 x 2 mesh).
The JAX side runs its sharded model on the 8-device CPU mesh
(`tests/test_parallel.py`), or on a (2, 2) mesh of four of its devices.
Held:
- `best_mesh_shape` and `host_shard` equal to JAX's; `host_shard` splits
  over the data axis only; `make_mesh`'s layout, groups and argument rules
  equal JAX `make_mesh`'s;
- rank slices of bf16, int8 and int4 trees put back together equal the
  whole, dequantized; an int4 column slice's codes and scales equal
  quantizing the sliced weight; an int4 row split inside a 128-row group
  raises;
- TP prefill logits within 1e-4 of JAX's sharded prefill at tp 2 and 4;
- greedy answers and batched captions equal to JAX's sharded LongVA;
- at tp 2, token-exact with the unsharded port: int4, kv_int8, spec 4, H2O
  under a budget, TextLM.shard; the NLL within 1e-5;
- every rank of a group returns the same tokens;
- on the 2 x 2 mesh: prefill logits, greedy answers and captions, TextLM's
  tokens and USP equal to JAX's on a (2, 2) mesh;
- the runner's --shard output file on the 2 x 2 mesh equal to the JAX
  runner's --num_chunks 2 runs merged by annotation index, with no file
  written by two ranks; under the multi-modal memory (k-means, summaries)
  equal to the port's unsharded --num_chunks 2 runs merged;
- the on-line session takes its collectives in the same order on every
  rank, each answer's after the worker's captions.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import importlib
import json

from jax.sharding import Mesh as JMesh

from streamchat_tpu import config as jconfig
from streamchat_tpu.models import decoder as jdec
from streamchat_tpu.models.decoder import KVCache as JKVCache
from streamchat_tpu.models.embedder import TextEmbedder as JEmbedder
from streamchat_tpu.models.longva import LongVA as JLongVA
from streamchat_tpu.models.textlm import TextLM as JTextLM
from streamchat_tpu.models.tokenizer import ByteTokenizer as JByteTokenizer
from streamchat_tpu.ops import quant as jquant
from streamchat_tpu.parallel import best_mesh_shape as j_best_mesh_shape
from streamchat_tpu.parallel import decoder_pspecs, make_mesh as j_make_mesh, shard_pytree
from streamchat_tpu.parallel.multihost import host_shard as j_host_shard
from streamchat_tpu.pipeline import runner as jrunner
from streamchat_tpu.utils.prng import KeySeq
from streamchat_tpu.video.reader import SyntheticVideoReader as JSyntheticVideoReader
from streamchat_tpu_torch import config, convert
from streamchat_tpu_torch.models import decoder
from streamchat_tpu_torch.models.textlm import TextLM
from streamchat_tpu_torch.models.tokenizer import ByteTokenizer
from streamchat_tpu_torch.ops import quant
from streamchat_tpu_torch.ops import ring_attention as ring
from streamchat_tpu_torch.parallel import Mesh, ModelGroup, best_mesh_shape, make_mesh
from streamchat_tpu_torch.parallel.multihost import host_shard
from streamchat_tpu_torch.parallel.sharding import rank_config, shard_decoder
from tests import torch_parallel_ranks

# `streamchat_tpu.ops` re-exports a function that shadows this submodule.
julysses = importlib.import_module("streamchat_tpu.ops.ulysses")

ATOL = 1e-4
USP_ATOL = 2e-5
PROMPT = "<image>\nwhat?"
PROMPTS = ["caption <image> one.", "caption <image> two, longer prompt."]


def _jcfg():
    return dataclasses.replace(jconfig.DecoderConfig.tiny(), num_heads=8, num_kv_heads=4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# USP's q / k / v on the 2 x 2 mesh: B 1, 4 heads over 2 kv heads, S 32, D 16.
USP_QKV = (_rand(20, 1, 4, 32, 16), _rand(21, 1, 2, 32, 16), _rand(22, 1, 2, 32, 16))


@pytest.fixture(scope="module")
def jax_side():
    """JAX's LongVA at the test geometry, sharded on the 8-device mesh, and
    what the tests compare with."""
    dcfg = _jcfg()
    jm = JLongVA.init_random(jax.random.key(0),
                             jconfig.ViTConfig.tiny(projection_dim=dcfg.hidden_size), dcfg,
                             dtype=jnp.float32)
    whole = _np(jm.dec_params)
    embeds = _rand(1, 2, 16, dcfg.hidden_size, scale=0.5)
    lengths = np.asarray([16, 12], np.int32)
    mesh = j_make_mesh(*j_best_mesh_shape(8, kv_heads=dcfg.num_kv_heads))

    def prefill(m):
        sharded = shard_pytree(jm.dec_params, decoder_pspecs(dcfg), m)
        return np.asarray(jdec.prefill(sharded, dcfg, jnp.asarray(embeds),
                                       JKVCache.create(dcfg, 2, 16, dtype=jnp.float32),
                                       jnp.asarray(lengths))[0])

    logits, logits22 = prefill(mesh), prefill(_mesh22())
    feats = _rand(2, 4, dcfg.hidden_size)
    batch_feats = [[_rand(10 + i, 6, dcfg.hidden_size, scale=0.2)] for i in range(2)]
    port = dict(vit=convert.vit_params(_np(jm.vit_params)),
                proj=convert.to_torch(_np(jm.proj_params)), dec=convert.to_torch(whole),
                vit_cfg=config.ViTConfig(**dataclasses.asdict(jm.vit_cfg)),
                dec_cfg=config.DecoderConfig(**dataclasses.asdict(dcfg)),
                prompt=PROMPT, prompts=PROMPTS, feats=torch.from_numpy(feats),
                batch_feats=[[torch.from_numpy(f[0])] for f in batch_feats],
                long_feats=torch.from_numpy(_rand(3, 300, dcfg.hidden_size, scale=0.2)),
                judge_prompts=["Q: what is on the table?", "Q: where?"],
                prefill_embeds=torch.from_numpy(embeds),
                prefill_lengths=torch.from_numpy(lengths),
                usp=tuple(torch.from_numpy(t) for t in USP_QKV))
    lm22 = JTextLM(jax.tree.map(jnp.asarray, whole), dcfg, JByteTokenizer(), KeySeq(0))
    judge22 = lm22.shard(_mesh22()).generate_batch(port["judge_prompts"], max_new_tokens=6)
    usp = jax.jit(functools.partial(julysses.usp_attention, mesh=_mesh22(),
                                    ulysses_axis="model", ring_axis="data", causal=True))
    out = dict(logits=logits, logits22=logits22, judge22=judge22, port=port,
               usp=np.asarray(usp(*map(jnp.asarray, USP_QKV))))
    for key, m in (("", None), ("22", _mesh22())):
        model = jm if m is None else JLongVA.init_random(
            jax.random.key(0), jconfig.ViTConfig.tiny(projection_dim=dcfg.hidden_size), dcfg,
            dtype=jnp.float32)
        model.shard(m)
        out["answer" + key] = model.generate_with_image_embedding(
            PROMPT, [jnp.asarray(feats)], max_new_tokens=4, temperature=0.0)
        out["batch" + key] = model.generate_with_image_embedding_batch(
            PROMPTS, [[jnp.asarray(f[0])] for f in batch_feats], max_new_tokens=6,
            temperature=0.0)
    return out


def _mesh22():
    """JAX's (2, 2) (data, model) mesh over four of the conftest's CPU devices."""
    return JMesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))


# The runner's CLI settings: greedy, and nothing drawn at random (short_window
# == remember_window, chunk_size <= num_clusters, fewer than `interval` tree
# nodes), so the JAX and the port runs may agree record for record. The
# answer is the CLI's default, the uni-modal one: at these random weights
# many captions come out equal, and the multi-modal answer's caption search
# then picks among tied nodes by last-bit differences of the two packages'
# embedders.
RUNNER_CLI = ["--chunk_size", "10", "--num_clusters", "10", "--interval", "10",
              "--short_window", "5", "--remember_window", "5", "--temperature", "0"]
RUNNER_VIDEOS = 4
# The port alone, sharded against unsharded: the multi-modal answer and
# memory, k-means (chunk_size > num_clusters) and summaries (interval 3).
MULTIMODAL_CLI = ["--chunk_size", "4", "--num_clusters", "2", "--interval", "3",
                  "--temperature", "0", "--multi_modal_memory"]
MULTIMODAL_VIDEOS = 2


def _runner_annotations():
    return [{"info": {"video_path": f"v{i}.mp4", "class_1": "cls"},
             "breakpoint": [{"question": f"What do I see in clip {i}?", "answer": "a",
                             "class": "c", "time": 1},
                            {"question": f"What changed in clip {i}?", "answer": "b",
                             "class": "c", "time": 3}]} for i in range(RUNNER_VIDEOS)]


def _multimodal_annotations():
    return [{"info": {"video_path": f"v{i}.mp4", "class_1": "cls"},
             "breakpoint": [{"question": f"What do I see now in clip {i}?", "answer": "a",
                             "class": "c", "time": 2},
                            {"question": f"What is new in clip {i}?", "answer": "b",
                             "class": "c", "time": 5}]} for i in range(MULTIMODAL_VIDEOS)]


def _jax_tiny_models():
    """The JAX pipeline's models at its tiny geometry (2 kv heads) in f32,
    from fixed keys -> (LongVA, tree embedder, bank embedder)."""
    dcfg = jconfig.DecoderConfig.tiny()
    k1, k2, k3 = jax.random.split(jax.random.key(5), 3)
    jm = JLongVA.init_random(k1, jconfig.ViTConfig.tiny(projection_dim=dcfg.hidden_size), dcfg,
                             dtype=jnp.float32)
    jtree = JEmbedder.init_random(k2, jconfig.BertConfig.tiny())
    jbank = JEmbedder.init_random(
        k3, dataclasses.replace(jconfig.BertConfig.tiny(), pooling="mean"))
    return jm, jtree, jbank


def _short(cfg):
    return cfg.replace(sampling=dataclasses.replace(
        cfg.sampling, max_answer_tokens=4, max_answer_tokens_unimodal=4, max_caption_tokens=4,
        max_summary_tokens=4, caption_temperature=0.0))


@pytest.fixture(scope="module")
def runner_side(tmp_path_factory):
    """The runner's annotation file (RUNNER_VIDEOS videos, read as the
    synthetic video), the JAX tiny weights converted for the ranks, and the
    JAX runner's records at --num_chunks 2 --chunk_idx 0 and 1, each run
    from a fresh int8 pipeline, as two fanned-out JAX processes."""
    tmp = tmp_path_factory.mktemp("runner")
    (tmp / "videos" / "cls").mkdir(parents=True)
    for i in range(RUNNER_VIDEOS):
        (tmp / "videos" / "cls" / f"v{i}.mp4").write_bytes(b"")
    anno = tmp / "annotations.json"
    anno.write_text(json.dumps(_runner_annotations()))
    mm_anno = tmp / "multimodal.json"
    mm_anno.write_text(json.dumps(_multimodal_annotations()))
    base = ["--video_dir", str(tmp / "videos"), "--annotations", str(anno)] + RUNNER_CLI
    records = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrunner, "open_video", lambda path: JSyntheticVideoReader(
            total_frames=150, frame_rate=30, height=56, width=56))
        for chunk in (0, 1):
            out = str(tmp / f"jax{chunk}")
            args = jrunner.parse_args(base + ["--memory_basic_dir", out, "--save_file",
                                              out + ".json", "--num_chunks", "2",
                                              "--chunk_idx", str(chunk)])
            jp = jrunner.StreamChatPipeline(*_jax_tiny_models(),
                                            _short(jrunner.config_from_args(args)))
            jp.model.quantize()                   # as the JAX main does by default (int8)
            jrunner.run_inference(jp, args)
            records[chunk] = json.loads((tmp / f"jax{chunk}.json").read_text())
    jm, jtree, jbank = _jax_tiny_models()

    def emb(j):
        return dict(params=convert.to_torch(_np(j.params)),
                    cfg=config.BertConfig(**dataclasses.asdict(j.cfg)), max_length=j.max_length)

    models = dict(vit=convert.vit_params(_np(jm.vit_params)),
                  proj=convert.to_torch(_np(jm.proj_params)),
                  dec=convert.to_torch(_np(jm.dec_params)),
                  vit_cfg=config.ViTConfig(**dataclasses.asdict(jm.vit_cfg)),
                  dec_cfg=config.DecoderConfig(**dataclasses.asdict(jm.dec_cfg)),
                  tree=emb(jtree), bank=emb(jbank))
    spec = dict(videos=str(tmp / "videos"), annotations=str(anno), cli=RUNNER_CLI,
                models=models,
                multimodal=dict(annotations=str(mm_anno), cli=MULTIMODAL_CLI))
    return dict(spec=spec, jax=records)


@pytest.fixture(scope="module")
def ranks(jax_side, runner_side, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_ranks")
    inputs = str(tmp / "inputs.pt")
    torch.save(dict(jax_side["port"], runner=runner_side["spec"]), inputs)
    return torch_parallel_ranks.spawn(torch_parallel_ranks.tp_cases, 4, tmp, inputs, str(tmp))


# --- mesh and multihost -----------------------------------------------------------------

@pytest.mark.parametrize("n,kv", [(8, 4), (8, 2), (1, 4), (4, 8), (6, 4), (2, 4), (3, 1)])
def test_best_mesh_shape_matches_jax(n, kv):
    assert best_mesh_shape(n, kv_heads=kv) == j_best_mesh_shape(n, kv_heads=kv)


@pytest.mark.parametrize("n_items,count", [(10, 3), (8, 4), (1, 2), (0, 3), (7, 1)])
def test_host_shard_matches_jax(n_items, count):
    items = list(range(n_items))
    for pid in range(count):
        assert host_shard(items, pid, count) == j_host_shard(items, pid, count)


def test_world_of_one_changes_nothing():
    """No process group: make_mesh is a world of one and shard() is a no-op
    on both facades, as a one-device mesh in the JAX package."""
    assert make_mesh() == Mesh() and make_mesh().model.all_reduce(torch.ones(2)).sum() == 2
    assert make_mesh().coords == (0, 0) and make_mesh().shape == {"data": 1, "model": 1}
    cfg = config.DecoderConfig(**dataclasses.asdict(_jcfg()))
    params = decoder.init(cfg, torch.Generator().manual_seed(0), dtype=torch.float32)
    lm = TextLM(params, cfg, ByteTokenizer(), torch.Generator().manual_seed(0))
    before = {id(v) for v in params["layers"][0]["attn"].values()}
    assert lm.shard() is lm and lm.cfg == cfg and "tp" not in lm.params
    assert {id(v) for v in lm.params["layers"][0]["attn"].values()} == before


# --- the (data, model) mesh -----------------------------------------------------------

def test_mesh_layout_matches_jax(ranks):
    """Four ranks at 2 kv heads: the 2 x 2 mesh of JAX's
    `np.asarray(devices).reshape(2, 2)`; rank r at (r // 2, r % 2), its
    model group the ranks of its row, its data group those of its column."""
    grid = np.arange(4).reshape(2, 2)
    assert best_mesh_shape(4, kv_heads=2) == (2, 2)
    for r, rep in enumerate(ranks):
        d, m = divmod(r, 2)
        assert rep["grid"]["coords"] == (d, m) and grid[d, m] == r
        assert rep["grid"]["shape"] == {"data": 2, "model": 2}
        assert rep["grid"]["model"] == grid[d].tolist()
        assert rep["grid"]["data"] == grid[:, m].tolist()


@pytest.mark.parametrize("args", torch_parallel_ranks.MESH_ARGS, ids=str)
def test_make_mesh_argument_rules_match_jax(ranks, args):
    """make_mesh(dp, tp) over 4 ranks: the shape JAX `make_mesh` gives 4
    devices, or its ValueError."""
    try:
        want = dict(j_make_mesh(*args, devices=jax.devices()[:4]).shape)
    except ValueError as e:
        want = str(e)
    assert all(r["mesh_args"][args] == want for r in ranks), (want, ranks[0]["mesh_args"][args])


def test_host_shard_splits_over_the_data_axis(ranks):
    """Over a mesh the ranks of one model group take the same items: all of
    them on a tp-4 mesh, each pair its half on the 2 x 2 mesh."""
    for r, rep in enumerate(ranks):
        assert rep["host_shard"]["tp4"] == list(range(10))
        assert rep["host_shard"]["grid"] == j_host_shard(list(range(10)), r // 2, 2)
    assert ranks[0]["host_shard"]["grid"] == [0, 1, 2, 3, 4]


def test_host_shard_in_a_group_needs_the_layout(ranks):
    """In a process group the data axis follows the run's mesh, which the
    world size alone does not fix (4 ranks are tp 4 at 4 kv heads, 2 x 2 at
    2): a call with no mesh raises, explicit ids split as JAX's."""
    for r, rep in enumerate(ranks):
        assert "mesh=" in rep["host_shard"]["no_mesh"]
        assert rep["host_shard"]["ids"] == j_host_shard(list(range(10)), r % 2, 2)


def test_grid_prefill_logits_match_jax(ranks, jax_side):
    for r in ranks:
        np.testing.assert_allclose(r["prefill22"].numpy(), jax_side["logits22"], atol=ATOL,
                                   rtol=0)


def test_grid_longva_shard_matches_jax(ranks, jax_side):
    """LongVA.shard on the 2 x 2 mesh: every replica's greedy answer and
    batched captions equal JAX's sharded LongVA on a (2, 2) mesh."""
    for r in ranks:
        assert r["generate22"]["answer"] == jax_side["answer22"]
        assert r["generate22"]["batch"] == jax_side["batch22"]


def test_grid_textlm_shard_matches_jax(ranks, jax_side):
    assert len(jax_side["judge22"]) == 2
    for r in ranks:
        assert r["judge22"] == jax_side["judge22"]


def test_usp_on_the_grid_matches_jax(ranks, jax_side):
    """USP over the mesh's groups (Ulysses on the model axis, the ring on the
    data axis): each rank's shard equal to that of JAX usp_attention."""
    want = torch.from_numpy(np.array(jax_side["usp"]))
    for r, rep in enumerate(ranks):
        np.testing.assert_allclose(rep["usp"].numpy(),
                                   ring.sequence_shard(want, r, 4).numpy(), atol=USP_ATOL,
                                   rtol=0)


# --- slices --------------------------------------------------------------------------

def _tree(bits):
    cfg = config.DecoderConfig(**dataclasses.asdict(_jcfg()))
    params = decoder.init(cfg, torch.Generator().manual_seed(1), dtype=torch.float32)
    return cfg, (params if bits is None else quant.quantize_decoder_params(params, bits=bits))


def _dense(p):
    if isinstance(p, torch.Tensor):
        return p
    if "w_i4p" in p:
        return quant.dequantize_weight_int4(p, torch.float32)
    if "w_i8" in p:
        return quant.dequantize_weight(p, torch.float32)
    return p["w"]


@pytest.mark.parametrize("bits,tp", [(None, 2), (None, 4), (8, 2), (8, 4), (4, 2)])
def test_rank_slices_reassemble_the_whole(bits, tp):
    """Columns of q/k/v/gate/up/lm_head, rows of o/down and embed: the
    ranks' slices, concatenated, equal the whole tree (dequantized). int4
    row splits need tp 2 at this width (128 rows a rank; tp 4 raises:
    `test_int4_row_split_inside_a_group_raises`)."""
    cfg, whole = _tree(bits)
    parts = [shard_decoder(_tree(bits)[1], cfg, ModelGroup(None, r, tp)) for r in range(tp)]
    rcfg = parts[0][1]
    assert rcfg == rank_config(cfg, tp) and rcfg.num_kv_heads == cfg.num_kv_heads // tp
    assert rcfg.head_dim == cfg.head_dim and rcfg.vocab_size == cfg.vocab_size
    for i, layer in enumerate(whole["layers"]):
        for group, names, dim in (("attn", "qkv", 1), ("mlp", ("gate", "up"), 1),
                                  ("attn", "o", 0), ("mlp", ("down",), 0)):
            for n in names:
                got = torch.cat([_dense(p["layers"][i][group][n]) for p, _ in parts], dim)
                assert torch.equal(got, _dense(layer[group][n])), (i, n)
        for n in "qkv":
            got = torch.cat([p["layers"][i]["attn"][n]["b"] for p, _ in parts])
            assert torch.equal(got, layer["attn"][n]["b"])
    assert torch.equal(torch.cat([p["embed"] for p, _ in parts]), whole["embed"])
    assert torch.equal(torch.cat([_dense(p["lm_head"]) for p, _ in parts], 1),
                       _dense(whole["lm_head"]))
    assert all(p["tp"] == ModelGroup(None, r, tp) for r, (p, _) in enumerate(parts))


@pytest.mark.parametrize("tp", [2, 4])
def test_int4_column_slices_equal_quantizing_the_slice(tp):
    """Per-(group, column) scales: the packed codes and scales of a column
    slice are those of quantizing the sliced weight, in both packages."""
    w = torch.from_numpy(_rand(5, 256, 512))
    q = quant.quantize_weight_int4(w)
    for r in range(tp):
        cols = slice(r * 512 // tp, (r + 1) * 512 // tp)
        got = shard_decoder({"layers": [], "embed": torch.zeros(8, 1), "lm_head": q},
                            config.DecoderConfig(**dataclasses.asdict(_jcfg())),
                            ModelGroup(None, r, tp))[0]["lm_head"]
        want = quant.quantize_weight_int4(w[:, cols])
        jwant = jquant.quantize_weight_int4(jnp.asarray(w.numpy()[:, cols]))
        assert torch.equal(got["w_i4p"], want["w_i4p"])
        assert torch.equal(got["scale"], want["scale"])
        np.testing.assert_array_equal(got["w_i4p"].numpy(), np.asarray(jwant["w_i4p"]))


def test_int4_row_split_inside_a_group_raises(ranks):
    """o and down at tp 4 give 64 rows a rank, inside a 128-row group."""
    cfg, whole = _tree(4)
    with pytest.raises(ValueError, match="128-row quantization group"):
        shard_decoder(whole, cfg, ModelGroup(None, 0, 4))
    assert "128-row quantization group" in ranks[0]["int4_tp4_error"]


def test_quantize_after_shard_raises():
    cfg, whole = _tree(None)
    sharded, _ = shard_decoder(whole, cfg, ModelGroup(None, 0, 2))
    with pytest.raises(ValueError, match="before it is sharded"):
        quant.quantize_decoder_params(sharded)
    with pytest.raises(ValueError, match="already sharded"):
        shard_decoder(sharded, cfg, ModelGroup(None, 0, 2))


# --- tensor parallelism over gloo ranks ------------------------------------------------

def test_ranks_see_their_groups(ranks):
    assert [r["mesh"] for r in ranks] == [(0, 2, 0, 4), (1, 2, 1, 4), (0, 2, 2, 4),
                                          (1, 2, 3, 4)]


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_tp_prefill_logits_match_jax(ranks, jax_side, tp):
    for r in ranks:
        np.testing.assert_allclose(r["prefill"][tp].numpy(), jax_side["logits"], atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_tp_greedy_answer_matches_jax(ranks, jax_side, tp):
    assert all(r["generate"][tp]["answer"] == jax_side["answer"] for r in ranks)


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_tp_batched_captions_match_jax(ranks, jax_side, tp):
    assert all(r["generate"][tp]["batch"] == jax_side["batch"] for r in ranks)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_nll_matches_unsharded(ranks, tp):
    whole = ranks[0]["generate"][1]["nll"]
    for r in ranks:
        assert math.isclose(r["generate"][tp]["nll"][0], whole[0], rel_tol=1e-5)
        assert math.isclose(r["generate"][tp]["nll"][1], whole[1], rel_tol=1e-5)


@pytest.mark.parametrize("variant", ["int4", "kv_int8", "spec4", "h2o"])
def test_tp2_variant_token_exact(ranks, variant):
    for r in ranks:
        assert r["variants"][2][variant] == r["variants"][1][variant]
    assert ranks[0]["variants"][1][variant]


def test_textlm_shard_token_exact(ranks):
    for r in ranks:
        assert r["judge"][2] == r["judge"][1] and len(r["judge"][2]) == 2


def _untimed(records):
    return [{k: v for k, v in r.items() if k != "process_time"} for r in records]


def _merged(chunks, annotations=None):
    """Records of --num_chunks 2 runs, merged by annotation index (each
    annotation's in breakpoint order)."""
    index = {b["question"]: i for i, a in enumerate(annotations or _runner_annotations())
             for b in a["breakpoint"]}
    return sorted(_untimed(r for c in chunks for r in c), key=lambda r: index[r["question"]])


def test_runner_shard_writes_the_unsharded_file(ranks):
    """--shard on the 2 x 2 mesh under the multi-modal memory: rank 0's
    --save_file holds both replicas' records in annotation order, equal to
    the port's unsharded runs of --num_chunks 2 --chunk_idx 0 and 1 merged;
    each replica's model rank 0 wrote its bank file, the others none."""
    rep = [r["runner"] for r in ranks]
    sharded = _untimed(rep[0]["mm_sharded"])
    assert len(sharded) == 2 * MULTIMODAL_VIDEOS
    assert sharded == _merged([rep[0]["mm_unsharded"], rep[2]["mm_unsharded"]],
                              _multimodal_annotations())
    assert all("mm_sharded" not in r and "sharded" not in r for r in rep[1:])
    assert rep[0]["mm_banks"] == ["memory_0.json"] and rep[2]["mm_banks"] == ["memory_1.json"]
    assert rep[1]["mm_banks"] == rep[3]["mm_banks"] == []


def test_runner_shard_matches_jax_num_chunks(ranks, runner_side):
    """The sharded --save_file equals the JAX runner's --num_chunks 2
    --chunk_idx 0 / 1 files merged by annotation index, record for record."""
    want = _merged([runner_side["jax"][0], runner_side["jax"][1]])
    assert len(want) == 2 * RUNNER_VIDEOS
    assert _untimed(ranks[0]["runner"]["sharded"]) == want


def test_runner_shard_no_file_written_by_two_ranks(ranks):
    """Rank 0 writes --save_file and replica 0's bank files, rank 2 (replica
    1's model rank 0) replica 1's, ranks 1 and 3 nothing."""
    written = [set(r["runner"]["written"]) for r in ranks]
    assert written[0] == {"sharded.json", "sharded/memory_0.json", "sharded/memory_2.json"}
    assert written[2] == {"sharded/memory_1.json", "sharded/memory_3.json"}
    assert written[1] == written[3] == set()


def test_online_collectives_in_the_same_order_on_every_rank(ranks):
    """Every rank takes the same all_reduces in the same order, and the
    answers' (the caller's thread) never interleave with the worker's
    captions: `ask` drains the queue first. Answers equal the unsharded."""
    trace = ranks[0]["online"][2]["trace"]
    assert all(r["online"][2]["trace"] == trace for r in ranks)
    assert ranks[0]["online"][1]["trace"] == []
    runs = [trace[0][0]]
    for role, _ in trace[1:]:
        if role != runs[-1]:
            runs.append(role)
    assert runs == ["worker", "main"] * 2, runs
    labels = {label for _, label in trace}
    assert labels == {"embed", "o", "down", "logits"}
    for r in ranks:
        assert r["online"][2]["answers"] == r["online"][1]["answers"]
