"""The port's tensor parallelism against the JAX package's, on the CPU.

Four gloo ranks (`tests/torch_parallel_ranks.py`, spawned once for the
module) run every case: tp 4 over the world, tp 2 over pairs of ranks. The
geometry is tiny in float32, with 8 query heads over 4 kv heads so that tp
2 and tp 4 both divide. The JAX side runs its sharded model on the
8-device CPU mesh (`tests/test_parallel.py`). Held:
- `best_mesh_shape` and `host_shard` equal to JAX's;
- rank slices of bf16, int8 and int4 trees put back together equal the
  whole, dequantized; an int4 column slice's codes and scales equal
  quantizing the sliced weight; an int4 row split inside a 128-row group
  raises;
- TP prefill logits within 1e-4 of JAX's sharded prefill at tp 2 and 4;
- greedy answers and batched captions equal to JAX's sharded LongVA;
- at tp 2, token-exact with the unsharded port: int4, kv_int8, spec 4, H2O
  under a budget, TextLM.shard; the NLL within 1e-5;
- every rank of a group returns the same tokens;
- the runner's --shard output file equal to the unsharded run's, written
  by rank 0 only;
- the on-line session takes its collectives in the same order on every
  rank, each answer's after the worker's captions.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamchat_tpu import config as jconfig
from streamchat_tpu.models import decoder as jdec
from streamchat_tpu.models.decoder import KVCache as JKVCache
from streamchat_tpu.models.longva import LongVA as JLongVA
from streamchat_tpu.ops import quant as jquant
from streamchat_tpu.parallel import best_mesh_shape as j_best_mesh_shape
from streamchat_tpu.parallel import decoder_pspecs, make_mesh as j_make_mesh, shard_pytree
from streamchat_tpu.parallel.multihost import host_shard as j_host_shard
from streamchat_tpu_torch import config, convert
from streamchat_tpu_torch.models import decoder
from streamchat_tpu_torch.models.textlm import TextLM
from streamchat_tpu_torch.models.tokenizer import ByteTokenizer
from streamchat_tpu_torch.ops import quant
from streamchat_tpu_torch.parallel import ModelGroup, best_mesh_shape, make_mesh
from streamchat_tpu_torch.parallel.multihost import host_shard
from streamchat_tpu_torch.parallel.sharding import rank_config, shard_decoder
from tests import torch_parallel_ranks

ATOL = 1e-4
PROMPT = "<image>\nwhat?"
PROMPTS = ["caption <image> one.", "caption <image> two, longer prompt."]


def _jcfg():
    return dataclasses.replace(jconfig.DecoderConfig.tiny(), num_heads=8, num_kv_heads=4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


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
    sharded = shard_pytree(jm.dec_params, decoder_pspecs(dcfg), mesh)
    logits, _ = jdec.prefill(sharded, dcfg, jnp.asarray(embeds),
                             JKVCache.create(dcfg, 2, 16, dtype=jnp.float32),
                             jnp.asarray(lengths))
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
                prefill_lengths=torch.from_numpy(lengths))
    jm.shard()
    answer = jm.generate_with_image_embedding(PROMPT, [jnp.asarray(feats)], max_new_tokens=4,
                                              temperature=0.0)
    batch = jm.generate_with_image_embedding_batch(
        PROMPTS, [[jnp.asarray(f[0])] for f in batch_feats], max_new_tokens=6,
        temperature=0.0)
    return dict(logits=np.asarray(logits), answer=answer, batch=batch, port=port)


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_ranks")
    inputs = str(tmp / "inputs.pt")
    torch.save(jax_side["port"], inputs)
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
    assert make_mesh() == ModelGroup() and make_mesh().all_reduce(torch.ones(2)).sum() == 2
    cfg = config.DecoderConfig(**dataclasses.asdict(_jcfg()))
    params = decoder.init(cfg, torch.Generator().manual_seed(0), dtype=torch.float32)
    lm = TextLM(params, cfg, ByteTokenizer(), torch.Generator().manual_seed(0))
    before = {id(v) for v in params["layers"][0]["attn"].values()}
    assert lm.shard() is lm and lm.cfg == cfg and "tp" not in lm.params
    assert {id(v) for v in lm.params["layers"][0]["attn"].values()} == before


def test_data_axis_raises(ranks):
    """A world whose best_mesh_shape has a data axis (4 ranks at 2 kv heads)."""
    assert "ROADMAP §A 'Multi-GPU: the data axis'" in ranks[0]["data_axis_error"]


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


def test_runner_shard_writes_the_unsharded_file(ranks):
    """Rank 0 writes the records and its bank file, equal to the unsharded
    run's; rank 1 (its pair) and the other pair write nothing."""
    rep = ranks[0]["runner"]
    assert rep["sharded"] == rep["unsharded"] and len(rep["sharded"]) == 2
    assert rep["sharded_bank"]
    for r in ranks[1:]:
        assert "sharded" not in r["runner"] and not r["runner"]["sharded_bank"]
        assert r["runner"]["unsharded"] == rep["unsharded"]


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
