"""The port's checkpoint loader (`models/weights`) against the JAX package's and HF's, on the CPU.

Tiny HF models (Qwen2 with qkv biases, LLaMA with an eos list and an untied
head, a CLIP vision tower, BERT with and without the "bert." prefix) are
saved with `save_pretrained` at f32 and bf16, as one safetensors file, as
shards under an index and as a torch `.bin`. The port's reader is held
bit-equal to `safetensors.safe_open` (every dtype, 0-d and empty tensors,
an index) and refuses a corrupt header; its trees are bit-equal to
`convert.to_torch` / `convert.vit_params` of the JAX loader's on the same
directory, with the configs equal field by field; its forwards agree with
HF's at `test_weights_parity.py`'s tolerances and its greedy tokens with
HF's `generate`. Also: quantized npz files cross between the packages both
ways, both packages' `load_tokenizer` agree on a tokenizer built here, the
judge CLI's `--llama3_path` JSONL is byte-equal to the JAX judge's and its
leaves stay on `--device`, `build_pipeline` loads the embedders as the JAX
package does, and the smoke's writer, HF maps and leaf check round-trip a
tiny pipeline through `build_pipeline` and reject the planted faults.
"""

import copy
import dataclasses
import importlib.util
import json
import os
import pathlib
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")

from safetensors import safe_open  # noqa: E402

from streamchat_tpu import config as jconfig  # noqa: E402
from streamchat_tpu.eval import judge as jjudge  # noqa: E402
from streamchat_tpu.models import decoder as jdec  # noqa: E402
from streamchat_tpu.models import tokenizer as jtokenizer  # noqa: E402
from streamchat_tpu.models import weights as jweights  # noqa: E402
from streamchat_tpu.models.embedder import TextEmbedder as JTextEmbedder  # noqa: E402
from streamchat_tpu.ops import quant as jquant  # noqa: E402
from streamchat_tpu_torch import config, convert, kernels  # noqa: E402
from streamchat_tpu_torch.eval import judge  # noqa: E402
from streamchat_tpu_torch.models import decoder, embedder, tokenizer, vit, weights  # noqa: E402
from streamchat_tpu_torch.models.longva import LongVA  # noqa: E402
from streamchat_tpu_torch.models.textlm import TextLM  # noqa: E402
from streamchat_tpu_torch.models.tokenizer import ByteTokenizer  # noqa: E402
from streamchat_tpu_torch.ops import quant  # noqa: E402
from streamchat_tpu_torch.pipeline import runner  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
KINDS = ("qwen2", "llama", "clip", "bert", "bert_prefixed")
LAYOUTS = ("single", "sharded", "bin")
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
# The CLIP tower of the HF parity test.
CLIP_CFG = dict(image_size=28, patch_size=14, hidden_size=32, intermediate_size=64,
                num_layers=3, num_heads=4)
# A word-level tokenizer's vocabulary: the LLaMA-3 header specials, then the
# judge prompt's words and marks, then fillers up to the tiny LLaMA's vocab.
SPECIALS = ["[UNK]", "<|begin_of_text|>", "<|end_of_text|>", "<|eot_id|>",
            "<|start_header_id|>", "<|end_header_id|>"]
TOKENIZER_VOCAB = 320
PREDICTIONS = [
    {"question": "What is on the table?", "label": "a cup", "predict": "A cup of tea.",
     "class": "object"},
    {"question": "Where are the keys?", "label": "in the drawer", "predict": "drawer",
     "class": "location", "process_time": 0.5},
    {"question": "Who came in?", "label": "a man", "predict": "nobody", "class": "person"},
]


@pytest.fixture
def no_launches():
    kernels.reset_launch_counts()
    yield
    assert all(v == 0 for v in kernels.launch_counts().values()), \
        "a CPU tensor must run the plain twin, never count a launch"


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _hf_model(kind):
    """A tiny HF model of `kind`, seeded."""
    torch.manual_seed(KINDS.index(kind))
    if kind == "qwen2":
        cfg = transformers.Qwen2Config(
            vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
            rope_theta=10000.0, tie_word_embeddings=False)
        return transformers.Qwen2ForCausalLM(cfg).eval()
    if kind == "llama":
        cfg = transformers.LlamaConfig(
            vocab_size=TOKENIZER_VOCAB, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=512, rope_theta=5e5, rms_norm_eps=1e-5,
            tie_word_embeddings=False, bos_token_id=1, eos_token_id=[2, 3])
        return transformers.LlamaForCausalLM(cfg).eval()
    if kind == "clip":
        cfg = transformers.CLIPVisionConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=3, num_attention_heads=4,
            image_size=28, patch_size=14, hidden_act="quick_gelu")
        return transformers.CLIPVisionModel(cfg).eval()
    cfg = transformers.BertConfig(vocab_size=TOKENIZER_VOCAB, hidden_size=32,
                                  num_hidden_layers=2, num_attention_heads=4,
                                  intermediate_size=64, max_position_embeddings=64)
    if kind == "bert_prefixed":        # saved under "bert.", with a head beside it
        return transformers.BertForSequenceClassification(cfg).eval()
    return transformers.BertModel(cfg, add_pooling_layer=False).eval()


def _save_tokenizer(path):
    """A word-level fast tokenizer (LLaMA-3's header specials, eos
    <|eot_id|>) saved with `PreTrainedTokenizerFast.save_pretrained`."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    text = " ".join(judge.build_judge_prompt(p["question"], p["label"], p["predict"])
                    for p in PREDICTIONS)
    for s in SPECIALS:
        text = text.replace(s, " ")
    pre = pre_tokenizers.Whitespace()
    words = sorted({w for w, _ in pre.pre_tokenize_str(text)})
    vocab = SPECIALS + words
    vocab += [f"w{i}" for i in range(TOKENIZER_VOCAB - len(vocab))]
    assert len(vocab) == TOKENIZER_VOCAB
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(vocab)}, unk_token="[UNK]"))
    tok.pre_tokenizer = pre
    fast = transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, unk_token="[UNK]", bos_token="<|begin_of_text|>",
        eos_token="<|eot_id|>", additional_special_tokens=SPECIALS[2:])
    fast.save_pretrained(path)


@pytest.fixture(scope="module")
def hf_models():
    return {kind: _hf_model(kind) for kind in KINDS}


@pytest.fixture(scope="module")
def ckpt(hf_models, tmp_path_factory):
    """(kind, dtype name, layout) -> a saved checkpoint directory (cached);
    the LLaMA and BERT directories also hold the tokenizer."""
    made = {}

    def get(kind, dtype="f32", layout="single"):
        if (kind, dtype, layout) not in made:
            path = tmp_path_factory.mktemp(f"{kind}_{dtype}_{layout}")
            model = hf_models[kind]
            if dtype == "bf16":
                model = copy.deepcopy(model).to(torch.bfloat16)
            kw = {"bin": dict(safe_serialization=False),
                  "sharded": dict(max_shard_size="20KB")}.get(layout, {})
            model.save_pretrained(path, **kw)
            if kind in ("llama", "bert", "bert_prefixed"):
                _save_tokenizer(path)
            made[kind, dtype, layout] = str(path)
        return made[kind, dtype, layout]
    return get


@pytest.fixture(scope="module")
def llava_dir(hf_models, tmp_path_factory):
    """A tiny llava_qwen checkpoint: the tiny Qwen2 LM, a CLIP tower at
    `ViTConfig.tiny`'s geometry under the LongVA prefix and a random
    mlp2x_gelu projector, in one f32 safetensors file."""
    qwen = hf_models["qwen2"]
    torch.manual_seed(11)
    tower = transformers.CLIPVisionModel(transformers.CLIPVisionConfig(
        hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
        image_size=56, patch_size=14, hidden_act="quick_gelu")).eval()
    d = qwen.config.hidden_size
    state = dict(qwen.state_dict())
    state.update({"model.vision_tower.vision_tower." + k: v
                  for k, v in tower.state_dict().items()})
    gen = torch.Generator().manual_seed(12)
    state.update({"model.mm_projector.0.weight": torch.randn(d, 64, generator=gen) * 0.1,
                  "model.mm_projector.0.bias": torch.randn(d, generator=gen) * 0.1,
                  "model.mm_projector.2.weight": torch.randn(d, d, generator=gen) * 0.1,
                  "model.mm_projector.2.bias": torch.randn(d, generator=gen) * 0.1})
    path = tmp_path_factory.mktemp("llava_qwen")
    safetensors_torch.save_file({k: v.contiguous() for k, v in state.items()},
                                str(path / "model.safetensors"))
    hf = json.loads(qwen.config.to_json_string())
    hf.update(model_type="llava_qwen", architectures=["LlavaQwenForCausalLM"],
              tokenizer_model_max_length=4096)
    (path / "config.json").write_text(json.dumps(hf))
    return str(path)


def _bits(t):
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[
        t.element_size()])


def _assert_tree(port, ref, dtype=None):
    """Port tree == reference tree (`convert.to_torch`: bf16 came as f32)
    bit for bit, each float leaf of the port's stored as `dtype`."""
    if isinstance(ref, dict):
        assert isinstance(port, dict) and port.keys() == ref.keys()
        for k in ref:
            _assert_tree(port[k], ref[k], dtype)
    elif isinstance(ref, list):
        assert isinstance(port, list) and len(port) == len(ref)
        for p, r in zip(port, ref):
            _assert_tree(p, r, dtype)
    else:
        assert port.device.type == "cpu" and port.shape == ref.shape
        if dtype is not None and port.is_floating_point():
            assert port.dtype == dtype
        if port.dtype == torch.bfloat16 and ref.dtype == torch.float32:
            port = port.float()
        assert port.dtype == ref.dtype and torch.equal(_bits(port), _bits(ref))


def _jax_tree(tree):
    return convert.to_torch(jax.tree.map(np.asarray, tree))


# ---------------------------------------------------------------------------
# The reader
# ---------------------------------------------------------------------------


def _example(dtype):
    gen = torch.Generator().manual_seed(5)
    if dtype == torch.bool:
        full = torch.rand(3, 5, generator=gen) > 0.5
    elif dtype.is_floating_point:
        full = torch.randn(3, 5, generator=gen).to(dtype)
    else:
        info = torch.iinfo(dtype)
        full = torch.randint(max(info.min, -1000), min(info.max, 1000), (3, 5),
                             generator=gen).to(dtype)
    return {"full": full, "scalar": full[1, 2].clone(), "empty": full[:0],
            "column": full[:, 1:2].contiguous()}


@pytest.mark.parametrize("name", sorted(weights.DTYPES))
def test_reader_matches_safe_open(tmp_path, name):
    """Every dtype, a 0-d and an empty tensor: bit-equal to safe_open, the
    CPU read owning its memory."""
    dtype = weights.DTYPES[name]
    path = str(tmp_path / "t.safetensors")
    safetensors_torch.save_file(_example(dtype), path)
    shards = weights.open_shards(str(tmp_path))
    assert isinstance(shards, weights.Shards) and sorted(shards) == sorted(_example(dtype))
    with safe_open(path, framework="pt") as f:
        for k in f.keys():
            ref, got = f.get_tensor(k), shards[k]
            assert got.dtype == ref.dtype == dtype and got.shape == ref.shape
            assert torch.equal(_bits(got), _bits(ref))


def test_reader_follows_the_index(ckpt):
    """A sharded save: the index's files, every tensor bit-equal to safe_open."""
    path = ckpt("qwen2", "bf16", "sharded")
    with open(os.path.join(path, "model.safetensors.index.json")) as f:
        files = sorted(set(json.load(f)["weight_map"].values()))
    assert len(files) > 2
    shards = weights.open_shards(path)
    seen = 0
    for fname in files:
        with safe_open(os.path.join(path, fname), framework="pt") as f:
            for k in f.keys():
                assert torch.equal(_bits(shards[k]), _bits(f.get_tensor(k)))
                seen += 1
    assert seen == len(shards)


def _raw_file(path, header, data):
    blob = json.dumps(header).encode()
    path.write_bytes(struct.pack("<Q", len(blob)) + blob + data)


@pytest.mark.parametrize("case", ["gap", "overlap", "size", "dtype", "short", "header_len",
                                  "entry"])
def test_reader_refuses_a_corrupt_header(tmp_path, case):
    good = {"a": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]},
            "b": {"dtype": "I8", "shape": [4], "data_offsets": [8, 12]}}
    header, data = copy.deepcopy(good), bytes(12)
    if case == "gap":
        header["b"]["data_offsets"] = [9, 13]
        data = bytes(13)
    elif case == "overlap":
        header["b"]["data_offsets"] = [4, 8]
    elif case == "size":
        header["a"]["shape"] = [3]
    elif case == "dtype":
        header["a"]["dtype"] = "F8_E9M9"
    elif case == "short":
        data = bytes(10)
    elif case == "entry":
        del header["b"]["shape"]
    path = tmp_path / "t.safetensors"
    _raw_file(path, header, data)
    if case == "header_len":
        path.write_bytes(struct.pack("<Q", 10**6) + path.read_bytes()[8:])
    with pytest.raises(ValueError):
        weights.read_header(str(path))
    _raw_file(path, good, bytes(12))
    assert set(weights.read_header(str(path))) == {"a", "b"}


@pytest.mark.parametrize("kind", ["llama", "bert_prefixed", "llava"])
def test_loaders_read_each_tensor_once(ckpt, llava_dir, monkeypatch, kind):
    """A load reads every tensor it maps exactly once, and nothing else:
    testing a name (`"lm_head.weight" in t`) reads no tensor."""
    read = []
    tensor = weights.Shards.tensor

    def counting(self, name, device="cpu"):
        read.append(name)
        return tensor(self, name, device)

    monkeypatch.setattr(weights.Shards, "tensor", counting)
    monkeypatch.setattr(weights, "ViTConfig", config.ViTConfig.tiny)
    if kind == "llama":
        path, (_, tree) = ckpt(kind), weights.load_decoder(ckpt(kind), device="cpu")
    elif kind == "bert_prefixed":
        path, (_, tree) = ckpt(kind), weights.load_bert(ckpt(kind), "cls", device="cpu")
    else:
        path, tree = llava_dir, weights.load_longva(llava_dir, device="cpu")[2:]
    assert len(read) == len(set(read))
    leaves = jax.tree_util.tree_leaves(tree)
    # The ViT's q, k and v read three tensors into one leaf each for w and b.
    merged = 4 * config.ViTConfig.tiny().num_layers if kind == "llava" else 0
    assert len(read) == len(leaves) + merged
    assert "lm_head.weight" in weights.open_shards(path) or kind != "llama"


def test_missing_weights_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="no safetensors/bin weights"):
        weights.open_shards(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        weights.load_decoder(str(tmp_path / "absent"), device="cpu")


def test_staged_copies_are_guarded_on_the_stream_of_the_target_device(tmp_path, monkeypatch):
    """A staged read onto a card that is not the current one: each pinned
    buffer's guard event is recorded on the current stream of the target's
    device, where its copy runs, not on the current device's. A one-card
    machine cannot show the race, so the stream each event records on is
    asserted here, with the CUDA calls stood in for and the target's device
    named "cuda:1" to the stream lookup."""
    data = torch.arange(40, dtype=torch.float32)
    safetensors_torch.save_file({"w": data}, str(tmp_path / "t.safetensors"))
    shards = weights.open_shards(str(tmp_path))
    target = torch.device("cuda", 1)
    recorded, asked = [], []

    class Event:
        def record(self, stream=None):
            recorded.append(stream)

        def synchronize(self):
            pass

    def current_stream(device=None):
        asked.append(device)
        return ("stream of", device)

    class Target(torch.Tensor):
        """A CPU tensor that names cuda:1 as its device."""
        @property
        def device(self):
            return target

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(weights, "STAGE_BYTES", 48)
    shards._stage = [torch.empty(48, dtype=torch.uint8) for _ in range(2)]
    out = torch.empty(160, dtype=torch.uint8).as_subclass(Target)
    with open(tmp_path / "t.safetensors", "rb", buffering=0) as f:
        f.seek(shards._entries["w"].start)
        shards._staged(f, out)
    assert torch.equal(torch.Tensor(out).view(torch.float32), data)
    assert asked == [target] and len(recorded) == 4
    assert recorded == [("stream of", target)] * 4


def test_smoke_writer_reads_back_in_safe_open(tmp_path, monkeypatch):
    """chip_smoke.write_checkpoint: shards of at most SHARD_BYTES under an
    index, views written in their logical order, every dtype; safe_open and
    the port's reader read each tensor back bit-equal."""
    smoke = _smoke()
    monkeypatch.setattr(smoke, "SHARD_BYTES", 64)
    base = torch.randn(6, 4, generator=torch.Generator().manual_seed(3))
    tensors = {"w.t": base.to(torch.bfloat16).t(), "w": base, "cut": base[:, 1:3],
               "scalar": base[2, 2].clone(), "empty": base[:0],
               **{f"x.{n}": _example(dt)["full"] for n, dt in weights.DTYPES.items()}}
    nbytes = smoke.write_checkpoint(str(tmp_path), {"model_type": "none"}, tensors)
    with open(tmp_path / "model.safetensors.index.json") as f:
        index = json.load(f)
    assert sorted(index["weight_map"]) == sorted(tensors)
    files = sorted(set(index["weight_map"].values()))
    assert len(files) > 3 and nbytes == sum(os.path.getsize(tmp_path / f) for f in files)
    shards = weights.open_shards(str(tmp_path))
    for fname in files:
        with safe_open(str(tmp_path / fname), framework="pt") as f:
            for k in f.keys():
                ref = tensors[k]
                assert torch.equal(_bits(f.get_tensor(k)), _bits(ref.contiguous()))
                assert torch.equal(_bits(shards[k]), _bits(ref.contiguous()))


# ---------------------------------------------------------------------------
# Trees against the JAX loader
# ---------------------------------------------------------------------------


def _load_both(kind, path, dtype_name):
    """(port config, port tree, JAX config, JAX tree as torch) of `kind`."""
    tdt, jdt = DTYPES[dtype_name]
    if kind in ("qwen2", "llama"):
        pc, pt = weights.load_decoder(path, tdt, device="cpu")
        jc, jt = jweights.load_decoder(path, jdt)
        return pc, pt, jc, _jax_tree(jt)
    if kind == "clip":
        pc, jc = config.ViTConfig(**CLIP_CFG), jconfig.ViTConfig(**CLIP_CFG)
        pt = weights.map_vit(weights.open_shards(path), pc, tdt, prefix="vision_model.",
                             device="cpu")
        jt = jweights.map_vit(jweights._open_shards(path), jc, jdt, prefix="vision_model.")
        return pc, pt, jc, convert.vit_params(jax.tree.map(np.asarray, jt))
    pc, pt = weights.load_bert(path, "cls", tdt, device="cpu")
    jc, jt = jweights.load_bert(path, "cls", jdt)
    return pc, pt, jc, _jax_tree(jt)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("kind", KINDS)
def test_tree_matches_jax(ckpt, kind, dtype_name, layout):
    path = ckpt(kind, dtype_name, layout)
    pc, pt, jc, jt = _load_both(kind, path, dtype_name)
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    _assert_tree(pt, jt, DTYPES[dtype_name][0])
    if kind == "qwen2":
        assert pc.qkv_bias and "b" in pt["layers"][0]["attn"]["q"]
    if kind == "llama":
        assert not pc.qkv_bias and pc.eos_token_id == 2 and "lm_head" in pt


def test_bf16_load_of_an_f32_file_rounds_as_jax(ckpt):
    """The loaders' default dtype casts f32 weights to bf16 on the device,
    bit-equal to the JAX cast."""
    path = ckpt("llama")
    _, pt = weights.load_decoder(path, device="cpu")
    _, jt = jweights.load_decoder(path)
    _assert_tree(pt, _jax_tree(jt), torch.bfloat16)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_load_longva_matches_jax(llava_dir, monkeypatch, dtype_name):
    """load_longva on a tiny llava_qwen checkpoint (both packages'
    weights.ViTConfig patched to the tiny tower): the five results equal."""
    monkeypatch.setattr(weights, "ViTConfig", config.ViTConfig.tiny)
    monkeypatch.setattr(jweights, "ViTConfig", jconfig.ViTConfig.tiny)
    tdt, jdt = DTYPES[dtype_name]
    pv, pd, pvit, pproj, pdec = weights.load_longva(llava_dir, tdt, device="cpu")
    jv, jd, jvit, jproj, jdec_p = jweights.load_longva(llava_dir, jdt)
    assert dataclasses.asdict(pv) == dataclasses.asdict(jv)
    assert dataclasses.asdict(pd) == dataclasses.asdict(jd)
    assert pd.qkv_bias and pd.max_position_embeddings == 4096 and pv.projection_dim == 32
    _assert_tree(pvit, convert.vit_params(jax.tree.map(np.asarray, jvit)), tdt)
    _assert_tree(pproj, _jax_tree(jproj), tdt)
    _assert_tree(pdec, _jax_tree(jdec_p), tdt)


# ---------------------------------------------------------------------------
# Forwards against HF
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["qwen2", "llama"])
def test_decoder_logits_match_hf(ckpt, hf_models, no_launches, kind):
    cfg, params = weights.load_decoder(ckpt(kind), torch.float32, device="cpu")
    ids = torch.tensor([[3, 17, 42, 99, 7, 23]])
    with torch.no_grad():
        ref = hf_models[kind](ids).logits
    s = ids.shape[1]
    cache = decoder.KVCache.create(cfg, 1, s, dtype=torch.float32)
    hidden, _ = decoder.forward(params, cfg, decoder.embed_tokens(params, ids),
                                torch.arange(s)[None], cache, torch.tensor([s]))
    ours = decoder.logits_from_hidden(params, cfg, hidden)
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=2e-4, rtol=2e-3)


def test_vit_matches_hf(ckpt, hf_models, no_launches):
    cfg = config.ViTConfig(**CLIP_CFG)
    params = weights.map_vit(weights.open_shards(ckpt("clip")), cfg, torch.float32,
                             prefix="vision_model.", device="cpu")
    pixels = torch.from_numpy(
        np.random.default_rng(0).normal(size=(2, 3, 28, 28)).astype(np.float32))
    with torch.no_grad():
        ref = hf_models["clip"](pixels, output_hidden_states=True).hidden_states[-2][:, 1:]
    ours = vit.encode(params, pixels, cfg)
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=3e-4, rtol=2e-3)


@pytest.mark.parametrize("kind", ["bert", "bert_prefixed"])
def test_bert_matches_hf(ckpt, hf_models, kind):
    cfg, params = weights.load_bert(ckpt(kind), "cls", torch.float32, device="cpu")
    ids = torch.tensor([[2, 5, 9, 14, 3, 0, 0, 0]])
    mask = torch.tensor([[1, 1, 1, 1, 1, 0, 0, 0]])
    model = hf_models[kind]
    model = getattr(model, "bert", model)
    with torch.no_grad():
        ref = model(input_ids=ids, attention_mask=mask).last_hidden_state
    ours = embedder.forward(params, cfg, ids, mask)
    # Padded positions attend to garbage in both; compare the valid prefix.
    np.testing.assert_allclose(ours[:, :5].numpy(), ref[:, :5].numpy(), atol=3e-4, rtol=2e-3)


def test_longva_greedy_tokens_match_hf(llava_dir, hf_models, monkeypatch, no_launches):
    """Twelve greedy tokens of `LongVA.from_pretrained` (f32, the byte
    tokenizer) through `generate_with_image_embedding` equal HF's
    `generate` from the same spliced embeddings."""
    monkeypatch.setattr(weights, "ViTConfig", config.ViTConfig.tiny)
    model = LongVA.from_pretrained(llava_dir, torch.float32, device="cpu",
                                   tokenizer=ByteTokenizer())
    assert model.device.type == "cpu" and model.vit_cfg == config.ViTConfig.tiny(32)
    hf = hf_models["qwen2"]
    tok = ByteTokenizer()
    prompt = "user: describe <image> now\nassistant:"
    feats = torch.from_numpy(np.random.default_rng(7).normal(
        size=(3, hf.config.hidden_size)).astype(np.float32) * 0.1)
    pre, suf = prompt.split("<image>")
    emb = hf.get_input_embeddings()
    with torch.no_grad():
        embeds = torch.cat([emb(torch.tensor([tok.encode(pre)])), feats[None],
                            emb(torch.tensor([tok.encode(suf)]))], dim=1)
        hf_tokens = hf.generate(inputs_embeds=embeds,
                                attention_mask=torch.ones(embeds.shape[:2], dtype=torch.long),
                                max_new_tokens=12, do_sample=False)[0].tolist()
    assert len(hf_tokens) == 12
    out = model.generate_with_image_embedding(prompt, [feats], max_new_tokens=12,
                                              temperature=0.0)
    assert out == tok.decode(hf_tokens).strip()


# ---------------------------------------------------------------------------
# Quantized npz files
# ---------------------------------------------------------------------------


def _jax_quantized(bits, dtype=jnp.float32):
    jcfg = jconfig.DecoderConfig.tiny()
    return jquant.quantize_decoder_params(jdec.init(jax.random.key(3), jcfg, dtype), bits=bits)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_npz_crosses_packages(tmp_path, bits):
    """A file JAX's save_quantized writes loads in the port bit-equal to
    convert.to_torch of the JAX tree, and the port's file of that tree
    holds the same arrays under the same keys and loads in JAX the same."""
    jtree = _jax_quantized(bits)
    ref = _jax_tree(jtree)
    jweights.save_quantized(jtree, str(tmp_path / "jax.npz"))
    _assert_tree(weights.load_quantized(str(tmp_path / "jax.npz"), torch.float32,
                                        device="cpu"), ref)
    weights.save_quantized(ref, str(tmp_path / "port.npz"))
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    _assert_tree(_jax_tree(jweights.load_quantized(str(tmp_path / "port.npz"), jnp.float32)),
                 ref)
    layer = ref["layers"][0]["attn"]["q"]
    assert layer["w_i8" if bits == 8 else "w_i4p"].dtype == torch.int8


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_bf16_npz_round_trip(tmp_path, bits):
    """A bf16 quantized tree: the port's own file round-trips bit-equal
    (bf16 leaves as numpy's 2-byte void, as numpy writes the JAX
    package's), and the JAX package's file of a bf16 tree loads in the
    port bit-equal to its tree."""
    gen = torch.Generator().manual_seed(4)
    tree = quant.quantize_decoder_params(
        decoder.init(config.DecoderConfig.tiny(), gen, dtype=torch.bfloat16), bits=bits)
    path = str(tmp_path / "port")
    weights.save_quantized(tree, path)
    got = weights.load_quantized(path, device="cpu")
    assert got["embed"].dtype == torch.bfloat16
    _assert_tree(got, tree)
    jtree = _jax_quantized(bits, jnp.bfloat16)
    jweights.save_quantized(jtree, str(tmp_path / "jax.npz"))
    got = weights.load_quantized(str(tmp_path / "jax.npz"), device="cpu")
    assert got["embed"].dtype == torch.bfloat16
    _assert_tree(got, _jax_tree(jtree))


# ---------------------------------------------------------------------------
# Tokenizers and entry points
# ---------------------------------------------------------------------------


def test_load_tokenizer_matches_jax(ckpt, tmp_path):
    path = ckpt("llama")
    port, ref = tokenizer.load_tokenizer(path), jtokenizer.load_tokenizer(path)
    assert isinstance(port, tokenizer.HFTokenizer) and port.vocab_size == TOKENIZER_VOCAB
    texts = [judge.build_judge_prompt(p["question"], p["label"], p["predict"])
             for p in PREDICTIONS] + ["What is on the table ?", "unknown words here", ""]
    for text in texts:
        for special in (True, False):
            ids = port.encode(text, add_special_tokens=special)
            assert ids == ref.encode(text, add_special_tokens=special)
            assert port.decode(ids) == ref.decode(ids)
    assert port.encode(texts[0], add_special_tokens=False)[0] == SPECIALS.index(
        "<|begin_of_text|>")
    assert port.eos_ids == ref.eos_ids and SPECIALS.index("<|eot_id|>") in port.eos_ids
    for missing in (None, str(tmp_path / "absent")):
        assert isinstance(tokenizer.load_tokenizer(missing), ByteTokenizer)


def _judge_argv(tmp_path, name, llama_dir):
    pred_file = tmp_path / "preds.json"
    pred_file.write_text(json.dumps(PREDICTIONS))
    return ["--predict_file", str(pred_file), "--output_dir", str(tmp_path / "out"),
            "--output_name", name, "--batch_size", "2", "--llama3_path", llama_dir]


def test_judge_llama3_path_matches_jax(ckpt, tmp_path, no_launches):
    """`--llama3_path` loads the checkpoint and its tokenizer in both
    packages; the JSONL files are byte-equal."""
    path = ckpt("llama")
    jjudge.main(_judge_argv(tmp_path, "jax", path))
    judge.main(_judge_argv(tmp_path, "port", path) + ["--device", "cpu"])
    port, ref = (tmp_path / "out" / "port.jsonl").read_bytes(), \
        (tmp_path / "out" / "jax.jsonl").read_bytes()
    assert port == ref and len(port.splitlines()) == len(PREDICTIONS)


def test_judge_loads_onto_the_requested_device(ckpt, tmp_path, monkeypatch, no_launches):
    """`--device cpu` reaches the loader: every leaf of the judge's tree
    lies on the CPU, stored bf16 (the loader's default)."""
    made = []
    load = TextLM.from_pretrained.__func__

    def recording(cls, path, *a, **kw):
        made.append((load(cls, path, *a, **kw), kw))
        return made[-1][0]

    monkeypatch.setattr(TextLM, "from_pretrained", classmethod(recording))
    judge.main(_judge_argv(tmp_path, "judged", ckpt("llama")) + ["--device", "cpu"])
    (lm, kw), = made
    assert kw["device"] == torch.device("cpu")
    leaves = jax.tree_util.tree_leaves(lm.params)
    assert leaves and all(t.device.type == "cpu" and t.dtype == torch.bfloat16 for t in leaves)
    assert isinstance(lm.tokenizer, tokenizer.HFTokenizer)


def test_build_pipeline_loads_embedders_like_jax(ckpt):
    """The colbert and MiniLM paths load through TextEmbedder.from_pretrained
    (f32, max_length 256, the checkpoint's tokenizer): trees equal to the
    JAX package's, embeddings within 1e-5; the unset LongVA path stays
    random at the tiny geometry."""
    plain, prefixed = ckpt("bert"), ckpt("bert_prefixed")
    cfg = config.PipelineConfig(paths=config.ModelPaths(colbert=plain, minilm=prefixed))
    pipe = runner.build_pipeline(cfg, device="cpu", geometry="tiny", dtype=torch.float32)
    assert pipe.model.dec_cfg == config.DecoderConfig.tiny()
    texts = ["What is on the table ?", "a cup of tea", ""]
    for emb, path, pooling in ((pipe.tree_embedder, plain, "cls"),
                               (pipe.bank_embedder, prefixed, "mean")):
        ref = JTextEmbedder.from_pretrained(path, pooling)
        assert dataclasses.asdict(emb.cfg) == dataclasses.asdict(ref.cfg)
        assert emb.cfg.pooling == pooling and emb.max_length == ref.max_length == 256
        assert isinstance(emb.tokenizer, tokenizer.HFTokenizer)
        _assert_tree(emb.params, _jax_tree(ref.params), torch.float32)
        np.testing.assert_allclose(emb.embed(texts).numpy(), np.asarray(ref.embed(texts)),
                                   atol=1e-5, rtol=1e-5)


def test_smoke_round_trip_and_planted_faults(tmp_path, monkeypatch, no_launches):
    """The smoke's checkpoint path at the tiny geometry: a random pipeline
    written with its HF maps (LongVA as llava_qwen, colbert under "bert.",
    MiniLM without) and built back with `build_pipeline` from the three
    paths (the byte tokenizer) is equal leaf for leaf, configs included;
    each planted writer fault is rejected and its control passes."""
    smoke = _smoke()
    monkeypatch.setattr(weights, "ViTConfig", config.ViTConfig.tiny)
    written = runner.build_pipeline(config.PipelineConfig(), device="cpu", geometry="tiny",
                                    dtype=torch.bfloat16)
    m, tree, bank = written.model, written.tree_embedder, written.bank_embedder
    paths = {name: str(tmp_path / name) for name in ("longva", "colbert", "minilm")}
    smoke.write_checkpoint(paths["longva"], smoke.longva_config(m.dec_cfg, m.vit_cfg), {
        **smoke.hf_vit(m.vit_params, m.vit_cfg), **smoke.hf_projector(m.proj_params),
        **smoke.hf_decoder(m.dec_params)})
    smoke.write_checkpoint(paths["colbert"], smoke.bert_config(tree.cfg),
                           smoke.hf_bert(tree.params, prefix="bert."))
    smoke.write_checkpoint(paths["minilm"], smoke.bert_config(bank.cfg),
                           smoke.hf_bert(bank.params))
    assert any(k.startswith("bert.") for k in weights.open_shards(paths["colbert"]))
    pipe = runner.build_pipeline(config.PipelineConfig(paths=config.ModelPaths(**paths)),
                                 device="cpu", geometry="tiny", tokenizer=ByteTokenizer())
    got = pipe.model
    assert (got.dec_cfg, got.vit_cfg) == (m.dec_cfg, m.vit_cfg)
    assert (pipe.tree_embedder.cfg, pipe.bank_embedder.cfg) == (tree.cfg, bank.cfg)
    for w, g in ((m.vit_params, got.vit_params), (m.proj_params, got.proj_params),
                 (m.dec_params, got.dec_params), (tree.params, pipe.tree_embedder.params),
                 (bank.params, pipe.bank_embedder.params)):
        assert smoke.leaf_mismatches(w, g) == []
    got.dec_params["layers"][1]["mlp"]["up"][0, 0] += 1
    assert smoke.leaf_mismatches(m.dec_params, got.dec_params) == ["/layers/1/mlp/up"]
    rejected = smoke.check_loader_faults(m, str(tmp_path))
    assert len(rejected) == 3
    assert all(bad for bad in rejected.values())
    qk, o0, down = rejected.values()
    assert "/layers/1/attn/q/w" in qk and "/layers/1/attn/k/w" in qk
    assert o0 == ["/layers/0/attn/o/w"] and down == ["/layers/1/mlp/down"]
