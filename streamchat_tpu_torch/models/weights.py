"""HF checkpoints -> the port's parameter trees (`streamchat_tpu/models/weights.py`).

Reads safetensors files with a reader of its own (`open_shards`: the
header parsed with `json`, each tensor read from its file when it is asked
for), so a bf16 checkpoint loads without `safetensors` or `ml_dtypes`, and
the host holds about one tensor at a time, not the checkpoint. The maps put
HF parameter names onto the port's trees: Linear weights go from HF's
[out, in] to the port's [in, out], and each ViT layer's q, k and v
projections are merged into the `attn.wqkv` / `attn.bqkv` its K1 kernel
reads (as `convert.vit_params` builds them). Every leaf is read onto
`device` first, then cast and transposed there.

Supported checkpoints:
* LongVA / llava_qwen (Qwen2 LM + CLIP tower + mm_projector), `load_longva`;
* plain Qwen2 / LLaMA-3 causal LMs (the judge), `load_decoder`;
* BERT-family encoders (mxbai-colbert, MiniLM), `load_bert`.

`save_quantized` / `load_quantized` keep the JAX package's flat npz format
and casting rules, so a file written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import struct
from typing import Dict, Iterator, List, Mapping, Tuple

import numpy as np
import torch

from streamchat_tpu_torch.config import BertConfig, DecoderConfig, ViTConfig

# safetensors dtype names -> torch dtypes.
DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
# Bytes a read onto the card stages through pinned host memory at a time
# (two such buffers alternate, so the file read overlaps the copy).
STAGE_BYTES = 64 << 20


@dataclasses.dataclass(frozen=True)
class TensorEntry:
    """Where one tensor lies in a safetensors file."""

    file: str
    dtype: torch.dtype
    shape: Tuple[int, ...]
    start: int          # absolute byte offset of the data in `file`
    nbytes: int


def read_header(path: str) -> Dict[str, TensorEntry]:
    """Parse one safetensors file's header -> name -> entry.

    Layout: an 8-byte little-endian header length, a JSON header naming
    each tensor's dtype, shape and [begin, end) data offsets, then the raw
    bytes. Raises ValueError for an unknown dtype, a size that disagrees
    with its shape, or offsets that do not tile the data exactly."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: {size} bytes, too short for a safetensors header")
        (n,) = struct.unpack("<Q", head)
        if n > size - 8:
            raise ValueError(f"{path}: a {n}-byte header in a {size}-byte file")
        header = json.loads(f.read(n))
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the header is not a JSON object")
    base = 8 + n
    entries = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if not isinstance(info, dict) or not {"dtype", "shape", "data_offsets"} <= info.keys():
            raise ValueError(f"{path}: {name}'s entry lacks dtype, shape or data_offsets")
        dtype = DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has unknown dtype {info['dtype']!r}")
        shape = tuple(int(d) for d in info["shape"])
        begin, end = (int(o) for o in info["data_offsets"])
        nbytes = math.prod(shape) * dtype.itemsize
        if end - begin != nbytes or begin < 0:
            raise ValueError(f"{path}: {name} {info['dtype']}{list(shape)} needs {nbytes} "
                             f"bytes, its offsets [{begin}, {end}) hold {end - begin}")
        entries[name] = TensorEntry(path, dtype, shape, base + begin, nbytes)
    pos = base
    for e in sorted(entries.values(), key=lambda e: (e.start, e.nbytes)):
        if e.start != pos:
            raise ValueError(f"{path}: tensor offsets do not tile the data (a tensor "
                             f"starts at byte {e.start - base}, the previous ends at "
                             f"{pos - base})")
        pos += e.nbytes
    if pos != size:
        raise ValueError(f"{path}: the tensors end at byte {pos}, the file at {size}")
    return entries


def _read_into(f, buf: np.ndarray) -> None:
    view, got = memoryview(buf).cast("B"), 0
    while got < len(view):
        k = f.readinto(view[got:])
        if not k:
            raise ValueError(f"{f.name}: the file ended inside a tensor")
        got += k


class Shards(Mapping):
    """A checkpoint's safetensors tensors by name, each read from its file
    when asked for: `shards[name]` gives a CPU tensor, `tensor(name,
    device)` reads straight onto `device` (through two pinned staging
    buffers of STAGE_BYTES for a card)."""

    def __init__(self, files: List[str]) -> None:
        self._entries: Dict[str, TensorEntry] = {}
        for path in files:
            self._entries.update(read_header(path))
        self._stage: List[torch.Tensor] = []

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.tensor(name, "cpu")

    def __contains__(self, name) -> bool:
        # Mapping's own `in` would read the tensor (lm_head: 1 GB at 7B).
        return name in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def tensor(self, name: str, device="cpu") -> torch.Tensor:
        e = self._entries[name]
        device = torch.device(device)
        out = torch.empty(e.nbytes, dtype=torch.uint8, device=device)
        with open(e.file, "rb", buffering=0) as f:
            f.seek(e.start)
            if device.type == "cpu":
                _read_into(f, out.numpy())
            else:
                self._staged(f, out)
        return out.view(e.dtype).reshape(e.shape)

    def _staged(self, f, out: torch.Tensor) -> None:
        """Read the file into `out` on the card, one pinned buffer filling
        while the other's copy runs. A copy runs on the current stream of
        `out`'s device, which need not be the current device: the event
        that guards its buffer is recorded on that stream."""
        if not self._stage:
            self._stage = [torch.empty(STAGE_BYTES, dtype=torch.uint8, pin_memory=True)
                           for _ in range(2)]
        copied = [None, None]
        stream = torch.cuda.current_stream(out.device)
        pos, i = 0, 0
        while pos < out.numel():
            k = min(STAGE_BYTES, out.numel() - pos)
            if copied[i] is not None:
                copied[i].synchronize()
            _read_into(f, self._stage[i].numpy()[:k])
            out[pos:pos + k].copy_(self._stage[i][:k], non_blocking=True)
            copied[i] = torch.cuda.Event()
            copied[i].record(stream)
            pos, i = pos + k, 1 - i
        for event in copied:
            if event is not None:
                event.synchronize()


def open_shards(path: str):
    """The weights under `path`: a `Shards` over its safetensors files (the
    ones `model.safetensors.index.json` lists, else every `*.safetensors`),
    or else every `*.bin` state dict read at once and cast to f32, as the
    JAX package does. FileNotFoundError when there is neither."""
    index_file = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index_file):
        with open(index_file) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
    else:
        files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if files:
        return Shards([os.path.join(path, f) for f in files])
    tensors: Dict[str, torch.Tensor] = {}
    for fname in sorted(f for f in os.listdir(path) if f.endswith(".bin")):
        sd = torch.load(os.path.join(path, fname), map_location="cpu", weights_only=True)
        tensors.update((k, v.to(torch.float32)) for k, v in sd.items())
    if not tensors:
        raise FileNotFoundError(f"no safetensors/bin weights under {path}")
    return tensors


def _read_config(path: str) -> dict:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


def _fetch(t: Mapping, name: str, device) -> torch.Tensor:
    if isinstance(t, Shards):
        return t.tensor(name, device)
    return torch.as_tensor(t[name]).to(device)


def _leaf(t: Mapping, name: str, dtype, device, transpose: bool = False) -> torch.Tensor:
    """One tensor onto `device`, then cast (and transposed) there."""
    x = _fetch(t, name, device).to(dtype)
    return x.t().contiguous() if transpose else x


def _linear(t: Mapping, name: str, dtype, device, bias: bool = False) -> dict:
    out = {"w": _leaf(t, f"{name}.weight", dtype, device, transpose=True)}
    if bias:
        out["b"] = _leaf(t, f"{name}.bias", dtype, device)
    return out


def _ln(t: Mapping, name: str, dtype, device) -> dict:
    return {"scale": _leaf(t, f"{name}.weight", dtype, device),
            "bias": _leaf(t, f"{name}.bias", dtype, device)}


# ---------------------------------------------------------------------------
# Decoder (Qwen2 / LLaMA-3)
# ---------------------------------------------------------------------------


def decoder_config_from_hf(cfg: dict) -> DecoderConfig:
    head_dim = cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"]
    eos = cfg.get("eos_token_id", 0)
    if isinstance(eos, list):
        eos = eos[0]
    return DecoderConfig(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
        head_dim=head_dim,
        rope_theta=cfg.get("rope_theta", 1e4),
        rms_eps=cfg.get("rms_norm_eps", 1e-6),
        qkv_bias=cfg.get("model_type", "") == "qwen2" or "qwen" in cfg.get("model_type", ""),
        tie_embeddings=cfg.get("tie_word_embeddings", False),
        max_position_embeddings=cfg.get(
            "tokenizer_model_max_length", cfg.get("max_position_embeddings", 32768)),
        eos_token_id=eos,
        pad_token_id=cfg.get("pad_token_id") or 0,
    )


def longva_decoder_config(path: str) -> DecoderConfig:
    """The decoder config of the LongVA checkpoint at `path` (its config.json
    alone)."""
    return decoder_config_from_hf(_read_config(path))


def map_decoder(t: Mapping, cfg: DecoderConfig, dtype, prefix: str = "model.", *,
                device="cuda") -> dict:
    layers = []
    for i in range(cfg.num_layers):
        p = f"{prefix}layers.{i}."
        layers.append({
            "input_norm": _leaf(t, p + "input_layernorm.weight", dtype, device),
            "attn": {
                "q": _linear(t, p + "self_attn.q_proj", dtype, device, cfg.qkv_bias),
                "k": _linear(t, p + "self_attn.k_proj", dtype, device, cfg.qkv_bias),
                "v": _linear(t, p + "self_attn.v_proj", dtype, device, cfg.qkv_bias),
                "o": _linear(t, p + "self_attn.o_proj", dtype, device),
            },
            "post_norm": _leaf(t, p + "post_attention_layernorm.weight", dtype, device),
            "mlp": {n: _leaf(t, f"{p}mlp.{n}_proj.weight", dtype, device, transpose=True)
                    for n in ("gate", "up", "down")},
        })
    params = {
        "embed": _leaf(t, prefix + "embed_tokens.weight", dtype, device),
        "layers": layers,
        "final_norm": _leaf(t, prefix + "norm.weight", dtype, device),
    }
    if not cfg.tie_embeddings and "lm_head.weight" in t:
        params["lm_head"] = _leaf(t, "lm_head.weight", dtype, device, transpose=True)
    return params


def load_decoder(path: str, dtype=torch.bfloat16, *,
                 device="cuda") -> Tuple[DecoderConfig, dict]:
    """Plain causal LM checkpoint (e.g. the LLaMA-3 judge) on `device`."""
    cfg = decoder_config_from_hf(_read_config(path))
    return cfg, map_decoder(open_shards(path), cfg, dtype, device=device)


# ---------------------------------------------------------------------------
# CLIP vision tower + projector (LongVA multimodal checkpoint)
# ---------------------------------------------------------------------------

_VIT_PREFIX = "model.vision_tower.vision_tower.vision_model."


def map_vit(t: Mapping, cfg: ViTConfig, dtype, prefix: str = _VIT_PREFIX, *,
            device="cuda") -> dict:
    conv = _fetch(t, prefix + "embeddings.patch_embedding.weight", device)  # [D, 3, ps, ps]
    patch_w = conv.reshape(conv.shape[0], -1).t().to(dtype).contiguous()   # [3*ps*ps, D]
    del conv
    layers = []
    for i in range(cfg.num_layers):
        p = f"{prefix}encoder.layers.{i}."
        layers.append({
            "ln1": _ln(t, p + "layer_norm1", dtype, device),
            "attn": {
                "wqkv": torch.cat([_leaf(t, f"{p}self_attn.{n}_proj.weight", dtype, device,
                                         transpose=True) for n in "qkv"], dim=1),
                "bqkv": torch.cat([_leaf(t, f"{p}self_attn.{n}_proj.bias", dtype, device)
                                   for n in "qkv"]),
                "o": _linear(t, p + "self_attn.out_proj", dtype, device, bias=True),
            },
            "ln2": _ln(t, p + "layer_norm2", dtype, device),
            "mlp": {"fc1": _linear(t, p + "mlp.fc1", dtype, device, bias=True),
                    "fc2": _linear(t, p + "mlp.fc2", dtype, device, bias=True)},
        })
    return {
        "patch_embed": {"w": patch_w},
        "class_embed": _leaf(t, prefix + "embeddings.class_embedding", dtype, device),
        "pos_embed": _leaf(t, prefix + "embeddings.position_embedding.weight", dtype, device),
        # HF ships the typo'd name "pre_layrnorm".
        "pre_ln": _ln(t, prefix + "pre_layrnorm", dtype, device),
        "layers": layers,
    }


def map_projector(t: Mapping, dtype, prefix: str = "model.mm_projector.", *,
                  device="cuda") -> dict:
    return {"fc1": _linear(t, prefix + "0", dtype, device, bias=True),
            "fc2": _linear(t, prefix + "2", dtype, device, bias=True)}


def load_longva(path: str, dtype=torch.bfloat16, *, device="cuda"):
    """LongVA llava_qwen checkpoint -> (vit_cfg, dec_cfg, vit_p, proj_p,
    dec_p) on `device`."""
    dec_cfg = longva_decoder_config(path)
    vit_cfg = ViTConfig(projection_dim=dec_cfg.hidden_size)
    t = open_shards(path)
    return (
        vit_cfg,
        dec_cfg,
        map_vit(t, vit_cfg, dtype, device=device),
        map_projector(t, dtype, device=device),
        map_decoder(t, dec_cfg, dtype, device=device),
    )


# ---------------------------------------------------------------------------
# BERT encoders (mxbai-colbert, MiniLM)
# ---------------------------------------------------------------------------


def bert_config_from_hf(cfg: dict, pooling: str) -> BertConfig:
    return BertConfig(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        max_position_embeddings=cfg["max_position_embeddings"],
        type_vocab_size=cfg.get("type_vocab_size", 2),
        layernorm_eps=cfg.get("layer_norm_eps", 1e-12),
        pooling=pooling,
    )


def map_bert(t: Mapping, cfg: BertConfig, dtype, *, device="cuda") -> dict:
    # An optional "bert." prefix is stripped from the names.
    names = {k[len("bert."):] if k.startswith("bert.") else k: k for k in t}

    def leaf(name, transpose=False):
        return _leaf(t, names[name], dtype, device, transpose)

    def lin(name):
        return {"w": leaf(name + ".weight", transpose=True), "b": leaf(name + ".bias")}

    def ln(name):
        return {"scale": leaf(name + ".weight"), "bias": leaf(name + ".bias")}

    layers = []
    for i in range(cfg.num_layers):
        p = f"encoder.layer.{i}."
        layers.append({
            "attn": {
                "q": lin(p + "attention.self.query"),
                "k": lin(p + "attention.self.key"),
                "v": lin(p + "attention.self.value"),
                "o": lin(p + "attention.output.dense"),
            },
            "attn_ln": ln(p + "attention.output.LayerNorm"),
            "mlp": {"fc1": lin(p + "intermediate.dense"), "fc2": lin(p + "output.dense")},
            "mlp_ln": ln(p + "output.LayerNorm"),
        })
    return {
        "word_embed": leaf("embeddings.word_embeddings.weight"),
        "pos_embed": leaf("embeddings.position_embeddings.weight"),
        "type_embed": leaf("embeddings.token_type_embeddings.weight"),
        "embed_ln": ln("embeddings.LayerNorm"),
        "layers": layers,
    }


def load_bert(path: str, pooling: str, dtype=torch.bfloat16, *,
              device="cuda") -> Tuple[BertConfig, dict]:
    cfg = bert_config_from_hf(_read_config(path), pooling)
    return cfg, map_bert(open_shards(path), cfg, dtype, device=device)


# ---------------------------------------------------------------------------
# Quantized checkpoint save / load (int8 / int4 weight-only serving format)
# ---------------------------------------------------------------------------


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        # numpy has no bf16: its two bytes go as a 2-byte void, which is
        # what numpy writes for the JAX package's (ml_dtypes) bf16 leaves.
        return x.view(torch.int16).numpy().view(np.dtype("V2"))
    return x.numpy()


def save_quantized(params: dict, path: str) -> None:
    """Persist a quantized decoder tree (ops/quant layout) as one .npz of
    flat leaves keyed by their dotted paths, the JAX package's format."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}.{k}" if prefix else k, v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}.{i}", v)
        else:
            flat[prefix] = _to_numpy(node)

    walk("", params)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def load_quantized(path: str, dtype=torch.bfloat16, *, device="cuda") -> dict:
    """Load a save_quantized file (either package's) back into the nested
    tree on `device`: int8 leaves and f32 "scale" leaves keep their dtype,
    every other leaf is cast to `dtype`, as in the JAX package."""
    root: dict = {}
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        for key in data.files:
            parts = key.split(".")
            node = root
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            arr = data[key]
            if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:      # a bf16 leaf
                val = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                val = torch.from_numpy(arr)
            val = val.to(device)
            keep = arr.dtype == np.int8 or (arr.dtype == np.float32 and parts[-1] == "scale")
            node[parts[-1]] = val if keep else val.to(dtype)

    def listify(node):
        if isinstance(node, dict):
            if node and all(k.isdigit() for k in node):
                return [listify(node[str(i)]) for i in range(len(node))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(root)
