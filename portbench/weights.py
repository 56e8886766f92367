"""Random weights made from the run's seed, under the published checkpoint's
names (HF layout: a Linear weight is [out, in]).

The tensors of one group (a decoder layer, the token table, a ViT layer,
...) come from one `torch.randn` call on the device with a generator seeded
from the run seed and the group's name, so any group can be made again
alone, with the same values: the program takes the groups through a
`Mapping` (`SeededWeights`) that makes one group at a time, and the
reference makes each group again after the program is gone.

Scales: a matrix is N(0, 1/fan_in) (the port's own random init), a bias
and an embedding N(0, 0.02^2), a norm's weight 1 + N(0, 0.02^2). A
configuration's `random_init.qk_gain` widens the decoder's q and k
projections by that factor, so that attention over a long context is
peaked, as a trained model's is, and not an average of the whole context.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Iterator, List, Tuple

import torch

from portbench.seeds import subseed

# (name, shape, kind); kind is "w" (matrix; "w*<gain>" widened by a gain),
# "b" (bias), "emb", "norm", "norm_b" (a LayerNorm's bias).
Leaf = Tuple[str, Tuple[int, ...], str]

VIT_PREFIX = "model.vision_tower.vision_tower.vision_model."


def decoder_groups(cfg: dict) -> Dict[str, List[Leaf]]:
    """Qwen2 (LongVA's language model) in its checkpoint's names."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = d // hq
    v = cfg["vocab_size"]
    qk = "w*%r" % float(cfg.get("random_init", {}).get("qk_gain", 1.0))
    groups: Dict[str, List[Leaf]] = {}
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        groups[f"decoder.layer.{i}"] = [
            (p + "input_layernorm.weight", (d,), "norm"),
            (p + "self_attn.q_proj.weight", (hq * dh, d), qk),
            (p + "self_attn.q_proj.bias", (hq * dh,), "b"),
            (p + "self_attn.k_proj.weight", (hkv * dh, d), qk),
            (p + "self_attn.k_proj.bias", (hkv * dh,), "b"),
            (p + "self_attn.v_proj.weight", (hkv * dh, d), "w"),
            (p + "self_attn.v_proj.bias", (hkv * dh,), "b"),
            (p + "self_attn.o_proj.weight", (d, hq * dh), "w"),
            (p + "post_attention_layernorm.weight", (d,), "norm"),
            (p + "mlp.gate_proj.weight", (f, d), "w"),
            (p + "mlp.up_proj.weight", (f, d), "w"),
            (p + "mlp.down_proj.weight", (d, f), "w"),
        ]
    groups["decoder.embed"] = [("model.embed_tokens.weight", (v, d), "emb")]
    groups["decoder.norm"] = [("model.norm.weight", (d,), "norm")]
    groups["decoder.head"] = [("lm_head.weight", (v, d), "w")]
    return groups


def vit_groups(cfg: dict) -> Dict[str, List[Leaf]]:
    """CLIP ViT-L/14-336 as LongVA's checkpoint holds it."""
    vc = cfg["vision_config"]
    d, f, ps = vc["hidden_size"], vc["intermediate_size"], vc["patch_size"]
    n = (vc["image_size"] // ps) ** 2 + 1
    p = VIT_PREFIX
    groups: Dict[str, List[Leaf]] = {"vit.embed": [
        (p + "embeddings.patch_embedding.weight", (d, 3, ps, ps), "w"),
        (p + "embeddings.class_embedding", (d,), "emb"),
        (p + "embeddings.position_embedding.weight", (n, d), "emb"),
        (p + "pre_layrnorm.weight", (d,), "norm"),
        (p + "pre_layrnorm.bias", (d,), "norm_b"),
    ]}
    for i in range(vc["num_hidden_layers"]):
        q = f"{p}encoder.layers.{i}."
        leaves: List[Leaf] = [(q + "layer_norm1.weight", (d,), "norm"),
                              (q + "layer_norm1.bias", (d,), "norm_b")]
        for n_ in ("q", "k", "v", "out"):
            leaves += [(f"{q}self_attn.{n_}_proj.weight", (d, d), "w"),
                       (f"{q}self_attn.{n_}_proj.bias", (d,), "b")]
        leaves += [(q + "layer_norm2.weight", (d,), "norm"),
                   (q + "layer_norm2.bias", (d,), "norm_b"),
                   (q + "mlp.fc1.weight", (f, d), "w"), (q + "mlp.fc1.bias", (f,), "b"),
                   (q + "mlp.fc2.weight", (d, f), "w"), (q + "mlp.fc2.bias", (d,), "b")]
        groups[f"vit.layer.{i}"] = leaves
    return groups


def projector_groups(cfg: dict) -> Dict[str, List[Leaf]]:
    """mlp2x_gelu: Linear(vision hidden -> hidden), GELU, Linear(hidden -> hidden)."""
    din, d = cfg["vision_config"]["hidden_size"], cfg["hidden_size"]
    p = "model.mm_projector."
    return {"projector": [(p + "0.weight", (d, din), "w"), (p + "0.bias", (d,), "b"),
                          (p + "2.weight", (d, d), "w"), (p + "2.bias", (d,), "b")]}


def bert_groups(bc: dict, tag: str) -> Dict[str, List[Leaf]]:
    """A BERT encoder (mxbai-colbert-large, all-MiniLM-L6) in its names."""
    d, f = bc["hidden_size"], bc["intermediate_size"]
    groups: Dict[str, List[Leaf]] = {f"{tag}.embed": [
        ("embeddings.word_embeddings.weight", (bc["vocab_size"], d), "emb"),
        ("embeddings.position_embeddings.weight", (bc["max_position_embeddings"], d), "emb"),
        ("embeddings.token_type_embeddings.weight", (bc["type_vocab_size"], d), "emb"),
        ("embeddings.LayerNorm.weight", (d,), "norm"),
        ("embeddings.LayerNorm.bias", (d,), "norm_b"),
    ]}
    for i in range(bc["num_hidden_layers"]):
        p = f"encoder.layer.{i}."
        leaves: List[Leaf] = []
        for n_ in ("attention.self.query", "attention.self.key", "attention.self.value",
                   "attention.output.dense"):
            leaves += [(f"{p}{n_}.weight", (d, d), "w"), (f"{p}{n_}.bias", (d,), "b")]
        leaves += [(p + "attention.output.LayerNorm.weight", (d,), "norm"),
                   (p + "attention.output.LayerNorm.bias", (d,), "norm_b"),
                   (p + "intermediate.dense.weight", (f, d), "w"),
                   (p + "intermediate.dense.bias", (f,), "b"),
                   (p + "output.dense.weight", (d, f), "w"), (p + "output.dense.bias", (d,), "b"),
                   (p + "output.LayerNorm.weight", (d,), "norm"),
                   (p + "output.LayerNorm.bias", (d,), "norm_b")]
        groups[f"{tag}.layer.{i}"] = leaves
    return groups


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def make_group(leaves: List[Leaf], seed: int, tag: str, device, dtype) -> Dict[str, torch.Tensor]:
    """One group's tensors: one randn call on `device`, cut and scaled per
    leaf, then cast to `dtype` (the dtype the configuration serves)."""
    g = torch.Generator(device=device).manual_seed(subseed(seed, "weights/" + tag))
    flat = torch.randn(sum(_numel(s) for _, s, _ in leaves), generator=g, device=device)
    out, at = {}, 0
    for name, shape, kind in leaves:
        x = flat[at: at + _numel(shape)].view(shape)
        at += _numel(shape)
        if kind.startswith("w"):
            gain = float(kind[2:]) if kind.startswith("w*") else 1.0
            x = x * (gain * _numel(shape[1:]) ** -0.5)
        elif kind == "norm":
            x = 1.0 + 0.02 * x
        else:
            x = 0.02 * x
        out[name] = x.to(dtype)
    return out


class SeededWeights(Mapping):
    """name -> tensor over `groups`, made one group at a time on first use
    (the maps of the program read a group's names together)."""

    def __init__(self, groups: Dict[str, List[Leaf]], seed: int, device, dtype) -> None:
        self._groups = groups
        self._where = {name: tag for tag, leaves in groups.items() for name, _, _ in leaves}
        self._seed, self._device, self._dtype = seed, device, dtype
        self._tag, self._made = None, {}

    def group(self, tag: str) -> Dict[str, torch.Tensor]:
        return make_group(self._groups[tag], self._seed, tag, self._device, self._dtype)

    def __getitem__(self, name: str) -> torch.Tensor:
        tag = self._where[name]
        if tag != self._tag:
            self._made = None
            self._tag, self._made = tag, self.group(tag)
        return self._made[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)

    def release(self) -> None:
        self._tag, self._made = None, {}
