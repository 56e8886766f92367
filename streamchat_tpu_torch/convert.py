"""JAX parameter trees (as nested dicts / lists of numpy arrays) -> the port's
parameters, so both packages compute the same function from the same
weights. The caller does the `np.asarray` on the JAX side; this module
never imports jax.

The decoder, projector and BERT trees have the same layout in both
packages. The ViT differs in one place: the port stores each layer's
merged q|k|v projection (`attn.wqkv`, `attn.bqkv`) that its K1 kernel
reads, so the concatenation happens here, once. A JAX tree that has been
through `vit.fold_params` keeps its per-layer "fused" leaves (wqkv, bqkv,
w1, b1, already merged and folded), so both packages' fused blocks read the
same folded weights.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def to_torch(tree: Any) -> Any:
    """Map every array leaf of a dict/list tree to a CPU torch tensor.

    Float, integer and bool leaves keep their dtype (the int8 weights and
    f32 scales of a quantized tree cross unchanged); bf16, which numpy only
    knows as a non-native dtype, becomes float32."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_torch(v) for v in tree]
    arr = np.asarray(tree)
    if arr.dtype.kind not in "fiub":
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr, order="C"))


def vit_params(jax_vit: dict) -> dict:
    """The JAX ViT tree (HF layout, separate q/k/v) -> the port's tree."""
    def merged(attn, leaf, axis):
        return to_torch(np.concatenate(
            [np.asarray(attn[n][leaf], np.float32) for n in ("q", "k", "v")], axis=axis))

    layers = []
    for p in jax_vit["layers"]:
        layer = {
            "ln1": to_torch(p["ln1"]),
            "attn": {"wqkv": merged(p["attn"], "w", 1), "bqkv": merged(p["attn"], "b", 0),
                     "o": to_torch(p["attn"]["o"])},
            "ln2": to_torch(p["ln2"]),
            "mlp": to_torch(p["mlp"]),
        }
        if "fused" in p:
            layer["fused"] = to_torch(p["fused"])
        layers.append(layer)
    return {
        "patch_embed": to_torch(jax_vit["patch_embed"]),
        "class_embed": to_torch(jax_vit["class_embed"]),
        "pos_embed": to_torch(jax_vit["pos_embed"]),
        "pre_ln": to_torch(jax_vit["pre_ln"]),
        "layers": layers,
    }

