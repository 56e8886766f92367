"""CLIP vision tower (`streamchat_tpu/models/vit.py`).

ViT-L/14-336: patch embedding as unfold + one matmul, CLS + position
embeddings, pre-LN, then `num_layers + 1 + select_layer` blocks (23 of 24
for select_layer -2), CLS dropped -> [N, 576, 1024]. Every block runs
through the K1 kernel wrapper `ops.fused_vit.fused_vit_layer` (its plain
twin on CPU tensors), exact softmax.

Parameter layout is the JAX package's HF-style tree except that each layer
keeps the merged q|k|v projection the kernel reads (`attn.wqkv` [D, 3D],
`attn.bqkv` [3D]): the concatenation is done once, when the weights are
built or converted, never per forward.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from streamchat_tpu_torch.config import ViTConfig
from streamchat_tpu_torch.ops.fused_vit import fused_vit_layer

Params = Dict[str, Any]


def _layernorm(x, scale, bias, eps):
    y = torch.nn.functional.layer_norm(x.float(), (x.shape[-1],), scale.float(),
                                       bias.float(), eps)
    return y.to(x.dtype)


def init(cfg: ViTConfig, generator: torch.Generator, *, device="cpu",
         dtype=torch.bfloat16) -> Params:
    """Random parameters at the exact CLIP geometry of `cfg`."""

    def normal(*shape, scale):
        t = torch.randn(*shape, generator=generator, device=device)
        return (t * scale).to(dtype)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=device)

    def ln():
        return {"scale": torch.ones(cfg.hidden_size, dtype=dtype, device=device),
                "bias": zeros(cfg.hidden_size)}

    d, f = cfg.hidden_size, cfg.intermediate_size
    patch_dim = 3 * cfg.patch_size * cfg.patch_size
    layers = []
    for _ in range(cfg.num_layers):
        layers.append({
            "ln1": ln(),
            "attn": {"wqkv": normal(d, 3 * d, scale=d ** -0.5), "bqkv": zeros(3 * d),
                     "o": {"w": normal(d, d, scale=d ** -0.5), "b": zeros(d)}},
            "ln2": ln(),
            "mlp": {"fc1": {"w": normal(d, f, scale=d ** -0.5), "b": zeros(f)},
                    "fc2": {"w": normal(f, d, scale=f ** -0.5), "b": zeros(d)}},
        })
    return {
        "patch_embed": {"w": normal(patch_dim, d, scale=patch_dim ** -0.5)},
        "class_embed": normal(d, scale=0.02),
        "pos_embed": normal(cfg.num_patches + 1, d, scale=0.02),
        "pre_ln": ln(),
        "layers": layers,
    }


def _embed_patches(pixels: torch.Tensor, w: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """[N, 3, H, W] -> [N, P, hidden] via unfold + matmul (stride == kernel)."""
    n = pixels.shape[0]
    ps, g = cfg.patch_size, cfg.num_patches_per_side
    x = pixels.reshape(n, 3, g, ps, g, ps).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(n, g * g, 3 * ps * ps).to(w.dtype) @ w


def _block(x: torch.Tensor, p: Params, cfg: ViTConfig) -> torch.Tensor:
    return fused_vit_layer(
        x, p["ln1"]["scale"], p["ln1"]["bias"], p["attn"]["wqkv"], p["attn"]["bqkv"],
        p["attn"]["o"]["w"], p["attn"]["o"]["b"], p["ln2"]["scale"], p["ln2"]["bias"],
        p["mlp"]["fc1"]["w"], p["mlp"]["fc1"]["b"], p["mlp"]["fc2"]["w"],
        p["mlp"]["fc2"]["b"], num_heads=cfg.num_heads, eps=cfg.layernorm_eps)


def hidden_states(params: Params, pixels: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """Run the tower up to `cfg.select_layer` -> [N, 1 + P, hidden]."""
    select_layer = cfg.select_layer
    num_blocks = cfg.num_layers + 1 + select_layer if select_layer < 0 else select_layer
    x = _embed_patches(pixels, params["patch_embed"]["w"], cfg)
    cls = params["class_embed"][None, None, :].expand(x.shape[0], 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"][None]
    x = _layernorm(x, params["pre_ln"]["scale"], params["pre_ln"]["bias"],
                   cfg.layernorm_eps)
    for p in params["layers"][:num_blocks]:
        x = _block(x.contiguous(), p, cfg)
    return x


def encode(params: Params, pixels: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """Patch features [N, P, hidden]: hidden_states[select_layer] minus CLS."""
    return hidden_states(params, pixels, cfg)[:, 1:, :]
