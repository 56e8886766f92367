"""Multimodal projector `mlp2x_gelu` (`streamchat_tpu/models/projector.py`).

fc2(erf-GELU(fc1(features))) through the K2 kernel wrapper
`ops.fused_vit.fused_ln_mlp` with LayerNorm off and no residual, as the
JAX package routes it on its TPU (`projector.py:46-58`).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from streamchat_tpu_torch.ops.fused_vit import fused_ln_mlp

Params = Dict[str, Any]


def init(in_dim: int, out_dim: int, generator: torch.Generator, *, device="cpu",
         dtype=torch.bfloat16) -> Params:
    def dense(kin, kout):
        w = torch.randn(kin, kout, generator=generator, device=device) * kin ** -0.5
        return {"w": w.to(dtype), "b": torch.zeros(kout, dtype=dtype, device=device)}

    return {"fc1": dense(in_dim, out_dim), "fc2": dense(out_dim, out_dim)}


def apply(params: Params, features: torch.Tensor) -> torch.Tensor:
    """[..., in_dim] -> [..., out_dim]."""
    din = features.shape[-1]
    out = fused_ln_mlp(
        features.reshape(-1, din).contiguous(), None, None,
        params["fc1"]["w"], params["fc1"]["b"], params["fc2"]["w"], params["fc2"]["b"],
        activation="gelu", layernorm=False, residual=False)
    return out.reshape(features.shape[:-1] + (out.shape[-1],))
