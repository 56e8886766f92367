"""Spatial pooling over ViT patch grids (`streamchat_tpu/ops/pooling.py`).

The reference's `compress_spatial_features` (`--compress_rate`): an
average pool of each frame's square patch grid (24 x 24 at ViT-L/14-336)
by `rate` along each side, as a reshape and a mean. Plain PyTorch: the
JAX package leaves it to XLA, with no Pallas kernel.
"""

from __future__ import annotations

import torch


def pool_patch_grid(features: torch.Tensor, rate: int, mode: str = "average") -> torch.Tensor:
    """Pool [N, P, D] patch-token features by `rate` along each grid side
    -> [N, (side / rate)^2, D]. P must be a perfect square whose side
    `rate` divides; rate 1 is the identity."""
    if rate == 1:
        return features
    n, p, d = features.shape
    side = int(round(p ** 0.5))
    if side * side != p:
        raise ValueError(f"patch count {p} is not a perfect square")
    if side % rate != 0:
        raise ValueError(f"grid side {side} not divisible by pool rate {rate}")
    out = side // rate
    grid = features.reshape(n, out, rate, out, rate, d)
    if mode == "average":
        pooled = grid.mean(dim=(2, 4))
    elif mode == "max":
        pooled = grid.amax(dim=(2, 4))
    else:
        raise ValueError(f"unknown pool mode: {mode}")
    return pooled.reshape(n, out * out, d)


def compress_spatial_features(features: torch.Tensor, compress_rate: int) -> torch.Tensor:
    """The reference's name: [N, P, D] -> [N, (side / rate)^2, D], averaged."""
    return pool_patch_grid(features, compress_rate, mode="average")
