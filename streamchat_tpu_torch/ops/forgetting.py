"""Ebbinghaus forgetting-curve sampling for short-term memory
(`ops/forgetting.py`).

R(t) = exp(-t / tau), normalized, with t = 0 at the OLDEST frame of the
window (as the reference indexes it). Sampling without replacement is
Gumbel-top-k; tests inject the Gumbel noise so both packages pick the same
frames (jax.random and torch generators give different streams).
"""

from __future__ import annotations

import torch


def forgetting_probabilities(length: int, tau: float = 10.0,
                             device=None) -> torch.Tensor:
    """Normalized retention probabilities over window positions [0, length)."""
    t = torch.arange(length, dtype=torch.float32, device=device)
    r = torch.exp(-t / tau)
    return r / r.sum()


def sample_without_replacement(probs: torch.Tensor, num_select: int, *,
                               generator: torch.Generator | None = None,
                               gumbel: torch.Tensor | None = None) -> torch.Tensor:
    """`num_select` distinct indices ~ probs via Gumbel-top-k.

    `gumbel` (same shape as probs) replaces the drawn noise."""
    if gumbel is None:
        u = torch.rand(probs.shape, generator=generator, device=probs.device)
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        gumbel = -torch.log(-torch.log(u))
    scores = torch.log(probs.clamp_min(1e-30)) + gumbel.to(probs.device)
    return torch.topk(scores, num_select).indices


def select_short_memory(features: torch.Tensor, num_select: int, tau: float, *,
                        generator: torch.Generator | None = None,
                        gumbel: torch.Tensor | None = None) -> torch.Tensor:
    """Sample `num_select` of the window's [W, ...] features by retention
    probability, kept in temporal order."""
    w = features.shape[0]
    probs = forgetting_probabilities(w, tau, device=features.device)
    idx = torch.sort(sample_without_replacement(
        probs, num_select, generator=generator, gumbel=gumbel)).values
    return features[idx]
