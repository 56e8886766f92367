"""Token sampling: greedy / temperature / top-p (`ops/sampling.py`).

temperature <= 0 is greedy (argmax). Otherwise the logits are divided by
the temperature, optionally top-p filtered (the smallest sorted prefix whose
mass reaches top_p; the first token always survives), and one token is
drawn per row from `generator`. The draw cannot reproduce `jax.random`'s
stream; the filtering and the greedy path are exact twins.

The draw is `torch.multinomial`'s for one sample, written out: the argmax
of p / E with E ~ Exp(1) drawn by `exponential_` from the generator, the
same tokens from the same generator state. `multinomial` first checks its
probabilities on the host (a device-to-host read), which no CUDA graph can
hold; a decode step that samples is captured whole
(`models/step_graph.py`), so the check is left out: softmax rows are
valid probabilities.
"""

from __future__ import annotations

import torch


def top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Set logits outside the top-p nucleus to -inf (rows of [B, V])."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = cum - probs < top_p
    threshold = torch.where(keep, sorted_logits,
                            torch.full_like(sorted_logits, float("inf")))
    threshold = threshold.amin(dim=-1, keepdim=True)
    return torch.where(logits >= threshold, logits,
                       torch.full_like(logits, float("-inf")))


def sample_token(logits: torch.Tensor, generator: torch.Generator | None = None, *,
                 temperature: float = 0.0, top_p: float | None = None) -> torch.Tensor:
    """Next-token ids [B] (int64) from logits [B, V]."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / temperature
    if top_p is not None and top_p < 1.0:
        logits = top_p_filter(logits, top_p)
    probs = torch.softmax(logits, dim=-1)
    noise = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / noise, dim=-1)
