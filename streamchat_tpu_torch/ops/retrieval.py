"""Similarity scoring for retrieval (`streamchat_tpu/ops/retrieval.py`).

Cosine scores of queries against candidates as one [Q, N] product, their
top-k, and ColBERT MaxSim (the sum over query tokens of each token's best
document-token similarity). Plain PyTorch in f32: the JAX package runs
them as XLA code, with no Pallas kernel.
"""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    n = torch.sqrt(torch.sum(torch.square(x.float()), dim=dim, keepdim=True))
    return x / torch.clamp_min(n, eps)


def cosine_scores(query: torch.Tensor, candidates: torch.Tensor) -> torch.Tensor:
    """[Q, D] x [N, D] -> [Q, N] cosine similarities (f32)."""
    return l2_normalize(query.float()) @ l2_normalize(candidates.float()).T


def cosine_topk(query: torch.Tensor, candidates: torch.Tensor, k: int):
    """Top-k most similar candidates -> (scores [Q, k], indices [Q, k])."""
    return torch.topk(cosine_scores(query, candidates), k, dim=-1)


def maxsim_score(query_tokens: torch.Tensor, doc_tokens: torch.Tensor) -> torch.Tensor:
    """ColBERT MaxSim: [Tq, D] query tokens vs [N, Td, D] doc tokens -> [N]."""
    q = l2_normalize(query_tokens.float())
    d = l2_normalize(doc_tokens.float())
    sim = torch.einsum("qd,ntd->nqt", q, d)
    return sim.amax(dim=2).sum(dim=1)
