"""Clustering extras (`streamchat_tpu/ops/clustering.py`).

The reference's vendored clustering toolbox (`torch_kmeans/`,
`kmeans_pytorch/soft_dtw_cuda.py`), which its pipeline imports but never
calls: Lloyd's k-means over four distance metrics, soft k-means, k nearest
neighbours and soft-DTW. Plain PyTorch in f32: the JAX package runs them as
XLA code, with no Pallas kernel (float64 inputs stay float64, for a host
reference).

The initial centroids are rows drawn by a random permutation from a
`torch.Generator`; `init_idx` takes the rows instead, so a test holds both
packages to the same draw. `knn` breaks ties toward the lower point index,
as `lax.top_k` does (a stable sort; `torch.topk` promises no order).
`soft_dtw` walks the anti-diagonals of the cost matrix in a host loop, all
pairs of `pairwise_soft_dtw` at once.
"""

from __future__ import annotations

from typing import Tuple

import torch

from streamchat_tpu_torch.ops.kmeans import _pairwise_sq_dists
from streamchat_tpu_torch.ops.retrieval import l2_normalize


def _real(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float64 else x.float()


def pairwise_distances(x: torch.Tensor, c: torch.Tensor, metric: str = "euclidean"
                       ) -> torch.Tensor:
    """[T, D] x [K, D] -> [T, K] distances in f32."""
    x32, c32 = _real(x), _real(c)
    if metric == "euclidean":
        return torch.sqrt(_pairwise_sq_dists(x32, c32))
    if metric == "sq_euclidean":
        return _pairwise_sq_dists(x32, c32)
    if metric == "dot":
        return -(x32 @ c32.T)          # a larger similarity is a smaller distance
    if metric == "cosine":
        return 1.0 - l2_normalize(x32) @ l2_normalize(c32).T
    raise ValueError(f"unknown metric: {metric}")


def _initial(x32: torch.Tensor, k: int, generator, init_idx) -> torch.Tensor:
    if init_idx is None:
        init_idx = torch.randperm(x32.shape[0], generator=generator, device=x32.device)[:k]
    return x32[init_idx.to(x32.device).long()]


def kmeans(x: torch.Tensor, generator: torch.Generator | None = None, *, num_clusters: int,
           num_iters: int = 10, metric: str = "sq_euclidean",
           init_idx: torch.Tensor | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's algorithm under `metric` -> (centroids [K, D] f32, labels [T]
    int32 of the last iteration); an empty cluster keeps its centroid."""
    x32 = _real(x)
    centroids = _initial(x32, num_clusters, generator, init_idx)
    labels = None
    for _ in range(num_iters):
        labels = torch.argmin(pairwise_distances(x32, centroids, metric), dim=1)
        onehot = torch.nn.functional.one_hot(labels, num_clusters).to(x32.dtype)
        counts = onehot.sum(0)
        means = (onehot.T @ x32) / torch.where(counts > 0, counts, 1.0)[:, None]
        centroids = torch.where((counts > 0)[:, None], means, centroids)
    return centroids, labels.to(torch.int32)


def soft_kmeans(x: torch.Tensor, generator: torch.Generator | None = None, *,
                num_clusters: int, num_iters: int = 10, temperature: float = 1.0,
                init_idx: torch.Tensor | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Soft assignments softmax(-d^2 / T) -> (centroids [K, D], soft
    assignment [T, K] of the last iteration)."""
    x32 = _real(x)
    centroids = _initial(x32, num_clusters, generator, init_idx)
    w = None
    for _ in range(num_iters):
        w = torch.softmax(-_pairwise_sq_dists(x32, centroids) / temperature, dim=1)
        centroids = (w.T @ x32) / w.sum(0).clamp_min(1e-9)[:, None]
    return centroids, w


def knn(queries: torch.Tensor, points: torch.Tensor, k: int, metric: str = "sq_euclidean"
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest points of each query -> (distances [Q, k], indices [Q, k]),
    nearest first, ties toward the lower index."""
    d = pairwise_distances(queries, points, metric)
    dist, idx = torch.sort(d, dim=1, stable=True)
    return dist[:, :k], idx[:, :k]


def _softmin(a, b, c, gamma):
    """-gamma logsumexp(-[a, b, c] / gamma), +inf where all three are +inf."""
    z = -torch.stack([a, b, c]) / gamma
    zmax = z.amax(dim=0)
    inf = torch.isinf(zmax)
    safe = torch.where(inf, torch.zeros_like(zmax), zmax)
    out = -gamma * (torch.log(torch.exp(z - safe).sum(0)) + safe)
    return torch.where(inf, torch.full_like(out, float("inf")), out)


def _soft_dtw_costs(dmat: torch.Tensor, gamma: float) -> torch.Tensor:
    """Soft-DTW of cost matrices [..., n, m] -> [...]: R[i, j] = D[i, j] +
    softmin(R[i-1, j], R[i, j-1], R[i-1, j-1]) over the anti-diagonals,
    carrying the two before each as length-n vectors (row i, column k - i)."""
    n, m = dmat.shape[-2:]
    rows = torch.arange(n, device=dmat.device)
    inf = torch.full(dmat.shape[:-1], float("inf"), dtype=dmat.dtype, device=dmat.device)
    prev2, prev = inf, inf
    for k in range(n + m - 1):
        j = k - rows
        valid = (j >= 0) & (j < m)
        d_k = torch.where(valid, dmat.gather(-1, j.clamp(0, m - 1).expand(
            dmat.shape[:-1])[..., None])[..., 0], inf)
        up = torch.where(rows > 0, prev.roll(1, -1), inf)            # R[i-1, j]
        diag = torch.where(rows > 0, prev2.roll(1, -1), inf)         # R[i-1, j-1]
        base = torch.where((rows == 0) & (j == 0), torch.zeros_like(d_k),
                           _softmin(up, prev, diag, gamma))
        prev2, prev = prev, torch.where(valid, d_k + base, inf)
    return prev[..., n - 1]


def _sq_costs(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared euclidean costs [..., n, m] of x [..., n, d], y [..., m, d]
    by the norm expansion."""
    x32, y32 = _real(x), _real(y)
    return ((x32 * x32).sum(-1)[..., :, None] - 2.0 * x32 @ y32.transpose(-1, -2)
            + (y32 * y32).sum(-1)[..., None, :])


def soft_dtw(x: torch.Tensor, y: torch.Tensor, gamma: float = 1.0) -> torch.Tensor:
    """Soft-DTW distance of sequences x [n, d] and y [m, d] -> scalar."""
    return _soft_dtw_costs(_sq_costs(x, y), gamma)


def pairwise_soft_dtw(xs: torch.Tensor, ys: torch.Tensor, gamma: float = 1.0) -> torch.Tensor:
    """All pairs: xs [A, n, d] x ys [B, m, d] -> [A, B]."""
    return _soft_dtw_costs(_sq_costs(xs[:, None], ys[None]), gamma)
