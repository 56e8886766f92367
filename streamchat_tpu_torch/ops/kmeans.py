"""Weighted k-means over frame features (`ops/kmeans.py`).

Lloyd iterations with a fixed trip count (10, as the reference caps it),
distances by the ||x||^2 - 2 x.c + ||c||^2 expansion in f32, weighted
k-means++ seeding, and deterministic empty-cluster repair from pre-drawn
point indices. `init_centroids` and `repair_idx` can be injected so a test
holds both packages to the same draws.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _pairwise_sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    x_sq = (x * x).sum(-1, keepdim=True)
    c_sq = (c * c).sum(-1)[None, :]
    return (x_sq - 2.0 * (x @ c.T) + c_sq).clamp_min(0.0)


def _kmeans_plus_plus_init(x, w, k, generator):
    t = x.shape[0]
    first = torch.randint(0, t, (1,), generator=generator, device=x.device)
    centroids = torch.zeros(k, x.shape[1], dtype=x.dtype, device=x.device)
    centroids[0] = x[first[0]]
    for i in range(1, k):
        d_min = _pairwise_sq_dists(x, centroids[:i]).amin(dim=1)
        probs = (w * d_min).clamp_min(1e-30)
        nxt = torch.multinomial(probs / probs.sum(), 1, generator=generator)
        centroids[i] = x[nxt[0]]
    return centroids


def weighted_kmeans(x: torch.Tensor, weights: torch.Tensor, *, num_clusters: int,
                    num_iters: int = 10, generator: torch.Generator | None = None,
                    init_centroids: torch.Tensor | None = None,
                    repair_idx: torch.Tensor | None = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Weighted Lloyd's algorithm on x [T, D] ->
    (centroids [K, D] f32, labels [T] int64, cluster_weight [K] f32)."""
    t = x.shape[0]
    k = num_clusters
    x32 = x.float()
    w32 = weights.float().to(x.device)
    if init_centroids is None:
        centroids = _kmeans_plus_plus_init(x32, w32, k, generator)
    else:
        centroids = init_centroids.float().to(x.device)
    if repair_idx is None:
        repair_idx = torch.randint(0, t, (num_iters, k), generator=generator,
                                   device=x.device)
    repair_idx = repair_idx.to(x.device).long()
    labels = cluster_w = None
    for it in range(num_iters):
        d = _pairwise_sq_dists(x32, centroids)
        labels = torch.argmin(d, dim=1)
        wo = torch.nn.functional.one_hot(labels, k).float() * w32[:, None]
        cluster_w = wo.sum(0)
        sums = wo.T @ x32
        alive = cluster_w > 0.0
        means = sums / torch.where(alive, cluster_w, torch.ones_like(cluster_w))[:, None]
        centroids = torch.where(alive[:, None], means, x32[repair_idx[it]])
    return centroids, labels, cluster_w


def weighted_kmeans_feature(img_feature: torch.Tensor, num_clusters: int, *,
                            generator: torch.Generator | None = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cluster T frame features [T, P, D] (equal weights) down to
    [K, P, D]; T <= K returns the input unchanged."""
    t, p, d = img_feature.shape
    if t <= num_clusters:
        return img_feature, torch.arange(t, device=img_feature.device)
    weights = torch.ones(t, dtype=torch.float32, device=img_feature.device)
    centroids, labels, _ = weighted_kmeans(
        img_feature.reshape(t, p * d), weights, num_clusters=num_clusters,
        generator=generator)
    return centroids.reshape(num_clusters, p, d).to(img_feature.dtype), labels
