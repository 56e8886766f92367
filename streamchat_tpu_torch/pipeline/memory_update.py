"""Per-segment memory update (`streamchat_tpu/pipeline/memory_update.py`).

0. With `compress_rate` > 1 each frame's patch grid is average-pooled by
   that rate along each side first (ops/pooling.py; 576 -> 144 tokens a
   frame at rate 2), so short memory, chunks and captions all see the
   pooled features. The on-line session (pipeline/streaming.py) cuts its
   chunks itself and, as the JAX package's, does not pool.
1. Short memory: the segment's last `short_window` frames, sampled down to
   `remember_window` by the Ebbinghaus curve (reset every breakpoint, as the
   reference does).
2. Long memory: the segment cut into `chunk_size` chunks; each RAW chunk is
   captioned, each full chunk is k-means reduced to `num_clusters` centroids
   for its tree node (the partial tail chunk stays raw), and the nodes enter
   the tree. A captioner with a `.batch` method captions groups of its
   `.batch_size` chunks in one call (a group of one goes to the captioner
   itself); group size 1 is the reference's strictly sequential captioning.
   `cluster_full_chunks=False` (`--literal_kmeans`) reproduces the
   reference's literal guard, which never clusters a chunk: every node then
   keeps its raw chunk.

The JAX package's host offload of chunks and weights (`offload_chunks`,
`offload_residents`, OFFLOAD_STATS) exists to fit a 16 GB chip; the H100's
80 GB holds a segment's features and the caption prefill together.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from streamchat_tpu_torch.config import MemoryConfig
from streamchat_tpu_torch.memory.tree import VisualMemoryTree
from streamchat_tpu_torch.ops.forgetting import select_short_memory
from streamchat_tpu_torch.ops.kmeans import weighted_kmeans_feature
from streamchat_tpu_torch.ops.pooling import compress_spatial_features

CaptionFn = Callable[[torch.Tensor], str]


def build_short_memory(features: torch.Tensor, cfg: MemoryConfig,
                       generator: torch.Generator | None = None) -> torch.Tensor:
    """[N, P, D] segment features -> [R, P, D] short memory."""
    n = features.shape[0]
    if n == 0:
        raise ValueError("empty segment: no short memory")
    window = features[-cfg.short_window:] if n > cfg.short_window else features
    r = min(cfg.remember_window, window.shape[0])
    if window.shape[0] <= r:
        return window
    return select_short_memory(window, r, cfg.tau, generator=generator)


def chunk_and_cluster(features: torch.Tensor, cfg: MemoryConfig,
                      generator: torch.Generator | None = None,
                      cluster_full_chunks: bool = True
                      ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Split [N, P, D] into chunk_size chunks -> (raw_chunks, node_features)."""
    raw: List[torch.Tensor] = []
    node: List[torch.Tensor] = []
    for i in range(0, features.shape[0], cfg.chunk_size):
        chunk = features[i: i + cfg.chunk_size]
        raw.append(chunk)
        if (cluster_full_chunks and chunk.shape[0] >= cfg.chunk_size
                and chunk.shape[0] > cfg.num_clusters):
            centroids, _ = weighted_kmeans_feature(chunk, cfg.num_clusters,
                                                   generator=generator)
            node.append(centroids)
        else:
            node.append(chunk)
    return raw, node


def update_memory(features: torch.Tensor, tree: VisualMemoryTree, caption_fn: CaptionFn,
                  cfg: MemoryConfig, generator: torch.Generator | None = None,
                  cluster_full_chunks: bool = True
                  ) -> Tuple[VisualMemoryTree, torch.Tensor]:
    """One segment's memory update -> (tree, short_memory [R, P, D])."""
    if cfg.compress_rate > 1:
        features = compress_spatial_features(features, cfg.compress_rate)
    short = build_short_memory(features, cfg, generator)
    raw_chunks, node_feats = chunk_and_cluster(features, cfg, generator,
                                               cluster_full_chunks)
    batch_fn = getattr(caption_fn, "batch", None)
    size = getattr(caption_fn, "batch_size", 1) if batch_fn is not None else 1
    captions: List[str] = []
    for i in range(0, len(raw_chunks), size):
        group = raw_chunks[i:i + size]
        captions.extend([caption_fn(group[0])] if len(group) == 1 else batch_fn(group))
    tree.add_chunks(node_feats, captions)
    return tree, short
