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
3. Host offload. With `offload_chunks`, or past `offload_chunks_over`
   frames in a segment, each raw chunk is copied to pinned host memory as
   it is cut, and goes back to the card right before its caption group
   (the copy done before the caption starts). `features` may be passed as
   a one-element list, which is popped: update_memory then holds the
   segment's only reference, so the stack on the card is freed once it is
   cut (under the offload, what stays on the card, the centroids, the
   short memory and a raw tail chunk's node, is never a view of the
   stack). `residents` (utils/offload.WeightOffloader over the trees the
   caption loop leaves idle) is parked around the caption loop and
   restored before `tree.add_chunks`. `stats` (`offload_stats()`) totals
   the chunk offload's seconds each way, chunks and bytes.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import torch

from streamchat_tpu_torch.config import MemoryConfig
from streamchat_tpu_torch.memory.tree import VisualMemoryTree
from streamchat_tpu_torch.ops.forgetting import select_short_memory
from streamchat_tpu_torch.ops.kmeans import weighted_kmeans_feature
from streamchat_tpu_torch.ops.pooling import compress_spatial_features
from streamchat_tpu_torch.utils.offload import WeightOffloader, synchronize, to_host

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


def _owned(t: torch.Tensor, stack: torch.Tensor) -> torch.Tensor:
    """`t`, or a copy of it where it is a view of `stack`'s storage: what
    outlives the segment must not pin the whole stack on the card."""
    if t.untyped_storage().data_ptr() == stack.untyped_storage().data_ptr():
        return t.clone()
    return t


def offload_stats() -> dict:
    """Zeroed totals of the chunk offload: seconds each way, chunks, bytes
    (both directions)."""
    return {"d2h_s": 0.0, "h2d_s": 0.0, "chunks": 0, "bytes": 0}


def chunk_and_cluster(features: torch.Tensor, cfg: MemoryConfig,
                      generator: torch.Generator | None = None,
                      cluster_full_chunks: bool = True, offload: bool = False,
                      stats: Optional[dict] = None
                      ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Split [N, P, D] into chunk_size chunks -> (raw_chunks, node_features).

    `offload` parks each raw chunk in host memory as it is cut (pinned,
    for a stack on the card), so the card never holds the stack and its
    chunk copies at once, and keeps no node that is a view of the stack;
    `stats` totals the seconds and bytes."""
    stats = offload_stats() if stats is None else stats
    raw: List[torch.Tensor] = []
    node: List[torch.Tensor] = []
    for i in range(0, features.shape[0], cfg.chunk_size):
        chunk = features[i: i + cfg.chunk_size]
        if offload:
            t0 = time.perf_counter()
            raw.append(to_host(chunk))
            stats["d2h_s"] += time.perf_counter() - t0
            stats["chunks"] += 1
            stats["bytes"] += chunk.nbytes
        else:
            raw.append(chunk)
        if (cluster_full_chunks and chunk.shape[0] >= cfg.chunk_size
                and chunk.shape[0] > cfg.num_clusters):
            centroids, _ = weighted_kmeans_feature(chunk, cfg.num_clusters,
                                                   generator=generator)
            node.append(centroids)
        else:
            node.append(_owned(chunk, features) if offload else chunk)
    return raw, node


def update_memory(features, tree: VisualMemoryTree, caption_fn: CaptionFn,
                  cfg: MemoryConfig, generator: torch.Generator | None = None,
                  cluster_full_chunks: bool = True,
                  residents: Optional[WeightOffloader] = None,
                  stats: Optional[dict] = None
                  ) -> Tuple[VisualMemoryTree, torch.Tensor]:
    """One segment's memory update -> (tree, short_memory [R, P, D]).

    `features` is [N, P, D], or a one-element list holding it (popped, so
    the stack is freed once it is cut)."""
    if isinstance(features, list):
        features = features.pop()
    stats = offload_stats() if stats is None else stats
    if cfg.compress_rate > 1:
        features = compress_spatial_features(features, cfg.compress_rate)
    device = features.device
    offload = cfg.offload_chunks or (cfg.offload_chunks_over is not None
                                     and features.shape[0] > cfg.offload_chunks_over)
    short = build_short_memory(features, cfg, generator)
    if offload:
        short = _owned(short, features)
    raw_chunks, node_feats = chunk_and_cluster(features, cfg, generator,
                                               cluster_full_chunks, offload, stats)
    del features
    batch_fn = getattr(caption_fn, "batch", None)
    size = getattr(caption_fn, "batch_size", 1) if batch_fn is not None else 1
    if residents is not None:
        residents.offload()
    groups = [raw_chunks[i:i + size] for i in range(0, len(raw_chunks), size)]
    del raw_chunks
    captions: List[str] = []
    for gi in range(len(groups)):
        group, groups[gi] = groups[gi], None
        if offload:
            t0 = time.perf_counter()
            group = [c.to(device, non_blocking=True) for c in group]
            synchronize([device])
            stats["h2d_s"] += time.perf_counter() - t0
            stats["bytes"] += sum(c.nbytes for c in group)
        captions.extend([caption_fn(group[0])] if len(group) == 1 else batch_fn(group))
        del group
    if residents is not None:
        residents.restore()
    tree.add_chunks(node_feats, captions)
    return tree, short
