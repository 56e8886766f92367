"""Frame ingest: decode -> preprocess -> batched ViT encode, then the
optional scene-change dedup (`streamchat_tpu/pipeline/ingest.py`)."""

from __future__ import annotations

import numpy as np
import torch

from streamchat_tpu_torch.config import VideoConfig
from streamchat_tpu_torch.ops.dedup import frame_descriptors, select_changed_frames
from streamchat_tpu_torch.video.reader import sample_frame_indices
from streamchat_tpu_torch.pipeline.preprocess import preprocess_frames
from streamchat_tpu_torch.utils.profiling import span


def segment_indices(reader, start_s, end_s, cfg: VideoConfig, chunk_size: int):
    """Frame indices for a [start_s, end_s) segment (for prefetch scheduling)."""
    return sample_frame_indices(start_s, end_s, reader.frame_rate, reader.total_frames,
                                cfg.sample_rate, chunk_size, cfg.frame_cap,
                                cfg.frame_cap_trigger)


def encode_segment(model, reader, start_s: float, end_s: float, cfg: VideoConfig,
                   chunk_size: int) -> torch.Tensor:
    """Encode a [start_s, end_s) segment -> features [N, P, D].

    Frames encode in cfg.ingest_batch slices, each padded to a 16-multiple
    of frames (tail slices to the full batch when the segment spans
    several), as in the JAX package, so the batch shapes the kernels see are
    the same in both. Spans: `ingest.read` (the wait on the reader's
    frames), then per slice `ingest.upload` (padding, the host-to-device
    copy and the preprocessing launches) and `ingest.encode` (the ViT and
    projector launches)."""
    max_batch = cfg.ingest_batch
    dtype = model.dec_params["embed"].dtype
    indices = segment_indices(reader, start_s, end_s, cfg, chunk_size)
    with span("ingest.read", frames=len(indices)):
        frames = reader.read_frames(indices) if indices else None
    if frames is None or frames.shape[0] == 0:
        return torch.zeros(0, 1, 1, dtype=dtype, device=model.device)
    feats = []
    for i in range(0, frames.shape[0], max_batch):
        with span("ingest.upload"):
            batch = frames[i: i + max_batch]
            valid = batch.shape[0]
            target = max_batch if frames.shape[0] > max_batch else min(
                max_batch, max(16, ((valid + 15) // 16) * 16))
            if valid < target:
                pad = np.zeros((target - valid,) + batch.shape[1:], batch.dtype)
                batch = np.concatenate([batch, pad], axis=0)
            pixels = preprocess_frames(batch, cfg.image_size, device=model.device)
        with span("ingest.encode", frames=target):
            feats.append(model.encode_images(pixels)[:valid])
    return torch.cat(feats, dim=0)


def dedup_segment(features: torch.Tensor, threshold: float) -> torch.Tensor:
    """Selective frame stacking: keep the frames [N, P, D] whose descriptor
    changed by more than `threshold` from the frame before (K12); frame 0
    is always kept. Threshold 0 (the v0.3 path) passes through."""
    if threshold <= 0.0 or features.shape[0] == 0:
        return features
    keep = select_changed_frames(frame_descriptors(features), threshold=threshold)
    return features[torch.nonzero(keep).flatten()]
