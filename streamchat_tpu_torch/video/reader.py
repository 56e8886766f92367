"""Video frame reading.

A copy of `streamchat_tpu/video/reader.py` (tests hold the two equal), so
that the port imports nothing of the JAX package.

Replaces `video_reader_thread_with_embedding`'s decode half
(inference_streaming_longva_v2.py:454-531). Two deliberate changes:

* Frame indices are read in ascending order with `cap.set` seeks only on
  gaps — the reference seeks before EVERY read (`:503-504`), the dominant
  host cost in its ingest loop (SURVEY.md §3.2).
* Reading is separated from encoding so the host decode of segment N+1 can
  overlap the device encode of segment N (double-buffering, SURVEY.md §7.8).

Index sampling reproduces the reference exactly: `sample_rate` x segment
frames, >900 sampled clamped to 200 (`:481-485`), segments shorter than
`chunk_size` use every frame (`:487-495`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def sample_frame_indices(
    start_s: float,
    end_s: float,
    frame_rate: float,
    total_frames: int,
    sample_rate: float,
    chunk_size: int,
    frame_cap: int = 200,
    frame_cap_trigger: int = 900,
) -> List[int]:
    """Uniform frame indices for a [start_s, end_s) segment."""
    start_frame = max(0, int(start_s * frame_rate))
    end_frame = min(total_frames, int(end_s * frame_rate))
    to_process = end_frame - start_frame
    if to_process <= 0:
        return []
    num_frame = int(to_process * sample_rate)
    if num_frame > frame_cap_trigger:
        num_frame = frame_cap
    if to_process <= chunk_size:
        return list(range(start_frame, end_frame))
    if num_frame <= 0:
        return []
    return [
        int(start_frame + i * to_process / num_frame) for i in range(num_frame)
    ]


class VideoReader:
    """cv2-backed reader returning RGB uint8 frames [N, H, W, 3]."""

    def __init__(self, path: str):
        import cv2  # local import: heavy native lib

        self._cv2 = cv2
        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise FileNotFoundError(f"cannot open video: {path}")
        self.total_frames = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.frame_rate = float(self.cap.get(cv2.CAP_PROP_FPS)) or 30.0

    def read_frames(self, indices: Sequence[int]) -> np.ndarray:
        """Decode the given frame indices (ascending recommended)."""
        cv2 = self._cv2
        frames = []
        pos = -2  # force initial seek
        for idx in indices:
            if idx != pos + 1:
                self.cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
            ret, frame = self.cap.read()
            if not ret:
                break
            pos = idx
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        if not frames:
            return np.zeros((0, 2, 2, 3), np.uint8)
        return np.stack(frames)

    def close(self) -> None:
        self.cap.release()


class SyntheticVideoReader:
    """Deterministic fake video for tests/benches (no codec dependency).

    Plays the role of the reference's `torch.randn` feature banks
    (utiles.py:2245-2258) one level earlier, at the pixel boundary.
    """

    def __init__(
        self,
        total_frames: int = 300,
        frame_rate: float = 30.0,
        height: int = 64,
        width: int = 64,
        seed: int = 0,
    ):
        self.total_frames = total_frames
        self.frame_rate = frame_rate
        self.height = height
        self.width = width
        self._seed = seed

    def read_frames(self, indices: Sequence[int]) -> np.ndarray:
        rng = np.random.default_rng(self._seed)
        base = rng.integers(0, 256, (self.height, self.width, 3), np.uint8)
        out = np.zeros((len(indices), self.height, self.width, 3), np.uint8)
        for j, idx in enumerate(indices):
            # Content drifts with frame index so dedup/kmeans see structure.
            out[j] = np.roll(base, idx, axis=1)
            out[j, :, :, 0] = (out[j, :, :, 0].astype(np.int32) + idx) % 256
        return out

    def close(self) -> None:
        pass


class PrefetchReader:
    """Decode-ahead wrapper: reads segment N+1 on a host thread while the
    device computes segment N (the double-buffering called for in
    SURVEY.md §7.8; cv2 releases the GIL during decode).

    Usage: schedule(indices) before heavy device work, then read_frames with
    the SAME indices returns the prefetched batch.
    """

    def __init__(self, reader):
        import concurrent.futures

        self._reader = reader
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[tuple] = None
        self.total_frames = reader.total_frames
        self.frame_rate = reader.frame_rate

    def schedule(self, indices: Sequence[int]) -> None:
        indices = tuple(indices)
        self._pending = (indices, self._pool.submit(self._reader.read_frames, indices))

    def read_frames(self, indices: Sequence[int]) -> np.ndarray:
        indices = tuple(indices)
        if self._pending is not None:
            sched, fut = self._pending
            self._pending = None
            if sched == indices:
                return fut.result()
            # A stale prefetch is still driving the capture on the worker
            # thread; wait it out before touching the (not thread-safe)
            # cv2.VideoCapture from this thread.
            fut.result()
        return self._reader.read_frames(indices)

    def stop(self) -> None:
        """Shut down the worker thread, leaving the wrapped reader open."""
        self._pool.shutdown(wait=False)

    def close(self) -> None:
        self.stop()
        self._reader.close()


def open_video(path: Optional[str], **synthetic_kwargs):
    """Path -> VideoReader; None -> SyntheticVideoReader (tests)."""
    if path is None:
        return SyntheticVideoReader(**synthetic_kwargs)
    return VideoReader(path)
