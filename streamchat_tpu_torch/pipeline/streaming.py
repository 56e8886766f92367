"""Live streaming session of the on-line mode: ingest and memory update at
once (`streamchat_tpu/pipeline/streaming.py`).

The caller pushes encoded frame features as they stream in; a worker thread
turns each full chunk (and each flushed partial tail) into a captioned tree
node while the caller keeps ingesting; a question sees a consistent
snapshot. A bounded queue (8 chunks) feeds the worker whole chunks, the
tree and the short-term FIFO each sit behind a lock, and `ask` waits for
the queue to drain before it answers.

On a GPU both threads launch on the default stream (the current stream is
per thread, and neither thread sets another), so the card runs the worker's
caption kernels and the caller's ingest kernels in launch order and the
chunk tensors handed from one thread to the other need no stream
synchronization. The worker makes the session's device current for itself
(`torch.cuda.set_device` is per thread). Draws from the shared
`torch.Generator` (the worker's k-means, `ask`'s short-term sample, and a
tree merge when the caller's merge function takes the same lock) happen
under one lock; since `ask` drains the queue first, each breakpoint's
k-means draws come before its sample. A worker error (a caption's CUDA
error or OOM included) is kept and raised by the next `sync`, `ask` or
`close`, never dropped.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, List, Optional

import torch

from streamchat_tpu_torch.config import MemoryConfig
from streamchat_tpu_torch.memory.short_term import ShortTermMemory
from streamchat_tpu_torch.memory.tree import VisualMemoryTree
from streamchat_tpu_torch.models import step_graph
from streamchat_tpu_torch.ops.kmeans import weighted_kmeans_feature
from streamchat_tpu_torch.utils.profiling import span

CaptionFn = Callable[[torch.Tensor], str]


class StreamingSession:
    """Incremental video QA session; thread-safe push / ask."""

    def __init__(self, tree: VisualMemoryTree, caption_fn: CaptionFn, cfg: MemoryConfig,
                 generator: torch.Generator | None = None, cluster_full_chunks: bool = True,
                 *, generator_lock: threading.Lock | None = None, device=None) -> None:
        self.tree = tree
        self.cfg = cfg
        self._caption = caption_fn
        self._cluster = cluster_full_chunks
        self._generator = generator
        self._generator_lock = generator_lock or threading.Lock()
        self._device = None if device is None else torch.device(device)
        self.short_term = ShortTermMemory(cfg.short_window, cfg.remember_window, cfg.tau)
        self._pending: List[torch.Tensor] = []       # frames awaiting a full chunk
        self._chunks: queue.Queue = queue.Queue(maxsize=8)
        self._tree_lock = threading.Lock()
        self._short_lock = threading.Lock()
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self.worker_ident = self._worker.ident     # the thread of its spans

    # Producer side

    def push(self, features: torch.Tensor) -> None:
        """Feed encoded frame features [N, P, D] as they stream in."""
        with self._short_lock:
            self.short_term.extend(features)
        for i in range(features.shape[0]):
            self._pending.append(features[i])
            if len(self._pending) >= self.cfg.chunk_size:
                chunk = torch.stack(self._pending[: self.cfg.chunk_size])
                del self._pending[: self.cfg.chunk_size]
                self._chunks.put(chunk)          # blocks while the worker is behind

    def flush(self) -> None:
        """Enqueue the partial tail chunk (end of stream, or before a question)."""
        if self._pending:
            self._chunks.put(torch.stack(self._pending))
            self._pending.clear()

    # Worker

    def _run(self) -> None:
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        try:
            self._serve()
        finally:
            step_graph.release()      # this thread's kept decode workspaces and graphs

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                chunk = self._chunks.get(timeout=0.05)
            except queue.Empty:
                continue
            try:
                node_feats = chunk
                if (self._cluster and chunk.shape[0] >= self.cfg.chunk_size
                        and chunk.shape[0] > self.cfg.num_clusters):
                    with span("memory.cluster"), self._generator_lock:
                        node_feats, _ = weighted_kmeans_feature(
                            chunk, self.cfg.num_clusters, generator=self._generator)
                with span("memory.caption", chunks=1):
                    caption = self._caption(chunk)
                with self._tree_lock:
                    self.tree.add_chunks([node_feats], [caption])
            except BaseException as e:       # raised by the next sync / ask / close
                self._error = e
            finally:
                self._chunks.task_done()

    # Consumer side

    def sync(self) -> None:
        """Block until every queued chunk is in the tree; raise a worker error."""
        self._chunks.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def ask(self, answer_fn: Callable[[torch.Tensor, VisualMemoryTree], object]):
        """answer_fn(short_memory [R, P, D], tree) on a consistent snapshot
        (the wait for the queue is an `online.drain` span)."""
        with span("online.drain"):
            self.sync()
        with self._short_lock, self._generator_lock:
            short = self.short_term.sample(self._generator)
        with self._tree_lock:
            return answer_fn(short, self.tree)

    def close(self) -> None:
        """Drain the queue, then stop the worker (also when a worker error
        is raised here)."""
        try:
            self.sync()
        finally:
            self._stop.set()
            self._worker.join(timeout=5)
