"""The model axis of tensor parallelism (`streamchat_tpu/parallel/mesh.py`).

The JAX package builds a (data, model) `Mesh` over every device one
controller sees. The port runs one process a rank, Megatron-style, and a
rank sees the model axis as a `ModelGroup`: a `torch.distributed` process
group, the rank's index in it and its size. Tensor parallelism needs one
collective, `all_reduce`, so the same code runs over gloo on the CPU, over
gloo with several ranks sharing one card (NCCL takes one card a rank),
and over NCCL with a card a rank.

In this port the world is the model axis: a world whose `best_mesh_shape`
has a data axis larger than one raises (ROADMAP §A "Multi-GPU: the data
axis").

Every all_reduce goes through `ModelGroup.all_reduce`, which counts the
calls, bytes and host seconds (`collective_stats`), and, inside
`record_collectives`, notes each call's thread and label, so a test can
hold the order in which ranks take their collectives.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, List, Optional, Tuple

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"

_LOCK = threading.Lock()
_STATS: dict = {}              # label -> {"count", "bytes", "seconds"}
_TRACE: Optional[List[Tuple[str, str]]] = None


def best_mesh_shape(n_devices: int, max_model: int = 8, kv_heads: int = 4) -> Tuple[int, int]:
    """(dp, tp) for `n_devices`: TP is the largest power of two that
    divides n_devices and stays within `max_model` and the decoder's KV-head
    count (Qwen2-7B has 4); the remaining devices form the data axis."""
    tp = 1
    limit = min(max_model, kv_heads)
    while tp * 2 <= limit and n_devices % (tp * 2) == 0:
        tp *= 2
    return n_devices // tp, tp


def collective_stats() -> dict:
    """all_reduce calls, bytes and host seconds since the last reset, in
    all and by label ("by_label")."""
    with _LOCK:
        by = {k: dict(v) for k, v in _STATS.items()}
    return {**{k: sum(v[k] for v in by.values()) for k in ("count", "bytes", "seconds")},
            "by_label": by}


def reset_collective_stats() -> None:
    with _LOCK:
        _STATS.clear()


@contextlib.contextmanager
def record_collectives():
    """Yield a list that receives (thread name, label) for every
    all_reduce taken inside the block, in call order."""
    global _TRACE
    trace: List[Tuple[str, str]] = []
    _TRACE = trace
    try:
        yield trace
    finally:
        _TRACE = None


@dataclasses.dataclass(frozen=True)
class ModelGroup:
    """The model axis as one rank sees it: `group` (None for a world of
    one), the rank's index in it and its size, and the group's backend."""

    group: Any = None
    rank: int = 0
    size: int = 1
    backend: str = "none"
    # dtype -> the pinned host buffer a gloo group stages CUDA tensors
    # through, grown when too small (page-locking is slow, so it is reused).
    _pinned: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def all_reduce(self, t: torch.Tensor, label: str = "") -> torch.Tensor:
        """Sum `t` over the group, in place, and return it.

        An NCCL group reduces on the card. A gloo group reduces a CPU
        tensor as it is; a CUDA tensor it stages through a pinned host
        buffer kept for the group (copy out, reduce on the host, copy back):
        PyTorch documents gloo's CUDA support for all_reduce, but PyTorch
        2.11 (CUDA 12.8) hands the device pointer to gloo's TCP transport,
        which aborts ("writev: Bad address"). The staging is for gloo groups
        only, and `chip_smoke.py` names it on its lines. The host seconds
        counted here are the call's whole time under gloo (the call returns
        when the sum is back) and only its launch under NCCL."""
        if self.size == 1:
            return t
        import torch.distributed as dist

        t0 = time.perf_counter()
        if t.is_cuda and self.backend == "gloo":
            buf = self._pinned.get(t.dtype)
            if buf is None or buf.numel() < t.numel():
                buf = self._pinned[t.dtype] = torch.empty(t.numel(), dtype=t.dtype,
                                                          pin_memory=True)
            host = buf[:t.numel()].view(t.shape)
            host.copy_(t)
            dist.all_reduce(host, group=self.group)
            t.copy_(host)
        else:
            dist.all_reduce(t, group=self.group)
        dt = time.perf_counter() - t0
        with _LOCK:
            st = _STATS.setdefault(label, {"count": 0, "bytes": 0, "seconds": 0.0})
            st["count"] += 1
            st["bytes"] += t.numel() * t.element_size()
            st["seconds"] += dt
            if _TRACE is not None:
                _TRACE.append((threading.current_thread().name, label))
        return t


def make_mesh(*, group=None, kv_heads: int = 4) -> ModelGroup:
    """The model-axis group of this rank: `group` when given, else the
    world (a world of one when no process group is initialized, as a
    single-device mesh in the JAX package). A world whose
    `best_mesh_shape` at `kv_heads` has a data axis above one raises
    NotImplementedError."""
    import torch.distributed as dist

    if group is None and not (dist.is_available() and dist.is_initialized()):
        return ModelGroup()
    g = group if group is not None else dist.group.WORLD
    n = dist.get_world_size(g)
    dp, tp = best_mesh_shape(n, kv_heads=kv_heads) if group is None else (1, n)
    if dp != 1:
        raise NotImplementedError(
            f"{n} ranks at {kv_heads} kv heads make a {dp} x {tp} mesh with a data axis of "
            f"{dp}: only a data axis of one is ported, ROADMAP §A 'Multi-GPU: the data axis'")
    return ModelGroup(group=g, rank=dist.get_rank(g), size=n,
                      backend=str(dist.get_backend(g)))
