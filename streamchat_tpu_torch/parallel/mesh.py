"""The (data, model) mesh of one rank (`streamchat_tpu/parallel/mesh.py`).

The JAX package builds a (data, model) `Mesh` over every device one
controller sees. The port runs one process a rank, Megatron-style, and
lays the ranks out as JAX lays out its devices,
`np.arange(world).reshape(dp, tp)`: rank r has data index r // tp and
model index r % tp (`layout`). `make_mesh` returns the rank's `Mesh`: its
model axis as a `ModelGroup` (a `torch.distributed` process group, the
rank's index in it and its size), over which the decoder all-reduces, and
its data axis, the group of the ranks that share its model index. Tensor
parallelism needs one collective, `all_reduce`, so the same code runs over
gloo on the CPU, over gloo with several ranks sharing one card (NCCL takes
one card a rank), and over NCCL with a card a rank. No parameter is cut
over the data axis (as no JAX pspec names it): each data replica holds a
whole copy of the model, sharded over its own model group.

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


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's place on the (data, model) mesh: `model`, its model-axis
    group; `data_group`, the ranks that share its model index (None while
    the data axis is one rank); `data`, its index on the data axis of `dp`."""

    model: ModelGroup = dataclasses.field(default_factory=ModelGroup)
    data_group: Any = None
    data: int = 0
    dp: int = 1

    @property
    def tp(self) -> int:
        return self.model.size

    @property
    def coords(self) -> Tuple[int, int]:
        """(data index, model index) of this rank."""
        return self.data, self.model.rank

    @property
    def shape(self) -> dict:
        """Axis sizes by name, as `jax.sharding.Mesh.shape`."""
        return {DATA_AXIS: self.dp, MODEL_AXIS: self.tp}


def layout(world: int, dp: Optional[int] = None, tp: Optional[int] = None, *,
           kv_heads: int = 4) -> Tuple[int, int]:
    """(dp, tp) of a mesh over `world` ranks, by JAX `make_mesh`'s rules:
    neither given -> `best_mesh_shape(world, kv_heads=...)`, one given -> the
    other divides it out; ValueError unless dp * tp == world. Rank r then
    sits at (r // tp, r % tp)."""
    if dp is None and tp is None:
        dp, tp = best_mesh_shape(world, kv_heads=kv_heads)
    elif dp is None:
        dp = world // tp
    elif tp is None:
        tp = world // dp
    if dp * tp != world:
        raise ValueError(f"mesh {dp}x{tp} != {world} devices")
    return dp, tp


def make_mesh(dp: Optional[int] = None, tp: Optional[int] = None, *, group=None,
              kv_heads: int = 4) -> Mesh:
    """This rank's `Mesh` over the initialized world, laid out by `layout`
    (a world of one when no process group is initialized, as a
    single-device mesh in the JAX package). `group`, when given, is the
    model axis as it is, with a data axis of one. Every rank must call it
    with the same arguments: every rank makes every group, in the same
    order (first the model groups by data index, then the data groups by
    model index)."""
    import torch.distributed as dist

    if group is not None:
        return Mesh(ModelGroup(group=group, rank=dist.get_rank(group),
                               size=dist.get_world_size(group),
                               backend=str(dist.get_backend(group))))
    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    dp, tp = layout(world, dp, tp, kv_heads=kv_heads)
    if world == 1:
        return Mesh()
    data, index = divmod(dist.get_rank(), tp)
    backend = str(dist.get_backend())
    model = dist.group.WORLD if dp == 1 else None
    data_group = dist.group.WORLD if tp == 1 else None
    if dp > 1 and tp > 1:
        models = [dist.new_group([d * tp + m for m in range(tp)]) for d in range(dp)]
        datas = [dist.new_group([d * tp + m for d in range(dp)]) for m in range(tp)]
        model, data_group = models[data], datas[index]
    model_axis = (ModelGroup() if tp == 1 else
                  ModelGroup(group=model, rank=index, size=tp, backend=backend))
    return Mesh(model_axis, data_group, data, dp)
