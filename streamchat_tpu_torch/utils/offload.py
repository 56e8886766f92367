"""Park idle parameter trees in host memory (`streamchat_tpu/utils/offload.py`).

During a segment's caption loop only the decoder runs: the vision tower,
the projector and both text embedders idle until `tree.add_chunks` embeds
the new captions. A `WeightOffloader` parks those trees in pinned host
memory for the loop (`--offload_residents`) and puts them back after it.

Semantics, as in the JAX package:
- The host copy is made at the first offload of a tree and reused: serving
  weights do not change, so later offloads copy nothing back. A tree that
  was replaced since its last restore (the ViT's lazy fold swaps in a new
  tree, `LongVA.encode_images`) is copied anew, so a restore never brings
  back a tree that the attribute no longer held.
- An offload that is repeated, or limited to some names, leaves what is
  already parked alone.
- Parking replaces the attribute and touches no tensor: a caller that
  still holds the device tree computes with it as before, and the parked
  (host) tree computes the same function on the CPU.

Each restore is a non-blocking copy from pinned memory per tensor
(`block=True` waits for them). `offload_s` / `restore_s` total the host
seconds of each direction.
"""

from __future__ import annotations

import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch


def map_tensors(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """`fn` over every tensor leaf of a dict / list / tuple tree; other
    leaves (ints such as a resampler's head count, None) are kept."""
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def tensors(tree: Any) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    map_tensors(out.append, tree)
    return out


def to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of `t`: pinned when `t` lies on the card (the copy
    returns once the bytes have arrived), a plain clone of a CPU tensor."""
    if t.device.type != "cuda":
        return t.clone()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def synchronize(devices) -> None:
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _same_tensors(refs: Optional[list], leaves: List[torch.Tensor]) -> bool:
    """Whether `leaves` are the very tensors `refs` point at, in order."""
    return (refs is not None and len(refs) == len(leaves)
            and all(r() is t for r, t in zip(refs, leaves)))


class WeightOffloader:
    """Round-trips registered `(obj, attr)` parameter trees between the
    device and pinned host memory."""

    def __init__(self):
        self._entries: Dict[str, Tuple[object, str]] = {}
        # name -> (weak references to the tensors of the tree last restored,
        # None while parked; the host tree; the device of each tensor leaf).
        self._host: Dict[str, Tuple[Optional[list], Any, List[torch.device]]] = {}
        self.offloaded: set = set()
        self.offload_s = 0.0
        self.restore_s = 0.0

    def register(self, name: str, obj: object, attr: str) -> "WeightOffloader":
        """Track `getattr(obj, attr)` (a tree of tensors) under `name`."""
        self._entries[name] = (obj, attr)
        return self

    @property
    def names(self) -> List[str]:
        return list(self._entries)

    def host_bytes(self) -> int:
        """Bytes of the cached host copies."""
        return sum(t.nbytes for _, host, _ in self._host.values() for t in tensors(host))

    def offload(self, names: Optional[Sequence[str]] = None) -> None:
        """Replace each device tree with its host copy (made now if the
        tree is new to the offloader); the device tensors are freed once
        no caller holds them."""
        t0 = time.perf_counter()
        for name in names if names is not None else list(self._entries):
            if name in self.offloaded:
                continue
            obj, attr = self._entries[name]
            tree = getattr(obj, attr)
            leaves = tensors(tree)
            cached = self._host.get(name)
            if cached is None or not _same_tensors(cached[0], leaves):
                self._host[name] = (None, map_tensors(to_host, tree),
                                    [t.device for t in leaves])
            else:
                self._host[name] = (None,) + cached[1:]
            setattr(obj, attr, self._host[name][1])
            self.offloaded.add(name)
        self.offload_s += time.perf_counter() - t0

    def restore(self, names: Optional[Sequence[str]] = None, block: bool = False) -> None:
        """Put the parked trees back on the devices they came from."""
        t0 = time.perf_counter()
        used = set()
        for name in names if names is not None else list(self._entries):
            if name not in self.offloaded:
                continue
            obj, attr = self._entries[name]
            _, host, devices = self._host[name]
            placed = iter(devices)

            def put(t):
                dev = next(placed)
                used.add(dev)
                return t.to(dev, non_blocking=True)

            tree = map_tensors(put, host)
            setattr(obj, attr, tree)
            self._host[name] = ([weakref.ref(t) for t in tensors(tree)], host, devices)
            self.offloaded.discard(name)
        if block:
            synchronize(used)
        self.restore_s += time.perf_counter() - t0
