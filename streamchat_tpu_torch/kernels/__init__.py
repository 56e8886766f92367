"""Kernel library loader and the launch counters of the kernel wrappers.

Each wrapper of a hand-written kernel is registered with `counted`; it calls
`launched` where it launches its kernel on a CUDA tensor, and nowhere else
(the CPU branch runs the plain PyTorch version and does not count), which
adds one to its `launches` attribute under a lock: the on-line session
launches from a worker thread and the main thread at once.
`launch_counts()` reads every counter and `reset_launch_counts()` zeroes
them, so a run can show that its main path went through the kernels. A
wrapper whose kernel has modes (K1's folded / one-pass / clamp form, a
probe's variant) names the mode of each launch, `launched(fn, mode)`, and
`launch_modes()` reads those tallies (one entry per mode, summing to the
count).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

_WRAPPERS: Dict[str, Callable] = {}
_LOCK = threading.Lock()


def counted(fn: Callable) -> Callable:
    """Register a kernel wrapper and give it a `launches` counter."""
    fn.launches = 0
    fn.modes = {}
    _WRAPPERS[fn.__name__] = fn
    return fn


def launched(fn: Callable, mode: Optional[str] = None) -> None:
    """Count one launch of `fn`'s kernel (atomic across threads), in `mode`
    when the kernel has modes."""
    with _LOCK:
        fn.launches += 1
        if mode is not None:
            fn.modes[mode] = fn.modes.get(mode, 0) + 1


def launch_counts() -> Dict[str, int]:
    with _LOCK:
        return {name: fn.launches for name, fn in _WRAPPERS.items()}


def launch_modes() -> Dict[str, Dict[str, int]]:
    """wrapper name -> {mode: launches} for the wrappers that named a mode."""
    with _LOCK:
        return {name: dict(fn.modes) for name, fn in _WRAPPERS.items() if fn.modes}


def reset_launch_counts() -> None:
    with _LOCK:
        for fn in _WRAPPERS.values():
            fn.launches = 0
            fn.modes = {}
