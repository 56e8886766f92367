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

A wrapper called while its thread captures a CUDA graph
(`models/step_graph.StepGraph`) launches nothing: inside `recording()` the
thread's `launched` calls are tallied for the graph instead of counted, and
each replay of the graph adds that tally back (`add_launches`), so the
counters stay the launches the card made. Other threads count as usual.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Iterator, Optional, Tuple

_WRAPPERS: Dict[str, Callable] = {}
_LOCK = threading.Lock()
_CAPTURE = threading.local()


def counted(fn: Callable) -> Callable:
    """Register a kernel wrapper and give it a `launches` counter."""
    fn.launches = 0
    fn.modes = {}
    _WRAPPERS[fn.__name__] = fn
    return fn


def launched(fn: Callable, mode: Optional[str] = None) -> None:
    """Count one launch of `fn`'s kernel (atomic across threads), in `mode`
    when the kernel has modes; inside this thread's `recording()` tally it
    there instead."""
    tally = getattr(_CAPTURE, "tally", None)
    if tally is not None:
        tally[fn, mode] = tally.get((fn, mode), 0) + 1
        return
    _add(fn, mode, 1)


def _add(fn: Callable, mode: Optional[str], n: int) -> None:
    with _LOCK:
        fn.launches += n
        if mode is not None:
            fn.modes[mode] = fn.modes.get(mode, 0) + n


@contextlib.contextmanager
def recording() -> Iterator[Dict[Tuple[Callable, Optional[str]], int]]:
    """The `launched` calls this thread makes inside the block -> a tally
    {(wrapper, mode): calls}, left out of the counters."""
    if getattr(_CAPTURE, "tally", None) is not None:
        raise RuntimeError("kernels.recording() does not nest")
    _CAPTURE.tally = tally = {}
    try:
        yield tally
    finally:
        _CAPTURE.tally = None


def add_launches(tally: Dict[Tuple[Callable, Optional[str]], int]) -> None:
    """Count the launches of a `recording()` tally: one replay of the graph
    captured while it was recorded."""
    for (fn, mode), n in tally.items():
        _add(fn, mode, n)


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
