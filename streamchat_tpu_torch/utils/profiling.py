"""Phase timing and device traces (`streamchat_tpu/utils/profiling.py`).

  timer = PhaseTimer()
  with timer.phase("ingest"): ...
  timer.totals  # {"ingest": s}

Host wall-clock per named phase. A phase that ends in device work measures
the device only if the caller synchronises inside the window (the runner
does, through `synchronize`, so phase totals are true on a GPU). Each
window is also a `record_function` named "phase=<name>" in a torch.profiler
trace (a few microseconds when no profiler runs); it encloses the window's
synchronize, so every kernel of the phase ends inside it
(`utils.traceparse.device_seconds_by_phase` buckets device time by these
windows). Set STREAMCHAT_TRACE_DIR to write a Chrome trace of everything
inside `maybe_device_trace()` into that directory.

`device_ms(fn, iters[, kernel])` is the device time of a GPU call: the summed
durations of the device events torch.profiler records. `device_launches(fn,
iters)` splits it by launch: (kernel name, ms) for each device event of one
call, in launch order, averaged over the calls.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, Optional

TRACE_DIR_ENV = "STREAMCHAT_TRACE_DIR"


class PhaseTimer:
    def __init__(self, synchronize: Optional[Callable[[], None]] = None) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._sync = synchronize

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with annotate(f"phase={name}"):
                try:
                    yield
                finally:
                    if self._sync is not None:
                        self._sync()
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        return dict(self.totals)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region in the torch.profiler trace (`record_function`)."""
    from torch.profiler import record_function

    with record_function(name):
        yield


@contextlib.contextmanager
def maybe_device_trace() -> Iterator[None]:
    """A torch.profiler trace of the block, CPU and CUDA activity (CPU alone
    where no card is visible), written as a Chrome trace
    `<host>_<pid>.<ms>.pt.trace.json` into $STREAMCHAT_TRACE_DIR; a no-op
    when it is unset."""
    trace_dir = os.environ.get(TRACE_DIR_ENV)
    if not trace_dir:
        yield
        return
    import socket

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"{socket.gethostname()}_{os.getpid()}.{time.time_ns() // 10**6}"
                   ".pt.trace.json"))


# Profiled windows device_ms measures before it gives up on a call.
PROFILE_ATTEMPTS = 5


def _device_events(fn: Callable[[], object], iters: int, kernel: Optional[str] = None):
    """The device events torch.profiler records over `iters` calls of `fn`
    (after one warm-up call), in start order; with `kernel`, only those
    whose name contains it. A window that lost events (none at all, or a
    count that is not a whole number per call, which the profiler now and
    then hands back) is measured again, PROFILE_ATTEMPTS windows at most;
    then the last window with events is taken, and none at all raises."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    found = None
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                  and (kernel is None or kernel in e.name)]
        if events:
            found = sorted(events, key=lambda e: e.time_range.start)
            if len(events) % iters == 0:
                return found
    if found:
        return found
    raise AssertionError(f"torch.profiler recorded no device event in "
                         f"{PROFILE_ATTEMPTS} windows")


def device_launches(fn: Callable[[], object], iters: int):
    """[(kernel name, ms)] for each device event of one call of `fn`, in
    launch order, each averaged over `iters` calls; raises if the calls did
    not record the same number of events."""
    events = _device_events(fn, iters)
    if len(events) % iters:
        raise AssertionError(f"{len(events)} device events over {iters} calls")
    per = len(events) // iters
    return [(events[i].name, sum(e.time_range.elapsed_us() for e in events[i::per])
             / iters / 1e3) for i in range(per)]


def device_ms(fn: Callable[[], object], iters: int, kernel: Optional[str] = None) -> float:
    """Device time per call of `fn` on the GPU: the summed durations of the
    device events (kernels and copies) torch.profiler records over `iters`
    calls, after one warm-up call; with `kernel`, only the events whose name
    contains it (one kernel of a wrapper that also runs small torch ops).
    For a kernel shorter than its wrapper's host work this is the kernel's
    time, where CUDA events over
    back-to-back calls would time the host's pace. The profiler now and
    then hands back a window that lost device events; such a window is
    measured again (`_device_events`)."""
    events = _device_events(fn, iters, kernel)
    return sum(e.time_range.elapsed_us() for e in events) / iters / 1e3


def host_us(fn: Callable[[], object], iters: int) -> float:
    """Host time per call of `iters` back-to-back calls of `fn` that queue on
    the device without a synchronise (a wrapper's checks, allocations and
    launches), after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us
