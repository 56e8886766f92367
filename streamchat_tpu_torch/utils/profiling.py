"""Spans, phase timing and device traces (`streamchat_tpu/utils/profiling.py`).

  with span("decode.step"): ...          # recorded into the ring
  spans(t0_ns, t1_ns)                    # the spans that started inside
  timer = PhaseTimer()
  with timer.phase("ingest"): ...
  timer.totals  # {"ingest": s}

`span(name, **tags)` is the program's one recorder. Every layer of the main
path opens its spans through it (the names are in the README's tracing
paragraph): the decode loops (`decode.step` and its `decode.alloc`,
`decode.replay`, `decode.readback`; `generate` with `generate.prefill` and
`generate.decode`), ingest (`ingest.read`, `ingest.upload`,
`ingest.encode`), the memory update (`memory.update`, `memory.short`,
`memory.cluster`, `memory.caption`, `memory.tree_add`,
`memory.summarize`), retrieval (`answer.history`, `answer.embed_query`,
`answer.tree_search`) and the on-line session (`online.drain`). A span is
(name, start_ns, end_ns, id, parent id, request id, thread, tags) on the
host clock `time.perf_counter_ns()`. Each thread keeps its own stack of
open spans: a span opened with none open is a root, and its id is the
request id of every span under it. A closed span goes into a ring of the
newest RING_SPANS spans (`dropped()` counts those overwritten). A span
adds no synchronize: device work it queued shows in whichever later span
waits for it.

While a torch.profiler session records, and only then, each span is also a
`record_function("streamchat.<name>")`, so the Chrome trace holds it on the
device events' clock. Outside a profiler a span costs a flag test, two
clock reads and its ring slot.

`PhaseTimer` times named phases through `span` ("phase.<name>"). A phase
that ends in device work measures the device only if the caller
synchronises inside the window (the runner does, through `synchronize`,
so phase totals are true on a GPU). Each window is also a
`record_function` named "phase=<name>" in a torch.profiler trace (a few
microseconds when no profiler runs); it encloses the window's
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
import itertools
import os
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch.autograd.profiler as _autograd_profiler
from torch.autograd.profiler import record_function

TRACE_DIR_ENV = "STREAMCHAT_TRACE_DIR"
# Spans the ring keeps: a 40 s window of answers holds ~18 x 3 x 256 decode
# spans, and the ring holds several such windows.
RING_SPANS = 1 << 17
# The prefix of a span's `record_function` under a profiler.
ANNOTATION_PREFIX = "streamchat."

_ring: List[Optional[tuple]] = [None] * RING_SPANS
_mask = RING_SPANS - 1
_slots = itertools.count()          # ring slots handed out (next() is atomic)
_ids = itertools.count(1)           # span ids; 0 is "no parent"
_clock = time.perf_counter_ns


class _Local(threading.local):
    def __init__(self) -> None:
        self.stack: List[Span] = []
        self.thread = threading.get_ident()


_local = _Local()


class Record(NamedTuple):
    """A closed span. The ring keeps it as a plain tuple of strings and
    ints (its tags as a tuple of pairs), which the garbage collector stops
    tracking, so that a full ring adds nothing to a collection's walk."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int              # the enclosing span's id, 0 for a root
    request: int             # the root's id
    thread: int
    tags: dict
    slot: int                # its place in the order spans closed

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class Span:
    """One window of the program, open: `tags` may be added to until it
    closes, and then the ring keeps it as a `Record`."""

    __slots__ = ("name", "tags", "start_ns", "end_ns", "id", "parent", "request", "thread",
                 "_annotation")

    def __init__(self, name: str, **tags) -> None:
        self.name, self.tags, self.end_ns = name, tags, 0

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def __enter__(self):
        loc = _local
        stack = loc.stack
        self.id = sid = next(_ids)
        if stack:
            top = stack[-1]
            self.parent, self.request = top.id, top.request
        else:
            self.parent, self.request = 0, sid
        self.thread = loc.thread
        stack.append(self)
        # Under a profiler the clock reads sit inside the annotation, so that
        # the annotation's own allocation (and any collection it sets off)
        # falls outside both.
        if _autograd_profiler._is_profiler_enabled:
            self._annotation = record_function(ANNOTATION_PREFIX + self.name)
            self._annotation.__enter__()
        else:
            self._annotation = None
        self.start_ns = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = end = _clock()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
            self._annotation = None
        stack = _local.stack
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        slot = next(_slots)
        _ring[slot & _mask] = (self.name, self.start_ns, end, self.id, self.parent,
                               self.request, self.thread,
                               tuple(self.tags.items()) if self.tags else (), slot)
        return False


span = Span


def _record(s: tuple) -> Record:
    return Record(*s[:7], dict(s[7]), s[8])


def _kept() -> List[Record]:
    return [_record(s) for s in list(_ring) if s is not None]


def spans(t0_ns: Optional[int] = None, t1_ns: Optional[int] = None) -> List[Record]:
    """The ring's spans that started in [t0_ns, t1_ns), oldest first (every
    span kept without bounds)."""
    lo = -1 if t0_ns is None else t0_ns
    hi = None if t1_ns is None else t1_ns
    out = [_record(s) for s in list(_ring)
           if s is not None and s[1] >= lo and (hi is None or s[1] < hi)]
    out.sort(key=lambda s: (s.start_ns, s.id))
    return out


def dropped() -> int:
    """Spans the ring overwrote since the last `reset`."""
    kept = _kept()
    return max(0, max((s.slot for s in kept), default=-1) + 1 - len(_ring))


def intact_since(t0_ns: int) -> bool:
    """Whether every span that started at or after t0_ns and has closed is
    still in the ring. Ids are handed out in start order, so it is when
    every id after the last kept span that started before t0_ns is kept
    (or still open on this thread); with none kept from before t0_ns, only
    a ring that dropped nothing is."""
    kept = _kept()
    if max((s.slot for s in kept), default=-1) + 1 <= len(_ring):
        return True
    before = [s.id for s in kept if s.start_ns < t0_ns]
    if not before:
        return False
    last = max(before)
    after = {s.id for s in kept if s.id > last} | {s.id for s in _local.stack if s.id > last}
    return len(after) == max(after, default=last) - last


def totals(of: List[Record]) -> Tuple[Dict[str, float], Dict[str, int]]:
    """Seconds and counts of `of`, summed by span name."""
    secs: Dict[str, float] = defaultdict(float)
    counts: Dict[str, int] = defaultdict(int)
    for s in of:
        secs[s.name] += s.seconds
        counts[s.name] += 1
    return dict(secs), dict(counts)


def reset(size: int = RING_SPANS) -> None:
    """Empty the ring (a new one of `size` slots, a power of two) and its
    counters; this thread's open spans are forgotten."""
    global _ring, _mask, _slots
    if size <= 0 or size & (size - 1):
        raise ValueError(f"the ring's size must be a power of two, not {size}")
    _ring, _mask, _slots = [None] * size, size - 1, itertools.count()
    _local.stack.clear()


class PhaseTimer:
    def __init__(self, synchronize: Optional[Callable[[], None]] = None) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._sync = synchronize

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        window = span("phase." + name)
        try:
            with window, annotate(f"phase={name}"):
                try:
                    yield
                finally:
                    if self._sync is not None:
                        self._sync()
        finally:
            self.totals[name] += window.seconds
            self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        return dict(self.totals)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region in the torch.profiler trace (`record_function`)."""
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
