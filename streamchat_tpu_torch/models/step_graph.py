"""One decode step as one device program, kept across generate calls: the
counterpart of the JAX package's `lax.while_loop` decode loops
(`streamchat_tpu/models/generate.py` `generate`, `generate_paged.py`'s
fused sample -> (compress) -> alloc -> attend loop, `spec_decode.py`'s
verify loop), each of which XLA compiles once for each set of static
arguments and shapes and the host starts once a call.

A loop hands `StepGraph` its body as a function of no argument: it reads
and writes only tensors that keep their addresses (the logits it samples
from, the output tokens, a device step counter, the done flags, the
cache's length, table and pools; `bound()` lists them), updates each in
place, and reads nothing back to the host. The host keeps the loop's
control: it calls the `StepGraph` once a step and reads what it needs
between calls (the done flags, the allocator's overflow flag, a verify
step's continue flag), as the JAX loop's `cond` reads them, and runs what
changes a step's form between calls (the H2O compression).

On a CUDA device:
* call 1 of a new `StepGraph` runs the step eagerly, on a side stream: the
  warm-up, which makes every one-time host call of the path outside
  capture (the kernels' `cudaFuncSetAttribute`, the TMA encoder lookup,
  loading the kernel library, cuBLAS's workspace for that stream);
* call 2 captures the step with `torch.cuda.CUDAGraph` on that stream, the
  caller's generator registered with the graph (each replay then draws
  from the generator what an eager step would, and advances it as far),
  and replays it once, since capture records the work without running it;
* every later call replays the graph, in this generate call and in every
  later one at the same key (below).

Capture runs in "thread_local" mode: the on-line session's other host
thread may go on launching on the card meanwhile. A capture that fails
raises; no call falls back to the eager step. The kernel wrappers'
`launched` calls made while capturing are tallied (`kernels.recording`),
and each replay counts the tally again, so the launch counters stay the
launches the card made.

The jit cache's counterpart: `workspace(key, params, generator, device)`
keeps, for each thread and device, the `Workspace` of every decode-loop key
it has seen: the loop's static tensors (pools and scales, table, length,
`next_free`, logits, output tokens, done flags, step counter, H2O's scores,
the speculative loop's history) and its `StepGraph`s. The key is what the
JAX jits key on: the loop's form, the decoder tree (every leaf's address,
shape, stride and dtype: what a graph reads of it), the rows, the pool's or
dense cache's shape and dtype, max_new_tokens, temperature, top_p, eos_ids,
the speculative and H2O settings, and the generator object (a graph is
registered with one generator; the workspace keeps it alive). A call at a
known key writes its prefill into the workspace's tensors in place, resets
the counters and flags, and replays from its first step: no warm-up, no
capture. A workspace whose tree has been freed is dropped at the next
claim.

Memory: every capture of a thread goes into one graph memory pool a device,
that of its live graphs (a new one once they have all been dropped). A
step leaves nothing alive there: its
outputs are copied into workspace tensors, allocated outside any capture,
and its temporaries die with the step, so after a capture the pool holds no
live block (`pool_bytes` reads it) and any kept graph may replay after any
other graph of its thread: a replay only rewrites blocks no one reads
across replays. The pool holds what the largest step needs. The
workspaces' static tensors are bounded by WORKSPACE_BYTES (4 GiB) a thread
and device: past it the least recently used workspaces are dropped,
always outside any capture (captures and evictions hold one lock), their
memory given back to the card (`torch.cuda.empty_cache`), and the newest
is kept even alone over the bound. `release()` drops the calling thread's
workspaces the same way (a thread ending, or a model being freed).

On the CPU, and on the card where the caller asks for it (`graph=False`),
every call runs the same step eagerly, so the CPU tests hold the graphed
loops' arithmetic and the workspaces' reuse. After every call the tensors
of `bound()` must sit where they sat after the first: a step that rebound
one (`cache.length = ...`) would leave a replay on the old buffer, so the
loop raises instead.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
import weakref
from typing import Callable, Optional, Sequence

import torch

from streamchat_tpu_torch import kernels
from streamchat_tpu_torch.utils.profiling import span

# Bytes of workspace tensors kept a thread and device: a chunk-40 caption's
# pool (~1.36 GB of bf16 pages at LongVA-7B), a partial chunk's and a few
# answers', or the judge's dense cache (~0.8 GB at LLaMA-3-8B, 8 rows).
# Kept tensors also pin the allocator's segments, so reserved memory grows
# by more than their bytes.
WORKSPACE_BYTES = 4 * 2**30

# Held by every capture and every eviction, so that no graph is freed while
# any thread captures (the allocator skips a dead graph's pool then).
_LOCK = threading.RLock()

# Per thread: `workspaces`, key -> Workspace, least recently used first;
# `streams`, the side stream a device; `graphs`, its live graphs a device,
# whose one memory pool takes the thread's next capture.
_THREAD = threading.local()


def _thread_state():
    if not hasattr(_THREAD, "workspaces"):
        _THREAD.workspaces = collections.OrderedDict()
        _THREAD.streams, _THREAD.graphs = {}, {}
    return _THREAD


def _device(device) -> torch.device:
    """`device` with its index ("cuda" is the current card)."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _live_graphs(device) -> "weakref.WeakSet":
    """The calling thread's graphs on `device` that are still alive."""
    return _thread_state().graphs.setdefault(_device(device), weakref.WeakSet())


def use_graph(graph: Optional[bool], device, params: dict) -> bool:
    """Whether a decode loop replays its step as a CUDA graph.

    By default (None) on a CUDA device, unless the decoder tree is
    tensor-parallel: its all_reduces over gloo stage through host memory,
    which a graph cannot hold, and NCCL's have not been captured. False
    runs the eager step; True where no graph can run raises ValueError."""
    possible = torch.device(device).type == "cuda" and "tp" not in params
    if graph is None:
        return possible
    if graph and not possible:
        raise ValueError("a decode step is graphed only on a CUDA device and an "
                         "unsharded decoder")
    return bool(graph)


def run_steps(replay: Optional[Callable[[], None]], finished: Callable[[], bool],
              max_steps: int, *, before: Optional[Callable[[int], Optional[Callable]]] = None
              ) -> int:
    """The host side of every decode loop -> the steps taken. Up to
    `max_steps` iterations, each a `decode.step` span: `before(step)` (the
    host's work between replays: the allocator, a compression, the choice
    of the step's form; it opens a `decode.alloc` span where the allocator
    runs, and may return the step to run instead of `replay`), then the
    step (`decode.replay`: a graph's replay or the eager step), then
    `finished()` (`decode.readback`: the host blocked on the loop's flag),
    which ends the loop when true. The end of a call's first readback is
    its first token's mark."""
    step = 0
    while step < max_steps:
        with span("decode.step"):
            fn = before(step) if before is not None else None
            with span("decode.replay"):
                (fn or replay)()
            step += 1
            with span("decode.readback"):
                stop = finished()
        if stop:
            break
    return step


def cache_tensors(cache) -> tuple:
    """Every field of a KV cache dataclass (pools, scales, table, lengths):
    the cache tensors a decode step must keep at their addresses."""
    return tuple(getattr(cache, f.name) for f in dataclasses.fields(cache))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def tree_key(params) -> tuple:
    """What a captured step reads of a decoder tree: each tensor leaf's path,
    address, shape, stride, dtype and device; other leaves by value, or by
    identity (a `ModelGroup`)."""
    out = []
    for path, x in _leaves(params):
        if isinstance(x, torch.Tensor):
            out.append((path, x.data_ptr(), tuple(x.shape), x.stride(), x.dtype, x.device))
        elif x is None or isinstance(x, (bool, int, float, str)):
            out.append((path, x))
        else:
            out.append((path, id(x)))
    return tuple(out)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if dataclasses.is_dataclass(x):
        return sum(_nbytes(t) for t in cache_tensors(x))
    return 0


class Workspace:
    """One decode-loop key's static tensors (`get`) and step graphs (`loop`)."""

    def __init__(self, params, generator, device):
        self.device = _device(device)
        self.generator = generator      # graphs are registered with it: keep it alive
        self._anchors = [weakref.ref(x) for _, x in _leaves(params)
                         if isinstance(x, torch.Tensor)]
        self.tensors: dict = {}
        self.loops: dict = {}

    def alive(self) -> bool:
        """False once a tensor of the decoder tree it was made for is freed."""
        return all(r() is not None for r in self._anchors)

    def nbytes(self) -> int:
        return sum(_nbytes(x) for x in self.tensors.values())

    def get(self, name: str, make: Callable[[], object]):
        """The workspace's `name` (a tensor or a cache dataclass), made on
        first use; a new one may evict other workspaces past the bound."""
        if name not in self.tensors:
            self.tensors[name] = make()
            _evict(keep=self)
        return self.tensors[name]

    def loop(self, name: str, step: Callable[[], None],
             bound: Callable[[], Sequence[torch.Tensor]], *, graphed: bool) -> "StepGraph":
        """The kept `StepGraph` `name` (eager and graphed ones apart), given
        this call's `step`; a new one the first time."""
        sg = self.loops.get((name, graphed))
        if sg is None:
            sg = self.loops[name, graphed] = StepGraph(step, bound, self.device, self.generator,
                                                       graphed=graphed)
        else:
            sg.begin(step)
        return sg


def workspace(key: tuple, params, generator: Optional[torch.Generator], device) -> Workspace:
    """The calling thread's workspace for `key` (the loop's form and its
    static arguments; the caller's part) on this decoder tree, generator
    and device; a new, empty one the first time. Workspaces of freed trees
    are dropped first."""
    state = _thread_state()
    device = _device(device)
    full = (device, tree_key(params), id(generator), key)
    with _LOCK:
        for k in [k for k, ws in state.workspaces.items() if not ws.alive()]:
            del state.workspaces[k]
        ws = state.workspaces.pop(full, None)
        if ws is None:
            ws = Workspace(params, generator, device)
        state.workspaces[full] = ws                    # most recently used last
    return ws


def _evict(keep: Workspace) -> None:
    state = _thread_state()
    with _LOCK:
        total = sum(ws.nbytes() for ws in state.workspaces.values())
        evicted = False
        for k in list(state.workspaces):
            if total <= WORKSPACE_BYTES:
                break
            ws = state.workspaces[k]
            if ws is not keep:
                total -= ws.nbytes()
                del state.workspaces[k]
                evicted = True
        if evicted:
            _return_memory()


def _return_memory() -> None:
    """Give the card the allocator's free blocks, dropped workspaces' among
    them (called under _LOCK: no capture is under way)."""
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def workspaces() -> list:
    """The calling thread's workspaces, least recently used first."""
    return list(_thread_state().workspaces.values())


def release() -> None:
    """Drop the calling thread's workspaces and their graphs, and give the
    card their memory."""
    with _LOCK:
        _thread_state().workspaces.clear()
        _return_memory()


def pool_bytes(device="cuda") -> Optional[dict]:
    """The calling thread's graph pool on `device`: {"reserved", "active"}
    bytes of its segments, from the allocator's snapshot; None where the
    snapshot does not name segments' pools. Outside a capture "active" is
    the bytes of blocks a capture left alive (0 when every step copies its
    outputs into workspace tensors)."""
    graphs = list(_live_graphs(device))
    if not graphs:
        return {"reserved": 0, "active": 0}
    pool = tuple(graphs[0].pool())
    segs = torch.cuda.memory_snapshot()
    if any("segment_pool_id" not in s for s in segs):
        return None
    mine = [s for s in segs if tuple(s["segment_pool_id"]) == pool]
    return {"reserved": sum(s["total_size"] for s in mine),
            "active": sum(s["active_size"] for s in mine)}


class StepGraph:
    """A decode loop's step `step()`: eager on its first call, then captured
    and replayed (`graphed`), or eager every call. Kept in a `Workspace`
    across generate calls: `begin` gives it the next call's step, and
    `record` ends a call."""

    def __init__(self, step: Callable[[], None], bound: Callable[[], Sequence[torch.Tensor]],
                 device, generator: Optional[torch.Generator] = None, *, graphed: bool):
        self.bound = bound
        if graphed and torch.device(device).type != "cuda":
            raise ValueError("a CUDA graph needs a CUDA device")
        self.device = _device(device)
        self.generator, self.graphed = generator, graphed
        self.calls = 0                 # steps taken in every call
        self.tally: dict = {}          # kernel launches of one replay
        self._graph = None
        self._addresses = None
        self.begin(step)

    def begin(self, step: Callable[[], None]) -> None:
        """Start a generate call whose step is `step`."""
        self.step = step
        self._reused, self._captured = self._graph is not None, False
        self._steps = self._replays = 0
        self._capture_s = self._first_step_s = 0.0

    def __call__(self) -> None:
        first = self._steps == 0
        if first and self.graphed:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        if not self.graphed:
            self.step()
        elif self.calls == 0:
            self._on_side_stream(self.step)
        else:
            if self._graph is None:
                self._capture()
            self._graph.replay()
            self._replays += 1
            kernels.add_launches(self.tally)
        if first:
            if self.graphed:
                torch.cuda.synchronize(self.device)
            self._first_step_s = time.perf_counter() - t0 - self._capture_s
        self.calls += 1
        self._steps += 1
        addresses = [t.data_ptr() for t in self.bound()]
        if self._addresses is None:
            self._addresses = addresses
        elif addresses != self._addresses:
            raise RuntimeError("the decode step moved one of its static tensors: a replay "
                               "would read the old buffer")

    def _on_side_stream(self, fn: Callable[[], None]) -> None:
        streams = _thread_state().streams
        if self.device not in streams:
            streams[self.device] = torch.cuda.Stream(self.device)
        side, current = streams[self.device], torch.cuda.current_stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            fn()
        current.wait_stream(side)

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        live = _live_graphs(self.device)

        def capture():
            # The pool of a live graph of this thread, or a new one: a pool
            # whose graphs have all died is being freed and takes no capture.
            pool = next((g.pool() for g in live), None)
            with kernels.recording() as tally:
                graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    self.step()
                except Exception as err:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass                       # the capture was already invalid
                    raise RuntimeError(f"capturing the decode step failed: {err}") from err
                graph.capture_end()
            self.tally = tally

        t0 = time.perf_counter()
        with _LOCK:
            self._on_side_stream(capture)
        self._capture_s = time.perf_counter() - t0
        self._graph, self._captured = graph, True
        live.add(graph)

    def record(self, stats: Optional[dict]) -> None:
        """End this generate call: drop its step (and what it holds, the
        decoder tree among it) and add its graph figures to `stats`:
        "graph_captures" (0 or 1), "graph_reuses" (1 when a graph captured
        in an earlier call served it), "capture_s", "graph_replays",
        "replayed_launches" (kernel launches the replays made) and
        "first_step_s" (host seconds of its first step, device synchronized
        on both sides); nothing for an eager loop."""
        self.step = None
        if stats is None or not self.graphed:
            return
        for k, v in (("graph_captures", int(self._captured)),
                     ("graph_reuses", int(self._reused and self._steps > 0)),
                     ("capture_s", self._capture_s), ("graph_replays", self._replays),
                     ("replayed_launches", self._replays * sum(self.tally.values())),
                     ("first_step_s", self._first_step_s)):
            stats[k] = stats.get(k, 0) + v
