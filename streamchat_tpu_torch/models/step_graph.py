"""One decode step as one device program: the counterpart of the JAX
package's `lax.while_loop` decode loops (`streamchat_tpu/models/generate.py`
`generate`, `generate_paged.py`'s fused sample -> alloc -> attend loop,
`spec_decode.py`'s verify loop), each of which XLA compiles into one
program the host starts once.

A loop hands `StepGraph` its body as a function of no argument: it reads
and writes only tensors that keep their addresses for the whole loop (the
logits it samples from, the output tokens, a device step counter, the done
flags, the cache's length, table and pools; `bound()` lists them), updates
each in place, and reads nothing back to the host. The host keeps the
loop's control: it calls the `StepGraph` once a step and reads what it
needs between calls (the done flags, the allocator's overflow flag, a
verify step's continue flag), as the JAX loop's `cond` reads them.

On a CUDA device:
* call 1 runs the step eagerly, on a side stream: the warm-up, which makes
  every one-time host call of the path outside capture (the kernels'
  `cudaFuncSetAttribute`, the TMA encoder lookup, loading the kernel
  library, cuBLAS's workspace for that stream);
* call 2 captures the step with `torch.cuda.CUDAGraph` on that stream, the
  caller's generator registered with the graph (each replay then draws
  from the generator what an eager step would, and advances it as far),
  and replays it once, since capture records the work without running it;
* every later call replays the graph.

Capture runs in "thread_local" mode: the on-line session's other host
thread may go on launching on the card meanwhile. A capture that fails
raises; no call falls back to the eager step. The kernel wrappers'
`launched` calls made while capturing are tallied (`kernels.recording`),
and each replay counts the tally again, so the launch counters stay the
launches the card made. A graph is captured per generate call: the pools
and caches it points at are allocated per call.

A thread's warm-ups and captures share one side stream and one memory
pool a device. The caching allocator reuses a free block only for the
stream it was allocated on, and frees a dead graph's pool only outside
any capture (its release is skipped while a capture is under way), so a
stream or a pool per call would leave each call's step memory behind
until an out-of-memory error inside a capture. Instead each capture goes
into the pool of the thread's previous graph, kept alive, and never
replayed again, until the next capture replaces it: the pool holds what
the largest step needs, reused call after call. Two loops of one thread
never interleave their replays, and another thread (the on-line session's
worker) has a stream and a pool of its own.

On the CPU, and on the card where the caller asks for it (`graph=False`,
which only the card's graphed-against-eager equality check passes), every
call runs the same step eagerly, so the CPU tests hold the graphed loops'
arithmetic. After every call the tensors of `bound()` must sit where they
sat after the first: a step that rebound one (`cache.length = ...`)
would leave a replay on the old buffer, so the loop raises instead.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional, Sequence

import torch

from streamchat_tpu_torch import kernels


# Per thread: `streams`, the side stream a device; `graphs`, the last graph
# captured on a device, whose memory pool takes the thread's next capture.
_THREAD = threading.local()


def _thread_state():
    if not hasattr(_THREAD, "graphs"):
        _THREAD.graphs, _THREAD.streams = {}, {}
    return _THREAD


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


def cache_tensors(cache) -> tuple:
    """Every field of a KV cache dataclass (pools, scales, table, lengths):
    the cache tensors a decode step must keep at their addresses."""
    return tuple(getattr(cache, f.name) for f in dataclasses.fields(cache))


class StepGraph:
    """The decode step `step()` of one generate call: eager on the first
    call, then captured and replayed (`graphed`), or eager every call."""

    def __init__(self, step: Callable[[], None], bound: Callable[[], Sequence[torch.Tensor]],
                 device, generator: Optional[torch.Generator] = None, *, graphed: bool):
        self.step, self.bound = step, bound
        self.device = torch.device(device)
        if graphed and self.device.type != "cuda":
            raise ValueError("a CUDA graph needs a CUDA device")
        self.generator, self.graphed = generator, graphed
        self.calls = 0
        self.capture_s = 0.0           # host seconds of the capture alone
        self.tally: dict = {}          # kernel launches of one replay
        self._graph = None
        self._addresses = None

    def __call__(self) -> None:
        if not self.graphed:
            self.step()
        elif self.calls == 0:
            self._on_side_stream(self.step)
        else:
            if self._graph is None:
                self._capture()
            self._graph.replay()
            kernels.add_launches(self.tally)
        self.calls += 1
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
        last = _thread_state().graphs
        pool = last[self.device].pool() if self.device in last else None

        def capture():
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
        self._on_side_stream(capture)
        self.capture_s = time.perf_counter() - t0
        self._graph = last[self.device] = graph

    def record(self, stats: Optional[dict]) -> None:
        """Add this loop's graph figures to a generate call's `stats`:
        "graph_captures", "capture_s", "graph_replays" and
        "replayed_launches" (kernel launches the replays made); nothing
        for an eager loop."""
        if stats is None or not self.graphed:
            return
        replays = max(self.calls - 1, 0)
        for k, v in (("graph_captures", int(self._graph is not None)),
                     ("capture_s", self.capture_s), ("graph_replays", replays),
                     ("replayed_launches", replays * sum(self.tally.values()))):
            stats[k] = stats.get(k, 0) + v
