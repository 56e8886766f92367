"""Reading a torch.profiler Chrome trace: a frozen copy of the program's
`utils/traceparse.py` arithmetic (Kineto's device categories, the union of
busy intervals over every stream), with what the benchmark adds: a traced
window bounded by the benchmark's own spans, device seconds by kernel
name, the top device ops, and the idle gaps named by what the host was
doing.
"""

from __future__ import annotations

import json
import re
from collections import defaultdict
from typing import Dict, List, Tuple

# Kineto's categories of device activity.
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
# Host events that can say what the host did during a gap.
HOST_CATS = frozenset({"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"})
SPAN_PREFIX = "portbench."


def load_events(path: str) -> List[dict]:
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    return doc.get("traceEvents", doc if isinstance(doc, list) else [])


def _span(e: dict) -> Tuple[float, float]:
    ts = float(e.get("ts", 0.0))
    return ts, ts + float(e.get("dur", 0.0))


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        elif e > s:
            out.append((s, e))
    return out


class Trace:
    """The device and host events of a trace inside the benchmark's traced
    window (from the first to the last end of a `portbench.` span)."""

    def __init__(self, events: List[dict]) -> None:
        spans = [(e, _span(e)) for e in events
                 if e.get("ph") == "X" and str(e.get("name", "")).startswith(SPAN_PREFIX)
                 and e.get("cat") != "gpu_user_annotation"]
        if not spans:
            raise ValueError("no benchmark spans in the trace")
        self.t0 = min(s for _, (s, _) in spans)
        self.t1 = max(e for _, (_, e) in spans)
        self.spans = [(str(ev["name"])[len(SPAN_PREFIX):], s, e) for ev, (s, e) in spans]
        self.device = [(str(e.get("name", "")), *_span(e)) for e in events
                       if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
                       and self.t0 <= _span(e)[0] < self.t1]
        self.host = [(str(e.get("name", "")), *_span(e)) for e in events
                     if e.get("ph") == "X" and e.get("cat") in HOST_CATS
                     and not str(e.get("name", "")).startswith(SPAN_PREFIX)
                     and _span(e)[1] > self.t0 and _span(e)[0] < self.t1]
        self.busy = _union([(s, min(e, self.t1)) for _, s, e in self.device])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e6

    def kernel_seconds(self, pattern: str) -> Tuple[float, int]:
        """Summed device seconds and count of the events whose name matches
        `pattern` (a regular expression)."""
        rx = re.compile(pattern)
        hits = [e - s for name, s, e in self.device if rx.search(name)]
        return sum(hits) / 1e6, len(hits)

    def top_ops(self, n: int = 10) -> List[list]:
        tot: Dict[str, float] = defaultdict(float)
        for name, s, e in self.device:
            tot[name] += (e - s) / 1e6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10, short_us: float = 20.0) -> List[list]:
        """Idle device time between busy intervals, summed by what the host
        was doing at each gap's middle (the innermost benchmark span and the
        innermost host event); gaps under `short_us` are summed as one
        entry. The n largest sums."""
        edges = [(self.t0, self.t0)] + self.busy + [(self.t1, self.t1)]
        gaps = [(a, b) for (_, a), (b, _) in zip(edges, edges[1:]) if b > a]
        tot: Dict[str, float] = defaultdict(float)
        host = sorted(self.host, key=lambda h: h[1])
        active: List[Tuple[str, float, float]] = []
        k = 0
        for a, b in gaps:
            if b - a < short_us:
                tot[f"gaps under {short_us:g} us"] += (b - a) / 1e6
                continue
            t = 0.5 * (a + b)
            while k < len(host) and host[k][1] <= t:
                active.append(host[k])
                k += 1
            active = [h for h in active if h[2] > t]
            inner = min(active, key=lambda h: h[2] - h[1])[0] if active else "no host event"
            spans = [sp for sp in self.spans if sp[1] <= t < sp[2]]
            span = min(spans, key=lambda sp: sp[2] - sp[1])[0] if spans else "outside spans"
            tot[f"{span} / {inner}"] += (b - a) / 1e6
        return [[k_, v] for k_, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]
