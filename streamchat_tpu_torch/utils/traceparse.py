"""Per-phase device seconds from a trace (`streamchat_tpu/utils/traceparse.py`).

A trace (`utils.profiling.maybe_device_trace` writes torch.profiler's
Chrome trace, `*.pt.trace.json` or `.json.gz`) turns into measured numbers:

  - device busy seconds per pipeline phase (phases are host-side
    `record_function` windows named ``phase=<name>``, emitted by
    `utils.profiling.PhaseTimer`, every window), and
  - the host gap (wall - device busy) per phase.

Host and device events share one microsecond timeline, so a device event
is attributed to the phase window(s) its midpoint falls in. Phase nesting
mirrors the wall-clock semantics ("caption" is a subset of
"memory_update").

Which events are device time. torch.profiler (Kineto) tags every event
with a category; device activity is `kernel`, `gpu_memcpy` and
`gpu_memset`, on any stream. Kineto also mirrors each `record_function`
onto the GPU's lanes as `gpu_user_annotation`, which spans the whole window
and is not busy time. The JAX package's trace-viewer layout has no
categories: there every complete event on a pid whose `process_name`
names a device counts, as in the JAX parser, which this module equals on
such a trace.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
from typing import Dict, List, Tuple

# Kineto's categories of device activity.
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})


def find_trace_file(trace_dir: str) -> str:
    """The newest Chrome trace under `trace_dir`."""
    hits: List[str] = []
    for pat in ("*.trace.json.gz", "*.trace.json"):
        hits += glob.glob(os.path.join(trace_dir, "**", pat), recursive=True)
    if not hits:
        raise FileNotFoundError(f"no *.trace.json(.gz) under {trace_dir}")
    return max(hits, key=os.path.getmtime)


def load_trace_events(path: str) -> List[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as f:
        doc = json.load(f)
    return doc.get("traceEvents", doc if isinstance(doc, list) else [])


def _device_pids(events) -> set:
    """pids whose process_name metadata names a device (TPU/GPU) lane."""
    pids = set()
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            low = str((e.get("args") or {}).get("name", "")).lower()
            if "tpu" in low or "gpu" in low or "/device:" in low:
                pids.add(e.get("pid"))
    return pids


def _is_device(e: dict, dev_pids: set) -> bool:
    """A complete event of device activity: a Kineto device category, or,
    in the category-free trace-viewer layout, any event on a device pid."""
    if e.get("ph") != "X":
        return False
    if "cat" in e:
        return e["cat"] in DEVICE_CATS
    return e.get("pid") in dev_pids


def _span(e: dict) -> Tuple[float, float]:
    ts = float(e.get("ts", 0.0))
    return ts, ts + float(e.get("dur", 0.0))


def _phase_windows(events, prefix: str) -> Dict[str, List[Tuple[float, float]]]:
    """Host windows by phase name; Kineto's GPU-lane mirrors of the same
    annotations (`gpu_user_annotation`) are not windows."""
    wins: Dict[str, List[Tuple[float, float]]] = {}
    for e in events:
        if (e.get("ph") == "X" and str(e.get("name", "")).startswith(prefix)
                and e.get("cat") != "gpu_user_annotation"):
            wins.setdefault(e["name"][len(prefix):], []).append(_span(e))
    return wins


def _busy_intervals(events, dev_pids) -> List[Tuple[float, float]]:
    """The union of each device pid's device events over all its lanes
    (streams), as disjoint intervals: busy time, not summed event time."""
    lanes: Dict[object, List[Tuple[float, float]]] = {}
    for e in events:
        if _is_device(e, dev_pids):
            lanes.setdefault(e.get("pid"), []).append(_span(e))
    outer: List[Tuple[float, float]] = []
    for evs in lanes.values():
        evs.sort()
        last_end = -1.0
        for ts, end in evs:
            start = max(ts, last_end)
            if end > start:
                outer.append((start, end))
                last_end = end
    return outer


def device_seconds_by_phase(trace_dir: str, prefix: str = "phase=") -> Dict[str, dict]:
    """-> {phase: {"wall_s", "device_s", "host_gap_s", "device_events"}}.

    device_s sums the busy intervals (`_busy_intervals`) whose midpoints
    fall inside the phase's windows; device_events counts those intervals
    (0 for a phase that launched kernels means the trace lost them)."""
    events = load_trace_events(find_trace_file(trace_dir))
    outer = _busy_intervals(events, _device_pids(events))
    out: Dict[str, dict] = {}
    for phase, wins in _phase_windows(events, prefix).items():
        wall = sum(e - s for s, e in wins)
        dev = 0.0
        ndev = 0
        for ts, end in outer:
            mid = 0.5 * (ts + end)
            if any(s <= mid < e for s, e in wins):
                dev += end - ts
                ndev += 1
        out[phase] = {
            "wall_s": round(wall / 1e6, 3),
            "device_s": round(dev / 1e6, 3),
            "host_gap_s": round(max(0.0, wall - dev) / 1e6, 3),
            "device_events": ndev,
        }
    return out


def device_op_table(trace_dir: str, top: int = 25) -> List[dict]:
    """Top device ops by summed duration: [{"name", "total_s", "count"}],
    sorted by total_s descending. A Kineto device pid gives every stream's
    device events; a trace-viewer device pid only its lane (tid) with the
    most events, the per-op lane (its module lanes mirror one
    whole-program event a launch)."""
    events = load_trace_events(find_trace_file(trace_dir))
    dev_pids = _device_pids(events)
    by_lane: Dict[Tuple, List[dict]] = {}
    for e in events:
        if _is_device(e, dev_pids):
            by_lane.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    by_pid: Dict[object, List[List[dict]]] = {}
    for (pid, _), evs in by_lane.items():
        by_pid.setdefault(pid, []).append(evs)
    agg: Dict[str, List[float]] = {}
    for lanes in by_pid.values():
        if any("cat" in evs[0] for evs in lanes):
            chosen = [e for evs in lanes for e in evs]
        else:
            chosen = max(lanes, key=len)
        for e in chosen:
            rec = agg.setdefault(str(e.get("name", "")), [0.0, 0])
            rec[0] += float(e.get("dur", 0.0))
            rec[1] += 1
    rows = [{"name": n, "total_s": round(t / 1e6, 5), "count": c}
            for n, (t, c) in agg.items()]
    rows.sort(key=lambda r: -r["total_s"])
    return rows[:top]


def host_events_in_phase(trace_dir: str, phase: str, top: int = 20,
                         prefix: str = "phase=") -> List[dict]:
    """Top host events (by summed duration) inside a phase's windows:
    complete events that are neither device activity nor its annotation
    mirrors, on no device pid, whose midpoints fall inside the windows, the
    windows themselves excluded -> [{"name", "total_s", "count"}] sorted by
    total_s descending."""
    events = load_trace_events(find_trace_file(trace_dir))
    dev_pids = _device_pids(events)
    wins = _phase_windows(events, prefix).get(phase, [])
    agg: Dict[str, List[float]] = {}
    for e in events:
        if (e.get("ph") != "X" or e.get("pid") in dev_pids or _is_device(e, dev_pids)
                or e.get("cat") == "gpu_user_annotation"):
            continue
        name = str(e.get("name", ""))
        if name.startswith(prefix):
            continue
        ts, end = _span(e)
        mid = 0.5 * (ts + end)
        if any(s <= mid < w for s, w in wins):
            rec = agg.setdefault(name, [0.0, 0])
            rec[0] += end - ts
            rec[1] += 1
    rows = [{"name": n, "total_s": round(t / 1e6, 4), "count": c}
            for n, (t, c) in agg.items()]
    rows.sort(key=lambda r: -r["total_s"])
    return rows[:top]
