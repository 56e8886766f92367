"""BENCHMARK.json and the files it names: every cell, configuration, traffic
mix and metric is found by its name, so a later change adds one with new
files and entries and edits none.

  configuration  the file its `configs` entry names
  traffic mix    portbench/traffic/<name>.json
  traffic kind   portbench/kinds/<kind>.py (a mix's `kind`), a module with
                 a `Driver` and the `NUMBERS` its check compares
  metric         portbench/metrics/<name>.py, a module with
                 `read(ctx) -> float | None` (None: nothing to read here)
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from types import ModuleType
from typing import List

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)


def cell(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(man: dict, name: str, root: str) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"]), encoding="utf-8") as f:
                return json.load(f)
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def traffic(name: str, root: str) -> dict:
    with open(os.path.join(root, "portbench", "traffic", name + ".json"), encoding="utf-8") as f:
        return json.load(f)


def _module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_module(name: str, root: str) -> ModuleType:
    return _module(os.path.join(root, "portbench", "metrics", name + ".py"),
                   "portbench_metric_" + re.sub(r"\W", "_", name))


def kind_module(kind: str, root: str) -> ModuleType:
    return _module(os.path.join(root, "portbench", "kinds", kind + ".py"),
                   "portbench_kind_" + re.sub(r"\W", "_", kind))


def metrics_of(man: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a run of `workload` reports: its end-to-end metrics
    untraced, its per-layer metrics traced (a per-layer metric without a
    `workloads` list goes with every cell that reports what it moves)."""
    e2e = [m for m in man["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if workload in m["workloads"] or ("workloads" not in m and m["moves"] in moved)]


def problems(man: dict) -> List[str]:
    """Names and units that break the manifest's rules."""
    out = []
    names = ([c["name"] for c in man["configs"]] + [w["name"] for w in man["workloads"]]
             + [m["name"] for m in man["end_to_end"] + man["per_layer"]]
             + [w["config"] for w in man["workloads"]] + [w["traffic"] for w in man["workloads"]]
             + [k for c in man["configs"] for k in c["reduced"]])
    out += [f"name {n!r}" for n in names if not NAME.match(n)]
    out += [f"unit {m['unit']!r}" for m in man["end_to_end"] + man["per_layer"]
            if not UNIT.match(m["unit"])]
    for group in ("configs", "workloads"):
        seen = [x["name"] for x in man[group]]
        out += [f"duplicate {group} name {n!r}" for n in set(seen) if seen.count(n) > 1]
    seen = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    out += [f"duplicate metric name {n!r}" for n in set(seen) if seen.count(n) > 1]
    return out
