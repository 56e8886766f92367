"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for (no card: exit 2, no result). The run builds the program's kernels
(cached in the checkout), makes the weights and the traffic from the seed,
warms every shape the traffic uses (all of that is `setup_s`), measures for
`--seconds` (whole requests), reads the peak device memory, then frees the
program and judges what the window produced against the plain reference
(portbench/check.py). The last stderr lines give each compared number and
its limit; the last stdout line is the result object. With --trace 1 the
metrics are the cell's per-layer metrics, read from a profiled stretch of
requests before the window and from the window's spans and counters.
`--control 1` (not a benchmark run) also puts the reference in the
configuration's control precision in the program's place and prints its
readings beside the program's.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Top-level module names that must not be loaded in a run: JAX and the
# JAX package (compared whole: the port's name begins with it).
FORBIDDEN = ("jax", "jaxlib", "flax", "streamchat_tpu")
THREADS = 4


def _environment(root: str) -> None:
    """Caches of any compiler the program may start, at fixed paths inside
    the checkout; no library may load JAX or Flax."""
    cache = os.path.join(root, ".portbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Context:
    """What a metric reader reads: the window's requests, the spans and
    generate calls the recorder kept, the trace, the configuration."""

    def __init__(self, cfg, spec, window, rec, setup_s, trace) -> None:
        self.cfg, self.spec, self.window, self.setup_s, self.trace = \
            cfg, spec, window, setup_s, trace
        self.kind = spec["kind"]
        self.bits = int(cfg["serving"]["weight_bits"])
        self.kv_int8 = bool(cfg["serving"].get("kv_int8", False))
        self._calls, self._spans = rec.calls, rec.spans

    def units(self, traced: bool = False):
        return [u for u in self.window.units if u.traced == traced]

    def calls(self, traced: bool = False):
        ids = {u.index for u in self.units(traced)}
        return [c for c in self._calls if c.get("unit") in ids]

    def spans(self, name: str, traced: bool = False):
        ids = {u.index for u in self.units(traced)}
        return [s for s in self._spans if s["name"] == name and s.get("unit") in ids]


def _read_trace(prof):
    from portbench.traceparse import Trace, load_events

    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return Trace(load_events(path))
    finally:
        os.remove(path)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device,
             root: str = ROOT, control: bool = False, config_override: dict | None = None,
             spec_override: dict | None = None) -> dict:
    """One run of a cell -> the result object (without printing it)."""
    import torch

    from portbench import check, drive, manifest, system
    from portbench import traffic as traffic_mod
    from portbench.video import SyntheticVideo

    torch.set_num_threads(THREADS)
    man = manifest.load(root)
    cell = manifest.cell(man, workload)
    cfg = config_override or manifest.config(man, cell["config"], root)
    spec = spec_override or manifest.traffic(cell["traffic"], root)
    dev = torch.device(device)
    if dev.type == "cuda":
        from streamchat_tpu_torch.kernels import build

        build.build()
    plan = traffic_mod.make_plan(spec, seed)
    video = SyntheticVideo(spec["video"], seed)
    kind = manifest.kind_module(spec["kind"], root)
    pipe = system.build(cfg, spec, seed, dev)
    rec = drive.Recorder(pipe)
    driver = kind.Driver(pipe, plan, video, rec)
    driver.open()
    try:
        driver.warm()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - T_START
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        window = driver.window(seconds, int(spec.get("trace_units", 2)) if trace else 0)
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        inputs = check.gather(driver, window, spec, seed)
    finally:
        driver.close()
        rec.close()
    captures = sum(c["captures"] for c in rec.calls
                   if c.get("unit") in {u.index for u in window.units})
    del driver, pipe
    check.release_program()
    tr = _read_trace(window.profile) if window.profile is not None else None
    window.profile = None
    numbers = check.judge(cfg, seed, video, inputs, dev, control=control)
    correct = check.verdict(numbers, kind.NUMBERS)
    ctx = Context(cfg, spec, window, rec, setup_s, tr)
    metrics = {}
    for m in manifest.metrics_of(man, workload, trace):
        value = manifest.metric_module(m["name"], root).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": len(window.units), "failed": 0,
           "metrics": metrics, "device": dev_info}
    if tr is not None:
        dev_info["busy_s"] = tr.busy_s
        dev_info["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}
    out["graph_captures_in_window"] = captures
    out["unit_s"] = [u.t1 - u.t0 for u in window.units]
    out["window_start_unix"] = time.time() - (time.perf_counter() - window.t0)
    out["checks"] = numbers
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment(ROOT)
    import torch

    from portbench import manifest

    need = manifest.cell(manifest.load(ROOT), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), control=bool(args.control))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded in this process: {bad}", file=sys.stderr)
        return 3
    for name, rec in out["checks"].items():
        extra = f" control {rec['control']!r}" if "control" in rec else ""
        print(f"check {name} {rec['value']!r} limit {rec['limit']!r}{extra}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
