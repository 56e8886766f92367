"""The port's trace parser (`streamchat_tpu_torch/utils/traceparse.py`) and
phase annotations (`utils/profiling.py`) on the CPU.

Held:
- on a synthetic trace in the JAX trace-viewer layout (no categories, a
  device pid named by its process_name, an op lane and a mirrored module
  lane), the five functions return what the JAX package's return;
- on a synthetic torch.profiler (Kineto) trace, hand-computed values: the
  `gpu_user_annotation` mirror of a phase on the GPU lane is not busy time,
  kernels on two streams both count (their overlap once), a copy counts,
  and nested phases (caption inside memory_update) each get their windows;
- a real torch.profiler CPU capture (`maybe_device_trace`) around
  `PhaseTimer` finds every phase, its wall_s within 5 ms of
  the timer's, the timer's synchronize inside the window, and no device
  events.
"""

import gzip
import json
import time

import pytest
import torch

from streamchat_tpu.utils import traceparse as jtraceparse
from streamchat_tpu_torch.utils import traceparse
from streamchat_tpu_torch.utils.profiling import TRACE_DIR_ENV, PhaseTimer, maybe_device_trace

FUNCTIONS = ("find_trace_file", "load_trace_events", "device_seconds_by_phase",
             "device_op_table", "host_events_in_phase")


def _x(name, pid, tid, ts, dur, **extra):
    return dict(name=name, ph="X", pid=pid, tid=tid, ts=ts, dur=dur, **extra)


def _meta(pid, name):
    return dict(name="process_name", ph="M", pid=pid, tid=0, args=dict(name=name))


def _jax_layout_events():
    """Host pid 1, TPU pid 2 with an op lane (tid 1) and a module lane
    (tid 2) that mirrors whole programs over the ops; times in us."""
    ev = [_meta(1, "/host:CPU"), _meta(2, "/device:TPU:0"),
          _x("phase=ingest", 1, 1, 0, 40_000), _x("phase=memory_update", 1, 1, 50_000, 100_000),
          _x("phase=caption", 1, 1, 60_000, 50_000), _x("phase=answer", 1, 1, 160_000, 30_000),
          _x("phase=caption", 1, 1, 120_000, 20_000),
          _x("dispatch", 1, 3, 1_000, 2_000), _x("dispatch", 1, 3, 61_000, 1_500),
          _x("compile", 1, 3, 70_000, 8_000), _x("dispatch", 1, 3, 165_000, 900)]
    for i, (ts, dur) in enumerate([(2_000, 10_000), (15_000, 5_000), (62_000, 9_000),
                                   (80_000, 20_000), (125_000, 4_000), (162_000, 12_000),
                                   (175_000, 3_000), (195_000, 1_000)]):
        ev.append(_x(f"fusion.{i % 3}", 2, 1, ts, dur))
    ev += [_x("jit_program", 2, 2, 1_500, 19_000), _x("jit_program", 2, 2, 61_500, 40_000),
           _x("jit_program", 2, 2, 161_000, 17_000)]
    return ev


def _write(path, events, gz):
    path.parent.mkdir(parents=True, exist_ok=True)
    doc = json.dumps({"traceEvents": events})
    if gz:
        with gzip.open(path, "wt", encoding="utf-8") as f:
            f.write(doc)
    else:
        path.write_text(doc)


@pytest.mark.parametrize("gz", [True, False], ids=["json.gz", "json"])
def test_jax_layout_matches_the_jax_parser(tmp_path, gz):
    name = "host.trace.json.gz" if gz else "host.trace.json"
    _write(tmp_path / "plugins" / "profile" / "run" / name, _jax_layout_events(), gz)
    d = str(tmp_path)
    for fn in FUNCTIONS:
        port, jax_fn = getattr(traceparse, fn), getattr(jtraceparse, fn)
        if fn == "load_trace_events":
            args = (traceparse.find_trace_file(d),)
        elif fn == "host_events_in_phase":
            for phase in ("ingest", "memory_update", "caption", "answer", "absent"):
                assert port(d, phase) == jax_fn(d, phase), phase
            continue
        else:
            args = (d,)
        assert port(*args) == jax_fn(*args), fn
    assert traceparse.device_seconds_by_phase(d)["memory_update"]["device_events"] > 0


def _kineto_events():
    """A torch.profiler trace: CPU pid 4242, GPU pid 0 with streams 7 and
    20; times in us. Hand-computed busy time below."""
    ev = [_meta(4242, "python3 4242"), _meta(0, "GPU 0"),
          dict(name="thread_name", ph="M", pid=0, tid=7, args=dict(name="stream 7")),
          dict(name="thread_name", ph="M", pid=0, tid=20, args=dict(name="stream 20"))]
    for name, ts, dur in (("phase=memory_update", 0, 1_000_000),
                          ("phase=caption", 100_000, 500_000),
                          ("phase=answer", 1_200_000, 600_000)):
        ev.append(_x(name, 4242, 4242, ts, dur, cat="user_annotation"))
        # Kineto's mirror of the annotation on the GPU lane: spans the window.
        ev.append(_x(name, 0, 7, ts, dur, cat="gpu_user_annotation"))
    ev += [_x("cudaLaunchKernel", 4242, 4242, 140_000, 10_000, cat="cuda_runtime"),
           _x("cudaLaunchKernel", 4242, 4242, 190_000, 10_000, cat="cuda_runtime"),
           _x("aten::mm", 4242, 4242, 130_000, 80_000, cat="cpu_op"),
           _x("sc_gemm_kernel", 0, 7, 150_000, 100_000, cat="kernel"),
           _x("sc_flash_prefill_kernel", 0, 20, 200_000, 100_000, cat="kernel"),
           _x("Memcpy DtoH (Device -> Pinned)", 0, 7, 400_000, 50_000, cat="gpu_memcpy"),
           _x("sc_gemm_kernel", 0, 20, 700_000, 100_000, cat="kernel"),
           _x("Memset (Device)", 0, 7, 1_300_000, 20_000, cat="gpu_memset"),
           _x("sc_paged_decode_kernel", 0, 20, 1_400_000, 100_000, cat="kernel")]
    return ev


def test_kineto_trace_hand_computed(tmp_path):
    """caption [100, 600] ms: the two streams' kernels [150, 250] and [200,
    300] are busy 150 ms (two disjoint pieces, the overlap once), the copy
    adds 50; memory_update [0, 1000] adds the kernel at 700; answer: a
    memset and a kernel. Were the GPU-lane annotation mirrors busy time,
    each phase would read all of its wall."""
    _write(tmp_path / "host_4242.1.pt.trace.json", _kineto_events(), gz=False)
    d = str(tmp_path)
    assert traceparse.device_seconds_by_phase(d) == {
        "memory_update": {"wall_s": 1.0, "device_s": 0.3, "host_gap_s": 0.7,
                          "device_events": 4},
        "caption": {"wall_s": 0.5, "device_s": 0.2, "host_gap_s": 0.3, "device_events": 3},
        "answer": {"wall_s": 0.6, "device_s": 0.12, "host_gap_s": 0.48, "device_events": 2}}
    assert traceparse.device_op_table(d) == [
        {"name": "sc_gemm_kernel", "total_s": 0.2, "count": 2},
        {"name": "sc_flash_prefill_kernel", "total_s": 0.1, "count": 1},
        {"name": "sc_paged_decode_kernel", "total_s": 0.1, "count": 1},
        {"name": "Memcpy DtoH (Device -> Pinned)", "total_s": 0.05, "count": 1},
        {"name": "Memset (Device)", "total_s": 0.02, "count": 1}]
    assert traceparse.host_events_in_phase(d, "caption") == [
        {"name": "aten::mm", "total_s": 0.08, "count": 1},
        {"name": "cudaLaunchKernel", "total_s": 0.02, "count": 2}]


def test_cpu_capture_around_annotated_phases(tmp_path, monkeypatch):
    """torch.profiler on the CPU: every phase's window is in the trace, its
    wall within 5 ms of the timer's total (the synchronize, 20 ms here,
    inside it), and no device events."""
    monkeypatch.setenv(TRACE_DIR_ENV, str(tmp_path / "trace"))
    timer = PhaseTimer(synchronize=lambda: time.sleep(0.02))
    x = torch.randn(64, 64)
    with maybe_device_trace():
        with timer.phase("ingest"):
            for _ in range(3):
                x = torch.tanh(x @ x)
        with timer.phase("memory_update"):
            with timer.phase("caption"):
                time.sleep(0.01)
        with timer.phase("answer"):
            time.sleep(0.03)
    path = traceparse.find_trace_file(str(tmp_path / "trace"))
    assert path.endswith(".pt.trace.json")
    phases = traceparse.device_seconds_by_phase(str(tmp_path / "trace"))
    assert set(phases) == {"ingest", "memory_update", "caption", "answer"}
    for name, rec in phases.items():
        assert abs(rec["wall_s"] - timer.totals[name]) < 5e-3, (name, rec, timer.totals[name])
        assert rec["wall_s"] >= 0.02
        assert rec["device_events"] == 0 and rec["device_s"] == 0.0
    # wall_s is rounded to whole ms: compare whole ms, where rounding keeps
    # the order (0.035 + 0.02 exceeds 0.055 in floating point).
    assert (round(phases["memory_update"]["wall_s"] * 1e3)
            >= round(phases["caption"]["wall_s"] * 1e3) + 20)
    assert traceparse.device_op_table(str(tmp_path / "trace")) == []
    ops = {r["name"] for r in traceparse.host_events_in_phase(str(tmp_path / "trace"), "ingest")}
    assert {"aten::mm", "aten::tanh"} <= ops


def test_no_trace_without_the_variable(tmp_path, monkeypatch):
    monkeypatch.delenv(TRACE_DIR_ENV, raising=False)
    monkeypatch.chdir(tmp_path)
    with maybe_device_trace():
        torch.ones(2).sum()
    assert list(tmp_path.iterdir()) == []
    with pytest.raises(FileNotFoundError):
        traceparse.find_trace_file(str(tmp_path))
