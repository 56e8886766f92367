"""The per-layer metrics that read the program's spans
(`streamchat_tpu_torch/utils/profiling.py`): each reader on a synthetic
Context and recorder, one read of the ring over the window, nothing read
from a program without the recorder or from a ring that dropped spans of
the window, and a tiny CPU run of each kind that reports them."""

import types

import pytest

from portbench import manifest
from portbench.drive import Unit, Window
from portbench.tests.conftest import ROOT

MS = 1_000_000
READERS = ["step_launch_ms.qa", "step_launch_ms.stream", "step_wait_ms.qa", "step_wait_ms.stream",
           "decode_step_p99_ms.qa", "decode_step_p99_ms.stream", "first_token_ms.qa",
           "ingest_host_ms.stream", "memory_self_ms.stream"]


def _read(name, ctx):
    return manifest.metric_module(name, ROOT).read(ctx)


class _Ctx:
    def __init__(self, units, trace=None):
        self.window = Window(units=units, t0=units[0].t0, t1=units[-1].t1)
        self.trace = trace

    def units(self, traced=False):
        return [u for u in self.window.units if u.traced == traced]


def _span(sid, name, start_ms, dur_ms, parent=0, **tags):
    return types.SimpleNamespace(id=sid, name=name, start_ns=int(start_ms * MS),
                                 end_ns=int((start_ms + dur_ms) * MS), parent=parent, tags=tags)


@pytest.fixture
def recorder(monkeypatch):
    """Put `spans` into the program's recorder: its reader then returns those
    that start in an interval; `intact` says whether the ring dropped any."""
    from streamchat_tpu_torch.utils import profiling

    state = {"spans": [], "intact": True}

    def spans(t0_ns=None, t1_ns=None):
        return sorted((s for s in state["spans"] if t0_ns <= s.start_ns < t1_ns),
                      key=lambda s: s.start_ns)

    monkeypatch.setattr(profiling, "spans", spans)
    monkeypatch.setattr(profiling, "intact_since", lambda t0_ns: state["intact"])
    return state


def _units(kind, *bounds_ms, frames=0):
    return [Unit(index=i, t0=a / 1e3, t1=b / 1e3, traced=False, kind=kind, frames=frames)
            for i, (a, b) in enumerate(bounds_ms)]


def _steps(first_id, start_ms, n, replay_ms, wait_ms, parent=0):
    """n decode steps from start_ms, each 1 ms of its own then its replay and
    its readback."""
    out, sid, t = [], first_id, start_ms
    for _ in range(n):
        step = _span(sid, "decode.step", t, 1 + replay_ms + wait_ms, parent)
        out += [step, _span(sid + 1, "decode.replay", t + 1, replay_ms, sid),
                _span(sid + 2, "decode.readback", t + 1 + replay_ms, wait_ms, sid)]
        sid, t = sid + 3, t + 1 + replay_ms + wait_ms
    return out


@pytest.mark.parametrize("cell", ["qa", "stream"])
def test_step_launch_and_wait_read_the_mean_per_step(recorder, cell):
    recorder["spans"] = (_steps(1, 10, 3, 2, 5) + _steps(100, 210, 2, 4, 1)
                         + _steps(200, 5000, 4, 50, 50))       # outside the window's units
    ctx = _Ctx(_units("answer", (0, 100), (200, 300)))
    assert _read(f"step_launch_ms.{cell}", ctx) == pytest.approx((3 * 2 + 2 * 4) / 5)
    assert _read(f"step_wait_ms.{cell}", ctx) == pytest.approx((3 * 5 + 2 * 1) / 5)


@pytest.mark.parametrize("cell", ["qa", "stream"])
def test_decode_step_p99_needs_a_thousand_steps(recorder, cell):
    ctx = _Ctx(_units("answer", (0, 10_000_000)))
    recorder["spans"] = [_span(i + 1, "decode.step", 10 * i, i + 1) for i in range(1000)]
    assert _read(f"decode_step_p99_ms.{cell}", ctx) == pytest.approx(990)
    recorder["spans"] = recorder["spans"][:999]
    assert _read(f"decode_step_p99_ms.{cell}", ctx) is None


def test_first_token_reads_each_calls_first_readback(recorder):
    """Call 1's first readback ends at 25 + 1 + 5 + 10 = 41 ms, call 2's at
    115 + 1 + 2 + 3 = 121 ms; a readback under no generate call is not read."""
    recorder["spans"] = ([_span(1, "generate", 10, 80), _span(2, "generate.decode", 20, 70, 1)]
                         + _steps(10, 25, 2, 5, 10, parent=2)
                         + [_span(3, "generate", 110, 80), _span(4, "generate.decode", 112, 70, 3)]
                         + _steps(20, 115, 3, 2, 3, parent=4)
                         + [_span(5, "generate", 210, 80)]           # no step taken
                         + _steps(40, 250, 1, 1, 1))
    ctx = _Ctx(_units("answer", (0, 100), (100, 200), (200, 300)))
    assert _read("first_token_ms.qa", ctx) == pytest.approx((31 + 11) / 2)


def test_ingest_host_reads_read_and_upload_per_segment(recorder):
    recorder["spans"] = [_span(1, "ingest.read", 0, 3), _span(2, "ingest.upload", 3, 2),
                         _span(3, "ingest.encode", 5, 10), _span(4, "ingest.upload", 15, 1),
                         _span(5, "ingest.read", 100, 7)]
    ctx = _Ctx(_units("segment", (0, 100), (100, 200), frames=40))
    assert _read("ingest_host_ms.stream", ctx) == pytest.approx((3 + 2 + 1 + 7) / 2)


def test_memory_self_leaves_out_captions_and_summaries(recorder):
    recorder["spans"] = [
        _span(1, "memory.update", 0, 100), _span(2, "memory.cluster", 1, 9, 1),
        _span(3, "memory.caption", 10, 30, 1), _span(4, "generate", 11, 28, 3),
        _span(5, "memory.tree_add", 40, 50, 1), _span(6, "memory.summarize", 45, 20, 5),
        _span(7, "memory.update", 200, 60), _span(8, "memory.caption", 205, 40, 7),
        _span(9, "memory.caption", 500, 10)]                     # under no update
    ctx = _Ctx(_units("segment", (0, 150), (150, 600), frames=40))
    assert _read("memory_self_ms.stream", ctx) == pytest.approx(((100 - 30 - 20) + (60 - 40)) / 2)


@pytest.mark.parametrize("name", ["step_launch_ms.qa", "step_wait_ms.stream",
                                  "decode_step_p99_ms.qa", "first_token_ms.qa",
                                  "ingest_host_ms.stream", "memory_self_ms.stream"])
def test_nothing_is_read_from_a_dropping_ring_or_a_program_without_spans(recorder, monkeypatch,
                                                                         name):
    recorder["spans"] = (_steps(1, 10, 1000, 1, 1) + [
        _span(5000, "generate", 1, 5), _span(5003, "decode.readback", 2, 1, 5000),
        _span(5001, "ingest.read", 1, 1), _span(5002, "memory.update", 1, 5)])
    ctx = _Ctx(_units("segment", (0, 10_000), frames=40))
    assert _read(name, ctx) is not None
    recorder["intact"] = False
    assert _read(name, ctx) is None
    from streamchat_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    recorder["intact"] = True
    assert _read(name, ctx) is None


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_the_ring_once_over_the_window(recorder, monkeypatch, name):
    """One read from the first unit's start to the last unit's end; a span in
    the gap between two units is left out."""
    from streamchat_tpu_torch.utils import profiling

    recorder["spans"] = _steps(1, 10, 1000, 1, 1) + [
        _span(5000, "generate", 1, 5), _span(5003, "decode.readback", 2, 1, 5000),
        _span(5001, "ingest.read", 1, 1), _span(5002, "memory.update", 1, 5)]
    ctx = _Ctx(_units("segment", (0, 10_000), (20_000, 20_100), frames=40))
    whole = _read(name, ctx)
    calls = []
    inner = profiling.spans

    def counted(t0_ns=None, t1_ns=None):
        calls.append((t0_ns, t1_ns))
        return inner(t0_ns, t1_ns)

    monkeypatch.setattr(profiling, "spans", counted)
    recorder["spans"] += _steps(9000, 12_000, 5, 40, 40) + [_span(9100, "ingest.read", 12_500, 99)]
    assert _read(name, ctx) == pytest.approx(whole)
    assert calls == [(0, int(ctx.units()[-1].t1 * 1e9))]


@pytest.mark.parametrize("kind,names", [
    ("qa", ["step_launch_ms.qa", "step_wait_ms.qa", "first_token_ms.qa"]),
    ("stream", ["step_launch_ms.stream", "step_wait_ms.stream", "ingest_host_ms.stream",
                "memory_self_ms.stream"]),
])
def test_a_tiny_traced_run_reports_them(run_tiny, kind, names):
    """decode_step_p99_ms needs a thousand steps, more than a tiny window takes."""
    out = run_tiny(kind, trace=True)
    for name in names:
        assert out["metrics"][name]["value"] >= 0, name
    assert f"decode_step_p99_ms.{kind}" not in out["metrics"]
    assert out["metrics"][f"step_launch_ms.{kind}"]["value"] > 0
