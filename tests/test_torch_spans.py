"""The port's span recorder (`utils/profiling.span`) and the spans every layer
of the main path opens, on the CPU.

Held:
- the recorder: nesting gives parent ids and one request id a root; each
  thread keeps its own stack, and many threads at once lose no span and
  share no slot; the ring keeps the newest spans and counts
  the ones it overwrote; `spans(t0, t1)` reads an interval oldest first;
- under a CPU torch.profiler each span is a `user_annotation` named
  `streamchat.<name>`, in the recorder's order, with durations that agree;
  without a profiler no `record_function` is entered;
- `PhaseTimer` records its windows through `span`;
- every decode loop (dense, paged in row order and through the table,
  speculative, H2O): one `decode.step` a step taken, one `decode.replay`
  and one `decode.readback` under each, `decode.alloc` where the allocator
  runs, a `generate` span over `generate.prefill` and `generate.decode`
  whose times are `gen_stats`' `prefill_s` and `decode_s`, and a first
  readback that ends between the two; also through `LongVA`;
- `encode_segment`, `update_memory` (with the tree's summary), the answer's
  retrieval, the on-line session's worker and drain emit their spans, and
  `process_video_online` reports phase totals from those of its own two
  threads, and none when the ring overwrote any of them.
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from streamchat_tpu_torch import config
from streamchat_tpu_torch.config import MemoryConfig, PipelineConfig, SamplingConfig
from streamchat_tpu_torch.memory.bank import MemoryBank
from streamchat_tpu_torch.memory.tree import VisualMemoryTree
from streamchat_tpu_torch.models import decoder, generate
from streamchat_tpu_torch.models import generate_paged as gp
from streamchat_tpu_torch.models.longva import LongVA
from streamchat_tpu_torch.ops.kmeans import weighted_kmeans_feature
from streamchat_tpu_torch.pipeline import answer, runner
from streamchat_tpu_torch.pipeline.ingest import encode_segment
from streamchat_tpu_torch.pipeline.memory_update import update_memory
from streamchat_tpu_torch.pipeline.streaming import StreamingSession
from streamchat_tpu_torch.utils import profiling
from streamchat_tpu_torch.utils.profiling import PhaseTimer, span
from streamchat_tpu_torch.video.reader import SyntheticVideoReader


@pytest.fixture(autouse=True)
def fresh_ring():
    profiling.reset()
    yield
    profiling.reset()


def _named(name, of=None):
    return [s for s in (profiling.spans() if of is None else of) if s.name == name]


def _children(parent, of):
    return [s for s in of if s.parent == parent.id]


def hash_embed(texts):
    out = np.zeros((len(texts), 16), np.float32)
    for i, t in enumerate(texts):
        for a, b in zip(t, t[1:]):
            out[i, (ord(a) * 31 + ord(b)) % 16] += 1.0
        if not t:
            out[i, 0] = 1.0
    return out


# --- the recorder -------------------------------------------------------------------

def test_nested_spans_give_parents_and_one_request_id():
    with span("a", k=1) as a:
        with span("b") as b:
            with span("c") as c:
                pass
        with span("d") as d:
            d.tags["late"] = 2
    with span("e") as e:
        pass
    got = profiling.spans()
    assert [s.name for s in got] == ["a", "b", "c", "d", "e"]
    assert (a.parent, b.parent, c.parent, d.parent, e.parent) == (0, a.id, b.id, a.id, 0)
    assert {s.request for s in (a, b, c, d)} == {a.id} and e.request == e.id != a.id
    assert a.tags == {"k": 1} and d.tags == {"late": 2}
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns <= d.start_ns
    assert d.end_ns <= a.end_ns <= e.start_ns
    assert {s.thread for s in got} == {threading.get_ident()}
    assert profiling.dropped() == 0


def test_two_threads_keep_their_own_stacks():
    """Spans of two threads interleave in time and never parent each other."""
    gate = threading.Barrier(2)
    made = {}

    def work(tag):
        with span("root." + tag) as root:
            gate.wait()
            for i in range(3):
                with span("leaf." + tag, i=i):
                    time.sleep(0.001)
            gate.wait()
        made[tag] = (root, threading.get_ident())

    threads = [threading.Thread(target=work, args=(t,)) for t in "xy"]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    got = profiling.spans()
    for tag, (root, ident) in made.items():
        leaves = _named("leaf." + tag, got)
        assert len(leaves) == 3
        assert all(s.parent == root.id and s.request == root.id and s.thread == ident
                   for s in leaves)
        assert root.parent == 0 and root.thread == ident
    assert made["x"][1] != made["y"][1]
    (x, _), (y, _) = made["x"], made["y"]
    assert x.start_ns < y.end_ns and y.start_ns < x.end_ns


def test_many_threads_lose_no_span_and_share_no_slot():
    """More threads than cores, a switch interval of a microsecond: every
    span lands in a slot of its own, with its own thread's parent."""
    threads_n, per = min(2 * (os.cpu_count() or 4), 32), 500
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(per):
                with span("outer", k=k, i=i):
                    with span("inner", k=k):
                        pass

        threads = [threading.Thread(target=work, args=(k,)) for k in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    got = profiling.spans()
    assert len(got) == 2 * threads_n * per and profiling.dropped() == 0
    assert len({s.slot for s in got}) == len(got) and len({s.id for s in got}) == len(got)
    outer = {s.id: s for s in got if s.name == "outer"}
    for s in got:
        if s.name == "inner":
            parent = outer[s.parent]
            assert parent.thread == s.thread and parent.tags["k"] == s.tags["k"]
            assert s.request == parent.id


def test_the_ring_overwrites_the_oldest_and_counts_them():
    profiling.reset(8)
    for i in range(5):
        with span("s", i=i):
            pass
    assert profiling.dropped() == 0 and len(profiling.spans()) == 5
    assert profiling.intact_since(0)
    for i in range(5, 13):
        with span("s", i=i):
            pass
        if i == 6:
            mark = time.perf_counter_ns()
    kept = profiling.spans()
    assert [s.tags["i"] for s in kept] == list(range(5, 13))
    assert profiling.dropped() == 5
    # Spans 0-4 went; a window from span 7 on is whole, one from 0 is not.
    assert profiling.intact_since(mark) and not profiling.intact_since(0)
    assert not profiling.intact_since(kept[0].start_ns)
    with pytest.raises(ValueError):
        profiling.reset(12)


def test_spans_reads_an_interval_oldest_first():
    """A parent closes after its children but reads first; bounds test the start."""
    t0 = time.perf_counter_ns()
    with span("outer"):
        with span("inner"):
            time.sleep(0.002)
    t1 = time.perf_counter_ns()
    with span("later"):
        pass
    assert [s.name for s in profiling.spans(t0, t1)] == ["outer", "inner"]
    assert [s.name for s in profiling.spans(t1)] == ["later"]
    secs, counts = profiling.totals(profiling.spans())
    assert counts == {"outer": 1, "inner": 1, "later": 1}
    assert secs["outer"] >= secs["inner"] >= 0.002


def test_without_a_profiler_no_record_function_is_entered(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(profiling, "record_function", Counting)
    with span("a"):
        with span("b"):
            pass
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        with span("a"):
            pass
    assert entered == ["streamchat.a"]


def test_under_a_profiler_each_span_is_an_annotation_in_order(tmp_path):
    """Spans of 100 ms and more agree with their annotations within 5%: a
    few milliseconds of the test process descheduled under a loaded CPU
    between a clock read and its annotation's edge stay inside that."""
    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("outer"):
            for i in range(4):
                with span("decode.step", i=i):
                    with span("decode.replay"):
                        x = torch.tanh(x @ x)
                        time.sleep(0.1)
                    with span("decode.readback"):
                        time.sleep(0.1)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ann = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and str(e.get("name", "")).startswith(profiling.ANNOTATION_PREFIX)),
                 key=lambda e: float(e["ts"]))
    got = profiling.spans()
    assert [e["name"] for e in ann] == [profiling.ANNOTATION_PREFIX + s.name for s in got]
    assert len(got) == 13
    for e, s in zip(ann, got):
        dur_us = s.duration_ns / 1e3
        assert abs(float(e["dur"]) - dur_us) <= 0.05 * dur_us, (e, s)


def test_phase_timer_records_its_windows_through_span():
    synced = []
    timer = PhaseTimer(synchronize=lambda: synced.append(1))
    with timer.phase("ingest"):
        time.sleep(0.002)
    with timer.phase("ingest"):
        pass
    phases = _named("phase.ingest")
    assert len(phases) == 2 and synced == [1, 1]
    assert timer.counts["ingest"] == 2
    assert timer.totals["ingest"] == pytest.approx(sum(s.seconds for s in phases), abs=1e-9)


# --- the decode loops ---------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_decoder():
    cfg = config.DecoderConfig.tiny()
    params = decoder.init(cfg, torch.Generator().manual_seed(0), device="cpu",
                          dtype=torch.float32)
    return cfg, params


# Each loop form: (rows' valid lengths, generate_paged keywords or None for
# the dense loop, whether the allocator runs between steps).
FORMS = {
    "dense": ([37, 12], None, False),
    "row_order_b1": ([37], dict(page_size=8), False),
    "table_b3": ([37, 20, 5], dict(page_size=8, num_pages=22, max_pages_per_seq=7), True),
    "spec3": ([37], dict(page_size=8, spec_tokens=3), False),
    "h2o": ([20], dict(page_size=16, num_pages=3, max_pages_per_seq=3, hh_size=12,
                       recent_size=16, sink_size=4), True),
}


@pytest.mark.parametrize("form", list(FORMS))
def test_every_decode_loop_records_its_steps(tiny_decoder, form):
    cfg, params = tiny_decoder
    lengths, kw, allocates = FORMS[form]
    rng = np.random.default_rng(3)
    s = 20 if form == "h2o" else 40
    embeds = torch.from_numpy((rng.standard_normal((len(lengths), s, cfg.hidden_size)) * 0.5)
                              .astype(np.float32))
    seq = torch.tensor(lengths, dtype=torch.int32)
    stats = {}
    new = 36 if form == "h2o" else 14
    g = torch.Generator().manual_seed(5)
    if kw is None:
        generate.generate(params, cfg, embeds, seq, g, max_new_tokens=new, temperature=1.0,
                          stats=stats)
    else:
        gp.generate_paged(params, cfg, embeds, seq, g, max_new_tokens=new, temperature=1.0,
                          stats=stats, **kw)
    got = profiling.spans()
    steps = _named("decode.step", got)
    assert stats["decode_steps"] > 0 and len(steps) == stats["decode_steps"]
    (call,) = _named("generate", got)
    (pre,) = _named("generate.prefill", got)
    (dec,) = _named("generate.decode", got)
    assert pre.parent == dec.parent == call.id
    assert all(st.parent == dec.id for st in steps)
    for st in steps:
        kids = [k.name for k in _children(st, got)]
        assert kids.count("decode.replay") == 1 and kids.count("decode.readback") == 1
        assert set(kids) <= {"decode.alloc", "decode.replay", "decode.readback"}
        assert kids[-2:] == ["decode.replay", "decode.readback"]
    assert bool(_named("decode.alloc", got)) == allocates
    assert call.tags["steps"] == stats["decode_steps"] and call.tags["graphed"] is False
    assert call.tags["prompt_tokens"] == stats["prompt_tokens"]
    assert (stats["prefill_s"], stats["decode_s"]) == (pre.seconds, dec.seconds)
    first_wait = _named("decode.readback", got)[0]
    assert first_wait.parent == steps[0].id
    assert pre.end_ns <= first_wait.end_ns <= dec.end_ns


def test_longva_generate_paged_records_one_step_span_a_decode_step():
    model = LongVA.init_random(config.ViTConfig.tiny(projection_dim=128),
                               config.DecoderConfig.tiny(), device="cpu", dtype=torch.float32)
    for prompt in ("describe the scene", "and then?"):
        model.generate_with_image_embedding(prompt, None, max_new_tokens=6, temperature=1.0)
    got = profiling.spans()
    assert len(_named("decode.step", got)) == model.gen_stats["decode_steps"] > 0
    assert len(_named("decode.replay", got)) == len(_named("decode.readback", got)) == \
        model.gen_stats["decode_steps"]
    calls = _named("generate", got)
    assert len(calls) == 2
    for call in calls:
        dec = [s for s in _named("generate.decode", got) if s.parent == call.id][0]
        pre = [s for s in _named("generate.prefill", got) if s.parent == call.id][0]
        first_step = [s for s in _named("decode.step", got) if s.parent == dec.id][0]
        first_wait = [s for s in _children(first_step, got) if s.name == "decode.readback"][0]
        assert pre.end_ns <= first_wait.end_ns <= dec.end_ns


# --- ingest, memory update, retrieval, the on-line session ---------------------------

@pytest.fixture(scope="module")
def tiny_pipe():
    cfg = PipelineConfig(
        memory=MemoryConfig(chunk_size=4, num_clusters=2, interval=2, short_window=6,
                            remember_window=3),
        sampling=SamplingConfig(max_answer_tokens=4, max_caption_tokens=4,
                                max_summary_tokens=4))
    return runner.build_pipeline(cfg, device="cpu", geometry="tiny", dtype=torch.float32)


def test_encode_segment_records_read_upload_and_encode(tiny_pipe):
    reader = SyntheticVideoReader(total_frames=150, frame_rate=30, height=56, width=56)
    feats = encode_segment(tiny_pipe.model, reader, 0, 2, tiny_pipe.cfg.video, 4)
    got = profiling.spans()
    (read,) = _named("ingest.read", got)
    uploads, encodes = _named("ingest.upload", got), _named("ingest.encode", got)
    assert read.tags["frames"] == feats.shape[0] > 0
    assert len(uploads) == len(encodes) >= 1
    assert read.end_ns <= uploads[0].start_ns
    for up, enc in zip(uploads, encodes):
        assert up.end_ns <= enc.start_ns


def _tree(interval=2):
    g = torch.Generator().manual_seed(0)
    return VisualMemoryTree(2, interval, hash_embed, lambda caps: "summary: " + "|".join(caps),
                            lambda x, k: weighted_kmeans_feature(x, k, generator=g)[0])


def test_update_memory_records_its_parts_and_the_summary():
    cfg = MemoryConfig(chunk_size=4, num_clusters=2, interval=2, short_window=6,
                       remember_window=3)
    feats = torch.from_numpy(np.random.default_rng(0).standard_normal((9, 3, 8))
                             .astype(np.float32))
    tree, short = update_memory(feats, _tree(), lambda c: f"caption {c.shape[0]}", cfg,
                                torch.Generator().manual_seed(1))
    got = profiling.spans()
    (upd,) = _named("memory.update", got)
    assert [k.name for k in _children(upd, got)] == [
        "memory.short", "memory.cluster", "memory.caption", "memory.caption",
        "memory.caption", "memory.tree_add"]
    (add,) = _named("memory.tree_add", got)
    (summ,) = _named("memory.summarize", got)
    assert summ.parent == add.id and summ.request == upd.id and summ.tags["captions"] == 2
    assert add.tags["chunks"] == 3 and short.shape[0] == 3
    assert any(n.depth == 1 for n in tree.roots)


def test_the_answers_retrieval_spans_give_its_timings():
    class Model:
        def generate_with_image_embedding(self, prompt, image_embeddings=None, **kw):
            return "ok"

    tree = _tree(interval=10)
    tree.add_chunks([torch.ones(2, 3, 8)], ["a caption"])
    res = answer.answer_question("what?", Model(), lambda t: torch.from_numpy(hash_embed([t])[0]),
                                 torch.ones(2, 3, 8), tree, None, SamplingConfig())
    got = profiling.spans()
    (emb,) = _named("answer.embed_query", got)
    (search,) = _named("answer.tree_search", got)
    assert emb.end_ns <= search.start_ns
    assert res.timings["embed_query_s"] == round(emb.seconds, 4)
    assert res.timings["tree_search_s"] == round(search.seconds, 4)


def test_the_online_worker_and_drain_record_spans():
    cfg = MemoryConfig(chunk_size=4, num_clusters=2, interval=2, short_window=6,
                       remember_window=3, tau=5.0)
    session = StreamingSession(_tree(), lambda c: f"mock caption {c.shape[0]}", cfg,
                               torch.Generator().manual_seed(1))
    try:
        session.push(torch.from_numpy(np.random.default_rng(0).standard_normal((10, 3, 8))
                                      .astype(np.float32)))
        session.flush()
        session.ask(lambda short, tree: len(tree))
    finally:
        session.close()
    got = profiling.spans()
    me = threading.get_ident()
    (drain,) = _named("online.drain", got)
    assert drain.thread == me
    worker = [s for s in got if s.name in ("memory.cluster", "memory.caption",
                                           "memory.tree_add")]
    assert len(_named("memory.caption", got)) == 3 and len(_named("memory.cluster", got)) == 2
    assert len(_named("memory.tree_add", got)) == 3
    assert {s.thread for s in worker} == {session._worker.ident} != {me}
    assert len(_named("memory.summarize", got)) == 1


def test_process_video_online_reports_phase_totals_from_spans(tiny_pipe, tmp_path):
    bank = MemoryBank(str(tmp_path / "m.json"), tiny_pipe.bank_embed)
    reader = SyntheticVideoReader(total_frames=150, frame_rate=30, height=56, width=56)
    res = tiny_pipe.process_video_online(reader, [{"question": "q1", "time": 2}], bank, "User")
    assert len(res) == 1
    totals, counts = tiny_pipe.last_phase_totals, tiny_pipe.last_phase_counts
    assert {"ingest.read", "ingest.encode", "memory.caption", "memory.tree_add", "online.drain",
            "answer.history", "generate", "decode.step"} <= set(totals)
    assert counts["decode.step"] == sum(s.tags["steps"] for s in _named("generate"))
    assert all(v >= 0 for v in totals.values())


def test_process_video_online_leaves_out_other_threads_spans(tiny_pipe, tmp_path,
                                                             monkeypatch):
    """A span another thread of the process records during the call is not
    the call's."""
    history = tiny_pipe._history_prompt

    def with_a_neighbour(*args):
        t = threading.Thread(target=lambda: span("elsewhere").__enter__().__exit__())
        t.start()
        t.join()
        return history(*args)

    monkeypatch.setattr(tiny_pipe, "_history_prompt", with_a_neighbour)
    bank = MemoryBank(str(tmp_path / "m.json"), tiny_pipe.bank_embed)
    reader = SyntheticVideoReader(total_frames=150, frame_rate=30, height=56, width=56)
    tiny_pipe.process_video_online(reader, [{"question": "q1", "time": 2}], bank, "User")
    assert len(_named("elsewhere")) == 1
    assert "elsewhere" not in tiny_pipe.last_phase_totals
    assert tiny_pipe.last_phase_counts["answer.history"] == 1


def test_process_video_online_reports_no_totals_from_a_ring_that_overwrote_spans(
        tiny_pipe, tmp_path):
    profiling.reset(64)
    bank = MemoryBank(str(tmp_path / "m.json"), tiny_pipe.bank_embed)
    reader = SyntheticVideoReader(total_frames=150, frame_rate=30, height=56, width=56)
    res = tiny_pipe.process_video_online(reader, [{"question": "q1", "time": 2}], bank, "User")
    assert len(res) == 1 and profiling.dropped() > 0
    assert tiny_pipe.last_phase_totals == {} and tiny_pipe.last_phase_counts == {}


def test_the_span_names_are_those_the_readme_lists():
    readme = open(os.path.join(os.path.dirname(__file__), "..", "README.md")).read()
    for name in ("decode.step", "decode.alloc", "decode.replay", "decode.readback", "generate",
                 "generate.prefill", "generate.decode", "ingest.read", "ingest.upload",
                 "ingest.encode", "memory.update", "memory.short", "memory.cluster",
                 "memory.caption", "memory.tree_add", "memory.summarize", "answer.history",
                 "answer.embed_query", "answer.tree_search", "online.drain"):
        assert f"`{name}`" in readme, name
