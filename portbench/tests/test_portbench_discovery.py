"""The harness finds a cell, a configuration, a traffic mix, a traffic kind
and a metric by name: one added as new files and new entries in a copy of
the benchmark runs without an edit to any existing file. The added
configuration also serves the program with a key no existing one sets
(speculative decoding), and the added kind drives its window in a way of
its own."""

import json
import os
import shutil

from portbench import manifest
from portbench.tests.conftest import ROOT, tiny


def _copy(tmp_path):
    dst = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst / "BENCHMARK.json")
    return dst


def test_finds_existing_entries_by_name():
    man = manifest.load(ROOT)
    for w in man["workloads"]:
        assert manifest.cell(man, w["name"]) is w
        assert manifest.config(man, w["config"], ROOT)["hidden_size"] == 3584
        kind = manifest.kind_module(manifest.traffic(w["traffic"], ROOT)["kind"], ROOT)
        assert callable(kind.Driver) and kind.NUMBERS
    for m in man["end_to_end"] + man["per_layer"]:
        assert callable(manifest.metric_module(m["name"], ROOT).read)


def test_new_files_and_entries_make_a_new_cell(tmp_path, run_tiny, monkeypatch):
    root = _copy(tmp_path)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    man = json.loads((root / "BENCHMARK.json").read_text())
    cfg, spec = tiny("qa")
    cfg["serving"] = dict(cfg["serving"], spec_tokens=2)
    (root / "portbench" / "configs" / "tiny-added.json").write_text(json.dumps(cfg))
    spec = dict(spec, kind="qa_twice",
                questions=dict(spec["questions"], min_words=5, max_words=8))
    (root / "portbench" / "traffic" / "qa-added.json").write_text(json.dumps(spec))
    (root / "portbench" / "kinds" / "qa_twice.py").write_text(
        '"""qa_twice: the qa kind, each question asked twice in a row."""\n\n'
        "from portbench.drive import run_window\n"
        "from portbench.kinds.qa import NUMBERS, Driver as QADriver  # noqa: F401\n\n\n"
        "class Driver(QADriver):\n"
        "    def window(self, seconds, trace_units):\n"
        "        def step(unit, traced):\n"
        "            q = self.plan.questions[(unit // 2) % len(self.plan.questions)]\n"
        "            return self.answer(q, unit, self.plan.greedy[unit], traced)\n\n"
        "        return run_window(step, seconds, trace_units, self.pipe.model.device)\n")
    (root / "portbench" / "metrics" / "answers_done.qa-added.py").write_text(
        '"""answers_done: answers the untraced window finished."""\n\n\n'
        "def read(ctx):\n    return float(len(ctx.units()))\n")
    man["configs"].append({"name": "tiny-added", "source": "https://example.org/tiny",
                           "file": "portbench/configs/tiny-added.json", "reduced": [],
                           "why": "added in a test"})
    man["workloads"].append({"name": "tiny-added.qa-added", "config": "tiny-added",
                             "traffic": "qa-added", "chips": 1, "why": "added in a test"})
    man["end_to_end"][1]["workloads"].append("tiny-added.qa-added")
    man["per_layer"].append({"name": "answers_done.qa-added", "unit": "answers",
                             "better": "higher", "source": "program_counter", "layer": "device",
                             "moves": "answer_s", "workloads": ["tiny-added.qa-added"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    changed = [p for p, b in before.items() if p.read_bytes() != b]
    assert changed == [root / "BENCHMARK.json"]
    assert manifest.problems(manifest.load(str(root))) == []

    import copy

    from portbench import run
    from portbench.kinds.qa import Driver as QADriver

    added = manifest.config(manifest.load(str(root)), "tiny-added", str(root))
    asked = []
    orig = QADriver.answer

    def answer(self, question, *a, **kw):
        asked.append(question)
        return orig(self, question, *a, **kw)

    monkeypatch.setattr(QADriver, "answer", answer)
    out = run.run_cell("tiny-added.qa-added", 55, 0.5, True, "cpu", root=str(root),
                       config_override=copy.deepcopy(added))
    assert out["correct"], out["checks"]
    assert out["metrics"]["answers_done.qa-added"]["value"] >= 1
    window = asked[-out["attempted"]:]
    assert len(window) >= 2 and window[0] == window[1]
    out = run.run_cell("tiny-added.qa-added", 55, 0.5, False, "cpu", root=str(root),
                       config_override=copy.deepcopy(added))
    assert set(out["metrics"]) == {"answer_s", "setup_s"}
