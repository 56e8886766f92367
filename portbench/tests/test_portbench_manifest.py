"""BENCHMARK.json against the rules its names, units and entries keep."""

import json
import os

from portbench import manifest
from portbench.tests.conftest import ROOT


def _man():
    return manifest.load(ROOT)


def test_names_and_units_keep_the_rules():
    assert manifest.problems(_man()) == []


def test_rules_reject_bad_names_and_units():
    man = _man()
    bad = json.loads(json.dumps(man))
    bad["per_layer"][0]["name"] = "a name"
    bad["end_to_end"][0]["unit"] = "frames per second"
    bad["workloads"].append(dict(bad["workloads"][0]))
    got = manifest.problems(bad)
    assert any("a name" in p for p in got)
    assert any("frames per second" in p for p in got)
    assert any("duplicate workloads" in p for p in got)


def test_every_file_an_entry_names_exists():
    man = _man()
    for c in man["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert any(w["config"] == c["name"] for w in man["workloads"])
    for w in man["workloads"]:
        assert os.path.exists(os.path.join(ROOT, "portbench", "traffic", w["traffic"] + ".json"))
    for m in man["end_to_end"] + man["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics", m["name"] + ".py"))


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    man = _man()
    moved = {m["name"] for m in man["end_to_end"]}
    for w in man["workloads"]:
        e2e = {m["name"] for m in manifest.metrics_of(man, w["name"], trace=False)}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        per_layer = manifest.metrics_of(man, w["name"], trace=True)
        assert per_layer, w["name"]
        for m in per_layer:
            assert m["moves"] in moved and m["moves"] in e2e, (w["name"], m["name"])


def test_configuration_files_state_what_the_reference_needs():
    man = _man()
    for c in man["configs"]:
        cfg = manifest.config(man, c["name"], ROOT)
        assert c["reduced"] == []
        assert set(cfg["limits"]) >= {"vit_rel_err", "memory_logit_gap", "answer_logit_gap",
                                      "query_rel_err"}
        assert cfg["serving"]["weight_bits"] in (4, 8)
        assert "assumed" in cfg
