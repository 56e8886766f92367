"""The port's copies of the model-free tools (`tools/streambench.py`,
`tools/visualize.py`) and of the memory leftovers (`forgetting_curve`,
`ForgetfulMemoryBank`, `build_full_memory_prompt`) against the JAX
package's originals: the same inputs give equal outputs, files and
prompts. Modelled on `tests/test_tools_baseline.py` and
`tests/test_parity_extras.py`.
"""

import json
import os

import numpy as np
import pytest
import torch

from streamchat_tpu.memory import bank as jbank
from streamchat_tpu.pipeline import prompts as jprompts
from streamchat_tpu.tools import streambench as jstreambench
from streamchat_tpu.tools import visualize as jvisualize
from streamchat_tpu_torch.memory import bank
from streamchat_tpu_torch.pipeline import prompts
from streamchat_tpu_torch.tools import streambench, visualize

ANNOS = [
    {"info": {"video_path": f"v{i}.mp4", "class_1": cat, "class_2": sub},
     "breakpoint": [
         {"question": "q", "answer": "a", "class": "OCP", "time": 5 + i},
         {"question": "q2", "answer": "a2", "class": cls, "time": 9 + 2 * i},
     ]}
    for i, (cat, sub, cls) in enumerate([
        ("Ego", "Cooking", "CT"), ("Ego", "Cooking", "CT"), ("Ego", "Room-Tour", "OCP"),
        ("Movie", "Drama", "CT"), ("Movie", "Action", "SCU"), ("Web", "Show", "CT"),
    ])
]


def _cli(module, argv, capsys):
    module.main(argv)
    return capsys.readouterr().out


def test_stats_resample_and_check_videos_equal(tmp_path):
    assert streambench.annotation_stats(ANNOS) == jstreambench.annotation_stats(ANNOS)
    for per, seed in ((1, 0), (2, 1), (5, 3)):
        assert (streambench.resample_by_category(ANNOS, per, seed)
                == jstreambench.resample_by_category(ANNOS, per, seed))
    (tmp_path / "Ego").mkdir()
    (tmp_path / "Ego" / "v0.mp4").write_bytes(b"")
    assert (streambench.check_videos(ANNOS, str(tmp_path))
            == jstreambench.check_videos(ANNOS, str(tmp_path)))
    assert (streambench.check_videos(ANNOS[:1], str(tmp_path), open_check=True)
            == jstreambench.check_videos(ANNOS[:1], str(tmp_path), open_check=True)
            == [str(tmp_path / "Ego" / "v0.mp4")])


def test_cli_stats_resample_check_and_plots_equal(tmp_path, capsys):
    ann = tmp_path / "a.json"
    ann.write_text(json.dumps(ANNOS))
    for argv in (["stats", "--annotations", str(ann)],
                 ["check-videos", "--annotations", str(ann), "--video_dir", str(tmp_path)]):
        assert _cli(streambench, argv, capsys) == _cli(jstreambench, argv, capsys)
    outs = []
    for module, name in ((streambench, "port.json"), (jstreambench, "jax.json")):
        argv = ["resample", "--annotations", str(ann), "--per_category", "1",
                "--output", str(tmp_path / name), "--seed", "2"]
        outs.append(_cli(module, argv, capsys))
    assert outs[0] == outs[1]
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    wrote = []
    for module, d in ((streambench, "port"), (jstreambench, "jax")):
        argv = ["plots", "--annotations", str(ann), "--out_dir", str(tmp_path / d)]
        wrote.append([os.path.basename(p) for p in json.loads(_cli(module, argv, capsys))["wrote"]])
    assert wrote[0] == wrote[1] and len(wrote[0]) == 3
    assert all(os.path.exists(tmp_path / "port" / f) for f in wrote[0])


def test_extract_frames_equal(tmp_path, capsys):
    cv2 = pytest.importorskip("cv2")
    path = tmp_path / "clip.mp4"
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (64, 48))
    assert w.isOpened()
    rng = np.random.default_rng(0)
    for _ in range(75):
        w.write(rng.integers(0, 255, (48, 64, 3), np.uint8))
    w.release()
    reports = []
    for module, d in ((streambench, "port"), (jstreambench, "jax")):
        argv = ["extract-frames", "--video", str(path), "--output_folder", str(tmp_path / d),
                "--fps", "2", "--limit", "4"]
        reports.append(json.loads(_cli(module, argv, capsys)))
    for r in reports:
        r.pop("save_path")
    assert reports[0] == reports[1] and reports[0]["extracted_frames"] == 4
    names = sorted(os.listdir(tmp_path / "port" / "clip"))
    assert names == sorted(os.listdir(tmp_path / "jax" / "clip"))
    for n in names:
        assert ((tmp_path / "port" / "clip" / n).read_bytes()
                == (tmp_path / "jax" / "clip" / n).read_bytes())
    with pytest.raises(ValueError, match="cannot open"):
        streambench.extract_frames(str(tmp_path / "nope.mp4"), str(tmp_path))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_visualize_takes_tensors_and_arrays(tmp_path, dtype):
    rng = np.random.default_rng(1)
    bank_np = [rng.normal(size=(4, 16)).astype(np.float32) for _ in range(10)]
    mems_np = [rng.normal(size=(2, 4, 16)).astype(np.float32) for _ in range(3)]
    as_t = [torch.from_numpy(b).to(dtype) for b in bank_np]
    mems_t = [torch.from_numpy(m).to(dtype) for m in mems_np]
    # The JAX original on the values the tensors hold.
    ref = jvisualize.visualize_memory_features(
        [t.float().numpy() for t in as_t], [m.float().numpy() for m in mems_t],
        str(tmp_path / "jax.png"))
    got = visualize.visualize_memory_features(as_t, mems_t, str(tmp_path / "port.png"))
    assert got.shape == (10, 2) and np.array_equal(got, ref)
    assert np.array_equal(visualize.visualize_memory_features(bank_np, mems_np,
                                                              str(tmp_path / "np.png")),
                          jvisualize.visualize_memory_features(bank_np, mems_np,
                                                               str(tmp_path / "j2.png")))
    x = rng.normal(size=(20, 16))
    assert np.array_equal(visualize.pca_project(torch.from_numpy(x)), jvisualize.pca_project(x))
    stats = jstreambench.annotation_stats(ANNOS)
    assert np.array_equal(
        visualize.plot_duration_histogram(stats["video_seconds"]["per_video"],
                                          str(tmp_path / "h.png"), bins=4),
        jvisualize.plot_duration_histogram(stats["video_seconds"]["per_video"],
                                           str(tmp_path / "hj.png"), bins=4))
    assert (visualize.plot_class_pie(stats["question_classes"], str(tmp_path / "p.png"))
            == jvisualize.plot_class_pie(stats["question_classes"], str(tmp_path / "pj.png")))
    assert (visualize.plot_category_sunburst(stats["subclasses"], str(tmp_path / "s.png"))
            == jvisualize.plot_category_sunburst(stats["subclasses"],
                                                 str(tmp_path / "sj.png")))


def test_visualize_returns_values_without_matplotlib(tmp_path, monkeypatch):
    """Where matplotlib is missing the functions return their values and
    write no PNG, as the originals do."""
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *a, **kw):
        if name.startswith("matplotlib"):
            raise ImportError(name)
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    counts = visualize.plot_duration_histogram([1, 2, 3, 9], str(tmp_path / "h.png"), bins=2)
    xy = visualize.visualize_memory_features([torch.ones(2, 4), torch.zeros(2, 4)], None,
                                             str(tmp_path / "m.png"))
    assert counts.tolist() == [3, 1] and xy.shape == (2, 2)
    assert os.listdir(tmp_path) == []


def hash_embed(texts):
    out = np.zeros((len(texts), 16), np.float32)
    for i, t in enumerate(texts):
        for a, b in zip(t, t[1:]):
            out[i, (ord(a) * 31 + ord(b)) % 16] += 1.0
    return out


@pytest.mark.parametrize("days,strength", [(0, 1), (1, 1), (10, 1), (10, 5), (3, 0)])
def test_forgetting_curve_equal(days, strength):
    assert bank.forgetting_curve(days, strength) == jbank.forgetting_curve(days, strength)


def test_forgetful_bank_equal(tmp_path):
    """The same turns, seed and dates: both forget the same turns, write the
    same JSON and strengthen the same metadata."""
    stores = []
    for pkg, name in ((bank, "port.json"), (jbank, "jax.json")):
        b = pkg.MemoryBank(str(tmp_path / name), hash_embed)
        b.enter_name("u")
        for i, date in enumerate(["2020-01-01", "2026-07-01", "2026-08-10", "2026-08-16"]):
            for j in range(3):
                b.save_local_memory("u", f"q{i}{j}", f"r{i}{j}", date=date)
        fb = pkg.ForgetfulMemoryBank(b, seed=3)
        forgotten = fb.apply_forgetting("u", "2026-08-16")
        ids = [d["memory_id"] for day in b.memory["u"]["history"].values() for d in day][:2]
        fb.strengthen("u", ids, "2026-08-20")
        stores.append((forgotten, (tmp_path / name).read_text()))
    assert stores[0] == stores[1]
    assert stores[0][0] >= 1


def test_full_memory_prompt_equal():
    meta = ("U:{user_name} S:{history_summary} R:{related_memory_content} "
            "P:{personality} B:{boot_actual_name} H:{history_text} D:{memo_dates}")
    meta_related = "U:{user_name} R:{related_memory_content} B:{boot_actual_name} D:{memo_dates}"
    new_user = "NEW U:{user_name} B:{boot_actual_name} H:{history_text}"
    cases = [
        ("what now?", "alice", {"overall_history": "we cooked", "overall_personality": "kind"},
         ["memo one", "memo two"], "2026-01-01", meta, new_user,
         [{"query": "hi", "response": "hello"}]),
        ("q", "bob", {}, ["memo"], "d", meta_related, new_user, None),
        ("q", "carol", {}, [], "", meta_related, new_user, [{"query": "a", "response": "b"}]),
    ]
    for q, user, mem, memos, dates, m, n, history in cases:
        assert (prompts.build_full_memory_prompt(q, user, mem, memos, dates, m, n,
                                                 history=history)
                == jprompts.build_full_memory_prompt(q, user, mem, memos, dates, m, n,
                                                     history=history))
