"""The port's memory-free baseline and cross-benchmark runner CLIs against
the JAX package's, on the CPU.

Both packages run the same tiny LongVA (the JAX package's f32 random
weights, carried across by `streamchat_tpu_torch.convert`) through each
CLI's `main` over the same written files: an mp4 per video and PNGs for
SEED-Bench. Each CLI's model builder is patched to return that model (the
JAX CLIs build bf16 weights of their own). Greedy decoding (temperature
0): every output file must equal the JAX CLI's, field by field, ignoring
the prefix baseline's `process_time`. The helpers are held equal on the
same inputs. On a CPU tensor no wrapper may count a kernel launch.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import streamchat_tpu.pipeline.baseline as j_baseline
import streamchat_tpu.pipeline.bench_runners as j_runners
from streamchat_tpu import config as jconfig
from streamchat_tpu.models.longva import LongVA as JLongVA
from streamchat_tpu_torch import config, convert, kernels
from streamchat_tpu_torch.models.longva import LongVA
from streamchat_tpu_torch.models.tokenizer import ByteTokenizer
from streamchat_tpu_torch.pipeline import baseline, bench_runners

cv2 = pytest.importorskip("cv2")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these tiny tensors: the suite runs a worker
    per core, and torch's thread pools then contend (a step took 2.5x as
    long with the default eight)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_launches():
    kernels.reset_launch_counts()
    yield
    assert all(v == 0 for v in kernels.launch_counts().values()), \
        "a CPU tensor must run the plain twin, never count a launch"


@pytest.fixture(scope="module")
def models():
    dcfg = jconfig.DecoderConfig.tiny()
    jm = JLongVA.init_random(jax.random.key(0),
                             jconfig.ViTConfig.tiny(projection_dim=dcfg.hidden_size), dcfg,
                             dtype=jnp.float32)
    pm = LongVA(vit_params=convert.vit_params(_np(jm.vit_params)),
                proj_params=convert.to_torch(_np(jm.proj_params)),
                dec_params=convert.to_torch(_np(jm.dec_params)),
                vit_cfg=config.ViTConfig(**dataclasses.asdict(jm.vit_cfg)),
                dec_cfg=config.DecoderConfig(**dataclasses.asdict(dcfg)),
                tokenizer=ByteTokenizer(), generator=torch.Generator().manual_seed(0))
    return jm, pm


@pytest.fixture
def patched(models, monkeypatch):
    """Both CLIs' model builders return the shared tiny model."""
    jm, pm = models
    monkeypatch.setattr(JLongVA, "init_random", classmethod(lambda cls, *a, **k: jm))
    monkeypatch.setattr(j_runners, "_build_model", lambda name: jm)
    monkeypatch.setattr(bench_runners, "build_model", lambda name, device: pm)
    return jm, pm


def _write_video(path, frames=40, size=56, seed=0):
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (size, size))
    assert w.isOpened()
    rng = np.random.default_rng(seed)
    for _ in range(frames):
        w.write(rng.integers(0, 255, (size, size, 3), np.uint8))
    w.release()


def _both(tmp_path, run):
    """run(out_dir, jax: bool) in a directory per package -> (port, jax)."""
    outs = []
    for name, is_jax in (("port", False), ("jax", True)):
        d = tmp_path / name
        d.mkdir()
        outs.append(run(d, is_jax))
    return outs


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("total,n,end", [(100, 8, None), (100, 8, 30), (5, 8, None),
                                         (1, 4, None), (40, 128, 25)])
def test_uniform_indices_match_jax(total, n, end):
    assert baseline.uniform_indices(total, n, end) == j_baseline.uniform_indices(total, n, end)


@pytest.mark.parametrize("n,k", [(1, 0), (2, 0), (2, 1), (3, 2), (4, 3)])
def test_contiguous_chunk_matches_jax(n, k):
    lst = list(range(7))
    assert bench_runners.contiguous_chunk(lst, n, k) == j_runners.contiguous_chunk(lst, n, k)


def test_resolve_video_path_and_constants_match_jax(tmp_path):
    (tmp_path / "v_abc.webm").write_bytes(b"x")
    (tmp_path / "w_abc.mkv").write_bytes(b"x")
    for name, prefix in (("abc", "v_"), ("abc", "w_"), ("nope", "v_")):
        assert (bench_runners.resolve_video_path(str(tmp_path), name, prefix)
                == j_runners.resolve_video_path(str(tmp_path), name, prefix))
    assert bench_runners.VIDEO_FORMATS == j_runners.VIDEO_FORMATS
    assert bench_runners.VIDEOBENCH_DATASETS == j_runners.VIDEOBENCH_DATASETS
    assert bench_runners.SEED_SUBPARTS == j_runners.SEED_SUBPARTS


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7])
def test_format_mc_question_matches_jax(n):
    choices = {k: f"choice {k.lower()} " for k in "ABCDEFG"[:n]}
    if n in (1, 7):
        with pytest.raises(ValueError):
            j_runners.format_mc_question("Q?", choices)
        with pytest.raises(ValueError):
            bench_runners.format_mc_question("Q?", choices)
        return
    assert (bench_runners.format_mc_question("Q?", choices)
            == j_runners.format_mc_question("Q?", choices))


SEED_ITEMS = [{"level": lv, "subpart": sp, "version": v}
              for lv in ("L1", "L2", "L3")
              for sp in ("Single-Image & Text Comprehension", "Image Generation", "Other")
              for v in ("v1", "v2")]


@pytest.mark.parametrize("level,subpart,version", [
    ("L1", "all", "v2"), ("L2", "all", "v1"), ("L3", "Image Generation", "v2"),
    ("L9", "all", "v2"), ("L2", "nope", "v2"), ("L2", "all", "v3")])
def test_filter_seed_questions_matches_jax(level, subpart, version):
    try:
        ref = j_runners.filter_seed_questions(SEED_ITEMS, level, subpart, version)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            bench_runners.filter_seed_questions(SEED_ITEMS, level, subpart, version)
        return
    assert bench_runners.filter_seed_questions(SEED_ITEMS, level, subpart, version) == ref


def test_seed_type_accuracy_matches_jax():
    records = [{"prediction": p, "gt": g, "q_type_id": t}
               for p, g, t in (("A", "A", 1), ("B", "C", 2), ("D", "C", 2), ("C", "C", 3))]
    for recs in (records, [], records[1:3]):
        assert bench_runners.seed_type_accuracy(recs) == j_runners.seed_type_accuracy(recs)


# ---------------------------------------------------------------------------
# The CLIs, end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ego", [False, True], ids=["prefix", "ego"])
def test_baseline_cli_matches_jax(no_launches, patched, tmp_path, ego):
    video_dir = tmp_path / "videos"
    (video_dir / "cooking").mkdir(parents=True)
    _write_video(video_dir / "cooking" / "a.mp4")
    annos = [{"info": {"class_1": "cooking", "video_path": "a.mp4"},
              "breakpoint": [{"question": "What is cut?", "answer": "bread", "class": "obj",
                              "time": 2},
                             {"question": "What next?", "answer": "a pan", "class": "act",
                              "time": 4}]},
             {"info": {"class_1": "cooking", "video_path": "missing.mp4"},
              "breakpoint": [{"question": "?", "answer": "-", "class": "x", "time": 1}]}]
    anno_file = tmp_path / "annos.json"
    anno_file.write_text(json.dumps(annos))

    def run(d, is_jax):
        argv = ["--video_dir", str(video_dir), "--annotations", str(anno_file),
                "--save_file", str(d / "out.json"), "--num_frame", "4", "--temperature", "0",
                "--max_new_tokens", "4"] + (["--ego"] if ego else [])
        if is_jax:
            j_baseline.main(argv)
        else:
            baseline.main(argv + ["--device", "cpu"])
        text = (d / "out.json").read_text()
        if ego:
            return [json.loads(line) for line in text.splitlines()]
        return [{k: v for k, v in r.items() if k != "process_time"} for r in json.loads(text)]

    got, ref = _both(tmp_path, run)
    assert got == ref and len(got) == 2
    assert all(r["pred" if ego else "predict"] for r in got)


def test_videoqa_cli_matches_jax(no_launches, patched, tmp_path):
    _write_video(tmp_path / "v_vid0.mp4")
    _write_video(tmp_path / "v_vid1.mkv", seed=1)
    gt = [{"video_name": f"vid{i}", "question": q, "answer": "a", "question_id": f"q{i}"}
          for i, q in enumerate(("what?", "when?", "who?"))]
    gt_file = tmp_path / "gt.json"
    gt_file.write_text(json.dumps(gt))

    def run(d, is_jax):
        argv = ["videoqa", "--video_dir", str(tmp_path), "--gt_file_question", str(gt_file),
                "--output_dir", str(d), "--output_name", "preds", "--num_frame", "4",
                "--temperature", "0", "--max_new_tokens", "4"]
        if is_jax:
            j_runners.main(argv)
        else:
            bench_runners.main(argv + ["--device", "cpu"])
        return (d / "preds.json").read_text()

    got, ref = _both(tmp_path, run)
    assert got == ref
    rows = [json.loads(line) for line in got.splitlines()]
    assert [r["id"] for r in rows] == ["q0", "q1"] and all(r["pred"] for r in rows)


def test_videobench_cli_matches_jax(no_launches, patched, tmp_path):
    qa_root, vid_root = tmp_path / "qa", tmp_path / "videos"
    (qa_root / "Eval_QA").mkdir(parents=True)
    vid_root.mkdir()
    _write_video(vid_root / "clip.mp4")
    for name, n in (("MSVD", 4), ("TGIF", 5)):
        (qa_root / "Eval_QA" / f"{name}_QA_new.json").write_text(json.dumps({
            f"{name}_1": {"video_id": "clip", "vid_path": "clip.mp4", "question": "what?",
                          "choices": {k: k.lower() for k in "ABCDE"[:n]}},
            f"{name}_2": {"video_id": "gone", "vid_path": "gone.mp4", "question": "?",
                          "choices": {"A": "a", "B": "b"}}}))

    def run(d, is_jax):
        argv = ["videobench", "--eval_qa_root", str(qa_root), "--eval_video_root",
                str(vid_root), "--output_dir", str(d), "--datasets", "MSVD", "TGIF", "MV",
                "--num_frame", "4", "--temperature", "0", "--max_new_tokens", "4"]
        if is_jax:
            j_runners.main(argv)
        else:
            bench_runners.main(argv + ["--device", "cpu"])
        return {n: (d / f"{n}_eval.json").read_text() for n in ("MSVD", "TGIF")}

    got, ref = _both(tmp_path, run)
    assert got == ref
    assert all(json.loads(t)[f"{n}_1"]["output_sequence"] for n, t in got.items())


def test_seedbench_cli_matches_jax(no_launches, patched, tmp_path):
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    for name, shape in (("a.png", (48, 48, 3)), ("b.png", (40, 64, 3))):
        cv2.imwrite(str(img_dir / name), rng.integers(0, 255, shape, np.uint8))
    common = {"subpart": "Single-Image & Text Comprehension", "version": "v2"}
    anno = {"questions": [
        {"question_id": "s0", "question": "<img>what?", "choice_a": "cats",
         "choice_b": "dogs", "choice_c": "lake", "choice_d": "tree",
         "answer": "A", "question_type_id": 7, "data_source": "SEED-Bench v2",
         "data_id": "a.png", "level": "L1", **common},
        {"question_id": "s1", "question": "order?", "choice_a": "ones", "choice_b": "twos",
         "choice_c": "both", "choice_d": "none", "answer": "B", "question_type_id": 8,
         "data_source": "cc3m", "data_id": ["a.png", "b.png"], "level": "L2", **common},
        {"question_id": "s2", "question": "skip?", "choice_a": "", "choice_b": "",
         "choice_c": "", "choice_d": "", "answer": "C", "question_type_id": 8,
         "data_source": "cc3m", "data_id": "a.png", "level": "L3", **common}]}
    anno_path = tmp_path / "anno.json"
    anno_path.write_text(json.dumps(anno))
    summaries = []

    def run(d, is_jax):
        argv = ["seedbench", "--anno_path", str(anno_path), "--output_dir", str(d),
                "--cc3m_dir", str(img_dir), "--seed_bench_dir", str(img_dir)]
        mod = j_runners if is_jax else bench_runners
        run_seed = mod.run_seedbench
        mod_patch = pytest.MonkeyPatch()
        mod_patch.setattr(mod, "run_seedbench",
                          lambda model, args: summaries.append(run_seed(model, args)))
        try:
            mod.main(argv if is_jax else argv + ["--device", "cpu"])
        finally:
            mod_patch.undo()
        return (d / "results_longva.json").read_text()

    got, ref = _both(tmp_path, run)
    assert got == ref
    assert [json.loads(line)["question_id"] for line in got.splitlines()] == ["s0", "s1"]
    assert summaries[0] == summaries[1] and summaries[0]["count"] == 2


def test_seedbench_scores_match_jax(no_launches, models):
    """`score_choices`' four NLLs (features encoded once) within 1e-4."""
    jm, pm = models
    frames = np.random.default_rng(3).integers(0, 255, (2, 56, 56, 3), np.uint8)
    choices = ["cats", "dogs", "lake", "tree"]
    ref = j_runners.score_choices(jm, frames, "what?", choices)
    got = bench_runners.score_choices(pm, frames, "what?", choices)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_build_model_follows_the_device(monkeypatch):
    """No checkpoint: tiny random weights on the CPU; the card by default,
    which raises when there is none."""
    m = bench_runners.build_model(None, "cpu")
    assert m.dec_cfg == config.DecoderConfig.tiny() and m.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cuda"):
        bench_runners.build_model(None, "cuda")
