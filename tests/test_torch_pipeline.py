"""The port's off-line pipeline against the JAX package's, end to end.

Slice parity: both packages run `process_video` at tiny geometry from the
same converted float32 weights, greedy, with settings under which nothing
draws random numbers (short_window == remember_window, chunk_size <=
num_clusters, fewer than `interval` tree nodes), and their result records
must agree field by field: with bf16-free float32 weights, and with each
package quantizing its own copy to int8, to int4, and to int4 with int8 KV
pages. Also: the port imports and runs with jax and the JAX package
blocked (off-line, then on-line with dedup, then off-line with the
uni-modal answer and --ppl), every CLI option that is not ported raises,
`--mode on_line`, `--literal_kmeans`, `--save_tree_dir`, `--ppl`, the
uni-modal answer (no `--multi_modal_memory`) and `--compress_rate 2` run
through `main` at tiny geometry, and the CLI's weight storage flags
quantize the model as the JAX `main` does.
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import streamchat_tpu.models.generate_paged as j_generate_paged
from streamchat_tpu import config as jconfig
from streamchat_tpu.memory.bank import MemoryBank as JBank
from streamchat_tpu.models.embedder import TextEmbedder as JEmbedder
from streamchat_tpu.models.longva import LongVA as JLongVA
from streamchat_tpu.pipeline.runner import StreamChatPipeline as JPipeline
from streamchat_tpu.video.reader import SyntheticVideoReader
from streamchat_tpu_torch import config, convert
from streamchat_tpu_torch.memory.bank import MemoryBank
from streamchat_tpu_torch.memory.tree import VisualMemoryTree
from streamchat_tpu_torch.models import longva as port_longva
from streamchat_tpu_torch.models.embedder import TextEmbedder
from streamchat_tpu_torch.models.longva import LongVA
from streamchat_tpu_torch.models.tokenizer import ByteTokenizer
from streamchat_tpu_torch.pipeline import runner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfg(jcfg, cls):
    return cls(**dataclasses.asdict(jcfg))


def _pipelines(bits=None, kv_int8=False):
    """Both pipelines on the same weights; bits 8 / 4 quantizes each
    package's decoder with its own `LongVA.quantize`."""
    dcfg = jconfig.DecoderConfig.tiny()
    k1, k2, k3 = jax.random.split(jax.random.key(0), 3)
    jm = JLongVA.init_random(k1, jconfig.ViTConfig.tiny(projection_dim=dcfg.hidden_size),
                             dcfg, dtype=jnp.float32)
    jtree = JEmbedder.init_random(k2, jconfig.BertConfig.tiny())
    jbank = JEmbedder.init_random(
        k3, dataclasses.replace(jconfig.BertConfig.tiny(), pooling="mean"))
    jcfg = jconfig.PipelineConfig(
        memory=jconfig.MemoryConfig(chunk_size=5, num_clusters=5, interval=10,
                                    short_window=5, remember_window=5),
        sampling=jconfig.SamplingConfig(temperature=0.0, caption_temperature=0.0,
                                        max_answer_tokens=8, max_caption_tokens=6,
                                        max_summary_tokens=6))
    jp = JPipeline(jm, jtree, jbank, jcfg)

    model = LongVA(
        vit_params=convert.vit_params(_np(jm.vit_params)),
        proj_params=convert.to_torch(_np(jm.proj_params)),
        dec_params=convert.to_torch(_np(jm.dec_params)),
        vit_cfg=_cfg(jm.vit_cfg, config.ViTConfig), dec_cfg=_cfg(dcfg, config.DecoderConfig),
        tokenizer=ByteTokenizer(), generator=torch.Generator().manual_seed(0))

    def emb(j):
        return TextEmbedder(convert.to_torch(_np(j.params)), _cfg(j.cfg, config.BertConfig),
                            ByteTokenizer(), max_length=j.max_length)

    pcfg = config.PipelineConfig(
        memory=_cfg(jcfg.memory, config.MemoryConfig),
        sampling=_cfg(jcfg.sampling, config.SamplingConfig))
    if bits is not None:
        jm.quantize(bits=bits)
        model.quantize(bits=bits)
    jm.kv_int8 = model.kv_int8 = kv_int8
    return jp, runner.StreamChatPipeline(model, emb(jtree), emb(jbank), pcfg)


BREAKPOINTS = [
    {"question": "What do I see?", "answer": "a room", "class": "scene", "time": 1},
    {"question": "What is on the table?", "answer": "a cup", "class": "object", "time": 3},
    {"question": "What changed?", "answer": "nothing", "class": "change", "time": 5},
]


def _recording(fn, sink):
    def wrapped(*args, **kwargs):
        toks, count = fn(*args, **kwargs)[:2]
        sink.append(np.asarray(toks)[0, : int(np.asarray(count)[0])].tolist())
        return toks, count
    return wrapped


@pytest.mark.parametrize("bits,kv_int8", [(None, False), (8, False), (4, False), (4, True)],
                         ids=["f32", "int8", "int4", "int4-kv_int8"])
def test_slice_parity_with_jax_pipeline(tmp_path, monkeypatch, bits, kv_int8):
    jp, pp = _pipelines(bits, kv_int8)
    jtoks, ptoks = [], []
    monkeypatch.setattr(j_generate_paged, "generate_paged_fetch",
                        _recording(j_generate_paged.generate_paged_fetch, jtoks))
    monkeypatch.setattr(port_longva, "generate_paged",
                        _recording(port_longva.generate_paged, ptoks))
    jres = jp.process_video(
        SyntheticVideoReader(total_frames=150, frame_rate=30, height=56, width=56),
        BREAKPOINTS, JBank(str(tmp_path / "j.json"), lambda t: jp.bank_embedder.embed(t)),
        user_name="User")
    pres = pp.process_video(
        SyntheticVideoReader(total_frames=150, frame_rate=30, height=56, width=56),
        BREAKPOINTS, MemoryBank(str(tmp_path / "p.json"), pp.bank_embed), user_name="User")
    assert len(pres) == len(jres) == len(BREAKPOINTS)
    # Every caption and answer, token for token (decoded text can hide a
    # difference: undecodable bytes all print as U+FFFD).
    assert len(ptoks) == len(jtoks) == 11 and ptoks == jtoks
    assert sum(map(len, ptoks)) > 0
    for p, j in zip(pres, jres):
        assert set(p) == set(j)
        for field in ("time", "question", "label", "predict", "class"):
            assert p[field] == j[field], field
    assert [n.text for n in pp.last_tree.roots] == [n.text for n in jp.last_tree.roots]
    assert len(pp.last_tree) == len(jp.last_tree) == 8
    for pn, jn in zip(pp.last_tree.roots, jp.last_tree.roots):
        np.testing.assert_allclose(pn.centroids.numpy(), np.asarray(jn.centroids),
                                   atol=1e-4, rtol=0)
    assert set(pp.last_phase_totals) >= {"ingest", "memory_update", "caption", "answer"}


def test_port_runs_with_jax_blocked(tmp_path):
    """The port imports neither jax nor the JAX package, and a tiny
    process_video, then process_video_online with dedup, run on the CPU
    without them."""
    code = textwrap.dedent(f"""
        import dataclasses
        import sys
        sys.modules["jax"] = None
        sys.modules["streamchat_tpu"] = None
        import torch
        from streamchat_tpu_torch.config import MemoryConfig, PipelineConfig, SamplingConfig
        from streamchat_tpu_torch.memory.bank import MemoryBank
        from streamchat_tpu_torch.pipeline.runner import build_pipeline
        from streamchat_tpu_torch.video.reader import SyntheticVideoReader
        cfg = PipelineConfig(
            memory=MemoryConfig(chunk_size=4, num_clusters=2, interval=3,
                                short_window=6, remember_window=3),
            sampling=SamplingConfig(max_answer_tokens=4, max_caption_tokens=4,
                                    max_summary_tokens=4))
        pipe = build_pipeline(cfg, device="cpu", geometry="tiny", dtype=torch.float32)
        bank = MemoryBank({str(tmp_path / "m.json")!r}, pipe.bank_embed)
        reader = SyntheticVideoReader(total_frames=150, frame_rate=30, height=56, width=56)
        bps = [{{"question": "q1", "time": 2}}, {{"question": "q2", "time": 5}}]
        res = pipe.process_video(reader, bps, bank, "User")
        assert len(res) == 2 and len(pipe.last_tree) > 0
        # On-line with dedup, the threshold at the median 1 - cos score of the
        # first segment so that K12's twin drops frames and keeps others.
        from streamchat_tpu_torch.ops.dedup import frame_descriptors, select_changed_frames
        from streamchat_tpu_torch.pipeline import runner
        from streamchat_tpu_torch.pipeline.ingest import encode_segment
        feats = encode_segment(pipe.model, reader, 0, 2, pipe.cfg.video, 4)
        _, sim = select_changed_frames(frame_descriptors(feats), return_similarity=True)
        thr = float((1 - sim[1:]).median())
        pipe.cfg = pipe.cfg.replace(video=dataclasses.replace(pipe.cfg.video,
                                                              dedup_threshold=thr))
        seen = []
        dedup = runner.dedup_segment
        runner.dedup_segment = lambda f, t: seen.append((len(f), len(dedup(f, t)))) or dedup(f, t)
        res = pipe.process_video_online(reader, bps, bank, "User")
        assert len(res) == 2 and len(pipe.last_tree) > 0
        assert any(k < n for n, k in seen) and all(k > 0 for n, k in seen), seen
        # Off-line with the uni-modal answer and --ppl.
        pipe.cfg = pipe.cfg.replace(
            multi_modal_memory=False, ppl=True,
            sampling=dataclasses.replace(pipe.cfg.sampling, max_answer_tokens_unimodal=4))
        bps = [dict(b, answer="a cup") for b in bps]
        res = pipe.process_video(reader, bps, bank, "User")
        assert len(res) == 2 and all(r["nll"] > 0 and r["ppl"] > 1 for r in res), res
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("OK")


BASE = ["--video_dir", "v", "--memory_basic_dir", "m", "--save_file", "s.json",
        "--annotations", "a.json", "--multi_modal_memory"]


@pytest.mark.parametrize("flags", [
    ["--bf16", "--shard"],
    ["--bf16", "--offload_chunks"], ["--bf16", "--offload_residents"],
    ["--bf16", "--ppl"],
])
def test_unported_cli_options_raise(flags):
    """No option is left unported: --shard, --ppl and the offload flags,
    once among them, parse into the PipelineConfig (--shard is `main`'s:
    `tests/test_torch_parallel.py` runs it) and `_NOT_PORTED` is gone."""
    args = runner.parse_args(BASE + flags)
    cfg = runner.config_from_args(args)
    assert cfg.multi_modal_memory and args.shard is ("--shard" in flags)
    assert cfg.ppl is ("--ppl" in flags)
    assert cfg.memory.offload_chunks is ("--offload_chunks" in flags)
    assert cfg.memory.offload_residents is ("--offload_residents" in flags)
    assert not hasattr(runner, "_NOT_PORTED")


def _cli_run(tmp_path, monkeypatch, flags, multi_modal=True):
    """`main` over a one-video annotation file at tiny geometry on the CPU
    (the synthetic reader in place of the codec, 4-token generations), with
    `--multi_modal_memory` unless multi_modal is False -> (the pipeline it
    built, the saved results)."""
    (tmp_path / "videos" / "cls").mkdir(parents=True)
    (tmp_path / "videos" / "cls" / "v.mp4").write_bytes(b"")
    anno = [{"info": {"video_path": "v.mp4", "class_1": "cls"},
             "breakpoint": [{"question": "What do I see?", "answer": "a", "class": "c",
                             "time": 2},
                            {"question": "What changed?", "answer": "b", "class": "c",
                             "time": 5}]}]
    (tmp_path / "a.json").write_text(json.dumps(anno))
    built, config_from_args, build = [], runner.config_from_args, runner.build_pipeline

    def short(args):
        cfg = config_from_args(args)
        return cfg.replace(sampling=dataclasses.replace(
            cfg.sampling, max_answer_tokens=4, max_answer_tokens_unimodal=4,
            max_caption_tokens=4, max_summary_tokens=4))

    def recording_build(*a, **kw):
        built.append(build(*a, **kw))
        return built[-1]

    monkeypatch.setattr(runner, "config_from_args", short)
    monkeypatch.setattr(runner, "build_pipeline", recording_build)
    monkeypatch.setattr(runner, "open_video", lambda path: SyntheticVideoReader(
        total_frames=150, frame_rate=30, height=56, width=56))
    runner.main(["--video_dir", str(tmp_path / "videos"), "--memory_basic_dir",
                 str(tmp_path / "m"), "--save_file", str(tmp_path / "s.json"),
                 "--annotations", str(tmp_path / "a.json"), "--device", "cpu",
                 "--geometry", "tiny", "--bf16", "--chunk_size", "4", "--num_clusters", "2",
                 "--interval", "3"] + (["--multi_modal_memory"] if multi_modal else []) + flags)
    return built[0], json.loads((tmp_path / "s.json").read_text())


@pytest.mark.parametrize("flags", [
    ["--mode", "on_line"], ["--literal_kmeans"], ["--save_tree_dir", "TREES"],
    ["--mode", "on_line", "--literal_kmeans", "--save_tree_dir", "TREES"],
])
def test_online_cli_flags_run_on_cpu(tmp_path, monkeypatch, flags):
    """--mode on_line, --literal_kmeans and --save_tree_dir parse and run:
    two answers per video, the tree pickled per video when asked, and under
    --literal_kmeans every node keeps its raw chunk."""
    flags = [str(tmp_path / "trees") if f == "TREES" else f for f in flags]
    calls = []
    for name in ("process_video", "process_video_online"):
        fn = getattr(runner.StreamChatPipeline, name)
        monkeypatch.setattr(runner.StreamChatPipeline, name,
                            lambda self, *a, _fn=fn, _n=name, **kw:
                            calls.append(_n) or _fn(self, *a, **kw))
    pipe, saved = _cli_run(tmp_path, monkeypatch, flags)
    assert calls == ["process_video_online" if "on_line" in flags else "process_video"]
    assert [r["time"] for r in saved] == [2, 5] and all(isinstance(r["predict"], str)
                                                        for r in saved)
    literal = "--literal_kmeans" in flags
    assert pipe.cluster_full_chunks is not literal
    if literal:
        assert all(n.centroids.shape[0] in (1, 2, 3, 4) for n in pipe.last_tree.all_nodes())
        assert max(n.centroids.shape[0] for n in pipe.last_tree.all_nodes()) > 2
    if "--save_tree_dir" in flags:
        with open(tmp_path / "trees" / "tree_0.pkl", "rb") as f:
            state = pickle.load(f)
        back = VisualMemoryTree.from_state(state, 2, 3, None, None, None)
        assert [n.text for n in back.all_nodes()] == [n.text for n in pipe.last_tree.all_nodes()]
        for a, b in zip(back.all_nodes(), pipe.last_tree.all_nodes()):
            assert torch.equal(a.centroids, b.centroids)
    else:
        assert not (tmp_path / "trees").exists()


def test_cli_compress_rate_still_raises(tmp_path, monkeypatch):
    """--compress_rate 2, which raised before spatial pooling was ported,
    runs: every tree node and the answers' short memory hold the tiny
    tower's 4 x 4 patch grid pooled to 2 x 2."""
    shorts = []
    answer = runner.answer_question

    def recording(question, model, embed_query, short_memory, *a, **kw):
        shorts.append(tuple(short_memory.shape[1:]))
        return answer(question, model, embed_query, short_memory, *a, **kw)

    monkeypatch.setattr(runner, "answer_question", recording)
    pipe, saved = _cli_run(tmp_path, monkeypatch, ["--compress_rate", "2"])
    assert pipe.cfg.memory.compress_rate == 2 and len(saved) == 2
    assert {n.centroids.shape[1] for n in pipe.last_tree.all_nodes()} == {4}
    assert shorts == [(4, 128)] * 2 and "nll" not in saved[0]


@pytest.mark.parametrize("flags,multi_modal", [
    (["--ppl"], True), ([], False), (["--ppl"], False),
    (["--ppl", "--mode", "on_line"], False), (["--ppl", "--compress_rate", "2"], False),
], ids=["ppl", "unimodal", "unimodal-ppl", "unimodal-ppl-on_line", "unimodal-ppl-compress2"])
def test_cli_answer_options_run_on_cpu(tmp_path, monkeypatch, flags, multi_modal):
    """`main` without --multi_modal_memory (the CLI's default) answers
    uni-modally, --ppl saves the ground-truth answer's nll / ppl in every
    record, and both combine with --mode on_line and --compress_rate 2."""
    answers = []
    for name in ("answer_question", "answer_question_unimodal"):
        fn = getattr(runner, name)
        monkeypatch.setattr(runner, name, lambda *a, _fn=fn, _n=name, **kw:
                            answers.append((_n, kw.get("ppl_target"))) or _fn(*a, **kw))
    pipe, saved = _cli_run(tmp_path, monkeypatch, flags, multi_modal=multi_modal)
    ppl = "--ppl" in flags
    name = "answer_question" if multi_modal else "answer_question_unimodal"
    assert answers == [(name, "a" if ppl else None), (name, "b" if ppl else None)]
    assert pipe.cfg.multi_modal_memory is multi_modal and pipe.cfg.ppl is ppl
    assert len(saved) == 2
    for r in saved:
        assert ({"nll", "ppl"} <= set(r)) is ppl
        if ppl:
            assert r["nll"] > 0 and np.isclose(r["ppl"], np.exp(r["nll"]), rtol=1e-5)


@pytest.mark.parametrize("flags,key", [
    ([], "w_i8"),                         # --int8 is the CLI default
    (["--int8"], "w_i8"), (["--int4"], "w_i4p"),
])
def test_cli_weight_storage_flags_quantize(monkeypatch, flags, key):
    """--int8 (the default) and --int4 parse and `main` quantizes the built
    model to that storage, as the JAX `main` does; the lm_head stays int8."""
    built = []

    def tiny(cfg, *, device, geometry, dtype):
        built.append(runner.StreamChatPipeline.__new__(runner.StreamChatPipeline))
        built[0].model = LongVA.init_random(
            config.ViTConfig.tiny(projection_dim=128), config.DecoderConfig.tiny(),
            device=device, dtype=torch.float32)
        built[0].last_phase_totals = {}
        return built[0]

    monkeypatch.setattr(runner, "build_pipeline", tiny)
    monkeypatch.setattr(runner, "run_inference", lambda pipe, args: None)
    runner.main(BASE + flags + ["--device", "cpu", "--geometry", "tiny"])
    params = built[0].model.dec_params
    for layer in params["layers"]:
        for p in (*layer["attn"].values(), *layer["mlp"].values()):
            assert p[key].dtype == torch.int8 and "w" not in p
    assert params["lm_head"]["w_i8"].dtype == torch.int8


@pytest.mark.parametrize("change", [
    dict(paths=config.ModelPaths(longva="/nonexistent/longva")),
    dict(multi_modal_memory=False),
])
def test_unported_pipeline_settings_raise(monkeypatch, change):
    """A checkpoint path that does not exist raises FileNotFoundError (no
    fallback to random weights), as the JAX loader's config read does.
    multi_modal_memory=False, which raised before the uni-modal answer was
    ported, now builds a pipeline that answers uni-modally."""
    cfg = config.PipelineConfig(**change)
    if "paths" in change:
        with pytest.raises(FileNotFoundError, match="config.json"):
            runner.build_pipeline(cfg, device="cpu", geometry="tiny", dtype=torch.float32)
        return
    pipe = runner.build_pipeline(cfg, device="cpu", geometry="tiny", dtype=torch.float32)
    assert pipe.cfg.multi_modal_memory is False
    called = []
    monkeypatch.setattr(runner, "answer_question_unimodal",
                        lambda *a, **kw: called.append(kw) or "answer")
    assert pipe._answer({"question": "q", "answer": "a"}, None, None, None) == "answer"
    assert called == [{"ppl_target": None}]


def test_cli_refuses_without_cuda_by_default(monkeypatch):
    """The CLI runs on the card unless a CPU run is asked for: with no card
    it raises before it builds a model, and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(runner, "build_pipeline", lambda *a, **k: pytest.fail("built"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.main(BASE + ["--bf16"])
    args = runner.parse_args(BASE + ["--bf16"])
    assert (args.device, args.geometry) == ("cuda", "longva7b")
