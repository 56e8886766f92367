"""The port's judge (`models/textlm`, `eval/`) against the JAX package's, on the CPU.

`TextLM.generate_batch` runs at tiny geometry in float32 with the same
weights in both packages (`convert`) and the byte tokenizer: the token ids
(recorded where each package's facade calls its generation loop) and the
strings are identical under greedy decoding, for the unquantized tree, the
int8 and int4 trees and speculative decode with 4 draft tokens; the rolling
draft corpus keeps the same last 8 outputs. The `eval` copies give the
same prompts, verdicts, shards, byte-equal JSONL files and equal scores as
their originals. On a CPU tensor no wrapper may count a kernel launch.
"""

import dataclasses
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import streamchat_tpu.models.generate as jgen
import streamchat_tpu.models.generate_paged as jgen_paged
from streamchat_tpu import config as jconfig
from streamchat_tpu.eval import judge as jjudge
from streamchat_tpu.eval import scoring as jscoring
from streamchat_tpu.models import decoder as jdec
from streamchat_tpu.models.textlm import TextLM as JTextLM
from streamchat_tpu.models.tokenizer import ByteTokenizer as JByteTokenizer
from streamchat_tpu.utils.prng import KeySeq
from streamchat_tpu_torch import config, convert, kernels
from streamchat_tpu_torch.eval import judge, scoring
from streamchat_tpu_torch.models import generate, textlm
from streamchat_tpu_torch.models.textlm import TextLM
from streamchat_tpu_torch.models.tokenizer import ByteTokenizer

PROMPTS = ["Question: what is on the table? Answer: a cup",
           "Q: where?",
           "Correct Answer: in the drawer. Predicted Answer: in the kitchen drawer, "
           "behind the plates."]


@pytest.fixture
def no_launches():
    kernels.reset_launch_counts()
    yield
    assert all(v == 0 for v in kernels.launch_counts().values()), \
        "a CPU tensor must run the plain twin, never count a launch"


def _models():
    """Both facades on the same tiny f32 weights."""
    jcfg = jconfig.DecoderConfig.tiny()
    jparams = jdec.init(jax.random.key(0), jcfg, jnp.float32)
    jlm = JTextLM(jparams, jcfg, JByteTokenizer(), KeySeq(0))
    lm = TextLM(convert.to_torch(jax.tree.map(np.asarray, jparams)),
                config.DecoderConfig(**dataclasses.asdict(jcfg)), ByteTokenizer(),
                torch.Generator().manual_seed(0))
    return jlm, lm


def _recorded(monkeypatch, spec: bool) -> dict:
    """Record (tokens, count) where each facade calls its generation loop."""
    seen = {"jax": [], "port": []}

    def wrap(fn, key):
        def recording(*a, **kw):
            toks, count = fn(*a, **kw)
            seen[key].append((np.asarray(toks), np.asarray(count)))
            return toks, count
        return recording

    if spec:
        monkeypatch.setattr(jgen_paged, "generate_paged", wrap(jgen_paged.generate_paged, "jax"))
        monkeypatch.setattr(textlm, "generate_paged", wrap(textlm.generate_paged, "port"))
    else:
        monkeypatch.setattr(jgen, "generate", wrap(jgen.generate, "jax"))
        monkeypatch.setattr(generate, "generate", wrap(generate.generate, "port"))
    return seen


@pytest.mark.parametrize("tree", ["f32", "int8", "int4", "spec4"])
def test_generate_batch_matches_jax(no_launches, monkeypatch, tree):
    jlm, lm = _models()
    if tree in ("int8", "int4"):
        jlm.quantize(bits=int(tree[3]))
        lm.quantize(bits=int(tree[3]))
    if tree == "spec4":
        jlm.spec_tokens = lm.spec_tokens = 4
    seen = _recorded(monkeypatch, spec=tree == "spec4")
    ref = jlm.generate_batch(PROMPTS, max_new_tokens=12)
    out = lm.generate_batch(PROMPTS, max_new_tokens=12)
    assert out == ref
    (jt, jc), (pt, pc) = seen["jax"][0], seen["port"][0]
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_array_equal(pc, jc)
    assert pt.shape == (3, 12) and (pc > 0).all()
    if tree == "spec4":
        assert lm._spec_corpus == jlm._spec_corpus and lm.gen_stats["verify_steps"] > 0
    else:
        assert lm.gen_stats["decode_steps"] == 12


def test_spec_corpus_keeps_the_last_8_outputs(no_launches):
    """Nine one-prompt calls: each output joins the corpus, which keeps the
    last 8, the same as the JAX facade's; a later call drafts from it."""
    jlm, lm = _models()
    jlm.spec_tokens = lm.spec_tokens = 2
    for i in range(9):
        prompt = [f"Q{i}: is it {i}?"]
        assert lm.generate_batch(prompt, max_new_tokens=4) == jlm.generate_batch(
            prompt, max_new_tokens=4)
    assert len(lm._spec_corpus) == 8 and lm._spec_corpus == jlm._spec_corpus
    look = lm._spec_lookup([[1, 2]])
    assert look["lookup_len"].tolist() == [2 + sum(len(o) for o in lm._spec_corpus)]


def test_generate_batch_refuses_a_bare_str():
    _, lm = _models()
    with pytest.raises(TypeError, match="bare str"):
        lm.generate_batch("one prompt")
    assert lm.generate_batch([]) == []


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _llama_dir(path):
    """A tiny LLaMA checkpoint (no qkv bias, an untied head) written in the
    HF layout by the smoke's writer -> (its TextLM, the path)."""
    smoke = _smoke()
    cfg = dataclasses.replace(config.DecoderConfig.tiny(), qkv_bias=False)
    lm = TextLM.init_random(cfg, seed=3, device="cpu", dtype=torch.float32)
    smoke.write_checkpoint(str(path), smoke.llama3_config(cfg), smoke.hf_decoder(lm.params))
    return lm, str(path)


def test_unported_entry_points_name_their_roadmap_items(no_launches, tmp_path):
    """`from_pretrained` loads (the tiny LLaMA written in the HF layout comes
    back leaf for leaf and generates the same tokens; a missing directory
    raises); `shard` still names its ROADMAP item."""
    written, path = _llama_dir(tmp_path / "llama3")
    lm = TextLM.from_pretrained(path, torch.float32, device="cpu", tokenizer=ByteTokenizer())
    assert lm.cfg == dataclasses.replace(written.cfg, eos_token_id=128001, pad_token_id=0)
    got = jax.tree_util.tree_leaves(lm.params)
    ref = jax.tree_util.tree_leaves(written.params)
    assert len(got) == len(ref) and all(torch.equal(a, b) for a, b in zip(got, ref))
    assert lm.generate_batch(PROMPTS, max_new_tokens=6) == written.generate_batch(
        PROMPTS, max_new_tokens=6)
    with pytest.raises(FileNotFoundError):
        TextLM.from_pretrained(str(tmp_path / "absent"), device="cpu")
    assert lm.shard() is lm and "tp" not in lm.params      # no process group: a world of one


# ---------------------------------------------------------------------------
# The eval copies
# ---------------------------------------------------------------------------

PREDICTIONS = [
    {"question": "What is on the table?", "label": "a cup", "predict": "A cup of tea.",
     "class": "object", "process_time": 1.5},
    {"question": "Where are the keys?", "label": "in the drawer", "predict": "drawer",
     "class": "location"},
    {"question": "Who came in?", "label": "a man", "predict": "nobody", "class": "person",
     "process_time": 0.25},
    {"question": "Is it \"raining\"?", "label": "no", "predict": "yes, heavily",
     "class": "object"},
]
VERDICTS = ["{'llama_pred': 'yes', 'score': 4}", "Sure! {'llama_pred': 'no', 'score': 1}",
            "no verdict here", "{'a': 1} then {'llama_pred': 'yes', 'score': 5}"]


@pytest.mark.parametrize("question,answer,prediction", [
    ("What is on the table?", "a cup", "A cup."), ("", "", ""),
    ("Q with {braces}", "ü", "line\nbreak")])
def test_build_judge_prompt_equal(question, answer, prediction):
    assert judge.build_judge_prompt(question, answer, prediction) == \
        jjudge.build_judge_prompt(question, answer, prediction)


@pytest.mark.parametrize("text", VERDICTS + ["{'llama_pred': 'yes', 'score': 4.8}", "{", "",
                                             "{oops: 1} {'score': 3}"])
def test_parse_judge_output_equal(text):
    assert judge.parse_judge_output(text) == jjudge.parse_judge_output(text)


@pytest.mark.parametrize("n,num_chunks,chunk_idx", [(10, 3, 0), (10, 3, 2), (10, 3, 5),
                                                    (0, 2, 0), (7, 7, 6), (5, 8, 4)])
def test_get_chunk_equal(n, num_chunks, chunk_idx):
    lst = list(range(n))
    assert judge.get_chunk(lst, num_chunks, chunk_idx) == jjudge.get_chunk(lst, num_chunks,
                                                                         chunk_idx)


@pytest.mark.parametrize("batch_size,fmt,num_chunks,chunk_idx", [
    (1, "ours", 1, 0), (3, "ours", 1, 0), (8, "ours", 2, 1), (2, "generic", 1, 0)])
def test_judge_predictions_byte_equal_jsonl(tmp_path, batch_size, fmt, num_chunks, chunk_idx):
    """A stub judge answers each prompt by its position: the JSONL files and
    the returned records are equal, unparseable rows marked alike."""
    preds = PREDICTIONS if fmt == "ours" else [
        {"question": p["question"], "answer": p["label"], "pred": p["predict"]}
        for p in PREDICTIONS]

    def stub():
        calls = iter(range(100))

        def one(prompt):
            assert isinstance(prompt, str)
            return VERDICTS[next(calls) % len(VERDICTS)]

        def many(prompts):
            return [one(p) for p in prompts]
        return many if batch_size > 1 else one

    outs = {}
    for name, mod in (("port", judge), ("jax", jjudge)):
        path = tmp_path / f"{name}.jsonl"
        outs[name] = mod.judge_predictions(preds, stub(), output_path=str(path),
                                           num_chunks=num_chunks, chunk_idx=chunk_idx,
                                           fmt=fmt, batch_size=batch_size)
    assert outs["port"] == outs["jax"] and outs["port"]
    assert (tmp_path / "port.jsonl").read_bytes() == (tmp_path / "jax.jsonl").read_bytes()


RESULTS = [
    {"llama_pred": "yes", "score": 4, "class": "object", "process_time": 1.0},
    {"llama_pred": "no", "score": 1, "class": "location"},
    {"judge_parse_error": True, "class": "object"},
    {"llama_pred": "Yes", "score": "5", "class": "object", "process_time": 3.0},
    {"llama_pred": "maybe", "score": 2, "class": None},
    {"score": 3},
    {"llama_pred": "no", "score": "bad"},
]


@pytest.mark.parametrize("rows", [slice(None), slice(0, 0), slice(2, 3), slice(1, 5)],
                         ids=["all", "none", "unparseable", "middle"])
def test_scores_equal(rows):
    results = RESULTS[rows]
    assert scoring.aggregate_scores(results) == jscoring.aggregate_scores(results)
    assert scoring.per_class_breakdown(results) == jscoring.per_class_breakdown(results)


def test_scoring_main_equal(tmp_path, capsys):
    """The same <name>_res.json bytes and the same printed JSON."""
    printed = {}
    for name, mod in (("port", scoring), ("jax", jscoring)):
        d = tmp_path / name
        d.mkdir()
        (d / "judged.jsonl").write_text("".join(json.dumps(r) + "\n" for r in RESULTS) + "\n")
        mod.main(["--output_dir", str(d), "--output_name", "judged"])
        printed[name] = capsys.readouterr().out
    assert printed["port"] == printed["jax"] and json.loads(printed["port"])["Yes count"] == 2
    assert (tmp_path / "port" / "judged_res.json").read_bytes() == \
        (tmp_path / "jax" / "judged_res.json").read_bytes()


def test_judge_cli_on_the_cpu(no_launches, tmp_path, monkeypatch):
    """`python -m streamchat_tpu_torch.eval.judge --device cpu` judges every
    prediction with random tiny weights, and with `--llama3_path` from a
    tiny LLaMA checkpoint (its tokenizer swapped for the byte tokenizer);
    the default device, the card, raises where there is none."""
    pred_file = tmp_path / "preds.json"
    pred_file.write_text(json.dumps(PREDICTIONS[:3]))
    argv = ["--predict_file", str(pred_file), "--output_dir", str(tmp_path / "out"),
            "--output_name", "judged", "--batch_size", "2", "--device", "cpu"]
    judge.main(argv)
    rows = scoring.read_jsonl(str(tmp_path / "out" / "judged.jsonl"))
    assert [r["question"] for r in rows] == [p["question"] for p in PREDICTIONS[:3]]
    assert all("score" in r or r.get("judge_parse_error") for r in rows)
    _, path = _llama_dir(tmp_path / "llama3")
    monkeypatch.setattr(textlm, "load_tokenizer", lambda _: ByteTokenizer())
    judge.main(argv[:-6] + ["--output_name", "loaded", "--batch_size", "2", "--device", "cpu",
                            "--llama3_path", path])
    loaded = scoring.read_jsonl(str(tmp_path / "out" / "loaded.jsonl"))
    assert [r["question"] for r in loaded] == [r["question"] for r in rows]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        judge.main(argv[:-2])


def test_get_logger_copy_formats_as_the_original():
    from streamchat_tpu.utils import logging as jlogging
    from streamchat_tpu_torch.utils import logging as plogging

    port, ref = plogging.get_logger("judge"), jlogging.get_logger("judge")
    assert port is ref                      # one stdlib logger by name in both
    roots = [__import__("logging").getLogger(n) for n in ("streamchat_tpu_torch",
                                                          "streamchat_tpu")]
    assert all(len(r.handlers) == 1 and not r.propagate for r in roots)
    fmts = [r.handlers[0].formatter for r in roots]
    assert fmts[0]._fmt == fmts[1]._fmt and fmts[0].datefmt == fmts[1].datefmt
    plogging.get_logger()
    assert len(roots[0].handlers) == 1      # configured once
