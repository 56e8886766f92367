"""Cross-benchmark LongVA baseline runners: ActivityNet-QA-style open-ended
video QA, Video-Bench multiple-choice, and SEED-Bench v2 PPL ranking
(`streamchat_tpu/pipeline/bench_runners.py`).

These are the reference's own-model (LongVA-family) baseline scripts —
the rows the paper's comparison tables that ARE ours to port (the other
model families under `test_other_models/` are vendored third-party trees,
SURVEY.md §2.5 [vendored-baseline]):

* ``videoqa`` — `test_other_models/act/inference_act_longva.py`:
  open-ended QA over {video_name, question, answer, question_id} samples;
  `num_frame` frames uniform over the whole video, `v_{name}{fmt}` path
  resolution (:189-191), `<image>\\n`+question through the qwen_1_5
  template (:66-76), sampling temperature 0.1 / max_new_tokens 256
  (:89-98), JSONL rows {id, question, answer, pred} (:184,197,201),
  contiguous ceil-split sharding (:23-31).
* ``videobench`` — `test_other_models/video_bench/
  inference_video_bench_longva.py`: 13 sub-dataset QA dicts; the
  choice-count-dependent "Among the N options ... closest to the correct
  answer is:" question suffixes kept VERBATIM (:162-183 — the prompt is
  the benchmark protocol, quirks included: the 6-choice branch glues
  "Choices:" straight onto the question and each branch's trailing
  whitespace differs); per-dataset output `{name}_eval.json` mapping
  q_id -> {video_id, question, output_sequence} (:192-215).
  `videoqa` rows feed `eval/judge.py --format generic` (the reference
  judges them with `eval_video_qa_with_llama3_others.py`) and then
  `eval/scoring.py` — the same 3-stage chain as StreamBench.
* ``seedbench`` — `test_other_models/seed_bench/
  inference_seed_bench_v2_longva.py`: filter by cumulative level /
  subpart / cumulative version (:41-69), strip ``<img>`` from the
  question (:88-89), rank the four choices by teacher-forced loss and
  take argmin (:181-184), JSONL records {question_id, prediction, gt,
  q_type_id} appended to `results_longva.json` (:156,186-194), per-type
  accuracy aggregation (:199-218).

Deliberate deviations (each a documented reference bug / TPU win):

* The reference's SEED scoring never feeds the candidate to the model:
  it masks the last `len(tokenizer(cand))` tokens of the PROMPT-ONLY
  input_ids (:113-133), so choices are distinguished only by their token
  count. We score the stated intent — teacher-forced NLL of the
  candidate as a continuation of the spliced prompt
  (`LongVA.score_with_image_embedding`, the same `forward_with_fix_
  embedding` twin the reference built for PPL scoring).
* The reference re-preprocesses and re-encodes the images once PER
  CHOICE (:99-130, 4x the vision-tower cost); we encode once per item
  and reuse the features across all four scores.
* The reference's accuracy loop KeyErrors on any question type with zero
  correct answers (`correct_counts[data_type]`, :213); ours defaults 0.

The CLI adds `--device` (the card unless the CPU is asked for); with no
`--model_name` the random LongVA is tiny on the CPU, as the JAX CLI's, and
LongVA-7B wide on the card (`build_model`: the card's kernels do not take
the tiny geometry's head dim). Frames go through K1 / K2, prompts through
K3 (K5 past 8,192 tokens), decode K4; seedbench's scores are one K3 pass
a layer each (`LongVA.score_with_image_embedding`).
"""

from __future__ import annotations

import argparse
import json
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from streamchat_tpu_torch.models.tokenizer import DEFAULT_IMAGE_TOKEN
from streamchat_tpu_torch.pipeline import prompts
from streamchat_tpu_torch.pipeline.baseline import uniform_indices
from streamchat_tpu_torch.pipeline.preprocess import preprocess_frames
from streamchat_tpu_torch.utils.logging import get_logger
from streamchat_tpu_torch.video.reader import open_video

log = get_logger("bench_runners")

VIDEO_FORMATS = (".mp4", ".webm", ".mkv")   # reference act:160

# The 13 Video-Bench sub-datasets (reference video_bench:129-143; QA files
# live at {eval_qa_root}/Eval_QA/{name}_QA_new.json).
VIDEOBENCH_DATASETS = (
    "Ucfcrime", "Youcook2", "TVQA", "MSVD", "MSRVTT",
    "Driving-decision-making", "NBA", "SQA3D", "Driving-exam",
    "MV", "MOT", "ActivityNet", "TGIF",
)

SEED_SUBPARTS = (
    "Single-Image & Text Comprehension",
    "Multiple-Images & Text Comprehension",
    "Video & Text Comprehension",
    "Interleaved Image & Text Comprehension",
    "Image Generation",
    "Image & Text Generation",
)


def contiguous_chunk(lst: List, n: int, k: int) -> List:
    """Reference get_chunk: contiguous ceil-split (act:23-31)."""
    size = math.ceil(len(lst) / n)
    return lst[k * size : (k + 1) * size]


def resolve_video_path(video_dir: str, video_name: str,
                       prefix: str = "v_") -> Optional[str]:
    """First existing `{prefix}{video_name}{fmt}` (reference act:189-191)."""
    for fmt in VIDEO_FORMATS:
        path = os.path.join(video_dir, f"{prefix}{video_name}{fmt}")
        if os.path.exists(path):
            return path
    return None


def _encode_frames(model, frames: np.ndarray) -> torch.Tensor:
    """uint8 RGB frames -> flat [N*P, D] projected visual features."""
    pixels = preprocess_frames(frames, model.vit_cfg.image_size, device=model.device)
    feats = model.encode_images(pixels)
    return feats.reshape(-1, feats.shape[-1])


def generate_uniform(
    model, frames: np.ndarray, question: str, *,
    conv_mode: str = "qwen_1_5", temperature: float = 0.1,
    max_new_tokens: int = 256,
) -> str:
    """One no-memory answer over the given frames (reference
    get_model_output, act:64-111: `<image>\\n`+question, qwen_1_5)."""
    flat = _encode_frames(model, frames)
    prompt = prompts.wrap_user_turn(
        conv_mode, DEFAULT_IMAGE_TOKEN + "\n" + question
    )
    return model.generate_with_image_embedding(
        prompt, [flat], max_new_tokens=max_new_tokens, temperature=temperature
    )


def _read_uniform(video_path: str, num_frame: int) -> np.ndarray:
    reader = open_video(video_path)
    try:
        idx = uniform_indices(reader.total_frames, num_frame)
        return reader.read_frames(idx)
    finally:
        reader.close()


# ---------------------------------------------------------------- videoqa


def run_videoqa(model, args) -> List[dict]:
    """ActivityNet-QA-style open-ended eval (reference act:114-204)."""
    with open(args.gt_file_question, encoding="utf-8") as f:
        gt_questions = json.load(f)
    gt_questions = contiguous_chunk(gt_questions, args.num_chunks, args.chunk_idx)
    os.makedirs(args.output_dir, exist_ok=True)
    out_path = os.path.join(args.output_dir, f"{args.output_name}.json")
    rows: List[dict] = []
    with open(out_path, "w", encoding="utf-8") as ans_file:
        for sample in gt_questions:
            video_path = resolve_video_path(
                args.video_dir, sample["video_name"], args.video_prefix
            )
            if video_path is None:
                log.error("missing video: %s", sample["video_name"])
                continue
            frames = _read_uniform(video_path, args.num_frame)
            pred = generate_uniform(
                model, frames, sample["question"],
                temperature=args.temperature,
                max_new_tokens=args.max_new_tokens,
            )
            # Reference sample_set key order (act:184,197).
            row = {
                "id": sample["question_id"],
                "question": sample["question"],
                "answer": sample.get("answer"),
                "pred": pred,
            }
            rows.append(row)
            ans_file.write(json.dumps(row) + "\n")
            ans_file.flush()
    return rows


# ------------------------------------------------------------- videobench


def format_mc_question(question: str, choices: Dict[str, str]) -> Tuple[str, List[str]]:
    """Append the Video-Bench choice block (reference video_bench:162-183,
    VERBATIM per choice count — spacing quirks are part of the protocol).

    Returns (formatted question, candidate letters).
    """
    c = choices
    n = len(c)
    if n == 6:
        question += (
            f"Choices: A.{c['A']} B.{c['B']} C.{c['C']} D.{c['D']} "
            f"E.{c['E']} F.{c['F']} \n Among the six options A, B, C, D, E, F "
            "above, the one closest to the correct answer is:"
        )
        candidates = ["A", "B", "C", "D", "E", "F"]
    elif n == 5:
        question += (
            f" A.{c['A']} B.{c['B']} C.{c['C']} D.{c['D']} E.{c['E']} \n "
            "Among the five options A, B, C, D, E above, the one closest "
            "to the correct answer is: "
        )
        candidates = ["A", "B", "C", "D", "E"]
    elif n == 4:
        question += (
            f" A.{c['A']} B.{c['B']} C.{c['C']} D.{c['D']} \n "
            "Among the four options A, B, C, D above, the one closest to "
            "the correct answer is:"
        )
        candidates = ["A", "B", "C", "D"]
    elif n == 3:
        question += (
            f" A.{c['A']} B.{c['B']} C.{c['C']} \n "
            "Among the three options A, B, C above, the one closest to "
            "the correct answer is: "
        )
        candidates = ["A", "B", "C"]
    elif n == 2:
        question += (
            f" A.{c['A']} B.{c['B']} \n "
            "Among the two options A, B above, the one closest to the "
            "correct answer is: "
        )
        candidates = ["A", "B"]
    else:
        raise ValueError(f"unsupported choice count: {n}")
    return question, candidates


def run_videobench(model, args) -> Dict[str, Dict[str, dict]]:
    """Video-Bench MC eval over its sub-datasets (reference
    video_bench:114-215). Writes `{name}_eval.json` per dataset."""
    datasets = args.datasets or list(VIDEOBENCH_DATASETS)
    os.makedirs(args.output_dir, exist_ok=True)
    all_results: Dict[str, Dict[str, dict]] = {}
    for dataset_name in datasets:
        qa_json = os.path.join(
            args.eval_qa_root, "Eval_QA", f"{dataset_name}_QA_new.json"
        )
        if not os.path.exists(qa_json):
            log.error("missing QA file: %s", qa_json)
            continue
        with open(qa_json, encoding="utf-8") as f:
            annotations = json.load(f)
        eval_dict: Dict[str, dict] = {}
        for q_id, item in annotations.items():
            question, _ = format_mc_question(item["question"], item["choices"])
            video_path = os.path.join(args.eval_video_root, item["vid_path"])
            if not os.path.exists(video_path):
                log.error("missing video: %s", video_path)
                continue
            frames = _read_uniform(video_path, args.num_frame)
            output = generate_uniform(
                model, frames, question,
                temperature=args.temperature,
                max_new_tokens=args.max_new_tokens,
            )
            # Reference eval_dict schema (video_bench:192-196).
            eval_dict[q_id] = {
                "video_id": item["video_id"],
                "question": question,
                "output_sequence": output,
            }
        out_path = os.path.join(args.output_dir, f"{dataset_name}_eval.json")
        with open(out_path, "w", encoding="utf-8") as f:
            json.dump(eval_dict, f, indent=2)
            f.write("\n")
        all_results[dataset_name] = eval_dict
    return all_results


# -------------------------------------------------------------- seedbench


def filter_seed_questions(
    data: Sequence[dict], level: str = "L2", subpart: str = "all",
    version: str = "v2",
) -> List[dict]:
    """Cumulative level/version + subpart membership filter (reference
    seed_bench:41-69)."""
    levels = {"L1": ["L1"], "L2": ["L1", "L2"], "L3": ["L1", "L2", "L3"]}
    if level not in levels:
        raise ValueError(f"Invalid level: {level}")
    data = [q for q in data if q["level"] in levels[level]]

    if subpart in SEED_SUBPARTS:
        valid_subparts: Sequence[str] = (subpart,)
    elif subpart == "all":
        valid_subparts = SEED_SUBPARTS
    else:
        raise ValueError(f"Invalid subpart: {subpart}")
    data = [q for q in data if q["subpart"] in valid_subparts]

    versions = {"v1": ["v1"], "v2": ["v1", "v2"]}
    if version not in versions:
        raise ValueError(f"Invalid version: {version}")
    return [q for q in data if q["version"] in versions[version]]


def _load_images(paths: Sequence[str]) -> np.ndarray:
    """Read RGB images; stack after resizing followers to the first's
    shape (SEED interleaved items may mix sizes; CLIP center-crop
    normalizes scale anyway)."""
    import cv2

    images = []
    for p in paths:
        bgr = cv2.imread(p)
        if bgr is None:
            raise FileNotFoundError(p)
        rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        if images and rgb.shape != images[0].shape:
            rgb = cv2.resize(rgb, (images[0].shape[1], images[0].shape[0]))
        images.append(rgb)
    return np.stack(images)


def score_choices(
    model, frames: np.ndarray, question: str, choices: Sequence[str], *,
    conv_mode: str = "qwen_1_5",
) -> List[float]:
    """Mean teacher-forced NLL per candidate, features encoded ONCE.

    This is the intent of the reference's loss loop (seed_bench:97-133);
    see the module docstring for why its actual masking never scores the
    candidate text."""
    flat = _encode_frames(model, frames)
    prompt = prompts.wrap_user_turn(
        conv_mode, DEFAULT_IMAGE_TOKEN + "\n" + question
    )
    return [
        model.score_with_image_embedding(prompt, cand, [flat])[0]
        for cand in choices
    ]


def seed_type_accuracy(records: Sequence[dict]) -> Dict[str, object]:
    """Per-question-type + total accuracy (reference seed_bench:199-218;
    its zero-correct KeyError fixed)."""
    type_counts: Dict[object, int] = {}
    correct_counts: Dict[object, int] = {}
    for item in records:
        t = item["q_type_id"]
        type_counts[t] = type_counts.get(t, 0) + 1
        if item["prediction"] == item["gt"]:
            correct_counts[t] = correct_counts.get(t, 0) + 1
    per_type = {
        t: correct_counts.get(t, 0) / n for t, n in type_counts.items()
    }
    total = sum(type_counts.values())
    return {
        "per_type": per_type,
        "total": (sum(correct_counts.values()) / total) if total else 0.0,
        "count": total,
    }


def run_seedbench(model, args) -> Dict[str, object]:
    """SEED-Bench v2 loss-ranked MC eval (reference seed_bench:152-218)."""
    with open(args.anno_path, encoding="utf-8") as f:
        qa_anno = json.load(f)
    if isinstance(qa_anno, dict) and "questions" in qa_anno:
        qa_anno = qa_anno["questions"]
    qa_anno = filter_seed_questions(
        qa_anno, args.evaluate_level, args.evaluate_part, args.evaluate_version
    )
    os.makedirs(args.output_dir, exist_ok=True)
    records: List[dict] = []
    out_path = os.path.join(args.output_dir, "results_longva.json")
    with open(out_path, "a", encoding="utf-8") as out_f:
        for qa_item in qa_anno:
            if qa_item["data_source"] == "cc3m":
                image_dir = args.cc3m_dir
            elif qa_item["data_source"] == "SEED-Bench v2":
                image_dir = args.seed_bench_dir
            else:
                raise ValueError("The data type is not valid.")
            data_id = qa_item["data_id"]
            paths = data_id if isinstance(data_id, list) else [data_id]
            frames = _load_images([os.path.join(image_dir, p) for p in paths])
            question = qa_item["question"].replace("<img>", "")
            choices = [qa_item[f"choice_{x}"] for x in "abcd"]
            losses = score_choices(model, frames, question, choices)
            pred = "ABCD"[int(np.argmin(losses))]
            record = {
                "question_id": qa_item["question_id"],
                "prediction": pred,
                "gt": qa_item["answer"],
                "q_type_id": qa_item["question_type_id"],
            }
            records.append(record)
            out_f.write(json.dumps(record) + "\n")
            out_f.flush()
    summary = seed_type_accuracy(records)
    log.info("SEED accuracy: %.2f%% over %d", 100 * summary["total"],
             summary["count"])
    return summary


# ------------------------------------------------------------------- CLI


def build_model(model_name: Optional[str], device="cuda"):
    """The LongVA both CLIs run: the checkpoint at `model_name` on `device`,
    or random weights (seed 0), tiny on the CPU and LongVA-7B wide on the
    card. A CUDA device that is missing raises."""
    from streamchat_tpu_torch.config import DecoderConfig, ViTConfig
    from streamchat_tpu_torch.models.longva import LongVA

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu for a CPU run)")
    if model_name:
        return LongVA.from_pretrained(model_name, device=device)
    cpu = device.type == "cpu"
    log.warning("no checkpoint: random %s weights", "tiny" if cpu else "LongVA-7B")
    dec = DecoderConfig.tiny() if cpu else DecoderConfig.qwen2_7b()
    vit = ViTConfig.tiny(projection_dim=dec.hidden_size) if cpu else ViTConfig(
        projection_dim=dec.hidden_size)
    return LongVA.init_random(vit, dec, seed=0, device=device)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="LongVA cross-benchmark baseline runners"
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    qa = sub.add_parser("videoqa", help="ActivityNet-QA-style open-ended")
    qa.add_argument("--video_dir", required=True)
    qa.add_argument("--gt_file_question", required=True)
    qa.add_argument("--output_dir", required=True)
    qa.add_argument("--output_name", required=True)
    qa.add_argument("--video_prefix", default="v_")
    qa.add_argument("--num_chunks", type=int, default=1)
    qa.add_argument("--chunk_idx", type=int, default=0)

    vb = sub.add_parser("videobench", help="Video-Bench multiple choice")
    vb.add_argument("--eval_qa_root", required=True)
    vb.add_argument("--eval_video_root", required=True)
    vb.add_argument("--output_dir", required=True)
    vb.add_argument("--datasets", nargs="*", default=None,
                    help=f"default: {' '.join(VIDEOBENCH_DATASETS)}")

    sb = sub.add_parser("seedbench", help="SEED-Bench v2 PPL ranking")
    sb.add_argument("--anno_path", required=True)
    sb.add_argument("--output_dir", required=True)
    sb.add_argument("--cc3m_dir", default="")
    sb.add_argument("--seed_bench_dir", default="")
    sb.add_argument("--evaluate_level", default="L2")
    sb.add_argument("--evaluate_part", default="all")
    sb.add_argument("--evaluate_version", default="v2")

    for s in (qa, vb, sb):
        s.add_argument("--model_name", default=None)
        s.add_argument("--num_frame", type=int, default=8)
        s.add_argument("--temperature", type=float, default=0.1)
        s.add_argument("--max_new_tokens", type=int, default=256)
        s.add_argument("--device", default="cuda",
                       help="torch device; a CPU run must be asked for (--device cpu)")

    args = p.parse_args(argv)
    model = build_model(args.model_name, args.device)
    if args.cmd == "videoqa":
        run_videoqa(model, args)
    elif args.cmd == "videobench":
        run_videobench(model, args)
    else:
        run_seedbench(model, args)


if __name__ == "__main__":
    main()
