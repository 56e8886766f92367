"""LLaMA-3 judge for StreamBench predictions.

Rebuilds `eval_video_qa_with_llama3_ours.py:38-171`: the hand-built
`<|begin_of_text|> <|start_header_id|> role <|end_header_id|> ... <|eot_id|>`
chat prompt (joined with SPACES — a reference quirk kept because it
conditions the judge), greedy generation, and the brace-regex +
`ast.literal_eval` parse into `{'llama_pred': 'yes'/'no', 'score': int}`.

Data-parallel sharding keeps the reference's --num_chunks/--chunk_idx
contract (ceil-split contiguous chunks, :69-75) so multi-host runs shard the
same way the reference's shell fan-out did.

A copy of `streamchat_tpu/eval/judge.py` (which loads jax through its
package's `__init__`) whose model is the port's `models/textlm.TextLM`; the
CLI adds `--device` (the card unless the CPU is asked for). With no
checkpoint the random judge is tiny on the CPU, as the JAX judge's, and
LLaMA-3-8B wide on the card (the card's kernels do not take the tiny
geometry's head dim).
"""

from __future__ import annotations

import ast
import json
import math
import re
from typing import Callable, Dict, List, Optional

from streamchat_tpu_torch.utils.logging import get_logger

log = get_logger("judge")

GenerateFn = Callable[[str], str]

JUDGE_SYSTEM = (
    "You are an intelligent chatbot designed for evaluating the correctness "
    "of generative outputs for question-answer pairs. "
    "Your task is to compare the predicted answer with the correct answer "
    "and determine if they match meaningfully. Here's how you can accomplish "
    "the task:"
    "------"
    "##INSTRUCTIONS: "
    "- Focus on the meaningful match between the predicted answer and the "
    "correct answer.\n"
    "- Consider synonyms or paraphrases as valid matches.\n"
    "- Evaluate the correctness of the prediction compared to the answer."
)

JUDGE_USER = (
    "Please evaluate the following video-based question-answer pair:\n\n"
    "Question: {question}\n"
    "Correct Answer: {answer}\n"
    "Predicted Answer: {prediction}\n\n"
    "Provide your evaluation only as a yes/no and score where the score is "
    "an integer value between 0 and 5, with 5 indicating the highest "
    "meaningful match. "
    "Please generate the response in the form of a Python dictionary string "
    "with keys 'llama_pred' and 'score', where value of 'llama_pred' is  a "
    "string of 'yes' or 'no' and value of 'score' is in INTEGER, not STRING."
    "DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only provide the "
    "Python dictionary string. "
    "For example, your response should look like this: "
    "{{'llama_pred': 'yes', 'score': 4.8}}."
)


def build_judge_prompt(question: str, answer: str, prediction: str) -> str:
    """Space-joined llama3 chat prompt (prepare_prompt, :38-66)."""
    messages = [
        ("system", JUDGE_SYSTEM),
        ("user", JUDGE_USER.format(
            question=question, answer=answer, prediction=prediction
        )),
    ]
    parts = ["<|begin_of_text|>"]
    for role, content in messages:
        parts.extend(
            ["<|start_header_id|>", role, "<|end_header_id|>", "\n\n",
             content, "<|eot_id|>"]
        )
    return " ".join(parts)


def parse_judge_output(text: str) -> Optional[Dict]:
    """Last `{...}` match parsed as a Python literal (:158-162); None when
    the judge produced nothing parseable (the reference would crash)."""
    result = None
    for match in re.findall(r"\{.*?\}", text):
        try:
            cand = ast.literal_eval(match)
            if isinstance(cand, dict):
                result = cand
        except (ValueError, SyntaxError):
            continue
    return result


def get_chunk(lst: List, num_chunks: int, chunk_idx: int) -> List:
    """Contiguous ceil-split sharding (:69-75); empty input -> empty shard."""
    size = max(1, math.ceil(len(lst) / num_chunks))
    chunks = [lst[i : i + size] for i in range(0, len(lst), size)]
    return chunks[chunk_idx] if chunk_idx < len(chunks) else []


# Input key mapping per source format: "ours" is the pipeline's result file
# (eval_video_qa_with_llama3_ours.py:109-111); "generic" is the baseline
# runners' output (eval_video_qa_with_llama3.py:107-109, also the ego
# variant).
FORMATS = {
    "ours": ("question", "label", "predict"),
    "generic": ("question", "answer", "pred"),
}


def judge_predictions(
    predictions: List[dict],
    generate: GenerateFn,
    output_path: Optional[str] = None,
    num_chunks: int = 1,
    chunk_idx: int = 0,
    fmt: str = "ours",
    batch_size: int = 1,
) -> List[dict]:
    """Judge each prediction dict, appending llama_pred + score; writes
    JSONL when output_path is given (:99, 165).

    batch_size > 1 groups prompts into one prefill + fused decode loop per
    batch (the reference generates one prediction at a time and regains
    throughput only via per-GPU process fan-out); `generate` then receives a
    list and must return a list.
    """
    q_key, a_key, p_key = FORMATS[fmt]
    shard = get_chunk(predictions, num_chunks, chunk_idx)
    out_file = open(output_path, "w", encoding="utf-8") if output_path else None
    results = []
    for i in range(0, len(shard), batch_size):
        batch = shard[i : i + batch_size]
        prompts = [
            build_judge_prompt(p[q_key], p[a_key], p[p_key]) for p in batch
        ]
        if batch_size == 1:
            outputs = [generate(prompts[0])]
        else:
            outputs = generate(prompts)
        for pred, text in zip(batch, outputs):
            verdict = parse_judge_output(text)
            rec = dict(pred)
            if verdict is None:
                # Do NOT coerce to {'no', 0}: that would deflate accuracy
                # relative to the reference (which crashes on unparseable
                # output, eval_video_qa_with_llama3_ours.py:158-162). The
                # row is marked and scoring excludes it from the yes/no
                # denominator, reporting an unparseable count instead.
                log.warning("unparseable judge output for question %r", pred[q_key])
                rec["judge_parse_error"] = True
            else:
                rec.update(verdict)
            results.append(rec)
            if out_file:
                out_file.write(json.dumps(rec) + "\n")
                out_file.flush()
    if out_file:
        out_file.close()
    return results


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="LLaMA-3 judge for StreamBench results")
    p.add_argument("--predict_file", required=True)
    p.add_argument("--llama3_path", default=None,
                   help="LLaMA-3 checkpoint (random weights if unset: tiny on the "
                        "CPU, LLaMA-3-8B wide on the card)")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--output_name", required=True)
    p.add_argument("--num_chunks", type=int, default=1)
    p.add_argument("--chunk_idx", type=int, default=0)
    p.add_argument("--format", choices=sorted(FORMATS), default="ours")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--int8", action="store_true",
                   help="int8 weight-only judge (halves decode latency; an "
                        "8B judge then fits one 16 GB chip)")
    p.add_argument("--spec_tokens", type=int, default=0,
                   help="speculative decoding draft length (the judge is "
                        "greedy and its verdicts are formulaic — a rolling "
                        "corpus of recent outputs drafts most of each one; "
                        "models/spec_decode). 0 = off.")
    p.add_argument("--device", default="cuda",
                   help="torch device; a CPU run must be asked for (--device cpu)")
    args = p.parse_args(argv)

    import os

    import torch

    from streamchat_tpu_torch.config import DecoderConfig
    from streamchat_tpu_torch.models.textlm import TextLM

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu for a CPU run)")
    if args.llama3_path:
        lm = TextLM.from_pretrained(args.llama3_path, device=device)
    else:
        cpu = device.type == "cpu"
        log.warning("no LLaMA-3 checkpoint: using random %s weights",
                    "tiny" if cpu else "LLaMA-3-8B")
        cfg = DecoderConfig.tiny() if cpu else DecoderConfig.llama3_8b()
        lm = TextLM.init_random(cfg, seed=0, device=device)
    if args.int8:
        lm.quantize()
    if args.spec_tokens:
        lm.spec_tokens = args.spec_tokens

    with open(args.predict_file, encoding="utf-8") as f:
        predictions = json.load(f)
    os.makedirs(args.output_dir, exist_ok=True)
    if args.batch_size > 1:
        gen = lambda prompts: lm.generate_batch(prompts, max_new_tokens=64)
    else:
        gen = lambda prompt: lm.generate(prompt, max_new_tokens=64)
    judge_predictions(
        predictions,
        gen,
        output_path=os.path.join(args.output_dir, f"{args.output_name}.jsonl"),
        num_chunks=args.num_chunks,
        chunk_idx=args.chunk_idx,
        fmt=args.format,
        batch_size=args.batch_size,
    )


if __name__ == "__main__":
    main()
