"""Evaluation & scoring harness: the LLaMA-3 judge and score aggregation
for StreamBench v0.3 results (copies of `streamchat_tpu/eval/`, which load
jax through their package's `__init__`; the judge's model is the port's
`models/textlm.TextLM`).
"""

from streamchat_tpu_torch.eval.judge import (
    build_judge_prompt,
    judge_predictions,
    parse_judge_output,
)
from streamchat_tpu_torch.eval.scoring import aggregate_scores, per_class_breakdown

__all__ = [
    "aggregate_scores",
    "build_judge_prompt",
    "judge_predictions",
    "parse_judge_output",
    "per_class_breakdown",
]
