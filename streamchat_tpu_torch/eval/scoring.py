"""Score aggregation over judged JSONL results.

Rebuilds `calculate_score.py:165-210` (accuracy = yes/(yes+no), average
0-5 score) and `calculate_avg_score.py:1-60` (per-class score/accuracy plus
the adjacent-score fluctuation metric — mean |Δscore| between consecutive
answers in file order).

A copy of `streamchat_tpu/eval/scoring.py` (pure Python; the original loads
jax through its package's `__init__`).
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, Iterable, List, Optional


def read_jsonl(path: str) -> List[dict]:
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def aggregate_scores(results: Iterable[dict]) -> Dict:
    """Accuracy / average score (calculate_score.py main, :165-210).

    Malformed rows are skipped like the reference's bare `except`."""
    score_sum = 0
    count = 0
    yes = 0
    no = 0
    unparseable = 0
    for r in results:
        if r.get("judge_parse_error"):
            # Rows the judge failed to emit a parseable verdict for are
            # EXCLUDED from the yes/no denominator and the score mean —
            # coercing them to no/0 would redefine the metric vs the
            # reference (which crashes instead). Their count is reported.
            unparseable += 1
            continue
        try:
            score_sum += int(r["score"])
            count += 1
            pred = r["llama_pred"].lower()
            if "yes" in pred:
                yes += 1
            elif "no" in pred:
                no += 1
        except (KeyError, TypeError, ValueError):
            continue
    return {
        "Yes count": yes,
        "No count": no,
        "Unparseable count": unparseable,
        "Accuracy": yes / (yes + no) if (yes + no) else 0.0,
        "Average score": score_sum / count if count else 0.0,
    }


def per_class_breakdown(results: Iterable[dict]) -> Dict:
    """Per-class score/acc + adjacent-score fluctuation
    (calculate_avg_score.py:14-53)."""
    class_scores = defaultdict(int)
    class_acc = defaultdict(int)
    class_counts = defaultdict(int)
    diffs = []
    prev: Optional[float] = None
    process_times = []
    for r in results:
        try:
            score = int(r["score"])
            pred = r["llama_pred"]
        except (KeyError, TypeError, ValueError):
            # Malformed rows are skipped like aggregate_scores (and the
            # reference's bare except) so one bad JSONL line cannot crash
            # the breakdown after aggregation already succeeded.
            continue
        c = r.get("class")
        class_scores[c] += score
        class_acc[c] += 1 if pred == "yes" else 0
        class_counts[c] += 1
        if prev is not None:
            diffs.append(abs(score - prev))
        prev = score
        if "process_time" in r:
            process_times.append(r["process_time"])
    out = {
        "classes": {
            c: {
                "avg_score": class_scores[c] / class_counts[c],
                "avg_acc": class_acc[c] / class_counts[c],
                "count": class_counts[c],
            }
            for c in class_counts
        },
        "fluctuation": sum(diffs) / len(diffs) if diffs else 0.0,
    }
    if process_times:
        out["avg_process_time"] = sum(process_times) / len(process_times)
    return out


def mc_accuracy(results: Iterable[dict]) -> Dict:
    """Multiple-choice accuracy (calculate_score.py eval_intent /
    eval_egoschema, :42-80): rows where 'truth' == 'correct_answer';
    correct_answer == -1 marks an unparseable prediction.

    (The NExT-QA per-type grouping mode needs the external val.csv the
    reference hard-codes; run it with that file via group_key if needed.)
    """
    count = 0
    valids = 0
    corrects = 0
    for r in results:
        count += 1
        if r.get("correct_answer") == -1:
            continue
        valids += 1
        if r.get("truth") == r.get("correct_answer"):
            corrects += 1
    return {
        "num_total": count,
        "num_valids": valids,
        "num_corrects": corrects,
        "acc": corrects / count if count else 0.0,
    }


def nextqa_grouped_accuracy(results: Iterable[dict], annotation_csv: str) -> Dict:
    """NExT-QA per-type accuracy (calculate_score.py eval_next, :69-135,
    itself adapted from doc-doc/NExT-QA eval_mc.py).

    `annotation_csv` is the NExT-QA val.csv (columns video, qid, type) the
    reference hard-codes; result rows carry {id: "<video>_<qid>", truth,
    correct_answer}. 'TP' folds into 'TN'; overall groups C/T/D are the type
    initials.
    """
    import csv

    preds = {
        r["id"]: {"truth": r["truth"], "pred": r["correct_answer"]}
        for r in results
    }
    group: Dict[str, list] = {k: [] for k in
                              ("CW", "CH", "TN", "TC", "DC", "DL", "DO")}
    with open(annotation_csv, newline="", encoding="utf-8") as f:
        for row in csv.DictReader(f):
            qid = f"{row['video']}_{row['qid']}"
            if qid not in preds:
                continue
            qtype = "TN" if row["type"] == "TP" else row["type"]
            group.setdefault(qtype, []).append(qid)

    group_stats = {}
    overall = {"C": [0, 0], "T": [0, 0], "D": [0, 0]}
    all_acc = all_cnt = 0
    for qtype, ids in group.items():
        acc = sum(1 for q in ids if preds[q]["truth"] == preds[q]["pred"])
        cnt = len(ids)
        group_stats[qtype] = {"acc": acc / cnt if cnt else 0.0, "count": cnt}
        # Unknown type codes (outside C*/T*/D*) get their own overall bucket
        # instead of crashing (the reference assumes the fixed NExT-QA set).
        bucket = overall.setdefault(qtype[:1], [0, 0])
        bucket[0] += acc
        bucket[1] += cnt
        all_acc += acc
        all_cnt += cnt
    return {
        "per_type": group_stats,
        "per_group": {
            k: (a / c if c else 0.0) for k, (a, c) in overall.items()
        },
        "overall_acc": all_acc / all_cnt if all_cnt else 0.0,
    }


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="Aggregate judged StreamBench scores")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--output_name", required=True)
    args = p.parse_args(argv)

    path = f"{args.output_dir}/{args.output_name}.jsonl"
    results = read_jsonl(path)
    stats = aggregate_scores(results)
    breakdown = per_class_breakdown(results)
    print(json.dumps({**stats, **breakdown}, indent=2))
    with open(f"{args.output_dir}/{args.output_name}_res.json", "w") as f:
        json.dump([{k: v} for k, v in stats.items()], f, indent=4)


if __name__ == "__main__":
    main()
