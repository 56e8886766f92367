"""The one generator of traffic: a mix is a JSON file of parameters
(`traffic/<name>.json`), and `make_plan` turns it and the seed into the
inputs a run hands to the program and to the reference alike.

Keys of a mix (see traffic/*.json):
  kind           the traffic kind, portbench/kinds/<kind>.py: "stream" (the
                 window runs memory updates, segment after segment) or "qa"
                 (the window asks questions in turn)
  video          the synthetic video (portbench/video.py)
  segment_frames video frames a segment spans
  memory, sampling, video_config
                 the pipeline's MemoryConfig, SamplingConfig and
                 VideoConfig fields the mix sets (the rest keep config.py's)
  warm_segments  segments run before the window (set-up), on a tree of
                 their own
  memory_segments (qa) segments whose memory the questions are asked of
  questions      (qa) count, min_words, max_words, vocabulary, warm
  warm_response_bytes (qa) the longest answer text the prompt buckets that
                 set-up warms allow for in a turn of history
  greedy_every   captions and answers: one in each group of this many is
                 decoded greedily (for the check), at a seeded place in
                 its group, so every seed has the same work; the others
                 sample at the configured temperature
  check_requests greedy requests the reference judges after the window
  trace_units    segments / answers a --trace 1 run profiles, from the
                 window's start
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Tuple

import numpy as np

from portbench.seeds import subseed

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Plan:
    spec: dict
    segments: List[Tuple[float, float]]       # [start_s, end_s) of each segment
    greedy: List[bool]                         # per window request
    questions: List[str]
    warm_questions: List[str]
    seed: int


def load(name: str, root: str = HERE) -> dict:
    with open(os.path.join(root, "traffic", name + ".json"), encoding="utf-8") as f:
        return json.load(f)


def _greedy_flags(n: int, every: int, rng: np.random.Generator) -> List[bool]:
    """One greedy request in each group of `every`, where the seed says."""
    flags: List[bool] = []
    while len(flags) < n:
        flags += [bool(b) for b in rng.permutation([True] + [False] * (every - 1))]
    return flags[:n]


def _questions(qs: dict, n: int, rng: np.random.Generator) -> List[str]:
    """n questions of min_words..max_words words: each pair of consecutive
    questions has a seeded count a and its mirror min + max - a, so every
    seed asks the same number of words in any even prefix; the words are
    drawn from the vocabulary."""
    words = qs["vocabulary"].split()
    lo, hi = int(qs["min_words"]), int(qs["max_words"])
    counts: List[int] = []
    while len(counts) < n:
        a = int(rng.integers(lo, hi + 1))
        counts += [int(c) for c in rng.permutation([a, lo + hi - a])]
    return [" ".join(rng.choice(words, c)).capitalize() + "?" for c in counts[:n]]


def make_plan(spec: dict, seed: int, max_requests: int = 512) -> Plan:
    fps = float(spec["video"]["fps"])
    seg = int(spec["segment_frames"])
    n_seg = int(spec["video"]["total_frames"]) // seg
    # Half a frame past each boundary, so int(t * fps) is the boundary frame.
    segments = [((i * seg + 0.5) / fps, ((i + 1) * seg + 0.5) / fps) for i in range(n_seg)]
    rng = np.random.default_rng(subseed(seed, "traffic"))
    greedy = _greedy_flags(max_requests, int(spec["greedy_every"]), rng)
    questions, warm = [], []
    if "questions" in spec:
        qs = spec["questions"]
        questions = _questions(qs, int(qs["count"]), rng)
        warm = _questions(qs, int(qs.get("warm", 0)), rng)
    return Plan(spec=spec, segments=segments, greedy=greedy, questions=questions,
                warm_questions=warm, seed=seed)
