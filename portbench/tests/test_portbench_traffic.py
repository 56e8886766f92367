"""The traffic and the video are functions of the seed: the same seed gives
the same inputs, another seed the same sizes in another order."""

import numpy as np

from portbench import traffic
from portbench.tests.conftest import tiny
from portbench.video import SyntheticVideo

SEED = 2 ** 31 + 12345


def test_same_seed_same_plan_and_frames():
    for kind in ("stream", "qa"):
        spec = traffic.load(kind)
        a, b = traffic.make_plan(spec, SEED), traffic.make_plan(spec, SEED)
        assert a.segments == b.segments and a.greedy == b.greedy
        assert a.questions == b.questions and a.warm_questions == b.warm_questions
    _, spec = tiny("stream")
    va, vb = SyntheticVideo(spec["video"], SEED), SyntheticVideo(spec["video"], SEED)
    idx = [0, 5, 199, 200, 777]
    assert np.array_equal(va.read_frames(idx), vb.read_frames(idx))
    vc = SyntheticVideo(spec["video"], SEED + 1)
    assert not np.array_equal(va.read_frames(idx), vc.read_frames(idx))


def test_other_seeds_keep_the_sizes():
    spec = traffic.load("qa")
    a, b = traffic.make_plan(spec, SEED), traffic.make_plan(spec, 7)
    assert a.questions != b.questions
    for p in (a, b):
        counts = [len(q.split()) for q in p.questions]
        assert all(counts[i] + counts[i + 1] == 50 for i in range(0, len(counts) - 1, 2))
        every = spec["greedy_every"]
        assert all(sum(p.greedy[i:i + every]) == 1 for i in range(0, len(p.greedy), every))
        assert {len(q.split()) for q in p.questions} <= set(range(10, 41))


def test_segments_cut_whole_frames():
    spec = traffic.load("stream")
    plan = traffic.make_plan(spec, SEED)
    fps, seg = spec["video"]["fps"], spec["segment_frames"]
    for i, (s0, s1) in enumerate(plan.segments[:50]):
        assert int(s0 * fps) == i * seg and int(s1 * fps) == (i + 1) * seg
