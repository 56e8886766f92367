"""K12 (`select_changed_frames`), K13 (`fused_ln_attn`) and K14
(`vit_attention`): the port's plain twins against the JAX package's Pallas
kernels run in interpret mode, on the same seeded numpy inputs, on the CPU.

Tolerance: float32 inputs, atol 2e-5 (rtol 2e-5 where outputs reach tens),
and the K12 similarities within 1e-6 with keep masks equal. On a CPU tensor
every wrapper runs its twin and counts no launch; the kernels themselves are
held to the same twins on the card by `tests/test_torch_cuda.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from streamchat_tpu.ops import dedup as jdedup
from streamchat_tpu.ops import fused_vit as jfv
from streamchat_tpu.ops.vit_attention import vit_attention as j_vit_attention
from streamchat_tpu.pipeline.ingest import dedup_segment as j_dedup_segment
from streamchat_tpu_torch import kernels
from streamchat_tpu_torch.ops import dedup, fused_vit, vit_attention
from streamchat_tpu_torch.pipeline.ingest import dedup_segment

ATOL = 2e-5


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture
def no_launches():
    kernels.reset_launch_counts()
    yield
    assert all(v == 0 for v in kernels.launch_counts().values()), \
        "a CPU tensor must run the plain twin, never count a launch"


# --- K12 select_changed_frames ------------------------------------------------

def _j_similarity(x):
    """The TPU kernel's [N] similarity output (interpret mode)."""
    n = x.shape[0]
    sim = pl.pallas_call(jdedup._dedup_kernel,
                         out_shape=jax.ShapeDtypeStruct((n, 1), jnp.float32),
                         interpret=True)(jnp.asarray(x))
    return np.asarray(sim)[:, 0]


def _frames_with_repeats(seed, n, d):
    """Descriptors where every third frame repeats the one before (plus
    small noise), so some frames fall under any threshold and some above."""
    x = _rand(seed, n, d)
    for i in range(1, n, 3):
        x[i] = x[i - 1] + 0.05 * _rand(seed + i, d)
    return x


@pytest.mark.parametrize("n,d", [(12, 64), (7, 200), (60, 3584)])
def test_select_changed_frames_matches_jax(no_launches, n, d):
    x = _frames_with_repeats(n, n, d)
    keep, sim = dedup.select_changed_frames(torch.from_numpy(x), return_similarity=True)
    np.testing.assert_allclose(sim.numpy(), _j_similarity(x), atol=1e-6, rtol=0)
    for thr in (0.01, 0.18, 0.5, 0.9):
        j_keep = np.asarray(jdedup.select_changed_frames(jnp.asarray(x), threshold=thr,
                                                         interpret=True))
        got = dedup.select_changed_frames(torch.from_numpy(x), threshold=thr)
        assert got.dtype == torch.bool and got.shape == (n,)
        np.testing.assert_array_equal(got.numpy(), j_keep)
    kept = dedup.select_changed_frames(torch.from_numpy(x), threshold=0.18).numpy()
    assert kept[0] and 0 < kept.sum() < n


def test_select_changed_frames_keeps_scene_changes_only(no_launches):
    """AAAABBBB keeps frames 0 and 4 (tests/test_ops_memory.py, TestDedup)."""
    a = np.ones(128, np.float32)
    b = np.concatenate([-np.ones(64), np.ones(64)]).astype(np.float32)
    feats = np.stack([a, a, a, a, b, b, b, b])
    keep = dedup.select_changed_frames(torch.from_numpy(feats), threshold=0.2).numpy()
    j_keep = np.asarray(jdedup.select_changed_frames(jnp.asarray(feats), threshold=0.2,
                                                     interpret=True))
    np.testing.assert_array_equal(keep, j_keep)
    np.testing.assert_array_equal(keep, [1, 0, 0, 0, 1, 0, 0, 0])


def test_select_changed_frames_single_frame_and_wrap(no_launches):
    """N = 1 compares row 0 with itself; row 0's score is against row N - 1
    (the TPU kernel's roll wraps) and frame 0 is kept whatever it is."""
    one = _rand(3, 1, 32)
    keep, sim = dedup.select_changed_frames(torch.from_numpy(one), threshold=0.5,
                                            return_similarity=True)
    np.testing.assert_allclose(sim.numpy(), _j_similarity(one), atol=1e-6, rtol=0)
    assert sim.item() == pytest.approx(1.0, abs=1e-6) and keep.tolist() == [True]
    x = _rand(4, 5, 32)
    x[0] = x[4]                         # row 0 equals the last row: sim[0] = 1
    x[1] = -x[0]                        # row 1 opposes row 0: sim[1] = -1
    _, sim = dedup.select_changed_frames(torch.from_numpy(x), return_similarity=True)
    np.testing.assert_allclose(sim.numpy(), _j_similarity(x), atol=1e-6, rtol=0)
    assert sim[0].item() == pytest.approx(1.0, abs=1e-6)
    assert sim[1].item() == pytest.approx(-1.0, abs=1e-6)


def test_frame_descriptors_and_ssim_match_jax():
    feats = _rand(5, 4, 9, 16)
    np.testing.assert_allclose(
        dedup.frame_descriptors(torch.from_numpy(feats)).numpy(),
        np.asarray(jdedup.frame_descriptors(jnp.asarray(feats))), atol=1e-6, rtol=0)
    rng = np.random.default_rng(6)
    a = rng.integers(0, 256, (3, 24, 20)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 20, a.shape), 0, 255).astype(np.float32)
    b[2] = 255 - a[2]
    got = dedup.ssim_pairs(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(jdedup.ssim_pairs(jnp.asarray(a),
                                                                 jnp.asarray(b))),
                               atol=1e-6, rtol=1e-5)
    assert got[0] > 0.5 > got[2]


@pytest.mark.parametrize("threshold", [0.0, 0.05, 0.18, 2.5])
def test_dedup_segment_matches_jax(no_launches, threshold):
    feats = _rand(7, 10, 6, 16)
    feats[3] = feats[2] + 0.01 * _rand(8, 6, 16)
    feats[4] = feats[3]
    feats[8] = feats[7] * 1.5
    got = dedup_segment(torch.from_numpy(feats), threshold)
    ref = np.asarray(j_dedup_segment(jnp.asarray(feats), threshold))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    if threshold == 0.0:
        assert got.shape[0] == 10
    if threshold == 0.05:
        assert 0 < got.shape[0] < 10
    assert dedup_segment(torch.zeros(0, 6, 16), threshold).shape == (0, 6, 16)


@pytest.mark.parametrize("n,d,itemsize,aligned,vec,passes", [
    (60, 3584, 4, True, True, 1), (60, 3584, 2, True, True, 1), (1, 4096, 4, True, True, 1),
    (1, 4100, 4, True, True, 2), (60, 1000, 4, True, True, 1), (60, 1001, 4, True, False, 1),
    (7, 1030, 2, True, False, 2), (60, 3584, 4, False, False, 4), (1, 1, 4, True, False, 1),
    (500, 100000, 2, True, True, 13)])
def test_k12_launch_plan(n, d, itemsize, aligned, vec, passes):
    """K12 on the card: one block a row, 16-byte loads only where every row
    starts on a 16-byte boundary (else the kernel's scalar loop), and as many
    passes of 4 loads a thread as cover the row."""
    plan = dedup.launch_plan(n, d, itemsize, aligned=aligned)
    assert plan == {"vec": vec, "blocks": n, "passes": passes}
    with pytest.raises(ValueError):
        dedup.launch_plan(0, d, itemsize)


# --- K13 fused_ln_attn ----------------------------------------------------------

def _attn_weights(d, seed):
    r = lambda i, *s, scale=1.0: _rand(seed * 100 + i, *s, scale=scale)  # noqa: E731
    return dict(ln_scale=1 + r(1, d, scale=0.1), ln_bias=r(2, d, scale=0.1),
                wqkv=r(3, d, 3 * d, scale=d ** -0.5), bqkv=r(4, 3 * d, scale=0.1),
                wo=r(5, d, d, scale=d ** -0.5), bo=r(6, d, scale=0.1))


_ATTN_ORDER = ("ln_scale", "ln_bias", "wqkv", "bqkv", "wo", "bo")


def test_fold_vit_attn_params_matches_jax():
    w = _attn_weights(64, 1)
    got = fused_vit.fold_vit_attn_params(
        *(torch.from_numpy(w[k]) for k in ("ln_scale", "ln_bias", "wqkv", "bqkv")),
        num_heads=2)
    ref = jfv.fold_vit_attn_params(
        *(jnp.asarray(w[k]) for k in ("ln_scale", "ln_bias", "wqkv", "bqkv")), num_heads=2)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("n,s,d,heads", [(2, 17, 64, 2), (4, 77, 128, 2)],
                         ids=["n2-s17-dh32", "n4-s77-dh64"])
@pytest.mark.parametrize("mode,folded,onepass", [
    ("clamp", False, False), ("exact", False, False),
    ("clamp", True, True), ("exact", False, True),
], ids=["clamp", "exact", "clamp-folded-onepass", "exact-onepass"])
def test_fused_ln_attn_matches_jax(no_launches, n, s, d, heads, mode, folded, onepass):
    w = _attn_weights(d, n)
    x = _rand(9, n, s, d)
    args = [w[k] for k in _ATTN_ORDER]
    if folded:
        fw, fb = jfv.fold_vit_attn_params(*map(jnp.asarray, args[:4]), num_heads=heads)
        args[2], args[3] = np.array(fw), np.array(fb)
    kw = dict(num_heads=heads, eps=1e-5, frame_tile=1, softmax_mode=mode, folded=folded,
              ln_onepass=onepass)
    ref = jfv.fused_ln_attn(jnp.asarray(x), *map(jnp.asarray, args), interpret=True, **kw)
    got = fused_vit.fused_ln_attn(torch.from_numpy(x), *map(torch.from_numpy, args), **kw)
    assert got.shape == (n, s, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=ATOL)


class TestClampEdges:
    """The edges of the clamp softmax that tests/test_fused_vit.py
    (TestSoftmaxModes) pins, with the port's twin beside the JAX kernel: a
    row max above 80 flattens to uniform weights, a row max below the
    underflow floor gives x + bo; the folded form keeps both."""

    D, HEADS, S, N = 16, 2, 12, 2

    def _weights(self, logit_center, logit_spread, key=3):
        d, dh = self.D, self.D // self.HEADS
        c = 8.0
        wqkv = np.zeros((d, 3 * d), np.float32)
        bqkv = np.zeros((3 * d,), np.float32)
        rng = np.random.default_rng(key)
        for h in range(self.HEADS):
            bqkv[h * dh] = c
            wqkv[:, d + h * dh] = rng.normal(0, 1, d) * (
                logit_spread * dh ** 0.5 / (c * d ** 0.5))
            bqkv[d + h * dh] = logit_center * dh ** 0.5 / c
        wqkv[:, 2 * d:] = np.eye(d, dtype=np.float32)
        wo = rng.normal(0, d ** -0.5, (d, d)).astype(np.float32)
        bo = rng.normal(0, 0.1, (d,)).astype(np.float32)
        return wqkv, bqkv, wo, bo

    def _both(self, center, mode, folded=False):
        d = self.D
        x = _rand(7, self.N, self.S, d)
        wqkv, bqkv, wo, bo = self._weights(center, 8.0)
        ones, zeros = np.ones(d, np.float32), np.zeros(d, np.float32)
        if folded:
            fw, fb = jfv.fold_vit_attn_params(jnp.asarray(ones), jnp.asarray(zeros),
                                              jnp.asarray(wqkv), jnp.asarray(bqkv),
                                              num_heads=self.HEADS)
            wqkv, bqkv = np.array(fw), np.array(fb)
        kw = dict(num_heads=self.HEADS, softmax_mode=mode, folded=folded, ln_onepass=folded)
        args = (ones, zeros, wqkv, bqkv, wo, bo)
        ref = jfv.fused_ln_attn(jnp.asarray(x), *map(jnp.asarray, args), interpret=True, **kw)
        got = fused_vit.fused_ln_attn(torch.from_numpy(x), *map(torch.from_numpy, args), **kw)
        return x, bo, got.numpy(), np.asarray(ref)

    @pytest.mark.parametrize("folded", [False, True])
    @pytest.mark.parametrize("center,mode", [
        (-50.0, "clamp"), (50.0, "clamp"), (140.0, "clamp"), (-200.0, "clamp"),
        (95.0, "exact"), (-110.0, "exact"),
    ])
    def test_matches_jax(self, no_launches, center, mode, folded):
        _, _, got, ref = self._both(center, mode, folded)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=ATOL)

    def test_underflow_gives_x_plus_bo(self):
        x, bo, got, _ = self._both(-200.0, "clamp")
        np.testing.assert_allclose(got, x + bo, rtol=1e-5, atol=1e-6)

    def test_above_80_flattens_to_uniform(self):
        x, bo, got, _ = self._both(140.0, "clamp")
        wqkv, bqkv, wo, _ = self._weights(140.0, 8.0)
        mu = x.mean(-1, keepdims=True)
        h = (x - mu) / np.sqrt(((x - mu) ** 2).mean(-1, keepdims=True) + 1e-5)
        v = (h @ wqkv + bqkv)[..., 2 * self.D:]
        uni = x + np.broadcast_to(v.mean(axis=1, keepdims=True), v.shape) @ wo + bo
        np.testing.assert_allclose(got, uni, atol=2e-4, rtol=2e-5)


def test_fused_ln_attn_option_errors():
    x = torch.zeros(3, 5, 16)
    w = [torch.zeros(16), torch.zeros(16), torch.zeros(16, 48), torch.zeros(48),
         torch.zeros(16, 16), torch.zeros(16)]
    with pytest.raises(ValueError, match="frame_tile"):
        fused_vit.fused_ln_attn(x, *w, num_heads=2, frame_tile=2)
    with pytest.raises(ValueError, match="softmax_mode"):
        fused_vit.fused_ln_attn(x, *w, num_heads=2, softmax_mode="fast")
    with pytest.raises(ValueError, match="frame_tile"):
        jfv.fused_ln_attn(jnp.zeros((3, 5, 16)), *(jnp.asarray(t.numpy()) for t in w),
                          num_heads=2, frame_tile=2, interpret=True)
    assert fused_vit.fused_ln_attn(x, *w, num_heads=2, frame_tile=3).shape == x.shape


# --- K14 vit_attention ----------------------------------------------------------

@pytest.mark.parametrize("shape,sm_scale", [((6, 4, 77, 32), None), ((2, 2, 17, 64), 0.3),
                                            ((1, 2, 577, 64), None)])
def test_vit_attention_matches_jax(no_launches, shape, sm_scale):
    q, k, v = (_rand(10 + i, *shape) for i in range(3))
    ref = j_vit_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), sm_scale=sm_scale,
                          block_n=4, interpret=True)
    got = vit_attention.vit_attention(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), sm_scale=sm_scale, block_n=4)
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
