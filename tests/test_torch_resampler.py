"""The port's projector and resampler registries, the parametric
resamplers, optical flow and the clustering extras against the JAX
package's, on the CPU.

Both packages run the same numpy inputs (seeded) and, for the parametric
modules, the same weights: each JAX tree is carried across as torch
tensors with its integer leaves kept as ints. Random draws are injected
into both packages: the JAX package's permutation as the port's
`masked_drop` permutation and as k-means' initial rows. Tolerances are
stated per test (f32 throughout).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamchat_tpu.models import projector as jprojector
from streamchat_tpu.models import resampler as jresampler
from streamchat_tpu.ops import clustering as jclustering
from streamchat_tpu.ops import optical_flow as jflow
from streamchat_tpu_torch import convert
from streamchat_tpu_torch.models import projector, resampler
from streamchat_tpu_torch.ops import clustering, optical_flow

F32_ATOL = 1e-5


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _carry(tree):
    """A JAX tree as torch tensors, int leaves (head counts) kept as ints."""
    if isinstance(tree, dict):
        return {k: _carry(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_carry(v) for v in tree]
    if isinstance(tree, int):
        return tree
    return convert.to_torch(np.asarray(tree))


def _close(got, ref, atol=F32_ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol, rtol=rtol)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["mlp2x_gelu", "linear", "identity"])
def test_projector_registry_matches_jax(name):
    jinit, japply = jprojector.build(name)
    init, apply = projector.build(name)
    jp = jinit(jax.random.key(0), 8, 16, jnp.float32)
    mine = init(8, 16, torch.Generator().manual_seed(0), dtype=torch.float32)
    assert jax.tree.map(np.shape, jp) == {k: {n: tuple(t.shape) for n, t in v.items()}
                                          for k, v in mine.items()}
    x = _rand(1, 2, 3, 8)
    ref = japply(jp, jnp.asarray(x))
    out = apply(_carry(jp), torch.from_numpy(x))
    assert out.shape == ref.shape == (2, 3, 8 if name == "identity" else 16)
    _close(out, ref)


def test_projector_registry_refuses_unknown():
    with pytest.raises(ValueError, match="unknown projector"):
        projector.build("pooler")


def test_stateless_resamplers_match_jax():
    x = _rand(2, 2, 16, 8)
    assert resampler.build(None)(torch.from_numpy(x)).numpy().tobytes() == x.tobytes()
    for mode in ("average", "max"):
        ref = jresampler.build("spatial_pool")(jnp.asarray(x), stride=2, mode=mode)
        out = resampler.build("spatial_pool")(torch.from_numpy(x), stride=2, mode=mode)
        assert out.shape == (2, 4, 8)
        _close(out, ref)


@pytest.mark.parametrize("ratio", [0.5, 0.25, 0.99])
def test_masked_drop_with_the_jax_permutation(ratio):
    key = jax.random.key(3)
    x = _rand(3, 2, 16, 8)
    ref = jresampler.masked_drop(jnp.asarray(x), key, ratio=ratio)
    perm = torch.from_numpy(np.array(jax.random.permutation(key, 16)))
    out = resampler.build("masked_drop")(torch.from_numpy(x), ratio=ratio, permutation=perm)
    assert out.numpy().tobytes() == np.asarray(ref).tobytes()


def test_masked_drop_draws_from_the_generator():
    x = torch.from_numpy(_rand(4, 2, 16, 8))
    a = resampler.masked_drop(x, torch.Generator().manual_seed(5), ratio=0.5)
    b = resampler.masked_drop(x, torch.Generator().manual_seed(5), ratio=0.5)
    assert torch.equal(a, b) and a.shape == (2, 8, 8)
    kept = [int(torch.nonzero((x[0] == row).all(-1))[0, 0]) for row in a[0]]
    assert kept == sorted(set(kept))


def test_perceiver_matches_jax():
    jp, japply = jresampler.build_parametric(
        "perceiver", jax.random.key(0), 64, mm_perceiver_depth=2, mm_perceiver_latents=8,
        dim_head=16, heads=4)
    feats = _rand(5, 3, 20, 64)
    ref = japply(jp, jnp.asarray(feats))
    out = resampler.apply_perceiver(_carry(jp), torch.from_numpy(feats))
    assert out.shape == ref.shape == (3, 8, 64)
    _close(out, ref, atol=2e-5)
    other = resampler.apply_perceiver(_carry(jp), torch.from_numpy(_rand(6, 3, 20, 64)))
    assert not torch.allclose(other, out, atol=1e-3)


def test_qformer_matches_jax():
    """On a second, different input too: the output does not move with
    the input's scale (ln_vision), so a scaled input proves nothing."""
    jp, japply = jresampler.build_parametric(
        "qformer", jax.random.key(1), 48, mm_qformer_depth=3, mm_qformer_latents=5,
        hidden=32, num_layers=6, heads=4, intermediate=64)
    for seed in (7, 8):
        feats = _rand(seed, 2, 30, 48)
        ref = japply(jp, jnp.asarray(feats))
        out = resampler.apply_qformer(_carry(jp), torch.from_numpy(feats))
        assert out.shape == ref.shape == (2, 5, 32)
        _close(out, ref, atol=2e-5)


def test_parametric_builders_keep_the_cross_freq_quirk():
    g = torch.Generator().manual_seed(0)
    params, apply = resampler.build_parametric(
        "qformer", 48, g, mm_qformer_depth=3, mm_qformer_latents=5, hidden=32,
        num_layers=6, heads=4, intermediate=64)
    assert apply is resampler.apply_qformer
    assert len(params["layers"]) == 6
    assert [i for i, p in enumerate(params["layers"]) if "cross" in p] == [0, 3]
    assert params["layers"][0]["cross"]["k"]["w"].shape == (48, 32)
    out = apply(params, torch.randn(2, 30, 48, generator=g))
    assert out.shape == (2, 5, 32) and torch.isfinite(out).all()
    pparams, papply = resampler.build_parametric(
        "perceiver", 64, g, mm_perceiver_depth=2, mm_perceiver_latents=8, dim_head=16,
        heads=4)
    assert len(pparams["layers"]) == 2 and pparams["latents"].shape == (8, 64)
    assert papply(pparams, torch.randn(3, 20, 64, generator=g)).shape == (3, 8, 64)
    with pytest.raises(KeyError):
        resampler.build_parametric("pooler", 8, g)


@pytest.mark.parametrize("metric", ["euclidean", "sq_euclidean", "dot", "cosine"])
def test_pairwise_distances_match_jax(metric):
    x, c = _rand(10, 12, 8), _rand(11, 5, 8)
    ref = jclustering.pairwise_distances(jnp.asarray(x), jnp.asarray(c), metric)
    _close(clustering.pairwise_distances(torch.from_numpy(x), torch.from_numpy(c), metric),
           ref, atol=1e-5)
    with pytest.raises(ValueError):
        clustering.pairwise_distances(torch.from_numpy(x), torch.from_numpy(c), "l7")


def _blobs(seed, t=40, d=8):
    x = _rand(seed, t, d)
    x[t // 2:] += 6.0
    return x


@pytest.mark.parametrize("metric", ["sq_euclidean", "euclidean", "cosine", "dot"])
def test_kmeans_with_the_jax_initial_rows(metric):
    key = jax.random.key(2)
    x = _blobs(12)
    ref_c, ref_l = jclustering.kmeans(jnp.asarray(x), key, num_clusters=3, metric=metric)
    idx = torch.from_numpy(np.array(jax.random.permutation(key, x.shape[0])[:3]))
    c, labels = clustering.kmeans(torch.from_numpy(x), num_clusters=3, metric=metric,
                                  init_idx=idx)
    assert labels.dtype == torch.int32
    assert np.array_equal(labels.numpy(), np.asarray(ref_l))
    _close(c, ref_c, atol=1e-4)


def test_soft_kmeans_with_the_jax_initial_rows():
    key = jax.random.key(4)
    x = _blobs(13)
    ref_c, ref_w = jclustering.soft_kmeans(jnp.asarray(x), key, num_clusters=3,
                                           temperature=4.0)
    idx = torch.from_numpy(np.array(jax.random.permutation(key, x.shape[0])[:3]))
    c, w = clustering.soft_kmeans(torch.from_numpy(x), num_clusters=3, temperature=4.0,
                                  init_idx=idx)
    _close(c, ref_c, atol=1e-4)
    _close(w, ref_w, atol=1e-5)
    _close(w.sum(1), np.ones(x.shape[0]), atol=1e-5)


def test_kmeans_draws_from_the_generator():
    x = torch.from_numpy(_blobs(14))
    a = clustering.kmeans(x, torch.Generator().manual_seed(9), num_clusters=2)
    b = clustering.kmeans(x, torch.Generator().manual_seed(9), num_clusters=2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert len(set(a[1][:20].tolist())) == 1 and a[1][0] != a[1][20]


@pytest.mark.parametrize("metric", ["sq_euclidean", "cosine"])
def test_knn_matches_jax_with_planted_ties(metric):
    """Points 2, 5 and 7 are copies of one row, so every query sees three
    equal distances: both packages keep the lower indices first."""
    pts = _rand(15, 9, 4)
    pts[5] = pts[2]
    pts[7] = pts[2]
    q = np.concatenate([pts[2:3] + 0.01, _rand(16, 3, 4)])
    ref_d, ref_i = jclustering.knn(jnp.asarray(q), jnp.asarray(pts), k=6, metric=metric)
    d, i = clustering.knn(torch.from_numpy(q), torch.from_numpy(pts), k=6, metric=metric)
    assert np.array_equal(i.numpy(), np.asarray(ref_i))
    assert i[0, :3].tolist() == [2, 5, 7]
    _close(d, ref_d, atol=1e-5)


@pytest.mark.parametrize("gamma", [0.1, 1.0])
def test_soft_dtw_matches_jax(gamma):
    x, y = _rand(17, 7, 3), _rand(18, 5, 3)
    ref = float(jclustering.soft_dtw(jnp.asarray(x), jnp.asarray(y), gamma=gamma))
    got = float(clustering.soft_dtw(torch.from_numpy(x), torch.from_numpy(y), gamma=gamma))
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert float(clustering.soft_dtw(torch.from_numpy(x), torch.from_numpy(x), 0.01)) <= 1e-3


def test_pairwise_soft_dtw_matches_jax():
    xs, ys = _rand(19, 3, 5, 2), _rand(20, 4, 6, 2)
    ref = jclustering.pairwise_soft_dtw(jnp.asarray(xs), jnp.asarray(ys))
    got = clustering.pairwise_soft_dtw(torch.from_numpy(xs), torch.from_numpy(ys))
    assert got.shape == (3, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


def test_optical_flow_gradients_and_grayscale_match_jax():
    rgb = np.random.default_rng(21).uniform(0, 255, (2, 3, 12, 20)).astype(np.float32)
    gray = optical_flow.grayscale(torch.from_numpy(rgb))
    _close(gray, jflow.grayscale(jnp.asarray(rgb)), atol=1e-4)
    ix, iy = optical_flow.compute_gradients(gray)
    jix, jiy = jflow.compute_gradients(jnp.asarray(gray.numpy()))
    _close(ix, jix, atol=1e-3)
    _close(iy, jiy, atol=1e-3)
    edge = torch.zeros(1, 8, 8)
    edge[:, :, 4:] = 1.0
    ex, ey = optical_flow.compute_gradients(edge)
    assert ex.abs().max() > 0 and ey[:, 1:-1].abs().max() == 0


@pytest.mark.parametrize("u_only", [False, True])
def test_flow_magnitude_matches_jax(u_only):
    rng = np.random.default_rng(22)
    last = rng.uniform(0, 1, (3, 24, 32)).astype(np.float32)
    cur = np.roll(last, 2, axis=2) + rng.normal(0, 0.01, last.shape).astype(np.float32)
    ref = jflow.flow_magnitude(jnp.asarray(last), jnp.asarray(cur), u_only=u_only)
    got = optical_flow.flow_magnitude(torch.from_numpy(last), torch.from_numpy(cur),
                                      u_only=u_only)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-3)
    static = optical_flow.flow_magnitude(torch.from_numpy(last), torch.from_numpy(last))
    assert (static < 1e-3).all()


def test_keep_frames_matches_jax():
    rng = np.random.default_rng(23)
    base = rng.uniform(0, 1, (16, 16)).astype(np.float32)
    frames = np.stack([base, base, np.roll(base, 3, axis=1) * 4.0, np.roll(base, 3, axis=1) * 4.0,
                       np.roll(np.eye(16, dtype=np.float32), 5, axis=1) * 10.0])
    ref = jflow.keep_frames_optical_flow(jnp.asarray(frames), threshold=0.05)
    got = optical_flow.keep_frames_optical_flow(torch.from_numpy(frames), threshold=0.05)
    assert got.dtype == torch.bool
    assert got.tolist() == np.asarray(ref).tolist()
    assert got[0] and not got[1] and got[2]
