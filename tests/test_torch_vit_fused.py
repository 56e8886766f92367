"""The fused ViT ingest of the port against the JAX package's, on the CPU.

K1's twin in each of the TPU kernel's options (softmax "clamp" / "exact",
folded weights, one-pass LayerNorm, the fc1 activation, the frame tile's
check) against JAX `fused_vit_layer(..., interpret=True)`, f32 inputs, atol
2e-5 (the other kernel parity tests' bound). The folds, the fused and
unfused towers, the clamp check's logit bounds, the lazy fold of
`LongVA.encode_images` and `convert.vit_params` with folded leaves against
the JAX package at `ViTConfig.tiny()`, atol 1e-4 (tests/test_torch_models:
whole towers sum in other orders). On a CPU tensor every wrapper runs its
twin and counts no launch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamchat_tpu import config as jconfig
from streamchat_tpu.models import projector as jproj
from streamchat_tpu.models import vit as jvit
from streamchat_tpu.ops import fused_vit as jfv
from streamchat_tpu_torch import config, convert, kernels
from streamchat_tpu_torch.models import vit
from streamchat_tpu_torch.models.longva import LongVA
from streamchat_tpu_torch.models.tokenizer import ByteTokenizer
from streamchat_tpu_torch.ops import fused_vit

ATOL = 2e-5
TOWER_ATOL = 1e-4


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture
def no_launches():
    kernels.reset_launch_counts()
    yield
    assert all(v == 0 for v in kernels.launch_counts().values()), \
        "a CPU tensor must run the plain twin, never count a launch"


def _layer_weights(d, f, seed):
    r = lambda i, *s, scale=1.0: _rand(seed * 100 + i, *s, scale=scale)  # noqa: E731
    return [1 + r(1, d, scale=0.1), r(2, d, scale=0.1), r(3, d, 3 * d, scale=d ** -0.5),
            r(4, 3 * d, scale=0.1), r(5, d, d, scale=d ** -0.5), r(6, d, scale=0.1),
            1 + r(7, d, scale=0.1), r(8, d, scale=0.1), r(9, d, f, scale=d ** -0.5),
            r(10, f, scale=0.1), r(11, f, d, scale=f ** -0.5), r(12, d, scale=0.1)]


def _folded(w, heads, fold):
    """The 12 K1 operands with wqkv / bqkv / w1 / b1 replaced by `fold`'s."""
    wqkv, bqkv, w1, b1 = fold(w[0], w[1], w[2], w[3], w[6], w[7], w[8], w[9], num_heads=heads)
    return [w[0], w[1], wqkv, bqkv, w[4], w[5], w[6], w[7], w1, b1, w[10], w[11]]


@pytest.mark.parametrize("softmax_mode,folded,ln_onepass,activation,frame_tile", [
    ("clamp", True, True, "quick_gelu", 2),     # the ingest's form
    ("clamp", False, False, "quick_gelu", 2),   # the defaults
    ("exact", True, False, "quick_gelu", 1),
    ("exact", False, True, "gelu", 1),
    ("clamp", True, False, "none", 2),
    ("clamp", False, True, "gelu", 4),
])
def test_vit_layer_options_match_jax_kernel(no_launches, softmax_mode, folded, ln_onepass,
                                            activation, frame_tile):
    n, s, d, f, heads = 4, 17, 64, 128, 4
    w = _layer_weights(d, f, seed=3)
    if folded:
        w = _folded(w, heads, lambda *a, **k: tuple(
            np.asarray(t) for t in jfv.fold_vit_layer_params(*map(jnp.asarray, a), **k)))
    x = _rand(7, n, s, d)
    kw = dict(num_heads=heads, eps=1e-5, activation=activation, frame_tile=frame_tile,
              softmax_mode=softmax_mode, folded=folded, ln_onepass=ln_onepass)
    ref = jfv.fused_vit_layer(jnp.asarray(x), *map(jnp.asarray, w), interpret=True, **kw)
    out = fused_vit.fused_vit_layer(torch.from_numpy(x), *map(torch.from_numpy, w), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    plain = fused_vit.fused_vit_layer_plain(torch.from_numpy(x), *map(torch.from_numpy, w),
                                            **kw)
    np.testing.assert_array_equal(plain.numpy(), out.numpy())


def test_vit_layer_ingest_form_at_577_tokens_matches_jax(no_launches):
    """The ingest's form (folded, one-pass, clamp) at the ViT's 577 tokens:
    the ragged 577-token edges the card kernels mask (a 128-row tile of 65
    queries and one of 65 keys in each frame)."""
    n, s, d, f, heads = 2, 577, 128, 256, 2
    w = _folded(_layer_weights(d, f, seed=5), heads, lambda *a, **k: tuple(
        np.asarray(t) for t in jfv.fold_vit_layer_params(*map(jnp.asarray, a), **k)))
    x = _rand(8, n, s, d)
    kw = dict(num_heads=heads, eps=1e-5, activation="quick_gelu", frame_tile=2,
              softmax_mode="clamp", folded=True, ln_onepass=True)
    ref = jfv.fused_vit_layer(jnp.asarray(x), *map(jnp.asarray, w), interpret=True, **kw)
    out = fused_vit.fused_vit_layer_plain(torch.from_numpy(x), *map(torch.from_numpy, w), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_vit_layer_checks_its_options(no_launches):
    w = [torch.from_numpy(t) for t in _layer_weights(64, 128, seed=1)]
    x = torch.from_numpy(_rand(2, 3, 5, 64))
    with pytest.raises(ValueError, match="frame_tile"):
        fused_vit.fused_vit_layer(x, *w, num_heads=4)            # default frame_tile 2
    with pytest.raises(ValueError, match="softmax_mode"):
        fused_vit.fused_vit_layer(x, *w, num_heads=4, frame_tile=1, softmax_mode="max")
    with pytest.raises(ValueError, match="activation"):
        fused_vit.fused_vit_layer(x, *w, num_heads=4, frame_tile=1, activation="relu")


def test_fold_vit_layer_params_matches_jax():
    d, f, heads = 64, 96, 4
    w = _layer_weights(d, f, seed=5)
    ref = jfv.fold_vit_layer_params(*(jnp.asarray(w[i]) for i in (0, 1, 2, 3, 6, 7, 8, 9)),
                                    num_heads=heads)
    got = fused_vit.fold_vit_layer_params(
        *(torch.from_numpy(w[i]) for i in (0, 1, 2, 3, 6, 7, 8, 9)), num_heads=heads)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-6)


# --- the tower --------------------------------------------------------------

def _perturbed(params, seed):
    """Random LN affines and biases (init leaves them 1 and 0), so the
    folds move every weight."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        a = np.asarray(a)
        if "'scale'" in name:
            return jnp.asarray(a + 0.1 * rng.standard_normal(a.shape).astype(np.float32))
        if "'b'" in name or "'bias'" in name:
            return jnp.asarray(0.1 * rng.standard_normal(a.shape).astype(np.float32))
        return jnp.asarray(a)

    return jax.tree_util.tree_map_with_path(leaf, params)


@pytest.fixture(scope="module")
def jtower():
    jcfg = jconfig.ViTConfig.tiny()
    params = _perturbed(jvit.init(jax.random.key(3), jcfg, dtype=jnp.float32), seed=4)
    return params, jcfg


@pytest.fixture(scope="module")
def tower(jtower):
    params, jcfg = jtower
    return convert.vit_params(_np(params)), config.ViTConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def pixels():
    return _rand(11, 3, 3, 56, 56)


@pytest.mark.parametrize("softmax_mode,select_layer", [("clamp", None), ("exact", -1)])
def test_hidden_states_fused_matches_jax(no_launches, jtower, tower, pixels, softmax_mode,
                                         select_layer):
    (jp, jcfg), (p, cfg) = jtower, tower
    ref = jvit.hidden_states(jp, jnp.asarray(pixels), jcfg, select_layer=select_layer,
                             fused=True, softmax_mode=softmax_mode, interpret=True)
    out = vit.hidden_states(p, torch.from_numpy(pixels), cfg, select_layer=select_layer,
                            fused=True, softmax_mode=softmax_mode)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOWER_ATOL, rtol=0)


@pytest.mark.parametrize("fused", [True, False])
def test_encode_matches_jax(no_launches, jtower, tower, pixels, fused):
    """fused=True against the JAX Pallas path (interpret mode), fused=False
    against JAX's XLA block; the CPU default (None) is the unfused form."""
    (jp, jcfg), (p, cfg) = jtower, tower
    ref = jvit.encode(jp, jnp.asarray(pixels), jcfg, fused=fused, interpret=True)
    out = vit.encode(p, torch.from_numpy(pixels), cfg, fused=fused)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOWER_ATOL, rtol=0)
    if not fused:
        default = vit.encode(p, torch.from_numpy(pixels), cfg)
        np.testing.assert_array_equal(default.numpy(), out.numpy())


def test_use_fused_is_false_on_the_cpu():
    assert vit._use_fused(None, "cpu") is False
    assert vit._use_fused(None, torch.device("cuda")) is True
    assert vit._use_fused(False, "cuda") is False and vit._use_fused(True, "cpu") is True


def test_fold_params_matches_jax_and_is_idempotent(jtower, tower):
    (jp, jcfg), (p, cfg) = jtower, tower
    ref = jvit.fold_params(jp, jcfg)
    got = vit.fold_params(p, cfg)
    assert "fused" not in p["layers"][0], "fold_params must not change its input"
    for jl, tl in zip(ref["layers"], got["layers"]):
        for k in ("wqkv", "bqkv", "w1", "b1"):
            np.testing.assert_allclose(tl["fused"][k].numpy(), np.asarray(jl["fused"][k]),
                                       atol=1e-6, rtol=1e-6)
        assert tl["attn"] is not None and "wqkv" in tl["attn"]   # HF-layout leaves kept
    assert vit.fold_params(got, cfg) is got


def test_convert_keeps_folded_leaves(no_launches, jtower, pixels):
    jp, jcfg = jtower
    jfold = jvit.fold_params(jp, jcfg)
    p = convert.vit_params(_np(jfold))
    cfg = config.ViTConfig(**dataclasses.asdict(jcfg))
    for jl, tl in zip(jfold["layers"], p["layers"]):
        assert set(tl["fused"]) == {"wqkv", "bqkv", "w1", "b1"}
        for k, v in tl["fused"].items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(jl["fused"][k]))
    ref = jvit.encode(jfold, jnp.asarray(pixels), jcfg, fused=True, interpret=True)
    out = vit.encode(p, torch.from_numpy(pixels), cfg, fused=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOWER_ATOL, rtol=0)


def test_attention_logit_bounds_matches_jax(no_launches, jtower, tower, pixels):
    (jp, jcfg), (p, cfg) = jtower, tower
    for select_layer in (None, -1):
        ref = jvit.attention_logit_bounds(jp, jnp.asarray(pixels), jcfg,
                                          select_layer=select_layer)
        out = vit.attention_logit_bounds(p, torch.from_numpy(pixels), cfg,
                                         select_layer=select_layer)
        assert out.shape == ref.shape and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOWER_ATOL, rtol=1e-5)


def test_encode_images_folds_once_and_honors_the_opt_out(no_launches, jtower, tower, pixels,
                                                        monkeypatch):
    """With the fused path on (as on the card), the first encode_images
    folds the tower once and later calls reuse it; SC_NO_VIT_FOLD=1 keeps
    the tree unfolded and folds inside each call, with the same result."""
    (jp, jcfg), (p, cfg) = jtower, tower
    d, lm = cfg.hidden_size, 128
    proj = {"fc1": {"w": _rand(21, d, lm, scale=d ** -0.5), "b": _rand(22, lm, scale=0.1)},
            "fc2": {"w": _rand(23, lm, lm, scale=lm ** -0.5), "b": _rand(24, lm, scale=0.1)}}
    ref = jproj.apply(jax.tree.map(jnp.asarray, proj), jvit.encode(
        jvit.fold_params(jp, jcfg), jnp.asarray(pixels), jcfg, fused=True, interpret=True))
    monkeypatch.setattr(vit, "_use_fused",
                        lambda fused, device: True if fused is None else fused)
    folds = []
    fold = vit.fold_params
    monkeypatch.setattr(vit, "fold_params", lambda *a: folds.append(1) or fold(*a))

    def model():
        return LongVA(vit_params=p, proj_params=convert.to_torch(proj), dec_params={},
                      vit_cfg=cfg, dec_cfg=None, tokenizer=ByteTokenizer(),
                      generator=torch.Generator().manual_seed(0))

    monkeypatch.delenv("SC_NO_VIT_FOLD", raising=False)
    m = model()
    first = m.encode_images(torch.from_numpy(pixels))
    second = m.encode_images(torch.from_numpy(pixels))
    assert len(folds) == 1 and all("fused" in lp for lp in m.vit_params["layers"])
    np.testing.assert_allclose(first.numpy(), np.asarray(ref), atol=TOWER_ATOL, rtol=0)
    np.testing.assert_array_equal(second.numpy(), first.numpy())

    monkeypatch.setenv("SC_NO_VIT_FOLD", "1")
    m = model()
    opted_out = m.encode_images(torch.from_numpy(pixels))
    assert len(folds) == 1 and m.vit_params is p and "fused" not in p["layers"][0]
    np.testing.assert_array_equal(opted_out.numpy(), first.numpy())
