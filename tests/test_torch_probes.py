"""The probe kernels' twins (K15, K16, K17) against the TPU probes' own code.

`scripts/probe_vit_variants.py` and `scripts/probe_int4_kernel.py` are
loaded by path. K16: `probe_layer_plain` in each variant against the TPU
probe's `_attn_mlp_body` called on arrays, with the probe's own
`make_params` weights, at S = 33 and the probe's fixed D = 1024; both round
to bf16 at the same places, so the two agree to one bf16 step of the output
(|diff| <= 1e-2 + 2^-7 |ref|) and to 1e-3 on average (the bf16s rounding
alone moves the mean by 2e-3). K15: `matvec_plain` in each variant against
the probe's `make_kernel` in a `pallas_call` with `matvec`'s specs,
interpret mode, at in 512 x out 1024, block_out 256 and gpb 2 and 3 (3 does
not divide the 4 groups): dma exactly, the rest to 1e-5 of the largest
output. K17: `dotk_plain` against a numpy statement of the
nested kernel `kern` (f32 sums of the dots), to 1e-5 relative. On a CPU
tensor every wrapper runs its twin and counts no launch.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from streamchat_tpu_torch import kernels
from streamchat_tpu_torch.ops import quant
from streamchat_tpu_torch.utils import probe_int4, probe_vit_variants

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"tpu_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jvv():
    return _script("probe_vit_variants")


@pytest.fixture(scope="module")
def ji4():
    return _script("probe_int4_kernel")


@pytest.fixture
def no_launches():
    kernels.reset_launch_counts()
    yield
    assert all(v == 0 for v in kernels.launch_counts().values()), \
        "a CPU tensor must run the plain twin, never count a launch"


def _bf16(a):
    """A numpy array -> (bf16 torch tensor, its values as f32 numpy)."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return t, t.float().numpy()


# --- K16 ----------------------------------------------------------------------

@pytest.mark.parametrize("variant", list(probe_vit_variants.VARIANTS))
def test_probe_layer_twin_matches_tpu_body(no_launches, jvv, variant):
    s = 33
    opt = {**jvv.VARIANTS[variant]}
    flags = {k: opt[k] for k in ("wfold", "ln1p", "bf16s")}
    assert flags == probe_vit_variants.VARIANTS[variant]
    jparams = jvv.make_params(jax.random.key(0), opt)
    params = tuple(_bf16(np.asarray(p.astype(jnp.float32)))[0] for p in jparams)
    x, x32 = _bf16(np.random.default_rng(1).standard_normal((1, s, jvv.D)) * 0.5)
    ref = jvv._attn_mlp_body(jnp.asarray(x32[0]), jparams, opt).astype(jnp.bfloat16)
    ref = np.asarray(ref.astype(jnp.float32))
    out = probe_vit_variants.make_layer(probe_vit_variants.VARIANTS[variant])(x, params)
    assert out.dtype == torch.bfloat16 and out.shape == (1, s, jvv.D)
    got = out[0].float().numpy()
    err = np.abs(got - ref)
    assert np.all(err <= 1e-2 + 2.0 ** -7 * np.abs(ref)), err.max()
    assert err.mean() <= 1e-3, err.mean()
    plain = probe_vit_variants.probe_layer_plain(x, params, probe_vit_variants.VARIANTS[variant])
    assert torch.equal(plain, out)


def test_probe_params_fold_preserves_the_layer(no_launches):
    """wfold's weights (folded from the same draws) compute base's layer."""
    x = (torch.randn(1, 9, probe_vit_variants.D, generator=torch.Generator().manual_seed(2))
         * 0.5).to(torch.bfloat16)
    outs = {}
    for name in ("base", "wfold"):
        opt = probe_vit_variants.VARIANTS[name]
        params = probe_vit_variants.make_params(torch.Generator().manual_seed(3), opt,
                                                device="cpu")
        outs[name] = probe_vit_variants.probe_layer(x, params, opt).float()
    ref = outs["base"]
    assert ((outs["wfold"] - ref).norm() / ref.norm()).item() < 1e-2


# --- K15 ----------------------------------------------------------------------

def _tpu_matvec(ji4, x, w_i4p, scale, variant, block_out, gpb):
    """The probe's `matvec` specs around its `make_kernel`, in interpret mode."""
    n, _ = x.shape
    oh = w_i4p.shape[1]
    g = scale.shape[0]
    bo = min(block_out, -(-oh // 128) * 128)
    gpb = min(gpb, g)
    bk = gpb * ji4.GROUP
    nj, nk = -(-oh // bo), -(-g // gpb)
    xp = jnp.pad(x, ((0, 8 - n), (0, 0)))
    out = pl.pallas_call(
        ji4.make_kernel(variant, gpb, nk, g),
        grid=(nj, nk),
        in_specs=[pl.BlockSpec((8, bk), lambda j, k: (0, k)),
                  pl.BlockSpec((bk, bo), lambda j, k: (k, j)),
                  pl.BlockSpec((gpb, 2, bo), lambda j, k: (k, 0, j))],
        out_specs=pl.BlockSpec((8, 2, bo), lambda j, k: (0, 0, j)),
        out_shape=jax.ShapeDtypeStruct((8, 2, nj * bo), jnp.float32),
        scratch_shapes=[pltpu.VMEM((8, bo), jnp.float32), pltpu.VMEM((8, bo), jnp.float32)],
        interpret=True,
    )(xp, w_i4p, scale)
    return np.asarray(out[:n, :, :oh].reshape(n, 2 * oh))


@pytest.fixture(scope="module")
def int4_case():
    rng = np.random.default_rng(5)
    q = quant.quantize_weight_int4(torch.from_numpy(
        (rng.standard_normal((512, 1024)) * 0.02).astype(np.float32)))
    x, x32 = _bf16(rng.standard_normal((3, 512)))
    return x, x32, q["w_i4p"], q["scale"]


@pytest.mark.parametrize("gpb", [2, 3])
@pytest.mark.parametrize("variant", probe_int4.VARIANTS)
def test_int4_probe_twin_matches_tpu_kernel(no_launches, ji4, int4_case, variant, gpb):
    x, x32, w, scale = int4_case
    ref = _tpu_matvec(ji4, jnp.asarray(x32, jnp.bfloat16), jnp.asarray(w.numpy()),
                      jnp.asarray(scale.numpy()), variant, 256, gpb)
    got = probe_int4.matvec(x, w, scale, variant=variant, block_out=256, gpb=gpb)
    assert got.dtype == torch.float32 and got.shape == (3, 1024)
    if variant == "dma":
        np.testing.assert_array_equal(got.numpy(), ref)
        assert not got[:, 512:].any()
    else:
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5 * np.abs(ref).max(), rtol=0)
    assert torch.equal(got, probe_int4.matvec_plain(x, w, scale, variant, 256, gpb))


def test_int4_probe_unpacks_match_the_dequantized_matmul(no_launches, int4_case):
    x, _, w, scale = int4_case
    ref = x.float() @ quant.dequantize_weight_int4({"w_i4p": w, "scale": scale}, torch.float32)
    for variant in probe_int4.UNPACKS:
        got = probe_int4.matvec(x, w, scale, variant=variant)
        assert ((got - ref).abs().max() / ref.abs().max()).item() < 1e-5
    with pytest.raises(ValueError, match="block_out"):
        probe_int4.matvec(x, w, scale, block_out=200)
    with pytest.raises(ValueError, match="variant"):
        probe_int4.matvec(x, w, scale, variant="xor16")


@pytest.mark.parametrize("block_out,gpb", probe_int4.SWEEP + ((1024, 16),))
def test_int4_probe_card_grid_covers_once_and_fills_the_card(block_out, gpb):
    """K15's card grid at the probe's shape (9472 packed columns, 28 groups):
    every (packed column, group) pair is covered by exactly one card block,
    each block's groups lie in its k-slice, the slices are the TPU probe's
    (gpb groups each, the last one short), and at least two waves of the
    H100's 132 SMs are busy."""
    oh, groups = probe_int4.DOUT // 2, probe_int4.DIN // probe_int4.GROUP
    _, gpb_c, nk = probe_int4._geometry(torch.empty(1, oh, dtype=torch.int8),
                                        torch.empty(groups, 2, oh), "cur", block_out, gpb)
    grid = probe_int4.card_grid(oh, groups, gpb_c)
    blocks = probe_int4.card_blocks(oh, groups, gpb_c)
    assert grid["slices"] == nk and len(blocks) == grid["blocks"] >= 2 * 132
    assert grid["cluster"] in (1, 2, 4, 8)
    cover = np.zeros((groups, oh), np.int64)
    for sl, (c0, c1), (g0, g1) in blocks:
        assert sl * gpb_c <= g0 <= g1 <= min(groups, (sl + 1) * gpb_c)
        cover[g0:g1, c0:c1] += 1
    assert (cover == 1).all()


# --- K17 ----------------------------------------------------------------------

def _numpy_kern(a, b):
    """The TPU probe's `kern`: acc = sum of the dots, in f32, in order."""
    if a.ndim == 3:
        acc = np.zeros((a.shape[1], b.shape[1]), np.float32)
        for i in range(a.shape[0]):
            acc += a[i] @ b
    else:
        acc = np.zeros((a.shape[0], b.shape[2]), np.float32)
        for i in range(b.shape[0]):
            acc += a @ b[i]
    return acc


@pytest.mark.parametrize("kind", probe_vit_variants.DOT_KINDS)
def test_dotk_twin_matches_numpy_kern(no_launches, kind):
    s, n = 45, 6
    dh = int(kind[2:])
    rng = np.random.default_rng(dh + len(kind))
    shapes = ((s, s), (n, s, dh)) if kind.startswith("pv") else ((n, s, dh), (dh, s))
    (a, a32), (b, b32) = (_bf16(rng.standard_normal(shp) * 0.1) for shp in shapes)
    ref = _numpy_kern(a32, b32)
    got = probe_vit_variants.dotk(a, b)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5 * np.abs(ref).max(), rtol=1e-5)


def test_dot_inputs_have_the_probe_shapes():
    g = torch.Generator().manual_seed(0)
    s, nd = probe_vit_variants.S, probe_vit_variants.N_DOTS
    want = {"qk64": ((nd, s, 64), (64, s)), "qk128": ((nd // 2, s, 128), (128, s)),
            "pv64": ((s, s), (nd, s, 64)), "pv128": ((s, s), (nd // 2, s, 128))}
    for kind, shapes in want.items():
        a, b = probe_vit_variants.make_dot_inputs(kind, g, device="cpu")
        assert (tuple(a.shape), tuple(b.shape)) == shapes and a.dtype == torch.bfloat16
    assert probe_vit_variants.dot_flops() == 2 * 577 * 577 * 64 * 96


@pytest.mark.parametrize("kind", probe_vit_variants.DOT_KINDS)
def test_dot_split_fills_one_wave(kind):
    """K17's dot slices: every dot in exactly one slice, and the tiles times
    the slices within one wave of the H100's 132 SMs (5 x 5 tiles and 5
    slices for qk, 5 row tiles and 24 slices for pv)."""
    pv, dh = kind.startswith("pv"), int(kind[2:])
    n, s = probe_vit_variants.N_DOTS * 64 // dh, probe_vit_variants.S
    per, nsplit = probe_vit_variants.dot_split(pv, s, n)
    assert (nsplit - 1) * per < n <= nsplit * per
    tiles = 5 if pv else 25
    assert nsplit == (24 if pv else 5) and tiles * nsplit <= 132

