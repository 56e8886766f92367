"""The port's S2 multiscale tower, anyres preprocessing and host frame
preprocessing (`native/frameproc`) against the JAX package's, on the CPU.

S2 runs both towers on the same converted float32 weights (tolerance 1e-5
absolute); its upscale is held to `jax.image.resize` on its own, and the
plain bicubic `F.interpolate` is shown to miss it. anyres is held
byte-equal to the JAX functions (both preprocess through the same C++
source, each package building its own copy). frameproc repeats
`tests/test_native.py`'s cases against the port's `preprocess_frames`.
"""

import concurrent.futures
import dataclasses
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamchat_tpu import config as jconfig
from streamchat_tpu.models import vit as jvit
from streamchat_tpu.native import frameproc as jframeproc
from streamchat_tpu.pipeline import anyres as janyres
from streamchat_tpu_torch import config, convert
from streamchat_tpu_torch.models import vit
from streamchat_tpu_torch.native import frameproc
from streamchat_tpu_torch.pipeline import anyres
from streamchat_tpu_torch.pipeline.preprocess import CLIP_MEAN, CLIP_STD, preprocess_frames

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S2_ATOL = 1e-5
# LLaVA-NeXT's grid pinpoints at base 336, and a range string.
PINPOINTS = [[[336, 672], [672, 336], [672, 672], [1008, 336], [336, 1008]],
             "(1x1)...(3x3)", [[112, 56], [56, 112]]]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these tiny tensors: the suite runs a worker
    per core, and torch's thread pools then contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def towers():
    cfg = jconfig.ViTConfig.tiny()
    params = jvit.init(jax.random.key(0), cfg, jnp.float32)
    port = convert.vit_params(jax.tree.map(np.asarray, params))
    return params, cfg, port, config.ViTConfig(**dataclasses.asdict(cfg))


def _pixels(n, size, seed=1):
    return np.random.default_rng(seed).standard_normal((n, 3, size, size)).astype(np.float32)


@pytest.mark.parametrize("scales", [(56, 112), (56, 112, 168)], ids=["2x", "2x-3x"])
def test_encode_s2_matches_jax(towers, scales):
    params, cfg, port, pcfg = towers
    pixels = _pixels(2, cfg.image_size)
    ref = np.asarray(jvit.encode_s2(params, jnp.asarray(pixels), cfg, scales=scales))
    out = vit.encode_s2(port, torch.from_numpy(pixels), pcfg, scales=scales).numpy()
    assert out.shape == ref.shape == (2, cfg.num_patches, cfg.hidden_size * len(scales))
    np.testing.assert_allclose(out, ref, atol=S2_ATOL, rtol=0)


@pytest.mark.parametrize("size,to", [(56, 112), (56, 168), (8, 16)])
def test_s2_resize_matches_jax_and_plain_bicubic_does_not(size, to):
    """The upscale is torch's antialiased bicubic (a = -0.5, edge taps
    renormalized), which is JAX's; the plain one (a = -0.75, clamped
    edges) misses it by far more than the tolerance."""
    x = _pixels(2, size, seed=size)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3, to, to), "bicubic",
                                      antialias=False))
    got = vit.s2_resize(torch.from_numpy(x), to).numpy()
    np.testing.assert_allclose(got, ref, atol=S2_ATOL, rtol=0)
    plain = torch.nn.functional.interpolate(torch.from_numpy(x), size=(to, to),
                                            mode="bicubic", align_corners=False).numpy()
    assert np.abs(plain - ref).max() > 1e-2


def test_encode_s2_rejects_non_multiple_scale(towers):
    _, cfg, port, pcfg = towers
    with pytest.raises(ValueError, match="not a multiple"):
        vit.encode_s2(port, torch.zeros(1, 3, 56, 56), pcfg, scales=(56, 100))


@pytest.mark.parametrize("pins", PINPOINTS, ids=["llava-next", "range", "list"])
@pytest.mark.parametrize("size", [(100, 200), (360, 640), (700, 300)])
def test_anyres_helpers_match_jax(pins, size):
    h, w = size
    assert (anyres.parse_grid_pinpoints(pins, 336)
            == janyres.parse_grid_pinpoints(pins, 336))
    resolved = anyres.parse_grid_pinpoints(pins, 336)
    assert (anyres.select_best_resolution((w, h), resolved)
            == janyres.select_best_resolution((w, h), resolved))
    assert (anyres.get_anyres_image_grid_shape((w, h), pins, 336)
            == janyres.get_anyres_image_grid_shape((w, h), pins, 336))


@pytest.mark.parametrize("size,pins,base", [
    ((100, 200), [[112, 56], [56, 112]], 56),
    ((90, 60), "(1x1)...(2x2)", 28),
    ((120, 213), [[56, 112], [112, 112], [168, 56]], 56),
])
def test_process_anyres_image_byte_equal_to_jax(size, pins, base):
    img = np.random.default_rng(sum(size)).integers(0, 256, size + (3,), np.uint8)
    ref = janyres.process_anyres_image(img, pins, base_size=base)
    out = anyres.process_anyres_image(img, pins, base_size=base)
    assert out.dtype == ref.dtype == np.float32
    assert out.shape == ref.shape and out.tobytes() == ref.tobytes()
    tiles = anyres.divide_to_patches(anyres.resize_and_pad(img, (2 * base, base)), base)
    jtiles = janyres.divide_to_patches(janyres.resize_and_pad(img, (2 * base, base)), base)
    assert all(np.array_equal(a, b) for a, b in zip(tiles, jtiles))


def test_frameproc_source_is_a_copy():
    assert filecmp.cmp(frameproc.SRC, os.path.join(REPO, "native", "frameproc.cpp"),
                       shallow=False)


@pytest.mark.parametrize("shape,size", [((3, 100, 140, 3), 56), ((2, 90, 60, 3), 28)])
def test_frameproc_matches_jax_host_and_device_preprocess(shape, size):
    """The JAX package's own bound against the device op (interior mean
    difference < 0.08), and the JAX package's host library bit for bit."""
    frames = np.random.default_rng(0).integers(0, 256, shape, np.uint8)
    host = frameproc.preprocess_frames_host(frames, image_size=size)
    assert host.tobytes() == jframeproc.preprocess_frames_host(frames, size).tobytes()
    dev = preprocess_frames(frames, size).numpy()
    assert host.shape == dev.shape == (shape[0], 3, size, size)
    assert float(np.mean(np.abs(host - dev)[:, :, 2:-2, 2:-2])) < 0.08


def test_frameproc_identity_at_s_by_s():
    out = frameproc.preprocess_frames_host(np.full((1, 56, 56, 3), 128, np.uint8), 56)
    expected = (128 / 255.0 - np.asarray(CLIP_MEAN)) / np.asarray(CLIP_STD)
    assert np.allclose(out[0, :, 10, 10], expected, atol=1e-3)


def test_frameproc_thread_counts_agree():
    frames = np.random.default_rng(1).integers(0, 256, (8, 90, 120, 3), np.uint8)
    a = frameproc.preprocess_frames_host(frames, 56, num_threads=1)
    b = frameproc.preprocess_frames_host(frames, 56, num_threads=4)
    assert np.array_equal(a, b)


def test_frameproc_empty_batch():
    out = frameproc.preprocess_frames_host(np.zeros((0, 10, 10, 3), np.uint8), 56)
    assert out.shape == (0, 3, 56, 56)


def test_frameproc_builds_race_free(monkeypatch, tmp_path):
    """Builds that run at once each write a name of their own and replace
    the library whole; the result loads and reports the source's ABI."""
    monkeypatch.setattr(frameproc, "SO", str(tmp_path / "libframeproc.so"))
    monkeypatch.setattr(frameproc, "_lib", None)
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        built = [f.result() for f in [pool.submit(frameproc.build, True) for _ in range(3)]]
    assert all(b["built"] for b in built)
    assert sorted(os.listdir(tmp_path)) == ["libframeproc.so"]
    assert frameproc.library().frameproc_abi_version() == frameproc.ABI_VERSION


def test_frameproc_build_failure_and_abi_mismatch_raise(monkeypatch, tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(frameproc, "SO", str(tmp_path / "libframeproc.so"))
    monkeypatch.setattr(frameproc, "_lib", None)
    monkeypatch.setattr(frameproc, "SRC", str(bad))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        frameproc.preprocess_frames_host(np.zeros((1, 8, 8, 3), np.uint8), 8)
    monkeypatch.setattr(frameproc, "SRC", os.path.join(REPO, "native", "frameproc.cpp"))
    monkeypatch.setattr(frameproc, "ABI_VERSION", 2)
    with pytest.raises(RuntimeError, match="ABI version 1, expected 2"):
        frameproc.library()
