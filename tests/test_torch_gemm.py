"""The Hopper GEMM's contract and twin, and the kernel library's C entry
points, on the CPU.

`fused_vit.gemm_guard` is the shape guard every GEMM wrapper runs before a
launch, a pure function of shapes, strides (in elements) and dtypes: the
shapes it refuses (K % 64, N % 128, a row stride TMA cannot take, an odd
leading dim in the epilogue, a dtype outside bf16 / f32) raise
GemmShapeError, and every product on a path passes. `gemm_plain` is held to
numpy in f32 (atol 1e-4 on outputs of order one), and the CPU wrapper runs
it without counting a launch. The C signatures the ctypes loader declares
(`kernels/build.SIGNATURES`) are held to the `extern "C"` definitions in
`csrc/`, argument for argument, since nothing here can load the library.
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

from streamchat_tpu_torch import kernels
from streamchat_tpu_torch.kernels import build
from streamchat_tpu_torch.ops import fused_vit

BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("m,n,k", [
    (16 * 577, 3 * 1024, 1024), (16 * 577, 1024, 1024), (16 * 577, 4096, 1024),
    (16 * 577, 1024, 4096),                          # ViT-L's four products (K1)
    (16 * 576, 3584, 1024), (16 * 576, 3584, 3584),  # the projector (K2)
    (66, 128, 128), (66, 256, 256), (2 * 577, 3072, 4096), (0, 128, 64),
])
def test_gemm_guard_takes_the_path_shapes(m, n, k):
    fused_vit.gemm_guard(m, n, k)
    fused_vit.gemm_guard(m, n, k, lda=k + 64, ldr=n + 2, res_dtype=F32, ldc=n, out_dtype=F32)


@pytest.mark.parametrize("kw,match", [
    (dict(m=66, n=128, k=96), "K=96"),
    (dict(m=66, n=128, k=0), "K=0"),
    (dict(m=66, n=192, k=64), "N=192"),
    (dict(m=66, n=0, k=64), "N=0"),
    (dict(m=66, n=128, k=64, lda=68), "lda=68"),
    (dict(m=66, n=128, k=128, lda=64), "lda=64"),
    (dict(m=66, n=128, k=64, ldr=129, res_dtype=BF), "residual leading dim 129"),
    (dict(m=66, n=256, k=64, ldr=128, res_dtype=F32), "residual leading dim 128"),
    (dict(m=66, n=128, k=64, ldc=131), "out leading dim 131"),
    (dict(m=66, n=128, k=64, a_dtype=F32), "bf16"),
    (dict(m=66, n=128, k=64, b_dtype=torch.float16), "bf16"),
    (dict(m=66, n=128, k=64, out_dtype=torch.float16), "out must be bf16 or f32"),
    (dict(m=-1, n=128, k=64), "M=-1"),
])
def test_gemm_guard_raises_the_named_error(kw, match):
    with pytest.raises(fused_vit.GemmShapeError, match=match):
        fused_vit.gemm_guard(**kw)
    assert issubclass(fused_vit.GemmShapeError, ValueError)


@pytest.mark.parametrize("activation", ["none", "quick_gelu", "gelu"])
def test_gemm_twin_matches_numpy(activation):
    rng = np.random.default_rng(4)
    a, b = rng.standard_normal((66, 128)), rng.standard_normal((128, 256)) / 128 ** 0.5
    bias, res = rng.standard_normal(256) * 0.1, rng.standard_normal((66, 256))
    ref = a @ b + bias
    ref = {"none": ref, "quick_gelu": ref / (1 + np.exp(-1.702 * ref)),
           "gelu": 0.5 * ref * (1 + np.vectorize(__import__("math").erf)(ref / 2 ** 0.5))}[
               activation] + res
    t = lambda x: torch.from_numpy(x.astype(np.float32))  # noqa: E731
    kernels.reset_launch_counts()
    got = fused_vit.gemm(t(a), t(b), t(bias), t(res), activation=activation)
    assert got.dtype == F32 and fused_vit.gemm.launches == 0
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)
    got16 = fused_vit.gemm(t(a).to(BF), t(b).to(BF), t(bias).to(BF), t(res),
                           activation=activation, out_dtype=F32)
    assert got16.dtype == F32
    np.testing.assert_array_equal(got16.numpy(), fused_vit.gemm_plain(
        t(a).to(BF), t(b).to(BF), t(bias).to(BF), t(res), activation=activation,
        out_dtype=F32).numpy())


def _c_entries():
    """name -> the parameter list of each `extern "C"` definition in csrc/."""
    out = {}
    for path in sorted(os.listdir(build.SRC_DIR)):
        if not path.endswith(".cu"):
            continue
        text = open(os.path.join(build.SRC_DIR, path)).read()
        for m in re.finditer(r'extern "C" (?:int|const char\*) (sc_\w+)\(([^)]*)\)', text):
            params = [p.strip() for p in m.group(2).split(",") if p.strip()]
            out[m.group(1)] = params
    return out


def _ctype(param):
    if "*" in param:
        return "ptr"
    if param.startswith(("int64_t", "long")):
        return "i64"
    if param.startswith("float"):
        return "f32"
    if param.startswith(("int", "unsigned")):
        return "i32"
    raise AssertionError(f"unexpected C parameter {param!r}")


def _loader_type(argtype):
    if argtype is ctypes.c_void_p or issubclass(argtype, ctypes._Pointer):
        return "ptr"
    return {ctypes.c_int: "i32", ctypes.c_uint: "i32", ctypes.c_int64: "i64",
            ctypes.c_float: "f32"}[argtype]


def test_loader_signatures_match_the_c_entries():
    entries = _c_entries()
    assert set(build.SIGNATURES) <= set(entries), set(build.SIGNATURES) - set(entries)
    for name, argtypes in build.SIGNATURES.items():
        got, want = [_loader_type(a) for a in argtypes], [_ctype(p) for p in entries[name]]
        assert got == want, f"{name}: loader {got} vs C {want}"
