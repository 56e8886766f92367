"""Build and load the hand-written CUDA kernels.

Every `csrc/*.cu` file is compiled by its own `nvcc` process (all started
together) into an object, and the objects are linked into one shared
library with a plain C interface, `build/libstreamchat_kernels.so` inside
the package, loaded with `ctypes` (the repo's `native/frameproc.py`
pattern, without a silent fallback: a failed build raises). The library is
rebuilt whenever a source under `csrc/` is newer than it, so a fresh
checkout builds everything from its own sources on first use.

Nothing here runs at import time: the CPU tests import every module of the
package on machines that have no `nvcc` and no GPU.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libstreamchat_kernels.so")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-lineinfo",
]

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_PI64 = ctypes.POINTER(ctypes.c_int64)

# C signatures of the exported functions (all return a cudaError_t as int).
SIGNATURES = {
    "sc_flash_attention": [_P, _PI64, _P, _PI64, _P, _PI64, _P, _PI64, _P,
                           _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "sc_flash_attention_partial": [_P, _PI64, _P, _PI64, _P, _PI64, _P, _P, _P, _P,
                                   _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _F, _P],
    "sc_paged_decode": [_P, _I64, _I64, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _I, _F, _P, _P, _P, _P, _P],
    "sc_paged_decode_int8": [_P, _I64, _I64, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _I, _F, _P, _P, _P, _P, _P],
    "sc_paged_decode_table": [_P, _I64, _I64, _P, _P, _P, _P] + [_I] * 8 + [_F] + [_P] * 5,
    "sc_paged_decode_table_int8": [_P, _I64, _I64, _P, _P, _P, _P, _P, _P] + [_I] * 8 + [_F]
                                  + [_P] * 5,
    "sc_paged_seq_partial": [_P, _I64, _I64, _I64, _I, _P, _P, _P] + [_I] * 7 + [_F]
                            + [_P] * 7,
    "sc_paged_seq_partial_int8": [_P, _I64, _I64, _I64, _I, _P, _P, _P, _P, _P] + [_I] * 7
                                 + [_F] + [_P] * 7,
    "sc_w8a16_gemv": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _I, _P],
    "sc_int4_gemv": [_P, _I, _I, _I, _P, _P, _I, _P, _P, _I, _P, _P, _I, _I, _P, _I, _P],
    "sc_int4_gemv_attributes": [_I, ctypes.POINTER(ctypes.c_int)],
    "sc_fused_vit_layer": [_P] * 19 + [_I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P],
    "sc_fused_ln_mlp": [_P] * 10 + [_I, _I, _I, _I, _I, _I, _I, _F, _P],
    "sc_fused_ln_attn": [_P] * 11 + [_I, _I, _I, _I, _F, _I, _I, _I, _P],
    "sc_vit_attention": [_P, _PI64, _P, _PI64, _P, _PI64, _P, _I, _I, _I, _I, _I, _F, _P],
    "sc_select_changed_frames": [_P, _I, _I, _P, _I, _I, _P],
    "sc_dedup_attributes": [_I, _I, ctypes.POINTER(ctypes.c_int)],
    "sc_empty_kernel": [_I, _I, _P],
    "sc_dotk": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "sc_int4_probe": [_P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _P, _P, ctypes.c_uint, _P, _P],
    "sc_flash_prefill_attributes": [_I, _I, _I, ctypes.POINTER(ctypes.c_int)],
    "sc_gemm": [_P, _I64, _P, _P, _P, _I, _I64, _P, _I, _I64, _I, _I, _I, _I, _P],
    "sc_gemm_attributes": [_I, _I, _I, ctypes.POINTER(ctypes.c_int)],
    "sc_int4_probe_attributes": [_I, _I, _I, ctypes.POINTER(ctypes.c_int)],
    "sc_dotk_attributes": [_I, _I, _I, ctypes.POINTER(ctypes.c_int)],
    "sc_paged_decode_attributes": [_I, _I, _I, ctypes.POINTER(ctypes.c_int)],
    "sc_add_rmsnorm": [_P, _P, _P, _P, _I, _I, _F, _P],
    "sc_bias_rope_append": [_P, _I64, _P, _I64, _P, _I64] + [_P] * 7 + [_I] + [_P] * 4
                           + [_I] * 5 + [_P, _P],
    "sc_silu_mul": [_P, _I64, _P, _I64, _P, _I, _I, _P],
}


def _sources():
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cu")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if not home:
        from torch.utils.cpp_extension import CUDA_HOME

        home = CUDA_HOME
    cand = os.path.join(home, "bin", "nvcc") if home else None
    if cand and os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    deps = _sources() + glob.glob(os.path.join(SRC_DIR, "*.cuh"))
    return any(os.path.getmtime(p) > built for p in deps)


def build(force: bool = False) -> dict:
    """Compile csrc/*.cu into LIB_PATH when stale -> {"seconds", "log", "built"}.

    One nvcc per source, run in parallel, then one link. Raises
    RuntimeError when nvcc fails.
    """
    if not force and not _stale():
        return {"seconds": 0.0, "log": "", "built": False}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = f"{LIB_PATH}.{tag}"
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, LIB_PATH)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return {"seconds": time.perf_counter() - t0, "log": "".join(log), "built": True}


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first when stale)."""
    build()
    lib = ctypes.CDLL(LIB_PATH)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.sc_error_string.argtypes = [ctypes.c_int]
    lib.sc_error_string.restype = ctypes.c_char_p
    return lib


def call(name: str, *args) -> None:
    """Invoke an exported kernel launcher and raise on a CUDA error."""
    lib = library()
    err = getattr(lib, name)(*args)
    if err != 0:
        msg = lib.sc_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
