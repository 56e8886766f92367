"""Hold this tree's kernels to another checkout's, on one GPU.

    python -m streamchat_tpu_torch.utils.compare_tree OTHER_TREE

OTHER_TREE is the root of another checkout of the repo (e.g. the parent
commit unpacked with `git archive`). Its `streamchat_tpu_torch/csrc/` is
built by its own `kernels/build.py` into its own library, beside this
tree's. The kernels whose C entry points both trees export with the same
signature (K1 `sc_fused_vit_layer` in its exact form, K3
`sc_flash_attention`, K5 `sc_flash_attention_partial` (the smoke's last
chunk of a caption prefill), K4 `sc_paged_decode`, K6
`sc_paged_decode_int8`, and the page-table decode kernels K8
`sc_paged_decode_table` and K9 `sc_paged_decode_table_int8` at the smoke's
shared-pool shapes) run through this tree's wrappers on the same inputs at
main-path shapes, once against each library, and the device time per call
of each (torch.profiler, as `chip_smoke.py` measures it) is taken in turns:
other, this, this, other. K1, K4, K6, K8 and K9 must be equal bit for bit.
K3 and K5 may sum in another order (a kernel redesign changes it), so they
are held to the other tree's output within the smoke's tolerance instead:
|a - b| <= 3e-2 + 2e-2 |b| and a row relative L2 error <= 1e-2 (K5 through
acc / l, with m and l elementwise). A kernel the other tree does not
export, or exports with another C signature (K1 before it took the TPU
kernel's options), is timed in this tree alone.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess

import torch

from streamchat_tpu_torch.utils.profiling import device_ms

KERNELS = ("sc_fused_vit_layer", "sc_flash_attention", "sc_flash_attention_partial",
           "sc_paged_decode", "sc_paged_decode_int8", "sc_paged_decode_table",
           "sc_paged_decode_table_int8")
# Held within tolerance of the other tree's output, not bit for bit.
TOLERANT = ("sc_flash_attention", "sc_flash_attention_partial")
ATOL, RTOL, ROW_REL_L2 = 3e-2, 2e-2, 1e-2


def _within(got, ref, rows: bool = True) -> dict:
    """Elementwise |got - ref| <= ATOL + RTOL |ref| and a row relative L2
    error <= ROW_REL_L2; a (acc, m, l) triple is compared through acc / l
    (0 where l == 0), with m and l elementwise."""
    if isinstance(got, tuple):
        (acc, m, l), (racc, rm, rl) = got, ref

        def norm(a, n):
            return a / torch.where(n == 0, torch.ones_like(n), n)[..., None]

        parts = [_within(norm(acc, l), norm(racc, rl)), _within(m, rm, rows=False),
                 _within(l, rl, rows=False)]
        return dict(max_abs_err=max(p["max_abs_err"] for p in parts),
                    max_row_rel_l2=parts[0]["max_row_rel_l2"],
                    within=all(p["within"] for p in parts))
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    rel = None
    if rows:
        d = ref.shape[-1]
        rel = ((got - ref).reshape(-1, d).norm(dim=-1)
               / ref.reshape(-1, d).norm(dim=-1).clamp_min(1e-6)).max().item()
    ok = (bool(torch.isfinite(got).all()) and not bool((err > ATOL + RTOL * ref.abs()).any())
          and (rel is None or rel <= ROW_REL_L2))
    return dict(max_abs_err=err.max().item(), max_row_rel_l2=rel, within=ok)


def _load_other(tree: str):
    """The other tree's kernel library, built by its own build.py -> (library,
    build seconds, the names of KERNELS it exports with this tree's C
    signature)."""
    from streamchat_tpu_torch.kernels.build import SIGNATURES

    path = os.path.join(tree, "streamchat_tpu_torch", "kernels", "build.py")
    spec = importlib.util.spec_from_file_location("other_kernel_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    info = mod.build(force=True)
    lib = ctypes.CDLL(mod.LIB_PATH)
    present = tuple(n for n in KERNELS if mod.SIGNATURES.get(n) == SIGNATURES[n])
    for name in present:
        fn = getattr(lib, name)
        fn.argtypes = mod.SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib, info["seconds"], present


def _cases(g):
    """name -> a call of this tree's wrapper at main-path shapes."""
    from streamchat_tpu_torch.ops import attention, fused_vit, paged_attention

    bf, dev = torch.bfloat16, "cuda"

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(bf)

    d, f = 1024, 4096
    vit = (1 + rnd(d, scale=0.1), rnd(d, scale=0.1), rnd(d, 3 * d, scale=d ** -0.5),
           rnd(3 * d, scale=0.1), rnd(d, d, scale=d ** -0.5), rnd(d, scale=0.1),
           1 + rnd(d, scale=0.1), rnd(d, scale=0.1), rnd(d, f, scale=d ** -0.5),
           rnd(f, scale=0.1), rnd(f, d, scale=f ** -0.5), rnd(d, scale=0.1))
    x = rnd(16, 577, d)
    q3, k3, v3 = rnd(1, 28, 4096, 128), rnd(1, 4, 4096, 128), rnd(1, 4, 4096, 128)
    # K5: the last 3,072-row chunk of a 23,552-token prefill (chip_smoke).
    q5, k5, v5 = rnd(1, 28, 3072, 128), rnd(1, 4, 23552, 128), rnd(1, 4, 23552, 128)
    pages, length = 182, 23105
    q = rnd(1, 28, 1, 128)
    kp, vp = rnd(pages, 4, 128, 128), rnd(pages, 4, 128, 128)
    ln = torch.tensor([length], dtype=torch.int32, device=dev)
    kq, vq = (torch.randint(-127, 128, (pages, 4, 128, 128), generator=g, device=dev,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(pages, 4, 128, generator=g, device=dev) * 0.04 + 0.01
              for _ in range(2))
    # K8 / K9: three rows of 23,105, 11,905 and 1 tokens over a 288-page
    # pool in a seeded permutation (chip_smoke.check_table_kernels).
    lengths, maxp, pool = (23105, 11905, 1), 184, 288
    perm = torch.randperm(pool, generator=g, device=dev).to(torch.int32)
    table = torch.full((3, maxp), -1, dtype=torch.int32, device=dev)
    used = 0
    for r, n in enumerate(lengths):
        need = -(-n // 128)
        table[r, :need] = perm[used:used + need]
        used += need
    lt = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q8 = rnd(3, 28, 1, 128)
    kt, vt = rnd(pool, 4, 128, 128), rnd(pool, 4, 128, 128)
    kqt, vqt = (torch.randint(-127, 128, (pool, 4, 128, 128), generator=g, device=dev,
                              dtype=torch.int8) for _ in range(2))
    kst, vst = (torch.rand(pool, 4, 128, generator=g, device=dev) * 0.04 + 0.01
                for _ in range(2))
    return {
        "sc_fused_vit_layer": lambda: fused_vit.fused_vit_layer(
            x, *vit, num_heads=16, frame_tile=1, softmax_mode="exact"),
        "sc_flash_attention": lambda: attention.flash_attention(q3, k3, v3, causal=True),
        "sc_flash_attention_partial": lambda: attention.flash_attention_partial(
            q5, k5, v5, 20480, 0),
        "sc_paged_decode": lambda: paged_attention.paged_decode_attention_seq(q, kp, vp, ln),
        "sc_paged_decode_int8": lambda: paged_attention.paged_decode_attention_seq_int8(
            q, kq, vq, ks, vs, ln),
        "sc_paged_decode_table": lambda: paged_attention.paged_decode_attention_table(
            q8, kt, vt, table, lt),
        "sc_paged_decode_table_int8": lambda: paged_attention.paged_decode_attention_table_int8(
            q8, kqt, vqt, kst, vst, table, lt),
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("other_tree")
    p.add_argument("--iters", type=int, default=50)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_tree: no CUDA device")
    from streamchat_tpu_torch.kernels import build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    build.library()
    other, seconds, present = _load_other(os.path.abspath(args.other_tree))
    print(f"other tree's kernels built in {seconds:.2f} s")
    current = build.call

    def call_into(lib):
        def call(name, *a):
            err = getattr(lib, name)(*a)
            if err != 0:
                raise RuntimeError(f"{name}: CUDA error {err}")
        return call

    cases = _cases(torch.Generator(device="cuda").manual_seed(7))
    report = {}
    try:
        for name, fn in cases.items():
            if name not in present:
                build.call = current
                report[name] = dict(other="absent or another signature",
                                    ms_this=[device_ms(fn, args.iters) for _ in range(2)])
                print(f"{name}: {json.dumps(report[name])}", flush=True)
                continue
            outs, times = {}, {"other": [], "this": []}
            for which in ("other", "this", "this", "other"):
                build.call = current if which == "this" else call_into(other)
                outs[which] = fn()
                times[which].append(device_ms(fn, args.iters))
            if name in TOLERANT:
                report[name] = _within(outs["this"], outs["other"])
            else:
                report[name] = dict(bit_equal=bool(torch.equal(outs["this"], outs["other"])))
            report[name].update(ms_other=times["other"], ms_this=times["this"])
            print(f"{name}: {json.dumps(report[name])}", flush=True)
    finally:
        build.call = current
    if not all(r.get("bit_equal", True) and r.get("within", True) for r in report.values()):
        raise SystemExit("compare_tree: outputs differ from the other tree's")
    print(json.dumps(report))


if __name__ == "__main__":
    main()
