"""Hold this tree's kernels to another checkout's, on one GPU.

    python -m streamchat_tpu_torch.utils.compare_tree OTHER_TREE [--kernels K4 K8 ...]

OTHER_TREE is the root of another checkout of the repo (e.g. the parent
commit unpacked with `git archive`). Its `streamchat_tpu_torch/csrc/` is
built by its own `kernels/build.py` into its own library, beside this
tree's. Every kernel whose C entry point both trees export with the same
signature runs through this tree's wrapper on the same inputs at main-path
shapes (`CASES`: K1 in the ingest's and the exact form, K2-K17, K7′ and W8;
K16 is K1's entry with the bf16-score softmax), once against each library,
and the device time per call of each (torch.profiler, as `chip_smoke.py`
measures it; for K1's ingest form also launch by launch) is taken in
turns: other, this, this, other (K12's kernel alone, without its wrapper's
keep-mask ops). The page-pool kernels (K4, K6-K9) run
through each tree's own `ops/paged_attention.py` wrapper, and the int4
GEMVs (K10 at o and down, K11 at q/k/v and gate/up, each at 1 and 5 rows)
through each tree's own `ops/int4_matmul.py`, and K12 through each tree's
own `ops/dedup.py`, so that each library gets the grid, the split and the
scratch its tree gives it (and its own C signature); K4, K6, K7 and K7′
are timed over four pools in turn (each call
reads its pool cold from HBM), K8 and K9 at the smoke's shape (three rows
of 23,105, 11,905 and 1 tokens through a permuted 184-slot table) and at the
caller pool's (two rows of 6,100 and 3,050 tokens on a 98-page pool, 50
slots, as `generate_paged` pages them; four pools in turn), K10 and K11
over enough layers' weights in turn to exceed the 50 MB L2, and their
wrappers' host time per call is reported too. A case must be
equal bit for bit unless `CASES` names a tolerance for it: the ViT kernels
K1, K2, K13, K14 and K16 (wgmma GEMM and attention since the Hopper
redesign, another summation order), the probes K15 (row ranges summed
in a cluster) and K17 (wgmma, other dot slices), K4, K6, K7 and K7′
(split-K over the pool on wgmma since their Hopper redesign), K8 and K9
(the same kernels through the page table since theirs) and K10 / K11
(tensor cores, ranges summed in a cluster, since theirs) are held to
the other tree's output within the smoke's tolerance instead, |a - b| <=
3e-2 + 2e-2 |b|, and for K4, K6-K11, K13, K14, K15 and K17 also a row
relative L2 error <= 1e-2 (K7 / K7′ through acc / l, m and l
elementwise); K12 (a thread's 16-byte vectors summed in another order
since its redesign) is held as the smoke holds it, equal keep masks and
max |sim - other sim| <= SIM_ATOL = 1e-5. Such a case also reports whether it was equal bit for bit
all the same (`bit_equal_anyway`: a kernel this tree did not change). A
kernel the
other tree does not export, or exports with another C signature and is
not reached through each tree's own wrapper, is timed in this tree alone.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import itertools
import json
import os
import subprocess

import torch

from streamchat_tpu_torch.utils.profiling import device_launches, device_ms, host_us

# Cases whose device time is also reported launch by launch.
BY_LAUNCH = ("K1 ingest form",)
# Cases timed on one kernel of the wrapper's launches (K12's wrapper also runs
# the keep mask's small torch ops).
KERNEL_ONLY = {"K12": "dedup_kernel"}
# case -> (its C entry point, its tolerance against the other tree: None for
# bit for bit, "elementwise", "rows" for elementwise and row relative L2, or
# "sim" for K12's (keep, sim): equal keep masks, max |sim - other| <= SIM_ATOL).
CASES = {
    "K1 ingest form": ("sc_fused_vit_layer", "elementwise"),
    "K1 exact form": ("sc_fused_vit_layer", "elementwise"),
    "K2": ("sc_fused_ln_mlp", "elementwise"),
    "K3": ("sc_flash_attention", None),
    "K4": ("sc_paged_decode", "rows"),
    "K5": ("sc_flash_attention_partial", None),
    "K6": ("sc_paged_decode_int8", "rows"),
    "K7": ("sc_paged_seq_partial", "rows"),
    "K7′": ("sc_paged_seq_partial_int8", "rows"),
    "K8": ("sc_paged_decode_table", "rows"),
    "K9": ("sc_paged_decode_table_int8", "rows"),
    "K8 caller pool": ("sc_paged_decode_table", "rows"),
    "K9 caller pool": ("sc_paged_decode_table_int8", "rows"),
    **{f"K10 {shape} n{n}": ("sc_int4_gemv", "rows") for shape in ("o", "down") for n in (1, 5)},
    **{f"K11 {shape} n{n}": ("sc_int4_gemv", "rows")
       for shape in ("qkv", "gate_up") for n in (1, 5)},
    "K12": ("sc_select_changed_frames", "sim"),
    "K13": ("sc_fused_ln_attn", "rows"),
    "K14": ("sc_vit_attention", "rows"),
    "K15": ("sc_int4_probe", "rows"),
    "K16": ("sc_fused_vit_layer", "elementwise"),
    "K17": ("sc_dotk", "rows"),
    "W8": ("sc_w8a16_gemv", None),
}
ATOL, RTOL, ROW_REL_L2 = 3e-2, 2e-2, 1e-2
# K12's similarities, as chip_smoke.py holds them.
SIM_ATOL = 1e-5
# C entries each tree reaches through its own wrapper module (MODULES, the
# keys of `mods` in `_cases`), compared whatever their C signatures.
OWN_WRAPPER = frozenset({"sc_paged_decode", "sc_paged_decode_int8", "sc_paged_seq_partial",
                         "sc_paged_seq_partial_int8", "sc_paged_decode_table",
                         "sc_paged_decode_table_int8", "sc_int4_gemv",
                         "sc_select_changed_frames"})
MODULES = {"paged": os.path.join("ops", "paged_attention.py"),
           "int4": os.path.join("ops", "int4_matmul.py"),
           "dedup": os.path.join("ops", "dedup.py")}
# LongVA-7B's int4 decode launches: (in, out of each part, layers' weights
# timed in turn so that one call's bytes are not in L2 from the call before).
INT4_SHAPES = {"o": (3584, (3584,), 10), "down": (18944, (3584,), 3),
               "qkv": (3584, (3584, 512, 512), 8), "gate_up": (3584, (18944, 18944), 2)}


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


def _within_sim(got, ref) -> dict:
    """K12's (keep, sim): equal keep masks and max |sim - ref sim| <= SIM_ATOL."""
    (keep, sim), (rkeep, rsim) = got, ref
    err = (sim.float() - rsim.float()).abs().max().item()
    ok = bool(torch.equal(keep, rkeep)) and bool(torch.isfinite(sim).all()) and err <= SIM_ATOL
    return dict(max_abs_err=err, keep_equal=bool(torch.equal(keep, rkeep)), within=ok)


def _equal(a, b) -> bool:
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return bool(torch.equal(a, b))


def _load_module(tree: str, name: str, rel: str):
    """The module at `rel` (a path inside the tree's package) of `tree`,
    loaded under `name`."""
    path = os.path.join(tree, "streamchat_tpu_torch", rel)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_other(tree: str):
    """The other tree's kernel library, built by its own build.py -> (library,
    build seconds, the C entries of CASES it exports with this tree's C
    signature, or at all for an entry reached through its own wrapper)."""
    from streamchat_tpu_torch.kernels.build import SIGNATURES

    mod = _load_module(tree, "other_kernel_build", os.path.join("kernels", "build.py"))
    info = mod.build(force=True)
    lib = ctypes.CDLL(mod.LIB_PATH)
    present = tuple({n for n, _ in CASES.values()
                     if mod.SIGNATURES.get(n) == SIGNATURES[n]
                     or (n in OWN_WRAPPER and n in mod.SIGNATURES)})
    for name in present:
        fn = getattr(lib, name)
        fn.argtypes = mod.SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib, info["seconds"], present


def _cases(g, mods):
    """-> (case -> a call of this tree's wrapper at main-path shapes, case ->
    the call to time where it differs: K4, K6, K7 and K7′ over four pools in
    turn, K10 and K11 over INT4_SHAPES' layers in turn).
    The page-pool, int4 and K12 cases call the wrapper module in
    mods["paged"] / mods["int4"] / mods["dedup"] (this tree's, or the other
    tree's while its library runs)."""
    from streamchat_tpu_torch.ops import attention, fused_vit, quant, vit_attention
    from streamchat_tpu_torch.utils import probe_int4
    from streamchat_tpu_torch.utils import probe_vit_variants as pvv

    bf, dev = torch.bfloat16, "cuda"

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(bf)

    d, f = 1024, 4096
    vit = (1 + rnd(d, scale=0.1), rnd(d, scale=0.1), rnd(d, 3 * d, scale=d ** -0.5),
           rnd(3 * d, scale=0.1), rnd(d, d, scale=d ** -0.5), rnd(d, scale=0.1),
           1 + rnd(d, scale=0.1), rnd(d, scale=0.1), rnd(d, f, scale=d ** -0.5),
           rnd(f, scale=0.1), rnd(f, d, scale=f ** -0.5), rnd(d, scale=0.1))
    x = rnd(16, 577, d)
    folded = list(vit)
    folded[2], folded[3], folded[8], folded[9] = fused_vit.fold_vit_layer_params(
        *(vit[i] for i in (0, 1, 2, 3, 6, 7, 8, 9)), num_heads=16)
    # K2: the projector over 16 frames; K13 / K14: ViT layer shapes.
    f2 = rnd(16 * 576, d)
    proj = (rnd(d, 3584, scale=d ** -0.5), rnd(3584, scale=0.1),
            rnd(3584, 3584, scale=3584 ** -0.5), rnd(3584, scale=0.1))
    q14, k14, v14 = rnd(16, 16, 577, 64), rnd(16, 16, 577, 64), rnd(16, 16, 577, 64)
    # K16: the layer probe's bf16s variant at its [128, 577, 1024].
    x16 = rnd(pvv.N, pvv.S, pvv.D, scale=0.5)
    p16 = pvv.make_params(g, pvv.VARIANTS["bf16s"])
    q3, k3, v3 = rnd(1, 28, 4096, 128), rnd(1, 4, 4096, 128), rnd(1, 4, 4096, 128)
    # K5: the last 3,072-row chunk of a 23,552-token prefill (chip_smoke).
    q5, k5, v5 = rnd(1, 28, 3072, 128), rnd(1, 4, 23552, 128), rnd(1, 4, 23552, 128)
    pages, length = 182, 23105
    q = rnd(1, 28, 1, 128)
    kp, vp = rnd(pages, 4, 128, 128), rnd(pages, 4, 128, 128)
    ln = torch.tensor([length], dtype=torch.int32, device=dev)

    def int8_pool():
        return tuple(torch.randint(-127, 128, (pages, 4, 128, 128), generator=g, device=dev,
                                   dtype=torch.int8) for _ in range(2)) + tuple(
            torch.rand(pages, 4, 128, generator=g, device=dev) * 0.04 + 0.01 for _ in range(2))

    int8_pools = [int8_pool() for _ in range(4)]
    kq, vq, ks, vs = int8_pools[0]
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
    # K8 / K9 on the caller pool of chip_smoke.drive_caller_pool: two rows of
    # 6,100 and 3,050 tokens paged as `from_contiguous` pages their 6,144
    # padded tokens (row r: pool pages [48 r, 48 r + 48)), 98 pages, 50
    # slots; four pools in turn.
    cp_table = torch.full((2, 50), -1, dtype=torch.int32, device=dev)
    cp_table[:, :48] = torch.arange(96, dtype=torch.int32, device=dev).view(2, 48)
    cp_len = torch.tensor([6100, 3050], dtype=torch.int32, device=dev)
    q8c = rnd(2, 28, 1, 128)
    cp_pools = [(rnd(98, 4, 128, 128), rnd(98, 4, 128, 128)) for _ in range(4)]
    cp_int8 = [tuple(torch.randint(-127, 128, (98, 4, 128, 128), generator=g, device=dev,
                                   dtype=torch.int8) for _ in range(2))
               + tuple(torch.rand(98, 4, 128, generator=g, device=dev) * 0.04 + 0.01
                       for _ in range(2)) for _ in range(4)]

    def caller_pool(fn_name, arg_sets):
        it = itertools.cycle(arg_sets)
        return lambda: getattr(mods["paged"], fn_name)(q8c, *next(it), cp_table, cp_len)
    # K7 / K7′: five in-flight queries (spec decode) against the K4 pool;
    # K4 and K7 timed over it and three more.
    q7 = rnd(1, 28, 5, 128)
    pools = [(kp, vp)] + [(rnd(pages, 4, 128, 128), rnd(pages, 4, 128, 128)) for _ in range(3)]

    def rotating(fn_name, qq, arg_sets=pools):
        it = itertools.cycle(arg_sets)
        return lambda: getattr(mods["paged"], fn_name)(qq, *next(it), ln)

    # W8: one decode row against Qwen2-7B's gate width.
    xg = rnd(1, 3584)
    w8 = quant.quantize_weight(rnd(3584, 18944, scale=0.02))
    # K10 / K11 at their path's shapes, 1 and 5 rows, bf16 out (the decoder's).
    int4_cases, int4_timed = {}, {}
    for shape, (kin, outs, layers) in INT4_SHAPES.items():
        qs = [[quant.quantize_weight_int4(rnd(kin, out, scale=0.02)) for out in outs]
              for _ in range(layers)]
        flats = [[t for q in parts for t in (q["w_i4p"], q["scale"])] for parts in qs]
        kernel, fn = ("K10", "qmatvec_int4") if len(outs) == 1 else ("K11", "qmatvec_int4_fused")
        for n in (1, 5):
            x4 = rnd(n, kin)

            def call(flat, x4=x4, fn=fn):
                out = getattr(mods["int4"], fn)(x4, *flat, out_dtype=bf)
                return torch.cat(out, 1) if isinstance(out, tuple) else out

            it = itertools.cycle(flats)
            name = f"{kernel} {shape} n{n}"
            int4_cases[name] = lambda call=call, flat=flats[0]: call(flat)
            int4_timed[name] = lambda call=call, it=it: call(next(it))
    # K12: one segment's frame descriptors; K15: the int4 probe's weight;
    # K17: the dot probe's qk64 operands.
    x12 = torch.randn(60, 3584, generator=g, device=dev)
    w15, s15 = probe_int4.make_weights(g, copies=1)[0][0]
    x15 = rnd(1, probe_int4.DIN)
    a17, b17 = pvv.make_dot_inputs("qk64", g)
    timed = {**int4_timed, "K4": rotating("paged_decode_attention_seq", q),
             "K6": rotating("paged_decode_attention_seq_int8", q, int8_pools),
             "K7": rotating("paged_seq_attention_partial", q7),
             "K7′": rotating("paged_seq_attention_partial_int8", q7, int8_pools),
             "K8 caller pool": caller_pool("paged_decode_attention_table", cp_pools),
             "K9 caller pool": caller_pool("paged_decode_attention_table_int8", cp_int8)}
    return {
        "K1 ingest form": lambda: fused_vit.fused_vit_layer(
            x, *folded, num_heads=16, frame_tile=1, folded=True, ln_onepass=True),
        "K1 exact form": lambda: fused_vit.fused_vit_layer(
            x, *vit, num_heads=16, frame_tile=1, softmax_mode="exact"),
        "K2": lambda: fused_vit.fused_ln_mlp(f2, None, None, *proj, activation="gelu",
                                             layernorm=False, residual=False),
        "K3": lambda: attention.flash_attention(q3, k3, v3, causal=True),
        "K4": lambda: mods["paged"].paged_decode_attention_seq(q, kp, vp, ln),
        "K5": lambda: attention.flash_attention_partial(q5, k5, v5, 20480, 0),
        "K6": lambda: mods["paged"].paged_decode_attention_seq_int8(q, kq, vq, ks, vs, ln),
        "K7": lambda: mods["paged"].paged_seq_attention_partial(q7, kp, vp, ln),
        "K7′": lambda: mods["paged"].paged_seq_attention_partial_int8(q7, kq, vq, ks, vs, ln),
        "K8": lambda: mods["paged"].paged_decode_attention_table(q8, kt, vt, table, lt),
        "K9": lambda: mods["paged"].paged_decode_attention_table_int8(
            q8, kqt, vqt, kst, vst, table, lt),
        "K8 caller pool": lambda: mods["paged"].paged_decode_attention_table(
            q8c, *cp_pools[0], cp_table, cp_len),
        "K9 caller pool": lambda: mods["paged"].paged_decode_attention_table_int8(
            q8c, *cp_int8[0], cp_table, cp_len),
        **int4_cases,
        "K12": lambda: mods["dedup"].select_changed_frames(x12, threshold=0.18,
                                                           return_similarity=True),
        "K13": lambda: fused_vit.fused_ln_attn(x, *vit[:6], num_heads=16),
        "K14": lambda: vit_attention.vit_attention(q14, k14, v14),
        "K15": lambda: probe_int4.matvec(x15, w15, s15, variant="cur"),
        "K16": lambda: pvv.probe_layer(x16, p16, pvv.VARIANTS["bf16s"]),
        "K17": lambda: pvv.dotk(a17, b17),
        "W8": lambda: quant.qmatvec_int8(xg, w8["w_i8"], w8["scale"]),
    }, timed


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("other_tree")
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--kernels", nargs="*", default=None,
                   help="only the cases of these kernels (e.g. K4 K8); default: every case")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_tree: no CUDA device")
    from streamchat_tpu_torch.kernels import build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    build.library()
    tree = os.path.abspath(args.other_tree)
    other, seconds, present = _load_other(tree)
    print(f"other tree's kernels built in {seconds:.2f} s")
    current = build.call
    from streamchat_tpu_torch.ops import dedup, int4_matmul, paged_attention

    this_mods = {"paged": paged_attention, "int4": int4_matmul, "dedup": dedup}
    other_mods = {key: _load_module(tree, f"other_{key}", rel) for key, rel in MODULES.items()}

    def call_into(lib):
        def call(name, *a):
            err = getattr(lib, name)(*a)
            if err != 0:
                raise RuntimeError(f"{name}: CUDA error {err}")
        return call

    mods = dict(this_mods)
    cases, timed = _cases(torch.Generator(device="cuda").manual_seed(7), mods)
    if args.kernels:
        cases = {n: fn for n, fn in cases.items() if n.split()[0] in args.kernels}
    report = {}
    try:
        for name, fn in cases.items():
            entry, tolerance = CASES[name]
            clock = timed.get(name, fn)
            if entry not in present:
                build.call = current
                mods.update(this_mods)
                report[name] = dict(other="absent or another signature",
                                    ms_this=[device_ms(clock, args.iters, KERNEL_ONLY.get(name))
                                             for _ in range(2)])
                print(f"{name}: {json.dumps(report[name])}", flush=True)
                continue
            outs, times = {}, {"other": [], "this": []}
            launches = {"other": [], "this": []}
            host = {"other": [], "this": []}
            for which in ("other", "this", "this", "other"):
                build.call = current if which == "this" else call_into(other)
                mods.update(this_mods if which == "this" else other_mods)
                outs[which] = fn()
                times[which].append(device_ms(clock, args.iters, KERNEL_ONLY.get(name)))
                if name in timed:
                    host[which].append(host_us(clock, args.iters))
                if name in BY_LAUNCH:
                    launches[which].append([ms for _, ms in device_launches(fn, args.iters)])
            if tolerance:
                report[name] = (_within_sim(outs["this"], outs["other"]) if tolerance == "sim"
                                else _within(outs["this"], outs["other"],
                                             rows=tolerance == "rows"))
                report[name]["bit_equal_anyway"] = _equal(outs["this"], outs["other"])
            else:
                report[name] = dict(bit_equal=_equal(outs["this"], outs["other"]))
            report[name].update(ms_other=times["other"], ms_this=times["this"])
            if name in timed:
                report[name].update(host_us_other=host["other"], host_us_this=host["this"])
            if name in BY_LAUNCH:
                report[name].update(launch_ms_other=launches["other"],
                                    launch_ms_this=launches["this"])
            print(f"{name}: {json.dumps(report[name])}", flush=True)
    finally:
        build.call = current
        mods.update(this_mods)
    if not all(r.get("bit_equal", True) and r.get("within", True) for r in report.values()):
        raise SystemExit("compare_tree: outputs differ from the other tree's")
    print(json.dumps(report))


if __name__ == "__main__":
    main()
