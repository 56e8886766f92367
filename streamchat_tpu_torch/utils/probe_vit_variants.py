"""The ViT-layer variant probe (K16) and the dot probe (K17) on the card.

Counterpart of `scripts/probe_vit_variants.py`, the TPU probe of where the
fused ViT layer's time goes beyond its matrix-product floor.

    python -m streamchat_tpu_torch.utils.probe_vit_variants                # all, then dotk
    python -m streamchat_tpu_torch.utils.probe_vit_variants --variant combo
    python -m streamchat_tpu_torch.utils.probe_vit_variants --variant dotk

Layer variants (K16), each one ViT-L block over x [128, 577, 1024] bf16 with
the clamp softmax, launched as K1's sequence (`ops.fused_vit.launch_layer`)
with the variant's flags:
  base  - LN affines in the kernel, two-pass LN statistics;
  wfold - LN1 / LN2 affines folded into wqkv / fc1 and dh^-0.5 * log2(e)
          into the q columns (softmax as exp2, clamp at 80 log2 e);
  ln1p  - one-pass LN statistics (E[x], E[x^2]);
  bf16s - scores rounded to bf16 after the f32 product, min(s, 80) and the
          exp in bf16 (a numerics-ceiling probe, not a production form);
  combo - wfold + ln1p: the form the ingest runs (models/vit `_block_fused`).
The TPU probe's ft4, ft4u and combo4 changed only Mosaic's frame tile (how
many frames one grid step holds in VMEM); the card's launches have no such
tile, so they are not variants here. Timing chains the calls, each output
feeding the next input, at two chain lengths; the time per layer call is
the slope (the TPU probe's `time_scan`).

The dot probe (K17, `--variant dotk`) sums 96 dots of [577, 64] x [64, 577]
(qk64), 48 of [577, 128] x [128, 577] (qk128), 96 of [577, 577] x [577, 64]
(pv64) or 48 of [577, 577] x [577, 128] (pv128) into one f32 output, the
same 4.09 GFLOP each, and prints the device time per call (torch.profiler:
a call of tens of microseconds is as short as its wrapper's host work) and
the TFLOP/s.

Weights and inputs are random from a seed. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess

import torch

from streamchat_tpu_torch.kernels import counted, launched
from streamchat_tpu_torch.ops import fused_vit

N, S, D, HEADS, DMID = 128, 577, 1024, 16, 4096
HEAD_DIM = D // HEADS
LOG2E = math.log2(math.e)
VARIANTS = {
    "base": dict(wfold=False, ln1p=False, bf16s=False),
    "wfold": dict(wfold=True, ln1p=False, bf16s=False),
    "ln1p": dict(wfold=False, ln1p=True, bf16s=False),
    "bf16s": dict(wfold=False, ln1p=False, bf16s=True),
    "combo": dict(wfold=True, ln1p=True, bf16s=False),
}
N_DOTS = 96
DOT_KINDS = ("qk64", "qk128", "pv64", "pv128")
# K17's output tiles are 128 rows (by 128 columns for qk); the dots are split
# so that at most one wave of the H100's 132 SMs runs.
TARGET_BLOCKS = 132
DOT_TILE = 128
# pv keeps a's 128-row tile (ceil(S / 64) boxes of 16 KB) and a 3-stage ring
# of 64-row slabs of b[i] in shared memory (csrc/dotk.cu PvLayout).
_SMEM_MAX = 232448


class DotShapeError(ValueError):
    """A dotk shape the kernel does not take (raised before any launch)."""


def dot_split(pv: bool, s: int, n: int):
    """-> (dots per slice, slices) of a dotk launch over n dots at S = s."""
    tiles = -(-s // DOT_TILE) * (1 if pv else -(-s // DOT_TILE))
    per = -(-n // min(n, max(1, TARGET_BLOCKS // tiles)))
    return per, -(-n // per)


def variant_mode(opt) -> str:
    """The name a K16 launch is tallied under (kernels.launch_modes)."""
    return "+".join(k for k in ("wfold", "ln1p", "bf16s") if opt[k]) or "base"


def make_params(generator: torch.Generator, opt, device="cuda"):
    """The 12 layer operands of the TPU probe's `make_params`: random f32,
    the wfold variants folded in f32 (LN affines into wqkv / fc1, the q
    scale into wqkv's q columns, LN scales 1 and biases 0 left behind),
    then bf16."""
    def rnd(*shape, scale):
        return torch.randn(*shape, generator=generator, device=device) * scale

    d = D
    g1, c1 = 1.0 + rnd(d, scale=0.1), rnd(d, scale=0.1)
    wqkv, bqkv = rnd(d, 3 * d, scale=d ** -0.5), rnd(3 * d, scale=0.1)
    wo, bo = rnd(d, d, scale=d ** -0.5), rnd(d, scale=0.1)
    g2, c2 = 1.0 + rnd(d, scale=0.1), rnd(d, scale=0.1)
    w1, b1 = rnd(d, DMID, scale=d ** -0.5), rnd(DMID, scale=0.1)
    w2, b2 = rnd(DMID, d, scale=DMID ** -0.5), rnd(d, scale=0.1)
    if opt["wfold"]:
        bqkv = bqkv + c1 @ wqkv
        wqkv = wqkv * g1[:, None]
        b1 = b1 + c2 @ w1
        w1 = w1 * g2[:, None]
        scale = HEAD_DIM ** -0.5 * LOG2E
        wqkv[:, :d] *= scale
        bqkv[:d] *= scale
        g1, c1 = torch.ones_like(g1), torch.zeros_like(c1)
        g2, c2 = torch.ones_like(g2), torch.zeros_like(c2)
    return tuple(t.to(torch.bfloat16) for t in
                 (g1, c1, wqkv, bqkv, wo, bo, g2, c2, w1, b1, w2, b2))


def probe_layer_plain(x, params, opt):
    """Plain PyTorch twin of `probe_layer`: the TPU probe's `_attn_mlp_body`
    (K1's `_layer_kernel` with the clamp softmax, plus bf16s)."""
    return fused_vit._layer_plain(
        x, *params, num_heads=x.shape[-1] // HEAD_DIM, eps=1e-5, activation="quick_gelu",
        softmax_mode="clamp", folded=opt["wfold"], ln_onepass=opt["ln1p"],
        bf16_scores=opt["bf16s"])


@counted
def probe_layer(x, params, opt):
    """One ViT block of variant `opt` over x [N, S, D] (K16, head dim 64).

    CPU tensors run the plain twin; CUDA tensors launch K1's sequence with
    the variant's flags (bf16, D and the MLP width multiples of 128) or
    raise."""
    if x.device.type == "cpu":
        return probe_layer_plain(x, params, opt)
    softmax = fused_vit.SOFTMAX_CLAMP_BF16 if opt["bf16s"] else fused_vit.SOFTMAX["clamp"]
    out = fused_vit.launch_layer(
        x, *params, num_heads=x.shape[-1] // HEAD_DIM, eps=1e-5, activation="quick_gelu",
        softmax=softmax, folded=opt["wfold"], ln_onepass=opt["ln1p"], name="probe_layer")
    launched(probe_layer, variant_mode(opt))
    return out


def make_layer(opt):
    """The layer of variant `opt` as a callable (x, params) -> out."""
    return lambda x, params: probe_layer(x, params, opt)


def _events_ms(fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def time_chain(layer, params, x, lengths=(2, 6), reps=3):
    """ms per layer call from the slope between two chain lengths (each
    call's output is the next call's input) -> (ms, {length: best ms})."""
    def chain(n):
        c = x
        for _ in range(n):
            c = layer(c, params)
        return c

    chain(1)
    torch.cuda.synchronize()
    best = {n: min(_events_ms(lambda n=n: chain(n)) for _ in range(reps)) for n in lengths}
    (l1, t1), (l2, t2) = sorted(best.items())
    return (t2 - t1) / (l2 - l1), best


def run_variant(name: str, generator: torch.Generator) -> dict:
    opt = VARIANTS[name]
    x = (torch.randn(N, S, D, generator=generator, device="cuda") * 0.5).to(torch.bfloat16)
    params = make_params(generator, opt)
    ms, raw = time_chain(make_layer(opt), params, x)
    out = {"variant": name, **opt, "ms_per_layer_call": ms,
           "eq_frames_per_s_24l": N / (ms * 1e-3 * 24), "raw_ms": raw}
    print(json.dumps(out), flush=True)
    return out


def dotk_plain(a, b):
    """Plain PyTorch twin of `dotk`: every dot in f32 (no operand is summed
    before its product), summed."""
    if a.dim() == 3:                     # [S, n dh] @ [n dh, S]: the n dots' sum
        n, s, _ = a.shape
        return a.float().permute(1, 0, 2).reshape(s, -1) @ b.float().repeat(n, 1)
    n, s, dh = b.shape                   # [S, S] @ [S, n dh], then the sum over n
    return (a.float() @ b.float().permute(1, 0, 2).reshape(s, -1)).reshape(s, n, dh).sum(1)


@counted
def dotk(a, b):
    """The sum of many dots into one f32 output (K17): a [n, S, dh] and b
    [dh, S] -> sum_i a[i] @ b [S, S] (qk), or a [S, S] and b [n, S, dh] ->
    sum_i a @ b[i] [S, dh] (pv); dh 64 or 128.

    CPU tensors run the plain twin; CUDA tensors (contiguous bf16) launch
    `csrc/dotk.cu` or raise (DotShapeError for a shape it does not take)."""
    if a.device.type == "cpu":
        return dotk_plain(a, b)
    from streamchat_tpu_torch.kernels.build import call

    pv = a.dim() == 2
    n, s, dh = (b.shape if pv else a.shape)
    want_a, want_b = ((s, s), (n, s, dh)) if pv else ((n, s, dh), (dh, s))
    for name, t, shape in (("a", a, want_a), ("b", b, want_b)):
        fused_vit._check_cuda(f"dotk {name}", t, torch.bfloat16, shape)
    if dh not in (64, 128):
        raise DotShapeError(f"dotk: head dim {dh}, expected 64 or 128")
    if pv and -(-s // 64) * 16384 + 3 * dh * 128 + 48 + 1024 > _SMEM_MAX:
        raise DotShapeError(f"dotk: pv at S = {s} needs more shared memory than a block has")
    if (b if pv else a).data_ptr() % 16:
        raise DotShapeError("dotk: the operand TMA reads must be 16-byte aligned")
    per, nsplit = dot_split(pv, s, n)
    y = torch.empty(s, dh if pv else s, dtype=torch.float32, device=a.device)
    partial = torch.empty(nsplit, *y.shape, dtype=torch.float32, device=a.device) \
        if nsplit > 1 else y
    call("sc_dotk", a.data_ptr(), b.data_ptr(), y.data_ptr(), partial.data_ptr(), int(pv), s,
         dh, n, per, nsplit, fused_vit._stream())
    launched(dotk, f"{'pv' if pv else 'qk'}{dh}")
    return y


def dot_attributes(kind: str, s: int = S) -> dict:
    """The compiled K17 kernel of `kind` (registers and local (spill) bytes
    per thread, static and dynamic shared bytes at S = s), and the blocks a
    launch at the probe's n runs."""
    import ctypes

    from streamchat_tpu_torch.kernels.build import library

    pv, dh = kind.startswith("pv"), int(kind[2:])
    out = (ctypes.c_int * 4)()
    err = library().sc_dotk_attributes(int(pv), dh, s, out)
    if err:
        raise RuntimeError(f"sc_dotk_attributes: CUDA error {err}")
    tiles = -(-s // DOT_TILE) * (1 if pv else -(-s // DOT_TILE))
    return dict(num_regs=out[0], local_bytes=out[1], static_shared_bytes=out[2],
                dynamic_shared_bytes=out[3],
                blocks=tiles * dot_split(pv, s, N_DOTS * 64 // dh)[1])


def make_dot_inputs(kind: str, generator: torch.Generator, device="cuda"):
    """The TPU probe's operands of `kind` (values 0.1 N(0, 1), bf16)."""
    dh = int(kind[2:])
    n = N_DOTS * 64 // dh
    a_shape, b_shape = ((S, S), (n, S, dh)) if kind.startswith("pv") else ((n, S, dh), (dh, S))
    return tuple((torch.randn(*shp, generator=generator, device=device) * 0.1).to(torch.bfloat16)
                 for shp in (a_shape, b_shape))


def dot_flops() -> int:
    return 2 * S * S * 64 * N_DOTS          # identical for all four kinds


def run_dotk(generator: torch.Generator, iters: int = 50) -> dict:
    """Device time per call and TFLOP/s of each kind -> {kind: row}."""
    from streamchat_tpu_torch.utils.profiling import device_ms

    rows = {}
    for kind in DOT_KINDS:
        a, b = make_dot_inputs(kind, generator)
        ms = device_ms(lambda: dotk(a, b), iters)
        rows[kind] = {"kind": kind, "us_per_call": ms * 1e3,
                      "tflops": dot_flops() / (ms * 1e-3) / 1e12}
        print(json.dumps(rows[kind]), flush=True)
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", default=None, choices=list(VARIANTS) + ["dotk"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_vit_variants: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    names = [args.variant] if args.variant else list(VARIANTS) + ["dotk"]
    results = {}
    for name in names:
        results[name] = run_dotk(g) if name == "dotk" else run_variant(name, g)
    return results


if __name__ == "__main__":
    main()
