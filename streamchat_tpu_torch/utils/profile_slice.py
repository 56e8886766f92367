"""Profile the slice's phases at full LongVA-7B width on one GPU.

    python -m streamchat_tpu_torch.utils.profile_slice [--weights bf16|int8|int4] [--kv_int8]
        [--spec_tokens N] [--caller_pool]

Random seeded weights, bf16; `--weights int8` / `int4` quantizes the
decoder after the build (as the CLI's `--int8` / `--int4` do),
`--kv_int8` stores the KV pages as int8 and `--spec_tokens N` decodes in
verify steps of N drafts (the CLI's flag). Three profiled windows under `torch.profiler`
(CPU + CUDA activities), each after a warm-up:

* ingest: 64 frames of a 360x640 synthetic video (the padded 60-frame
  segment) through preprocess, ViT-L (23 layers) and the projector;
* a chunk-40 caption (~23.4k-token prompt) with 1 new token, which is
  the prefill (in chunks: K3, then K5) and one logits row (with
  `--spec_tokens`, one verify step);
* the same caption with 33 new tokens, so the difference of the two is
  32 decode steps at a 23.4k context.

With `--caller_pool` the windows are instead `generate_paged` on a
caller-sized pool, the path of the page-table kernels K8 (K9 with
`--kv_int8`): two rows of 6,100 and 3,050 tokens (6,144 padded, seeded
random embeddings), 98 pages of 128 tokens and 50 table slots a row (as
`chip_smoke.drive_caller_pool`), with 1 and with 33 new tokens, so that
their difference is 32 decode steps of B = 2; it prints a step's device
ms, wall ms and idle share, and the page kernels' share of it.

Then the decode step alone, graphed and eager: the same caption through
`generate_paged` with 2 and with 34 new tokens, once with the step replayed
as a CUDA graph (the default on the card) and once eager (`graph=False`).
Both windows of a pair hold the prefill, the warm-up step and (graphed) the
capture, so their difference is 32 steps at a 23.4k context: it prints a
step's wall ms, device ms, idle share and kernel launches, for each form.

For each window it prints the host wall time (from before the first launch
to after a device synchronize), the device time (the sum of the durations
of every device event the profiler recorded, kernels and copies; the slice
runs on one stream, so they do not overlap), the idle share 1 - device
time / wall, the kernels with the largest device time, and the device time
and share of the int4 GEMVs (K10 / K11: the `int4_gemv` kernels) and of the
page kernels (K4, K6-K9: `paged_tc` and their merge). Last, an unprofiled
129-token caption (caller pool: 65 new tokens) gives decode ms per step
without the profiler's host overhead, and the peak device memory.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch


# Name parts of the kernels whose time is reported apart.
GROUPS = {"K10/K11 (int4_gemv)": ("int4_gemv",),
          "page kernels (paged_tc + merge)": ("paged_tc", "tc::merge_kernel")}


def summarize(prof, wall: float, label: str, rows: int = 18) -> dict:
    """Prints the window's summary -> dict(wall, busy, and each GROUPS
    label's device seconds) in seconds."""
    from torch.autograd import DeviceType

    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e6
    print(f"== {label}: wall {wall:.4f} s, device kernel time {busy:.4f} s, "
          f"idle share {1 - busy / wall:.3f}, kernels {len(kern)}")
    by = {}
    for e in kern:
        name = e.name[:90]
        t, n = by.get(name, (0.0, 0))
        by[name] = (t + e.time_range.elapsed_us() / 1e6, n + 1)
    for name, (t, n) in sorted(by.items(), key=lambda kv: -kv[1][0])[:rows]:
        print(f"   {t:9.4f} s  {100 * t / busy:5.1f}%  n={n:6d}  {name}")
    out = dict(wall=wall, busy=busy)
    for group, parts in GROUPS.items():
        mine = [e for e in kern if any(part in e.name for part in parts)]
        out[group] = t = sum(e.time_range.elapsed_us() for e in mine) / 1e6
        print(f"   {group}: {t:.6f} s, {100 * t / max(busy, 1e-12):.1f}% of device "
              f"time, {len(mine)} launches")
    out["kernels"] = len(kern)
    return out


def decode_steps(m, prompt, chunk, activities) -> None:
    """The graphed and the eager decode step at the caption's context: 34
    minus 2 new tokens, each pair under the profiler (temperature 0.1)."""
    from torch.profiler import profile

    from streamchat_tpu_torch.models import generate_paged as gp

    embeds, length = m.splice_prompt(prompt, [chunk])
    ln = torch.tensor([length], dtype=torch.int32, device="cuda")
    kw = dict(temperature=0.1, eos_ids=(), **m._paged_budget())
    for graph, form in ((None, "graphed"), (False, "eager")):
        seen = {}
        for new in (2, 34):
            stats = {}
            with profile(activities=activities) as prof:
                t0 = time.perf_counter()
                gp.generate_paged(m.dec_params, m.dec_cfg, embeds, ln, m.generator,
                                  max_new_tokens=new, stats=stats, graph=graph, **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            print(json.dumps(stats))
            seen[new] = summarize(prof, wall, f"caption 40 frames, {new} new tokens, {form}",
                                  rows=8)
        step = {k: (seen[34][k] - seen[2][k]) / 32 for k in seen[2]}
        print(f"== {form} decode step (34 - 2 new tokens, / 32; context {length}): wall "
              f"{1e3 * step['wall']:.3f} ms, device {1e3 * step['busy']:.3f} ms, idle share "
              f"{1 - step['busy'] / step['wall']:.3f}, {step['kernels']:.1f} kernels a step")


def caller_pool(m, activities) -> None:
    """The `--caller_pool` windows: `generate_paged` at B = 2 on a
    caller-sized pool with 1 and 33 new tokens, then 65 unprofiled."""
    from torch.profiler import profile

    from streamchat_tpu_torch.models import generate_paged as gp

    dcfg, dp = m.dec_cfg, m.dec_params
    g = torch.Generator(device="cuda").manual_seed(1234)
    embeds = (torch.randn(2, 6144, dcfg.hidden_size, generator=g, device="cuda") * 0.02
              ).to(torch.bfloat16)
    ln = torch.tensor([6100, 3050], dtype=torch.int32, device="cuda")
    kw = dict(num_pages=98, max_pages_per_seq=50, kv_int8=m.kv_int8)
    gp.generate_paged(dp, dcfg, embeds, ln, max_new_tokens=4, **kw)
    torch.cuda.synchronize()
    seen = {}
    for new in (1, 33):
        stats = {}
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            gp.generate_paged(dp, dcfg, embeds, ln, max_new_tokens=new, stats=stats, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        print(json.dumps(stats))
        seen[new] = summarize(prof, wall, f"caller pool B = 2, {new} new tokens")
    step = {k: 1e3 * (seen[33][k] - seen[1][k]) / 32 for k in seen[1]}
    print(f"== caller pool B = 2 decode step (33 - 1 new tokens, / 32): wall "
          f"{step['wall']:.3f} ms, device {step['busy']:.3f} ms, idle share "
          f"{1 - step['busy'] / step['wall']:.3f}, page kernels "
          f"{step['page kernels (paged_tc + merge)']:.3f} ms")
    stats = {}
    gp.generate_paged(dp, dcfg, embeds, ln, max_new_tokens=65, stats=stats, **kw)
    print("unprofiled 65 new tokens:", json.dumps(stats),
          f"decode ms/step {1e3 * stats['decode_s'] / stats['decode_steps']:.3f}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--weights", choices=("bf16", "int8", "int4"), default="bf16")
    p.add_argument("--kv_int8", action="store_true")
    p.add_argument("--spec_tokens", type=int, default=0)
    p.add_argument("--caller_pool", action="store_true",
                   help="B = 2 decode on a caller-sized pool (K8 / K9) in place of the slice")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: no CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from streamchat_tpu_torch.config import PipelineConfig
    from streamchat_tpu_torch.pipeline import prompts
    from streamchat_tpu_torch.pipeline.preprocess import preprocess_frames
    from streamchat_tpu_torch.pipeline.runner import build_pipeline
    from streamchat_tpu_torch.video.reader import SyntheticVideoReader

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    pipe = build_pipeline(PipelineConfig(), device="cuda", geometry="longva7b",
                          dtype=torch.bfloat16)
    m = pipe.model
    if args.weights != "bf16":
        m.quantize(bits=4 if args.weights == "int4" else 8)
    m.kv_int8 = args.kv_int8
    m.spec_tokens = args.spec_tokens
    print(f"weights {args.weights}, kv_int8 {args.kv_int8}, spec_tokens {args.spec_tokens}")
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if args.caller_pool:
        caller_pool(m, activities)
        print(f"peak GiB {torch.cuda.max_memory_allocated() / 2**30:.2f}")
        return

    reader = SyntheticVideoReader(total_frames=600, frame_rate=30, height=360, width=640)
    frames = reader.read_frames(list(range(0, 300, 5)) + [0, 0, 0, 0])
    for _ in range(2):
        m.encode_images(preprocess_frames(frames, 336, device="cuda"))
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        feats = m.encode_images(preprocess_frames(frames, 336, device="cuda"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summarize(prof, wall, "ingest 64 frames")

    chunk = feats[:40].contiguous().reshape(-1, feats.shape[-1])
    prompt = prompts.build_caption_prompt()
    m.generate_with_image_embedding(prompt, [chunk[: 2 * feats.shape[1]]], max_new_tokens=4)
    torch.cuda.synchronize()
    for new in (1, 33):
        m.gen_stats.clear()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            m.generate_with_image_embedding(prompt, [chunk], max_new_tokens=new,
                                            temperature=0.1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        print(json.dumps(m.gen_stats))
        summarize(prof, wall, f"caption 40 frames, {new} new tokens")

    decode_steps(m, prompt, chunk, activities)
    m.gen_stats.clear()
    m.generate_with_image_embedding(prompt, [chunk], max_new_tokens=129,
                                    temperature=0.1)
    gs = m.gen_stats
    print("unprofiled 129-token caption:", json.dumps(gs),
          f"decode ms/step {1e3 * gs['decode_s'] / gs['decode_steps']:.3f}",
          f"ms/emitted token {1e3 * gs['decode_s'] / gs.get('accepted_tokens', gs['decode_steps']):.3f}")
    print(f"peak GiB {torch.cuda.max_memory_allocated() / 2**30:.2f}")


if __name__ == "__main__":
    main()
