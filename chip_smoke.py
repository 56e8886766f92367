"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

1. Requires a CUDA device; prints the card's name and power limit
   (nvidia-smi) and the torch / CUDA versions.
2. Builds every hand-written kernel from `streamchat_tpu_torch/csrc/` and
   prints the build seconds.
3. Builds the pipeline at full LongVA-7B width on random weights (seeded).
4. Holds each kernel (K1 ViT layer, K2 projector MLP, K3 flash attention,
   K4 paged decode) against its plain PyTorch twin at main-path shapes,
   tolerance |kernel - plain| <= 3e-2 + 2e-2 |plain| (bf16 storage, f32
   accumulation in both, different summation order), and times both.
   Attention outputs over ~23k keys are small (a near-flat softmax averages
   the values), so K3 and K4 are also held to a relative L2 error of 1e-2
   per output row. Their keys and values past the valid length hold large
   garbage, as stale cache slots may, and planted faults (a key tile or a
   4-page chunk zeroed, the valid length ignored or 128 past its end) must
   fail that same check.
5. Checks the composed paths on small inputs: two frames through ViT +
   projector against the plain twins (per-token cosine >= 0.99 after 23
   bf16 layers), and one 28-layer decode step through K4 against the
   page-table gather path (relative L2 error of the logits <= 5e-2: one
   bf16 rounding difference per layer compounds through the stack).
6. Zeroes the launch counters, runs `StreamChatPipeline.process_video`
   (off-line, canonical v0.3 memory settings, bf16) over a 600-frame
   360x640 synthetic video with breakpoints at 10 s and 20 s, and fails if
   any kernel was not launched, an answer is missing or no token was
   generated.
7. Prints the kernels JSON line, then the device JSON line last.

Any failure raises: the script then exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import torch

ATOL, RTOL = 3e-2, 2e-2
ROW_REL_L2 = 1e-2


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip()


def _time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _errors(got, ref, row_rel):
    """-> (max abs error, max per-row relative L2 error or None, within
    tolerance). Rows are the last dim; a zero reference row counts its
    error against 1e-6."""
    torch.cuda.synchronize()
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    ok = bool(torch.isfinite(got).all()) and not bool((err > ATOL + RTOL * ref.abs()).any())
    rel = None
    if row_rel:
        d = ref.shape[-1]
        rel = ((got - ref).reshape(-1, d).norm(dim=-1)
               / ref.reshape(-1, d).norm(dim=-1).clamp_min(1e-6)).max().item()
        ok = ok and rel <= ROW_REL_L2
    return err.max().item(), rel, ok


def _compare(name, got, ref, row_rel=False):
    abs_err, rel, ok = _errors(got, ref, row_rel)
    if not ok:
        raise AssertionError(f"{name}: max abs err {abs_err}, max row relative L2 "
                             f"err {rel}: past atol {ATOL} + rtol {RTOL} * |plain|"
                             + (f" or row relative L2 {ROW_REL_L2}" if row_rel else ""))
    return abs_err, rel


def _planted(name, got, ref):
    """A deliberately wrong kernel output must fail the K3/K4 check."""
    abs_err, rel, ok = _errors(got, ref, row_rel=True)
    if ok:
        raise AssertionError(f"planted fault '{name}' passed the check (max abs "
                             f"err {abs_err}, max row relative L2 err {rel})")
    return rel


def _garbage_tail(k, v, valid, seq_dim):
    """Keys and values at and past `valid` along `seq_dim` set to large
    values: a kernel that reads past the valid length shows it."""
    k.narrow(seq_dim, valid, k.shape[seq_dim] - valid).fill_(8.0)
    v.narrow(seq_dim, valid, v.shape[seq_dim] - valid).fill_(100.0)


def check_kernels(model, g):
    """K1-K4 against their plain twins at main-path shapes -> report rows."""
    from streamchat_tpu_torch.ops import attention, fused_vit, paged_attention

    bf, dev = torch.bfloat16, "cuda"
    rows = {}

    # K1: one ViT-L layer over an ingest batch of 16 frames.
    p = model.vit_params["layers"][0]
    args = (p["ln1"]["scale"], p["ln1"]["bias"], p["attn"]["wqkv"], p["attn"]["bqkv"],
            p["attn"]["o"]["w"], p["attn"]["o"]["b"], p["ln2"]["scale"], p["ln2"]["bias"],
            p["mlp"]["fc1"]["w"], p["mlp"]["fc1"]["b"], p["mlp"]["fc2"]["w"],
            p["mlp"]["fc2"]["b"])
    heads = model.vit_cfg.num_heads
    x = torch.randn(16, 577, 1024, generator=g, device=dev).to(bf)
    k1 = lambda: fused_vit.fused_vit_layer(x, *args, num_heads=heads)  # noqa: E731
    p1 = lambda: fused_vit.fused_vit_layer_plain(x, *args, num_heads=heads)  # noqa: E731
    rows["fused_vit_layer"] = dict(
        shapes="x [16, 577, 1024] bf16, ViT-L layer",
        max_abs_err=_compare("K1 fused_vit_layer", k1(), p1())[0],
        ms=_time_ms(k1, 20), plain_ms=_time_ms(p1, 5))

    # K2: the projector over 16 frames of patch features.
    pp = model.proj_params
    f = torch.randn(16 * 576, 1024, generator=g, device=dev).to(bf)
    kw = dict(activation="gelu", layernorm=False, residual=False)
    k2 = lambda: fused_vit.fused_ln_mlp(  # noqa: E731
        f, None, None, pp["fc1"]["w"], pp["fc1"]["b"], pp["fc2"]["w"], pp["fc2"]["b"], **kw)
    p2 = lambda: fused_vit.fused_ln_mlp_plain(  # noqa: E731
        f, None, None, pp["fc1"]["w"], pp["fc1"]["b"], pp["fc2"]["w"], pp["fc2"]["b"], **kw)
    rows["fused_ln_mlp"] = dict(
        shapes="x [9216, 1024] bf16 -> 3584 -> 3584, erf-GELU",
        max_abs_err=_compare("K2 fused_ln_mlp", k2(), p2())[0],
        ms=_time_ms(k2, 20), plain_ms=_time_ms(p2, 5))

    # K3: causal GQA prefill, 28 query heads over 4 kv heads, dh 128, at
    # S = 4096 and at the chunk-40 caption bucket S = 23168 with a ragged
    # kv_length. The plain twin runs one head at a time so S^2 scores fit.
    # Every row is compared, those past kv_length included.
    hq, hkv = model.dec_cfg.num_heads, model.dec_cfg.num_kv_heads
    grp = hq // hkv
    errs, rels, times, planted = [], [], {}, {}
    for s, valid in ((4096, None), (23168, 23105)):
        q = torch.randn(1, hq, s, 128, generator=g, device=dev).to(bf)
        k = torch.randn(1, hkv, s, 128, generator=g, device=dev).to(bf)
        v = torch.randn(1, hkv, s, 128, generator=g, device=dev).to(bf)
        kl = None
        if valid is not None:
            kl = torch.tensor([valid], dtype=torch.int32, device=dev)
            _garbage_tail(k, v, valid, seq_dim=2)
        out = attention.flash_attention(q, k, v, kl, causal=True)

        def plain_heads(q=q, k=k, v=v, kl=kl):
            return [attention.flash_attention_plain(
                q[:, h:h + 1], k[:, h // grp:h // grp + 1], v[:, h // grp:h // grp + 1],
                kl, causal=True) for h in range(hq)]

        ref = torch.cat(plain_heads(), dim=1)
        err, rel = _compare(f"K3 flash_attention S={s}", out, ref, row_rel=True)
        errs.append(err)
        rels.append(rel)
        if valid is not None:
            planted["K3 kv_length ignored"] = _planted(
                "K3 kv_length ignored", attention.flash_attention(q, k, v, None, causal=True),
                ref)
            k0, v0 = k.clone(), v.clone()
            k0[:, :, 8192:8256] = 0
            v0[:, :, 8192:8256] = 0
            planted["K3 key tile 8192:8256 zeroed"] = _planted(
                "K3 key tile zeroed", attention.flash_attention(q, k0, v0, kl, causal=True),
                ref)
            del k0, v0
        del ref
        times[s] = (_time_ms(lambda: attention.flash_attention(q, k, v, kl, causal=True), 5),
                    _time_ms(plain_heads, 1))
    rows["flash_attention"] = dict(
        shapes="q [1, 28, S, 128], k/v [1, 4, S, 128] bf16 causal; S=23168 "
               "with kv_length 23105 (timed) and S=4096",
        max_abs_err=max(errs), max_row_rel_l2=max(rels), ms=times[23168][0],
        plain_ms=times[23168][1], ms_s4096=times[4096][0], plain_ms_s4096=times[4096][1])

    # K4: one decode token against a 23,105-token context (one layer's pool
    # of 182 pages; the last valid page is partly filled).
    pages, length, ps = -(-(23168 + 128) // 128), 23105, 128
    q = torch.randn(1, hq, 1, 128, generator=g, device=dev).to(bf)
    kp = torch.randn(pages, hkv, ps, 128, generator=g, device=dev).to(bf)
    vp = torch.randn(pages, hkv, ps, 128, generator=g, device=dev).to(bf)
    for t, val in ((kp, 8.0), (vp, 100.0)):
        t[length // ps, :, length % ps:] = val
        t[length // ps + 1:] = val
    ln = torch.tensor([length], dtype=torch.int32, device=dev)
    k4 = lambda: paged_attention.paged_decode_attention_seq(q, kp, vp, ln)  # noqa: E731
    p4 = lambda: paged_attention.paged_decode_attention_seq_plain(q, kp, vp, ln)  # noqa: E731
    ref = p4()
    err, rel = _compare("K4 paged_decode_attention_seq", k4(), ref, row_rel=True)
    planted["K4 length + 128"] = _planted(
        "K4 length + 128", paged_attention.paged_decode_attention_seq(q, kp, vp, ln + 128), ref)
    k0, v0 = kp.clone(), vp.clone()
    k0[80:84] = 0
    v0[80:84] = 0
    planted["K4 pages 80:84 zeroed"] = _planted(
        "K4 4-page chunk zeroed", paged_attention.paged_decode_attention_seq(q, k0, v0, ln), ref)
    rows["paged_decode_attention_seq"] = dict(
        shapes="q [1, 28, 1, 128], pages [182, 4, 128, 128] bf16, length 23105",
        max_abs_err=err, max_row_rel_l2=rel, ms=_time_ms(k4, 50), plain_ms=_time_ms(p4, 10))
    return rows, planted


def check_composed(model, g):
    """Small-input references for the composed ViT+projector and decode paths."""
    from streamchat_tpu_torch.models import decoder, paged_kv, vit
    from streamchat_tpu_torch.ops.fused_vit import fused_ln_mlp_plain, fused_vit_layer_plain

    cfg = model.vit_cfg
    pixels = torch.randn(2, 3, cfg.image_size, cfg.image_size, generator=g, device="cuda")
    got = model.encode_images(pixels).float()
    vp = model.vit_params
    x = vit._embed_patches(pixels, vp["patch_embed"]["w"], cfg)
    cls = vp["class_embed"][None, None, :].expand(x.shape[0], 1, cfg.hidden_size)
    x = vit._layernorm(torch.cat([cls, x], 1) + vp["pos_embed"][None],
                       vp["pre_ln"]["scale"], vp["pre_ln"]["bias"], cfg.layernorm_eps)
    for p in vp["layers"][: cfg.num_layers + 1 + cfg.select_layer]:
        x = fused_vit_layer_plain(
            x, p["ln1"]["scale"], p["ln1"]["bias"], p["attn"]["wqkv"], p["attn"]["bqkv"],
            p["attn"]["o"]["w"], p["attn"]["o"]["b"], p["ln2"]["scale"], p["ln2"]["bias"],
            p["mlp"]["fc1"]["w"], p["mlp"]["fc1"]["b"], p["mlp"]["fc2"]["w"],
            p["mlp"]["fc2"]["b"], num_heads=cfg.num_heads, eps=cfg.layernorm_eps)
    feats = x[:, 1:].reshape(-1, cfg.hidden_size)
    pp = model.proj_params
    ref = fused_ln_mlp_plain(feats, None, None, pp["fc1"]["w"], pp["fc1"]["b"],
                             pp["fc2"]["w"], pp["fc2"]["b"], activation="gelu",
                             layernorm=False, residual=False).float()
    got = got.reshape(ref.shape)
    if got.shape != (2 * cfg.num_patches, model.dec_cfg.hidden_size):
        raise AssertionError(f"encode_images shape {tuple(got.shape)}")
    cos = torch.nn.functional.cosine_similarity(got, ref, dim=-1).min().item()
    if not torch.isfinite(got).all() or cos < 0.99:
        raise AssertionError(f"ViT+projector vs plain: min token cosine {cos}")

    dcfg, dp = model.dec_cfg, model.dec_params
    s = 256
    embeds = (torch.randn(1, s, dcfg.hidden_size, generator=g, device="cuda") * 0.02
              ).to(dp["embed"].dtype)
    length = torch.tensor([250], dtype=torch.int32, device="cuda")
    dense = decoder.KVCache.create(dcfg, 1, s, dtype=embeds.dtype, device="cuda")
    logits, dense = decoder.prefill(dp, dcfg, embeds, dense, length)
    cache = paged_kv.from_contiguous(dense, 3, 3)
    twin = paged_kv.from_contiguous(dense, 3, 3)
    tok = torch.argmax(logits, -1)
    got, _ = paged_kv.decode_step_paged(dp, dcfg, tok, cache, sequential_pages=True)
    ref, _ = paged_kv.decode_step_paged(dp, dcfg, tok, twin, sequential_pages=False)
    rel = ((got - ref).norm() / ref.norm()).item()
    if not torch.isfinite(got).all() or rel > 5e-2:
        raise AssertionError(f"decode step K4 vs page-table gather: relative L2 "
                             f"error {rel} past 5e-2")
    return {"vit_projector_min_cosine": cos, "decode_logits_rel_l2_err": rel}


def run_slice(pipe):
    """The off-line main path at full width -> (results, seconds, prompt lengths)."""
    from streamchat_tpu_torch.video.reader import SyntheticVideoReader
    from streamchat_tpu_torch.memory.bank import MemoryBank

    lengths = []
    splice = pipe.model.splice_prompt

    def recording_splice(*a, **kw):
        embeds, n = splice(*a, **kw)
        lengths.append(n)
        return embeds, n

    pipe.model.splice_prompt = recording_splice
    reader = SyntheticVideoReader(total_frames=600, frame_rate=30, height=360, width=640)
    breakpoints = [
        {"question": "What is on the table in front of me?", "answer": "a cup",
         "class": "object", "time": 10},
        {"question": "Where did I put the keys?", "answer": "in the drawer",
         "class": "location", "time": 20},
    ]
    with tempfile.TemporaryDirectory() as d:
        bank = MemoryBank(os.path.join(d, "memory.json"), pipe.bank_embed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = pipe.process_video(reader, breakpoints, bank, user_name="User")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    pipe.model.splice_prompt = splice
    if len(results) != len(breakpoints) or any(
            not isinstance(r["predict"], str) for r in results):
        raise AssertionError(f"expected {len(breakpoints)} answers, got {results}")
    return results, seconds, lengths


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False)")
    from streamchat_tpu_torch.config import PipelineConfig
    from streamchat_tpu_torch import kernels
    from streamchat_tpu_torch.kernels.build import build, library
    from streamchat_tpu_torch.pipeline.runner import build_pipeline

    smi = _smi()
    print(smi)
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    info = build(force=True)
    library()
    print(f"kernel build: {info['seconds']:.2f} s")

    t0 = time.perf_counter()
    pipe = build_pipeline(PipelineConfig(), device="cuda", dtype=torch.bfloat16,
                          geometry="longva7b")
    torch.cuda.synchronize()
    print(f"pipeline build (random LongVA-7B weights): {time.perf_counter() - t0:.2f} s")
    g = torch.Generator(device="cuda").manual_seed(1234)

    rows, planted = check_kernels(pipe.model, g)
    for name, row in rows.items():
        print(f"{name}: max_abs_err {row['max_abs_err']:.6g}  max_row_rel_l2 "
              f"{row.get('max_row_rel_l2')}  kernel {row['ms']:.4f} ms  "
              f"plain {row['plain_ms']:.4f} ms  [{row['shapes']}]")
    for name, rel in planted.items():
        print(f"planted fault rejected: {name}: max row relative L2 err {rel:.6g} "
              f"(limit {ROW_REL_L2})")
    composed = check_composed(pipe.model, g)
    print(f"composed checks: {composed}")

    pipe.model.gen_stats.clear()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    results, seconds, lengths = run_slice(pipe)
    counts = kernels.launch_counts()
    print(f"process_video: {seconds:.3f} s, answers {len(results)}, generated "
          f"tokens {pipe.model.gen_stats['generated_tokens']}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    gs = pipe.model.gen_stats
    print(f"generate: {gs}; decode {1e3 * gs['decode_s'] / gs['decode_steps']:.2f} "
          f"ms/step, prefill {gs['prompt_tokens'] / gs['prefill_s']:.0f} tokens/s")
    print(f"phase totals (s): {pipe.last_phase_totals}")
    print(f"phase counts: {pipe.last_phase_counts}")
    print(f"prompt lengths: {lengths}")
    print(f"launch counts: {counts}")
    missing = [n for n in rows if counts.get(n, 0) == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    if pipe.model.gen_stats["generated_tokens"] == 0:
        raise AssertionError("the main path generated no token")
    if max(lengths) <= 23000:
        raise AssertionError(f"no chunk-40 caption prompt over 23000 tokens: {lengths}")

    sources = {
        "fused_vit_layer": ("streamchat_tpu_torch/csrc/fused_vit.cu",
                            "streamchat_tpu/ops/fused_vit.py:358"),
        "fused_ln_mlp": ("streamchat_tpu_torch/csrc/fused_vit.cu",
                         "streamchat_tpu/ops/fused_vit.py:159"),
        "flash_attention": ("streamchat_tpu_torch/csrc/flash_attention.cu",
                            "streamchat_tpu/ops/attention.py:173"),
        "paged_decode_attention_seq": ("streamchat_tpu_torch/csrc/paged_decode.cu",
                                       "streamchat_tpu/ops/paged_attention.py:382"),
    }
    report = [dict(name=n, route="cuda", source=sources[n][0], replaces=sources[n][1],
                   launches=counts[n], **row) for n, row in rows.items()]
    print(f"summary: kernel build {info['seconds']:.2f} s, process_video {seconds:.3f} s, "
          f"planted faults rejected {len(planted)}")
    print(smi)
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
