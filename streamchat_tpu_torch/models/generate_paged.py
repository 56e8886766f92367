"""Paged autoregressive generation, single row
(`streamchat_tpu/models/generate_paged.py`, the B = 1 path of
`_generate_paged_jit` / `_run_decode_loop`).

One-shot prefill into a dense cache, paged into an identity-mapped pool
sized for prompt + max_new tokens (so it never overflows and needs no
allocator), then a Python loop: sample -> write -> decode step through the
K4 kernel. Finished rows emit the pad id; `count` is the number of tokens
before the first EOS, as in the JAX loop.

kv_int8 keeps the prefill bf16 and dense, then quantizes it one layer at a
time into int8 pages (`paged_kv.from_contiguous_int8`) and decodes through
the K6 kernel. This is the JAX package's semantics for prompts of up to
8192 tokens; beyond that the JAX package prefills in chunks into an int8
dense cache to fit a 16 GB chip, which the port's one-pass prefill does not
need on 80 GB (ROADMAP §C). Batched rows (`caption_batch > 1`), H2O
eviction and speculative decoding are not ported yet (ROADMAP §A).
"""

from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from streamchat_tpu_torch.config import DecoderConfig
from streamchat_tpu_torch.models import decoder
from streamchat_tpu_torch.models.paged_kv import (
    decode_step_paged,
    decode_step_paged_int8,
    from_contiguous,
    from_contiguous_int8,
)
from streamchat_tpu_torch.ops.sampling import sample_token


def generate_paged(params, cfg: DecoderConfig, prompt_embeds: torch.Tensor,
                   seq_length: torch.Tensor, generator: torch.Generator | None = None,
                   *, max_new_tokens: int, page_size: int = 128,
                   temperature: float = 0.0, top_p: float | None = None,
                   eos_ids: Sequence[int] | None = None, kv_int8: bool = False,
                   stats: Optional[dict] = None) -> Tuple[np.ndarray, np.ndarray]:
    """-> (tokens [B, max_new] int64, count [B]) as numpy arrays.

    prompt_embeds [1, S, D] padded; seq_length [1] valid prompt tokens.
    `stats`, when given, accumulates "prefill_s", "decode_s" (host
    wall-clock, each ending in a device synchronize), "decode_steps",
    "prompt_tokens" (padded) and "generated_tokens" (before EOS) in place.
    """
    b, s, _ = prompt_embeds.shape
    if b != 1:
        raise NotImplementedError(
            "batched paged generation (caption_batch > 1) is not ported yet: "
            "ROADMAP §A 'Batched captioning'")
    if eos_ids is None:
        eos_ids = (cfg.eos_token_id,)
    dev = prompt_embeds.device
    s_pad = -(-s // page_size) * page_size
    if s_pad > s:
        prompt_embeds = torch.nn.functional.pad(prompt_embeds, (0, 0, 0, s_pad - s))
    seq_length = seq_length.to(device=dev, dtype=torch.int32)
    t0 = time.perf_counter()
    dense = decoder.KVCache.create(cfg, b, s_pad, dtype=prompt_embeds.dtype, device=dev)
    logits, dense = decoder.prefill(params, cfg, prompt_embeds, dense, seq_length)
    maxp = -(-(s_pad + max_new_tokens) // page_size)
    if kv_int8:
        cache = from_contiguous_int8(dense, maxp, maxp, page_size)
        step_fn = decode_step_paged_int8
    else:
        cache = from_contiguous(dense, maxp, maxp, page_size)
        step_fn = decode_step_paged
    del dense
    if stats is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()

    eos = torch.tensor(list(eos_ids), device=dev)
    out = torch.full((b, max_new_tokens), cfg.pad_token_id, dtype=torch.int64, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    step = 0
    while step < max_new_tokens:
        tok = sample_token(logits, generator, temperature=temperature, top_p=top_p)
        tok = torch.where(done, torch.full_like(tok, cfg.pad_token_id), tok)
        done = done | torch.isin(tok, eos)
        out[:, step] = tok
        logits, cache = step_fn(params, cfg, tok, cache)
        step += 1
        if bool(done.all()):
            break
    toks = out.cpu().numpy()
    if stats is not None:
        for k, v in (("prefill_s", t1 - t0), ("decode_s", time.perf_counter() - t1),
                     ("decode_steps", step), ("prompt_tokens", s_pad)):
            stats[k] = stats.get(k, 0) + v
    before_eos = np.cumsum(np.isin(toks, list(eos_ids)), axis=1) == 0
    count = np.minimum(before_eos.sum(axis=1), step)
    if stats is not None:
        stats["generated_tokens"] = stats.get("generated_tokens", 0) + int(count.sum())
    return toks, count
