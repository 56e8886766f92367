"""Paged autoregressive generation, single row
(`streamchat_tpu/models/generate_paged.py`, the B = 1 path of
`_generate_paged_jit` / `_run_decode_loop`).

Prefill into a dense cache (`generate._prefill_inline`: one pass up to
`CHUNKED_PREFILL_THRESHOLD` tokens, chunks beyond it), paged into an
identity-mapped pool sized for prompt + max_new (+ spec_tokens) tokens (so
it never overflows and needs no allocator), then a Python loop: sample ->
write -> decode step through the K4 kernel. Finished rows emit the pad id;
`count` is the number of tokens before the first EOS, as in the JAX loop.

kv_int8 stores the pool as int8 pages and decodes through the K6 kernel. A
prompt over the threshold prefills into the int8 dense `Int8KVCache`
(quantized on write, later chunks attend its dequantized view) and is then
repaged as it is; a shorter one prefills bf16 and is quantized layer by
layer when paged, as in the JAX package.

spec_tokens > 0 runs the speculative verify loop instead
(`models/spec_decode`, the K7 kernel): prompt-lookup drafts over
`lookup_tokens` plus everything generated, exact greedy / rejection-sampled
acceptance, top_p unsupported. Batched rows (`caption_batch > 1`) and H2O
eviction are not ported yet (ROADMAP §A).
"""

from __future__ import annotations

import math
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from streamchat_tpu_torch.config import DecoderConfig
from streamchat_tpu_torch.models import decoder, generate
from streamchat_tpu_torch.models.paged_kv import (
    decode_step_paged,
    decode_step_paged_int8,
    from_contiguous,
    from_contiguous_int8,
)
from streamchat_tpu_torch.models.spec_decode import run_spec_decode_loop
from streamchat_tpu_torch.ops.sampling import sample_token


def generate_paged(params, cfg: DecoderConfig, prompt_embeds: torch.Tensor,
                   seq_length: torch.Tensor, generator: torch.Generator | None = None,
                   *, max_new_tokens: int, page_size: int = 128,
                   temperature: float = 0.0, top_p: float | None = None,
                   eos_ids: Sequence[int] | None = None, kv_int8: bool = False,
                   spec_tokens: int = 0, spec_ngram: int = 3,
                   lookup_tokens: torch.Tensor | None = None,
                   lookup_len: torch.Tensor | None = None,
                   stats: Optional[dict] = None) -> Tuple[np.ndarray, np.ndarray]:
    """-> (tokens [B, max_new] int64, count [B]) as numpy arrays.

    prompt_embeds [1, S, D] padded; seq_length [1] valid prompt tokens.
    `stats`, when given, accumulates "prefill_s", "decode_s" (host
    wall-clock, each ending in a device synchronize), "decode_steps" (decode
    or verify forward passes), "prompt_tokens" (padded) and
    "generated_tokens" (before EOS) in place; a speculative run adds
    "verify_steps" and "accepted_tokens" (tokens its verify steps emitted).
    """
    b, s, _ = prompt_embeds.shape
    if b != 1:
        raise NotImplementedError(
            "batched paged generation (caption_batch > 1) is not ported yet: "
            "ROADMAP §A 'Batched captioning'")
    if spec_tokens > 0 and top_p is not None:
        raise ValueError("speculative decode supports top_p=None only")
    if eos_ids is None:
        eos_ids = (cfg.eos_token_id,)
    dev = prompt_embeds.device
    threshold = generate.CHUNKED_PREFILL_THRESHOLD
    # A chunked prefill needs the 128-padded prompt inside the dense cache.
    align = math.lcm(page_size, 128) if s > threshold else page_size
    s_pad = -(-s // align) * align
    if s_pad > s:
        prompt_embeds = torch.nn.functional.pad(prompt_embeds, (0, 0, 0, s_pad - s))
    seq_length = seq_length.to(device=dev, dtype=torch.int32)
    t0 = time.perf_counter()
    if kv_int8 and s_pad > threshold:
        dense = decoder.Int8KVCache.create(cfg, b, s_pad, device=dev)
    else:
        dense = decoder.KVCache.create(cfg, b, s_pad, dtype=prompt_embeds.dtype, device=dev)
    logits, dense = generate._prefill_inline(params, cfg, prompt_embeds, dense, seq_length)
    # + spec_tokens: a verify step writes its whole block before acceptance.
    maxp = -(-(s_pad + max_new_tokens + spec_tokens) // page_size)
    if kv_int8:
        cache = from_contiguous_int8(dense, maxp, maxp, page_size)
        step_fn = decode_step_paged_int8
    else:
        cache = from_contiguous(dense, maxp, maxp, page_size)
        step_fn = decode_step_paged
    del dense
    # The pool is identity-mapped and read in pool order: map every page,
    # not only the prompt's, so an append past them lands where it is read.
    cache.page_table = torch.arange(maxp, dtype=torch.int32, device=dev)[None]
    if stats is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()

    if spec_tokens > 0:
        out, count, step, emitted = run_spec_decode_loop(
            params, cfg, cache, logits, seq_length, generator,
            max_new_tokens=max_new_tokens, temperature=temperature, eos_ids=eos_ids,
            spec_tokens=spec_tokens, spec_ngram=spec_ngram, lookup_tokens=lookup_tokens,
            lookup_len=lookup_len)
        toks, count = out.cpu().numpy(), count.cpu().numpy()
        if stats is not None:
            for k, v in (("verify_steps", step), ("accepted_tokens", emitted)):
                stats[k] = stats.get(k, 0) + v
    else:
        eos = torch.tensor(list(eos_ids), device=dev)
        out = torch.full((b, max_new_tokens), cfg.pad_token_id, dtype=torch.int64,
                         device=dev)
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
        before_eos = np.cumsum(np.isin(toks, list(eos_ids)), axis=1) == 0
        count = np.minimum(before_eos.sum(axis=1), step)
    if stats is not None:
        for k, v in (("prefill_s", t1 - t0), ("decode_s", time.perf_counter() - t1),
                     ("decode_steps", step), ("prompt_tokens", s_pad),
                     ("generated_tokens", int(count.sum()))):
            stats[k] = stats.get(k, 0) + v
    return toks, count
