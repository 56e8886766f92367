"""Speculative decoding over the paged KV pool with prompt-lookup drafting
(`streamchat_tpu/models/spec_decode.py`), for a single row or a batch of
rows on a statically partitioned pool (ragged acceptance, per-row lengths).

* Drafting (`ngram_propose`): the last n emitted tokens (n from `ngram`
  down to 2) are matched against a history (a lookup corpus, e.g. the
  prompt's text tokens, plus everything generated); the continuation of the
  most recent match of the longest n is proposed, else the final token is
  repeated.
* Verification (`decode_step_spec`): the T = spec_tokens + 1 tokens go
  through the decoder in one pass. Per layer the pool part of attention is
  the K7 kernel (`ops.paged_attention.paged_seq_attention_partial{,_int8}`:
  unnormalized (acc, m, l) of the T queries against the pool); the staged
  T x T block and the online-softmax merge are plain PyTorch. Then all T
  tokens' K/V are committed into the pool, in place, with one indexed store
  per tensor; slots past the accepted count lie beyond `length` and are
  overwritten before `length` reaches them.
* Acceptance (`_accept`): greedy keeps a draft while it equals the argmax;
  with temperature, draft j is accepted with probability P_j(d_j) and on a
  rejection the rejected token is masked out of the next logits, so the
  next draw comes from the residual distribution: the emitted distribution
  is vanilla sampling's. Greedy output is token-identical to the vanilla
  loop (`models/generate_paged`).

The JAX `lax.while_loop` is one device program. Here its body (sample,
draft, verify, accept, the scatters into the outputs, the history and the
cache) is one `StepGraph` step (`models/step_graph.py`), replayed as a
CUDA graph on the card with every buffer it touches updated in place (a
decode workspace's, kept for the next call at the same key), and
the host reads the continue flag between steps (the loop's `cond`), as the
port's vanilla loop reads its done flags. Random draws come from a
`torch.Generator`. Verify steps of B * T <= 8 rows keep the W8 / K10 /
K11 GEMVs (more rows than `quant.MAX_KERNEL_ROWS` take the dequantize-and-
matmul path, as in the JAX package); K7 serves g * T <= 64 query rows per
kv head.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from streamchat_tpu_torch.models import decoder
from streamchat_tpu_torch.models.generate import pad_to_bucket
from streamchat_tpu_torch.models.paged_kv import (
    DEFAULT_MASK_VALUE,
    PagedKVCacheInt8,
    _quantize_kv,
)
from streamchat_tpu_torch.models.step_graph import cache_tensors, run_steps, use_graph
from streamchat_tpu_torch.ops.paged_attention import (
    paged_seq_attention_partial,
    paged_seq_attention_partial_int8,
)
from streamchat_tpu_torch.ops.sampling import sample_token


def ngram_propose(hist: torch.Tensor, hist_len: torch.Tensor, *, ngram: int,
                  num_draft: int, min_ngram: int = 2) -> torch.Tensor:
    """`num_draft` draft tokens [B, num_draft] per row from the most recent
    n-gram match of hist [B, H] (junk past hist_len [B]). n runs from
    `ngram` down to `min_ngram`; the first n with a match wins, and within
    it the last match. A match at i means hist[i:i+n] equals the last n
    valid tokens with a continuation token inside the valid region. Rows
    without a match, and slots past the valid region, repeat the final
    token."""
    b, h = hist.shape
    dev = hist.device
    hist_len = hist_len.long()
    last_tok = hist.gather(1, (hist_len - 1).clamp_min(0)[:, None])       # [B, 1]
    max_n = max(ngram, 1)
    min_n = max(min(min_ngram, max_n), 1)
    padded = torch.nn.functional.pad(hist, (0, max_n + num_draft), value=-1)
    pos = torch.arange(h, device=dev)[None]
    found = torch.zeros(b, dtype=torch.bool, device=dev)
    start = torch.zeros(b, dtype=torch.long, device=dev)
    for n in range(max_n, min_n - 1, -1):
        suf_idx = hist_len[:, None] - n + torch.arange(n, device=dev)[None]
        suffix = hist.gather(1, suf_idx.clamp_min(0))
        match = (pos + n < hist_len[:, None]) & (hist_len >= n + 1)[:, None]
        for j in range(n):
            match = match & (padded[:, j:j + h] == suffix[:, j:j + 1])
        last_i = torch.where(match, pos, -1).amax(1)
        hit = last_i >= 0
        start = torch.where(hit & ~found, last_i + n, start)
        found = found | hit
    idx = start[:, None] + torch.arange(num_draft, device=dev)[None]
    valid = found[:, None] & (idx < hist_len[:, None])
    return torch.where(valid, padded.gather(1, idx), last_tok)


def _spec_attention(q, pool_k, pool_v, scale_k, scale_v, length, fresh_k, fresh_v):
    """Attention of q [B, Hq, T, Dh] over the pool (K7) and the staged block
    fresh_k/v [B, Hkv, T, Dh] (causal within it), merged under one softmax
    -> [B, Hq, T, Dh] in q's dtype."""
    b, hq, t, d = q.shape
    hkv = pool_k.shape[1]
    g = hq // hkv
    if scale_k is not None:
        acc_p, m_p, l_p = paged_seq_attention_partial_int8(q, pool_k, pool_v, scale_k,
                                                           scale_v, length)
    else:
        acc_p, m_p, l_p = paged_seq_attention_partial(q, pool_k, pool_v, length)
    acc_p = acc_p.reshape(b, hkv, g, t, d)
    m_p, l_p = m_p.reshape(b, hkv, g, t), l_p.reshape(b, hkv, g, t)

    qg = q.reshape(b, hkv, g, t, d).float()
    s_f = torch.einsum("bhgtd,bhud->bhgtu", qg, fresh_k.float()) * d ** -0.5
    tri = torch.arange(t, device=q.device)[None, :] <= torch.arange(t, device=q.device)[:, None]
    s_f = s_f.masked_fill(~tri, DEFAULT_MASK_VALUE)
    m_f = s_f.amax(-1)
    p_f = torch.exp(s_f - m_f[..., None])
    acc_f = torch.einsum("bhgtu,bhud->bhgtd", p_f, fresh_v.float())

    m_tot = torch.maximum(m_p, m_f)
    a_p = torch.exp(m_p - m_tot)[..., None]
    a_f = torch.exp(m_f - m_tot)[..., None]
    o = (acc_p * a_p + acc_f * a_f) / (l_p[..., None] * a_p + p_f.sum(-1)[..., None] * a_f)
    return o.reshape(b, hq, t, d).to(q.dtype)


def _commit_staged(cache, staged_k: torch.Tensor, staged_v: torch.Tensor,
                   staged_ks: Optional[torch.Tensor] = None,
                   staged_vs: Optional[torch.Tensor] = None) -> None:
    """Write all T staged tokens of every row ([L, B, Hkv, T, Dh], post-RoPE;
    int8 with scales [L, B, Hkv, T] for an int8 pool) at the row's slots
    length .. length + T - 1 of every layer, in place, one indexed store per
    tensor (rows own distinct pages). `length` is not advanced."""
    l, b, hkv, t = staged_k.shape[:4]
    ps = cache.page_size
    slot = cache.length.long()[:, None] + torch.arange(t, device=staged_k.device)[None]
    page_idx = cache.page_table.long().gather(1, slot // ps).flatten()
    off = (slot % ps).flatten()

    def lead(x):     # [L, B, Hkv, T(, Dh)] -> [B * T, L, Hkv(, Dh)]
        return x.permute(1, 3, 0, 2, *range(4, x.dim())).reshape(b * t, l, hkv, *x.shape[4:])

    # pages[:, page_idx, :, off] is [B * T, L, Hkv(, Dh)]: the indexed dims lead.
    cache.k_pages[:, page_idx, :, off] = lead(staged_k).to(cache.k_pages.dtype)
    cache.v_pages[:, page_idx, :, off] = lead(staged_v).to(cache.v_pages.dtype)
    if staged_ks is not None:
        cache.k_scale[:, page_idx, :, off] = lead(staged_ks)
        cache.v_scale[:, page_idx, :, off] = lead(staged_vs)


def decode_step_spec(params, cfg, token_ids: torch.Tensor, cache, positions: torch.Tensor):
    """Verify step: token_ids [B, T] at RoPE positions [B, T] through the
    decoder against the paged pool -> (logits [B, T, V] f32, cache with all
    T tokens' K/V committed; `cache.length` not advanced).

    With int8 pages the staged block is attended through its quantized
    values, as vanilla int8 decode reads its own token back from the pool,
    so greedy output stays token-identical to it."""
    kv_int8 = isinstance(cache, PagedKVCacheInt8)
    b, t = token_ids.shape
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = decoder.embed_tokens(params, token_ids)                  # [B, T, D]
    staged = []
    for i, p in enumerate(params["layers"]):
        h = decoder.rmsnorm(x, p["input_norm"], cfg.rms_eps)
        q, k, v = decoder.qkv_proj(h, p["attn"], b, t, hq, hkv, dh)
        q = decoder.rope(q, positions, cfg.rope_theta)
        k = decoder.rope(k, positions, cfg.rope_theta)
        if kv_int8:
            vals, sc = _quantize_kv(torch.stack([k, v]))
            staged.append((vals, sc))
            kv = vals.float() * sc[..., None]
            o = _spec_attention(q, cache.k_pages[i], cache.v_pages[i], cache.k_scale[i],
                                cache.v_scale[i], cache.length, kv[0], kv[1])
        else:
            staged.append((torch.stack([k, v]), None))
            o = _spec_attention(q, cache.k_pages[i], cache.v_pages[i], None, None,
                                cache.length, k, v)
        x = x + decoder.attn_out(params, o.transpose(1, 2).reshape(b, t, hq * dh), p["attn"])
        x = x + decoder.mlp_out(params, decoder.rmsnorm(x, p["post_norm"], cfg.rms_eps),
                                p["mlp"])
    x = decoder.rmsnorm(x, params["final_norm"], cfg.rms_eps)
    logits = decoder.logits_from_hidden(params, cfg, x)          # [B, T, V]
    kv = torch.stack([s[0] for s in staged], dim=1)              # [2, L, B, Hkv, T, Dh]
    scales = torch.stack([s[1] for s in staged], dim=1) if kv_int8 else (None, None)
    _commit_staged(cache, kv[0], kv[1], scales[0], scales[1])
    return logits, cache


def _accept(logits_all: torch.Tensor, tokens: torch.Tensor, logits_prev: torch.Tensor,
            done: torch.Tensor, written: torch.Tensor, *, temperature: float,
            uniforms: Optional[torch.Tensor], eos: torch.Tensor, max_new_tokens: int):
    """Acceptance of one verify step -> (n_acc [B] tokens emitted, next
    logits [B, V], any_eos [B]).

    tokens [B, T] = (t0, drafts); draft j is judged against logits_all[:, j-1]:
    greedy accepts it while it equals the argmax, sampling while
    uniforms[:, j-1] < P_{j-1}(draft_j). Emission stops after the first
    accepted EOS and at max_new_tokens. On a rejection the rejected draft is
    masked out of the next logits (the residual distribution)."""
    b, t_block, vocab = logits_all.shape
    spec_tokens = t_block - 1
    draft = tokens[:, 1:]
    rows = torch.arange(b, device=tokens.device)
    if spec_tokens:
        judge = logits_all[:, :-1]
        if temperature <= 0.0:
            ok = draft == judge.argmax(-1)
        else:
            prob = torch.softmax(judge.float() / temperature, dim=-1)
            ok = uniforms < prob.gather(2, draft[..., None])[..., 0]
        m = torch.cumprod(ok.long(), dim=1).sum(1)
    else:
        m = torch.zeros(b, dtype=torch.long, device=tokens.device)
    n_acc = 1 + m
    idx_t = torch.arange(t_block, device=tokens.device)[None]
    eos_hit = torch.isin(tokens, eos) & (idx_t < n_acc[:, None])
    any_eos = eos_hit.any(1)
    n_acc = torch.where(any_eos, eos_hit.long().argmax(1) + 1, n_acc)
    n_acc = torch.minimum(n_acc, max_new_tokens - written)
    n_acc = torch.where(done, torch.zeros_like(n_acc), n_acc)
    sel = (n_acc - 1).clamp(0, t_block - 1)
    nxt = logits_all[rows, sel]
    if spec_tokens:
        rej = (m < spec_tokens) & ~any_eos & ~done
        rej_tok = draft.gather(1, m.clamp_max(spec_tokens - 1)[:, None])[:, 0]
        mask = torch.zeros_like(nxt, dtype=torch.bool)
        mask[rows, rej_tok] = rej
        nxt = nxt.masked_fill(mask, DEFAULT_MASK_VALUE)
    return n_acc, torch.where((n_acc > 0)[:, None], nxt, logits_prev), any_eos


def run_spec_decode_loop(params, cfg, cache, first_logits: torch.Tensor,
                         seq_length: torch.Tensor, generator: Optional[torch.Generator], *,
                         max_new_tokens: int, temperature: float, eos_ids: Sequence[int],
                         spec_tokens: int, spec_ngram: int,
                         lookup_tokens: Optional[torch.Tensor] = None,
                         lookup_len: Optional[torch.Tensor] = None, ws,
                         stats: Optional[dict] = None, graph: Optional[bool] = None):
    """Greedy / temperature speculative decode -> (tokens [B, max_new] on the
    device, count [B] tokens before the first EOS, verify steps, tokens
    emitted). The pool must hold length + max_new + spec_tokens tokens:
    every verify step writes its whole block before acceptance is known.
    The loop's tensors and its verify step, a `StepGraph` (`graph` as
    `generate_paged`'s), are the workspace `ws`'s; its figures go to
    `stats`."""
    t_block = spec_tokens + 1
    b = seq_length.shape[0]
    dev = first_logits.device

    def new(shape, dtype=torch.long):
        return lambda: torch.empty(shape, dtype=dtype, device=dev)

    eos = ws.get("eos", lambda: torch.tensor(list(eos_ids), device=dev))
    hlk = 0 if lookup_tokens is None else lookup_tokens.shape[1]
    hist = ws.get("hist", new((b, hlk + max_new_tokens + t_block)))
    hist_len = ws.get("hist_len", new((b,)))
    hist.fill_(-1)
    hist_len.zero_()
    if lookup_tokens is not None:
        hist[:, :hlk] = lookup_tokens.to(dev)
        hist_len.copy_(torch.full((b,), hlk) if lookup_len is None else lookup_len)
    trash_out = max_new_tokens + t_block - 1           # scratch slots, sliced off
    trash_hist = hist.shape[1] - 1
    rows = ws.get("rows", lambda: torch.arange(b, device=dev)[:, None])
    ar = ws.get("ar", lambda: torch.arange(t_block, device=dev)[None])
    out = ws.get("out", new((b, max_new_tokens + t_block)))
    written, done, pos = ws.get("written", new((b,))), ws.get("done", new((b,), torch.bool)), \
        ws.get("pos", new((b,)))
    logits = ws.get("logits", lambda: torch.empty_like(first_logits))
    out.fill_(cfg.pad_token_id)
    written.zero_()
    done.zero_()
    pos.copy_(seq_length)
    logits.copy_(first_logits)

    def body():
        t0 = sample_token(logits, generator, temperature=temperature)
        t0 = torch.where(done, torch.full_like(t0, cfg.pad_token_id), t0)
        hist2 = hist.clone()
        hist2[rows[:, 0], hist_len.clamp_max(trash_hist)] = t0
        draft = ngram_propose(hist2, hist_len + 1, ngram=spec_ngram, num_draft=spec_tokens)
        tokens = torch.cat([t0[:, None], draft], dim=1)                    # [B, T]
        logits_all, _ = decode_step_spec(params, cfg, tokens, cache, pos[:, None] + ar)
        uniforms = None
        if spec_tokens and temperature > 0.0:
            uniforms = torch.rand(b, spec_tokens, generator=generator, device=dev)
        n_acc, nxt, any_eos = _accept(logits_all, tokens, logits, done, written,
                                      temperature=temperature, uniforms=uniforms, eos=eos,
                                      max_new_tokens=max_new_tokens)
        live = ar < n_acc[:, None]
        out[rows, torch.where(live, written[:, None] + ar, trash_out)] = tokens
        hist[rows, torch.where(live, (hist_len[:, None] + ar).clamp_max(trash_hist),
                               trash_hist)] = tokens
        done.logical_or_(any_eos | (written + n_acc >= max_new_tokens))
        cache.length.add_(n_acc)
        pos.add_(n_acc)
        written.add_(n_acc)
        hist_len.add_(n_acc)
        logits.copy_(nxt)

    def bound():
        return (logits, out, hist, hist_len, written, done, pos, eos, rows, ar,
                *cache_tensors(cache))

    loop = ws.loop("verify", body, bound, graphed=use_graph(graph, dev, params))
    try:
        # A live row emits at least one token a step, so max_new_tokens
        # steps always reach the end.
        steps = run_steps(loop, lambda: not bool((~done & (written < max_new_tokens)).any()),
                          max_new_tokens)
    finally:
        loop.record(stats)
    toks = out[:, :max_new_tokens].clone()
    before_eos = torch.cumsum(torch.isin(toks, eos).long(), dim=1) == 0
    count = torch.minimum(before_eos.sum(1), written)
    return toks, count, steps, int(written.sum())


def build_lookup_arrays(rows, *, bucket: int = 256, cap: int = 4096) -> dict:
    """Host token-id lists -> generate_paged's {lookup_tokens, lookup_len}:
    padded to a `bucket` multiple, capped at `cap` tokens, filled with -1
    (never a token id, so it never matches), as int64 CPU tensors."""
    n = max(1, max((len(r) for r in rows), default=1))
    pad = pad_to_bucket(min(n, cap), bucket, minimum=bucket)
    arr = np.full((len(rows), pad), -1, np.int64)
    lens = np.zeros((len(rows),), np.int64)
    for i, r in enumerate(rows):
        m = min(len(r), pad)
        arr[i, :m] = r[:m]
        lens[i] = m
    return {"lookup_tokens": torch.from_numpy(arr), "lookup_len": torch.from_numpy(lens)}
