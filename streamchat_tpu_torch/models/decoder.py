"""Causal decoder core (Qwen2 / LLaMA geometry)
(`streamchat_tpu/models/decoder.py`).

The projections take bf16 / f32 weights as plain matrix products (`x @ w`,
[in, out] weights, as the JAX package leaves them to XLA), or the int8 /
int4 weight-only forms of `ops/quant.py`, whose decode rows go to the W8,
K10 and K11 GEMV kernels (q/k/v and gate/up share one K11 launch when all
parts are int4). Prefill attention is the K3 kernel wrapper
(`ops.attention.flash_attention`). RMSNorm, RoPE (HF rotate-half) and the
logits run in f32 (the eager forms of `ops/decode_glue.py`). The paged
decode runs against the pool in `models/paged_kv.py`, its glue as the
kernels of `ops/decode_glue.py`; `decode_step` (the dense generation loop of
`models/generate.py`, the judge's) appends each row's token at the row's own
length of a dense bf16 `KVCache`, one indexed store per tensor and layer, and
attends through the plain `ops.attention.decode_attention` (plain XLA in the
JAX package too).

Long prompts prefill in chunks, as in the JAX package (`prefill_chunked`,
called by `models/generate._prefill_inline` for prompts over
`CHUNKED_PREFILL_THRESHOLD` tokens): chunk 0 attends within itself through
K3 over its fresh K/V, every later chunk attends causally against the
whole cache up to its horizon (`kv_view`) through the K5 kernel
(`ops.attention.flash_attention_partial`). A row whose last token lies
before the final chunk (a shorter row of a batch padded to a longer one)
gets its next-token logits from a re-run of a chunk-sized window over the
completed cache, whose K/V must not land in the cache (see `_rerun_last`).
The cache is the dense bf16 `KVCache` or, for int8 KV pages, the
`Int8KVCache`: values are quantized on write and later chunks attend
through a per-layer dequantized view, so the result is the JAX package's,
not a bf16 prefill quantized afterwards.

A tree cut to one rank's tensor-parallel slice (`parallel.sharding`) runs
the same loops at the rank's narrower shapes (its config's heads and MLP
width); `attn_out`, `mlp_out`, `embed_tokens` and `logits_from_hidden` add
the four all_reduces over its `ModelGroup` (see the note above `attn_out`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from streamchat_tpu_torch.config import DecoderConfig
from streamchat_tpu_torch.ops import quant
from streamchat_tpu_torch.ops.attention import (
    decode_attention,
    flash_attention,
    flash_attention_partial,
)
from streamchat_tpu_torch.ops.decode_glue import quantize_kv, rmsnorm, rope, silu_mul_plain

Params = Dict[str, Any]


@dataclasses.dataclass
class KVCache:
    """Dense per-layer key/value store: k, v [L, B, Hkv, Lmax, Dh]; length [B]."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor

    @classmethod
    def create(cls, cfg: DecoderConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cpu") -> "KVCache":
        shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=torch.zeros(batch, dtype=torch.int32, device=device))


@dataclasses.dataclass
class Int8KVCache:
    """Dense KV cache stored int8 with per-(token, head) f32 scales, the
    layout of `KVCache`: k, v int8 [L, B, Hkv, Lmax, Dh]; k_s, v_s f32
    [L, B, Hkv, Lmax] (created as ones); length [B]. Values are quantized
    on write exactly as `ops.decode_glue.quantize_kv`, so paging it
    (`paged_kv.from_contiguous_int8`) is a pure layout shuffle."""

    k: torch.Tensor
    v: torch.Tensor
    k_s: torch.Tensor
    v_s: torch.Tensor
    length: torch.Tensor

    @classmethod
    def create(cls, cfg: DecoderConfig, batch: int, max_len: int,
               device="cpu") -> "Int8KVCache":
        shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
        return cls(k=torch.zeros(shape, dtype=torch.int8, device=device),
                   v=torch.zeros(shape, dtype=torch.int8, device=device),
                   k_s=torch.ones(shape[:-1], dtype=torch.float32, device=device),
                   v_s=torch.ones(shape[:-1], dtype=torch.float32, device=device),
                   length=torch.zeros(batch, dtype=torch.int32, device=device))


def init(cfg: DecoderConfig, generator: torch.Generator, *, device="cpu",
         dtype=torch.bfloat16) -> Params:
    """Random parameters at the exact geometry of `cfg`."""
    d, dh = cfg.hidden_size, cfg.head_dim
    hq, hkv, f = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size

    def mat(kin, kout):
        w = torch.randn(kin, kout, generator=generator, device=device)
        return (w * kin ** -0.5).to(dtype)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=device)

    layers = []
    for _ in range(cfg.num_layers):
        attn = {"q": {"w": mat(d, hq * dh)}, "k": {"w": mat(d, hkv * dh)},
                "v": {"w": mat(d, hkv * dh)}, "o": {"w": mat(hq * dh, d)}}
        if cfg.qkv_bias:
            attn["q"]["b"] = zeros(hq * dh)
            attn["k"]["b"] = zeros(hkv * dh)
            attn["v"]["b"] = zeros(hkv * dh)
        layers.append({"input_norm": ones(d), "attn": attn, "post_norm": ones(d),
                       "mlp": {"gate": mat(d, f), "up": mat(d, f), "down": mat(f, d)}})
    embed = torch.randn(cfg.vocab_size, d, generator=generator, device=device)
    params = {"embed": (embed * 0.02).to(dtype), "layers": layers,
              "final_norm": ones(d)}
    if not cfg.tie_embeddings:
        params["lm_head"] = mat(d, cfg.vocab_size)
    return params


def _proj(x: torch.Tensor, p: Params) -> torch.Tensor:
    """x @ W (+ b) for p = {"w"(, "b")}, the int8 form {"w_i8", "scale"(, "b")}
    or the int4 form {"w_i4p", "scale"(, "b")}."""
    if "w_i4p" in p:
        y = quant.qmatmul_int4(x, p)
    elif "w_i8" in p:
        y = quant.qmatmul(x, p)
    else:
        y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def _mm(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w where w may be a plain tensor or a quantized dict."""
    return quant.matmul_any(x, w)


def _all_int4(*ps) -> bool:
    return all(isinstance(p, dict) and "w_i4p" in p for p in ps)


def qkv_linear(h, attn):
    """The q/k/v products of h [B, S, D] without their biases -> (q, k, v)
    [B, S, H * Dh]; one fused K11 launch at decode when all three are int4."""
    pq, pk, pv = attn["q"], attn["k"], attn["v"]
    if _all_int4(pq, pk, pv):
        return tuple(quant.qmatmul_int4_multi(h, (pq, pk, pv)))
    return tuple(_mm(h, p["w"] if "w" in p else p) for p in (pq, pk, pv))


def qkv_bias(attn):
    """(bq, bk, bv), or None for a bias-free tree."""
    return tuple(attn[n]["b"] for n in "qkv") if "b" in attn["q"] else None


def qkv_proj(h, attn, b, s, hq, hkv, dh):
    """q/k/v projections -> ([B,Hq,S,Dh], [B,Hkv,S,Dh], [B,Hkv,S,Dh])."""
    qy, ky, vy = qkv_linear(h, attn)
    bias = qkv_bias(attn)
    if bias is not None:
        qy, ky, vy = qy + bias[0], ky + bias[1], vy + bias[2]
    return (qy.reshape(b, s, hq, dh).transpose(1, 2),
            ky.reshape(b, s, hkv, dh).transpose(1, 2),
            vy.reshape(b, s, hkv, dh).transpose(1, 2))


def _swiglu(h: torch.Tensor, mlp: Params, glu=silu_mul_plain) -> torch.Tensor:
    """glu(gate(h), up(h)), by default silu(gate) * up: the input of the down
    projection; gate/up share one K11 launch at decode when both are int4."""
    pg, pu = mlp["gate"], mlp["up"]
    if _all_int4(pg, pu):
        gy, uy = quant.qmatmul_int4_multi(h, (pg, pu))
    else:
        gy, uy = _mm(h, pg), _mm(h, pu)
    return glu(gy, uy)


# Tensor-parallel hooks. A tree cut by `parallel.sharding.shard_decoder`
# carries its `ModelGroup` under "tp"; every layer loop (`forward`,
# `paged_kv._decode_step`, `spec_decode.decode_step_spec`) adds the
# attention and MLP outputs through `attn_out` / `mlp_out` and embeds and
# reads logits through `embed_tokens` / `logits_from_hidden`, so the same
# four reductions serve all three. An unsharded tree takes none of them.
#
# o and down are row-parallel: each rank's product is a partial sum over its
# heads or MLP columns. The partials are all-reduced in f32 and then rounded
# where and as the unsharded product rounds (`quant.matmul_f32`: one f32
# accumulation, one rounding), so a sharded step differs from the
# unsharded one by the order of its f32 sums only; a bf16 reduction would
# round tp + 1 times. W8 and K10 write the f32 partials directly.


def _row_parallel(params: Params, x: torch.Tensor, p: Any, label: str) -> torch.Tensor:
    """x @ p for a row-parallel projection p (a matrix, {"w"(, "b")} or a
    quantized dict), summed over the model axis when the tree is sharded
    (a sharded row-parallel projection has no bias: `shard_decoder`)."""
    tp = params.get("tp")
    if tp is None:
        return _proj(x, p) if isinstance(p, dict) else _mm(x, p)
    y, finish = quant.matmul_f32(x, p["w"] if isinstance(p, dict) and "w" in p else p)
    return finish(tp.all_reduce(y, label))


def attn_out(params: Params, o: torch.Tensor, attn: Params) -> torch.Tensor:
    """The o projection of the heads' output o [B, S, H * Dh]."""
    return _row_parallel(params, o, attn["o"], "o")


def mlp_out(params: Params, h: torch.Tensor, mlp: Params, glu=silu_mul_plain) -> torch.Tensor:
    """The SwiGLU MLP of the normed hidden state h; `glu` joins the gate and
    up products (the paged decode step passes `decode_glue.silu_mul`)."""
    return _row_parallel(params, _swiglu(h, mlp, glu), mlp["down"], "down")


def _chunk_cache_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           q_offset: int, kv_length: torch.Tensor) -> torch.Tensor:
    """Causal attention of a mid-prompt chunk q [B, Hq, C, Dh] against the
    cache view [B, Hkv, view, Dh] (this chunk included): global causality
    col <= q_offset + row, keys masked at and past kv_length [B]. The K5
    kernel (its plain twin on the CPU), then the normalization."""
    acc, _, l = flash_attention_partial(q, k_cache, v_cache, q_offset, 0, kv_length,
                                        causal=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l_safe[..., None]).to(q.dtype)


def _write_kv(cache, i: int, start: int, k: torch.Tensor, v: torch.Tensor,
              rows: slice = slice(None)) -> None:
    """Write a block's K/V [B, Hkv, S, Dh] into layer i at [start, start + S)
    of the cache's `rows`, in place; an `Int8KVCache` quantizes them on the
    way."""
    s = k.shape[2]
    if isinstance(cache, Int8KVCache):
        vals, sc = quantize_kv(torch.stack([k, v]))
        cache.k[i, rows, :, start:start + s] = vals[0]
        cache.v[i, rows, :, start:start + s] = vals[1]
        cache.k_s[i, rows, :, start:start + s] = sc[0]
        cache.v_s[i, rows, :, start:start + s] = sc[1]
    else:
        cache.k[i, rows, :, start:start + s] = k
        cache.v[i, rows, :, start:start + s] = v


def _cache_view(cache, i: int, kv_view: int, dtype):
    """Layer i's K/V over [0, kv_view) in `dtype`; an `Int8KVCache` is
    dequantized, for this layer's view only."""
    k, v = cache.k[i, :, :, :kv_view], cache.v[i, :, :, :kv_view]
    if isinstance(cache, Int8KVCache):
        k = (k.float() * cache.k_s[i, :, :, :kv_view, None]).to(dtype)
        v = (v.float() * cache.v_s[i, :, :, :kv_view, None]).to(dtype)
    return k, v


def forward(params: Params, cfg: DecoderConfig, embeds: torch.Tensor,
            positions: torch.Tensor, cache, seq_length: torch.Tensor, *,
            start: int | list = 0, chunked: bool = False, kv_view: int | None = None,
            decode: bool = False):
    """Run the stack over embeds [B, S, D], writing K/V at [start, start
    + S) of a `KVCache` or `Int8KVCache` -> (post-norm hidden [B, S, D],
    cache with length = start + seq_length).

    With `decode` (S = 1, a bf16 / f32 `KVCache`) each row writes its token
    at its own `cache.length` (one indexed store per tensor and layer; the
    lengths stay on the device) and attends over the whole cache up to its
    new length (`decode_attention`); `start`, `chunked` and `kv_view` are
    then not read, and the cache's length is updated in place (a graphed
    decode step reads and writes it at one address).

    positions [B, S]; seq_length [B] valid tokens of `embeds` (the rest is
    padding, masked by kv_length). Without `chunked` the block attends
    within itself (K3 over its fresh K/V, bf16 even for an int8 cache);
    with it, causally against the cache's first `kv_view` tokens (all of
    them when None), this block included (K5). `start` may be a list of
    per-row offsets (the re-run window of `prefill_chunked`): each row
    writes at its own, and the causal offset of the block is row 0's, as
    in the JAX package.
    """
    b, s, _ = embeds.shape
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if decode:
        if isinstance(cache, Int8KVCache):
            raise NotImplementedError(
                "decode over an Int8KVCache: the dense generation loop decodes a "
                "bf16 KVCache, as the JAX package's generate does")
        if s != 1:
            raise ValueError(f"decode takes one token a row, got {s}")
        rows = torch.arange(b, device=embeds.device)
        slot = cache.length.long()
        start = cache.length
    per_row = isinstance(start, (list, tuple))
    q_offset = start[0] if per_row else start
    starts = torch.tensor(start, device=embeds.device) if per_row else start
    kv_length = (starts + seq_length).to(torch.int32)      # after this block's writes
    view = cache.k.shape[3] if kv_view is None else kv_view
    x = embeds
    for i, p in enumerate(params["layers"]):
        h = rmsnorm(x, p["input_norm"], cfg.rms_eps)
        q, k, v = qkv_proj(h, p["attn"], b, s, hq, hkv, dh)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        if decode:
            cache.k[i][rows, :, slot] = k[:, :, 0].to(cache.k.dtype)
            cache.v[i][rows, :, slot] = v[:, :, 0].to(cache.v.dtype)
            o = decode_attention(q, cache.k[i], cache.v[i], kv_length)
        else:
            if per_row:
                for r, st in enumerate(start):
                    _write_kv(cache, i, st, k[r:r + 1], v[r:r + 1], slice(r, r + 1))
            else:
                _write_kv(cache, i, start, k, v)
            if chunked:
                kd, vd = _cache_view(cache, i, view, k.dtype)
                o = _chunk_cache_attention(q, kd, vd, q_offset, kv_length)
            else:
                o = flash_attention(q, k, v, kv_length, causal=True)
        x = x + attn_out(params, o.transpose(1, 2).reshape(b, s, hq * dh), p["attn"])
        x = x + mlp_out(params, rmsnorm(x, p["post_norm"], cfg.rms_eps), p["mlp"])
    if decode:
        cache.length.copy_(kv_length)
    else:
        cache.length = kv_length.clone()
    return rmsnorm(x, params["final_norm"], cfg.rms_eps), cache


def logits_from_hidden(params: Params, cfg: DecoderConfig,
                       hidden: torch.Tensor) -> torch.Tensor:
    """f32 logits of the given rows (callers pass the last row only). An
    int8 head is an f32 product scaled per column (the W8 kernel with f32
    output at decode: a bf16 hidden state times int8 is exact in f32)."""
    if cfg.tie_embeddings and quant.is_quantized(params["embed"]):
        raise NotImplementedError(
            "tied embeddings with an int8 table would double quantization "
            "error through the logits; quantize_embed is for untied models")
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if isinstance(head, dict) and "w_i4p" in head:
        logits = quant.qmatmul_int4(hidden.float(), head)
    elif quant.is_quantized(head):
        logits = quant.qmatmul(hidden, head, out_dtype=torch.float32)
    else:
        logits = hidden.float() @ head.float()
    tp = params.get("tp")
    if tp is None:
        return logits
    # Vocabulary-parallel head: the rank's columns land in a zeroed
    # full-vocabulary buffer; adding zeros is exact, so every rank holds the
    # whole logits bit for bit and samples, scores and accepts as one.
    n = logits.shape[-1]
    full = logits.new_zeros(*logits.shape[:-1], n * tp.size)
    full[..., tp.rank * n:(tp.rank + 1) * n] = logits
    return tp.all_reduce(full, "logits")


def embed_tokens(params: Params, token_ids: torch.Tensor) -> torch.Tensor:
    """Token rows; an int8-row table (ops/quant.quantize_embedding) is
    dequantized per row to bf16. A sharded tree looks up the rows its
    vocabulary slice holds, zeroes the rest and all-reduces (exact: each
    row is one rank's row plus zeros)."""
    emb = params["embed"]
    tp = params.get("tp")
    if tp is not None:
        n = (emb["w_i8"] if isinstance(emb, dict) else emb).shape[0]
        local = token_ids - tp.rank * n
        inside = (local >= 0) & (local < n)
        token_ids = local.clamp(0, n - 1)
    if isinstance(emb, dict):
        rows = emb["w_i8"][token_ids].float() * emb["scale"][token_ids][..., None]
        rows = rows.to(torch.bfloat16)
    else:
        rows = emb[token_ids]
    if tp is None:
        return rows
    return tp.all_reduce(rows.masked_fill(~inside[..., None], 0), "embed")


def prefill(params: Params, cfg: DecoderConfig, embeds: torch.Tensor,
            cache, seq_length: torch.Tensor) -> Tuple[torch.Tensor, Any]:
    """One-shot prefill of a padded prompt into a fresh `KVCache` or
    `Int8KVCache` -> (last-token logits [B, V], cache)."""
    b, s, _ = embeds.shape
    positions = torch.arange(s, device=embeds.device)[None].expand(b, s)
    hidden, cache = forward(params, cfg, embeds, positions, cache, seq_length)
    last = (seq_length.to(embeds.device).long() - 1)
    rows = hidden[torch.arange(b, device=embeds.device), last]      # [B, D]
    return logits_from_hidden(params, cfg, rows[:, None])[:, 0], cache


def decode_step(params: Params, cfg: DecoderConfig, token_ids: torch.Tensor,
                cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
    """One decode step for token_ids [B] over a dense `KVCache` -> (logits
    [B, V] f32, cache), the cache updated in place and its lengths advanced
    by one. Each row's token takes RoPE position and cache slot
    `cache.length`."""
    b = token_ids.shape[0]
    embeds = embed_tokens(params, token_ids)[:, None, :]
    positions = cache.length[:, None]
    hidden, cache = forward(params, cfg, embeds, positions, cache,
                            torch.ones(b, dtype=torch.int32, device=embeds.device), decode=True)
    return logits_from_hidden(params, cfg, hidden)[:, 0], cache


def prefill_chunked(params: Params, cfg: DecoderConfig, embeds: torch.Tensor, cache,
                    seq_length: torch.Tensor, *, chunk: int = 4096) -> Tuple[torch.Tensor, Any]:
    """Long-prompt prefill in `chunk`-token pieces -> (logits [B, V], cache),
    as `streamchat_tpu.models.decoder.prefill_chunked`.

    The cache must be fresh and hold the 128-padded prompt. The prompt is
    padded to a 128 multiple (when the cache has room) and the final chunk
    may be partial. Chunk 0 runs as a plain prefill; chunk `off` writes at
    `off` and attends the cache's first off + width tokens (its causal
    horizon). When every row's last token sits in the final chunk its
    hidden state gives the logits; otherwise a chunk-sized window is re-run
    over the completed cache (`_rerun_last`).
    """
    b, s, _ = embeds.shape
    if s <= chunk:
        return prefill(params, cfg, embeds, cache, seq_length)
    lmax = cache.k.shape[3]
    if lmax < s:
        raise ValueError(f"prefill_chunked: cache Lmax={lmax} < prompt length {s}; "
                         "size the cache to at least the (128-rounded) prompt length")
    s128 = -(-s // 128) * 128
    if s128 > s and lmax >= s128:
        embeds = torch.nn.functional.pad(embeds, (0, 0, 0, s128 - s))
        s = s128
    offsets = list(range(0, s, chunk))
    final_off = offsets[-1]
    dev = embeds.device
    for off in offsets:
        width = min(chunk, s - off)
        positions = (off + torch.arange(width, device=dev))[None].expand(b, width)
        hidden, cache = forward(
            params, cfg, embeds[:, off:off + width], positions, cache,
            torch.full((b,), width, dtype=torch.int32, device=dev), start=off,
            chunked=off > 0, kv_view=off + width if off > 0 else None)
    last = [int(n) - 1 for n in seq_length.tolist()]
    if min(last) >= final_off:
        rows = hidden[torch.arange(b, device=dev), torch.tensor(last, device=dev) - final_off]
    else:
        rows = _rerun_last(params, cfg, embeds, cache, last, chunk)
    cache.length = seq_length.to(device=dev, dtype=torch.int32).clone()
    return logits_from_hidden(params, cfg, rows[:, None])[:, 0], cache


def _rerun_last(params: Params, cfg: DecoderConfig, embeds: torch.Tensor, cache,
                last: list, chunk: int) -> torch.Tensor:
    """Post-norm hidden state [B, D] of each row's last token (positions
    `last`) from a re-run of the window win = min((last // chunk) * chunk,
    S - chunk) over the completed cache: `chunk` tokens at win .. win +
    chunk attend causally against the whole cache (K5).

    The JAX package writes the window's K/V into a copy of the cache that
    it drops. The port's `forward` writes in place, and the recomputed K/V
    come from another chunking, so they are not bit-equal to the cache's:
    each row's window of every layer is saved first and put back after, so
    that the cache decode reads is the prefill's."""
    b, s, _ = embeds.shape
    dev = embeds.device
    win = [min((p // chunk) * chunk, s - chunk) for p in last]
    tensors = [cache.k, cache.v] + ([cache.k_s, cache.v_s] if isinstance(cache, Int8KVCache)
                                    else [])
    saved = [[t[:, r, :, w:w + chunk].clone() for t in tensors] for r, w in enumerate(win)]
    blk = torch.stack([embeds[r, w:w + chunk] for r, w in enumerate(win)])
    positions = torch.tensor(win, device=dev)[:, None] + torch.arange(chunk, device=dev)[None]
    hidden, cache = forward(params, cfg, blk, positions, cache,
                            torch.full((b,), chunk, dtype=torch.int32, device=dev), start=win,
                            chunked=True)
    for r, w in enumerate(win):
        for t, keep in zip(tensors, saved[r]):
            t[:, r, :, w:w + chunk] = keep
    idx = torch.tensor([p - w for p, w in zip(last, win)], device=dev)
    return hidden[torch.arange(b, device=dev), idx]
