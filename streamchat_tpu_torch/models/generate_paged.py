"""Paged autoregressive generation (`streamchat_tpu/models/generate_paged.py`),
single rows and batches.

Prefill runs into a dense cache (`generate._prefill_inline`: one pass up
to `CHUNKED_PREFILL_THRESHOLD` tokens, chunks beyond it), the pages go into
a pool, then the loop: (allocate) -> sample -> write -> decode step. The
JAX package fuses it into one `lax.while_loop` program; here the sample,
write and decode step are one `StepGraph` step (`models/step_graph.py`),
replayed as a CUDA graph on the card, while the allocator's in-place call
(`paged_kv.allocate_pages_`) and its overflow read run on the host between
steps, at page boundaries only, and the host reads the done flags once a
step. The pool and every tensor the loop touches belong to a decode
workspace kept across calls (`step_graph.workspace`, keyed as the JAX
package's jit is): a call at a known key pages its prefill into the kept
pool (`from_contiguous(into=)`, `_scatter_row_into_pools`) and replays the
kept graphs. Finished rows emit the pad id; `count` is the number of tokens
before the first EOS, as in the JAX loop. The dispatch is the JAX
package's:

* B > 1 rows and no caller-sized pool: the split path
  (`_generate_paged_split`). Each row prefills alone (B = 1, so a short
  row of a long batch takes the chunked prefill's re-run branch) and its
  pages land in its slice of a statically partitioned pool, rounded to
  whole `SEQ_POOL_BLOCK`s per row; then one batched decode loop reads the
  pool in row order (K4 / K6, K7 for speculative steps). Rows may be a
  list whose entries after the first are callables: a row is made only at
  its prefill turn and dropped once its pages have landed.
* Otherwise one program (`_generate_paged_one`). A single row on the
  default pool (all its pages mapped in pool order), or a caller's pool
  that is a static partition (num_pages == B * maxp, maxp a multiple of
  8), reads the pool in row order as above. Any other caller-sized pool
  (`num_pages`, `max_pages_per_seq`) prefills all rows densely, pages them
  with `from_contiguous`, and maps pages as rows grow with the allocator
  inside the decode loop; decode then reads through the page table (K8 /
  K9). An exhausted pool or table raises `RuntimeError` before any step
  reads another row's pages.

kv_int8 stores the pool as int8 pages. A prompt over the threshold prefills
into the int8 dense `Int8KVCache` and is repaged as it is; a shorter one
prefills bf16 and is quantized when paged, as in the JAX package.

spec_tokens > 0 runs the speculative verify loop instead
(`models/spec_decode`, the K7 kernel) on a pool in row order: prompt-lookup
drafts over `lookup_tokens` plus everything generated, exact greedy /
rejection-sampled acceptance, top_p unsupported.

hh_size > 0 (batch 1, bf16 pages, no speculative decode) turns on H2O
heavy-hitter eviction on a pool of cap = max_pages_per_seq * page_size
slots (`_prefill_h2o`, `_decode_loop_h2o`): the prompt's slots are scored
by the mass of its 16 last keys used as probe queries; a prompt over the
pool is compressed to C = sink + hh + recent slots right after its dense
prefill, and whenever the next token would overflow the pool the cache is
compressed again, in place (`paged_kv.compress_paged_`), and decoding
goes on. Each step ropes at the token's global position, which keeps
counting while the cache shrinks. A step adds its attention mass to the
scores (`collect_mass`: the plain gather attention, the only one that
yields the probabilities) while a later compression can still fire; the
steps after the last one run the page kernel (K4 on a pool in page order,
else K8), as a run without a budget does. The overflow test and that choice
read only host-side lengths and pages. The step has these three forms, each
its own `StepGraph`, which come in phases that never return (collect, then
K4, then K8); the compression and the allocator run eagerly between
replays, as the JAX loop's `lax.cond` branch and allocator call run inside
its one program.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from streamchat_tpu_torch.config import DecoderConfig
from streamchat_tpu_torch.models import decoder, generate, step_graph
from streamchat_tpu_torch.models.paged_kv import (
    PagedKVCache,
    PagedKVCacheInt8,
    _place,
    _quantize_kv,
    _row_table,
    allocate_pages_,
    compress_paged_,
    decode_step_paged,
    decode_step_paged_int8,
    from_contiguous,
    from_contiguous_int8,
)
from streamchat_tpu_torch.models.spec_decode import run_spec_decode_loop
from streamchat_tpu_torch.models.step_graph import run_steps, use_graph
from streamchat_tpu_torch.ops.kv_compress import attention_mass, compress_kv
from streamchat_tpu_torch.utils.profiling import span

# Pages of a partitioned pool's row are rounded to a multiple of this (the
# JAX package's TPU kernel block, `ops/paged_attention.SEQ_POOL_BLOCK`), so
# that pools and tables equal the JAX package's element by element.
SEQ_POOL_BLOCK = 32

_OVERFLOW_MSG = (
    "paged KV allocator overflowed during decode: the page pool or a "
    "row's page table ran out and H2O compression (if enabled) could "
    "not free enough — output tokens would read another sequence's KV")


def generate_paged(params, cfg: DecoderConfig, prompt_embeds, seq_length: torch.Tensor,
                   generator: torch.Generator | None = None, *, max_new_tokens: int,
                   page_size: int = 128, num_pages: int | None = None,
                   max_pages_per_seq: int | None = None, temperature: float = 0.0,
                   top_p: float | None = None, eos_ids: Sequence[int] | None = None,
                   kv_int8: bool = False, spec_tokens: int = 0, spec_ngram: int = 3,
                   lookup_tokens: torch.Tensor | None = None,
                   lookup_len: torch.Tensor | None = None, hh_size: int = 0,
                   recent_size: int = 0, sink_size: int = 4, merge: str | None = None,
                   stats: Optional[dict] = None,
                   graph: Optional[bool] = None) -> Tuple[np.ndarray, np.ndarray]:
    """-> (tokens [B, max_new] int64, count [B]) as numpy arrays.

    prompt_embeds [B, S, D] padded, or a list of B [1, S, D] rows (entries
    after the first may be callables that make the row; the list is
    consumed); seq_length [B] valid prompt tokens. `num_pages` /
    `max_pages_per_seq` size the pool (default: every row's prompt plus
    max_new + spec_tokens tokens). `stats`, when given, accumulates
    "prefill_s", "decode_s" (host wall-clock, each ending in a device
    synchronize), "decode_steps" (decode or verify forward passes),
    "prompt_tokens" (padded, all rows), "generated_tokens" (before EOS) and
    "batched_rows" (rows of calls with B > 1) in place; a speculative run
    adds "verify_steps" and "accepted_tokens" (tokens its verify steps
    emitted), an H2O run (hh_size > 0; `recent_size`, `sink_size` and
    `merge` as `ops.kv_compress.compress_kv`) "compressions_at_prefill" and
    "compressions_in_loop", and a graphed loop its `StepGraph.record`
    figures. `graph`: None replays every loop's step as a CUDA graph on the
    card (`step_graph.use_graph`), False runs it eagerly there (the card's
    equality check).
    """
    as_rows = isinstance(prompt_embeds, (list, tuple))
    b = len(prompt_embeds) if as_rows else prompt_embeds.shape[0]
    compress = hh_size > 0
    if compress and b != 1:
        raise ValueError("in-loop H2O compression supports batch 1")
    if compress and kv_int8:
        raise ValueError("kv_int8 and in-loop H2O compression are exclusive")
    if compress and spec_tokens > 0:
        raise ValueError("speculative decode excludes in-loop H2O")
    if spec_tokens > 0 and top_p is not None:
        raise ValueError("speculative decode supports top_p=None only")
    if eos_ids is None:
        eos_ids = (cfg.eos_token_id,)
    eos_ids = tuple(eos_ids)
    form = "h2o" if compress else "spec" if spec_tokens > 0 else "vanilla"
    lookup_width = 0 if lookup_tokens is None else lookup_tokens.shape[1]

    def claim(row_order: bool, pages: int, maxp: int, dtype, device):
        """The decode workspace of this call's key (`step_graph.workspace`)."""
        return step_graph.workspace(
            (form, cfg, b, row_order, pages, maxp, page_size, dtype, kv_int8, max_new_tokens,
             temperature, top_p, eos_ids, spec_tokens, spec_ngram, lookup_width, hh_size,
             recent_size, sink_size, merge), params, generator, device)

    with span("generate") as call:
        if compress:
            h2o = dict(hh_size=hh_size, recent_size=recent_size, sink_size=sink_size, merge=merge)
            with span("generate.prefill") as prefill:
                if as_rows:
                    prompt_embeds = (prompt_embeds[0]() if callable(prompt_embeds[0])
                                     else prompt_embeds[0])
                ws, logits, s_pad, host = _prefill_h2o(
                    params, cfg, prompt_embeds, seq_length, max_new_tokens=max_new_tokens,
                    page_size=page_size, num_pages=num_pages, max_pages_per_seq=max_pages_per_seq,
                    claim=claim, **h2o)
                if stats is not None and logits.device.type == "cuda":
                    torch.cuda.synchronize(logits.device)
            call.tags["graphed"] = use_graph(graph, logits.device, params)
            with span("generate.decode") as decode:
                toks, step, loop_compressions = _decode_loop_h2o(
                    params, cfg, ws.tensors["cache"], ws.tensors["hh"], logits, seq_length,
                    generator, host, max_new_tokens=max_new_tokens, temperature=temperature,
                    top_p=top_p, eos_ids=eos_ids, ws=ws, stats=stats, graph=graph, **h2o)
                before_eos = np.cumsum(np.isin(toks, list(eos_ids)), axis=1) == 0
                count = np.minimum(before_eos.sum(axis=1), step)
            if stats is not None:
                for k, v in (("prefill_s", prefill.seconds), ("decode_s", decode.seconds),
                             ("decode_steps", step), ("prompt_tokens", s_pad),
                             ("generated_tokens", int(count.sum())),
                             ("compressions_at_prefill", host["compressions"]),
                             ("compressions_in_loop", loop_compressions)):
                    stats[k] = stats.get(k, 0) + v
            call.tags.update(prompt_tokens=s_pad, steps=step)
            return toks, count
        kw = dict(max_new_tokens=max_new_tokens, page_size=page_size, kv_int8=kv_int8,
                  spec_tokens=spec_tokens, claim=claim)
        with span("generate.prefill") as prefill:
            if b > 1 and num_pages is None and max_pages_per_seq is None:
                ws, logits, s_pad = _generate_paged_split(params, cfg, prompt_embeds, seq_length,
                                                          **kw)
                row_order = True
            else:
                if as_rows:
                    prompt_embeds = torch.cat([r() if callable(r) else r for r in prompt_embeds])
                ws, logits, s_pad, row_order = _generate_paged_one(
                    params, cfg, prompt_embeds, seq_length, num_pages=num_pages,
                    max_pages_per_seq=max_pages_per_seq, **kw)
            cache = ws.tensors["cache"]
            dev = logits.device
            seq_length = seq_length.to(device=dev, dtype=torch.int32)
            if spec_tokens > 0 and not (row_order or b == 1):
                raise ValueError("speculative decode needs a row-ordered pool "
                                 "(batch 1 or the statically partitioned batched pool)")
            if spec_tokens > 0 and not row_order:
                # The verify step has no allocator: map every page the loop can touch.
                if bool(allocate_pages_(cache, torch.full((b,), max_new_tokens + spec_tokens,
                                                          device=dev))):
                    raise RuntimeError(_OVERFLOW_MSG)
            if stats is not None and dev.type == "cuda":
                torch.cuda.synchronize(dev)
        call.tags["graphed"] = use_graph(graph, dev, params)

        with span("generate.decode") as decode:
            if spec_tokens > 0:
                out, count, step, emitted = run_spec_decode_loop(
                    params, cfg, cache, logits, seq_length, generator,
                    max_new_tokens=max_new_tokens, temperature=temperature, eos_ids=eos_ids,
                    spec_tokens=spec_tokens, spec_ngram=spec_ngram, lookup_tokens=lookup_tokens,
                    lookup_len=lookup_len, stats=stats, graph=graph, ws=ws)
                toks, count = out.cpu().numpy(), count.cpu().numpy()
                if stats is not None:
                    for k, v in (("verify_steps", step), ("accepted_tokens", emitted)):
                        stats[k] = stats.get(k, 0) + v
            else:
                toks, step = _decode_loop(params, cfg, cache, logits, seq_length, generator,
                                          row_order=row_order,
                                          max_new_tokens=max_new_tokens, temperature=temperature,
                                          top_p=top_p, eos_ids=eos_ids, kv_int8=kv_int8,
                                          stats=stats, graph=graph, ws=ws)
                before_eos = np.cumsum(np.isin(toks, list(eos_ids)), axis=1) == 0
                count = np.minimum(before_eos.sum(axis=1), step)
        if stats is not None:
            for k, v in (("prefill_s", prefill.seconds), ("decode_s", decode.seconds),
                         ("decode_steps", step), ("prompt_tokens", b * s_pad),
                         ("generated_tokens", int(count.sum())),
                         ("batched_rows", b if b > 1 else 0)):
                stats[k] = stats.get(k, 0) + v
        call.tags.update(prompt_tokens=b * s_pad, steps=step)
        return toks, count


def _decode_loop(params, cfg, cache, logits, seq_length, generator, *, row_order,
                 max_new_tokens, temperature, top_p, eos_ids, kv_int8, ws, stats=None,
                 graph=None):
    """Vanilla decode -> (tokens [B, max_new] numpy, steps taken).

    `row_order`: every page is mapped and the pool is read in row order (K4
    / K6). Otherwise pages are mapped as rows grow and read through the
    table (K8 / K9): a row needs a new page when its length is a multiple
    of the page size (the JAX loop's allocator call with ones is a no-op
    otherwise), and lengths are tracked on the host, so only those steps
    call the allocator, in place and before the step, and read the
    overflow flag back. The step (sample, write, decode) is the workspace
    `ws`'s `StepGraph`; its figures go to `stats`."""
    b = seq_length.shape[0]
    dev = logits.device
    ps = cache.page_size
    st = generate.GenState.reset(ws, cache, logits, max_new_tokens, cfg.pad_token_id, eos_ids)

    def body():
        tok = st.sample(generator, temperature, top_p, cfg.pad_token_id)
        step_fn = decode_step_paged_int8 if kv_int8 else decode_step_paged
        new_logits, _ = step_fn(params, cfg, tok, cache, sequential_pages=row_order)
        st.advance(new_logits)

    loop = ws.loop("vanilla", body, st.tensors, graphed=use_graph(graph, dev, params))
    lengths = seq_length.tolist()
    ones = torch.ones(b, dtype=torch.int32, device=dev)

    def allocate(step):
        if not row_order and any((n + step) % ps == 0 for n in lengths):
            with span("decode.alloc"):
                if bool(allocate_pages_(cache, ones)):
                    raise RuntimeError(_OVERFLOW_MSG)

    try:
        step = run_steps(loop, lambda: bool(st.done.all()), max_new_tokens, before=allocate)
    finally:
        loop.record(stats)
    return st.out_tokens.cpu().numpy(), step


def _decode_loop_h2o(params, cfg, cache, hh, logits, seq_length, generator, host: dict, *,
                     max_new_tokens, temperature, top_p, eos_ids, hh_size, recent_size,
                     sink_size, merge, ws, stats=None, graph=None):
    """The H2O decode loop (batch 1) -> (tokens [1, max_new] numpy, steps
    taken, compressions). Each step: when the next token's slot would need
    a page past the pool or the row's table, compress the cache in place
    (`compress_paged_`); map a page at a page boundary (`allocate_pages_`,
    its overflow flag read back); then the step: sample, write the token,
    decode at the token's global position `pos`. While a later compression
    can still fire within max_new_tokens, the step collects its attention
    mass into the scores hh [L, Hkv, cap] (`collect_mass`: the plain
    gather); after the last one nothing reads hh again, so the step runs
    the page kernel a run without a budget would: K4 while slot j of the
    row sits in pool page j (the paged prompt, a compression's pages and
    pages mapped in order), K8 through the table once the allocator has
    mapped a slot past a padded prompt's unused pages. Each of the three
    forms is a `StepGraph` of the workspace `ws` (graphed as `graph` says,
    figures to `stats`); the phases never return, so no form replays after
    a later one. The cache length and the pool pages in use are tracked on
    the host from `host` ("length", "next_free"; after a compression the
    kept length and its pages), so neither test reads anything back from
    the card."""
    dev = logits.device
    num_pages, maxp, ps = cache.k_pages.shape[1], cache.page_table.shape[1], cache.page_size
    c = sink_size + hh_size + recent_size
    st = generate.GenState.reset(ws, cache, logits, max_new_tokens, cfg.pad_token_id, eos_ids)
    pos = ws.get("pos", lambda: torch.empty(1, dtype=torch.int32, device=dev))
    pos.copy_(seq_length.reshape(1))
    graphed = use_graph(graph, dev, params)

    def form_step(form):
        def body():
            tok = st.sample(generator, temperature, top_p, cfg.pad_token_id)
            if form == "collect":
                new_logits, _, mass = decode_step_paged(params, cfg, tok, cache, positions=pos,
                                                        collect_mass=True)
                hh.add_(mass[:, 0])
            else:
                new_logits, _ = decode_step_paged(params, cfg, tok, cache, positions=pos,
                                                  sequential_pages=form == "K4")
            st.advance(new_logits)
            pos.add_(1)
        return body

    loops = {}
    ones = torch.ones(1, dtype=torch.int32, device=dev)
    # The host's view of the cache: its length, the pool pages in use,
    # whether slot j still sits in page j, and the compressions made.
    at = dict(length=host["length"], next_free=host["next_free"], in_order=True,
              compressions=0)

    def before(step):
        """Compress and map pages as the next token needs -> that step's form."""
        length, next_free = at["length"], at["next_free"]
        extra = -(-(length + 1) // ps) - -(-length // ps)
        if next_free + extra > num_pages or -(-(length + 1) // ps) > maxp:
            compress_paged_(cache, hh, hh_size=hh_size, recent_size=recent_size,
                            sink_size=sink_size, merge=merge)
            length, next_free = min(length, c), -(-c // ps)
            at["compressions"] += 1
            at["in_order"] = True
        have = -(-length // ps)
        reachable = (have + min(num_pages - next_free, maxp - have)) * ps
        if length % ps == 0:
            with span("decode.alloc"):
                if bool(allocate_pages_(cache, ones)):
                    raise RuntimeError(_OVERFLOW_MSG)
            at["in_order"] = at["in_order"] and next_free == length // ps
            next_free += 1
        form = ("collect" if length + max_new_tokens - step > reachable
                else "K4" if at["in_order"] else "K8")
        if form not in loops:
            loops[form] = ws.loop(form, form_step(form), lambda: (*st.tensors(), pos, hh),
                                  graphed=graphed)
        at["length"], at["next_free"] = length + 1, next_free
        return loops[form]

    try:
        step = run_steps(None, lambda: bool(st.done.all()), max_new_tokens, before=before)
    finally:
        for loop in loops.values():
            loop.record(stats)
    return st.out_tokens.cpu().numpy(), step, at["compressions"]


def _seed_hh_from_prompt(cache: decoder.KVCache, length: int,
                         num_probes: int = 16) -> torch.Tensor:
    """Heavy-hitter scores [L, Hkv, Lmax] f32 of a batch-1 dense cache's
    slots: the attention mass of its last `num_probes` valid keys used as
    probe queries (the prefill's own probabilities never leave the
    attention kernel)."""
    n_layers, _, hkv, lmax, dh = cache.k.shape
    size = min(num_probes, lmax)
    start = min(max(length - num_probes, 0), lmax - size)
    k = cache.k[:, 0].reshape(n_layers * hkv, lmax, dh)
    return attention_mass(k[:, start:start + size], k, length).reshape(n_layers, hkv, lmax)


def _prefill_h2o(params, cfg, prompt_embeds: torch.Tensor, seq_length, *, max_new_tokens: int,
                 page_size: int, num_pages, max_pages_per_seq, hh_size: int, recent_size: int,
                 sink_size: int, merge, claim):
    """Prefill one row for H2O decode -> (workspace, first logits, padded
    length, host): the workspace `claim(...)` gives holds the paged cache
    ("cache") and the scores hh [L, Hkv, cap] ("hh"), both written in place;
    host holds the cache's length and the pool pages in use as host ints
    ("length", "next_free") and the compressions made (0 or 1). A dense
    prefill (chunked past the threshold) and the prompt's seeded scores; a
    prompt over the pool (padded length > cap) is compressed with
    `compress_kv` into a dense cache of cap slots first. The pool holds
    `num_pages` (default max_pages_per_seq, default prompt +
    max_new_tokens); `from_contiguous` raises ValueError when the paged
    prompt does not fit it."""
    b, s, _ = prompt_embeds.shape
    s_pad = _padded_length(s, page_size)
    if max_pages_per_seq is None:
        max_pages_per_seq = -(-(s_pad + max_new_tokens) // page_size)
    if num_pages is None:
        num_pages = max_pages_per_seq
    maxp, cap = max_pages_per_seq, max_pages_per_seq * page_size
    if s_pad > s:
        prompt_embeds = torch.nn.functional.pad(prompt_embeds, (0, 0, 0, s_pad - s))
    dev = prompt_embeds.device
    n = int(seq_length.reshape(-1)[0])
    dense = _dense_cache(cfg, 1, s_pad, False, prompt_embeds.dtype, dev)
    logits, dense = generate._prefill_inline(params, cfg, prompt_embeds, dense,
                                             seq_length.to(device=dev, dtype=torch.int32))
    n_layers, hkv, dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    ws = claim(True, num_pages, maxp, prompt_embeds.dtype, dev)
    hh = ws.get("hh", lambda: torch.empty(n_layers, hkv, cap, dtype=torch.float32, device=dev))
    hh.zero_()
    seed = _seed_hh_from_prompt(dense, n)
    host = dict(length=n, next_free=s_pad // page_size, compressions=0)
    if s_pad > cap:
        # The reference's H2O cache likewise evicts right after the prompt's
        # forward pass.
        k2, v2, s2, kept = compress_kv(
            dense.k[:, 0].reshape(n_layers * hkv, s_pad, dh),
            dense.v[:, 0].reshape(n_layers * hkv, s_pad, dh),
            seed.reshape(n_layers * hkv, s_pad), n, hh_size=hh_size, recent_size=recent_size,
            sink_size=sink_size, merge=merge)
        c = k2.shape[1]
        small = decoder.KVCache.create(cfg, 1, cap, dtype=dense.k.dtype, device=dev)
        small.k[:, 0, :, :c] = k2.reshape(n_layers, hkv, c, dh)
        small.v[:, 0, :, :c] = v2.reshape(n_layers, hkv, c, dh)
        small.length = kept.reshape(1).to(device=dev, dtype=torch.int32)
        dense = small
        hh[:, :, :c] = s2.reshape(n_layers, hkv, c)
        host.update(length=min(n, c), next_free=maxp, compressions=1)
    else:
        hh[:, :, :s_pad] = seed
    del seed
    _page_into(ws, from_contiguous, dense, num_pages, maxp, page_size)
    return ws, logits, s_pad, host


def _page_into(ws, page, dense, *args, **kw):
    """`page` (`from_contiguous` or its int8 twin) of a dense prefill into
    the workspace's pool, in place, or into a new pool the first time."""
    if "cache" in ws.tensors:
        return page(dense, *args, into=ws.tensors["cache"], **kw)
    return ws.get("cache", lambda: page(dense, *args, **kw))


def _padded_length(s: int, page_size: int) -> int:
    """A chunked prefill needs the 128-padded prompt inside the dense cache."""
    align = math.lcm(page_size, 128) if s > generate.CHUNKED_PREFILL_THRESHOLD else page_size
    return -(-s // align) * align


def _dense_cache(cfg, rows: int, s_pad: int, kv_int8: bool, dtype, device):
    """A long kv_int8 prompt prefills straight into the int8 dense cache."""
    if kv_int8 and s_pad > generate.CHUNKED_PREFILL_THRESHOLD:
        return decoder.Int8KVCache.create(cfg, rows, s_pad, device=device)
    return decoder.KVCache.create(cfg, rows, s_pad, dtype=dtype, device=device)


def _empty_cache(cfg, b: int, maxp: int, page_size: int, kv_int8: bool, dtype, device):
    """A statically partitioned pool of zero pages: row r owns pages
    [r * maxp, (r + 1) * maxp), its table fully mapped."""
    table, num_pages = _row_table(b, 0, maxp, True, device)
    shape = (cfg.num_layers, num_pages, cfg.num_kv_heads, page_size, cfg.head_dim)
    common = dict(page_table=table, length=torch.zeros(b, dtype=torch.int32, device=device),
                  next_free=torch.tensor(num_pages, dtype=torch.int32, device=device))
    if kv_int8:
        return PagedKVCacheInt8(
            k_pages=torch.zeros(shape, dtype=torch.int8, device=device),
            v_pages=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(shape[:4], dtype=torch.float32, device=device),
            v_scale=torch.zeros(shape[:4], dtype=torch.float32, device=device), **common)
    return PagedKVCache(k_pages=torch.zeros(shape, dtype=dtype, device=device),
                        v_pages=torch.zeros(shape, dtype=dtype, device=device), **common)


def _scatter_row_into_pools(cache, dense, ri: int, maxp: int) -> None:
    """Copy ONE row's dense cache ([L, 1, Hkv, S(, Dh)]) into its partition
    [ri * maxp, ri * maxp + S / page_size) of the pool, in place, one layer
    at a time; a bf16 row bound for int8 pages is quantized on the way
    (per-(token, head) scales, as `paged_kv._quantize_kv`)."""
    ppr = dense.k.shape[3] // cache.page_size
    int8_pool = isinstance(cache, PagedKVCacheInt8)
    pools = {"k": cache.k_pages, "v": cache.v_pages}
    if int8_pool:
        pools.update(k_s=cache.k_scale, v_s=cache.v_scale)
    for i in range(dense.k.shape[0]):
        vals = {"k": dense.k[i], "v": dense.v[i]}              # [1, Hkv, S(, Dh)]
        if isinstance(dense, decoder.Int8KVCache):
            vals.update(k_s=dense.k_s[i], v_s=dense.v_s[i])
        elif int8_pool:
            (vals["k"], vals["k_s"]), (vals["v"], vals["v_s"]) = (
                _quantize_kv(vals["k"]), _quantize_kv(vals["v"]))
        for name, pool in pools.items():
            _place(vals[name], pool[i, ri * maxp:(ri + 1) * maxp], ppr, ppr)


def _prefill_rows(params, cfg, rows: list, seq_length, *, maxp: int, page_size: int,
                  kv_int8: bool, claim):
    """Prefill the rows one at a time (B = 1 each) into a statically
    partitioned pool, the workspace's -> (workspace, first logits [B, V],
    padded length). Pages past each row's prompt keep what a former call
    at this key left there.

    `rows` holds [1, S, D] tensors or (after the first) callables making
    them; it is consumed, each entry dropped as its pages land."""
    shape0 = rows[0].shape
    if any(not callable(r) and r.shape != shape0 for r in rows):
        raise ValueError("row list must hold equal-shape [1, S, D] rows")
    b, s = len(rows), shape0[1]
    s_pad = _padded_length(s, page_size)
    dev, dtype = rows[0].device, rows[0].dtype
    ws = claim(True, b * maxp, maxp, dtype, dev)
    cache = ws.get("cache", lambda: _empty_cache(cfg, b, maxp, page_size, kv_int8, dtype, dev))
    table, num_pages = _row_table(b, 0, maxp, True, dev)
    cache.page_table.copy_(table)
    cache.next_free.fill_(num_pages)
    lengths = seq_length.to(device=dev, dtype=torch.int32)
    logits = []
    for r in range(b):
        er, rows[r] = rows[r], None
        if callable(er):
            er = er()
            if er.shape != shape0:
                raise ValueError(f"lazy row {r} produced shape {tuple(er.shape)}, "
                                 f"expected {tuple(shape0)}")
        if s_pad > s:
            er = torch.nn.functional.pad(er, (0, 0, 0, s_pad - s))
        dense = _dense_cache(cfg, 1, s_pad, kv_int8, dtype, dev)
        lg, dense = generate._prefill_inline(params, cfg, er, dense, lengths[r:r + 1])
        del er
        _scatter_row_into_pools(cache, dense, r, maxp)
        logits.append(lg)
        del dense
    cache.length.copy_(lengths)
    return ws, torch.cat(logits), s_pad


def _generate_paged_split(params, cfg, prompt_embeds, seq_length, *, max_new_tokens: int,
                          page_size: int, kv_int8: bool, spec_tokens: int, claim):
    """Batched rows on the default pool -> (workspace, first logits, padded
    length): row-by-row prefill into a partitioned pool whose rows hold the
    prompt, max_new_tokens and spec_tokens (a verify step writes its whole
    block before acceptance), rounded up to whole SEQ_POOL_BLOCKs."""
    if isinstance(prompt_embeds, (list, tuple)):
        rows = prompt_embeds if isinstance(prompt_embeds, list) else list(prompt_embeds)
    else:
        rows = [prompt_embeds[r:r + 1] for r in range(prompt_embeds.shape[0])]
    if callable(rows[0]):
        rows[0] = rows[0]()
    s_pad = _padded_length(rows[0].shape[1], page_size)
    maxp = -(-(s_pad + max_new_tokens + spec_tokens) // page_size)
    maxp = -(-maxp // SEQ_POOL_BLOCK) * SEQ_POOL_BLOCK
    return _prefill_rows(params, cfg, rows, seq_length, maxp=maxp, page_size=page_size,
                         kv_int8=kv_int8, claim=claim)


def _generate_paged_one(params, cfg, prompt_embeds: torch.Tensor, seq_length, *,
                        max_new_tokens: int, page_size: int, num_pages, max_pages_per_seq,
                        kv_int8: bool, spec_tokens: int, claim):
    """One row, or rows on a caller-sized pool -> (workspace, first logits,
    padded length, row_order). `row_order`: the pool is read in row order
    with no allocator, for a single row on the default pool (all its pages
    mapped in pool order) or a static partition prefilled row by row.
    Otherwise the rows prefill together and decode maps pages with the
    allocator and reads them through the table; that includes a single row
    on a caller-sized pool, where the allocator gives the slot after a
    short row's length a fresh page past its padded prompt's pages (the
    JAX package's row-order kernel would read that slot from the pool's
    order; its CPU path, the reference, reads through the table)."""
    b, s, _ = prompt_embeds.shape
    s_pad = _padded_length(s, page_size)
    identity = b == 1 and num_pages is None and max_pages_per_seq is None
    if max_pages_per_seq is None:
        max_pages_per_seq = -(-(s_pad + max_new_tokens + spec_tokens) // page_size)
        if b > 1:
            max_pages_per_seq = -(-max_pages_per_seq // SEQ_POOL_BLOCK) * SEQ_POOL_BLOCK
    if num_pages is None:
        num_pages = b * max_pages_per_seq
    maxp, cap = max_pages_per_seq, max_pages_per_seq * page_size
    if b > 1 and num_pages == b * maxp and maxp % 8 == 0 and s_pad <= cap:
        if bool((seq_length + max_new_tokens + spec_tokens > cap).any()):
            raise RuntimeError(_OVERFLOW_MSG)
        rows = [prompt_embeds[r:r + 1] for r in range(b)]
        ws, logits, s_pad = _prefill_rows(params, cfg, rows, seq_length, maxp=maxp,
                                          page_size=page_size, kv_int8=kv_int8, claim=claim)
        return ws, logits, s_pad, True
    if s_pad > s:
        prompt_embeds = torch.nn.functional.pad(prompt_embeds, (0, 0, 0, s_pad - s))
    if s_pad > cap:
        raise ValueError(f"prompt ({s_pad} tokens) exceeds the page pool ({cap}) and "
                         "H2O compression is disabled (hh_size=0)")
    dev = prompt_embeds.device
    dense = _dense_cache(cfg, b, s_pad, kv_int8, prompt_embeds.dtype, dev)
    logits, dense = generate._prefill_inline(params, cfg, prompt_embeds, dense,
                                             seq_length.to(device=dev, dtype=torch.int32))
    ws = claim(identity, num_pages, maxp, prompt_embeds.dtype, dev)
    cache = _page_into(ws, from_contiguous_int8 if kv_int8 else from_contiguous, dense,
                       num_pages, maxp, page_size)
    if identity:
        cache.page_table.copy_(torch.arange(maxp, dtype=torch.int32, device=dev)[None])
    return ws, logits, s_pad, identity
