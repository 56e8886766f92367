"""KV-cache compression: H2O heavy-hitter eviction and its merge variants
(`streamchat_tpu/ops/kv_compress.py`).

* `hh_score` sums each (head, slot)'s attention mass over the decoded
  queries (`update_hh_score`; `attention_mass` recomputes it for probe
  queries).
* `compress_kv` keeps, per head, `sink_size` pinned first slots, the
  `hh_size` highest-scoring slots before the recent region and the
  `recent_size` most recent slots: C = sink + hh + recent slots in the
  original order, or the cache as it is when its length fits in C.
* `merge` folds each evicted slot's K/V into its nearest kept heavy hitter
  (by key similarity): "avg" a running mean, "weighted" a mean weighted by
  the evicted slot's score.

The selection is the JAX package's `lax.top_k`, which breaks ties toward
the lower index; `torch.topk` promises no order among ties, and ties are
common here (+inf sinks, -inf recent and padding, masses that underflow to
0), so the kept set comes from a stable descending sort. No kernel: the
JAX package leaves this to XLA on its chip, and a compression runs once
per `cap - C` decode steps.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def update_hh_score(hh_score: Optional[torch.Tensor], attn_probs: torch.Tensor) -> torch.Tensor:
    """Accumulate attention mass: attn_probs [H, Q, L] -> hh_score [H, L] f32."""
    add = attn_probs.float().sum(1)
    return add if hh_score is None else hh_score + add


def attention_mass(q: torch.Tensor, k: torch.Tensor, length, sm_scale: float | None = None
                   ) -> torch.Tensor:
    """Softmax mass of probe queries q [H, Q, D] over a cache k [H, L, D],
    slots at or past `length` masked, summed over the queries -> [H, L] f32."""
    d = q.shape[-1]
    if sm_scale is None:
        sm_scale = d ** -0.5
    s = torch.einsum("hqd,hld->hql", q.float(), k.float()) * sm_scale
    col = torch.arange(k.shape[1], device=k.device)
    s = s.masked_fill(col[None, None, :] >= torch.as_tensor(length, device=k.device), -1e30)
    return torch.softmax(s, dim=-1).sum(1)


def _kept_slots(hh_score, length, c: int, hh_size: int, recent_size: int, sink_size: int):
    """[H, C] slot indices compress_kv keeps (sorted within the heavy
    hitters, then the recent run), or the identity when length <= C."""
    h, l = hh_score.shape
    dev = hh_score.device
    pos = torch.arange(l, device=dev)[None]
    recent_start = length - recent_size
    # Recent slots and padding -inf FIRST, then sinks +inf: the other order
    # lets the recent mask erase a sink's pin when length < C.
    score = hh_score.float().masked_fill(pos >= recent_start, float("-inf"))
    score = score.masked_fill(pos < sink_size, float("inf"))
    order = torch.sort(score, dim=1, descending=True, stable=True).indices
    keep_hh = order[:, :sink_size + hh_size].sort(dim=1).values
    keep_recent = (recent_start + torch.arange(recent_size, device=dev)).clamp(0, l - 1)
    keep = torch.cat([keep_hh, keep_recent[None].expand(h, recent_size)], dim=1)
    identity = torch.arange(c, device=dev)[None].expand(h, c)
    return torch.where(length <= c, identity, keep)


def compress_kv(k: torch.Tensor, v: torch.Tensor, hh_score: torch.Tensor, length, *,
                hh_size: int, recent_size: int, sink_size: int = 0,
                merge: Optional[str] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Evict to C = sink_size + hh_size + recent_size slots per head.

    k, v [H, L, D], hh_score [H, L], length: valid slots (<= L; an int or a
    0-d tensor) -> (k', v', hh_score', kept_length) with C slots per head
    (L when C >= L), kept_length = min(length, C) int32. Heads are
    independent, so H may stack several layers' heads."""
    h, l, d = k.shape
    c = sink_size + hh_size + recent_size
    length = torch.as_tensor(length, device=k.device)
    kept_length = torch.minimum(length, torch.tensor(c, device=k.device)).to(torch.int32)
    if c >= l:
        return k[:, :c], v[:, :c], hh_score[:, :c], kept_length
    keep = _kept_slots(hh_score, length, c, hh_size, recent_size, sink_size)
    k_kept = k.gather(1, keep[:, :, None].expand(h, c, d))
    v_kept = v.gather(1, keep[:, :, None].expand(h, c, d))
    s_kept = hh_score.gather(1, keep)
    if merge is not None:
        n_hh = sink_size + hh_size
        kept_mask = torch.zeros(h, l, dtype=torch.bool, device=k.device).scatter_(1, keep, True)
        valid = torch.arange(l, device=k.device)[None] < length
        pruned = ~kept_mask & valid                                       # [H, L]
        # Slots past the length may hold anything (a reused pool): 0 x NaN.
        kf = torch.where(valid[..., None], k.float(), 0.0)
        vf = torch.where(valid[..., None], v.float(), 0.0)
        sim = torch.einsum("hld,hcd->hlc", kf, k_kept[:, :n_hh].float())
        nearest = sim.argmax(dim=2)                                       # first maximum
        w = (torch.where(pruned, hh_score.float(), 0.0) if merge == "weighted"
             else pruned.float())
        onehot = torch.nn.functional.one_hot(nearest, n_hh).float() * w[:, :, None]
        denom = onehot.sum(1) + 1.0                                       # + the kept slot
        k_upd = (k_kept[:, :n_hh].float() + torch.einsum("hlc,hld->hcd", onehot, kf)
                 ) / denom[:, :, None]
        v_upd = (v_kept[:, :n_hh].float() + torch.einsum("hlc,hld->hcd", onehot, vf)
                 ) / denom[:, :, None]
        k_kept = torch.cat([k_upd.to(k.dtype), k_kept[:, n_hh:]], dim=1)
        v_kept = torch.cat([v_upd.to(v.dtype), v_kept[:, n_hh:]], dim=1)
    return k_kept, v_kept, s_kept, kept_length


def compress_cache(cache, probe_queries: torch.Tensor, *, hh_size: int, recent_size: int,
                   sink_size: int = 0, merge: Optional[str] = None):
    """Compress a whole dense `decoder.KVCache` (batch 1) between generation
    rounds: each layer's slots are scored by the mass of its probe queries
    probe_queries [L, Hkv * G, Q, Dh] (each kv head summing its query
    group's) and compressed with `compress_kv`. Returns a KVCache of the
    same Lmax whose first kept_length slots hold the surviving K/V."""
    from streamchat_tpu_torch.models.decoder import KVCache

    n_layers, b, hkv, lmax, dh = cache.k.shape
    if b != 1:
        raise ValueError("compress_cache supports batch 1")
    g = probe_queries.shape[1] // hkv
    length = cache.length[0]
    new_k, new_v = torch.zeros_like(cache.k), torch.zeros_like(cache.v)
    kept = None
    for i in range(n_layers):
        k_l, v_l = cache.k[i, 0], cache.v[i, 0]
        mass = attention_mass(probe_queries[i], k_l.repeat_interleave(g, dim=0), length)
        mass = mass.reshape(hkv, g, lmax).sum(1)
        k2, v2, _, kept = compress_kv(k_l, v_l, mass, length, hh_size=hh_size,
                                      recent_size=recent_size, sink_size=sink_size,
                                      merge=merge)
        new_k[i, 0, :, :k2.shape[1]] = k2
        new_v[i, 0, :, :v2.shape[1]] = v2
    return KVCache(k=new_k, v=new_v, length=kept[None].to(torch.int32))
