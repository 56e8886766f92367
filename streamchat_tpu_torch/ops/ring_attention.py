"""Ring attention: exact attention over a sequence split across ranks
(`streamchat_tpu/ops/ring_attention.py`).

Each rank holds one shard of the sequence (q [B, H, S/n, D], k / v
[B, Hkv, S/n, D]); the K/V shards travel the ring of the group once, and
each rank merges its queries' attention against every block with the f32
online-softmax rescale. The result is the rank's output shard. These are
per-rank functions over a `torch.distributed` group, the shape of the
reference's own sequence-parallel API (its vendored
`vila/train/sequence_parallel/`); the JAX package runs the same schedule
under `shard_map` with `lax.ppermute`.

Each op is a per-step local function and its transport:
- `ring_step` is one block: K5 (`ops.attention.flash_attention_partial`,
  its plain twin on the CPU) at the block's GLOBAL offsets, then the merge
  with the finite `NEG_INF` (rows no key has reached keep m = NEG_INF and
  l = 0, so the rescale stays finite and poisons nothing);
- `zigzag_step` and `stripe_step` are the balanced layouts' steps;
- the transport (`_ring`) sends the held block to rank + 1 and receives
  from rank - 1 with `dist.batch_isend_irecv`, issued before the step's K5,
  as the JAX body issues its ppermute first, and waited on after it.
Driving the step functions over a list of every rank's shards gives the
same result in one process (`chip_smoke.py` does so on the card).

Layouts: `ring_attention` shards the sequence contiguously (rank r holds
[r S/n, (r + 1) S/n)); `zigzag_ring_attention` takes the rank's piece of
the sequence permuted by `zigzag_indices` (chunks r and 2n - 1 - r of 2n),
`stripe_ring_attention` by `stripe_indices` (tokens r, r + n, ...), each
cut into n contiguous pieces (`sequence_shard` cuts any of the three and
raises on a length that does not divide); `inverse_permutation` puts the
gathered outputs back in order.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from streamchat_tpu_torch.ops.attention import flash_attention_partial

NEG_INF = -1e30

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]     # acc, m, l


def ring_init(q: torch.Tensor) -> State:
    """Empty merge state for queries q [B, H, Sq, D]: acc 0, m NEG_INF, l 0 (f32)."""
    b, h, sq, d = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    return (torch.zeros(b, h, sq, d, **f32), torch.full((b, h, sq), NEG_INF, **f32),
            torch.zeros(b, h, sq, **f32))


def merge(state: State, block: State) -> State:
    """Online-softmax merge of a block's (acc, m, l) into the state, in f32."""
    acc, m, l = state
    a, bm, bl = block
    new_m = torch.maximum(m, bm)
    alpha, beta = torch.exp(m - new_m), torch.exp(bm - new_m)
    return acc * alpha[..., None] + a * beta[..., None], new_m, l * alpha + bl * beta


def ring_finish(state: State, dtype) -> torch.Tensor:
    """acc / l (0 where l == 0) in `dtype`."""
    acc, _, l = state
    return (acc / torch.where(l == 0.0, torch.ones_like(l), l)[..., None]).to(dtype)


def ring_step(state: State, q, k, v, q_offset: int, k_offset: int, *, sm_scale=None,
              causal: bool = True, kv_length: Optional[torch.Tensor] = None) -> State:
    """Merge the attention of q (its first row at global position
    q_offset) against one K/V block (its first key at k_offset): K5 with
    global causality k_offset + col <= q_offset + row. kv_length [B] masks
    GLOBAL keys at and past each row's length (the block sees
    clamp(kv_length - k_offset, 0, Sk) of its keys)."""
    block_len = None
    if kv_length is not None:
        block_len = (kv_length - k_offset).clamp(0, k.shape[2]).to(torch.int32)
    blk = flash_attention_partial(q, k, v, q_offset, k_offset, block_len, causal=causal,
                                  neg_inf=NEG_INF, sm_scale=sm_scale)
    return merge(state, blk)


def zigzag_step(states: Sequence[State], q, k, v, rank: int, origin: int, n: int, *,
                sm_scale=None, causal: bool = True) -> List[State]:
    """One zigzag block: the rank's two query chunks (r and 2n - 1 - r)
    against the two key chunks of the block from rank `origin`."""
    c = q.shape[2] // 2
    q_offs = (rank * c, (2 * n - 1 - rank) * c)
    k_offs = (origin * c, (2 * n - 1 - origin) * c)
    out = []
    for half, st in enumerate(states):
        qh = q[:, :, half * c:(half + 1) * c]
        for kh in range(2):
            st = ring_step(st, qh, k[:, :, kh * c:(kh + 1) * c], v[:, :, kh * c:(kh + 1) * c],
                           q_offs[half], k_offs[kh], sm_scale=sm_scale, causal=causal)
        out.append(st)
    return out


def stripe_step(state: State, q, k, v, rank: int, origin: int, *, sm_scale=None,
                causal: bool = True) -> State:
    """One stripe block: local token t of rank r is global r + t n, so the
    block from `origin` masks as s <= t (origin <= r) or s <= t - 1
    (origin > r): K5 at q_offset 0, k_offset 0 or 1."""
    return ring_step(state, q, k, v, 0, int(origin > rank), sm_scale=sm_scale, causal=causal)


def _group(group) -> Tuple[int, int]:
    import torch.distributed as dist

    return dist.get_rank(group), dist.get_world_size(group)


def _peer(group, r: int) -> int:
    import torch.distributed as dist

    return r if group is None else dist.get_global_rank(group, r)


def _ring(group, k, v, step: Callable[[torch.Tensor, torch.Tensor, int], None]) -> None:
    """Call step(k_block, v_block, origin) for the n blocks the ring brings
    this rank, its own first; each rotation is issued before the step
    and waited on after it."""
    import torch.distributed as dist

    rank, n = _group(group)
    nxt, prv = _peer(group, (rank + 1) % n), _peer(group, (rank - 1) % n)
    origin = rank
    for s in range(n):
        reqs = bufs = None
        if s + 1 < n:
            bufs = [torch.empty_like(k), torch.empty_like(v)]
            ops = []
            for t, buf in zip((k, v), bufs):
                ops.append(dist.P2POp(dist.isend, t, nxt, group))
                ops.append(dist.P2POp(dist.irecv, buf, prv, group))
            reqs = dist.batch_isend_irecv(ops)
        step(k, v, origin)
        if reqs is not None:
            for req in reqs:
                req.wait()
            k, v = bufs
            origin = (origin - 1) % n


def ring_attention(q, k, v, group=None, *, causal: bool = True, sm_scale=None,
                   kv_length: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The rank's output shard of exact attention over a sequence cut
    contiguously over `group` (None: the world): q [B, H, S/n, D], k / v
    [B, Hkv, S/n, D]. kv_length [B] int32 masks each row's GLOBAL keys at
    and past its length (the reference's ring varlen); outputs at padded
    query rows are to be sliced away by the caller."""
    rank, n = _group(group)
    k, v = k.contiguous(), v.contiguous()
    sl = q.shape[2]
    state = [ring_init(q)]

    def step(kb, vb, origin):
        state[0] = ring_step(state[0], q, kb, vb, rank * sl, origin * sl, sm_scale=sm_scale,
                             causal=causal, kv_length=kv_length)

    _ring(group, k, v, step)
    return ring_finish(state[0], q.dtype)


def zigzag_ring_attention(q, k, v, group=None, *, causal: bool = True,
                          sm_scale=None) -> torch.Tensor:
    """The rank's output shard of exact attention, zigzag-balanced: q / k /
    v are the rank's piece of the sequence permuted by
    `zigzag_indices(S, n)`, its two chunks (r, 2n - 1 - r) of S/(2n) tokens."""
    if q.shape[2] % 2:
        raise ValueError(f"zigzag_ring_attention: a rank's {q.shape[2]} tokens are not two "
                         "equal chunks")
    rank, n = _group(group)
    k, v = k.contiguous(), v.contiguous()
    states = [ring_init(q[:, :, :q.shape[2] // 2]) for _ in range(2)]

    def step(kb, vb, origin):
        states[:] = zigzag_step(states, q, kb, vb, rank, origin, n, sm_scale=sm_scale,
                                causal=causal)

    _ring(group, k, v, step)
    return torch.cat([ring_finish(st, q.dtype) for st in states], dim=2)


def stripe_ring_attention(q, k, v, group=None, *, causal: bool = True,
                          sm_scale=None) -> torch.Tensor:
    """The rank's output shard of exact attention, stripe-balanced: q / k /
    v are the rank's tokens r, r + n, r + 2n, ... (`stripe_indices`)."""
    rank, _ = _group(group)
    k, v = k.contiguous(), v.contiguous()
    state = [ring_init(q)]

    def step(kb, vb, origin):
        state[0] = stripe_step(state[0], q, kb, vb, rank, origin, sm_scale=sm_scale,
                               causal=causal)

    _ring(group, k, v, step)
    return ring_finish(state[0], q.dtype)


def zigzag_indices(s: int, n: int) -> torch.Tensor:
    """Global permutation for zigzag sharding: rank i holds chunks
    (i, 2n-1-i) of 2n equal chunks, so each rank's causal work is equal."""
    c = s // (2 * n)
    order = []
    for i in range(n):
        order.extend(range(i * c, (i + 1) * c))
        order.extend(range((2 * n - 1 - i) * c, (2 * n - i) * c))
    return torch.tensor(order, dtype=torch.int32)


def stripe_indices(s: int, n: int) -> torch.Tensor:
    """Global permutation for stripe sharding: rank i holds tokens i, i+n,
    i+2n, ..."""
    c = s // n
    order = []
    for i in range(n):
        order.extend(range(i, s, n))
    assert len(order) == n * c
    return torch.tensor(order, dtype=torch.int32)


def sequence_shard(x: torch.Tensor, rank: int, n: int, layout: str = "contiguous",
                   dim: int = 2) -> torch.Tensor:
    """Rank `rank`'s piece of the whole sequence x (along `dim`) in a
    layout: "contiguous" (`ring_attention`, Ulysses), "zigzag" or
    "stripe". ValueError when the length does not divide (2n for zigzag)."""
    s = x.shape[dim]
    parts = 2 * n if layout == "zigzag" else n
    if s % parts:
        raise ValueError(f"sequence {s} not divisible by {parts} ({layout} over {n} ranks)")
    if layout != "contiguous":
        idx = (zigzag_indices if layout == "zigzag" else stripe_indices)(s, n)
        x = x.index_select(dim, idx.to(x.device).long())
    return x.narrow(dim, rank * (s // n), s // n)


def inverse_permutation(idx: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(idx)
    inv[idx.long()] = torch.arange(idx.shape[0], dtype=idx.dtype)
    return inv
