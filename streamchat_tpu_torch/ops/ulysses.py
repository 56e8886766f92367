"""Ulysses sequence parallelism and the USP hybrid
(`streamchat_tpu/ops/ulysses.py`).

Ulysses (the reference's `UlyssesAttention`,
vila/train/sequence_parallel/ulysses_attn.py:97): each rank passes its
sequence shard [B, H, S/n, D]; an all-to-all scatters the heads and gathers
the sequence ([B, H/n, S, D]), K3 (`ops.attention.flash_attention`, its
plain twin on the CPU) attends over the whole sequence for the rank's head
slice, and a second all-to-all restores the sequence shard. Exact, two
collectives, no softmax bookkeeping.

`usp_attention` is the reference's USP hybrid (hybrid_attn.py:60-282) on
the (data, model) mesh (`parallel.make_mesh`), rank = a nu + u for its
coordinates (a, u) on nr x nu; the sequence is cut ring-major (rank (a, u)
holds piece a nu + u of nr nu pieces). The all-to-all over the Ulysses
group (the model group: the ranks of one a) gives each rank its ring block
a for H/nu heads; the ring over the data group (the ranks of one u) runs at
that block's global offset; the second all-to-all restores the shard.

`all_to_all` is the collective (`dist.all_to_all_single` over chunks
stacked along a leading dim) and `exchange` its effect on a list of every
rank's tensors in one process: rank r receives chunk r of each rank's
`split_axis`, concatenated along `concat_axis` in rank order.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from streamchat_tpu_torch.ops.attention import flash_attention
from streamchat_tpu_torch.ops.ring_attention import ring_finish, ring_init, ring_step, _ring


def exchange(xs: Sequence[torch.Tensor], split_axis: int, concat_axis: int) -> List[torch.Tensor]:
    """The all-to-all over n ranks' tensors xs, in one process."""
    n = len(xs)
    chunks = [x.chunk(n, dim=split_axis) for x in xs]
    return [torch.cat([chunks[i][r] for i in range(n)], dim=concat_axis) for r in range(n)]


def all_to_all(x: torch.Tensor, group, split_axis: int, concat_axis: int) -> torch.Tensor:
    """This rank's part of `exchange` over `group`."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    inp = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    return torch.cat(out.unbind(0), dim=concat_axis)


def check_heads(h: int, hkv: int, n: int) -> None:
    """ValueError unless the query and kv heads split over n ranks."""
    if h % n or hkv % n:
        raise ValueError(f"H={h}, Hkv={hkv} must each be divisible by {n} ranks")


def ulysses_local(q, k, v, *, causal: bool = True, sm_scale=None) -> torch.Tensor:
    """The attention of one rank's head slice over the whole sequence (K3)."""
    return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)


def ulysses_attention(q, k, v, group=None, *, causal: bool = True,
                      sm_scale=None) -> torch.Tensor:
    """The rank's output shard [B, H, S/n, D] of exact attention over a
    sequence cut contiguously over `group` (None: the world); q [B, H, S/n,
    D], k / v [B, Hkv, S/n, D], H and Hkv divisible by the group's size."""
    import torch.distributed as dist

    check_heads(q.shape[1], k.shape[1], dist.get_world_size(group))
    q, k, v = (all_to_all(t, group, 1, 2) for t in (q, k, v))
    return all_to_all(ulysses_local(q, k, v, causal=causal, sm_scale=sm_scale), group, 2, 1)


def usp_attention(q, k, v, mesh, *, causal: bool = True, sm_scale=None) -> torch.Tensor:
    """The rank's output shard of exact attention, ring inside Ulysses (sp =
    ring x ulysses) on a `parallel.Mesh`: Ulysses over its model group, the
    ring over its data group (JAX `usp_attention`'s default axes). q / k /
    v are the rank's piece d tp + m of the sequence cut into dp tp pieces,
    where (d, m) are its mesh coordinates."""
    nu, a = mesh.tp, mesh.data
    check_heads(q.shape[1], k.shape[1], nu)
    if nu > 1:
        q, k, v = (all_to_all(t, mesh.model.group, 1, 2) for t in (q, k, v))
    block = q.shape[2]                       # the ring block: S / dp tokens
    state = [ring_init(q)]

    def step(kb, vb, origin):
        state[0] = ring_step(state[0], q, kb, vb, a * block, origin * block,
                             sm_scale=sm_scale, causal=causal)

    if mesh.dp > 1:
        _ring(mesh.data_group, k.contiguous(), v.contiguous(), step)
    else:
        step(k, v, 0)
    out = ring_finish(state[0], q.dtype)
    return all_to_all(out, mesh.model.group, 2, 1) if nu > 1 else out
