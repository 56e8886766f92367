"""Process start-up and benchmark sharding (`streamchat_tpu/parallel/multihost.py`).

`initialize` joins the process group that `torchrun` describes in the
environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT); without it it is
a no-op that returns (0, 1), as `jax.distributed` is on one host. Its
timeout bounds every collective, so ranks that diverge fail the run
instead of hanging it. `host_shard` is the JAX package's contiguous
ceil-split of an annotation list over the data replicas, and
`local_device` the card of this rank.
"""

from __future__ import annotations

import datetime
import math
import os
from typing import List, Optional, Sequence, Tuple

import torch

# Seconds a collective may wait for the other ranks before it raises.
TIMEOUT_S = 600


def initialize(backend: str) -> Tuple[int, int]:
    """Join torchrun's process group over `backend` -> (rank, world size).
    An already initialized group is kept; with no torchrun environment this
    returns (0, 1)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if "WORLD_SIZE" not in os.environ:
        return 0, 1
    dist.init_process_group(backend, init_method="env://",
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return dist.get_rank(), dist.get_world_size()


def host_shard(items: Sequence, process_id: Optional[int] = None,
               process_count: Optional[int] = None, mesh=None) -> List:
    """This data replica's contiguous ceil-split shard of `items`: the
    ranks of one model group share a replica and take the same items (as
    one JAX process holds the whole model axis). The replica is `mesh`'s
    (data index, dp); `process_id` / `process_count`, when given, take
    their place. In an initialized process group the layout is the
    caller's (it follows the decoder's kv heads), so a call with neither a
    mesh nor both ids raises; without a group it is a world of one."""
    import torch.distributed as dist

    if mesh is not None:
        data, dp = mesh.data, mesh.dp
    elif (process_id is None or process_count is None) and dist.is_initialized():
        raise ValueError("host_shard in a process group: pass mesh= (the make_mesh "
                         "of the run) or process_id and process_count")
    else:
        data, dp = 0, 1
    pid = data if process_id is None else process_id
    n = dp if process_count is None else process_count
    size = math.ceil(len(items) / n)
    return list(items[pid * size: (pid + 1) * size])


def local_device() -> torch.device:
    """cuda:{LOCAL_RANK % device count}: ranks beyond the cards share them."""
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                        % torch.cuda.device_count())
