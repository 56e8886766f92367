"""Process start-up and benchmark sharding (`streamchat_tpu/parallel/multihost.py`).

`initialize` joins the process group that `torchrun` describes in the
environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT); without it it is
a no-op that returns (0, 1), as `jax.distributed` is on one host. Its
timeout bounds every collective, so ranks that diverge fail the run
instead of hanging it. `host_shard` is the JAX package's contiguous
ceil-split of an annotation list, and `local_device` the card of this rank.
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
               process_count: Optional[int] = None) -> List:
    """This process's contiguous ceil-split shard of `items` (the rank and
    world size of the initialized group by default)."""
    import torch.distributed as dist

    up = dist.is_initialized()
    pid = (dist.get_rank() if up else 0) if process_id is None else process_id
    n = (dist.get_world_size() if up else 1) if process_count is None else process_count
    size = math.ceil(len(items) / n)
    return list(items[pid * size: (pid + 1) * size])


def local_device() -> torch.device:
    """cuda:{LOCAL_RANK % device count}: ranks beyond the cards share them."""
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                        % torch.cuda.device_count())
