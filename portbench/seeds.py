"""Sub-seeds: every random stream of a run comes from `--seed` and a tag, so
one part can be made again alone (a layer's weights, a frame) with the same
values."""

from __future__ import annotations

import hashlib


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream `tag` of run seed `seed`."""
    digest = hashlib.sha256(f"{int(seed)}/{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)
