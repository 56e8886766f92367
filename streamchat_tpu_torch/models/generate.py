"""Prompt bucketing for generation (`streamchat_tpu/models/generate.py`).

The JAX package switches prompts over 8192 tokens to a chunked prefill to
fit a 16 GB chip (`generate.py:116-128`); the port prefills every prompt in
one pass (`decoder.prefill`), which fits the H100's 80 GB at the v0.3
caption lengths (~23k tokens). Paged generation lives in
`models/generate_paged.py`.
"""

from __future__ import annotations


def pad_to_bucket(length: int, bucket: int = 128, minimum: int = 128) -> int:
    """Round a prompt length up to a bucket."""
    return max(minimum, ((length + bucket - 1) // bucket) * bucket)
