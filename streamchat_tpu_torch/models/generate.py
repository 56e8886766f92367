"""Prompt bucketing and the prefill dispatch (`streamchat_tpu/models/generate.py`).

Prompts of up to `CHUNKED_PREFILL_THRESHOLD` tokens prefill in one pass
(`decoder.prefill`, K3); longer ones prefill in chunks of half the
threshold (`decoder.prefill_chunked`: K3 for chunk 0, K5 for the rest), for
every weight and KV storage, as `_prefill_inline` does in the JAX package.
Paged generation lives in `models/generate_paged.py`.
"""

from __future__ import annotations

from streamchat_tpu_torch.models import decoder

CHUNKED_PREFILL_THRESHOLD = 8192


def _prefill_inline(params, cfg, embeds, cache, seq_length):
    """Prefill a padded prompt into a fresh dense cache -> (logits [B, V], cache)."""
    if embeds.shape[1] > CHUNKED_PREFILL_THRESHOLD:
        return decoder.prefill_chunked(params, cfg, embeds, cache, seq_length,
                                       chunk=CHUNKED_PREFILL_THRESHOLD // 2)
    return decoder.prefill(params, cfg, embeds, cache, seq_length)


def pad_to_bucket(length: int, bucket: int = 128, minimum: int = 128) -> int:
    """Round a prompt length up to a bucket."""
    return max(minimum, ((length + bucket - 1) // bucket) * bucket)
