"""Teacher-forced sequence scoring, the `--ppl` metric
(`streamchat_tpu/models/scoring.py`).

The mean negative log-likelihood of an answer continuation given a
(spliced) prompt: the prompt and the target's token embeddings go through
the decoder in one prefill-style pass (`decoder.forward`, not chunked: K3
at S = prompt + target on the card, whatever S is), into a fresh dense
`KVCache` in the embeddings' dtype, as in the JAX package (an int8 KV
cache is never used here). Position i predicts token i + 1, so the T
targets are read off the hidden rows [prompt_len - 1, prompt_len + T - 1).
The JAX package computes [1, S, V] f32 logits and their log-softmax over
every row and masks all but those T; each row's logits depend on that row
alone, so only the T rows go through the head and the log-softmax here
(at Qwen2's 152,064-token vocabulary the whole tensor would take 0.61 MB a
token, twice). The head is `decoder.logits_from_hidden`: an int8 head at
more than 8 rows takes `ops/quant.qmatmul`'s converted-weight product.
"""

from __future__ import annotations

import torch

from streamchat_tpu_torch.config import DecoderConfig
from streamchat_tpu_torch.models import decoder
from streamchat_tpu_torch.models.decoder import KVCache
from streamchat_tpu_torch.models.generate import pad_to_bucket


def _padded(params, prompt_embeds: torch.Tensor, prompt_len: int,
            target_ids: torch.Tensor) -> torch.Tensor:
    """[1, S_pad, D]: the prompt's valid prefix, then the target's token
    embeddings, zero-padded to a 128-token bucket."""
    t = int(target_ids.shape[0])
    d = prompt_embeds.shape[-1]
    total = prompt_len + t
    full = torch.zeros(1, pad_to_bucket(total), d, dtype=prompt_embeds.dtype,
                       device=prompt_embeds.device)
    full[:, :prompt_len] = prompt_embeds[:, :prompt_len]
    full[:, prompt_len:total] = decoder.embed_tokens(params, target_ids).to(prompt_embeds.dtype)
    return full


def pass_hidden(params, cfg: DecoderConfig, prompt_embeds: torch.Tensor,
                prompt_len: int, target_ids: torch.Tensor) -> torch.Tensor:
    """[S_pad, D] post-norm hidden rows of the one pass over the prompt and
    the target's token embeddings; row i predicts token i + 1."""
    t = int(target_ids.shape[0])
    embeds = _padded(params, prompt_embeds, prompt_len, target_ids)
    s, dev = embeds.shape[1], embeds.device
    cache = KVCache.create(cfg, 1, s, dtype=embeds.dtype, device=dev)
    hidden, _ = decoder.forward(
        params, cfg, embeds, torch.arange(s, device=dev)[None], cache,
        torch.tensor([prompt_len + t], dtype=torch.int32, device=dev))
    return hidden[0]


def target_log_softmax(params, cfg: DecoderConfig, prompt_embeds: torch.Tensor,
                       prompt_len: int, target_ids: torch.Tensor) -> torch.Tensor:
    """[T, V] f32 log-softmax of the logits at the rows that predict each
    target token (T = len(target_ids) > 0)."""
    t = int(target_ids.shape[0])
    rows = pass_hidden(params, cfg, prompt_embeds, prompt_len, target_ids)
    rows = rows[prompt_len - 1: prompt_len + t - 1]
    return torch.log_softmax(decoder.logits_from_hidden(params, cfg, rows), dim=-1)


def target_logprobs(params, cfg: DecoderConfig, prompt_embeds: torch.Tensor,
                    prompt_len: int, target_ids: torch.Tensor) -> torch.Tensor:
    """[T] f32 log-probability of each target token given what precedes it."""
    logp = target_log_softmax(params, cfg, prompt_embeds, prompt_len, target_ids)
    return logp.gather(1, target_ids.long().to(logp.device)[:, None])[:, 0]


def sequence_nll(params, cfg: DecoderConfig, prompt_embeds: torch.Tensor, prompt_len: int,
                 target_ids: torch.Tensor) -> torch.Tensor:
    """Mean NLL (f32 scalar) of target_ids [T] as the continuation of the
    prompt, prompt_embeds [1, S_pad, D] with `prompt_len` valid rows; 0 for
    an empty target."""
    if int(target_ids.shape[0]) == 0:
        return torch.zeros((), device=prompt_embeds.device)
    return -target_logprobs(params, cfg, prompt_embeds, prompt_len, target_ids).mean()
