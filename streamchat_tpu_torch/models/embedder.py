"""BERT-family text encoders for retrieval (`streamchat_tpu/models/embedder.py`).

mxbai-colbert-large (CLS pooling, tree search) and all-MiniLM-L6 (mean
pooling, dialogue memory): a plain PyTorch BERT with an additive padding
mask. Its products are ordinary matrix products (the JAX package leaves
them to XLA), so they stay `torch.matmul`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from streamchat_tpu_torch.config import BertConfig

Params = dict


def _layernorm(x, p, eps):
    y = torch.nn.functional.layer_norm(x.float(), (x.shape[-1],), p["scale"].float(),
                                       p["bias"].float(), eps)
    return y.to(x.dtype)


def _lin(x, p):
    return x @ p["w"] + p["b"]


def init(cfg: BertConfig, generator: torch.Generator, *, device="cpu",
         dtype=torch.float32) -> Params:
    d = cfg.hidden_size

    def normal(*shape, scale):
        return (torch.randn(*shape, generator=generator, device=device) * scale).to(dtype)

    def dense(kin, kout):
        return {"w": normal(kin, kout, scale=kin ** -0.5),
                "b": torch.zeros(kout, dtype=dtype, device=device)}

    def ln():
        return {"scale": torch.ones(d, dtype=dtype, device=device),
                "bias": torch.zeros(d, dtype=dtype, device=device)}

    layers = [{
        "attn": {"q": dense(d, d), "k": dense(d, d), "v": dense(d, d), "o": dense(d, d)},
        "attn_ln": ln(),
        "mlp": {"fc1": dense(d, cfg.intermediate_size),
                "fc2": dense(cfg.intermediate_size, d)},
        "mlp_ln": ln(),
    } for _ in range(cfg.num_layers)]
    return {
        "word_embed": normal(cfg.vocab_size, d, scale=0.02),
        "pos_embed": normal(cfg.max_position_embeddings, d, scale=0.02),
        "type_embed": torch.zeros(cfg.type_vocab_size, d, dtype=dtype, device=device),
        "embed_ln": ln(),
        "layers": layers,
    }


def forward(params: Params, cfg: BertConfig, token_ids: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """token_ids, mask: [B, S] -> last hidden state [B, S, D]."""
    b, s = token_ids.shape
    x = (params["word_embed"][token_ids] + params["pos_embed"][None, :s]
         + params["type_embed"][0][None, None])
    x = _layernorm(x, params["embed_ln"], cfg.layernorm_eps)
    neg = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9)
    h = cfg.num_heads
    dh = cfg.hidden_size // h
    for p in params["layers"]:
        q = _lin(x, p["attn"]["q"]).view(b, s, h, dh).transpose(1, 2)
        k = _lin(x, p["attn"]["k"]).view(b, s, h, dh).transpose(1, 2)
        v = _lin(x, p["attn"]["v"]).view(b, s, h, dh).transpose(1, 2)
        scores = (q.float() @ k.float().transpose(-1, -2)) * dh ** -0.5 + neg
        a = torch.softmax(scores, dim=-1).to(x.dtype)
        o = (a @ v).transpose(1, 2).reshape(b, s, cfg.hidden_size)
        x = _layernorm(x + _lin(o, p["attn"]["o"]), p["attn_ln"], cfg.layernorm_eps)
        hmid = torch.nn.functional.gelu(_lin(x, p["mlp"]["fc1"]).float()).to(x.dtype)
        x = _layernorm(x + _lin(hmid, p["mlp"]["fc2"]), p["mlp_ln"], cfg.layernorm_eps)
    return x


def pool(hidden: torch.Tensor, mask: torch.Tensor, strategy: str) -> torch.Tensor:
    """[B, S, D] -> [B, D] f32: 'cls' or 'mean' over the unmasked tokens."""
    if strategy == "cls":
        return hidden[:, 0].float()
    if strategy == "mean":
        m = mask[:, :, None].float()
        return (hidden.float() * m).sum(1) / m.sum(1).clamp_min(1e-9)
    raise ValueError(f"unknown pooling: {strategy}")


@dataclasses.dataclass
class TextEmbedder:
    """Batched sentence embedder with a host-side tokenizer."""

    params: Params
    cfg: BertConfig
    tokenizer: object
    max_length: int = 256

    @classmethod
    def init_random(cls, cfg: BertConfig | None = None, *, seed: int = 0, device="cuda"):
        """Random weights (default: the tiny geometry) on `device`, the card
        unless the caller asks for the CPU."""
        from streamchat_tpu_torch.models.tokenizer import ByteTokenizer

        cfg = cfg or BertConfig.tiny()
        g = torch.Generator(device=device).manual_seed(seed)
        return cls(init(cfg, g, device=device), cfg, ByteTokenizer(), max_length=128)

    @classmethod
    def from_pretrained(cls, path: str, pooling: str, dtype=torch.float32, *,
                        device="cuda", tokenizer=None):
        """Load a BERT HF checkpoint onto `device`, the card unless the
        caller asks for the CPU. `tokenizer` None reads the checkpoint's own
        (`load_tokenizer(path)`)."""
        from streamchat_tpu_torch.models import weights
        from streamchat_tpu_torch.models.tokenizer import load_tokenizer

        cfg, params = weights.load_bert(path, pooling, dtype, device=device)
        return cls(params, cfg, load_tokenizer(path) if tokenizer is None else tokenizer)

    def _batch_ids(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        # Sequences pad to a 16-multiple of at least 16 tokens, as in the
        # JAX package: an all-padding (empty) text then averages over the
        # same number of masked positions in both packages.
        encoded: List[List[int]] = [
            self.tokenizer.encode(t)[: self.max_length] for t in texts]
        s = max(16, max((len(e) for e in encoded), default=1))
        s = ((s + 15) // 16) * 16
        ids = np.zeros((len(texts), s), np.int64)
        mask = np.zeros((len(texts), s), np.int64)
        for i, e in enumerate(encoded):
            ids[i, : len(e)] = e
            mask[i, : len(e)] = 1
        return ids, mask

    def embed(self, texts: Sequence[str]) -> torch.Tensor:
        """Texts -> [N, D] f32 pooled embeddings (one batched forward)."""
        dev = self.params["word_embed"].device
        if not texts:
            return torch.zeros(0, self.cfg.hidden_size, device=dev)
        ids, mask = self._batch_ids(texts)
        ids_t = torch.from_numpy(ids).to(dev)
        mask_t = torch.from_numpy(mask).to(dev)
        hidden = forward(self.params, self.cfg, ids_t, mask_t)
        return pool(hidden, mask_t, self.cfg.pooling)

    def embed_tokens(self, texts: Sequence[str]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Texts -> ([N, S, D] token states, [N, S] mask) for MaxSim (the
        same batch and forward as `embed`, before pooling)."""
        dev = self.params["word_embed"].device
        ids, mask = self._batch_ids(texts)
        mask_t = torch.from_numpy(mask).to(dev)
        return forward(self.params, self.cfg, torch.from_numpy(ids).to(dev), mask_t), mask_t
