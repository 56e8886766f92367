"""The plain reference: LongVA-7B (CLIP ViT-L/14-336, the mlp2x_gelu
projector, Qwen2) and the BERT retrieval encoder, in float32 plain
PyTorch, from the published equations. It imports nothing of the program
and takes none of its tensors: it makes the weights again from the seed
(portbench/weights.py), one group at a time, and works out again what the
program derives from them (the quantized weights, the int8 KV cache) with
the frozen arithmetic of reference/quant.py.

A "mode" says in which precision a model is computed:
  ViT / BERT: "f32" (the reference) or a control ("fp8": weights and each
    matmul input rounded to float8 e4m3 with a scale; "bf16").
  decoder: (weight_bits, kv_bits), weight_bits 16 (as served, bf16 values),
    8 (int8 per output channel) or 4 (int4 in groups of 128, the head
    int8); kv_bits None (as computed) or 8 / 4 (per token and head).
TF32 is off while the reference runs (`float32_matmuls`).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from portbench import weights
from portbench.reference import quant

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGE_TOKEN = "<image>"


@contextlib.contextmanager
def float32_matmuls() -> Iterator[None]:
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _f32(group: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.float() for k, v in group.items()}


def _linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
            mode: str = "f32") -> torch.Tensor:
    """x @ w.T + b, w in HF [out, in] layout, in `mode`."""
    if mode == "fp8":
        x, w = quant.fp8_round(x, per_row=False), quant.fp8_round(w, per_row=True)
    elif mode == "bf16":
        x, w = x.bfloat16(), w.bfloat16()
        b = None if b is None else b.bfloat16()
        y = x @ w.t()
        return (y if b is None else y + b).float()
    y = x @ w.t()
    return y if b is None else y + b


def _layernorm(x, w, b, eps, mode="f32"):
    y = F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(), eps)
    return y.bfloat16().float() if mode == "bf16" else y


# --------------------------------------------------------------------------
# Frames -> features: CLIP preprocessing, the tower, the projector
# --------------------------------------------------------------------------


def preprocess(frames, image_size: int, device) -> torch.Tensor:
    """uint8 RGB [N, H, W, 3] -> [N, 3, S, S] f32: shortest edge to S by
    antialiased bicubic, centre crop, CLIP mean / std."""
    x = torch.as_tensor(frames, device=device).permute(0, 3, 1, 2).float() / 255.0
    _, _, h, w = x.shape
    if h <= w:
        nh, nw = image_size, max(image_size, int(round(w * image_size / h)))
    else:
        nh, nw = max(image_size, int(round(h * image_size / w))), image_size
    if (nh, nw) != (h, w):
        x = F.interpolate(x, size=(nh, nw), mode="bicubic", align_corners=False,
                          antialias=True)
    top, left = (nh - image_size) // 2, (nw - image_size) // 2
    x = x[:, :, top:top + image_size, left:left + image_size]
    mean = torch.tensor(CLIP_MEAN, device=device)[None, :, None, None]
    std = torch.tensor(CLIP_STD, device=device)[None, :, None, None]
    return ((x - mean) / std).clamp(-10.0, 10.0)


def image_features(cfg: dict, seed: int, frames, device, mode: str = "f32") -> torch.Tensor:
    """Frames -> projected patch features [N, P, hidden] f32: CLIP up to
    hidden_states[mm_vision_select_layer] without CLS, then mlp2x_gelu."""
    vc = cfg["vision_config"]
    d, heads, ps = vc["hidden_size"], vc["num_attention_heads"], vc["patch_size"]
    eps = float(vc["layer_norm_eps"])
    groups = weights.vit_groups(cfg)
    p = weights.VIT_PREFIX

    def make(tag):
        return _f32(weights.make_group(groups[tag], seed, tag, device, torch.bfloat16))

    pix = preprocess(frames, vc["image_size"], device)
    n, g = pix.shape[0], vc["image_size"] // ps
    emb = make("vit.embed")
    patches = pix.reshape(n, 3, g, ps, g, ps).permute(0, 2, 4, 1, 3, 5).reshape(n, g * g, -1)
    x = _linear(patches, emb[p + "embeddings.patch_embedding.weight"].reshape(d, -1), mode=mode)
    cls = emb[p + "embeddings.class_embedding"].expand(n, 1, d)
    x = torch.cat([cls, x], 1) + emb[p + "embeddings.position_embedding.weight"][None]
    x = _layernorm(x, emb[p + "pre_layrnorm.weight"], emb[p + "pre_layrnorm.bias"], eps, mode)
    layers = vc["num_hidden_layers"] + 1 + cfg["mm_vision_select_layer"]
    dh = d // heads
    for i in range(layers):
        w = make(f"vit.layer.{i}")
        q = f"{p}encoder.layers.{i}."
        h = _layernorm(x, w[q + "layer_norm1.weight"], w[q + "layer_norm1.bias"], eps, mode)

        def proj(name, t=h):
            return _linear(t, w[f"{q}self_attn.{name}_proj.weight"],
                           w[f"{q}self_attn.{name}_proj.bias"], mode)

        qh, kh, vh = (proj(t).view(n, -1, heads, dh).transpose(1, 2) for t in "qkv")
        s = (qh @ kh.transpose(-1, -2)) * dh ** -0.5
        o = (torch.softmax(s, -1) @ vh).transpose(1, 2).reshape(n, -1, d)
        x = x + proj("out", o)
        h = _layernorm(x, w[q + "layer_norm2.weight"], w[q + "layer_norm2.bias"], eps, mode)
        h = _linear(h, w[q + "mlp.fc1.weight"], w[q + "mlp.fc1.bias"], mode)
        h = h * torch.sigmoid(1.702 * h)                     # quick_gelu
        x = x + _linear(h, w[q + "mlp.fc2.weight"], w[q + "mlp.fc2.bias"], mode)
    x = x[:, 1:]
    pj = _f32(weights.make_group(weights.projector_groups(cfg)["projector"], seed, "projector",
                                 device, torch.bfloat16))
    x = F.gelu(_linear(x, pj["model.mm_projector.0.weight"], pj["model.mm_projector.0.bias"],
                       mode))
    return _linear(x, pj["model.mm_projector.2.weight"], pj["model.mm_projector.2.bias"], mode)


# --------------------------------------------------------------------------
# BERT (the tree's caption / question encoder), CLS or mean pooling
# --------------------------------------------------------------------------


def text_embedding(bc: dict, seed: int, tag: str, texts: Sequence[str], device,
                   mode: str = "f32", max_length: int = 256) -> torch.Tensor:
    """Texts -> [N, hidden] pooled f32. Tokens are the texts' UTF-8 bytes
    (the byte tokenizer the configuration states), at most `max_length`,
    padded to a multiple of 16 (at least 16) with a padding mask."""
    enc = [list(t.encode("utf-8"))[:max_length] for t in texts]
    s = max(16, max(len(e) for e in enc))
    s = -(-s // 16) * 16
    ids = torch.zeros(len(enc), s, dtype=torch.long, device=device)
    mask = torch.zeros(len(enc), s, device=device)
    for i, e in enumerate(enc):
        ids[i, :len(e)] = torch.tensor(e, dtype=torch.long)
        mask[i, :len(e)] = 1
    groups = weights.bert_groups(bc, tag)
    eps = float(bc["layer_norm_eps"])
    d, heads = bc["hidden_size"], bc["num_attention_heads"]
    dh = d // heads

    def make(t):
        return weights.make_group(groups[t], seed, t, device, torch.float32)

    e = make(f"{tag}.embed")
    x = (e["embeddings.word_embeddings.weight"][ids]
         + e["embeddings.position_embeddings.weight"][None, :s]
         + e["embeddings.token_type_embeddings.weight"][0][None, None])
    x = _layernorm(x, e["embeddings.LayerNorm.weight"], e["embeddings.LayerNorm.bias"], eps,
                   mode)
    neg = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9)
    n = len(enc)
    for i in range(bc["num_hidden_layers"]):
        w = make(f"{tag}.layer.{i}")
        p = f"encoder.layer.{i}."

        def lin(name, t):
            return _linear(t, w[p + name + ".weight"], w[p + name + ".bias"], mode)

        q, k, v = (lin("attention.self." + m, x).view(n, s, heads, dh).transpose(1, 2)
                   for m in ("query", "key", "value"))
        a = torch.softmax((q @ k.transpose(-1, -2)) * dh ** -0.5 + neg, -1)
        o = (a @ v).transpose(1, 2).reshape(n, s, d)
        x = _layernorm(x + lin("attention.output.dense", o),
                       w[p + "attention.output.LayerNorm.weight"],
                       w[p + "attention.output.LayerNorm.bias"], eps, mode)
        h = F.gelu(lin("intermediate.dense", x))
        x = _layernorm(x + lin("output.dense", h), w[p + "output.LayerNorm.weight"],
                       w[p + "output.LayerNorm.bias"], eps, mode)
    if bc["pooling"] == "cls":
        return x[:, 0]
    m = mask[:, :, None]
    return (x * m).sum(1) / m.sum(1).clamp_min(1e-9)


# --------------------------------------------------------------------------
# The decoder (Qwen2): prompt + served tokens -> logits at chosen rows
# --------------------------------------------------------------------------


def prompt_pieces(prompt: str) -> List[Optional[List[int]]]:
    """The prompt cut at each <image>: byte-token lists, with None where an
    image block goes."""
    out: List[Optional[List[int]]] = []
    for i, chunk in enumerate(prompt.split(IMAGE_TOKEN)):
        if i:
            out.append(None)
        if chunk:
            out.append(list(chunk.encode("utf-8")))
    return out


def _rmsnorm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE at positions 0..L-1; x [L, H, Dh]."""
    n, _, dh = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, device=x.device, dtype=torch.float64) / dh))
    ang = (torch.arange(n, device=x.device, dtype=torch.float64)[:, None] * inv)[:, None, :]
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _causal_attention(q, k, v, block: int = 2048) -> torch.Tensor:
    """q [L, Hq, Dh], k / v [L, Hkv, Dh] -> [L, Hq * Dh], exact softmax in
    f32, query blocks against their causal prefix."""
    n, hq, dh = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    out = torch.empty(n, hq, dh, device=q.device)
    scale = dh ** -0.5
    for j in range(hkv):
        kj, vj = k[:, j], v[:, j]
        for a in range(0, n, block):
            b = min(n, a + block)
            qb = q[a:b, j * g:(j + 1) * g].transpose(0, 1)          # [g, r, Dh]
            s = (qb @ kj[:b].t()) * scale                            # [g, r, b]
            r = torch.arange(a, b, device=q.device)[:, None]
            c = torch.arange(b, device=q.device)[None, :]
            s = s.masked_fill(c > r, float("-inf"))
            out[a:b, j * g:(j + 1) * g] = (torch.softmax(s, -1) @ vj[:b]).transpose(0, 1)
    return out.reshape(n, hq * dh)


class Decoder:
    """The Qwen2 decoder from the seed, one layer's weights at a time."""

    def __init__(self, cfg: dict, seed: int, device) -> None:
        self.cfg, self.seed, self.device = cfg, seed, device
        self.groups = weights.decoder_groups(cfg)
        self._table: Optional[torch.Tensor] = None

    def _group(self, tag: str) -> Dict[str, torch.Tensor]:
        return _f32(weights.make_group(self.groups[tag], self.seed, tag, self.device,
                                       torch.bfloat16))

    def embed(self, ids: Sequence[int]) -> torch.Tensor:
        if self._table is None:
            self._table = weights.make_group(
                self.groups["decoder.embed"], self.seed, "decoder.embed", self.device,
                torch.bfloat16)["model.embed_tokens.weight"]
        return self._table[torch.as_tensor(list(ids), dtype=torch.long,
                                           device=self.device)].float()

    def logits(self, embeds: torch.Tensor, rows: Tuple[int, int],
               modes: Sequence[Tuple[int, Optional[int]]]) -> List[torch.Tensor]:
        """embeds [L, D] f32 (prompt and served tokens) -> for each mode
        (weight_bits, kv_bits) the logits [rows[1] - rows[0], V] f32 at
        positions rows[0]..rows[1]-1."""
        c = self.cfg
        d, hq, hkv = c["hidden_size"], c["num_attention_heads"], c["num_key_value_heads"]
        dh, eps, theta = d // hq, float(c["rms_norm_eps"]), float(c["rope_theta"])
        xs = [embeds.clone() for _ in modes]
        for i in range(c["num_hidden_layers"]):
            raw = self._group(f"decoder.layer.{i}")
            p = f"model.layers.{i}."
            for m, (bits, kv_bits) in enumerate(modes):
                w = {k: (quant.weight(v, bits) if v.dim() == 2 else v) for k, v in raw.items()}
                x = xs[m]
                h = _rmsnorm(x, w[p + "input_layernorm.weight"], eps)

                def proj(name):
                    return _linear(h, w[f"{p}self_attn.{name}_proj.weight"],
                                   w[f"{p}self_attn.{name}_proj.bias"])

                q = _rope(proj("q").view(-1, hq, dh), theta)
                k = _rope(proj("k").view(-1, hkv, dh), theta)
                v = proj("v").view(-1, hkv, dh)
                k, v = quant.kv(k, kv_bits), quant.kv(v, kv_bits)
                x = x + _linear(_causal_attention(q, k, v), w[p + "self_attn.o_proj.weight"])
                del q, k, v
                for a in range(0, x.shape[0], 8192):
                    h = _rmsnorm(x[a:a + 8192], w[p + "post_attention_layernorm.weight"], eps)
                    up = F.silu(_linear(h, w[p + "mlp.gate_proj.weight"])) * _linear(
                        h, w[p + "mlp.up_proj.weight"])
                    x[a:a + 8192] += _linear(up, w[p + "mlp.down_proj.weight"])
                xs[m] = x
                del w
            del raw
        norm = self._group("decoder.norm")["model.norm.weight"]
        head = self._group("decoder.head")["lm_head.weight"]
        out = []
        for (bits, _), x in zip(modes, xs):
            h = _rmsnorm(x[rows[0]:rows[1]], norm, eps)
            # The head stays int8 under int4 weights, as the configuration serves it.
            out.append(_linear(h, quant.weight(head, 8 if bits < 16 else 16)))
        return out


def served_logit_gaps(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each served token's logit lies below the reference's best at
    its position: [T] f32, 0 where the token is the reference's argmax."""
    return ref.max(-1).values - ref.gather(-1, tokens[:, None].long())[:, 0]


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per leading row: ||got - ref|| / ||ref|| over the other dims."""
    got, ref = got.float().flatten(1), ref.float().flatten(1)
    return (got - ref).norm(dim=1) / ref.norm(dim=1).clamp_min(1e-30)
