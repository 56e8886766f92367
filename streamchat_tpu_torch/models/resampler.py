"""Vision resamplers (`streamchat_tpu/models/resampler.py`).

The registry of the reference's `build_vision_resampler`: `identity`
(LongVA's shipped config), `spatial_pool` (ops/pooling) and `masked_drop`,
and the two parametric resamplers, random-initialized as in the JAX
package (no pretrained resampler ships with LongVA):

* Perceiver (the flamingo-pytorch design): learned latents cross-attend to
  [media | latents] for `depth` rounds, pre-LN, GELU FFN, final LN.
* Q-Former (BLIP-2's bert-base): learned query tokens through post-LN BERT
  blocks, with cross-attention to the LayerNormed vision features every
  `cross_freq` blocks and only the query FFN branch. `build_parametric`
  keeps the reference's quirk: `mm_qformer_depth` sets cross_freq, never
  the depth.

Plain PyTorch with f32 scores and LayerNorm statistics (float64 stays
float64, for a host reference): the JAX package computes them as XLA
code, with no Pallas kernel. Random draws come from a
`torch.Generator`; `masked_drop` also takes the permutation itself, so a
test can hold it to the JAX function's draw.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from streamchat_tpu_torch.ops.pooling import pool_patch_grid


def identity(features: torch.Tensor, *_, **__) -> torch.Tensor:
    return features


def spatial_pool(features: torch.Tensor, *_, stride: int = 2, mode: str = "average",
                 **__) -> torch.Tensor:
    """Pool the patch grid by `stride` along each side."""
    return pool_patch_grid(features, stride, mode=mode)


def masked_drop(features: torch.Tensor, generator: torch.Generator | None = None, *,
                ratio: float = 0.5, permutation: torch.Tensor | None = None,
                **_) -> torch.Tensor:
    """Keep a random (1 - ratio) subset of the patch tokens, one mask shared
    by every frame (the masked_drop resampler's 'random' mode), in token
    order. The subset is the first tokens of a random permutation of the P
    tokens (`generator`'s, or `permutation` where given)."""
    n, p, d = features.shape
    keep = max(1, int(round(p * (1.0 - ratio))))
    if permutation is None:
        permutation = torch.randperm(p, generator=generator, device=features.device)
    idx = torch.sort(permutation.to(features.device)[:keep]).values
    return features.index_select(1, idx)


REGISTRY = {
    "identity": identity,
    "spatial_pool": spatial_pool,
    "masked_drop": masked_drop,
}


def build(name: str | None) -> Callable:
    return REGISTRY[name or "identity"]


def _real(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float64 else x.float()


def _ln(x: torch.Tensor, p: dict, eps: float = 1e-5) -> torch.Tensor:
    x32 = _real(x)
    y = torch.nn.functional.layer_norm(x32, (x.shape[-1],), p["g"].to(x32.dtype),
                                       p["b"].to(x32.dtype), eps)
    return y.to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.gelu(_real(x)).to(x.dtype)


def _heads(t: torch.Tensor, h: int, dh: int) -> torch.Tensor:
    """[B, S, h * dh] -> [B, h, S, dh] in f32."""
    return _real(t.reshape(t.shape[0], t.shape[1], h, dh).transpose(1, 2))


def _merge(o: torch.Tensor) -> torch.Tensor:
    b, h, s, dh = o.shape
    return o.transpose(1, 2).reshape(b, s, h * dh)


def _normal(generator, shape, scale, device, dtype):
    return (torch.randn(*shape, generator=generator, device=device) * scale).to(dtype)


def init_perceiver(dim: int, generator: torch.Generator, *, depth: int = 6,
                   dim_head: int = 64, heads: int = 8, num_latents: int = 64,
                   ff_mult: int = 4, device="cpu", dtype=torch.float32) -> dict:
    inner = dim_head * heads

    def mat(kin, kout):
        return _normal(generator, (kin, kout), kin ** -0.5, device, dtype)

    def ln():
        return {"g": torch.ones(dim, device=device), "b": torch.zeros(dim, device=device)}

    layers = [{
        "norm_media": ln(), "norm_latents": ln(),
        "to_q": mat(dim, inner), "to_kv": mat(dim, inner * 2), "to_out": mat(inner, dim),
        "ff_norm": ln(), "ff_in": mat(dim, dim * ff_mult), "ff_out": mat(dim * ff_mult, dim),
    } for _ in range(depth)]
    return {"latents": _normal(generator, (num_latents, dim), 1.0, device, dtype),
            "layers": layers, "final_norm": ln(), "heads": heads, "dim_head": dim_head}


def apply_perceiver(params: dict, features: torch.Tensor) -> torch.Tensor:
    """[N, P, D] image features -> [N, num_latents, D]."""
    h, dh = int(params["heads"]), int(params["dim_head"])
    n = features.shape[0]
    lat = params["latents"][None].expand(n, -1, -1).to(features.dtype)

    def attn(p, x, latents):
        xn = _ln(x, p["norm_media"])
        ln_lat = _ln(latents, p["norm_latents"])
        q = (ln_lat @ p["to_q"]) * dh ** -0.5
        k, v = (torch.cat([xn, ln_lat], dim=1) @ p["to_kv"]).chunk(2, dim=-1)
        sim = _heads(q, h, dh) @ _heads(k, h, dh).transpose(-1, -2)
        a = torch.softmax(sim - sim.amax(dim=-1, keepdim=True), dim=-1)
        return _merge(a @ _heads(v, h, dh)).to(latents.dtype) @ p["to_out"]

    for p in params["layers"]:
        lat = attn(p, features, lat) + lat
        lat = _gelu(_ln(lat, p["ff_norm"]) @ p["ff_in"]) @ p["ff_out"] + lat
    return _ln(lat, params["final_norm"])


def init_qformer(vision_dim: int, generator: torch.Generator, *, hidden: int = 768,
                 num_layers: int = 12, heads: int = 12, intermediate: int = 3072,
                 num_queries: int = 32, cross_freq: int = 2, device="cpu",
                 dtype=torch.float32) -> dict:
    def lin(kin, kout):
        return {"w": _normal(generator, (kin, kout), 0.02, device, dtype),
                "b": torch.zeros(kout, device=device, dtype=dtype)}

    def ln(d=hidden):
        return {"g": torch.ones(d, device=device), "b": torch.zeros(d, device=device)}

    def attn(kv_dim):
        return {"q": lin(hidden, hidden), "k": lin(kv_dim, hidden), "v": lin(kv_dim, hidden),
                "o": lin(hidden, hidden), "ln": ln()}

    layers = []
    for i in range(num_layers):
        layer = {"self": attn(hidden), "ff_in": lin(hidden, intermediate),
                 "ff_out": lin(intermediate, hidden), "ff_ln": ln()}
        if i % cross_freq == 0:
            layer["cross"] = attn(vision_dim)    # K / V from the vision width
        layers.append(layer)
    return {"query_tokens": _normal(generator, (num_queries, hidden), 0.02, device, dtype),
            "ln_vision": ln(vision_dim), "layers": layers, "heads": heads}


def _bert_attn(q_in: torch.Tensor, kv_in: torch.Tensor, p: dict, heads: int) -> torch.Tensor:
    def lin(x, w):
        return x @ w["w"] + w["b"]

    q, k, v = lin(q_in, p["q"]), lin(kv_in, p["k"]), lin(kv_in, p["v"])
    dh = q.shape[-1] // heads
    s = (_heads(q, heads, dh) @ _heads(k, heads, dh).transpose(-1, -2)) * dh ** -0.5
    o = _merge(torch.softmax(s, dim=-1) @ _heads(v, heads, dh)).to(q_in.dtype)
    return _ln(q_in + lin(o, p["o"]), p["ln"], eps=1e-12)    # post-LN (BERT)


def apply_qformer(params: dict, features: torch.Tensor) -> torch.Tensor:
    """[N, P, Dv] image features -> [N, num_queries, hidden]: the query
    tokens self-attend (no text on this path) and, in the blocks with a
    cross branch, attend to the LayerNormed vision features."""
    heads = int(params["heads"])
    x = _ln(features, params["ln_vision"], eps=1e-12)
    h = params["query_tokens"][None].expand(features.shape[0], -1, -1).to(features.dtype)
    for p in params["layers"]:
        h = _bert_attn(h, h, p["self"], heads)
        if "cross" in p:
            h = _bert_attn(h, x, p["cross"], heads)
        ff = _gelu(h @ p["ff_in"]["w"] + p["ff_in"]["b"]) @ p["ff_out"]["w"] + p["ff_out"]["b"]
        h = _ln(h + ff, p["ff_ln"], eps=1e-12)
    return h


def build_parametric(name: str, vision_dim: int, generator: torch.Generator,
                     **kw) -> Tuple[dict, Callable]:
    """(params, apply) for the parametric resamplers, with the reference's
    model_args plumbing: `mm_perceiver_depth` / `_latents` / `_ff_mult`, and
    `mm_qformer_depth` feeding cross_freq (not the depth, which stays
    bert-base's 12) and `mm_qformer_latents` the query count."""
    if name == "perceiver":
        params = init_perceiver(
            vision_dim, generator, depth=kw.pop("mm_perceiver_depth", 6),
            num_latents=kw.pop("mm_perceiver_latents", 64),
            ff_mult=kw.pop("mm_perceiver_ff_mult", 4), **kw)
        return params, apply_perceiver
    if name == "qformer":
        params = init_qformer(
            vision_dim, generator, cross_freq=kw.pop("mm_qformer_depth", 2),
            num_queries=kw.pop("mm_qformer_latents", 32), **kw)
        return params, apply_qformer
    raise KeyError(f"unknown parametric resampler: {name}")
