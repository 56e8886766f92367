"""CLIP vision tower (`streamchat_tpu/models/vit.py`).

ViT-L/14-336: patch embedding as unfold + one matmul, CLS + position
embeddings, pre-LN, then `num_layers + 1 + select_layer` blocks (23 of 24
for select_layer -2), CLS dropped -> [N, 576, 1024]. Every block runs
through the K1 kernel wrapper `ops.fused_vit.fused_vit_layer` (its plain
twin on CPU tensors), in one of the JAX package's two forms:

* fused (`_block_fused`, the default for weights on the card, as the JAX
  package's default on its chip): the layer's weights folded once
  (`fold_params`: both LN affines and the q scale in wqkv / fc1, kept under
  a per-layer "fused" key), one-pass LN statistics and the clamp softmax,
  exact for attention logits in (-87, 80] (`attention_logit_bounds` checks
  a checkpoint);
* unfused (`_block`, `fused=False`, the default on the CPU): HF-layout
  weights, two-pass LN and the exact softmax, the JAX XLA block's function.

Parameter layout is the JAX package's HF-style tree except that each layer
keeps the merged q|k|v projection the kernel reads (`attn.wqkv` [D, 3D],
`attn.bqkv` [3D]): the concatenation is done once, when the weights are
built or converted, never per forward.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from streamchat_tpu_torch.config import ViTConfig
from streamchat_tpu_torch.ops.fused_vit import fold_vit_layer_params, fused_vit_layer

Params = Dict[str, Any]


def _layernorm(x, scale, bias, eps):
    y = torch.nn.functional.layer_norm(x.float(), (x.shape[-1],), scale.float(),
                                       bias.float(), eps)
    return y.to(x.dtype)


def init(cfg: ViTConfig, generator: torch.Generator, *, device="cpu",
         dtype=torch.bfloat16) -> Params:
    """Random parameters at the exact CLIP geometry of `cfg`."""

    def normal(*shape, scale):
        t = torch.randn(*shape, generator=generator, device=device)
        return (t * scale).to(dtype)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=device)

    def ln():
        return {"scale": torch.ones(cfg.hidden_size, dtype=dtype, device=device),
                "bias": zeros(cfg.hidden_size)}

    d, f = cfg.hidden_size, cfg.intermediate_size
    patch_dim = 3 * cfg.patch_size * cfg.patch_size
    layers = []
    for _ in range(cfg.num_layers):
        layers.append({
            "ln1": ln(),
            "attn": {"wqkv": normal(d, 3 * d, scale=d ** -0.5), "bqkv": zeros(3 * d),
                     "o": {"w": normal(d, d, scale=d ** -0.5), "b": zeros(d)}},
            "ln2": ln(),
            "mlp": {"fc1": {"w": normal(d, f, scale=d ** -0.5), "b": zeros(f)},
                    "fc2": {"w": normal(f, d, scale=f ** -0.5), "b": zeros(d)}},
        })
    return {
        "patch_embed": {"w": normal(patch_dim, d, scale=patch_dim ** -0.5)},
        "class_embed": normal(d, scale=0.02),
        "pos_embed": normal(cfg.num_patches + 1, d, scale=0.02),
        "pre_ln": ln(),
        "layers": layers,
    }


def _embed_patches(pixels: torch.Tensor, w: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """[N, 3, H, W] -> [N, P, hidden] via unfold + matmul (stride == kernel)."""
    n = pixels.shape[0]
    ps, g = cfg.patch_size, cfg.num_patches_per_side
    x = pixels.reshape(n, 3, g, ps, g, ps).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(n, g * g, 3 * ps * ps).to(w.dtype) @ w


def _block(x: torch.Tensor, p: Params, cfg: ViTConfig) -> torch.Tensor:
    """The unfused block: HF-layout weights, two-pass LN, exact softmax."""
    return fused_vit_layer(
        x, p["ln1"]["scale"], p["ln1"]["bias"], p["attn"]["wqkv"], p["attn"]["bqkv"],
        p["attn"]["o"]["w"], p["attn"]["o"]["b"], p["ln2"]["scale"], p["ln2"]["bias"],
        p["mlp"]["fc1"]["w"], p["mlp"]["fc1"]["b"], p["mlp"]["fc2"]["w"],
        p["mlp"]["fc2"]["b"], num_heads=cfg.num_heads, eps=cfg.layernorm_eps,
        frame_tile=1, softmax_mode="exact")


def _fold_layer(p: Params, cfg: ViTConfig) -> Params:
    """The LN-affine / q-scale fold of one layer -> {wqkv, bqkv, w1, b1}."""
    folded = fold_vit_layer_params(
        p["ln1"]["scale"], p["ln1"]["bias"], p["attn"]["wqkv"], p["attn"]["bqkv"],
        p["ln2"]["scale"], p["ln2"]["bias"], p["mlp"]["fc1"]["w"], p["mlp"]["fc1"]["b"],
        num_heads=cfg.num_heads)
    return dict(zip(("wqkv", "bqkv", "w1", "b1"), folded))


def fold_params(params: Params, cfg: ViTConfig) -> Params:
    """Attach each layer's folded projections under a per-layer "fused" key
    (~350 MB bf16 at ViT-L), so the fused block does not fold per call. The
    HF-layout leaves stay (the unfused path and `attention_logit_bounds`
    read them). Idempotent: returns `params` itself when every layer has
    the key."""
    if all("fused" in p for p in params["layers"]):
        return params
    layers = [p if "fused" in p else {**p, "fused": _fold_layer(p, cfg)}
              for p in params["layers"]]
    return {**params, "layers": layers}


def _frame_tile(n: int) -> int:
    """The TPU kernel's frame tile for N frames (4, 2 or 1); on the card it
    only has to divide N."""
    return 4 if n % 4 == 0 else 2 if n % 2 == 0 else 1


def _block_fused(x: torch.Tensor, p: Params, cfg: ViTConfig,
                 softmax_mode: str = "clamp") -> torch.Tensor:
    """The fused block: folded weights (the pre-folded "fused" key, else
    folded in the call), one-pass LN, `softmax_mode` softmax."""
    f = p.get("fused") or _fold_layer(p, cfg)
    return fused_vit_layer(
        x, p["ln1"]["scale"], p["ln1"]["bias"], f["wqkv"], f["bqkv"],
        p["attn"]["o"]["w"], p["attn"]["o"]["b"], p["ln2"]["scale"], p["ln2"]["bias"],
        f["w1"], f["b1"], p["mlp"]["fc2"]["w"], p["mlp"]["fc2"]["b"],
        num_heads=cfg.num_heads, eps=cfg.layernorm_eps, activation="quick_gelu",
        frame_tile=_frame_tile(x.shape[0]), softmax_mode=softmax_mode, folded=True,
        ln_onepass=True)


def _use_fused(fused: bool | None, device) -> bool:
    """Resolve the tri-state `fused` flag: None is True for tensors on the
    card and False on the CPU (the JAX package keeps XLA's ops on the CPU,
    and its single-device test for the fused path comes back with sharded
    ingest)."""
    if fused is not None:
        return fused
    return torch.device(device).type == "cuda"


def _embedded(params: Params, pixels: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """Patch + CLS + position embeddings and the pre-LN -> [N, 1 + P, hidden]."""
    x = _embed_patches(pixels, params["patch_embed"]["w"], cfg)
    cls = params["class_embed"][None, None, :].expand(x.shape[0], 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"][None]
    return _layernorm(x, params["pre_ln"]["scale"], params["pre_ln"]["bias"],
                      cfg.layernorm_eps)


def _num_blocks(cfg: ViTConfig, select_layer: int | None) -> int:
    if select_layer is None:
        select_layer = cfg.select_layer
    return cfg.num_layers + 1 + select_layer if select_layer < 0 else select_layer


def hidden_states(params: Params, pixels: torch.Tensor, cfg: ViTConfig,
                  select_layer: int | None = None, fused: bool | None = None,
                  softmax_mode: str = "clamp") -> torch.Tensor:
    """Run the tower up to `select_layer` (default `cfg.select_layer`) ->
    [N, 1 + P, hidden]. `fused` None picks the fused block on the card;
    `softmax_mode` ("clamp", or "exact") applies to the fused block."""
    use_fused = _use_fused(fused, params["patch_embed"]["w"].device)
    x = _embedded(params, pixels, cfg)
    for p in params["layers"][:_num_blocks(cfg, select_layer)]:
        x = x.contiguous()
        x = _block_fused(x, p, cfg, softmax_mode) if use_fused else _block(x, p, cfg)
    return x


def attention_logit_bounds(params: Params, pixels: torch.Tensor, cfg: ViTConfig,
                           select_layer: int | None = None) -> torch.Tensor:
    """Per-layer [min, max] attention logits (natural units) over a sample
    batch -> [L, 2] f32: the check of the clamp softmax, exact while every
    row's max logit stays in (-87, 80]. Plain torch with f32 scores, over
    the unfused block."""
    x = _embedded(params, pixels, cfg)
    bounds = []
    for p in params["layers"][:_num_blocks(cfg, select_layer)]:
        h = _layernorm(x, p["ln1"]["scale"], p["ln1"]["bias"], cfg.layernorm_eps)
        n, s, d = h.shape
        dh = d // cfg.num_heads
        qk = (h @ p["attn"]["wqkv"][:, :2 * d] + p["attn"]["bqkv"][:2 * d]).reshape(
            n, s, 2, cfg.num_heads, dh)
        q, k = qk.float().permute(2, 0, 3, 1, 4)
        scores = (q @ k.transpose(-1, -2)) * dh ** -0.5
        bounds.append(torch.stack([scores.min(), scores.max()]))
        x = _block(x.contiguous(), p, cfg)
    return torch.stack(bounds)


def encode(params: Params, pixels: torch.Tensor, cfg: ViTConfig,
           fused: bool | None = None) -> torch.Tensor:
    """Patch features [N, P, hidden]: hidden_states[select_layer] minus CLS."""
    return hidden_states(params, pixels, cfg, fused=fused)[:, 1:, :]


def s2_resize(pixels: torch.Tensor, size: int) -> torch.Tensor:
    """[N, 3, H, W] -> [N, 3, size, size] bicubic, as the JAX package's
    `jax.image.resize(..., "bicubic", antialias=False)` computes an upscale:
    Keys a = -0.5 with the taps past an edge dropped and the rest
    renormalized, which is torch's antialiased kernel (the plain one uses
    a = -0.75 and clamps the edges). In f32."""
    return torch.nn.functional.interpolate(pixels.float(), size=(size, size),
                                           mode="bicubic", align_corners=False,
                                           antialias=True)


def encode_s2(params: Params, pixels: torch.Tensor, cfg: ViTConfig,
              scales: tuple = (336, 672), fused: bool | None = None) -> torch.Tensor:
    """S2 multiscale features [N, P, hidden * len(scales)] of base-size
    pixels [N, 3, base, base] (`CLIPVisionTowerS2` with s2wrapper's
    multiscale_forward): per scale s, resize to s x s, cut into (s / base)^2
    base-size tiles, `encode` every tile (K1 on the card), reassemble each
    frame's tile grid, average-pool it ns x ns back to the base grid, and
    concatenate the scales along the channels, smallest first."""
    base, side = cfg.image_size, cfg.num_patches_per_side
    n = pixels.shape[0]
    outs = []
    for s in sorted(scales):
        ns = s // base
        if ns * base != s:
            raise ValueError(f"scale {s} not a multiple of base {base}")
        if ns == 1:
            outs.append(encode(params, pixels, cfg, fused=fused))
            continue
        big = s2_resize(pixels, s).to(pixels.dtype)
        tiles = big.reshape(n, 3, ns, base, ns, base).permute(0, 2, 4, 1, 3, 5)
        feats = encode(params, tiles.reshape(n * ns * ns, 3, base, base), cfg, fused=fused)
        d = feats.shape[-1]
        grid = feats.reshape(n, ns, ns, side, side, d).permute(0, 1, 3, 2, 4, 5)
        pooled = grid.reshape(n, side, ns, side, ns, d).mean(dim=(2, 4))
        outs.append(pooled.reshape(n, side * side, d))
    return torch.cat(outs, dim=-1)
