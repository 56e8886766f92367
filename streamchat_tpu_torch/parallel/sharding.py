"""A rank's slice of a decoder tree (`streamchat_tpu/parallel/sharding.py`).

The JAX package gives every leaf a PartitionSpec (`decoder_pspecs`) and
lets XLA place it. The port cuts the same slices by hand, one rank's at a
time, Megatron-style:
- q / k / v (with their biases) and gate / up: by output column, so each
  rank holds whole heads and whole MLP columns;
- o and down: by input row, so each rank's product is a partial sum that
  the decoder all-reduces (`models/decoder.attn_out`, `mlp_out`);
- embed: by vocabulary row, lm_head by vocabulary column (the embedding and
  the logits are all-reduced from zeroed full-vocabulary buffers).
The norms are replicated. An int8 leaf's per-column scale goes with its
columns and stays whole under a row slice. An int4 leaf is packed two
columns to a byte, column j with column j + out/2 (`ops/quant.pack_int4`),
so a column slice is unpacked, cut and packed again, its [g, out] scales
cut with it; the codes then equal those of quantizing the sliced weight.
A row slice of an int4 leaf must fall on its 128-row groups (the JAX
package also accepts a cut inside a group, ROADMAP §C).

`rank_config` is the rank's `DecoderConfig`: num_heads, num_kv_heads and
intermediate_size divided by the model axis, head_dim and vocab_size as
they were (the logits come back whole). `shard_decoder` cuts a tree in
place and marks it with its `ModelGroup` under the key "tp", which the
decoder's hooks read.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from streamchat_tpu_torch.config import DecoderConfig
from streamchat_tpu_torch.ops.quant import is_quantized, pack_int4, unpack_int4
from streamchat_tpu_torch.parallel.mesh import ModelGroup

Params = Dict[str, Any]


def rank_config(cfg: DecoderConfig, tp: int) -> DecoderConfig:
    """`cfg` as one of `tp` ranks runs it; ValueError when the heads, the
    MLP width or the vocabulary do not divide."""
    for name in ("num_heads", "num_kv_heads", "intermediate_size", "vocab_size"):
        if getattr(cfg, name) % tp:
            raise ValueError(f"{name}={getattr(cfg, name)} does not divide over {tp} ranks")
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // tp,
                               num_kv_heads=cfg.num_kv_heads // tp,
                               intermediate_size=cfg.intermediate_size // tp)


def _part(n: int, mesh: ModelGroup) -> slice:
    w = n // mesh.size
    return slice(mesh.rank * w, (mesh.rank + 1) * w)


def _own(t: torch.Tensor) -> torch.Tensor:
    """A slice in storage of its own, so the whole leaf can be freed."""
    return t.contiguous().clone()


def _columns(p: Any, mesh: ModelGroup) -> Any:
    """The rank's output columns of a plain [in, out] matrix, a {"w"(,
    "b")} dict or an int8 / int4 dict (biases and scales cut with them)."""
    if isinstance(p, torch.Tensor):
        return _own(p[:, _part(p.shape[1], mesh)])
    out = {}
    if "w_i4p" in p:
        vals = unpack_int4(p["w_i4p"])                          # [in, out]
        cols = _part(vals.shape[1], mesh)
        g = p["scale"].shape[0]
        scale = p["scale"].reshape(g, -1)[:, cols]
        out["w_i4p"] = pack_int4(vals[:, cols])
        out["scale"] = _own(scale.reshape(g, 2, -1))
    elif "w_i8" in p:
        cols = _part(p["w_i8"].shape[1], mesh)
        out["w_i8"], out["scale"] = _own(p["w_i8"][:, cols]), _own(p["scale"][cols])
    else:
        cols = _part(p["w"].shape[1], mesh)
        out["w"] = _own(p["w"][:, cols])
    if "b" in p:
        out["b"] = _own(p["b"][cols])
    return out


def _rows(p: Any, mesh: ModelGroup) -> Any:
    """The rank's input rows of a row-parallel matrix (o, down); an int8
    scale stays whole, an int4 cut must fall on its 128-row groups."""
    if isinstance(p, torch.Tensor):
        return _own(p[_part(p.shape[0], mesh)])
    if "b" in p:
        raise ValueError("a row-parallel projection with a bias would add it once a rank")
    if "w_i4p" in p:
        kin = p["w_i4p"].shape[0]
        group = kin // p["scale"].shape[0]
        rows = _part(kin, mesh)
        if (kin // mesh.size) % group:
            raise ValueError(
                f"int4 row split of {kin} rows over {mesh.size} ranks gives {kin // mesh.size} "
                f"rows a rank, not a multiple of the {group}-row quantization group")
        groups = slice(rows.start // group, rows.stop // group)
        return {"w_i4p": _own(p["w_i4p"][rows]), "scale": _own(p["scale"][groups])}
    if "w_i8" in p:
        return {"w_i8": _own(p["w_i8"][_part(p["w_i8"].shape[0], mesh)]),
                "scale": p["scale"]}
    return {"w": _own(p["w"][_part(p["w"].shape[0], mesh)])}


def _vocab_rows(emb: Any, mesh: ModelGroup) -> Any:
    """The rank's rows of the token table (plain, or int8 rows + scales)."""
    if is_quantized(emb):
        rows = _part(emb["w_i8"].shape[0], mesh)
        return {"w_i8": _own(emb["w_i8"][rows]), "scale": _own(emb["scale"][rows])}
    return _own(emb[_part(emb.shape[0], mesh)])


def shard_decoder(params: Params, cfg: DecoderConfig,
                  mesh: ModelGroup) -> Tuple[Params, DecoderConfig]:
    """Cut `params` to this rank's slice IN PLACE (each whole leaf is
    dropped as its slice is made) -> (params, rank_config(cfg, mesh.size)).
    A group of one leaves both as they are."""
    if mesh.size == 1:
        return params, cfg
    if "tp" in params:
        raise ValueError("the decoder tree is already sharded")
    rcfg = rank_config(cfg, mesh.size)
    for i, p in enumerate(params["layers"]):
        attn, mlp = p["attn"], p["mlp"]
        params["layers"][i] = {
            "input_norm": p["input_norm"], "post_norm": p["post_norm"],
            "attn": {"q": _columns(attn["q"], mesh), "k": _columns(attn["k"], mesh),
                     "v": _columns(attn["v"], mesh), "o": _rows(attn["o"], mesh)},
            "mlp": {"gate": _columns(mlp["gate"], mesh), "up": _columns(mlp["up"], mesh),
                    "down": _rows(mlp["down"], mesh)},
        }
        del p, attn, mlp
    params["embed"] = _vocab_rows(params["embed"], mesh)
    if "lm_head" in params:
        params["lm_head"] = _columns(params["lm_head"], mesh)
    params["tp"] = mesh
    return params, rcfg
