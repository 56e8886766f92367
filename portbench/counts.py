"""The yardstick's arithmetic: operations and bytes that the work needs,
counted from shapes (not from what a kernel happens to read), and the
published peaks of one NVIDIA H100 SXM (dense, no sparsity; 700 W).

A step's least time is the larger of its operations at the bf16 tensor-core
peak and its bytes at the memory rate. Bytes count each input read once
and each output written once; weights are counted as the configuration
stores them (bf16, int8 + f32 scale per output channel, or int4 + f32
scale per group of 128 inputs).
"""

from __future__ import annotations

from typing import List, Tuple

PEAK_FLOPS = 989e12      # bf16 dense tensor-core FLOP/s
PEAK_BYTES = 3.35e12     # HBM3 bytes/s
GROUP = 128


def least_time(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def _dims(cfg: dict):
    d, hq, hkv = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    return d, hq, hkv, d // hq, cfg["intermediate_size"], cfg["num_hidden_layers"], \
        cfg["vocab_size"]


def layer_linears(cfg: dict) -> List[Tuple[int, int]]:
    """(in, out) of one decoder layer's projections: q, k, v, o, gate, up, down."""
    d, hq, hkv, dh, f, _, _ = _dims(cfg)
    return [(d, hq * dh), (d, hkv * dh), (d, hkv * dh), (hq * dh, d), (d, f), (d, f), (f, d)]


def weight_bytes(kin: int, kout: int, bits: int) -> int:
    """Stored bytes of a [in, out] weight at `bits` (16, 8 or 4)."""
    if bits == 16:
        return 2 * kin * kout
    if bits == 8:
        return kin * kout + 4 * kout
    if bits == 4:
        return kin * kout // 2 + 4 * kout * (kin // GROUP)
    raise ValueError(bits)


def head_bits(bits: int) -> int:
    """The head is int8 under int4 weights, as the configuration serves it."""
    return 16 if bits == 16 else 8


def linear_params(cfg: dict, head: bool = True) -> int:
    _, _, _, _, _, layers, v = _dims(cfg)
    n = layers * sum(i * o for i, o in layer_linears(cfg))
    return n + (cfg["hidden_size"] * v if head else 0)


def decode_linear_bytes(cfg: dict, bits: int, rows: int = 1) -> int:
    """Bytes one decode step's projections and head need at `rows` rows:
    the stored weights and scales, the q/k/v biases, each distinct input
    vector read once (attention input, o's input, the MLP input, down's
    input, the head's input) and each output written once (bf16; the head's
    logits f32)."""
    d, hq, hkv, dh, f, layers, v = _dims(cfg)
    per_layer = sum(weight_bytes(i, o, bits) for i, o in layer_linears(cfg))
    per_layer += 2 * (hq * dh + 2 * hkv * dh)                        # q, k, v biases
    per_layer += rows * 2 * (d + hq * dh + d + f)                     # inputs
    per_layer += rows * 2 * sum(o for _, o in layer_linears(cfg))    # outputs
    head = weight_bytes(d, v, head_bits(bits)) + rows * (2 * d + 4 * v)
    return layers * per_layer + head


def head_bytes(cfg: dict, bits: int, rows: int = 1) -> int:
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    return weight_bytes(d, v, head_bits(bits)) + rows * (2 * d + 4 * v)


def kv_token_bytes(cfg: dict, kv_int8: bool) -> int:
    """KV bytes of one token over all layers (int8: values + f32 scale per
    head and tensor)."""
    _, _, hkv, dh, _, layers, _ = _dims(cfg)
    row = dh + 4 if kv_int8 else 2 * dh
    return layers * hkv * 2 * row


def attention_flops(cfg: dict, q_len: int, kv_before: int) -> int:
    """Causal attention of q_len new queries after kv_before cached tokens:
    QK^T and PV, 2 FLOPs a multiply-add, over every query head and layer."""
    _, hq, _, dh, _, layers, _ = _dims(cfg)
    pairs = q_len * kv_before + q_len * (q_len + 1) // 2
    return layers * hq * 4 * dh * pairs


def decode_step(cfg: dict, bits: int, kv_int8: bool, context: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one decode step (one row) that attends `context`
    tokens, its own included."""
    flops = 2 * linear_params(cfg) + attention_flops(cfg, 1, context - 1)
    nbytes = (decode_linear_bytes(cfg, bits) + kv_token_bytes(cfg, kv_int8) * context
              + 2 * cfg["hidden_size"])
    return flops, nbytes


def prefill(cfg: dict, bits: int, kv_int8: bool, length: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of a prefill of `length` tokens: every projection at
    every row, the head at the last row, causal attention; the weights read
    once, the prompt's embeddings read and its KV written."""
    d = cfg["hidden_size"]
    flops = 2 * linear_params(cfg, head=False) * length + 2 * d * cfg["vocab_size"] \
        + attention_flops(cfg, length, 0)
    layers = cfg["num_hidden_layers"]
    w = layers * sum(weight_bytes(i, o, bits) for i, o in layer_linears(cfg))
    nbytes = w + head_bytes(cfg, bits) + 2 * d * length + kv_token_bytes(cfg, kv_int8) * length
    return flops, nbytes


def vit_batch(cfg: dict, frames: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of encoding `frames` frames: patch embedding, the
    blocks up to the selected layer, the projector; the bf16 weights read
    once, f32 pixels read and bf16 features written."""
    vc = cfg["vision_config"]
    dv, fv, ps, size = vc["hidden_size"], vc["intermediate_size"], vc["patch_size"], \
        vc["image_size"]
    p = (size // ps) ** 2
    n = p + 1
    blocks = vc["num_hidden_layers"] + 1 + cfg["mm_vision_select_layer"]
    d = cfg["hidden_size"]
    patch = 3 * ps * ps
    per_frame = (2 * p * patch * dv
                 + blocks * (2 * n * (4 * dv * dv + 2 * dv * fv) + 4 * n * n * dv)
                 + 2 * p * (dv * d + d * d))
    w = 2 * (patch * dv + blocks * (4 * dv * dv + 2 * dv * fv) + dv * d + d * d)
    nbytes = w + frames * (4 * 3 * size * size + 2 * p * d)
    return frames * per_frame, nbytes
