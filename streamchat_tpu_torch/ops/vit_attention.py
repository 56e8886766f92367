"""Non-causal attention for the ViT's shape regime (K14), with its plain twin
(`streamchat_tpu/ops/vit_attention.py`).

q [N, H, Sq, D] against k / v [N, H, Sk, D] (Sq = Sk = S in the ViT: 577
tokens, 16 heads of 64), every key valid. The TPU kernel padded S to the
128 tile and masked the pad; `csrc/flash_prefill.cu` masks the ragged last
tiles itself and its TMA maps give zeros past each image's S, so nothing is
padded here. A CUDA tensor launches `sc_vit_attention` (the wgmma / TMA
loop K3 runs, causal off, one kv head per query head, the exact softmax;
K1's attention is the same loop in the clamp mode); a CPU tensor runs
`vit_attention_plain`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from streamchat_tpu_torch.kernels import counted, launched
from streamchat_tpu_torch.ops.attention import _strides


def vit_attention_plain(q, k, v, *, sm_scale: float | None = None, block_n: int = 4):
    """Plain PyTorch twin of `vit_attention` (same signature): scores in f32,
    max-subtracted softmax, probabilities normalized and rounded to v's
    dtype before the product with v, as the TPU kernel does."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = (q.float() @ k.float().transpose(-1, -2)) * sm_scale
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = (p / p.sum(-1, keepdim=True)).to(v.dtype)
    return (p.float() @ v.float()).to(q.dtype)


@counted
def vit_attention(q, k, v, *, sm_scale: float | None = None, block_n: int = 4):
    """softmax(q k^T * sm_scale) v (K14), sm_scale defaulting to D^-0.5 ->
    [N, H, Sq, D] in q's dtype. `block_n` is the TPU kernel's image tile and
    has no effect here. CPU tensors run the plain twin; CUDA tensors launch
    the kernel (bf16, head dim 64 or 128, the last dim contiguous) or raise.
    """
    if q.device.type == "cpu":
        return vit_attention_plain(q, k, v, sm_scale=sm_scale, block_n=block_n)
    from streamchat_tpu_torch.kernels.build import call

    n, h, sq, d = q.shape
    sk = k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.dtype != torch.bfloat16:
            raise ValueError(f"vit_attention {name}: expected CUDA bf16, got "
                             f"{t.device} {t.dtype}")
    if d not in (64, 128) or tuple(k.shape) != (n, h, sk, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"vit_attention: unsupported shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    qs, ks, vs = ((ctypes.c_int64 * 3)(*_strides(t, name))
                  for t, name in ((q, "q"), (k, "k"), (v, "v")))
    out = torch.empty(n, h, sq, d, dtype=q.dtype, device=q.device)
    call("sc_vit_attention", q.data_ptr(), qs, k.data_ptr(), ks, v.data_ptr(), vs,
         out.data_ptr(), n, h, sq, sk, d, float(sm_scale),
         torch.cuda.current_stream().cuda_stream)
    launched(vit_attention)
    return out
