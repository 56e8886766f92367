"""The hand-written CUDA kernels against their plain PyTorch twins, on the card.

Every test here carries the `cuda` marker and skips where there is no CUDA
device (the kernels have no CPU mode; on the CPU the wrappers run the twins,
which tests/test_torch_ops.py holds to the JAX package). The file imports
neither jax nor the JAX package, so it runs on a GPU machine without jax:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(`--noconftest` skips tests/conftest.py, which sets up jax.) Tolerance:
|kernel - plain| <= 3e-2 + 2e-2 |plain|, bf16 storage with f32
accumulation in both, summed in a different order.
"""

import numpy as np
import pytest
import torch

from streamchat_tpu_torch import kernels
from streamchat_tpu_torch.ops import attention, fused_vit, paged_attention

ATOL, RTOL = 3e-2, 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    kernels.reset_launch_counts()
    return torch.device("cuda")


def _bf(seed, dev, *shape, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.from_numpy(x.astype(np.float32)).to(dev, torch.bfloat16)


def _close(got, ref):
    torch.testing.assert_close(got.float(), ref.float(), atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
def test_cuda_vit_layer_and_mlp(cuda):
    d, f = 128, 256
    ln1_s, ln1_b = 1 + _bf(1, cuda, d, scale=0.1), _bf(2, cuda, d, scale=0.1)
    wqkv, bqkv = _bf(3, cuda, d, 3 * d, scale=d ** -0.5), _bf(4, cuda, 3 * d, scale=0.1)
    wo, bo = _bf(5, cuda, d, d, scale=d ** -0.5), _bf(6, cuda, d, scale=0.1)
    ln2_s, ln2_b = 1 + _bf(7, cuda, d, scale=0.1), _bf(8, cuda, d, scale=0.1)
    w1, b1 = _bf(9, cuda, d, f, scale=d ** -0.5), _bf(10, cuda, f, scale=0.1)
    w2, b2 = _bf(11, cuda, f, d, scale=f ** -0.5), _bf(12, cuda, d, scale=0.1)
    args = (ln1_s, ln1_b, wqkv, bqkv, wo, bo, ln2_s, ln2_b, w1, b1, w2, b2)
    x = _bf(13, cuda, 2, 33, d)           # 66 rows: a ragged GEMM edge
    _close(fused_vit.fused_vit_layer(x, *args, num_heads=2),
           fused_vit.fused_vit_layer_plain(x, *args, num_heads=2))
    flat = x.reshape(-1, d)
    mlp = (ln2_s, ln2_b, w1, b1, w2, b2)
    for act in ("quick_gelu", "gelu", "none"):
        _close(fused_vit.fused_ln_mlp(flat, *mlp, activation=act),
               fused_vit.fused_ln_mlp_plain(flat, *mlp, activation=act))
    kw = dict(activation="gelu", layernorm=False, residual=False)
    _close(fused_vit.fused_ln_mlp(flat, None, None, w1, b1, w2, b2, **kw),
           fused_vit.fused_ln_mlp_plain(flat, None, None, w1, b1, w2, b2, **kw))
    assert fused_vit.fused_vit_layer.launches == 1
    assert fused_vit.fused_ln_mlp.launches == 4


@pytest.mark.cuda
@pytest.mark.parametrize("d,causal,kv", [
    (64, True, None),
    (64, False, (0, 70)),           # row 0 sees no key -> 0
    (128, True, (37, 100)),         # the decoder's head dim, ragged lengths
])
def test_cuda_flash_attention(cuda, d, causal, kv):
    q = _bf(1, cuda, 2, 4, 100, d)
    k, v = _bf(2, cuda, 2, 2, 100, d), _bf(3, cuda, 2, 2, 100, d)
    kl = None if kv is None else torch.tensor(kv, dtype=torch.int32, device=cuda)
    _close(attention.flash_attention(q, k, v, kl, causal=causal),
           attention.flash_attention_plain(q, k, v, kl, causal=causal))
    assert attention.flash_attention.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("b,lengths,pages", [(2, (1000, 3), 18), (1, (2049,), 17)])
def test_cuda_paged_decode(cuda, b, lengths, pages):
    q = _bf(1, cuda, b, 8, 1, 128)
    kp, vp = _bf(2, cuda, pages, 2, 128, 128), _bf(3, cuda, pages, 2, 128, 128)
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    _close(paged_attention.paged_decode_attention_seq(q, kp, vp, ln),
           paged_attention.paged_decode_attention_seq_plain(q, kp, vp, ln))
    assert paged_attention.paged_decode_attention_seq.launches == 1
