"""The port's kernel wrappers against the JAX package's kernels.

On a CPU tensor each wrapper runs its plain PyTorch twin; these tests hold
the twins to the JAX Pallas kernels run in interpret mode (and to the JAX
package's XLA references) on the same numpy inputs, in float32, atol 2e-5.
The hand-written kernels are held to the same twins on the card by
`tests/test_torch_cuda.py`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamchat_tpu.config import ViTConfig
from streamchat_tpu.models import vit as jvit
from streamchat_tpu.models.paged_kv import paged_decode_attention as j_paged_gather
from streamchat_tpu.ops import fused_vit as jfv
from streamchat_tpu.ops.attention import decode_attention as j_decode
from streamchat_tpu.ops.attention import flash_attention as j_flash
from streamchat_tpu.ops.paged_attention import paged_decode_attention_pallas_seq as j_seq
from streamchat_tpu.ops.sampling import sample_token as j_sample
from streamchat_tpu_torch import kernels
from streamchat_tpu_torch.ops import attention, fused_vit, paged_attention, sampling

ATOL = 2e-5


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _vit_layer_weights(d, f, seed=0):
    r = lambda i, *s, scale=1.0: _rand(seed * 100 + i, *s, scale=scale)  # noqa: E731
    return dict(
        ln1_scale=1 + r(1, d, scale=0.1), ln1_bias=r(2, d, scale=0.1),
        wqkv=r(3, d, 3 * d, scale=d ** -0.5), bqkv=r(4, 3 * d, scale=0.1),
        wo=r(5, d, d, scale=d ** -0.5), bo=r(6, d, scale=0.1),
        ln2_scale=1 + r(7, d, scale=0.1), ln2_bias=r(8, d, scale=0.1),
        w1=r(9, d, f, scale=d ** -0.5), b1=r(10, f, scale=0.1),
        w2=r(11, f, d, scale=f ** -0.5), b2=r(12, d, scale=0.1))


_K1_ORDER = ("ln1_scale", "ln1_bias", "wqkv", "bqkv", "wo", "bo", "ln2_scale",
             "ln2_bias", "w1", "b1", "w2", "b2")


@pytest.fixture
def no_launches():
    kernels.reset_launch_counts()
    yield
    assert all(v == 0 for v in kernels.launch_counts().values()), \
        "a CPU tensor must run the plain twin, never count a launch"


@pytest.mark.parametrize("n,heads", [(3, 4), (2, 2)])
def test_vit_layer_matches_jax_kernel_and_block(no_launches, n, heads):
    cfg = dataclasses.replace(ViTConfig.tiny(), num_heads=heads)
    d, f, s = cfg.hidden_size, cfg.intermediate_size, cfg.num_patches + 1
    w = _vit_layer_weights(d, f, seed=n)
    x = _rand(7, n, s, d)
    args = [w[k] for k in _K1_ORDER]
    ref_kernel = jfv.fused_vit_layer(
        jnp.asarray(x), *map(jnp.asarray, args), num_heads=heads,
        eps=cfg.layernorm_eps, frame_tile=1, softmax_mode="exact", folded=False,
        interpret=True)
    split = np.split(w["wqkv"], 3, axis=1)
    bsplit = np.split(w["bqkv"], 3)
    lp = {
        "ln1": {"scale": w["ln1_scale"], "bias": w["ln1_bias"]},
        "attn": {**{n_: {"w": split[i], "b": bsplit[i]} for i, n_ in enumerate("qkv")},
                 "o": {"w": w["wo"], "b": w["bo"]}},
        "ln2": {"scale": w["ln2_scale"], "bias": w["ln2_bias"]},
        "mlp": {"fc1": {"w": w["w1"], "b": w["b1"]}, "fc2": {"w": w["w2"], "b": w["b2"]}},
    }
    ref_block = jvit._block(jnp.asarray(x), jax.tree.map(jnp.asarray, lp), cfg)
    out = fused_vit.fused_vit_layer(torch.from_numpy(x), *map(torch.from_numpy, args),
                                    num_heads=heads, eps=cfg.layernorm_eps, frame_tile=1,
                                    softmax_mode="exact")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_kernel), atol=ATOL, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_block), atol=ATOL, rtol=0)


@pytest.mark.parametrize("activation", ["quick_gelu", "gelu", "none"])
@pytest.mark.parametrize("layernorm", [True, False])
@pytest.mark.parametrize("residual", [True, False])
def test_ln_mlp_matches_jax_kernel(no_launches, activation, layernorm, residual):
    t, din, dmid = 40, 32, 64
    x = _rand(1, t, din)
    ln_s, ln_b = 1 + _rand(2, din, scale=0.1), _rand(3, din, scale=0.1)
    w1, b1 = _rand(4, din, dmid, scale=din ** -0.5), _rand(5, dmid, scale=0.1)
    w2, b2 = _rand(6, dmid, din, scale=dmid ** -0.5), _rand(7, din, scale=0.1)
    ref = jfv.fused_ln_mlp(
        *map(jnp.asarray, (x, ln_s, ln_b, w1, b1, w2, b2)), activation=activation,
        layernorm=layernorm, residual=residual, token_tile=16, interpret=True)
    ts = list(map(torch.from_numpy, (x, ln_s, ln_b, w1, b1, w2, b2)))
    if not layernorm:
        ts[1] = ts[2] = None
    out = fused_vit.fused_ln_mlp(*ts, activation=activation, layernorm=layernorm,
                                 residual=residual)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,kv_length", [
    (2, 4, 2, 200, 32, True, None),            # causal GQA, ragged S
    (1, 2, 2, 130, 16, False, None),           # non-causal (the ViT's form)
    (2, 4, 2, 200, 32, True, (150, 90)),       # kv_length < S
    (2, 2, 2, 100, 16, False, (0, 77)),        # row 0 sees no key -> 0
    (1, 7, 1, (128, 384), 32, False, (291,)),  # Sq 128 vs Sk 384, 7 heads a kv head
])
def test_flash_attention_matches_jax_kernel(no_launches, b, hq, hkv, s, d, causal,
                                            kv_length):
    sq, sk = s if isinstance(s, tuple) else (s, s)
    q, k, v = _rand(1, b, hq, sq, d), _rand(2, b, hkv, sk, d), _rand(3, b, hkv, sk, d)
    kl = None if kv_length is None else np.asarray(kv_length, np.int32)
    ref = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  None if kl is None else jnp.asarray(kl), causal=causal,
                  block_q=128, block_k=128, interpret=True)
    out = attention.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if kl is None else torch.from_numpy(kl), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    if kv_length is not None and kv_length[0] == 0:
        assert not out[0].abs().any()


@pytest.mark.parametrize("b,lengths,pages", [(1, (61,), 5), (2, (37, 64), 8)])
def test_paged_decode_matches_jax_kernel_and_gather(no_launches, b, lengths, pages):
    hq, hkv, ps, d = 4, 2, 16, 32
    q = _rand(1, b, hq, 1, d)
    kp, vp = _rand(2, pages, hkv, ps, d), _rand(3, pages, hkv, ps, d)
    ln = np.asarray(lengths, np.int32)
    ref = j_seq(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(ln),
                pages_per_block=2, interpret=True)
    row = pages // b
    table = np.arange(pages, dtype=np.int32).reshape(b, row)
    ref_gather = j_paged_gather(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                jnp.asarray(table), jnp.asarray(ln))
    out = paged_attention.paged_decode_attention_seq(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(ln))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_gather), atol=ATOL, rtol=0)


@pytest.mark.parametrize("lengths", [(9, 40), (1, 1)])
def test_decode_attention_matches_jax(lengths):
    q, k, v = _rand(1, 2, 4, 1, 16), _rand(2, 2, 2, 40, 16), _rand(3, 2, 2, 40, 16)
    ln = np.asarray(lengths, np.int32)
    ref = j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ln))
    out = attention.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), torch.from_numpy(ln))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_greedy_sampling_matches_jax():
    logits = _rand(1, 3, 50)
    ref = j_sample(jnp.asarray(logits), jax.random.key(0), temperature=0.0)
    out = sampling.sample_token(torch.from_numpy(logits), temperature=0.0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_top_p_keeps_the_nucleus():
    logits = torch.tensor([[4.0, 3.0, 0.0, -1.0, -5.0]])
    kept = sampling.top_p_filter(logits, 0.9)
    probs = torch.softmax(logits, -1)[0]
    # smallest sorted prefix whose mass reaches 0.9 (the first is always kept)
    n = int((torch.cumsum(probs, 0) - probs < 0.9).sum())
    assert torch.isfinite(kept[0, :n]).all() and torch.isinf(kept[0, n:]).all()
    g = torch.Generator().manual_seed(0)
    draws = {int(sampling.sample_token(logits, g, temperature=1.0, top_p=0.9)[0])
             for _ in range(50)}
    assert draws <= set(range(n))

