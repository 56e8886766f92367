"""The port's sequence-parallel attention against the JAX package's, on the CPU.

Four gloo ranks (`tests/torch_parallel_ranks.sp_cases`, spawned once for
the module) each cut their shard of the same q / k / v and run ring,
zigzag, stripe and Ulysses attention at n = 2 (pairs of ranks) and n = 4,
causal and not, with and without GQA; ring with a ragged kv_length and an
explicit sm_scale; USP on the 2 x 2 grid. Each rank's output shard is held
within 2e-5 of the same shard of the JAX function's result on the CPU mesh
(`tests/test_ring_attention.py`, `tests/test_ulysses.py`), the varlen case
on each row's valid queries. The index helpers equal JAX's, sizes that do
not divide raise, and the K3 / K5 plain twins take `sm_scale` as JAX's
references do.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from streamchat_tpu.ops.attention import _attention_reference
from streamchat_tpu.parallel import make_mesh as j_make_mesh
from streamchat_tpu_torch.ops import attention
from streamchat_tpu_torch.ops import ring_attention as ring
from streamchat_tpu_torch.ops import ulysses
from tests import torch_parallel_ranks

# `streamchat_tpu.ops` re-exports functions that shadow these submodules.
jring = importlib.import_module("streamchat_tpu.ops.ring_attention")
julysses = importlib.import_module("streamchat_tpu.ops.ulysses")

ATOL = 2e-5
B, S, D = 2, 64, 16
CASES = {"mha": (4, 4), "gqa": (8, 2)}
LENGTHS = [40, 64]


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _qkv(h, hkv, seed):
    return _rand(seed, B, h, S, D), _rand(seed + 1, B, hkv, S, D), _rand(seed + 2, B, hkv, S, D)


@pytest.fixture(scope="module")
def inputs():
    cases = {name: _qkv(h, hkv, 10 * i) for i, (name, (h, hkv)) in enumerate(CASES.items())}
    return dict(cases=cases, varlen=_qkv(4, 4, 50))


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp_ranks")
    path = str(tmp / "inputs.pt")
    torch.save(dict(cases={k: tuple(map(torch.from_numpy, v)) for k, v in inputs["cases"].items()},
                    varlen=tuple(map(torch.from_numpy, inputs["varlen"])),
                    lengths=torch.tensor(LENGTHS, dtype=torch.int32)), path)
    return torch_parallel_ranks.spawn(torch_parallel_ranks.sp_cases, 4, tmp, path)


def _jax(op, n, q, k, v, **kw):
    """The JAX op over the model axis of a (8 / n, n) CPU mesh, jitted (an
    eager shard_map takes ~5x as long here)."""
    fn = {"ring": jring.ring_attention, "zigzag": jring.zigzag_ring_attention,
          "stripe": jring.stripe_ring_attention, "ulysses": julysses.ulysses_attention}[op]
    fn = jax.jit(functools.partial(fn, mesh=j_make_mesh(8 // n, n), axis_name="model", **kw))
    return np.asarray(fn(*map(jnp.asarray, (q, k, v))))


def _shards_match(ranks, key, want, n, layout="contiguous", rows=None):
    want = torch.from_numpy(np.array(want))
    for rank, r in enumerate(ranks):
        ref = ring.sequence_shard(want, rank % n if n == 2 else rank, n, layout)
        got = r[key]
        if rows is not None:        # varlen: each row's valid queries
            for b, n_valid in enumerate(rows):
                first = (rank % n if n == 2 else rank) * (S // n)
                keep = max(0, min(S // n, n_valid - first))
                np.testing.assert_allclose(got[b, :, :keep].numpy(), ref[b, :, :keep].numpy(),
                                           atol=ATOL, rtol=0)
        else:
            np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("op,layout", [("ring", "contiguous"), ("zigzag", "zigzag"),
                                       ("stripe", "stripe"), ("ulysses", "contiguous")])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_sp_op_matches_jax(ranks, inputs, op, layout, case, n, causal):
    q, k, v = inputs["cases"][case]
    h, hkv = CASES[case]
    key = (op, case, n, causal)
    if op == "ulysses" and (h % n or hkv % n):
        assert key not in ranks[0]
        with pytest.raises(ValueError):
            ulysses.check_heads(h, hkv, n)
        with pytest.raises(ValueError):
            _jax(op, n, q, k, v, causal=causal)
        return
    _shards_match(ranks, key, _jax(op, n, q, k, v, causal=causal), n, layout)


@pytest.mark.parametrize("n", [2, 4])
def test_ring_varlen_matches_jax(ranks, inputs, n):
    q, k, v = inputs["varlen"]
    want = _jax("ring", n, q, k, v, causal=True,
                kv_length=jnp.asarray(LENGTHS, jnp.int32))
    _shards_match(ranks, ("varlen", n), want, n, rows=LENGTHS)


@pytest.mark.parametrize("n", [2, 4])
def test_ring_sm_scale_matches_jax(ranks, inputs, n):
    q, k, v = inputs["cases"]["mha"]
    _shards_match(ranks, ("scaled", n), _jax("ring", n, q, k, v, causal=True, sm_scale=0.3), n)


@pytest.mark.parametrize("causal", [True, False])
def test_usp_matches_jax(ranks, inputs, causal):
    q, k, v = inputs["cases"]["mha"]
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    fn = jax.jit(functools.partial(julysses.usp_attention, mesh=mesh, ulysses_axis="model",
                                   ring_axis="data", causal=causal))
    want = np.asarray(fn(*map(jnp.asarray, (q, k, v))))
    _shards_match(ranks, ("usp", causal), want, 4)


@pytest.mark.parametrize("s,n", [(32, 4), (64, 2), (48, 3)])
def test_indices_match_jax_and_round_trip(s, n):
    for mine, theirs in ((ring.zigzag_indices, jring.zigzag_indices),
                         (ring.stripe_indices, jring.stripe_indices)):
        idx = mine(s, n)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(theirs(s, n)))
        inv = ring.inverse_permutation(idx)
        np.testing.assert_array_equal(inv.numpy(),
                                      np.asarray(jring._inverse_permutation(theirs(s, n))))
        assert torch.equal(idx[inv.long()], torch.arange(s, dtype=idx.dtype))


def test_sizes_that_do_not_divide_raise():
    x = torch.zeros(1, 2, 30, 8)
    with pytest.raises(ValueError):
        ring.sequence_shard(x, 0, 4)
    with pytest.raises(ValueError):
        ring.sequence_shard(torch.zeros(1, 2, 36, 8), 0, 4, "zigzag")
    with pytest.raises(ValueError):
        ring.zigzag_ring_attention(torch.zeros(1, 2, 9, 8), x, x, group=object())
    with pytest.raises(ValueError):
        ulysses.check_heads(6, 2, 4)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_sm_scale_matches_jax(causal):
    q, k, v = _qkv(8, 2, 70)
    want = _attention_reference(*map(jnp.asarray, (q, k, v)), causal=causal, sm_scale=0.3)
    got = attention.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                                    sm_scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    default = attention.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    assert not torch.allclose(got, default)


@pytest.mark.parametrize("q_off,k_off", [(0, 0), (64, 0), (0, 64), (20, 7)])
def test_flash_attention_partial_plain_sm_scale_matches_jax_block(q_off, k_off):
    """K5's twin against the JAX ring's plain block attention: acc / l and
    the rows without keys (l == 0 on both)."""
    q, k, v = _qkv(4, 2, 80)
    a_ref, m_ref, l_ref = jring._block_attn(*map(jnp.asarray, (q, k, v)), jnp.asarray(q_off),
                                            jnp.asarray(k_off), 0.3, True, use_flash=False)
    a, m, l = attention.flash_attention_partial(*map(torch.from_numpy, (q, k, v)), q_off, k_off,
                                                causal=True, neg_inf=ring.NEG_INF, sm_scale=0.3)
    l_ref, l = np.asarray(l_ref), l.numpy()
    np.testing.assert_array_equal(l == 0, l_ref == 0)
    np.testing.assert_allclose(a.numpy() / np.where(l == 0, 1, l)[..., None],
                               np.asarray(a_ref) / np.where(l_ref == 0, 1, l_ref)[..., None],
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_ref), rtol=1e-5, atol=1e-5)
