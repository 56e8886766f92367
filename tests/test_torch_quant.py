"""The port's quantized decode against the JAX package's, on the CPU.

Inputs are numpy arrays made from a seed and handed to both packages.
Quantizers agree bit for bit (int8 values exactly, scales with rtol 0). The
kernel twins are held to the JAX Pallas kernels in interpret mode: the int4
GEMV twins (K10, K11) at atol 1e-4 in f32 (both sum per-group partials, in
another order), the int8-page decode twin (K6) at atol 2e-5 with f32
queries. The int8 / int4 matmuls match the JAX CPU path (f32: atol 1e-5;
bf16: one bf16 rounding, rtol 2^-7), and greedy generation is token-exact
under int8, int4 and int8 KV pages. On a CPU tensor no wrapper may count a
kernel launch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamchat_tpu import config as jconfig
from streamchat_tpu.models import decoder as jdec
from streamchat_tpu.models import paged_kv as jpkv
from streamchat_tpu.models.generate_paged import generate_paged_fetch
from streamchat_tpu.ops import int4_matmul as jint4
from streamchat_tpu.ops import quant as jquant
from streamchat_tpu.ops.paged_attention import paged_decode_attention_pallas_seq_int8
from streamchat_tpu_torch import config, convert, kernels
from streamchat_tpu_torch.models import decoder, paged_kv
from streamchat_tpu_torch.models.generate_paged import generate_paged
from streamchat_tpu_torch.ops import int4_matmul, paged_attention, quant

BF16_RTOL = 2.0 ** -7


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bf16_values(x):
    """f32 numpy values that bf16 represents exactly."""
    return torch.from_numpy(x).bfloat16().float().numpy()


@pytest.fixture
def no_launches():
    kernels.reset_launch_counts()
    yield
    assert all(v == 0 for v in kernels.launch_counts().values()), \
        "a CPU tensor must run the plain twin, never count a launch"


def _halfway_matrix(rows, cols, amax, seed):
    """Random weights whose first column's largest magnitude is `amax`, so
    its scale is 1.0 and entries at x.5 hit round-half-to-even."""
    w = _rand(seed, rows, cols, scale=0.3 * amax)
    w[:, 0] = 0.0
    w[:6, 0] = [amax, 2.5, -3.5, 0.5, 1.5, -0.5]
    w[:, 1] = 0.0                                    # an all-zero column: scale 1
    return w


@pytest.mark.parametrize("rows,cols", [(128, 64), (256, 34)])
def test_quantizers_bit_exact(rows, cols):
    w = _halfway_matrix(rows, cols, 127.0, seed=rows)
    ref, out = jquant.quantize_weight(jnp.asarray(w)), quant.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(out["w_i8"].numpy(), np.asarray(ref["w_i8"]))
    np.testing.assert_allclose(out["scale"].numpy(), np.asarray(ref["scale"]), rtol=0, atol=0)
    assert out["w_i8"][1:6, 0].tolist() == [2, -4, 0, 2, 0]

    w4 = _halfway_matrix(rows, cols, 7.0, seed=rows + 1)
    ref, out = (jquant.quantize_weight_int4(jnp.asarray(w4)),
                quant.quantize_weight_int4(torch.from_numpy(w4)))
    assert out["w_i4p"].dtype == torch.int8 and out["scale"].shape == (rows // 128, 2, cols // 2)
    np.testing.assert_array_equal(out["w_i4p"].numpy(), np.asarray(ref["w_i4p"]))
    np.testing.assert_allclose(out["scale"].numpy(), np.asarray(ref["scale"]), rtol=0, atol=0)
    np.testing.assert_array_equal(quant.unpack_int4(out["w_i4p"]).numpy(),
                                  np.asarray(jquant.unpack_int4(ref["w_i4p"])))
    np.testing.assert_allclose(quant.dequantize_weight_int4(out, torch.float32).numpy(),
                               np.asarray(jquant.dequantize_weight_int4(ref, jnp.float32)),
                               rtol=0, atol=0)

    ref, out = (jquant.quantize_embedding(jnp.asarray(w.T)),
                quant.quantize_embedding(torch.from_numpy(np.ascontiguousarray(w.T))))
    np.testing.assert_array_equal(out["w_i8"].numpy(), np.asarray(ref["w_i8"]))
    np.testing.assert_allclose(out["scale"].numpy(), np.asarray(ref["scale"]), rtol=0, atol=0)

    kv = _halfway_matrix(rows, cols, 127.0, seed=rows + 2).T.reshape(2, cols // 2, rows)
    (ref_v, ref_s), (vals, sc) = (jpkv._quantize_kv(jnp.asarray(kv)),
                                  paged_kv._quantize_kv(torch.from_numpy(kv)))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_v))
    np.testing.assert_allclose(sc.numpy(), np.asarray(ref_s), rtol=0, atol=0)


@pytest.mark.parametrize("bits", [8, 4])
def test_convert_keeps_quantized_dtypes(bits):
    """A quantized JAX tree (bf16 source) crosses with its int8 leaves as
    int8 and its f32 scales as f32, values unchanged; bf16 leaves become f32."""
    params = jdec.init(jax.random.key(1), jconfig.DecoderConfig.tiny(), jnp.bfloat16)
    jq = _np(jquant.quantize_decoder_params(params, bits=bits))
    tq = convert.to_torch(jq)
    flat_j, _ = jax.tree.flatten(jq)
    flat_t, _ = jax.tree.flatten(tq)
    assert len(flat_j) == len(flat_t)
    kinds = set()
    for a, t in zip(flat_j, flat_t):
        if a.dtype == np.int8:
            assert t.dtype == torch.int8
            np.testing.assert_array_equal(t.numpy(), a)
        elif a.dtype == np.float32:
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), a)
        else:
            assert a.dtype == jnp.bfloat16 and t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), a.astype(np.float32))
        kinds.add(str(a.dtype))
    assert {"int8", "float32", "bfloat16"} <= kinds
    layer = tq["layers"][0]
    key = "w_i4p" if bits == 4 else "w_i8"
    assert layer["attn"]["q"][key].dtype == torch.int8
    assert tq["lm_head"]["w_i8"].dtype == torch.int8      # the head stays int8


def _tol(dtype):
    return dict(atol=1e-5, rtol=1e-5) if dtype == "f32" else dict(atol=1e-3, rtol=BF16_RTOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_qmatmul_matches_jax_cpu_path(no_launches, dtype):
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16,
                                                                     torch.bfloat16)
    x = _bf16_values(_rand(1, 2, 3, 256, scale=0.5))
    w = _rand(2, 256, 384, scale=0.1)
    q8, q4 = jquant.quantize_weight(jnp.asarray(w)), jquant.quantize_weight_int4(jnp.asarray(w))
    t8, t4 = convert.to_torch(_np(q8)), convert.to_torch(_np(q4))
    xj, xt = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    for ref, out in ((jquant.qmatmul(xj, q8), quant.qmatmul(xt, t8)),
                     (jquant.qmatmul_int4(xj, q4), quant.qmatmul_int4(xt, t4)),
                     (jquant.matmul_any(xj, q8), quant.matmul_any(xt, t8))):
        assert out.dtype == tdt and out.shape == ref.shape
        np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                                   **_tol(dtype))
    w2 = _rand(3, 256, 128, scale=0.1)
    qs = [q4, jquant.quantize_weight_int4(jnp.asarray(w2))]
    refs = jquant.qmatmul_int4_multi(xj, qs)
    outs = quant.qmatmul_int4_multi(xt, [convert.to_torch(_np(q)) for q in qs])
    for ref, out in zip(refs, outs):
        np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                                   **_tol(dtype))


def _int4_parts(kin, widths, seed):
    parts = []
    for i, out in enumerate(widths):
        q = jquant.quantize_weight_int4(jnp.asarray(_rand(seed + i, kin, out, scale=0.1)))
        parts.append((q, convert.to_torch(_np(q))))
    return parts


@pytest.mark.parametrize("kin,out,bo,gpb", [
    (256, 256, 128, 1),      # exact blocks
    (384, 512, 128, 2),      # k edge (3 groups, gpb 2)
    (256, 768, 256, 2),      # j edge (oh = 384, bo = 256)
])
def test_int4_twin_matches_jax_kernel(no_launches, kin, out, bo, gpb):
    x = _bf16_values(_rand(kin, 3, kin, scale=0.5))
    (jq, tq), = _int4_parts(kin, (out,), seed=kin + out)
    ref = jint4.qmatvec_int4(jnp.asarray(x).astype(jnp.bfloat16), jq["w_i4p"], jq["scale"],
                             block_out=bo, groups_per_block=gpb, interpret=True)
    got = int4_matmul.qmatvec_int4(torch.from_numpy(x).bfloat16(), tq["w_i4p"], tq["scale"])
    assert got.dtype == torch.float32 and got.shape == (3, out)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    np.testing.assert_allclose(
        int4_matmul.qmatvec_int4_plain(torch.from_numpy(x), tq["w_i4p"], tq["scale"]).numpy(),
        np.asarray(ref), atol=1e-4, rtol=0)


def test_int4_fused_twin_matches_jax_kernel(no_launches):
    kin, widths = 384, (512, 128, 128)
    x = _bf16_values(_rand(5, 2, kin, scale=0.5))
    parts = _int4_parts(kin, widths, seed=20)
    jflat, tflat = [], []
    for jq, tq in parts:
        jflat += [jq["w_i4p"], jq["scale"]]
        tflat += [tq["w_i4p"], tq["scale"]]
    refs = jint4.qmatvec_int4_fused(jnp.asarray(x).astype(jnp.bfloat16), *jflat,
                                    block_out=128, groups_per_block=2, interpret=True)
    outs = int4_matmul.qmatvec_int4_fused(torch.from_numpy(x).bfloat16(), *tflat)
    assert len(outs) == len(widths)
    for ref, out, width in zip(refs, outs, widths):
        assert out.shape == (2, width)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def dcfg():
    return jconfig.DecoderConfig.tiny()


def _dense(cfg, lengths, lmax, seed):
    """A dense JAX KVCache holding random K/V at the given row lengths."""
    shape = (cfg.num_layers, len(lengths), cfg.num_kv_heads, lmax, cfg.head_dim)
    return jdec.KVCache(k=jnp.asarray(_rand(seed, *shape)), v=jnp.asarray(_rand(seed + 1, *shape)),
                        length=jnp.asarray(lengths, jnp.int32))


def _port_dense(jcache):
    return decoder.KVCache(k=torch.from_numpy(np.array(jcache.k)),
                           v=torch.from_numpy(np.array(jcache.v)),
                           length=torch.from_numpy(np.array(jcache.length)))


def test_int8_pages_twin_matches_jax_kernel_single_row(no_launches, dcfg):
    """B = 1: pages filled token by token by the JAX appender."""
    hkv, dh, ps, maxp, n = dcfg.num_kv_heads, dcfg.head_dim, 16, 4, 41
    shape = (dcfg.num_layers, maxp, hkv, ps, dh)
    cache = jpkv.PagedKVCacheInt8(
        k_pages=jnp.zeros(shape, jnp.int8), v_pages=jnp.zeros(shape, jnp.int8),
        k_scale=jnp.ones(shape[:4], jnp.float32), v_scale=jnp.ones(shape[:4], jnp.float32),
        page_table=jnp.full((1, maxp), -1, jnp.int32), length=jnp.zeros((1,), jnp.int32),
        next_free=jnp.zeros((), jnp.int32))
    for t in range(n):
        cache = jpkv.allocate_pages_int8(cache, jnp.ones((1,), jnp.int32))
        cache = jpkv.append_token_kv_int8(cache, jnp.asarray(0),
                                          jnp.asarray(_rand(500 + t, 1, hkv, dh)),
                                          jnp.asarray(_rand(600 + t, 1, hkv, dh)))
        cache = cache._replace(length=cache.length + 1)
    q = _rand(9, 1, dcfg.num_heads, 1, dh)
    length = np.asarray([n], np.int32)
    ref = paged_decode_attention_pallas_seq_int8(
        jnp.asarray(q), cache.k_pages[0], cache.v_pages[0], cache.k_scale[0],
        cache.v_scale[0], jnp.asarray(length), pages_per_block=2, interpret=True)
    args = [torch.from_numpy(np.array(a)) for a in (cache.k_pages[0], cache.v_pages[0],
                                                    cache.k_scale[0], cache.v_scale[0])]
    out = paged_attention.paged_decode_attention_seq_int8(torch.from_numpy(q), *args,
                                                          torch.from_numpy(length))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)
    table = paged_attention.paged_decode_attention_table_int8(
        torch.from_numpy(q), *args, torch.from_numpy(np.array(cache.page_table)),
        torch.from_numpy(length))
    np.testing.assert_allclose(table.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


def test_int8_pages_twin_matches_jax_kernel_partitioned(no_launches, dcfg):
    """B = 2 over a statically partitioned pool, with NaN and inf in the
    scales past each row's length (the twin must not let them through)."""
    lengths, lmax, ps, maxp = [37, 12], 64, 16, 4
    paged = jpkv.from_contiguous_int8(_dense(dcfg, lengths, lmax, seed=30), num_pages=2 * maxp,
                                      max_pages_per_seq=maxp, page_size=ps, partitioned=True)
    q = _rand(31, 2, dcfg.num_heads, 1, dcfg.head_dim)
    length = np.asarray(lengths, np.int32)
    ref = paged_decode_attention_pallas_seq_int8(
        jnp.asarray(q), paged.k_pages[0], paged.v_pages[0], paged.k_scale[0],
        paged.v_scale[0], jnp.asarray(length), pages_per_block=2, interpret=True)
    ks, vs = (np.array(paged.k_scale[0]), np.array(paged.v_scale[0]))
    for row, n in enumerate(lengths):
        for sc, bad in ((ks, np.nan), (vs, np.inf)):
            flat = sc[row * maxp:(row + 1) * maxp].transpose(1, 0, 2).reshape(-1, maxp * ps)
            flat[:, n:] = bad
            sc[row * maxp:(row + 1) * maxp] = flat.reshape(-1, maxp, ps).transpose(1, 0, 2)
    out = paged_attention.paged_decode_attention_seq_int8(
        torch.from_numpy(q), torch.from_numpy(np.array(paged.k_pages[0])),
        torch.from_numpy(np.array(paged.v_pages[0])), torch.from_numpy(ks),
        torch.from_numpy(vs), torch.from_numpy(length))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


def test_int8_paging_and_append_match_jax(dcfg):
    """Pages and scales equal JAX's exactly. The JAX paging runs with jit
    off: under jit XLA rewrites `amax / 127` as `amax * (1 / 127)`, which
    moves some scales by one ulp; the source (and the port) divide."""
    lengths, lmax, ps, maxp = [29], 32, 8, 5
    jdense = _dense(dcfg, lengths, lmax, seed=40)
    with jax.disable_jit():
        jp = jpkv.from_contiguous_int8(jdense, maxp, maxp, page_size=ps)
    tp = paged_kv.from_contiguous_int8(_port_dense(jdense), maxp, maxp, page_size=ps)

    def same(tp, jp):
        for name in ("k_pages", "v_pages"):
            np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)))
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)),
                                       rtol=0, atol=0)
        np.testing.assert_array_equal(tp.page_table.numpy(), np.asarray(jp.page_table))
        np.testing.assert_array_equal(tp.length.numpy(), np.asarray(jp.length))

    same(tp, jp)
    assert tp.k_pages.dtype == torch.int8 and tp.k_scale.dtype == torch.float32
    hkv, dh = dcfg.num_kv_heads, dcfg.head_dim
    for t in range(5):                       # crosses into a new page at length 32
        k, v = _rand(700 + t, 1, hkv, dh), _rand(800 + t, 1, hkv, dh)
        for layer in range(dcfg.num_layers):
            jp = jpkv.append_token_kv_int8(jp, jnp.asarray(layer), jnp.asarray(k), jnp.asarray(v))
            paged_kv.append_token_kv_int8(tp, layer, torch.from_numpy(k), torch.from_numpy(v))
        jp = jp._replace(length=jp.length + 1)
        paged_kv.advance(tp)
    same(tp, jp)


@pytest.fixture(scope="module")
def trees():
    """Tiny f32 decoder weights, quantized by the JAX package and converted."""
    cfg = jconfig.DecoderConfig.tiny()
    params = jdec.init(jax.random.key(0), cfg, jnp.float32)
    out = {"cfg": cfg, "pcfg": config.DecoderConfig(**dataclasses.asdict(cfg))}
    for bits in (8, 4):
        jq = jquant.quantize_decoder_params(params, bits=bits)
        out[bits] = (jq, convert.to_torch(_np(jq)))
    return out


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("sequential_pages", [True, False])
def test_decode_step_paged_int8_matches_jax(no_launches, trees, bits, sequential_pages):
    cfg, pcfg = trees["cfg"], trees["pcfg"]
    jparams, tparams = trees[bits]
    embeds, length = _rand(7, 1, 32, cfg.hidden_size, scale=0.5), np.asarray([29], np.int32)
    jcache = jdec.KVCache.create(cfg, 1, 32, dtype=jnp.float32)
    _, jcache = jdec.prefill(jparams, cfg, jnp.asarray(embeds), jcache, jnp.asarray(length))
    jpaged = jpkv.from_contiguous_int8(jcache, 5, 5, page_size=8)
    cache = decoder.KVCache.create(pcfg, 1, 32, dtype=torch.float32)
    _, cache = decoder.prefill(tparams, pcfg, torch.from_numpy(embeds), cache,
                               torch.from_numpy(length))
    paged = paged_kv.from_contiguous_int8(cache, 5, 5, page_size=8)
    for tok in (17, 300):
        ref, jpaged = jpkv.decode_step_paged_int8(jparams, cfg, jnp.asarray([tok], jnp.int32),
                                                  jpaged)
        out, paged = paged_kv.decode_step_paged_int8(tparams, pcfg, torch.tensor([tok]), paged,
                                                     sequential_pages=sequential_pages)
        # A K/V entry whose f32 input differs from JAX's in the last bits can
        # round to the neighbouring int8 value (one quantization step, up to
        # 1/254 of its slot's largest value), so logits agree to 1e-3.
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3, rtol=0)
    assert int(paged.length[0]) == int(jpaged.length[0]) == 31


@pytest.mark.parametrize("bits,kv_int8", [(8, False), (4, False), (8, True)])
@pytest.mark.parametrize("valid,max_new", [(37, 12), (16, 20)])
def test_generate_paged_quantized_token_exact(no_launches, trees, bits, kv_int8, valid,
                                              max_new):
    cfg, pcfg = trees["cfg"], trees["pcfg"]
    jparams, tparams = trees[bits]
    embeds, length = _rand(valid, 1, 40, cfg.hidden_size, scale=0.5), np.asarray([valid],
                                                                                np.int32)
    ref_toks, ref_count = generate_paged_fetch(
        jparams, cfg, jnp.asarray(embeds), jnp.asarray(length), jax.random.key(2),
        max_new_tokens=max_new, temperature=0.0, page_size=16, kv_int8=kv_int8)
    toks, count = generate_paged(tparams, pcfg, torch.from_numpy(embeds),
                                 torch.from_numpy(length), max_new_tokens=max_new,
                                 temperature=0.0, page_size=16, kv_int8=kv_int8)
    np.testing.assert_array_equal(toks, np.asarray(ref_toks))
    np.testing.assert_array_equal(count, np.asarray(ref_count))


def test_logits_and_embed_from_quantized_tables(no_launches, trees):
    """An int8 head gives f32 logits as the JAX f32 product does; an
    int8-row embedding table dequantizes per row to bf16."""
    cfg, pcfg = trees["cfg"], trees["pcfg"]
    jparams, tparams = trees[8]
    hidden = _bf16_values(_rand(3, 1, 1, cfg.hidden_size))
    ref = jdec.logits_from_hidden(jparams, cfg, jnp.asarray(hidden).astype(jnp.bfloat16))
    out = decoder.logits_from_hidden(tparams, pcfg, torch.from_numpy(hidden).bfloat16())
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    table = _rand(4, 64, cfg.hidden_size, scale=0.02)
    ids = np.asarray([3, 0, 63, 3])
    ref = jdec.embed_tokens({"embed": jquant.quantize_embedding(jnp.asarray(table))},
                            jnp.asarray(ids))
    out = decoder.embed_tokens({"embed": quant.quantize_embedding(torch.from_numpy(table))},
                               torch.from_numpy(ids))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref, np.float32))
