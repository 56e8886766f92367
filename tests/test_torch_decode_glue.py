"""The paged decode step's glue (`ops/decode_glue.py`) on the CPU.

On the card the paged decode step runs its elementwise glue as three
hand-written kernels (add + RMSNorm, bias + RoPE + KV append, SiLU x up);
on CPU tensors the wrappers run their plain twins, which are the eager
code the kernels replaced. These tests hold that on the CPU, bit for bit,
against copies of that code as it stood:
- each plain twin at Qwen2 geometry (q/k/v biases, 28 / 4 heads) and LLaMA
  geometry (no bias, 32 / 8), bf16 and int8 pages, at each row's length and
  at explicit positions;
- `paged_kv.decode_step_paged(_int8)`'s logits, pools and lengths over
  three steps against the replaced step loop, for bf16, int8 and int4
  weights, with and without biases, bf16 and int8 pages, and explicit
  positions; no wrapper counts a launch on the CPU.
The kernels against these twins on the card are in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from streamchat_tpu_torch import kernels
from streamchat_tpu_torch.config import DecoderConfig
from streamchat_tpu_torch.models import decoder, paged_kv
from streamchat_tpu_torch.ops import decode_glue, quant
from streamchat_tpu_torch.ops.paged_attention import (paged_decode_attention_table,
                                                      paged_decode_attention_table_int8)

# ---------------------------------------------------------------------------
# The replaced code, as it stood (models/decoder.py, models/paged_kv.py).
# ---------------------------------------------------------------------------


def _old_rmsnorm(x, scale, eps):
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _old_rope(x, positions, theta):
    dh = x.shape[-1]
    inv_freq = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                             device=x.device) / dh))
    ang = positions[:, None, :, None].float() * inv_freq
    cos, sin = torch.cos(ang), torch.sin(ang)
    x32 = x.float()
    x1, x2 = x32[..., : dh // 2], x32[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _old_quantize_kv(x):
    amax = x.abs().amax(-1).float()
    scale = (amax / 127.0).masked_fill_(amax == 0, 1.0)
    vals = torch.div(x, scale[..., None]).round_().clamp_(-127, 127).to(torch.int8)
    return vals, scale


def _old_append(cache, layer, k, v):
    ps = cache.page_size
    length = cache.length.long()
    page_idx = cache.page_table.gather(1, (length // ps)[:, None])[:, 0].long()
    offset = length % ps
    cache.k_pages[layer][page_idx, :, offset] = k.to(cache.k_pages.dtype)
    cache.v_pages[layer][page_idx, :, offset] = v.to(cache.v_pages.dtype)


def _old_append_int8(cache, layer, k, v):
    ps = cache.page_size
    length = cache.length.long()
    page_idx = cache.page_table.gather(1, (length // ps)[:, None])[:, 0].long()
    offset = length % ps
    vals, sc = _old_quantize_kv(torch.stack([k, v]))
    cache.k_pages[layer][page_idx, :, offset] = vals[0]
    cache.v_pages[layer][page_idx, :, offset] = vals[1]
    cache.k_scale[layer][page_idx, :, offset] = sc[0]
    cache.v_scale[layer][page_idx, :, offset] = sc[1]


def _old_qkv_proj(h, attn, b, s, hq, hkv, dh):
    pq, pk, pv = attn["q"], attn["k"], attn["v"]
    if decoder._all_int4(pq, pk, pv):
        qy, ky, vy = quant.qmatmul_int4_multi(h, (pq, pk, pv))
        if "b" in pq:
            qy, ky, vy = qy + pq["b"], ky + pk["b"], vy + pv["b"]
    else:
        qy, ky, vy = decoder._proj(h, pq), decoder._proj(h, pk), decoder._proj(h, pv)
    return (qy.reshape(b, s, hq, dh).transpose(1, 2),
            ky.reshape(b, s, hkv, dh).transpose(1, 2),
            vy.reshape(b, s, hkv, dh).transpose(1, 2))


def _old_swiglu(h, mlp):
    pg, pu = mlp["gate"], mlp["up"]
    if decoder._all_int4(pg, pu):
        gy, uy = quant.qmatmul_int4_multi(h, (pg, pu))
    else:
        gy, uy = decoder._mm(h, pg), decoder._mm(h, pu)
    return torch.nn.functional.silu(gy.float()).to(h.dtype) * uy


def _old_decode_step(params, cfg, token_ids, cache, append, attend, positions=None):
    b = token_ids.shape[0]
    x = decoder.embed_tokens(params, token_ids)[:, None, :]
    positions = (cache.length if positions is None else positions)[:, None]
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    new_length = (cache.length + 1).to(torch.int32)
    for i, p in enumerate(params["layers"]):
        h = _old_rmsnorm(x, p["input_norm"], cfg.rms_eps)
        q, k, v = _old_qkv_proj(h, p["attn"], b, 1, hq, hkv, dh)
        q = _old_rope(q, positions, cfg.rope_theta)
        k = _old_rope(k, positions, cfg.rope_theta)
        append(cache, i, k[:, :, 0], v[:, :, 0])
        o = attend(q, i, new_length)
        x = x + decoder.attn_out(params, o.transpose(1, 2).reshape(b, 1, hq * dh), p["attn"])
        mid = _old_rmsnorm(x, p["post_norm"], cfg.rms_eps)
        x = x + decoder._row_parallel(params, _old_swiglu(mid, p["mlp"]), p["mlp"]["down"],
                                      "down")
    x = _old_rmsnorm(x, params["final_norm"], cfg.rms_eps)
    logits = decoder.logits_from_hidden(params, cfg, x)[:, 0]
    paged_kv.advance(cache)
    return logits, cache


# ---------------------------------------------------------------------------


def _bf(seed, *shape, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


@pytest.fixture
def no_launches():
    kernels.reset_launch_counts()
    yield
    assert not any(kernels.launch_counts().values()), \
        "a CPU tensor must run the plain twin, never count a launch"


# Qwen2-7B (LongVA) and LLaMA-3-8B (the judge): heads, bias, theta, width.
GEOMETRIES = {"qwen2": dict(hq=28, hkv=4, bias=True, theta=1e6, d=3584, f=18944),
              "llama3": dict(hq=32, hkv=8, bias=False, theta=5e5, d=4096, f=14336)}


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("residual", [False, True], ids=["no_delta", "delta"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_add_rmsnorm_plain_is_the_replaced_code(no_launches, geometry, residual, rows):
    d = GEOMETRIES[geometry]["d"]
    x, scale = _bf(1, rows, 1, d, scale=4.0), 1 + _bf(2, d, scale=0.1)
    delta = _bf(3, rows, 1, d) if residual else None
    kept = x.clone()
    new_x, h = decode_glue.add_rmsnorm(x, delta, scale, 1e-6)
    ref_x = kept + delta if residual else kept
    assert torch.equal(new_x, ref_x) and torch.equal(x, kept)
    assert torch.equal(h, _old_rmsnorm(ref_x, scale, 1e-6))


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_silu_mul_plain_is_the_replaced_code(no_launches, geometry, rows):
    f = GEOMETRIES[geometry]["f"]
    gate, up = _bf(4, rows, 1, f, scale=3.0), _bf(5, rows, 1, f)
    ref = torch.nn.functional.silu(gate.float()).to(gate.dtype) * up
    assert torch.equal(decode_glue.silu_mul(gate, up), ref)


@pytest.mark.parametrize("form", ["f32", "three_tokens_a_row", "nine_rows"])
def test_cpu_calls_run_the_plain_twins_for_any_form(no_launches, form):
    """On CPU tensors the wrappers run their twins for forms the kernels
    refuse on the card (f32, more than one token a row) too."""
    shape = {"three_tokens_a_row": (2, 3, 64), "nine_rows": (9, 1, 64)}.get(form, (2, 1, 64))
    dt = torch.float32 if form == "f32" else torch.bfloat16
    x, delta = _bf(6, *shape).to(dt), _bf(7, *shape).to(dt)
    scale = (1 + _bf(8, 64, scale=0.1)).to(dt)
    new_x, h = decode_glue.add_rmsnorm(x, delta, scale, 1e-6)
    assert torch.equal(new_x, x + delta) and torch.equal(h, _old_rmsnorm(x + delta, scale, 1e-6))
    ref = torch.nn.functional.silu(x.float()).to(dt) * delta
    assert torch.equal(decode_glue.silu_mul(x, delta), ref)


def _pool(rows, hkv, dh, ps, int8, lengths, seed):
    """A pool of 12 pages mapped through a shuffled table (4 slots a row),
    holding random values, at the rows' lengths."""
    num_pages, maxp = 12, 4
    shape = (num_pages, hkv, ps, dh)
    if int8:
        g = torch.Generator().manual_seed(seed)
        cache = paged_kv.PagedKVCacheInt8(
            k_pages=torch.randint(-127, 128, shape, dtype=torch.int8, generator=g),
            v_pages=torch.randint(-127, 128, shape, dtype=torch.int8, generator=g),
            k_scale=torch.rand(shape[:3], generator=g), v_scale=torch.rand(shape[:3], generator=g),
            page_table=None, length=None, next_free=torch.tensor(num_pages, dtype=torch.int32))
    else:
        cache = paged_kv.PagedKVCache(k_pages=_bf(seed, *shape), v_pages=_bf(seed + 1, *shape),
                                      page_table=None, length=None,
                                      next_free=torch.tensor(num_pages, dtype=torch.int32))
    perm = np.random.default_rng(seed).permutation(num_pages)[:rows * maxp]
    cache.page_table = torch.from_numpy(perm.reshape(rows, maxp).astype(np.int32))
    cache.length = torch.tensor(lengths, dtype=torch.int32)
    return cache


def _clone(cache):
    return type(cache)(**{f: getattr(cache, f).clone() for f in cache.__dataclass_fields__})


def _same_cache(a, b):
    for f in a.__dataclass_fields__:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("positions", [False, True], ids=["at_length", "positions"])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16_pages", "int8_pages"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_bias_rope_append_plain_is_the_replaced_code(no_launches, geometry, int8, positions):
    geo = GEOMETRIES[geometry]
    hq, hkv, dh, ps, rows = geo["hq"], geo["hkv"], 128, 16, 3
    cache = _pool(rows, hkv, dh, ps, int8, [0, 17, 63], seed=7)
    twin = _clone(cache)
    q, k, v = (_bf(10 + i, rows, 1, h * dh, scale=2.0) for i, h in enumerate((hq, hkv, hkv)))
    bias = tuple(_bf(20 + i, h * dh) for i, h in enumerate((hq, hkv, hkv))) if geo["bias"] \
        else None
    pos = torch.tensor([23_105, 5, 7_000], dtype=torch.int32) if positions else None
    got = decode_glue.bias_rope_append(
        q, k, v, bias, pos, geo["theta"], cache.k_pages, cache.v_pages,
        cache.k_scale if int8 else None, cache.v_scale if int8 else None, cache.page_table,
        cache.length)
    qy, ky, vy = (q + bias[0], k + bias[1], v + bias[2]) if bias else (q, k, v)
    qh = qy.reshape(rows, 1, hq, dh).transpose(1, 2)
    kh = ky.reshape(rows, 1, hkv, dh).transpose(1, 2)
    vh = vy.reshape(rows, 1, hkv, dh).transpose(1, 2)
    at = (twin.length if pos is None else pos)[:, None]
    ref = _old_rope(qh, at, geo["theta"])
    layered = type(twin)(**{f: (getattr(twin, f)[None] if f.endswith(("pages", "scale"))
                                else getattr(twin, f)) for f in twin.__dataclass_fields__})
    old_append = _old_append_int8 if int8 else _old_append
    old_append(layered, 0, _old_rope(kh, at, geo["theta"])[:, :, 0], vh[:, :, 0])
    assert got.shape == (rows, hq, 1, dh) and torch.equal(got, ref)
    _same_cache(cache, twin)
    assert not torch.equal(cache.k_pages, _pool(rows, hkv, dh, ps, int8, [0, 17, 63], 7).k_pages)


def _tiny_cfg(bias):
    """A Qwen2-like (bias) or LLaMA-like decoder at a width int4 takes."""
    return DecoderConfig(vocab_size=97, hidden_size=128, intermediate_size=256, num_layers=2,
                         num_heads=4, num_kv_heads=2, head_dim=32,
                         rope_theta=1e6 if bias else 5e5, rms_eps=1e-6 if bias else 1e-5,
                         qkv_bias=bias, eos_token_id=1, pad_token_id=0)


@pytest.mark.parametrize("pages", ["bf16", "int8", "bf16_positions"])
@pytest.mark.parametrize("weights", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_decode_step_equals_the_replaced_loop(no_launches, bias, weights, pages):
    """Three decode steps over two rows (the first crosses a page boundary)
    through the page table: logits, pools, tables and lengths bit-equal to
    the step loop the glue wrappers replaced."""
    cfg = _tiny_cfg(bias)
    g = torch.Generator().manual_seed(3)
    params = decoder.init(cfg, g)
    if bias:
        for p in params["layers"]:
            for n in "qkv":
                p["attn"][n]["b"] = torch.randn(p["attn"][n]["b"].shape, generator=g).to(
                    torch.bfloat16)
    for p in params["layers"]:
        p["input_norm"] = (1 + 0.1 * torch.randn(cfg.hidden_size, generator=g)).to(torch.bfloat16)
    if weights != "bf16":
        params = quant.quantize_decoder_params(params, bits=4 if weights == "int4" else 8)
    lengths = torch.tensor([15, 6], dtype=torch.int32)
    embeds = (torch.randn(2, 32, cfg.hidden_size, generator=g) * 0.5).to(torch.bfloat16)
    dense = decoder.KVCache.create(cfg, 2, 32)
    logits, dense = decoder.prefill(params, cfg, embeds, dense, lengths)
    int8 = pages == "int8"
    page = paged_kv.from_contiguous_int8 if int8 else paged_kv.from_contiguous
    cache, twin = page(dense, 8, 4, page_size=16), page(dense, 8, 4, page_size=16)
    pos = torch.tensor([4_000, 20_000], dtype=torch.int32) if pages == "bf16_positions" else None

    def attend(c):
        if int8:
            return lambda q, i, ln: paged_decode_attention_table_int8(
                q, c.k_pages[i], c.v_pages[i], c.k_scale[i], c.v_scale[i], c.page_table, ln)
        return lambda q, i, ln: paged_decode_attention_table(q, c.k_pages[i], c.v_pages[i],
                                                             c.page_table, ln)

    tok = torch.argmax(logits, -1)
    ref_tok = tok
    for step in range(3):
        cache = paged_kv.allocate_pages(cache, torch.ones(2, dtype=torch.int32))
        twin = paged_kv.allocate_pages(twin, torch.ones(2, dtype=torch.int32))
        at = None if pos is None else pos + step
        if int8:
            got, cache = paged_kv.decode_step_paged_int8(params, cfg, tok, cache)
        else:
            got, cache = paged_kv.decode_step_paged(params, cfg, tok, cache, positions=at)
        ref, twin = _old_decode_step(params, cfg, ref_tok, twin,
                                     _old_append_int8 if int8 else _old_append, attend(twin), at)
        assert torch.equal(got, ref), step
        _same_cache(cache, twin)
        tok = ref_tok = torch.argmax(got, -1)
    assert cache.length.tolist() == [18, 9]
