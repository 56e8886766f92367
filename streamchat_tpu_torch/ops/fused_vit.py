"""The ViT layer (K1) and the LN-MLP (K2) for Hopper, with plain twins.

Counterparts of `streamchat_tpu/ops/fused_vit.py`:

* `fused_vit_layer` (K1) — one pre-LN CLIP block,
  out = y + fc2(act(fc1(LN2(y)))),  y = x + O(attn(QKV(LN1(x)))),
  with the TPU kernel's options and defaults: softmax "clamp" (default) or
  "exact"; `folded` weights from `fold_vit_layer_params` (both LN affines
  and the q scale in wqkv / bqkv / w1 / b1, exp2 softmax); `ln_onepass`
  statistics for both LayerNorms; the fc1 activation. The ingest runs it
  folded, one-pass and clamp (models/vit `_block_fused`), as the JAX
  package does on its chip. On a CUDA tensor it launches `csrc/fused_vit.cu`
  (`sc_fused_vit_layer`: LayerNorm, tensor-core GEMMs with fused epilogues
  and the flash-attention kernel on one stream); on a CPU tensor it runs
  `fused_vit_layer_plain`, which follows the TPU kernel's `_layer_kernel`
  option by option. The GEMMs are `csrc/gemm.cu` (wgmma, TMA, epilogue in
  registers), the attention `csrc/flash_prefill.cu` in the layer's softmax
  mode.
* `fused_ln_mlp` — out = [x +] fc2(act(fc1([LN] x))), act one of
  quick_gelu / erf-GELU / none (the projector runs it with LN off, no
  residual and erf-GELU). CUDA: `sc_fused_ln_mlp`; CPU: `fused_ln_mlp_plain`.
* `gemm` — out = act(a @ b + bias) (+ residual), the wgmma GEMM with its
  fused epilogue that K1, K2, K13 and K16 launch inside their sequences, on
  its own (no path calls it; the card tests and the smoke hold it to
  `gemm_plain`). `gemm_guard` is its contract as a pure function of shapes,
  strides and dtypes: every wrapper here checks each of its products with
  it and raises `GemmShapeError` before any launch.
* `fused_ln_attn` (K13) — out = x + O(attn(QKV(LN x))), the attention half
  of the block with the TPU kernel's options: softmax "clamp" (default;
  p = exp(min(s, 80)), no max subtraction, the sum floored at 1e-30) or
  "exact"; `folded` weights from `fold_vit_attn_params` (LN affine and the
  q scale dh^-0.5 * log2 e in wqkv / bqkv, exp2 softmax); `ln_onepass`
  statistics. CUDA: `sc_fused_ln_attn`; CPU: `fused_ln_attn_plain`, which
  follows the TPU kernel's `_attn_body` option by option.

Numerics follow the TPU kernels: LayerNorm statistics in f32, products of
the storage dtype with f32 accumulation, the mid-layer residual kept in
f32, activations rounded to the storage dtype between the products. The
plain twins compute each product in f32 from the rounded operands, which is
what the kernels' f32 accumulation computes up to summation order.
"""

from __future__ import annotations

import math

import torch

from streamchat_tpu_torch.kernels import counted, launched

ACTIVATIONS = {"none": 0, "quick_gelu": 1, "gelu": 2}
_LOG2E = math.log2(math.e)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product of the (rounded) operands with f32 accumulation and output."""
    return a.float() @ b.float()


def _ln_f32(x32, scale, bias, eps, *, onepass: bool = False):
    """LayerNorm in f32; `onepass` takes var = E[x^2] - E[x]^2, and
    scale None skips the affine (folded weights)."""
    mu = x32.mean(-1, keepdim=True)
    if onepass:
        var = (x32 * x32).mean(-1, keepdim=True) - mu * mu
    else:
        var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    if scale is None:
        return y
    return y * scale.float() + bias.float()


def _activate(h32, activation: str):
    if activation == "quick_gelu":
        return h32 * torch.sigmoid(1.702 * h32)
    if activation == "gelu":
        return 0.5 * h32 * (1.0 + torch.erf(h32 * 2.0 ** -0.5))
    if activation == "none":
        return h32
    raise ValueError(f"unknown activation: {activation}")


def _check_cuda(name, t, dtype, shape=None):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: expected a 16-byte aligned tensor")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


class GemmShapeError(ValueError):
    """A product the Hopper GEMM (`csrc/gemm.cu`) does not take. The
    wrappers raise it before any launch; nothing falls back to another
    kernel or to `torch.matmul`."""


def gemm_guard(m, n, k, *, lda=None, a_dtype=torch.bfloat16, b_dtype=torch.bfloat16, ldr=None,
               res_dtype=None, ldc=None, out_dtype=torch.bfloat16):
    """The GEMM's contract, with its TMA maps', as a pure function of shapes,
    strides (in elements) and dtypes; raises GemmShapeError outside it.

    A [m, k] with rows `lda` apart (default k) and B [k, n] row-major, both
    bf16; k a positive multiple of 64 (the k-slab), n a positive multiple of
    128 (the tile width); lda >= k and a multiple of 8 (TMA's 16-byte row
    stride); the residual (res_dtype None: none) and the output bf16 or f32
    with leading dims `ldr` / `ldc` (default n) >= n and even (the
    epilogue's paired loads and stores). m is free: rows past it are
    masked."""
    lda = k if lda is None else lda
    if a_dtype != torch.bfloat16 or b_dtype != torch.bfloat16:
        raise GemmShapeError(f"gemm: A and B must be bf16, got {a_dtype} and {b_dtype}")
    if m < 0:
        raise GemmShapeError(f"gemm: M={m} is negative")
    if k <= 0 or k % 64:
        raise GemmShapeError(f"gemm: K={k} is not a positive multiple of 64")
    if n <= 0 or n % 128:
        raise GemmShapeError(f"gemm: N={n} is not a positive multiple of 128")
    if lda < k or lda % 8:
        raise GemmShapeError(f"gemm: lda={lda} must be >= K={k} and a multiple of 8 "
                             "(TMA's 16-byte row stride)")
    for name, ld, dt in (("residual", ldr, res_dtype), ("out", ldc, out_dtype)):
        if dt is None:
            continue
        if dt not in (torch.bfloat16, torch.float32):
            raise GemmShapeError(f"gemm: {name} must be bf16 or f32, got {dt}")
        ld = n if ld is None else ld
        if ld < n or ld % 2:
            raise GemmShapeError(f"gemm: {name} leading dim {ld} must be >= N={n} and even")


def gemm_plain(a, b, bias=None, residual=None, *, activation="none", out_dtype=None):
    """Plain PyTorch twin of `gemm` (same signature): the product in f32 from
    the rounded operands, then bias, activation, residual, one rounding."""
    out = _mm(a, b)
    if bias is not None:
        out = out + bias.float()
    out = _activate(out, activation)
    if residual is not None:
        out = out + residual.float()
    return out.to(out_dtype or a.dtype)


@counted
def gemm(a, b, bias=None, residual=None, *, activation="none", out_dtype=None):
    """out [M, N] = act(a @ b + bias) (+ residual) with a [M, K] (rows may
    be strided), b [K, N], bias [N] bf16 and residual [M, N] bf16 or f32;
    out in `out_dtype` (default a's). CPU tensors run `gemm_plain`; CUDA
    tensors launch `sc_gemm` or raise (GemmShapeError outside
    `gemm_guard`)."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation: {activation}")
    if a.device.type == "cpu":
        return gemm_plain(a, b, bias, residual, activation=activation, out_dtype=out_dtype)
    from streamchat_tpu_torch.kernels.build import call

    (m, k), n = a.shape, b.shape[1]
    out_dtype = out_dtype or a.dtype
    if a.stride(1) != 1 or tuple(b.shape) != (k, n) or not b.is_contiguous():
        raise GemmShapeError(f"gemm: a {tuple(a.shape)} (stride {a.stride()}) and b "
                             f"{tuple(b.shape)} must be row-major [M, K] and [K, N]")
    if residual is not None and (tuple(residual.shape) != (m, n) or residual.stride(1) != 1):
        raise GemmShapeError(f"gemm: residual {tuple(residual.shape)} must be row-major "
                             f"[{m}, {n}]")
    gemm_guard(m, n, k, lda=a.stride(0), a_dtype=a.dtype, b_dtype=b.dtype,
               ldr=None if residual is None else residual.stride(0),
               res_dtype=None if residual is None else residual.dtype, out_dtype=out_dtype)
    for name, t in (("a", a), ("b", b), ("bias", bias), ("residual", residual)):
        if t is not None and (t.device != a.device or t.data_ptr() % 16):
            raise ValueError(f"gemm {name}: expected a 16-byte aligned tensor on {a.device}")
    if bias is not None:
        _check_cuda("gemm bias", bias, torch.bfloat16, (n,))
    out = torch.empty(m, n, dtype=out_dtype, device=a.device)
    dtype_code = {torch.bfloat16: 0, torch.float32: 1}
    call("sc_gemm", a.data_ptr(), a.stride(0), b.data_ptr(),
         None if bias is None else bias.data_ptr(),
         None if residual is None else residual.data_ptr(),
         0 if residual is None else dtype_code[residual.dtype],
         0 if residual is None else residual.stride(0), out.data_ptr(), dtype_code[out_dtype],
         n, m, n, k, ACTIVATIONS[activation], _stream())
    launched(gemm)
    return out


def _guard_products(m, *kn):
    """gemm_guard over each (K, N) product of a wrapper's launch sequence,
    its A contiguous."""
    for k, n in kn:
        gemm_guard(m, n, k)


SOFTMAX = {"exact": 0, "clamp": 1}
# The flash loop's clamp softmax with bf16 scores (the layer probe's bf16s
# variant, utils/probe_vit_variants); no K1 caller reaches it.
SOFTMAX_CLAMP_BF16 = 2


def layer_mode(softmax_mode: str, folded: bool, ln_onepass: bool, activation: str) -> str:
    """The name a K1 launch is tallied under (kernels.launch_modes)."""
    return "+".join([softmax_mode] + ["folded"] * folded + ["onepass"] * ln_onepass
                    + [activation])


def _check_layer(n, frame_tile, softmax_mode, activation):
    if n % frame_tile:
        raise ValueError(f"N={n} not a multiple of frame_tile={frame_tile}")
    _check_softmax_mode(softmax_mode)
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation: {activation}")


def _attention_plain(qkv, num_heads, *, folded, softmax_mode, bf16_scores=False):
    """Merged q|k|v [n, s, 3d] in the storage dtype -> [n, s, d]: the TPU
    kernels' `_attn_body` attention, all heads at once. `bf16_scores` is
    the layer probe's bf16s variant: scores rounded to bf16, then min(s, 80)
    and the (natural) exp in bf16."""
    n, s, d3 = qkv.shape
    dt, d = qkv.dtype, d3 // 3
    dh = d // num_heads
    q, k, v = qkv.view(n, s, 3, num_heads, dh).permute(2, 0, 3, 1, 4)   # [n, H, s, dh]
    if not folded:
        q = q * torch.tensor(dh ** -0.5, dtype=dt)
    scores = _mm(q, k.transpose(-1, -2))          # [n, H, s, s], log2 units when folded
    exp = torch.exp2 if folded else torch.exp
    if bf16_scores:
        p = torch.exp(scores.to(torch.bfloat16).clamp_max(80.0))
    elif softmax_mode == "exact":
        p = exp(scores - scores.amax(-1, keepdim=True))
    else:
        p = exp(scores.clamp_max(80.0 * _LOG2E if folded else 80.0))
    p = p.to(dt)
    l_inv = 1.0 / p.float().sum(-1, keepdim=True).clamp_min(1e-30)
    return (_mm(p, v) * l_inv).to(dt).transpose(1, 2).reshape(n, s, d)


def _layer_plain(x, ln1_scale, ln1_bias, wqkv, bqkv, wo, bo, ln2_scale, ln2_bias, w1, b1,
                 w2, b2, *, num_heads, eps, activation, softmax_mode, folded, ln_onepass,
                 bf16_scores=False):
    """The TPU kernel's `_layer_kernel` body over every frame at once."""
    dt = x.dtype
    x32 = x.float()
    aff1 = (None, None) if folded else (ln1_scale, ln1_bias)
    aff2 = (None, None) if folded else (ln2_scale, ln2_bias)
    h = _ln_f32(x32, *aff1, eps, onepass=ln_onepass).to(dt)
    qkv = (_mm(h, wqkv) + bqkv.float()).to(dt)
    attn = _attention_plain(qkv, num_heads, folded=folded, softmax_mode=softmax_mode,
                            bf16_scores=bf16_scores)
    mid_x = _mm(attn, wo) + bo.float() + x32
    h = _ln_f32(mid_x, *aff2, eps, onepass=ln_onepass).to(dt)
    mid = _activate(_mm(h, w1) + b1.float(), activation).to(dt)
    return (_mm(mid, w2) + b2.float() + mid_x).to(dt)


def fused_vit_layer_plain(x, ln1_scale, ln1_bias, wqkv, bqkv, wo, bo,
                          ln2_scale, ln2_bias, w1, b1, w2, b2, *,
                          num_heads: int, eps: float = 1e-5, activation: str = "quick_gelu",
                          frame_tile: int = 2, softmax_mode: str = "clamp",
                          folded: bool = False, ln_onepass: bool = False):
    """Plain PyTorch twin of `fused_vit_layer` (same signature)."""
    _check_layer(x.shape[0], frame_tile, softmax_mode, activation)
    return _layer_plain(x, ln1_scale, ln1_bias, wqkv, bqkv, wo, bo, ln2_scale, ln2_bias,
                        w1, b1, w2, b2, num_heads=num_heads, eps=eps, activation=activation,
                        softmax_mode=softmax_mode, folded=folded, ln_onepass=ln_onepass)


def launch_layer(x, ln1_scale, ln1_bias, wqkv, bqkv, wo, bo, ln2_scale, ln2_bias, w1, b1,
                 w2, b2, *, num_heads, eps, activation, softmax, folded, ln_onepass,
                 name="fused_vit_layer"):
    """One `sc_fused_vit_layer` launch sequence on CUDA tensors -> out.

    `softmax` is the kernel's code (SOFTMAX, or SOFTMAX_CLAMP_BF16). The
    caller counts the launch. Raises on what the kernel does not take (bf16,
    D and the MLP width multiples of 128, head dim 64 or 128)."""
    from streamchat_tpu_torch.kernels.build import call

    n, s, d = x.shape
    dmid = w1.shape[1]
    dh = d // num_heads
    if d % 128 or dmid % 128 or dh * num_heads != d or dh not in (64, 128):
        raise ValueError(f"{name}: unsupported D={d}, MLP={dmid}, heads={num_heads}")
    bf = torch.bfloat16
    checks = [("x", x, (n, s, d)), ("wqkv", wqkv, (d, 3 * d)), ("bqkv", bqkv, (3 * d,)),
              ("wo", wo, (d, d)), ("bo", bo, (d,)), ("w1", w1, (d, dmid)),
              ("b1", b1, (dmid,)), ("w2", w2, (dmid, d)), ("b2", b2, (d,))]
    if not folded:
        checks += [("ln1_scale", ln1_scale, (d,)), ("ln1_bias", ln1_bias, (d,)),
                   ("ln2_scale", ln2_scale, (d,)), ("ln2_bias", ln2_bias, (d,))]
    for label, t, shape in checks:
        _check_cuda(f"{name} {label}", t, bf, shape)
    m = n * s
    _guard_products(m, (d, 3 * d), (d, d), (d, dmid), (dmid, d))
    out = torch.empty_like(x)
    ws_h = torch.empty(m, d, dtype=bf, device=x.device)
    ws_qkv = torch.empty(m, 3 * d, dtype=bf, device=x.device)
    ws_attn = torch.empty(m, d, dtype=bf, device=x.device)
    ws_mid_x = torch.empty(m, d, dtype=torch.float32, device=x.device)
    ws_mid = torch.empty(m, dmid, dtype=bf, device=x.device)
    ln = (ln1_scale, ln1_bias, ln2_scale, ln2_bias)
    ln = [None] * 4 if folded else [t.data_ptr() for t in ln]
    ptrs = [t.data_ptr() for t in (x, wqkv, bqkv, wo, bo, w1, b1, w2, b2, out, ws_h, ws_qkv,
                                   ws_attn, ws_mid_x, ws_mid)]
    call("sc_fused_vit_layer", ptrs[0], ln[0], ln[1], *ptrs[1:5], ln[2], ln[3], *ptrs[5:],
         n, s, d, dmid, num_heads, eps, softmax, int(folded), int(ln_onepass),
         ACTIVATIONS[activation], _stream())
    return out


@counted
def fused_vit_layer(x, ln1_scale, ln1_bias, wqkv, bqkv, wo, bo,
                    ln2_scale, ln2_bias, w1, b1, w2, b2, *,
                    num_heads: int, eps: float = 1e-5, activation: str = "quick_gelu",
                    frame_tile: int = 2, softmax_mode: str = "clamp",
                    folded: bool = False, ln_onepass: bool = False):
    """One pre-LN CLIP block over x [N, S, D] -> [N, S, D] (K1).

    Weights are [in, out]; wqkv is the merged [D, 3D] q|k|v projection.
    The keyword arguments and defaults are the TPU kernel's: `frame_tile`
    must divide N and has no other effect here; with `folded` the ln*
    operands are ignored (pass what `fold_vit_layer_params` returned for
    wqkv / bqkv / w1 / b1). CPU tensors run the plain twin; CUDA tensors
    launch the kernel (bf16, D and the MLP width multiples of 128, head dim
    64 or 128) or raise.
    """
    _check_layer(x.shape[0], frame_tile, softmax_mode, activation)
    kw = dict(num_heads=num_heads, eps=eps, activation=activation, folded=folded,
              ln_onepass=ln_onepass)
    args = (x, ln1_scale, ln1_bias, wqkv, bqkv, wo, bo, ln2_scale, ln2_bias, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return _layer_plain(*args, softmax_mode=softmax_mode, **kw)
    out = launch_layer(*args, softmax=SOFTMAX[softmax_mode], **kw)
    launched(fused_vit_layer, layer_mode(softmax_mode, folded, ln_onepass, activation))
    return out


def fused_ln_mlp_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, *,
                       eps: float = 1e-5, activation: str = "quick_gelu",
                       layernorm: bool = True, residual: bool = True):
    """Plain PyTorch twin of `fused_ln_mlp` (same signature)."""
    dt = x.dtype
    x32 = x.float()
    h = _ln_f32(x32, ln_scale, ln_bias, eps).to(dt) if layernorm else x
    mid = _activate(_mm(h, w1) + b1.float(), activation).to(dt)
    out = _mm(mid, w2) + b2.float()
    if residual:
        out = out + x32
    return out.to(dt)


@counted
def fused_ln_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2, *,
                 eps: float = 1e-5, activation: str = "quick_gelu",
                 layernorm: bool = True, residual: bool = True):
    """out = [x +] fc2(act(fc1([LN] x))) over x [T, Din] (K2).

    ln_scale / ln_bias may be None when layernorm is False. CPU tensors
    run the plain twin; CUDA tensors launch the kernel (bf16, Din % 64 == 0,
    MLP and output widths multiples of 128) or raise (GemmShapeError for a
    width the GEMM does not take).
    """
    t, din = x.shape
    dmid, dout = w1.shape[1], w2.shape[1]
    if residual and dout != din:
        raise ValueError("residual requires matching in/out dims")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation: {activation}")
    if x.device.type == "cpu":
        return fused_ln_mlp_plain(
            x, ln_scale, ln_bias, w1, b1, w2, b2, eps=eps,
            activation=activation, layernorm=layernorm, residual=residual)
    from streamchat_tpu_torch.kernels.build import call

    _guard_products(t, (din, dmid), (dmid, dout))
    bf = torch.bfloat16
    checks = [("x", x, (t, din)), ("w1", w1, (din, dmid)), ("b1", b1, (dmid,)),
              ("w2", w2, (dmid, dout)), ("b2", b2, (dout,))]
    if layernorm:
        checks += [("ln_scale", ln_scale, (din,)), ("ln_bias", ln_bias, (din,))]
    for name, tt, shape in checks:
        _check_cuda(f"fused_ln_mlp {name}", tt, bf, shape)
    out = torch.empty(t, dout, dtype=bf, device=x.device)
    ws_mid = torch.empty(t, dmid, dtype=bf, device=x.device)
    ws_h = torch.empty(t, din, dtype=bf, device=x.device) if layernorm else None
    ptr = lambda tt: None if tt is None else tt.data_ptr()  # noqa: E731
    call("sc_fused_ln_mlp", ptr(x), ptr(ln_scale if layernorm else None),
         ptr(ln_bias if layernorm else None), ptr(w1), ptr(b1), ptr(w2), ptr(b2),
         ptr(out), ptr(ws_h), ptr(ws_mid), t, din, dmid, dout,
         ACTIVATIONS[activation], int(layernorm), int(residual), eps, _stream())
    launched(fused_ln_mlp)
    return out


def _check_softmax_mode(softmax_mode):
    if softmax_mode not in ("clamp", "exact"):
        raise ValueError(f"softmax_mode={softmax_mode!r}: expected 'clamp' or 'exact'")


def _check_ln_attn(n, frame_tile, softmax_mode):
    if n % frame_tile:
        raise ValueError(f"N={n} not a multiple of frame_tile={frame_tile}")
    _check_softmax_mode(softmax_mode)


def fold_vit_attn_params(ln_scale, ln_bias, wqkv, bqkv, *, num_heads: int):
    """Fold the pre-attention LN affine and the q scale dh^-0.5 * log2(e)
    into wqkv / bqkv (y @ W + b with y = n * g + c is n @ (g * W) + (c @ W
    + b)), in f32, rounded back to the weights' dtype -> (wqkv', bqkv') for
    `fused_ln_attn(..., folded=True)`, which then ignores ln_scale / ln_bias."""
    d = wqkv.shape[0]
    dh = d // num_heads
    w = wqkv.float()
    b = bqkv.float() + ln_bias.float() @ w
    w = w * ln_scale.float()[:, None]
    qscale = (dh ** -0.5) * _LOG2E
    w[:, :d] *= qscale
    b[:d] *= qscale
    return w.to(wqkv.dtype), b.to(bqkv.dtype)


def fold_vit_layer_params(ln1_scale, ln1_bias, wqkv, bqkv, ln2_scale, ln2_bias, w1, b1, *,
                          num_heads: int):
    """Fold both LN affines and the q scale into the projections ->
    (wqkv', bqkv', w1', b1') for `fused_vit_layer(..., folded=True)`: the
    attention half is `fold_vit_attn_params`, and the LN2 affine commutes
    into fc1 the same way (in f32, rounded back to the weights' dtype)."""
    w, b = fold_vit_attn_params(ln1_scale, ln1_bias, wqkv, bqkv, num_heads=num_heads)
    w1f = w1.float()
    b1f = b1.float() + ln2_bias.float() @ w1f
    w1f = w1f * ln2_scale.float()[:, None]
    return w, b, w1f.to(w1.dtype), b1f.to(b1.dtype)


def fused_ln_attn_plain(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, *, num_heads: int,
                        eps: float = 1e-5, frame_tile: int = 1, softmax_mode: str = "clamp",
                        folded: bool = False, ln_onepass: bool = False):
    """Plain PyTorch twin of `fused_ln_attn` (same signature): the TPU
    kernel's `_attn_body`, all heads at once."""
    n, s, d = x.shape
    _check_ln_attn(n, frame_tile, softmax_mode)
    dt = x.dtype
    x32 = x.float()
    affine = (None, None) if folded else (ln_scale, ln_bias)
    h = _ln_f32(x32, *affine, eps, onepass=ln_onepass).to(dt)
    qkv = (_mm(h, wqkv) + bqkv.float()).to(dt)
    attn = _attention_plain(qkv, num_heads, folded=folded, softmax_mode=softmax_mode)
    return (_mm(attn, wo) + bo.float() + x32).to(dt)


@counted
def fused_ln_attn(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, *, num_heads: int,
                  eps: float = 1e-5, frame_tile: int = 1, softmax_mode: str = "clamp",
                  folded: bool = False, ln_onepass: bool = False):
    """out = x + O(attention(QKV(LN x))) over x [N, S, D] (K13).

    wqkv is the merged [D, 3D] q|k|v projection. `frame_tile` is the TPU
    kernel's frame tiling: N must be a multiple of it, and it has no other
    effect here. CPU tensors run the plain twin; CUDA tensors launch the
    kernel (bf16, D a multiple of 128, head dim 64 or 128) or raise.
    """
    n, s, d = x.shape
    _check_ln_attn(n, frame_tile, softmax_mode)
    if x.device.type == "cpu":
        return fused_ln_attn_plain(
            x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, num_heads=num_heads, eps=eps,
            frame_tile=frame_tile, softmax_mode=softmax_mode, folded=folded,
            ln_onepass=ln_onepass)
    from streamchat_tpu_torch.kernels.build import call

    dh = d // num_heads
    if d % 128 or dh * num_heads != d or dh not in (64, 128):
        raise ValueError(f"fused_ln_attn: unsupported D={d}, heads={num_heads}")
    bf = torch.bfloat16
    checks = [("x", x, (n, s, d)), ("wqkv", wqkv, (d, 3 * d)), ("bqkv", bqkv, (3 * d,)),
              ("wo", wo, (d, d)), ("bo", bo, (d,))]
    if not folded:
        checks += [("ln_scale", ln_scale, (d,)), ("ln_bias", ln_bias, (d,))]
    for name, t, shape in checks:
        _check_cuda(f"fused_ln_attn {name}", t, bf, shape)
    m = n * s
    _guard_products(m, (d, 3 * d), (d, d))
    out = torch.empty_like(x)
    ws_h = torch.empty(m, d, dtype=bf, device=x.device)
    ws_qkv = torch.empty(m, 3 * d, dtype=bf, device=x.device)
    ws_attn = torch.empty(m, d, dtype=bf, device=x.device)
    ln = (None, None) if folded else (ln_scale.data_ptr(), ln_bias.data_ptr())
    call("sc_fused_ln_attn", x.data_ptr(), *ln, wqkv.data_ptr(), bqkv.data_ptr(),
         wo.data_ptr(), bo.data_ptr(), out.data_ptr(), ws_h.data_ptr(), ws_qkv.data_ptr(),
         ws_attn.data_ptr(), n, s, d, num_heads, eps, SOFTMAX[softmax_mode],
         int(folded), int(ln_onepass), _stream())
    launched(fused_ln_attn)
    return out
