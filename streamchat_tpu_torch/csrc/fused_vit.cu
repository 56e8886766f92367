// The ViT layer (K1), the LN-MLP (K2) and the LN-attention half (K13)
// composed from the hand-written kernels of this library.
//
// Replaces the TPU kernels ops/fused_vit.py:fused_vit_layer (_layer_kernel),
// ops/fused_vit.py:fused_ln_mlp (_mlp_kernel) and ops/fused_vit.py:
// fused_ln_attn (_attn_kernel), and the layer of the variant probe
// scripts/probe_vit_variants.py:make_layer (_attn_mlp_body, K16: the same
// block with the clamp softmax, through sc_fused_vit_layer with its flags).
// On the TPU each was ONE
// Pallas kernel that kept a frame tile, every intermediate and all weights
// in VMEM. A Hopper block has at most 227 KB of shared memory, far below one
// frame's [577, 4096] MLP intermediate, so the layer runs as a sequence of
// launches on one stream: LayerNorm -> QKV GEMM -> attention -> O GEMM +
// residual -> LayerNorm -> fc1 GEMM + activation -> fc2 GEMM + residual. The
// GEMMs are gemm.cu's wgmma kernel, whose epilogues fuse bias, activation and
// residual; the attention is flash_prefill.cu's wgmma loop in the layer's
// softmax mode, reading q, k and v in place from the merged QKV buffer. The
// mid-layer residual stays f32 as in the TPU kernel; the intermediates round
// trip device memory in workspaces the Python wrapper allocates. The layer is
// bound by tensor-core throughput in the GEMMs (about 95% of its FLOPs).
#include "kernels.cuh"

namespace {

using bf = __nv_bfloat16;

// The attention step of K1, K13 and K16: H heads of dh = D / H over the
// merged qkv [N S, 3 D] (q | k | v, head-major inside each) into attn
// [N S, D]. Folded weights carry the q scale dh^-0.5 * log2(e), so their
// scores are in log2 units: scale ln 2 (exactly 1 in exp2's domain).
cudaError_t attention_step(const bf* qkv, bf* attn, int N, int S, int D, int H, int softmax,
                           int folded, cudaStream_t st) {
  const int dh = D / H;
  const int64_t qkv_strides[3] = {(int64_t)S * 3 * D, dh, 3 * D};
  const int64_t o_strides[3] = {(int64_t)S * D, dh, D};
  const float scale = folded ? 0.69314718055994531f : 1.0f / sqrtf((float)dh);
  const float scale_log2 = folded ? 1.0f : scale * 1.4426950408889634f;
  return sc::launch_vit_attention(qkv, qkv_strides, qkv + D, qkv_strides, qkv + 2 * D,
                                  qkv_strides, attn, o_strides, N, H, S, S, dh, scale,
                                  scale_log2, softmax, st);
}

}  // namespace

// x, out: [N * S, D] bf16; ws_h: [N*S, D] bf16; ws_qkv: [N*S, 3D]
// bf16; ws_attn: [N*S, D] bf16; ws_mid_x: [N*S, D] f32; ws_mid: [N*S, Dmid] bf16.
// The TPU kernel's options, as in sc_fused_ln_attn below: softmax 0 is
// "exact", 1 "clamp" (2 is clamp with bf16 scores, the layer probe's bf16s
// variant, K16); folded means both LN affines and the q scale dh^-0.5 *
// log2(e) live in wqkv / bqkv / w1 / b1 (ln*_s / ln*_b unused: both
// LayerNorms run without affine, LN2 on the f32 mid-layer residual) and the
// flash loop runs with scale ln 2; onepass selects the one-pass LN statistics
// for both LayerNorms; act is the fc1 epilogue's activation (sc::Act).
extern "C" int sc_fused_vit_layer(const void* x, const void* ln1_s, const void* ln1_b,
                                  const void* wqkv, const void* bqkv, const void* wo,
                                  const void* bo, const void* ln2_s, const void* ln2_b,
                                  const void* w1, const void* b1, const void* w2,
                                  const void* b2, void* out, void* ws_h, void* ws_qkv,
                                  void* ws_attn, void* ws_mid_x, void* ws_mid, int N, int S,
                                  int D, int Dmid, int H, float eps, int softmax, int folded,
                                  int onepass, int act, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int M = N * S;
  auto h = static_cast<bf*>(ws_h);
  auto qkv = static_cast<bf*>(ws_qkv);
  auto attn = static_cast<bf*>(ws_attn);
  auto mid = static_cast<bf*>(ws_mid);
  auto affine = [folded](const void* p) { return folded ? nullptr : static_cast<const bf*>(p); };

  sc::launch_layernorm(x, sc::kBF16, affine(ln1_s), affine(ln1_b), h, M, D, eps, onepass, st);
  cudaError_t err = sc::launch_gemm(h, D, static_cast<const bf*>(wqkv),
                                    static_cast<const bf*>(bqkv), nullptr, sc::kBF16, 0, qkv,
                                    sc::kBF16, 3 * D, M, 3 * D, D, sc::kActNone, st);
  if (err == cudaSuccess) err = attention_step(qkv, attn, N, S, D, H, softmax, folded, st);
  if (err == cudaSuccess)
    err = sc::launch_gemm(attn, D, static_cast<const bf*>(wo), static_cast<const bf*>(bo), x,
                          sc::kBF16, D, ws_mid_x, sc::kF32, D, M, D, D, sc::kActNone, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  sc::launch_layernorm(ws_mid_x, sc::kF32, affine(ln2_s), affine(ln2_b), h, M, D, eps, onepass,
                       st);
  err = sc::launch_gemm(h, D, static_cast<const bf*>(w1), static_cast<const bf*>(b1), nullptr,
                        sc::kBF16, 0, mid, sc::kBF16, Dmid, M, Dmid, D, act, st);
  if (err == cudaSuccess)
    err = sc::launch_gemm(mid, Dmid, static_cast<const bf*>(w2), static_cast<const bf*>(b2),
                          ws_mid_x, sc::kF32, D, out, sc::kBF16, D, M, D, Dmid, sc::kActNone,
                          st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// out = [x +] fc2(act(fc1([LN] x))): x [T, Din] bf16, out [T, Dout] bf16,
// ws_h [T, Din] bf16 (used only with layernorm), ws_mid [T, Dmid] bf16.
extern "C" int sc_fused_ln_mlp(const void* x, const void* ln_s, const void* ln_b,
                               const void* w1, const void* b1, const void* w2, const void* b2,
                               void* out, void* ws_h, void* ws_mid, int T, int Din, int Dmid,
                               int Dout, int act, int layernorm, int residual, float eps,
                               void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const bf* h = static_cast<const bf*>(x);
  if (layernorm) {
    sc::launch_layernorm(x, sc::kBF16, static_cast<const bf*>(ln_s),
                         static_cast<const bf*>(ln_b), static_cast<bf*>(ws_h), T, Din, eps,
                         /*onepass=*/0, st);
    h = static_cast<const bf*>(ws_h);
  }
  cudaError_t err = sc::launch_gemm(h, Din, static_cast<const bf*>(w1),
                                    static_cast<const bf*>(b1), nullptr, sc::kBF16, 0, ws_mid,
                                    sc::kBF16, Dmid, T, Dmid, Din, act, st);
  if (err == cudaSuccess)
    err = sc::launch_gemm(static_cast<const bf*>(ws_mid), Dmid, static_cast<const bf*>(w2),
                          static_cast<const bf*>(b2), residual ? x : nullptr, sc::kBF16, Din,
                          out, sc::kBF16, Dout, T, Dout, Dmid, sc::kActNone, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K13, out = x + O(attn(QKV(LN x))): K1's launch sequence without the MLP
// half, the O GEMM's epilogue adding bo and the residual x and storing bf16.
// clamp selects the TPU kernel's clamp softmax (else exact); folded means the
// LN affine and the q scale dh^-0.5 * log2(e) live in wqkv / bqkv (ln_s /
// ln_b unused), so the scores are in log2 units and the flash loop runs with
// scale ln 2 (exp(s ln 2) = exp2(s), and the clamp at 80 in natural units is
// the TPU kernel's 80 log2(e) in log2 units); onepass selects the one-pass LN
// statistics. x, out: [N * S, D] bf16; ws_h [N*S, D], ws_qkv [N*S, 3D],
// ws_attn [N*S, D] bf16.
extern "C" int sc_fused_ln_attn(const void* x, const void* ln_s, const void* ln_b,
                                const void* wqkv, const void* bqkv, const void* wo,
                                const void* bo, void* out, void* ws_h, void* ws_qkv,
                                void* ws_attn, int N, int S, int D, int H, float eps,
                                int clamp, int folded, int onepass, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int M = N * S;
  auto h = static_cast<bf*>(ws_h);
  auto qkv = static_cast<bf*>(ws_qkv);
  auto attn = static_cast<bf*>(ws_attn);
  sc::launch_layernorm(x, sc::kBF16, folded ? nullptr : static_cast<const bf*>(ln_s),
                       folded ? nullptr : static_cast<const bf*>(ln_b), h, M, D, eps, onepass,
                       st);
  cudaError_t err = sc::launch_gemm(h, D, static_cast<const bf*>(wqkv),
                                    static_cast<const bf*>(bqkv), nullptr, sc::kBF16, 0, qkv,
                                    sc::kBF16, 3 * D, M, 3 * D, D, sc::kActNone, st);
  if (err == cudaSuccess) err = attention_step(qkv, attn, N, S, D, H, clamp, folded, st);
  if (err == cudaSuccess)
    err = sc::launch_gemm(attn, D, static_cast<const bf*>(wo), static_cast<const bf*>(bo), x,
                          sc::kBF16, D, out, sc::kBF16, D, M, D, D, sc::kActNone, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
