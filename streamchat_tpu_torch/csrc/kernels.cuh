// Host-side launchers shared across the translation units of the kernel
// library. fused_vit.cu composes the ViT layer (K1), the LN-MLP (K2) and the
// LN-attention half (K13) from these; each launcher only enqueues work on
// `stream`.
#pragma once

#include "common.cuh"

namespace sc {

// out[M, N] = act(A[M, K] @ B[K, N] + bias) (+ residual), f32 accumulation
// (gemm.cu: wgmma, TMA, one fixed summation order). A rows are `lda`
// elements apart; B, bias, residual (ldr) and out (ldc) are row-major.
// bias / residual may be null. Shape contract (checked by the Python
// wrappers, which raise GemmShapeError before any launch): N % 128 == 0,
// K % 64 == 0, lda % 8 == 0 and lda >= K, ldr and ldc even, 16-byte aligned
// operands; M is free (rows past M are masked). Returns cudaErrorInvalidValue
// for a shape outside it.
cudaError_t launch_gemm(const __nv_bfloat16* A, int64_t lda, const __nv_bfloat16* B,
                        const __nv_bfloat16* bias, const void* residual, int res_dtype,
                        int64_t ldr, void* out, int out_dtype, int64_t ldc, int M, int N,
                        int K, int act, cudaStream_t stream);

// Row LayerNorm with f32 statistics: out = (x - mu) * rsqrt(var + eps) * g + b
// (no affine when gamma is null); onepass takes var = E[x^2] - mu^2.
void launch_layernorm(const void* x, int in_dtype, const __nv_bfloat16* gamma,
                      const __nv_bfloat16* beta, __nv_bfloat16* out, int rows, int D,
                      float eps, int onepass, cudaStream_t stream);

// Non-causal attention of the ViT (K1, K13, K14, K16) on the Hopper prefill
// kernel (flash_prefill.cu): q/k/v/o are [B, H, S, D] addressed through
// element strides (batch, head, seq; the last dim contiguous), every key
// valid. softmax 0 (kSoftmaxExact) subtracts the running max; 1
// (kSoftmaxClamp) is the TPU ViT kernel's "clamp" softmax, p = exp(min(x, 80))
// with no running max and the output divided by max(l, 1e-30); 2
// (kSoftmaxBf16S) is the same with each score rounded to bf16 before the
// clamp and p rounded to bf16 (the layer probe's bf16s). x = s * scale;
// scale_log2 is scale * log2(e), passed apart so that folded weights (scale
// ln 2) take exactly 1.
cudaError_t launch_vit_attention(const __nv_bfloat16* q, const int64_t* qs,
                                 const __nv_bfloat16* k, const int64_t* ks,
                                 const __nv_bfloat16* v, const int64_t* vs, __nv_bfloat16* o,
                                 const int64_t* os, int B, int H, int Sq, int Sk, int D,
                                 float scale, float scale_log2, int softmax,
                                 cudaStream_t stream);

// Second pass of a split-K GEMV: y[i] = (sum_s partial[s][i]) (* scale[i % O])
// over i < n * O, summed in slice order (deterministic); scale may be null;
// y is f32 when out_f32, else bf16.
cudaError_t launch_splitk_reduce(const float* partial, int nsplit, int n, int O,
                                 const float* scale, void* y, int out_f32,
                                 cudaStream_t stream);

}  // namespace sc
