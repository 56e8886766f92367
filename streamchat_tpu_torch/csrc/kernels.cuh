// Host-side launchers shared across the translation units of the kernel
// library. fused_vit.cu composes the ViT layer (K1), the LN-MLP (K2) and the
// LN-attention half (K13) from these; each launcher only enqueues work on
// `stream`.
#pragma once

#include "common.cuh"

namespace sc {

// out[M, N] = act(A[M, K] @ B[K, N] + bias) (+ residual), f32 accumulation.
// A rows are `lda` elements apart; B, bias, residual (ldr) and out (ldc) are
// row-major. bias / residual may be null. Shape contract (checked by the
// Python wrappers): N % 128 == 0, K % 32 == 0, lda % 8 == 0, 16-byte
// aligned A and B; M is free (ragged rows are masked).
void launch_gemm(const __nv_bfloat16* A, int64_t lda, const __nv_bfloat16* B,
                 const __nv_bfloat16* bias, const void* residual, int res_dtype,
                 int64_t ldr, void* out, int out_dtype, int64_t ldc, int M, int N,
                 int K, int act, cudaStream_t stream);

// Row LayerNorm with f32 statistics: out = (x - mu) * rsqrt(var + eps) * g + b
// (no affine when gamma is null); onepass takes var = E[x^2] - mu^2.
void launch_layernorm(const void* x, int in_dtype, const __nv_bfloat16* gamma,
                      const __nv_bfloat16* beta, __nv_bfloat16* out, int rows, int D,
                      float eps, int onepass, cudaStream_t stream);

// Online-softmax attention; q/k/v/o are [B, H, S, D] addressed through
// element strides (batch, head, seq); the last dim is contiguous. clamp = 0
// subtracts the running max (exact); clamp = 1 is the TPU ViT kernel's
// "clamp" softmax, p = exp(min(x, 80)) with no running max and the output
// divided by max(l, 1e-30); clamp = 2 is the same with each score rounded to
// bf16 before the clamp and p rounded to bf16 (the layer probe's bf16s).
cudaError_t launch_flash(const __nv_bfloat16* q, const int64_t* qs,
                         const __nv_bfloat16* k, const int64_t* ks,
                         const __nv_bfloat16* v, const int64_t* vs, __nv_bfloat16* o,
                         const int64_t* os, const int* kv_len, int B, int Hq, int Hkv,
                         int Sq, int Sk, int D, int causal, float scale, int clamp,
                         cudaStream_t stream);

// Second pass of a split-K GEMV: y[i] = (sum_s partial[s][i]) (* scale[i % O])
// over i < n * O, summed in slice order (deterministic); scale may be null;
// y is f32 when out_f32, else bf16.
cudaError_t launch_splitk_reduce(const float* partial, int nsplit, int n, int O,
                                 const float* scale, void* y, int out_f32,
                                 cudaStream_t stream);

}  // namespace sc
