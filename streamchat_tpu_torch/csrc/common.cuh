// Shared helpers for the hand-written Hopper kernels (sm_90a).
//
// Every kernel here is built by streamchat_tpu_torch/kernels/build.py into one
// shared library with a plain C interface (loaded through ctypes). Each
// exported `sc_*` function launches on the caller's stream and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sc {

// Element types a wrapper may pass for an input/output that is not fixed bf16.
enum DType : int { kBF16 = 0, kF32 = 1 };

// GEMM epilogue activations (ops/fused_vit._activate).
enum Act : int { kActNone = 0, kActQuickGelu = 1, kActGelu = 2 };

// The ViT attention's softmax modes (ops/fused_vit.SOFTMAX).
enum Softmax : int { kSoftmaxExact = 0, kSoftmaxClamp = 1, kSoftmaxBf16S = 2 };

__device__ __forceinline__ float load_as_float(const void* p, int dtype, int64_t i) {
  return dtype == kF32 ? static_cast<const float*>(p)[i]
                       : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

__device__ __forceinline__ void store_from_float(void* p, int dtype, int64_t i, float v) {
  if (dtype == kF32) {
    static_cast<float*>(p)[i] = v;
  } else {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  }
}

// 16-byte global->shared async copy; src_bytes == 0 zero-fills the
// destination (used for rows past the ragged edge).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace sc
