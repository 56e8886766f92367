// Row LayerNorm with f32 statistics (LN1 and LN2 of the ViT layer, the LN of
// the LN-attention half).
//
// Replaces the `_ln_f32` passes inside the TPU kernels
// ops/fused_vit.py:fused_vit_layer and fused_ln_attn (_attn_body /
// _layer_kernel). On the H100 a 1024-wide row LayerNorm is bound by device
// memory bandwidth (one read of x, one bf16 write), so the kernel gives each
// row to one warp, keeps the statistics in registers and reads the row from
// L1 for the centred second pass and the output pass; the input may be the
// bf16 residual stream or the f32 mid-layer residual (mid_x), and the output
// is the bf16 operand of the following tensor-core GEMM. `onepass` takes the
// variance as E[x^2] - E[x]^2 from the first pass (the TPU kernel's
// ln_onepass); a null gamma skips the affine (the folded form, whose affine
// lives in the following GEMM's weights).
#include "kernels.cuh"

namespace sc {
namespace {

constexpr int ROWS_PER_BLOCK = 8;

__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
layernorm_kernel(const void* __restrict__ x, int in_dtype,
                 const __nv_bfloat16* __restrict__ gamma,
                 const __nv_bfloat16* __restrict__ beta, __nv_bfloat16* __restrict__ out,
                 int rows, int D, float eps, int onepass) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROWS_PER_BLOCK + warp;
  if (row >= rows) return;
  const int64_t base = (int64_t)row * D;
  float sum = 0.0f, sq = 0.0f;
  for (int d = lane; d < D; d += 32) {
    const float v = load_as_float(x, in_dtype, base + d);
    sum += v;
    sq += v * v;
  }
  const float mu = warp_sum(sum) / D;
  float var;
  if (onepass) {
    var = warp_sum(sq) / D - mu * mu;
  } else {
    sq = 0.0f;
    for (int d = lane; d < D; d += 32) {
      float c = load_as_float(x, in_dtype, base + d) - mu;
      sq += c * c;
    }
    var = warp_sum(sq) / D;
  }
  const float rstd = rsqrtf(var + eps);
  for (int d = lane; d < D; d += 32) {
    float y = (load_as_float(x, in_dtype, base + d) - mu) * rstd;
    if (gamma) y = y * __bfloat162float(gamma[d]) + __bfloat162float(beta[d]);
    out[base + d] = __float2bfloat16(y);
  }
}

}  // namespace

void launch_layernorm(const void* x, int in_dtype, const __nv_bfloat16* gamma,
                      const __nv_bfloat16* beta, __nv_bfloat16* out, int rows, int D,
                      float eps, int onepass, cudaStream_t stream) {
  dim3 grid((rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  layernorm_kernel<<<grid, ROWS_PER_BLOCK * 32, 0, stream>>>(x, in_dtype, gamma, beta, out,
                                                            rows, D, eps, onepass);
}

}  // namespace sc
