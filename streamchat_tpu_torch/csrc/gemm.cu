// bf16 GEMM with a fused bias / activation / residual epilogue.
//
// Replaces the matrix products inside the TPU kernels of ops/fused_vit.py:
// fused_vit_layer (_layer_kernel: QKV, O + residual, fc1 + quick_gelu,
// fc2 + residual) and fused_ln_mlp (_mlp_kernel: the projector's
// fc1 + erf-GELU and fc2). On the TPU those products ran on the MXU with the
// weights resident in VMEM; on the H100 they are compute-bound at ViT-L
// ingest shapes (M = N*577 rows, K and N of 1024-4096), so the kernel puts
// them on the tensor cores: 128x128 output tiles, 32-deep k-steps,
// nvcuda::wmma bf16 16x16x16 fragments with f32 accumulation, and a
// two-stage cp.async ring in shared memory so the next k-slab loads while
// the current one multiplies. The epilogue applies bias, activation and
// residual in registers, so the [M, N] pre-activation never reaches device
// memory. wgmma/TMA and warp specialisation are left for later work.
#include "kernels.cuh"

namespace sc {
namespace {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int A_LD = BK + 8;   // padded leading dims (multiples of 8 bf16)
constexpr int B_LD = BN + 8;
constexpr int THREADS = 256;   // 8 warps: 2 (rows) x 4 (cols), 64x32 each

using namespace nvcuda;

__device__ __forceinline__ float activate(float x, int act) {
  if (act == kActQuickGelu) return x / (1.0f + expf(-1.702f * x));
  if (act == kActGelu) return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
  return x;
}

__global__ void __launch_bounds__(THREADS)
gemm_kernel(const __nv_bfloat16* __restrict__ A, int64_t lda,
            const __nv_bfloat16* __restrict__ B, const __nv_bfloat16* __restrict__ bias,
            const void* __restrict__ residual, int res_dtype, int64_t ldr,
            void* __restrict__ out, int out_dtype, int64_t ldc, int M, int N, int K,
            int act) {
  __shared__ __align__(128) __nv_bfloat16 As[2][BM * A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[2][BK * B_LD];
  __shared__ __align__(128) float stage[THREADS / 32][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int warp_m = warp / 4, warp_n = warp % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  auto load_tile = [&](int buf, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {            // A: 128 rows x 4 chunks of 8
      int c = tid + i * THREADS;
      int r = c / 4, col = (c % 4) * 8;
      int gr = m0 + r;
      const __nv_bfloat16* src = gr < M ? A + (int64_t)gr * lda + k0 + col : A;
      cp_async16(&As[buf][r * A_LD + col], src, gr < M ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {            // B: 32 rows x 16 chunks of 8
      int c = tid + i * THREADS;
      int r = c / 16, col = (c % 16) * 8;
      const __nv_bfloat16* src = B + (int64_t)(k0 + r) * N + n0 + col;
      cp_async16(&Bs[buf][r * B_LD + col], src, 16);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int kt_total = K / BK;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < kt_total; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < kt_total) {
      load_tile(buf ^ 1, (kt + 1) * BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], &As[buf][(warp_m * 64 + i * 16) * A_LD + kk], A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[buf][kk * B_LD + warp_n * 32 + j * 16], B_LD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* st = stage[warp];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        int e = t * 32 + lane;
        int r = e / 16, c = e % 16;
        int gr = m0 + warp_m * 64 + i * 16 + r;
        int gc = n0 + warp_n * 32 + j * 16 + c;
        if (gr < M) {
          float v = st[e];
          if (bias) v += __bfloat162float(bias[gc]);
          v = activate(v, act);
          if (residual) v += load_as_float(residual, res_dtype, (int64_t)gr * ldr + gc);
          store_from_float(out, out_dtype, (int64_t)gr * ldc + gc, v);
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace

void launch_gemm(const __nv_bfloat16* A, int64_t lda, const __nv_bfloat16* B,
                 const __nv_bfloat16* bias, const void* residual, int res_dtype,
                 int64_t ldr, void* out, int out_dtype, int64_t ldc, int M, int N,
                 int K, int act, cudaStream_t stream) {
  dim3 grid(N / BN, (M + BM - 1) / BM);
  gemm_kernel<<<grid, THREADS, 0, stream>>>(A, lda, B, bias, residual, res_dtype, ldr,
                                            out, out_dtype, ldc, M, N, K, act);
}

}  // namespace sc
