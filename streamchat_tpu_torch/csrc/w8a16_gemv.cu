// W8A16 GEMV (W8): y[n, o] = scale[o] * sum_k x[n, k] * w_i8[k, o], for the
// decode regime of the int8 weight-only decoder (N <= 8 rows of bf16 x).
//
// Replaces ops/quant.py:qmatmul's decode path, which has no Pallas source:
// on the TPU the int8 -> bf16 convert rode XLA's dot operand load. At batch 1
// the product is a matrix-vector product, bound by reading the weight once
// (in * out bytes; the 3584 x 18944 gate weight is 68 MB), so the kernel is
// built for HBM bandwidth, not the tensor cores:
// - a warp's 32 lanes read 16 consecutive int8 columns each, one 16-byte
//   load per row, so a warp reads 512 contiguous bytes of a weight row;
// - one block (8 warps) covers 512 output columns over a slice of K; its
//   warps take interleaved rows of the slice, four rows in flight per thread,
//   and sum their partials through shared memory at the end;
// - the K range is split so that a launch has ~2 blocks per SM (132 on the
//   H100) whatever the shape: down (in 18944) gets ~38 slices, the lm_head
//   (out 152064, 297 column tiles) one;
// - bytes are sign-extended in registers and accumulated in f32 against x
//   staged in shared memory as f32 (bf16 x int8 products are exact in f32);
// - with more than one slice, each block writes an f32 partial and a second
//   kernel sums the slices in a fixed order (deterministic: no atomics),
//   applies the per-column scale and stores bf16 (projections) or f32
//   (the logits, as the JAX package computes the int8 head in f32).
#include "kernels.cuh"

namespace sc {
namespace {

constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int CPT = 16;                 // int8 columns per thread (one 16-byte load)
constexpr int TILE = 32 * CPT;          // 512 output columns per block
constexpr int XCHUNK = 256;             // rows of x staged in shared memory at once
constexpr int UNROLL = 4;               // rows in flight per thread

__device__ __forceinline__ void unpack_i8x4(uint32_t w, float* f) {
  f[0] = static_cast<float>(static_cast<int32_t>(w << 24) >> 24);
  f[1] = static_cast<float>(static_cast<int32_t>(w << 16) >> 24);
  f[2] = static_cast<float>(static_cast<int32_t>(w << 8) >> 24);
  f[3] = static_cast<float>(static_cast<int32_t>(w) >> 24);
}

template <int NR>
__device__ __forceinline__ void fma_row(float (&acc)[NR][CPT], const uint4& v,
                                        float (*xs)[XCHUNK], int kk) {
  float f[CPT];
  unpack_i8x4(v.x, f);
  unpack_i8x4(v.y, f + 4);
  unpack_i8x4(v.z, f + 8);
  unpack_i8x4(v.w, f + 12);
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const float xv = xs[r][kk];
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[r][j] = fmaf(xv, f[j], acc[r][j]);
  }
}

// Grid (column tiles, K slices). NR >= n is the row count rounded up to
// 1, 2, 4 or 8; rows past n multiply zeros and are not stored.
template <int NR>
__global__ void __launch_bounds__(THREADS)
w8a16_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
             const float* __restrict__ scale, int n, int K, int O, int slice_rows,
             float* __restrict__ partial, void* __restrict__ y, int out_f32) {
  __shared__ float xs[NR][XCHUNK];
  __shared__ float red[WARPS][TILE];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int col0 = blockIdx.x * TILE;
  const int col = col0 + lane * CPT;
  const bool active = col < O;          // O % 16 == 0: a thread's columns are all in or out
  const int k_begin = blockIdx.y * slice_rows;
  const int k_end = min(K, k_begin + slice_rows);

  float acc[NR][CPT];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[r][j] = 0.0f;

  for (int k0 = k_begin; k0 < k_end; k0 += XCHUNK) {
    const int rows = min(XCHUNK, k_end - k0);
    __syncthreads();                    // the previous chunk's readers are done
    for (int i = tid; i < NR * XCHUNK; i += THREADS) {
      const int r = i / XCHUNK, kk = i % XCHUNK;
      xs[r][kk] = (r < n && kk < rows) ? __bfloat162float(x[(int64_t)r * K + k0 + kk]) : 0.0f;
    }
    __syncthreads();
    if (!active) continue;
    const int8_t* wp = w + (int64_t)k0 * O + col;
    int kk = warp;
    for (; kk + (UNROLL - 1) * WARPS < rows; kk += UNROLL * WARPS) {
      uint4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        v[u] = __ldcs(reinterpret_cast<const uint4*>(wp + (int64_t)(kk + u * WARPS) * O));
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) fma_row<NR>(acc, v[u], xs, kk + u * WARPS);
    }
    for (; kk < rows; kk += WARPS) {
      const uint4 v = __ldcs(reinterpret_cast<const uint4*>(wp + (int64_t)kk * O));
      fma_row<NR>(acc, v, xs, kk);
    }
  }

  // Sum the 8 warps' partials, one input row at a time.
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    if (r >= n) break;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < CPT; ++j) red[warp][lane * CPT + j] = acc[r][j];
    __syncthreads();
    for (int c = tid; c < TILE; c += THREADS) {
      const int o = col0 + c;
      if (o >= O) continue;
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < WARPS; ++i) s += red[i][c];
      if (gridDim.y > 1) {
        partial[((int64_t)blockIdx.y * n + r) * O + o] = s;
      } else {
        store_from_float(y, out_f32 ? kF32 : kBF16, (int64_t)r * O + o, s * scale[o]);
      }
    }
  }
}

__global__ void splitk_reduce_kernel(const float* __restrict__ partial, int nsplit,
                                     int64_t total, int O, const float* __restrict__ scale,
                                     void* __restrict__ y, int out_f32) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.0f;
  for (int p = 0; p < nsplit; ++p) s += partial[p * total + i];
  if (scale) s *= scale[i % O];
  store_from_float(y, out_f32 ? kF32 : kBF16, i, s);
}

template <int NR>
cudaError_t launch_w8(const __nv_bfloat16* x, const int8_t* w, const float* scale, int n,
                      int K, int O, int slice_rows, int nsplit, float* partial, void* y,
                      int out_f32, cudaStream_t stream) {
  const dim3 grid((O + TILE - 1) / TILE, nsplit);
  w8a16_kernel<NR><<<grid, THREADS, 0, stream>>>(x, w, scale, n, K, O, slice_rows, partial,
                                                 y, out_f32);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  return launch_splitk_reduce(partial, nsplit, n, O, scale, y, out_f32, stream);
}

}  // namespace

cudaError_t launch_splitk_reduce(const float* partial, int nsplit, int n, int O,
                                 const float* scale, void* y, int out_f32,
                                 cudaStream_t stream) {
  const int64_t total = (int64_t)n * O;
  const int threads = 256;
  splitk_reduce_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, stream>>>(
      partial, nsplit, total, O, scale, y, out_f32);
  return cudaGetLastError();
}

}  // namespace sc

// x: contiguous bf16 [n, K], n <= 8; w: contiguous int8 [K, O], O % 16 == 0,
// 16-byte aligned; scale: f32 [O]. K is cut into nsplit slices of slice_rows
// rows (a multiple of 8); with nsplit > 1, partial is f32 [nsplit, n, O]
// scratch. y: [n, O], f32 when out_f32, else bf16.
extern "C" int sc_w8a16_gemv(const void* x, const void* w, const void* scale, int n, int K,
                             int O, int slice_rows, int nsplit, void* partial, void* y,
                             int out_f32, void* stream) {
  auto xp = static_cast<const __nv_bfloat16*>(x);
  auto wp = static_cast<const int8_t*>(w);
  auto sp = static_cast<const float*>(scale);
  auto pp = static_cast<float*>(partial);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (n == 1)
    err = sc::launch_w8<1>(xp, wp, sp, n, K, O, slice_rows, nsplit, pp, y, out_f32, st);
  else if (n == 2)
    err = sc::launch_w8<2>(xp, wp, sp, n, K, O, slice_rows, nsplit, pp, y, out_f32, st);
  else if (n <= 4)
    err = sc::launch_w8<4>(xp, wp, sp, n, K, O, slice_rows, nsplit, pp, y, out_f32, st);
  else if (n <= 8)
    err = sc::launch_w8<8>(xp, wp, sp, n, K, O, slice_rows, nsplit, pp, y, out_f32, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
