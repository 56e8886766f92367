// K17: the dot probe, the sum of many bf16 dots into one f32 output tile.
//
// Replaces scripts/probe_vit_variants.py:run_dotk (its kernel `kern`), the
// TPU probe that asks whether a 64-deep contraction (q k^T at head dim 64)
// or a 64-wide output (p v) costs a full 128-wide MXU pass. Four kinds, each
// 2 * 577^2 * 64 * 96 = 4.09 GFLOP:
//   qk (dh 64 or 128): out[S, S]  = sum_i a[i] @ b, a [n, S, dh], b [dh, S];
//   pv (dh 64 or 128): out[S, dh] = sum_i a @ b[i], a [S, S], b [n, S, dh].
// On the H100 the question becomes the tensor-core rate of small mma.sync
// tiles at these depths, so the kernel runs the flash loop's tile loop
// (nvcuda::wmma bf16 16x16x16, issued as mma.sync m16n8k16, f32 accumulators
// in registers) over every dot: nothing sums the operands first. It is bound
// by tensor-core throughput (4.1 us at 989 TFLOP/s; the bytes, at most
// 8.5 MB, take 2.5 us). The TPU ran the dots in order on one core; here a
// block owns one 64-row output tile (by 64 columns for qk, all dh columns for
// pv) and a slice of the dots. The operand every dot of the block shares (b's
// column tile for qk, a's row tile for pv) is loaded into shared memory once;
// the other streams through a two-stage cp.async ring; the slices' f32
// partials are summed by the split-K reduce in a fixed order. The output has
// no pad columns (the TPU probe's 128-lane pad was Mosaic's). A row of S bf16
// (1154 bytes at S = 577) is not 16-byte aligned, so the shared operand is
// loaded element by element, once per block.
#include "kernels.cuh"

namespace sc {
namespace {

using namespace nvcuda;

constexpr int BM = 64, BN = 64, BK = 64, THREADS = 128;   // 4 warps, 16 rows each

using bf = __nv_bfloat16;

// Streams rows [row0, row0 + 64) of a [rows, DH] bf16 matrix into dst
// (leading dim DH + 8), zero-filling rows at and past `rows`.
template <int DH>
__device__ __forceinline__ void load_tile(bf* dst, const bf* src, int row0, int rows, int tid) {
  constexpr int CH = DH / 8, LD = DH + 8;
  for (int c = tid; c < 64 * CH; c += THREADS) {
    const int r = c / CH, col = (c % CH) * 8;
    const bool ok = row0 + r < rows;
    cp_async16(dst + r * LD + col, ok ? src + (int64_t)(row0 + r) * DH + col : src, ok ? 16 : 0);
  }
}

// One warp's 16 x (16 * NF) accumulators -> out rows [gr0, gr0 + 16), columns
// [gc0, ...), masked to rows < S and columns < ncols (ldo = ncols).
template <int NF>
__device__ __forceinline__ void store_acc(wmma::fragment<wmma::accumulator, 16, 16, 16, float>* acc,
                                          float* st, float* out, int gr0, int gc0, int S,
                                          int ncols, int lane) {
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    wmma::store_matrix_sync(st, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int e = t * 32 + lane, gr = gr0 + e / 16, gc = gc0 + j * 16 + e % 16;
      if (gr < S && gc < ncols) out[(int64_t)gr * ncols + gc] = st[e];
    }
    __syncwarp();
  }
}

// qk: block (column tile x, row tile y, dot slice z).
template <int DH>
__global__ void __launch_bounds__(THREADS)
dotk_qk_kernel(const bf* __restrict__ a, const bf* __restrict__ b, float* __restrict__ out,
               int S, int ndots, int dots_per_split) {
  constexpr int A_LD = DH + 8, B_LD = BN + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(32) float stage[THREADS / 32][16 * 16];
  bf* Bs = reinterpret_cast<bf*>(smem);          // [DH][B_LD], b's column tile
  bf* As = Bs + DH * B_LD;                       // [2][BM][A_LD], a[i]'s row tile
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = blockIdx.x * BN, r0 = blockIdx.y * BM;
  const int i0 = blockIdx.z * dots_per_split, i1 = min(ndots, i0 + dots_per_split);

  for (int e = tid; e < DH * BN; e += THREADS) {
    const int k = e / BN, c = e % BN;
    Bs[k * B_LD + c] = c0 + c < S ? b[(int64_t)k * S + c0 + c] : __float2bfloat16(0.0f);
  }
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BN / 16];
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);

  if (i0 < i1) {
    load_tile<DH>(As, a + (int64_t)i0 * S * DH, r0, S, tid);
    cp_async_commit();
  }
  for (int i = i0; i < i1; ++i) {
    const int buf = (i - i0) & 1;
    if (i + 1 < i1) {
      load_tile<DH>(As + (buf ^ 1) * BM * A_LD, a + (int64_t)(i + 1) * S * DH, r0, S, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf* at = As + (buf * BM + warp * 16) * A_LD;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, at + kk * 16, A_LD);
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, Bs + kk * 16 * B_LD + j * 16, B_LD);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();
  }
  store_acc<BN / 16>(acc, stage[warp], out + (int64_t)blockIdx.z * S * S, r0 + warp * 16, c0,
                     S, S, lane);
}

// pv: block (row tile x, -, dot slice z); a's row tile is padded to kp columns.
template <int DH>
__global__ void __launch_bounds__(THREADS)
dotk_pv_kernel(const bf* __restrict__ a, const bf* __restrict__ b, float* __restrict__ out,
               int S, int kp, int ndots, int dots_per_split) {
  constexpr int B_LD = DH + 8;
  const int A_LD = kp + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(32) float stage[THREADS / 32][16 * 16];
  bf* As = reinterpret_cast<bf*>(smem);          // [BM][A_LD], a's row tile
  bf* Bs = As + BM * A_LD;                       // [2][BK][B_LD], a k-chunk of b[i]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = blockIdx.x * BM;
  const int i0 = blockIdx.z * dots_per_split, i1 = min(ndots, i0 + dots_per_split);
  const int nk = kp / BK;

  for (int e = tid; e < BM * kp; e += THREADS) {
    const int r = e / kp, k = e % kp;
    As[r * A_LD + k] = r0 + r < S && k < S ? a[(int64_t)(r0 + r) * S + k]
                                           : __float2bfloat16(0.0f);
  }
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[DH / 16];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);

  // Step t is chunk t % nk of dot i0 + t / nk.
  auto load_b = [&](int buf, int t) {
    load_tile<DH>(Bs + buf * BK * B_LD, b + (int64_t)(i0 + t / nk) * S * DH, (t % nk) * BK, S,
                  tid);
  };
  const int steps = max(0, i1 - i0) * nk;
  if (steps > 0) {
    load_b(0, 0);
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    const int buf = t & 1;
    if (t + 1 < steps) {
      load_b(buf ^ 1, t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf* at = As + warp * 16 * A_LD + (t % nk) * BK;
    const bf* bt = Bs + buf * BK * B_LD;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, at + kk * 16, A_LD);
#pragma unroll
      for (int j = 0; j < DH / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, bt + kk * 16 * B_LD + j * 16, B_LD);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();
  }
  store_acc<DH / 16>(acc, stage[warp], out + (int64_t)blockIdx.z * S * DH, r0 + warp * 16, 0, S,
                     DH, lane);
}

template <int DH>
cudaError_t launch_dotk(const bf* a, const bf* b, float* out, int pv, int S, int ndots,
                        int dots_per_split, int nsplit, cudaStream_t stream) {
  const int tiles = (S + BM - 1) / BM;
  if (pv) {
    const int kp = tiles * BK;
    const size_t bytes = (size_t)(BM * (kp + 8) + 2 * BK * (DH + 8)) * sizeof(bf);
    cudaError_t err = cudaFuncSetAttribute(
        dotk_pv_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    dotk_pv_kernel<DH><<<dim3(tiles, 1, nsplit), THREADS, bytes, stream>>>(
        a, b, out, S, kp, ndots, dots_per_split);
  } else {
    const size_t bytes = (size_t)(DH * (BN + 8) + 2 * BM * (DH + 8)) * sizeof(bf);
    cudaError_t err = cudaFuncSetAttribute(
        dotk_qk_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    dotk_qk_kernel<DH><<<dim3((S + BN - 1) / BN, tiles, nsplit), THREADS, bytes, stream>>>(
        a, b, out, S, ndots, dots_per_split);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace sc

// pv = 0: a [ndots, S, dh], b [dh, S] -> y [S, S]; pv = 1: a [S, S], b
// [ndots, S, dh] -> y [S, dh]. Contiguous bf16 inputs, f32 y. The dots are
// cut into nsplit slices of dots_per_split; with nsplit > 1, partial is f32
// [nsplit, rows of y, columns of y] scratch.
extern "C" int sc_dotk(const void* a, const void* b, void* y, void* partial, int pv, int S,
                       int dh, int ndots, int dots_per_split, int nsplit, void* stream) {
  auto ap = static_cast<const __nv_bfloat16*>(a);
  auto bp = static_cast<const __nv_bfloat16*>(b);
  auto st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(nsplit > 1 ? partial : y);
  cudaError_t err;
  if (dh == 64)
    err = sc::launch_dotk<64>(ap, bp, out, pv, S, ndots, dots_per_split, nsplit, st);
  else if (dh == 128)
    err = sc::launch_dotk<128>(ap, bp, out, pv, S, ndots, dots_per_split, nsplit, st);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess || nsplit == 1) return static_cast<int>(err);
  const int cols = pv ? dh : S;
  return static_cast<int>(sc::launch_splitk_reduce(static_cast<const float*>(partial), nsplit,
                                                   S, cols, nullptr, y, /*out_f32=*/1, st));
}
