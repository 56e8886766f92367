// int4 weight-only GEMV over column-half nibble-packed weights: K10 (one
// weight) and K11 (2-3 weights sharing x, one launch).
//
// Replaces ops/int4_matmul.py:qmatvec_int4 (K10, _kernel) and
// qmatvec_int4_fused (K11, _kernel_fused). Storage (ops/quant.py
// quantize_weight_int4): byte (i, j) of w_i4p [in, out/2] holds w[i, j] in
// its low nibble and w[i, j + out/2] in its high nibble; scale [in/128, 2,
// out/2] f32 is one scale per (128-row group, output column). The result is
// y[n, j] = sum_g scale[g, j] * (sum_{i in g} x[n, i] * w[i, j]), each group's
// partial scaled in f32 before it accumulates, as in the TPU kernel.
//
// At decode (N <= 8 rows) the product is bound by reading the packed bytes
// (in * out / 2: half of int8's). Design:
// - a block (8 warps) covers 128 packed columns, i.e. 256 outputs (both
//   halves), over a slice of whole groups; each lane reads 4 packed bytes
//   (one 32-bit load) per row, so a warp reads 128 contiguous bytes of a row;
// - each byte is read once and feeds two outputs: the low nibble is
//   sign-extended as ((b & 15) ^ 8) - 8, the high one by an arithmetic shift
//   (the TPU's xor / bf16-dot algebra was a VPU trick and is not carried
//   over);
// - the 8 warps split a group's 128 rows (16 each, all loads in flight); the
//   group partial is summed across warps in shared memory and multiplied by
//   its scale there, so the scale never meets a partial of another group;
// - the group range is split so that a launch has ~2 blocks per SM, and the
//   slices are summed by a second kernel in a fixed order (deterministic);
// - K11 gives each part its own range of column tiles in one grid; the
//   parts' pointers and widths are kernel arguments (no descriptor copy to
//   the device), and a narrow k/v part is masked at its edge.
#include "kernels.cuh"

namespace sc {
namespace {

constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int GROUP = 128;               // rows per scale group
constexpr int WARP_ROWS = GROUP / WARPS; // rows of a group per warp
constexpr int CPT = 4;                   // packed bytes per thread (one 32-bit load)
constexpr int TILE = 32 * CPT;           // 128 packed columns = 256 outputs per block
constexpr int MAX_PARTS = 3;

// Up to three weights sharing x; tile_end[p] is the first column tile past
// part p, col_off[p] the part's first column in the [n, sum out] output.
struct Parts {
  const int8_t* w[MAX_PARTS];
  const float* scale[MAX_PARTS];
  int oh[MAX_PARTS];
  int tile_end[MAX_PARTS];
  int col_off[MAX_PARTS];
  int nparts;
};

template <int NR>
__global__ void __launch_bounds__(THREADS)
int4_gemv_kernel(const __nv_bfloat16* __restrict__ x, int n, int K, Parts parts,
                 int groups_per_slice, int out_cols, float* __restrict__ partial,
                 void* __restrict__ y, int out_f32) {
  __shared__ float xs[NR][GROUP];
  __shared__ float red[WARPS][2 * TILE];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  int p = 0;
  if (parts.nparts > 1 && (int)blockIdx.x >= parts.tile_end[0]) p = 1;
  if (parts.nparts > 2 && (int)blockIdx.x >= parts.tile_end[1]) p = 2;
  const int8_t* w = p == 0 ? parts.w[0] : (p == 1 ? parts.w[1] : parts.w[2]);
  const float* scale = p == 0 ? parts.scale[0] : (p == 1 ? parts.scale[1] : parts.scale[2]);
  const int oh = p == 0 ? parts.oh[0] : (p == 1 ? parts.oh[1] : parts.oh[2]);
  const int col_off = p == 0 ? parts.col_off[0] : (p == 1 ? parts.col_off[1] : parts.col_off[2]);
  const int tile0 = p == 0 ? 0 : (p == 1 ? parts.tile_end[0] : parts.tile_end[1]);

  const int pc0 = (blockIdx.x - tile0) * TILE;     // the block's first packed column
  const int pc = pc0 + lane * CPT;                 // this thread's packed columns
  const bool active = pc < oh;                     // oh % 4 == 0
  // In the reduction, thread tid owns output tid of the tile: the low half
  // for tid < TILE, the high half after.
  const int half = tid / TILE, out_pc = pc0 + tid % TILE;
  const bool out_valid = out_pc < oh;

  const int G = K / GROUP;
  const int g_begin = blockIdx.y * groups_per_slice;
  const int g_end = min(G, g_begin + groups_per_slice);

  float acc[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) acc[r] = 0.0f;

  for (int g = g_begin; g < g_end; ++g) {
    for (int i = tid; i < NR * GROUP; i += THREADS) {
      const int r = i / GROUP, kk = i % GROUP;
      xs[r][kk] = r < n ? __bfloat162float(x[(int64_t)r * K + g * GROUP + kk]) : 0.0f;
    }
    __syncthreads();

    float part_lo[NR][CPT], part_hi[NR][CPT];
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int j = 0; j < CPT; ++j) part_lo[r][j] = part_hi[r][j] = 0.0f;
    if (active) {
      const int row0 = g * GROUP + warp * WARP_ROWS;
      uint32_t words[WARP_ROWS];
#pragma unroll
      for (int i = 0; i < WARP_ROWS; ++i)
        words[i] = __ldcs(reinterpret_cast<const unsigned int*>(
            w + (int64_t)(row0 + i) * oh + pc));
#pragma unroll
      for (int i = 0; i < WARP_ROWS; ++i) {
        float lo[CPT], hi[CPT];
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int b = static_cast<int32_t>(words[i] << (24 - 8 * j)) >> 24;  // signed byte
          lo[j] = static_cast<float>(((b & 0xF) ^ 8) - 8);
          hi[j] = static_cast<float>(b >> 4);
        }
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          const float xv = xs[r][warp * WARP_ROWS + i];
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            part_lo[r][j] = fmaf(xv, lo[j], part_lo[r][j]);
            part_hi[r][j] = fmaf(xv, hi[j], part_hi[r][j]);
          }
        }
      }
    }

    // The group partial: sum the warps, scale, accumulate (one row at a time).
    const float s = out_valid ? scale[((int64_t)g * 2 + half) * oh + out_pc] : 0.0f;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      if (r >= n) break;
      __syncthreads();                  // red (and, for r = 0, xs) readers are done
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        red[warp][lane * CPT + j] = part_lo[r][j];
        red[warp][TILE + lane * CPT + j] = part_hi[r][j];
      }
      __syncthreads();
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < WARPS; ++i) sum += red[i][tid];
      acc[r] = fmaf(sum, s, acc[r]);
    }
    __syncthreads();                    // red and xs are free for the next group
  }

  if (!out_valid) return;
  const int col = col_off + half * oh + out_pc;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    if (r >= n) break;
    if (gridDim.y > 1) {
      partial[((int64_t)blockIdx.y * n + r) * out_cols + col] = acc[r];
    } else {
      store_from_float(y, out_f32 ? kF32 : kBF16, (int64_t)r * out_cols + col, acc[r]);
    }
  }
}

template <int NR>
cudaError_t launch_int4(const __nv_bfloat16* x, int n, int K, const Parts& parts,
                        int groups_per_slice, int nsplit, int out_cols, float* partial,
                        void* y, int out_f32, cudaStream_t stream) {
  const dim3 grid(parts.tile_end[parts.nparts - 1], nsplit);
  int4_gemv_kernel<NR><<<grid, THREADS, 0, stream>>>(x, n, K, parts, groups_per_slice,
                                                     out_cols, partial, y, out_f32);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  return launch_splitk_reduce(partial, nsplit, n, out_cols, nullptr, y, out_f32, stream);
}

}  // namespace
}  // namespace sc

// x: contiguous bf16 [n, K], n <= 8, K % 128 == 0. Part p (p < nparts <= 3):
// w_p contiguous int8 [K, oh_p] (oh_p % 4 == 0, 4-byte aligned), scale_p f32
// [K / 128, 2, oh_p]. y: [n, sum_p 2 oh_p] (f32 when out_f32, else bf16), part
// p at columns [off_p, off_p + 2 oh_p), off_p = sum_{q < p} 2 oh_q. The groups
// are cut into nsplit slices of groups_per_slice; with nsplit > 1, partial is
// f32 [nsplit, n, sum_p 2 oh_p] scratch.
extern "C" int sc_int4_gemv(const void* x, int n, int K, int nparts, const void* w0,
                            const void* s0, int oh0, const void* w1, const void* s1, int oh1,
                            const void* w2, const void* s2, int oh2, int groups_per_slice,
                            int nsplit, void* partial, void* y, int out_f32, void* stream) {
  if (nparts < 1 || nparts > sc::MAX_PARTS || K % sc::GROUP)
    return static_cast<int>(cudaErrorInvalidValue);
  sc::Parts parts{};
  const void* ws[3] = {w0, w1, w2};
  const void* ss[3] = {s0, s1, s2};
  const int ohs[3] = {oh0, oh1, oh2};
  int tiles = 0, cols = 0;
  for (int p = 0; p < nparts; ++p) {
    parts.w[p] = static_cast<const int8_t*>(ws[p]);
    parts.scale[p] = static_cast<const float*>(ss[p]);
    parts.oh[p] = ohs[p];
    parts.col_off[p] = cols;
    tiles += (ohs[p] + sc::TILE - 1) / sc::TILE;
    parts.tile_end[p] = tiles;
    cols += 2 * ohs[p];
  }
  parts.nparts = nparts;
  auto xp = static_cast<const __nv_bfloat16*>(x);
  auto pp = static_cast<float*>(partial);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (n == 1)
    err = sc::launch_int4<1>(xp, n, K, parts, groups_per_slice, nsplit, cols, pp, y, out_f32, st);
  else if (n == 2)
    err = sc::launch_int4<2>(xp, n, K, parts, groups_per_slice, nsplit, cols, pp, y, out_f32, st);
  else if (n <= 4)
    err = sc::launch_int4<4>(xp, n, K, parts, groups_per_slice, nsplit, cols, pp, y, out_f32, st);
  else if (n <= 8)
    err = sc::launch_int4<8>(xp, n, K, parts, groups_per_slice, nsplit, cols, pp, y, out_f32, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
