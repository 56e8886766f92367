// K10 / K11 on Hopper: the int4 weight-only GEMV over column-half
// nibble-packed weights, on the tensor cores. K10 is one weight, K11 two or
// three weights sharing x in one launch.
//
// Replaces streamchat_tpu/ops/int4_matmul.py:qmatvec_int4 (K10, _kernel) and
// qmatvec_int4_fused (K11, _kernel_fused). Storage (ops/quant.py
// quantize_weight_int4): byte (i, j) of w_i4p [in, out/2] holds w[i, j] in
// its low nibble and w[i, j + out/2] in its high nibble; scale [in/128, 2,
// out/2] f32 is one scale per (128-row group, output column). The result is
// y[r, j] = sum_g scale[g, j] * (sum_{i in g} x[r, i] * w[i, j]), each group's
// partial scaled in f32 before it accumulates, as in the TPU kernel.
//
// What bounds it: reading the packed bytes and their scales (LongVA-7B's
// gate/up pair 72 MB, 21.5 us at 3.35 TB/s). At n <= 8 rows the products are
// few, but unpacking every nibble and 2n FMAs a byte on the CUDA cores are
// not, and the loads must stay in flight while they run. Design:
// - The grid is counted in Python (ops/int4_matmul.launch_plan): each part's
//   packed columns are cut into 64-column tiles, each tile's groups into C
//   near-equal ranges, one block each, the C blocks of a tile one
//   thread-block cluster (C a power of two <= 8, the same for every part, as
//   large as keeps the blocks within one resident wave of 4 x 132), and a
//   block's range into its 4 warps' ranges of whole groups.
// - A warp owns 64 packed columns (128 outputs) over whole groups, and a
//   ring of 4 chunks of 16 rows (4 KB) in shared memory, filled by cp.async
//   (16-byte pieces; 4-byte ones, and 3 blocks an SM, for a width not a
//   multiple of 16), one commit group a chunk: chunk k + 4 is copied as
//   soon as chunk k is read, so the copies in flight do not depend on n and
//   hold no registers. x's 16 values of each of its n rows ride with each
//   chunk (the B fragment, read from shared memory: a load through L1 a
//   chunk ahead left every chunk waiting on L2), a group's column scales
//   with its chunk 0.
// - The products run on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//   out) with the weights as A (swap-AB): lane (g, t) = (lane / 4, lane %
//   4) reads packed columns 8g..8g+7 of rows 4t..4t+3 of a chunk; the low and
//   high nibbles of a column are M rows g and g + 8, the chunk's 16 rows are
//   K (rows 4t, 4t+1, 4t+2, 4t+3 are K 2t, 2t+1, 2t+8, 2t+9), x's rows are
//   N (rows at n and past are zero). One byte permute pairs two rows' bytes
//   of a column; after an xor with 0x88 every nibble is v + 8, (u & 15) |
//   0x4300 is the bf16 128 + v + 8, and a bf16x2 subtract of 136 leaves v in
//   -8..7. All exact, so is every product with bf16 x.
// - A group's f32 fragment is scaled in registers and added to the lane's
//   running sums, kept in shared memory (each lane its own 32 words), which
//   leaves 124 registers: 4 blocks an SM, no spills.
// - At the end the block's warps are summed in warp order, then the
//   cluster's ranks through distributed shared memory in rank order, rank r
//   writing its share of the tile. No atomics and no second launch: two
//   launches give equal bits.
#include <cooperative_groups.h>

#include "kernels.cuh"

namespace sc {
namespace {

namespace cg = cooperative_groups;

constexpr int GROUP = 128, CHUNK = 16, CHUNKS = GROUP / CHUNK;
constexpr int TILE = 64;                       // packed columns a block (and a warp) covers
constexpr int WARPS = 4, THREADS = 32 * WARPS;
// Blocks an SM (ops/int4_matmul.RESIDENT_BLOCKS): 4 for the 16-byte copies,
// 3 for the 4-byte ones (more address registers).
constexpr int RESIDENT = 4, RESIDENT_NARROW = 3;
constexpr int MAX_PARTS = 3, MAX_CLUSTER = 8, MAX_ROWS = 8;
constexpr int CHUNK_BYTES = CHUNK * TILE;      // 1 KB: a warp's chunk
constexpr int LANE_SUMS = 8 * 4;               // a lane's running sums: 8 columns x 4
constexpr int RING = 4;                        // chunks in flight a warp (half a group)

// Up to three weights sharing x; tile_end[p] is the first column tile past
// part p, col_off[p] the part's first column in the [n, sum 2 oh] output.
struct Parts {
  const int8_t* w[MAX_PARTS];
  const float* scale[MAX_PARTS];
  int oh[MAX_PARTS];
  int tile_end[MAX_PARTS];
  int col_off[MAX_PARTS];
  int nparts;
};

// A warp's shared memory: its ring of chunks (row r of a chunk at (r % 4) *
// 256 + (r / 4) * 64: lane (g, t)'s four rows are 256 bytes apart and a
// warp's read of one is 256 contiguous bytes) with x's 16 values of each
// row for each chunk, its column scales of two groups (low half, then high)
// and its lanes' running sums (word k of lane l at sums[k][l]).
struct WarpSmem {
  uint8_t ring[RING][CHUNK_BYTES];
  __nv_bfloat16 xs[RING][MAX_ROWS][CHUNK];
  float scale[2][2][TILE];
  float sums[LANE_SUMS][32];
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

// Copies one piece (16 bytes, 4 when !WIDE) from src to dst, zero-filling
// when !valid (src then falls back to `safe`, which is never read).
template <bool WIDE>
__device__ __forceinline__ void copy_piece(void* dst, const void* src, bool valid,
                                           const void* safe) {
  if constexpr (WIDE) cp_async16(dst, valid ? src : safe, valid ? 16 : 0);
  else cp_async4(dst, valid ? src : safe, valid ? 4 : 0);
}

// Chunk j of group grp of the warp's tile (columns pc0.., width oh) into
// `ring`, x's n rows over it into `xs`, and with chunk 0 the group's scales
// into `sc`; lane `lane`'s share.
template <bool WIDE>
__device__ __forceinline__ void copy_chunk(uint8_t* ring, __nv_bfloat16 (*xs)[CHUNK],
                                           float (*sc)[TILE], const int8_t* w,
                                           const float* scale, const __nv_bfloat16* x, int n,
                                           int K, int oh, int pc0, int grp, int j, int lane) {
  const int row0 = grp * GROUP + j * CHUNK;
  if (lane < 2 * n)   // x row lane / 2, half lane % 2: 16 bytes
    cp_async16(&xs[lane / 2][8 * (lane % 2)], x + (int64_t)(lane / 2) * K + row0 + 8 * (lane % 2),
               16);
  const int8_t* rows = w + (int64_t)row0 * oh + pc0;
  constexpr int PIECE = WIDE ? 16 : 4, PER_ROW = TILE / PIECE;
#pragma unroll
  for (int q = lane; q < CHUNK * PER_ROW; q += 32) {
    const int r = q / PER_ROW, col = (q % PER_ROW) * PIECE;
    copy_piece<WIDE>(ring + (r % 4) * 256 + (r / 4) * 64 + col, rows + (int64_t)r * oh + col,
                     pc0 + col < oh, w);
  }
  if (j == 0) {
    const float* s = scale + (int64_t)grp * 2 * oh + pc0;
    constexpr int SPIECE = PIECE / 4, PER_HALF = TILE / SPIECE;
#pragma unroll
    for (int q = lane; q < 2 * PER_HALF; q += 32) {
      const int h = q / PER_HALF, col = (q % PER_HALF) * SPIECE;
      copy_piece<WIDE>(&sc[h][col], s + (int64_t)h * oh + col, pc0 + col < oh, scale);
    }
  }
}

// Bytes 0 and 2 of u carry v + 8 in their low nibbles -> the bf16 pair v.
__device__ __forceinline__ unsigned nibble_pair(unsigned u) {
  unsigned p = (u & 0x000F000Fu) | 0x43004300u;
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<__nv_bfloat162*>(&p), __float2bfloat162_rn(136.0f));
  return *reinterpret_cast<const unsigned*>(&r);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool WIDE>
__global__ void __launch_bounds__(THREADS, WIDE ? RESIDENT : RESIDENT_NARROW)
int4_gemv_kernel(const __nv_bfloat16* __restrict__ x, int n, int K, Parts parts, int C,
                 void* __restrict__ y, int out_cols, int out_f32) {
  extern __shared__ __align__(16) WarpSmem smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, lg = lane / 4, lt = lane % 4;
  const int rank = blockIdx.x % C, tile = blockIdx.x / C;
  const int p = (parts.nparts > 1 && tile >= parts.tile_end[0])
                    ? ((parts.nparts > 2 && tile >= parts.tile_end[1]) ? 2 : 1)
                    : 0;
  const int8_t* w = p == 0 ? parts.w[0] : (p == 1 ? parts.w[1] : parts.w[2]);
  const float* scale = p == 0 ? parts.scale[0] : (p == 1 ? parts.scale[1] : parts.scale[2]);
  const int oh = p == 0 ? parts.oh[0] : (p == 1 ? parts.oh[1] : parts.oh[2]);
  const int col_off = p == 0 ? parts.col_off[0] : (p == 1 ? parts.col_off[1] : parts.col_off[2]);
  const int tile0 = p == 0 ? 0 : (p == 1 ? parts.tile_end[0] : parts.tile_end[1]);

  const int G = K / GROUP;
  const int g0 = rank * G / C, g1 = (rank + 1) * G / C;                  // the block's groups
  const int wg0 = g0 + warp * (g1 - g0) / WARPS, wg1 = g0 + (warp + 1) * (g1 - g0) / WARPS;
  const int pc0 = (tile - tile0) * TILE;                                 // the tile's first column
  WarpSmem& ws = smem[warp];

  // The ring holds half a group: chunk j + RING is copied as soon as chunk j
  // is read (chunk j - RING of the next group for j >= RING), one commit
  // group per chunk.
  if (wg0 < wg1) {
#pragma unroll
    for (int j = 0; j < RING; ++j) {
      copy_chunk<WIDE>(ws.ring[j], ws.xs[j], ws.scale[wg0 & 1], w, scale, x, n, K, oh, pc0, wg0,
                       j, lane);
      cp_async_commit();
    }
  }
#pragma unroll
  for (int k = 0; k < LANE_SUMS; ++k) ws.sums[k][lane] = 0.0f;

  for (int grp = wg0; grp < wg1; ++grp) {
    float acc[8][4];
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.0f;
    const bool more = grp + 1 < wg1;
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) {
      const int slot = j % RING;
      cp_async_wait<RING - 1>();
      __syncwarp();
      // x's row lg as the B fragment's column (rows at n and past are zero):
      // its values at lane t's 4 rows of the chunk.
      uint2 xb = make_uint2(0u, 0u);
      if (lg < n) xb = *reinterpret_cast<const uint2*>(&ws.xs[slot][lg][4 * lt]);
      unsigned wv[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint2 v =
            *reinterpret_cast<const uint2*>(ws.ring[slot] + i * 256 + lt * 64 + 8 * lg);
        wv[i][0] = v.x ^ 0x88888888u;   // every nibble v -> v + 8
        wv[i][1] = v.y ^ 0x88888888u;
      }
      __syncwarp();
      if (j + RING < CHUNKS)
        copy_chunk<WIDE>(ws.ring[slot], ws.xs[slot], ws.scale[grp & 1], w, scale, x, n, K, oh,
                         pc0, grp, j + RING, lane);
      else if (more)
        copy_chunk<WIDE>(ws.ring[slot], ws.xs[slot], ws.scale[(grp + 1) & 1], w, scale, x, n, K,
                         oh, pc0, grp + 1, j + RING - CHUNKS, lane);
      cp_async_commit();
      const unsigned b0 = xb.x, b1 = xb.y;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        // Byte c % 4 of word c / 4: rows 0 and 1 into bytes 0 and 2 (K 2t,
        // 2t + 1), rows 2 and 3 likewise (K 2t + 8, 2t + 9).
        const unsigned sel = (c % 4) | ((4 + c % 4) << 8);
        const unsigned p01 = __byte_perm(wv[0][c / 4], wv[1][c / 4], sel);
        const unsigned p23 = __byte_perm(wv[2][c / 4], wv[3][c / 4], sel);
        const unsigned a[4] = {nibble_pair(p01), nibble_pair(p01 >> 4), nibble_pair(p23),
                               nibble_pair(p23 >> 4)};
        mma_bf16(acc[c], a, b0, b1);
      }
    }
    // acc[c] = {lo row 2t, lo row 2t + 1, hi row 2t, hi row 2t + 1} of column
    // pc0 + 8 lg + c: scaled by the group's scales (landed with its chunk 0),
    // then added to the running sums.
    const float* s = ws.scale[grp & 1][0] + 8 * lg;
    const float4 lo0 = *reinterpret_cast<const float4*>(s);
    const float4 lo1 = *reinterpret_cast<const float4*>(s + 4);
    const float4 hi0 = *reinterpret_cast<const float4*>(s + TILE);
    const float4 hi1 = *reinterpret_cast<const float4*>(s + TILE + 4);
    const float s_lo[8] = {lo0.x, lo0.y, lo0.z, lo0.w, lo1.x, lo1.y, lo1.z, lo1.w};
    const float s_hi[8] = {hi0.x, hi0.y, hi0.z, hi0.w, hi1.x, hi1.y, hi1.z, hi1.w};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      ws.sums[4 * c + 0][lane] += acc[c][0] * s_lo[c];
      ws.sums[4 * c + 1][lane] += acc[c][1] * s_lo[c];
      ws.sums[4 * c + 2][lane] += acc[c][2] * s_hi[c];
      ws.sums[4 * c + 3][lane] += acc[c][3] * s_hi[c];
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp's sums are in; the rings are drained

  // The block's warps, summed in warp order: output e of the tile is row
  // e / 128, half (e / 64) % 2, packed column pc0 + e % 64.
  float* tile_sum = reinterpret_cast<float*>(smem[0].ring);             // [n][2][TILE]
  const int outs = n * 2 * TILE;
  for (int e = tid; e < outs; e += THREADS) {
    const int r = e / (2 * TILE), h = (e / TILE) % 2, col = e % TILE;
    const int k = 4 * (col % 8) + 2 * h + r % 2, l = 4 * (col / 8) + r / 2;
    float v = 0.0f;
#pragma unroll
    for (int q = 0; q < WARPS; ++q) v += smem[q].sums[k][l];
    tile_sum[e] = v;
  }
  // The cluster's ranks, summed in rank order; rank r writes its share.
  cg::cluster_group cluster = cg::this_cluster();
  if (C > 1) cluster.sync(); else __syncthreads();
  const int share = (outs + C - 1) / C, e1 = min(outs, (rank + 1) * share);
  const int dtype = out_f32 ? kF32 : kBF16;
  for (int e = rank * share + tid; e < e1; e += THREADS) {
    float v = tile_sum[e];
    if (C > 1) {
      v = 0.0f;
      for (int q = 0; q < C; ++q) v += cluster.map_shared_rank(tile_sum, q)[e];
    }
    const int r = e / (2 * TILE), h = (e / TILE) % 2, col = pc0 + e % TILE;
    if (col < oh) store_from_float(y, dtype, (int64_t)r * out_cols + col_off + h * oh + col, v);
  }
  if (C > 1) cluster.sync();   // no block leaves while another reads its tile
}

constexpr int SMEM = WARPS * sizeof(WarpSmem);
static_assert(MAX_ROWS * 2 * TILE * sizeof(float) <= sizeof(WarpSmem::ring),
              "a tile's sums fit in warp 0's ring");

template <bool WIDE>
cudaError_t prepare() {
  static const cudaError_t err = [] {
    const cudaError_t e = cudaFuncSetAttribute(
        int4_gemv_kernel<WIDE>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(int4_gemv_kernel<WIDE>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
  }();
  return err;
}

template <bool WIDE>
cudaError_t launch(int tiles, int C, const __nv_bfloat16* x, int n, int K, const Parts& parts,
                   void* y, int out_cols, int out_f32, cudaStream_t stream) {
  const cudaError_t err = prepare<WIDE>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * C);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute la[1];
  la[0].id = cudaLaunchAttributeClusterDimension;
  la[0].val.clusterDim.x = C;
  la[0].val.clusterDim.y = 1;
  la[0].val.clusterDim.z = 1;
  cfg.attrs = la;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, int4_gemv_kernel<WIDE>, x, n, K, parts, C, y, out_cols,
                            out_f32);
}

}  // namespace
}  // namespace sc

// x: contiguous bf16 [n, K], 1 <= n <= 8, K % 128 == 0, 16-byte aligned. Part
// p (p < nparts <= 3): w_p contiguous int8 [K, oh_p] (oh_p % 4 == 0, 4-byte
// aligned), scale_p f32 [K / 128, 2, oh_p]. y: [n, sum_p 2 oh_p] (f32 when
// out_f32, else bf16), part p at columns [off_p, off_p + 2 oh_p), off_p =
// sum_{q < p} 2 oh_q. cluster: the ranges each 64-column tile's groups are
// cut into (ops/int4_matmul.launch_plan), a power of two <= 8 and <= K / 128.
// Anything else returns cudaErrorInvalidValue.
extern "C" int sc_int4_gemv(const void* x, int n, int K, int nparts, const void* w0,
                            const void* s0, int oh0, const void* w1, const void* s1, int oh1,
                            const void* w2, const void* s2, int oh2, int cluster, void* y,
                            int out_f32, void* stream) {
  const int G = K / sc::GROUP;
  if (nparts < 1 || nparts > sc::MAX_PARTS || K % sc::GROUP || G < 1 || n < 1 ||
      n > sc::MAX_ROWS || cluster < 1 || cluster > sc::MAX_CLUSTER ||
      (cluster & (cluster - 1)) || cluster > G || reinterpret_cast<uintptr_t>(x) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  sc::Parts parts{};
  const void* ws[3] = {w0, w1, w2};
  const void* ss[3] = {s0, s1, s2};
  const int ohs[3] = {oh0, oh1, oh2};
  int tiles = 0, cols = 0;
  bool wide = true;
  for (int p = 0; p < nparts; ++p) {
    if (ohs[p] < 4 || ohs[p] % 4 || reinterpret_cast<uintptr_t>(ws[p]) % 4 ||
        reinterpret_cast<uintptr_t>(ss[p]) % 4)
      return static_cast<int>(cudaErrorInvalidValue);
    parts.w[p] = static_cast<const int8_t*>(ws[p]);
    parts.scale[p] = static_cast<const float*>(ss[p]);
    parts.oh[p] = ohs[p];
    parts.col_off[p] = cols;
    tiles += (ohs[p] + sc::TILE - 1) / sc::TILE;
    parts.tile_end[p] = tiles;
    cols += 2 * ohs[p];
    wide = wide && ohs[p] % 16 == 0 && reinterpret_cast<uintptr_t>(ws[p]) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(ss[p]) % 16 == 0;
  }
  parts.nparts = nparts;
  auto xp = static_cast<const __nv_bfloat16*>(x);
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      wide ? sc::launch<true>(tiles, cluster, xp, n, K, parts, y, cols, out_f32, st)
           : sc::launch<false>(tiles, cluster, xp, n, K, parts, y, cols, out_f32, st));
}

// Compiled attributes of the kernel instance (wide 1: 16-byte copies, 0:
// 4-byte copies): out[0] registers per thread, out[1] local (spill) bytes per
// thread, out[2] shared bytes a block (dynamic), out[3] resident blocks an
// SM.
extern "C" int sc_int4_gemv_attributes(int wide, int* out) {
  cudaError_t err = wide ? sc::prepare<true>() : sc::prepare<false>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes a{};
  err = wide ? cudaFuncGetAttributes(&a, sc::int4_gemv_kernel<true>)
             : cudaFuncGetAttributes(&a, sc::int4_gemv_kernel<false>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = sc::SMEM;
  int blocks = 0;
  err = wide ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, sc::int4_gemv_kernel<true>,
                                                             sc::THREADS, sc::SMEM)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &blocks, sc::int4_gemv_kernel<false>, sc::THREADS, sc::SMEM);
  out[3] = blocks;
  return static_cast<int>(err);
}
