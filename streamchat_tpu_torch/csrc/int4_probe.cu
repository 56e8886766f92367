// K15: the int4 GEMV probe's unpack variants and block shapes.
//
// Replaces scripts/probe_int4_kernel.py:matvec (make_kernel), the TPU probe
// that split the int4 GEMV's time (K10, ops/int4_matmul.py) into DMA, casts,
// bit operations and dots over the 7B MLP-up shape: x [n <= 8, 3584] bf16,
// packed bytes w [3584, 9472] int8 (low nibble column j, high nibble column
// j + 9472), scale [28, 2, 9472] f32 -> y [n, 18944] f32, low-nibble columns
// first. Variants, each computing what the TPU kernel computes:
//   dma   - every packed byte is loaded; y_lo[r, j] = sum over k-slices of
//           the signed byte in the slice's row r (r < n), y_hi = 0;
//   cast  - bytes as signed values, no bit operations: one dot per group,
//           scaled by scale[g, 0] into y_lo and by scale[g, 1] into y_hi;
//   cur   - K10's unpack: lo = ((b & 15) ^ 8) - 8, hi = b >> 4;
//   xor32 - one xor: u = b ^ 8 widened to 32 bits, dots d_u = x.(u & 15) and
//           d_b = x.u, then lo = d_u - 8 sum(x_g), hi = (d_b - d_u) / 16;
//   xor8  - the xor32 algebra on the four bytes of a 32-bit word at once
//           (^ 0x08080808, & 0x000F000F), the card's counterpart of the
//           TPU's i8-native lanes.
//
// What bounds it on the H100: the packed bytes (34 MB, 36 MB with the
// scales: 10.8 us at 3.35 TB/s). The TPU's grid (block_out / 4 threads x
// ceil(oh / block_out) column blocks x ceil(28 / gpb) k-slices) is 20 blocks
// at (1024, 16) on 132 SMs, so the sweep measured idle SMs. The design:
// - The card's grid no longer follows block_out and gpb. A card block owns a
//   128-packed-column sub-tile of one k-slice (gpb groups, the groups whose
//   partial the TPU summed) and, when the sub-tiles times the slices are
//   fewer than two waves (264 blocks), a range of whole groups of the slice:
//   the slice is split into C row ranges (C a power of two <= 8 and <= gpb),
//   the C blocks of a (sub-tile, slice) form one thread-block cluster, and
//   their partials are summed through distributed shared memory in rank
//   order. The slices are summed by the split-K reduce in slice order. No
//   atomics: two launches give equal bits. At the probe's shape every sweep
//   point launches 74 x C x slices = 296 blocks. block_out only names the
//   TPU's block shape. probe_int4.card_grid states the same geometry.
// - At n = 1 each thread reads 16 packed columns of a row with one 16-byte
//   non-allocating load (8 threads cover a row's 128 bytes), 8 rows of a
//   group at a time, and issues the next group's loads before it unpacks this
//   one: 32 KB in flight per block. n > 1 (8 x 32 f32 accumulators a row
//   would not fit) and a width not a multiple of 16 read 4 bytes a thread.
// - cur and xor8 unpack two nibbles per instruction: (b & 0x000F000F) |
//   0x43004300 is the bf16 pair 128 + v, exactly; cur flips bit 3 of every
//   nibble first (one xor for the word) and subtracts 136 (one bf16x2
//   subtract per pair), xor8 subtracts 128 from the low nibbles and takes the
//   signed byte as 2^23 + (u ^ 0x80) in f32. xor32 and cast keep their
//   scalar byte conversions; dma only loads.
// - Each thread sums its rows of a group in f32, scales the partial by the
//   group's scales before it accumulates (K10's order); the row lanes of a
//   block are summed in shared memory in lane order.
// The dma variant folds every loaded word into one value and stores a flag
// when it equals a sentinel the caller passes, so the compiler keeps every
// load; the flag is never read.
#include <cooperative_groups.h>

#include "kernels.cuh"

namespace sc {
namespace {

namespace cg = cooperative_groups;

constexpr int GROUP = 128, SUB = 128, THREADS = 128, TARGET_BLOCKS = 2 * 132, MAX_CLUSTER = 8;
enum Variant : int { kDma = 0, kCast = 1, kCur = 2, kXor32 = 3, kXor8 = 4 };

// Thread geometry for NR input rows and CW packed columns a thread.
template <int NR, int CW>
struct Geo {
  static constexpr int LPR = SUB / CW;           // lanes across a row
  static constexpr int RL = THREADS / LPR;       // row lanes
  static constexpr int RPT = GROUP / RL;         // rows of a group a thread
  static constexpr int WORDS = CW / 4;           // 32-bit words a row
  static constexpr bool PREFETCH = NR == 1;      // next group's loads in flight
  static constexpr int TILE = NR * 2 * SUB;      // a block's outputs
};

__host__ __device__ inline int cluster_size(int tiles, int slices, int gpb) {
  int c = 1;
  while (c < MAX_CLUSTER && 2 * c <= gpb && (long long)tiles * slices * c < TARGET_BLOCKS)
    c *= 2;
  return c;
}

__device__ __forceinline__ int sbyte(unsigned word, int j) {
  return static_cast<int>(static_cast<signed char>(word >> (8 * j)));
}

__device__ __forceinline__ float bf_lo(unsigned p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float bf_hi(unsigned p) { return __uint_as_float(p & 0xFFFF0000u); }

// The bf16 pair 128 + nibble (bytes 0 and 2 of v) minus `bias`.
__device__ __forceinline__ unsigned nib_pair(unsigned v, __nv_bfloat162 bias) {
  unsigned p = (v & 0x000F000Fu) | 0x43004300u;
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&p), bias);
  return *reinterpret_cast<unsigned*>(&r);
}

template <int WORDS>
__device__ __forceinline__ void load_row(unsigned (&dst)[WORDS], const int8_t* p) {
  if constexpr (WORDS == 4) {
    uint4 v;
    asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(p));
    dst[0] = v.x, dst[1] = v.y, dst[2] = v.z, dst[3] = v.w;
  } else {
    dst[0] = __ldcs(reinterpret_cast<const unsigned*>(p));
  }
}

template <int NR, int CW, int V>
__global__ void __launch_bounds__(THREADS)
int4_probe_kernel(const __nv_bfloat16* __restrict__ x, int n, int K,
                  const int8_t* __restrict__ w, const float* __restrict__ scale, int oh,
                  int gpb, int C, float* __restrict__ out, unsigned sentinel,
                  unsigned* __restrict__ flag) {
  using G = Geo<NR, CW>;
  extern __shared__ float smem[];
  const int tid = threadIdx.x, lane_c = tid % G::LPR, lane_r = tid / G::LPR;
  const int rank = blockIdx.x % C, tile = blockIdx.x / C;
  const int ngroups = K / GROUP;
  const int s0 = blockIdx.y * gpb, s1 = min(ngroups, s0 + gpb);
  const int q = (gpb + C - 1) / C;
  const int g0 = min(s1, s0 + rank * q), g1 = min(s1, g0 + q);
  const int pc0 = tile * SUB, pc = pc0 + lane_c * CW;
  const bool active = pc < oh;   // oh % CW == 0
  float* xs = smem;                               // [NR][q * GROUP]
  float* red = xs + NR * q * GROUP;               // [RL][TILE]
  float* tile_sum = red + G::RL * G::TILE;        // [TILE]

  if constexpr (V != kDma) {
    const int rows = (g1 - g0) * GROUP;
    for (int i = tid; i < NR * rows; i += THREADS) {
      const int r = i / rows, kk = i % rows;
      xs[r * q * GROUP + kk] =
          r < n ? __bfloat162float(x[(int64_t)r * K + g0 * GROUP + kk]) : 0.0f;
    }
    __syncthreads();
  }

  float acc_lo[NR][CW], acc_hi[NR][CW];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc_lo[r][c] = acc_hi[r][c] = 0.0f;
  unsigned live = 0;
  const __nv_bfloat162 b136 = __floats2bfloat162_rn(136.0f, 136.0f);
  const __nv_bfloat162 b128 = __floats2bfloat162_rn(128.0f, 128.0f);

  unsigned cur[G::RPT][G::WORDS], nxt[G::RPT][G::WORDS];
  auto load_group = [&](unsigned (&dst)[G::RPT][G::WORDS], int g) {
#pragma unroll
    for (int i = 0; i < G::RPT; ++i)
      load_row<G::WORDS>(dst[i], w + (int64_t)(g * GROUP + lane_r + i * G::RL) * oh + pc);
  };
  if (active && g0 < g1) load_group(cur, g0);

  for (int g = g0; g < g1 && active; ++g) {
    if constexpr (G::PREFETCH) {
      if (g + 1 < g1) load_group(nxt, g + 1);
    } else if (g > g0) {
      load_group(cur, g);
    }
    if constexpr (V == kDma) {
#pragma unroll
      for (int i = 0; i < G::RPT; ++i)
#pragma unroll
        for (int u = 0; u < G::WORDS; ++u) live ^= cur[i][u];
      if (g == s0) {   // the slice's first n rows, as signed bytes
#pragma unroll
        for (int i = 0; i < G::RPT; ++i) {
          const int k = lane_r + i * G::RL;
#pragma unroll
          for (int r = 0; r < NR; ++r)
            if (k == r && r < n) {
#pragma unroll
              for (int u = 0; u < G::WORDS; ++u)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  acc_lo[r][4 * u + j] = static_cast<float>(sbyte(cur[i][u], j));
            }
        }
      }
    } else {
      float plo[NR][CW], phi[NR][CW], sx[NR];
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        sx[r] = 0.0f;
#pragma unroll
        for (int c = 0; c < CW; ++c) plo[r][c] = phi[r][c] = 0.0f;
      }
      const float* xg = xs + (g - g0) * GROUP;
#pragma unroll
      for (int i = 0; i < G::RPT; ++i) {
        const int k = lane_r + i * G::RL;
        float xv[NR];
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          xv[r] = xg[r * q * GROUP + k];
          if constexpr (V == kXor32 || V == kXor8) sx[r] += xv[r];
        }
#pragma unroll
        for (int u = 0; u < G::WORDS; ++u) {
          const unsigned word = cur[i][u];
          float lo[4], hi[4];
          if constexpr (V == kCur) {
            const unsigned wx = word ^ 0x88888888u;   // every nibble v -> v ^ 8
            const unsigned l02 = nib_pair(wx, b136), l13 = nib_pair(wx >> 8, b136);
            const unsigned h02 = nib_pair(wx >> 4, b136), h13 = nib_pair(wx >> 12, b136);
            lo[0] = bf_lo(l02), lo[2] = bf_hi(l02), lo[1] = bf_lo(l13), lo[3] = bf_hi(l13);
            hi[0] = bf_lo(h02), hi[2] = bf_hi(h02), hi[1] = bf_lo(h13), hi[3] = bf_hi(h13);
          } else if constexpr (V == kXor8) {
            const unsigned wx = word ^ 0x08080808u, wv = wx ^ 0x80808080u;
            const unsigned l02 = nib_pair(wx, b128), l13 = nib_pair(wx >> 8, b128);
            lo[0] = bf_lo(l02), lo[2] = bf_hi(l02), lo[1] = bf_lo(l13), lo[3] = bf_hi(l13);
#pragma unroll
            for (int j = 0; j < 4; ++j)   // 2^23 + (u ^ 0x80) - (2^23 + 128) = u
              hi[j] = __uint_as_float(0x4B000000u | __byte_perm(wv, 0u, 0x4440u | j)) -
                      8388736.0f;
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int b = sbyte(word, j);
              if constexpr (V == kCast) {
                lo[j] = hi[j] = static_cast<float>(b);
              } else {   // kXor32
                const int u32 = b ^ 8;
                lo[j] = static_cast<float>(u32 & 0xF);
                hi[j] = static_cast<float>(u32);
              }
            }
          }
#pragma unroll
          for (int r = 0; r < NR; ++r)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              plo[r][4 * u + j] = fmaf(xv[r], lo[j], plo[r][4 * u + j]);
              if constexpr (V != kCast) phi[r][4 * u + j] = fmaf(xv[r], hi[j], phi[r][4 * u + j]);
            }
        }
      }
      float s_lo[CW], s_hi[CW];
#pragma unroll
      for (int c = 0; c < CW; c += 4) {
        const float4 a = *reinterpret_cast<const float4*>(scale + ((int64_t)g * 2) * oh + pc + c);
        const float4 b =
            *reinterpret_cast<const float4*>(scale + ((int64_t)g * 2 + 1) * oh + pc + c);
        s_lo[c] = a.x, s_lo[c + 1] = a.y, s_lo[c + 2] = a.z, s_lo[c + 3] = a.w;
        s_hi[c] = b.x, s_hi[c + 1] = b.y, s_hi[c + 2] = b.z, s_hi[c + 3] = b.w;
      }
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          float lo = plo[r][c], hi = V == kCast ? plo[r][c] : phi[r][c];
          if constexpr (V == kXor32 || V == kXor8) {
            hi = (phi[r][c] - plo[r][c]) * 0.0625f;
            lo = plo[r][c] - 8.0f * sx[r];
          }
          acc_lo[r][c] += lo * s_lo[c];
          acc_hi[r][c] += hi * s_hi[c];
        }
    }
    if constexpr (G::PREFETCH) {
#pragma unroll
      for (int i = 0; i < G::RPT; ++i)
#pragma unroll
        for (int u = 0; u < G::WORDS; ++u) cur[i][u] = nxt[i][u];
    }
  }
  if (V == kDma && live == sentinel) *flag = 1u;

  // The block's row lanes, summed in lane order: element e of a tile is input
  // row e / (2 SUB), half (e / SUB) % 2, packed column pc0 + e % SUB.
  float* mine = red + lane_r * G::TILE;
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      mine[r * 2 * SUB + lane_c * CW + c] = acc_lo[r][c];
      mine[r * 2 * SUB + SUB + lane_c * CW + c] = acc_hi[r][c];
    }
  __syncthreads();
  for (int e = tid; e < G::TILE; e += THREADS) {
    float s = 0.0f;
#pragma unroll
    for (int l = 0; l < G::RL; ++l) s += red[l * G::TILE + e];
    tile_sum[e] = s;
  }
  // The cluster's row ranges, summed in rank order; rank r writes its share
  // of the tile.
  cg::cluster_group cluster = cg::this_cluster();
  if (C > 1) cluster.sync(); else __syncthreads();
  float* o = out + (int64_t)blockIdx.y * n * 2 * oh;
  const int share = G::TILE / C;
  for (int e = rank * share + tid; e < (rank + 1) * share; e += THREADS) {
    const int r = e / (2 * SUB), h = (e / SUB) % 2, col = pc0 + e % SUB;
    float s = 0.0f;
    for (int k = 0; k < C; ++k) s += cluster.map_shared_rank(tile_sum, k)[e];
    if (r < n && col < oh) o[(int64_t)r * 2 * oh + h * oh + col] = s;
  }
  if (C > 1) cluster.sync();   // no block leaves while another reads its tile
}

template <int NR, int CW>
size_t smem_bytes(int q) {
  using G = Geo<NR, CW>;
  return sizeof(float) * ((size_t)NR * q * GROUP + (size_t)(G::RL + 1) * G::TILE);
}

template <int NR, int CW, int V>
cudaError_t launch_variant(dim3 grid, int C, size_t smem, const __nv_bfloat16* x, int n, int K,
                           const int8_t* w, const float* scale, int oh, int gpb, float* out,
                           unsigned sentinel, unsigned* flag, cudaStream_t st) {
  auto kernel = int4_probe_kernel<NR, CW, V>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute la[1];
  la[0].id = cudaLaunchAttributeClusterDimension;
  la[0].val.clusterDim.x = C;
  la[0].val.clusterDim.y = 1;
  la[0].val.clusterDim.z = 1;
  cfg.attrs = la;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, x, n, K, w, scale, oh, gpb, C, out, sentinel, flag);
}

template <int NR, int CW>
cudaError_t launch_probe(int variant, dim3 grid, int C, int q, const __nv_bfloat16* x, int n,
                         int K, const int8_t* w, const float* scale, int oh, int gpb, float* out,
                         unsigned sentinel, unsigned* flag, cudaStream_t st) {
  const size_t smem = smem_bytes<NR, CW>(q);
#define SC_PROBE(V)                                                                   \
  launch_variant<NR, CW, V>(grid, C, smem, x, n, K, w, scale, oh, gpb, out, sentinel, \
                            flag, st)
  switch (variant) {
    case kDma: return SC_PROBE(kDma);
    case kCast: return SC_PROBE(kCast);
    case kCur: return SC_PROBE(kCur);
    case kXor32: return SC_PROBE(kXor32);
    case kXor8: return SC_PROBE(kXor8);
    default: return cudaErrorInvalidValue;
  }
#undef SC_PROBE
}

template <int NR, int CW>
cudaError_t attributes(int variant, int* out) {
  cudaFuncAttributes a{};
  cudaError_t err;
  switch (variant) {
    case kDma: err = cudaFuncGetAttributes(&a, int4_probe_kernel<NR, CW, kDma>); break;
    case kCast: err = cudaFuncGetAttributes(&a, int4_probe_kernel<NR, CW, kCast>); break;
    case kCur: err = cudaFuncGetAttributes(&a, int4_probe_kernel<NR, CW, kCur>); break;
    case kXor32: err = cudaFuncGetAttributes(&a, int4_probe_kernel<NR, CW, kXor32>); break;
    case kXor8: err = cudaFuncGetAttributes(&a, int4_probe_kernel<NR, CW, kXor8>); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  return cudaSuccess;
}

}  // namespace
}  // namespace sc

// x: contiguous bf16 [n, K], n <= 8, K % 128 == 0; w: contiguous int8 [K, oh],
// oh % 4 == 0, 4-byte aligned (16-byte loads at n = 1 when oh % 16 == 0 and w
// is 16-byte aligned); scale: f32 [K / 128, 2, oh]; y: f32 [n, 2 oh]. variant
// 0-4: dma, cast, cur, xor32, xor8. block_out: the TPU's packed columns per
// block (a multiple of 128, at most 2048; checked, not used by the card's
// grid); gpb: groups per k-slice; nsplit = ceil((K / 128) / gpb) slices, and
// with nsplit > 1 partial is f32 [nsplit, n, 2 oh] scratch. flag: one uint32
// the dma variant may write (never read).
extern "C" int sc_int4_probe(const void* x, int n, int K, const void* w, const void* scale,
                             int oh, int variant, int block_out, int gpb, int nsplit,
                             void* partial, void* y, unsigned sentinel, void* flag,
                             void* stream) {
  const int groups = K / sc::GROUP;
  if (K % sc::GROUP || block_out % 128 || block_out > 2048 || gpb < 1 || n < 1 || n > 8 ||
      oh % 4 || groups < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  gpb = gpb < groups ? gpb : groups;
  if (nsplit != (groups + gpb - 1) / gpb) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (oh + sc::SUB - 1) / sc::SUB;
  const int C = sc::cluster_size(tiles, nsplit, gpb);
  const int q = (gpb + C - 1) / C;
  const dim3 grid(tiles * C, nsplit);
  auto xp = static_cast<const __nv_bfloat16*>(x);
  auto wp = static_cast<const int8_t*>(w);
  auto sp = static_cast<const float*>(scale);
  auto st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(nsplit > 1 ? partial : y);
  auto fp = static_cast<unsigned*>(flag);
  const bool wide = n == 1 && oh % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  cudaError_t err =
      n > 1 ? sc::launch_probe<8, 4>(variant, grid, C, q, xp, n, K, wp, sp, oh, gpb, out,
                                     sentinel, fp, st)
      : wide ? sc::launch_probe<1, 16>(variant, grid, C, q, xp, n, K, wp, sp, oh, gpb, out,
                                       sentinel, fp, st)
             : sc::launch_probe<1, 4>(variant, grid, C, q, xp, n, K, wp, sp, oh, gpb, out,
                                      sentinel, fp, st);
  if (err != cudaSuccess || nsplit == 1) return static_cast<int>(err);
  return static_cast<int>(sc::launch_splitk_reduce(static_cast<const float*>(partial), nsplit,
                                                   n, 2 * oh, nullptr, y, /*out_f32=*/1, st));
}

// Compiled attributes of the probe kernel for variant 0-4 at n rows (1 or
// more) and a width oh: out[0] registers per thread, out[1] local (spill)
// bytes per thread, out[2] static shared bytes, out[3] packed columns a thread
// loads at once (16: one 16-byte load; 4: one 32-bit load).
extern "C" int sc_int4_probe_attributes(int variant, int n, int oh, int* out) {
  cudaError_t err;
  if (n > 1) {
    err = sc::attributes<8, 4>(variant, out);
    out[3] = 4;
  } else if (oh % 16 == 0) {
    err = sc::attributes<1, 16>(variant, out);
    out[3] = 16;
  } else {
    err = sc::attributes<1, 4>(variant, out);
    out[3] = 4;
  }
  return static_cast<int>(err);
}
