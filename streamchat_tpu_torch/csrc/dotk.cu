// K17: the dot probe, the sum of many bf16 dots into one f32 output tile.
//
// Replaces scripts/probe_vit_variants.py:run_dotk (its kernel `kern`), the
// TPU probe that asks whether a 64-deep contraction (q k^T at head dim 64)
// or a 64-wide output (p v) costs a full 128-wide MXU pass. Four kinds, each
// 2 * 577^2 * 64 * 96 = 4.09 GFLOP:
//   qk (dh 64 or 128): out[S, S]  = sum_i a[i] @ b, a [n, S, dh], b [dh, S];
//   pv (dh 64 or 128): out[S, dh] = sum_i a @ b[i], a [S, S], b [n, S, dh].
// Nothing sums the operands before the products: every dot runs.
//
// What bounds it on the H100: operations (4.1 us at 989 TFLOP/s; the bytes,
// at most 8.5 MB, take 2.5 us), and only wgmma reaches the tensor cores'
// rate. On the card the probe's question becomes whether a 64-deep wgmma
// step costs what a 128-deep one does. The design, on the wgmma / TMA /
// mbarrier machinery of flash_prefill.cu and gemm.cu (hopper.cuh):
// - A block owns one output tile and a slice of the dots, with three
//   warpgroups: a producer whose one thread issues TMA loads into a ring
//   with a "full" and an "empty" mbarrier per stage, and two consumer
//   warpgroups of 64 output rows each; setmaxnreg moves registers from the
//   producer (24) to the consumers (240). The slices' f32 partials are
//   summed by the split-K reduce in slice order (no atomics: two launches
//   give equal bits).
// - qk: 128 x 128 output tiles (5 x 5 at S = 577), the dots split so that
//   about 132 blocks run. The streaming operand a[i]'s 128-row tile [128,
//   dh] arrives by TMA (K-major A, 128-byte swizzle, 4 stages); the shared
//   operand b [dh, S] is an MN-major B whose rows of S bf16 (1,154 bytes at
//   S = 577) are not 16-byte aligned, so TMA cannot map it: the block's
//   threads load its 128-column tile once, into the layout the TMA would
//   have written (chunk_sw128), eight elements to a 16-byte chunk, while the
//   ring's first TMA loads are in flight. Each dot is dh / 16 wgmma
//   m64n128k16 steps.
// - pv: 128-row tiles x all dh columns (5 at S = 577), the dots split about
//   26 ways. The shared operand, a's row tile [128, S] (K-major A, rows not
//   16-byte aligned), is loaded once by the threads in 64-deep boxes (160 KB
//   at S = 577, ceil(S / 64) boxes); the streaming operand b[i] [S, dh] is an
//   MN-major B, as V is in flash_prefill.cu, arriving by TMA in 64-row slabs
//   (3 stages). Each slab is four wgmma m64n{dh}k16 steps.
// - Rows and columns past S are zero in shared memory before wgmma reads
//   them: the manual loads write zeros and fence them to the async proxy,
//   TMA fills rows past S of its per-dot map with zeros (never the next
//   dot's rows). 0 x NaN is NaN in the tensor core. Stores are masked.
// One slab's products stay in flight while the next are issued; a stage is
// released once its products have retired.
#include "hopper.cuh"
#include "kernels.cuh"

namespace sc {
namespace {

using namespace hopper;
using bf = __nv_bfloat16;

constexpr int CONSUMERS = 2, THREADS = (CONSUMERS + 1) * 128;
constexpr int BM = 128, BN = 128, BK = 64;
constexpr int BOX = 128 * 128;   // [128 rows][64 bf16], 128-byte swizzle
constexpr int SLAB_BOX = BK * 128;   // [64 rows][64 bf16]
constexpr int MAX_SMEM = 232448;

template <int DH>
struct QkLayout {
  static constexpr int STAGES = 4;
  static constexpr int B_BOX = DH * 128;           // [dh][64 columns] of b's tile
  static constexpr int A_TILE = (DH / 64) * BOX;   // [128, dh] of a[i]
  static constexpr int ring = 2 * B_BOX;
  static constexpr int bars = ring + STAGES * A_TILE;
  static constexpr int bytes = bars + 8 * 2 * STAGES + 1024;   // + alignment slack
};

template <int DH>
struct PvLayout {
  static constexpr int STAGES = 3;
  static constexpr int B_STAGE = (DH / 64) * SLAB_BOX;   // [64 rows, dh] of b[i]
  // a's row tile [128, ceil(S / 64) 64] first, then the ring, then the barriers.
  __host__ __device__ static int ring(int S) { return ((S + BK - 1) / BK) * BOX; }
  __host__ __device__ static int bars(int S) { return ring(S) + STAGES * B_STAGE; }
  __host__ __device__ static int bytes(int S) { return bars(S) + 8 * 2 * STAGES + 1024; }
};

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                    ~uintptr_t(1023));
}

template <int NSTAGES>
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);   // one arrival per consumer warp
    }
    mbar_init_fence();
  }
}

// qk: block (column tile x, row tile y, dot slice z).
template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
    dotk_qk_kernel(__grid_constant__ const CUtensorMap amap, const bf* __restrict__ b,
                   float* __restrict__ out, int S, int ndots, int per) {
  using L = QkLayout<DH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + L::STAGES;
  const int c0 = blockIdx.x * BN, r0 = blockIdx.y * BM;
  const int i0 = blockIdx.z * per, nd = max(0, min(ndots, i0 + per) - i0);
  const int wg = threadIdx.x / 128;

  // The ring's first loads start before the shared operand is in place.
  init_ring<L::STAGES>(full, empty);
  __syncthreads();
  auto load_a = [&](int t) {
    const int s = t % L::STAGES;
    mbar_expect_tx(&full[s], L::A_TILE);
    for (int hf = 0; hf < DH / 64; ++hf)
      tma_load_4d(smem + L::ring + s * L::A_TILE + hf * BOX, &amap, &full[s], 64 * hf, r0,
                  i0 + t, 0);
  };
  const bool producer = threadIdx.x == CONSUMERS * 128;
  if (producer) {
    tma_prefetch_map(&amap);
    for (int t = 0; t < min(nd, L::STAGES); ++t) load_a(t);
  }
  // b's column tile [dh, 128] in 16-byte chunks, zeros past column S.
#pragma unroll 4
  for (int e = threadIdx.x; e < DH * (BN / 8); e += THREADS) {
    const int k = e / (BN / 8), c = (e % (BN / 8)) * 8;
    *chunk_sw128(smem, L::B_BOX, k, c) = load8_bf16(b + (int64_t)k * S + c0 + c, S - c0 - c);
  }
  fence_proxy_async();
  __syncthreads();

  if (wg == CONSUMERS) {
    setmaxnreg_dec<24>();
    if (producer) {
      for (int t = L::STAGES; t < nd; ++t) {
        const int s = t % L::STAGES;
        mbar_wait(&empty[s], ((t / L::STAGES) - 1) & 1);
        load_a(t);
      }
    }
    return;
  }

  // Consumers: this thread holds rows rr and rr + 8 of the warpgroup's 64 at
  // columns 8 j + c2 + {0, 1} (wgmma's accumulator layout).
  setmaxnreg_inc<240>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  const uint32_t bs = smem_addr(smem);
  for (int t = 0; t < nd; ++t) {
    const int s = t % L::STAGES;
    mbar_wait(&full[s], (t / L::STAGES) & 1);
    const uint32_t a = smem_addr(smem + L::ring + s * L::A_TILE) + wg * 64 * 128;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss_n128_tb(acc, desc_sw128(a + (kk / 4) * BOX + (kk % 4) * 32, 16, 1024),
                       desc_sw128(bs + kk * 16 * 128, L::B_BOX, 1024), 1);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
    if (t > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(t - 1) % L::STAGES]);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  const int rr = 16 * warp + lane / 4, c2 = 2 * (lane % 4);
  float* o = out + (int64_t)blockIdx.z * S * S;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 64 * wg + rr + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * j + c2 + e;
        if (col < S) o[(int64_t)row * S + col] = acc[4 * j + 2 * r + e];
      }
  }
}

// pv: block (row tile x, -, dot slice z).
template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
    dotk_pv_kernel(const bf* __restrict__ a, __grid_constant__ const CUtensorMap bmap,
                   float* __restrict__ out, int S, int ndots, int per) {
  using L = PvLayout<DH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const int kslabs = (S + BK - 1) / BK;
  const int ring = L::ring(S);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars(S));
  uint64_t* empty = full + L::STAGES;
  const int r0 = blockIdx.x * BM;
  const int i0 = blockIdx.z * per, nd = max(0, min(ndots, i0 + per) - i0);
  const int wg = threadIdx.x / 128;

  // The ring's first loads start before the shared operand is in place.
  init_ring<L::STAGES>(full, empty);
  __syncthreads();
  const int steps = nd * kslabs;   // step t: slab t % kslabs of dot i0 + t / kslabs
  auto load_b = [&](int t) {
    const int s = t % L::STAGES;
    mbar_expect_tx(&full[s], L::B_STAGE);
    for (int hf = 0; hf < DH / 64; ++hf)
      tma_load_4d(smem + ring + s * L::B_STAGE + hf * SLAB_BOX, &bmap, &full[s], 64 * hf,
                  (t % kslabs) * BK, i0 + t / kslabs, 0);
  };
  const bool producer = threadIdx.x == CONSUMERS * 128;
  if (producer) {
    tma_prefetch_map(&bmap);
    for (int t = 0; t < min(steps, L::STAGES); ++t) load_b(t);
  }
  // a's row tile [128, kslabs 64] in 16-byte chunks, zeros past row S and
  // column S.
  const int row_chunks = kslabs * (BK / 8);
#pragma unroll 4
  for (int e = threadIdx.x; e < BM * row_chunks; e += THREADS) {
    const int r = e / row_chunks, k = (e % row_chunks) * 8;
    *chunk_sw128(smem, BOX, r, k) =
        load8_bf16(a + (int64_t)(r0 + r) * S + k, r0 + r < S ? S - k : 0);
  }
  fence_proxy_async();
  __syncthreads();

  if (wg == CONSUMERS) {
    setmaxnreg_dec<24>();
    if (producer) {
      for (int t = L::STAGES; t < steps; ++t) {
        mbar_wait(&empty[t % L::STAGES], ((t / L::STAGES) - 1) & 1);
        load_b(t);
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.0f;
  const uint32_t as = smem_addr(smem) + wg * 64 * 128;
  for (int t = 0; t < steps; ++t) {
    const int s = t % L::STAGES;
    mbar_wait(&full[s], (t / L::STAGES) & 1);
    const uint32_t at = as + (t % kslabs) * BOX;
    const uint32_t bt = smem_addr(smem + ring + s * L::B_STAGE);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = desc_sw128(at + kk * 32, 16, 1024);
      const uint64_t db = desc_sw128(bt + kk * 16 * 128, SLAB_BOX, 1024);
      if constexpr (DH == 128)
        wgmma_ss_n128_tb(acc, da, db, 1);
      else
        wgmma_ss_n64_tb(acc, da, db, 1);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
    if (t > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(t - 1) % L::STAGES]);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  const int rr = 16 * warp + lane / 4, c2 = 2 * (lane % 4);
  float* o = out + (int64_t)blockIdx.z * S * DH;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 64 * wg + rr + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<float2*>(o + (int64_t)row * DH + 8 * j + c2) =
          make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

template <int DH>
cudaError_t launch_dotk(const bf* a, const bf* b, float* out, int pv, int S, int ndots,
                        int per, int nsplit, cudaStream_t stream) {
  const int tiles = (S + BM - 1) / BM;
  CUtensorMap map;
  const int64_t strides[3] = {0, (int64_t)S * DH, DH};
  if (pv) {
    const int bytes = PvLayout<DH>::bytes(S);
    if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
    cudaError_t err = make_map_bf16(&map, b, strides, 1, ndots, S, DH, BK);
    if (err != cudaSuccess) return err;
    static const cudaError_t attr = cudaFuncSetAttribute(
        dotk_pv_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (attr != cudaSuccess) return attr;
    dotk_pv_kernel<DH><<<dim3(tiles, 1, nsplit), THREADS, bytes, stream>>>(a, map, out, S,
                                                                           ndots, per);
  } else {
    constexpr int bytes = QkLayout<DH>::bytes;
    cudaError_t err = make_map_bf16(&map, a, strides, 1, ndots, S, DH, BM);
    if (err != cudaSuccess) return err;
    static const cudaError_t attr = cudaFuncSetAttribute(
        dotk_qk_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (attr != cudaSuccess) return attr;
    dotk_qk_kernel<DH><<<dim3(tiles, tiles, nsplit), THREADS, bytes, stream>>>(map, b, out, S,
                                                                               ndots, per);
  }
  return cudaGetLastError();
}

template <typename F>
cudaError_t kernel_attributes(F kernel, int dynamic_bytes, int* out) {
  cudaFuncAttributes at{};
  cudaError_t err = cudaFuncGetAttributes(&at, kernel);
  if (err != cudaSuccess) return err;
  out[0] = at.numRegs;
  out[1] = static_cast<int>(at.localSizeBytes);
  out[2] = static_cast<int>(at.sharedSizeBytes);
  out[3] = dynamic_bytes;
  return cudaSuccess;
}

}  // namespace
}  // namespace sc

// pv = 0: a [ndots, S, dh], b [dh, S] -> y [S, S]; pv = 1: a [S, S], b
// [ndots, S, dh] -> y [S, dh]. Contiguous bf16 inputs (16-byte aligned), f32
// y; pv needs ceil(S / 64) 16 KB + 3 dh 128 bytes of shared memory (S <= 704
// at dh 128). The dots are cut into nsplit slices of dots_per_split; with
// nsplit > 1, partial is f32 [nsplit, rows of y, columns of y] scratch.
extern "C" int sc_dotk(const void* a, const void* b, void* y, void* partial, int pv, int S,
                       int dh, int ndots, int dots_per_split, int nsplit, void* stream) {
  auto ap = static_cast<const __nv_bfloat16*>(a);
  auto bp = static_cast<const __nv_bfloat16*>(b);
  auto st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(nsplit > 1 ? partial : y);
  cudaError_t err;
  if (S < 1 || ndots < 1)
    err = cudaErrorInvalidValue;
  else if (dh == 64)
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

// Compiled attributes of the qk (pv = 0) or pv kernel at head dim dh: out[0]
// registers per thread, out[1] local (spill) bytes per thread, out[2] static
// shared bytes, out[3] the dynamic shared bytes it launches with at S.
extern "C" int sc_dotk_attributes(int pv, int dh, int S, int* out) {
  cudaError_t err;
  if (pv && dh == 64)
    err = sc::kernel_attributes(sc::dotk_pv_kernel<64>, sc::PvLayout<64>::bytes(S), out);
  else if (pv && dh == 128)
    err = sc::kernel_attributes(sc::dotk_pv_kernel<128>, sc::PvLayout<128>::bytes(S), out);
  else if (dh == 64)
    err = sc::kernel_attributes(sc::dotk_qk_kernel<64>, sc::QkLayout<64>::bytes, out);
  else if (dh == 128)
    err = sc::kernel_attributes(sc::dotk_qk_kernel<128>, sc::QkLayout<128>::bytes, out);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
