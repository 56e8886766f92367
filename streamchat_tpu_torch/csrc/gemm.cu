// bf16 GEMM for Hopper with a fused bias / activation / residual epilogue.
//
// Replaces the matrix products inside the TPU kernels of ops/fused_vit.py:
// fused_vit_layer (_layer_kernel: QKV, O + residual, fc1 + quick_gelu,
// fc2 + residual), fused_ln_attn (_attn_kernel: QKV, O + residual) and
// fused_ln_mlp (_mlp_kernel: the projector's fc1 + erf-GELU and fc2). On the
// TPU those products ran on the MXU with the weights resident in VMEM.
//
// What bounds them on the H100: operations. One ViT-L layer over a 16-frame
// ingest batch (M = 9,232 rows; K x N = 1024 x 3072, 1024 x 1024,
// 1024 x 4096, 4096 x 1024) is 232 GFLOP, 0.235 ms at 989 TFLOP/s, against
// about 0.1 ms for its bytes. Only wgmma reaches the tensor cores' rate, and
// the operands must arrive without costing the math warps instructions. The
// design:
// - A block owns one 128 x BN output tile (BN = 128 or 256, chosen per call
//   by the wave count on the card's SMs; blocks in launch order walk n
//   fastest, so the tiles in flight share A's rows in L2) with three
//   warpgroups: a producer whose one thread issues TMA loads, and two
//   consumer warpgroups of 64 rows each (wgmma's M). setmaxnreg moves
//   registers from the producer (24) to the consumers (240); a 64 x 256 f32
//   accumulator is 128 of them.
// - A [M, K] (rows lda apart, K-major) and B [K, N] (row-major, so
//   MN-major, as V is for P V in flash_prefill.cu) arrive by TMA with
//   128-byte swizzle in 64-deep k-slabs (A: one 128-row box; B: BN / 64
//   boxes of 64 columns) into a 4-stage ring with a "full" and an "empty"
//   mbarrier per stage. A rows past M arrive as zeros.
// - Each k-slab is four wgmma m64nBNk16 products from shared-memory
//   descriptors (B's: LBO = 8 KB between its 64-column boxes, SBO = 1024
//   between 8-row groups of K). One slab's products stay in flight while the
//   next slab's are issued; a slab's stage is released once its products
//   have retired.
// - The epilogue runs on the accumulator registers: bias, activation (none,
//   quick-GELU x sigmoid(1.702 x), erf-GELU), residual (bf16 or f32, its own
//   leading dimension), then a bf16 or f32 store guarded at row M. The
//   [M, N] pre-activation never reaches device memory.
// - No split-K: every output element is one fixed-order sum, so repeated
//   calls are bit-equal.
// Left for later: the last wave (the N = 1024 products are 73 x 8 = 584
// tiles on 132 SMs, 4.4 waves), consumer warpgroups taking turns so one's
// epilogue runs under the other's products, a TMA store epilogue, the
// LayerNorm fused into the producer, clusters multicasting B. Measured at
// K1's shapes and set aside (PERF.md): persistent blocks carrying the ring
// across tiles (no gain), and the fast exp / division intrinsics in the
// quick-GELU (every product slower, whatever its activation).
#include "hopper.cuh"
#include "kernels.cuh"

namespace sc {
namespace {

using namespace hopper;

constexpr int BM = 128, BK = 64, STAGES = 4, CONSUMERS = 2;
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int A_BYTES = BM * BK * 2;  // one box: 128 rows of 64 bf16
constexpr int B_BOX = BK * 64 * 2;    // one box: 64 k-rows of 64 bf16 columns

template <int BN>
struct GemmLayout {
  static constexpr int stage = A_BYTES + (BN / 64) * B_BOX;
  static constexpr int bars = STAGES * stage;
  static constexpr int bytes = bars + 8 * 2 * STAGES + 1024;  // + alignment slack
};

struct Epilogue {
  const __nv_bfloat16* bias;
  const void* residual;
  int res_dtype;
  int64_t ldr;
  void* out;
  int out_dtype;
  int64_t ldc;
  int M, N, K, act;
};

__device__ __forceinline__ float activate(float x, int act) {
  if (act == kActQuickGelu) return x / (1.0f + expf(-1.702f * x));
  if (act == kActGelu) return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
  return x;
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 256)
    wgmma_ss_n256_tb(d, da, db, 1);
  else
    wgmma_ss_n128_tb(d, da, db, 1);
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_kernel(__grid_constant__ const CUtensorMap amap,
                __grid_constant__ const CUtensorMap bmap, const Epilogue e) {
  using L = GemmLayout<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + STAGES;

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int nk = e.K / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // Producer: one thread keeps the ring full.
    setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS * 128) {
      tma_prefetch_map(&amap);
      tma_prefetch_map(&bmap);
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % STAGES;
        if (kb >= STAGES) mbar_wait(&empty[s], ((kb / STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], L::stage);
        uint8_t* st = smem + s * L::stage;
        tma_load_4d(st, &amap, &full[s], kb * BK, m0, 0, 0);
        for (int j = 0; j < BN / 64; ++j)
          tma_load_4d(st + A_BYTES + j * B_BOX, &bmap, &full[s], n0 + 64 * j, kb * BK, 0, 0);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows m0 + 64 wg .. + 63. In wgmma's
  // accumulator layout this thread holds rows rr and rr + 8 of them
  // (rr = 16 warp + lane / 4) at columns 8 j + c2 + {0, 1}: element
  // 4 j + e is row rr + 8 (e >> 1), column 8 j + c2 + (e & 1).
  setmaxnreg_inc<240>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;

  for (int kb = 0; kb < nk; ++kb) {
    const int s = kb % STAGES;
    mbar_wait(&full[s], (kb / STAGES) & 1);
    const uint32_t a = smem_addr(smem + s * L::stage) + wg * 64 * 128;
    const uint32_t b = smem_addr(smem + s * L::stage + A_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_tile<BN>(acc, desc_sw128(a + kk * 32, 16, 1024),
                     desc_sw128(b + kk * 16 * 128, B_BOX, 1024));
    wgmma_commit();
    // The slab before this one has retired: release its stage.
    wgmma_wait<1>();
    fence_regs(acc);
    if (kb > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(kb - 1) % STAGES]);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  const int rr = 16 * warp + lane / 4, c2 = 2 * (lane % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + 64 * wg + rr + 8 * r;
    if (row >= e.M) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + c2;
      float v0 = acc[4 * j + 2 * r], v1 = acc[4 * j + 2 * r + 1];
      if (e.bias) {
        const float2 bb =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(e.bias + col));
        v0 += bb.x;
        v1 += bb.y;
      }
      v0 = activate(v0, e.act);
      v1 = activate(v1, e.act);
      if (e.residual) {
        const int64_t i = (int64_t)row * e.ldr + col;
        float2 rv;
        if (e.res_dtype == kF32)
          rv = *reinterpret_cast<const float2*>(static_cast<const float*>(e.residual) + i);
        else
          rv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              static_cast<const __nv_bfloat16*>(e.residual) + i));
        v0 += rv.x;
        v1 += rv.y;
      }
      const int64_t o = (int64_t)row * e.ldc + col;
      if (e.out_dtype == kF32)
        *reinterpret_cast<float2*>(static_cast<float*>(e.out) + o) = make_float2(v0, v1);
      else
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(e.out) + o) =
            pack_bf16x2(v0, v1);
    }
  }
}

int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 132;
    return count;
  }();
  return n;
}

// BN = 256 unless 128-wide tiles fill the card's SMs in fewer 256-wide
// tile-times (a 256-wide tile takes about twice a 128-wide one).
bool wide_tiles(int M, int N) {
  if (N % 256) return false;
  const int64_t mt = (M + BM - 1) / BM, sms = sm_count();
  const int64_t waves256 = (mt * (N / 256) + sms - 1) / sms;
  const int64_t waves128 = (mt * (N / 128) + sms - 1) / sms;
  return 2 * waves256 <= waves128;
}

template <int BN>
cudaError_t launch(const CUtensorMap& am, const CUtensorMap& bm, const Epilogue& e,
                   cudaStream_t stream) {
  constexpr int bytes = GemmLayout<BN>::bytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(e.N / BN, (e.M + BM - 1) / BM);
  gemm_kernel<BN><<<grid, THREADS, bytes, stream>>>(am, bm, e);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_gemm(const __nv_bfloat16* A, int64_t lda, const __nv_bfloat16* B,
                        const __nv_bfloat16* bias, const void* residual, int res_dtype,
                        int64_t ldr, void* out, int out_dtype, int64_t ldc, int M, int N,
                        int K, int act, cudaStream_t stream) {
  if (M == 0) return cudaSuccess;
  if (N <= 0 || N % 128 || K <= 0 || K % BK || lda % 8 || lda < K)
    return cudaErrorInvalidValue;
  CUtensorMap am, bm;
  const int64_t a_strides[3] = {0, 0, lda}, b_strides[3] = {0, 0, N};
  cudaError_t err = hopper::make_map_bf16(&am, A, a_strides, 1, 1, M, K, BM);
  if (err == cudaSuccess) err = hopper::make_map_bf16(&bm, B, b_strides, 1, 1, K, N, BK);
  if (err != cudaSuccess) return err;
  const Epilogue e{bias, residual, res_dtype, ldr, out, out_dtype, ldc, M, N, K, act};
  return wide_tiles(M, N) ? launch<256>(am, bm, e, stream) : launch<128>(am, bm, e, stream);
}

}  // namespace sc

// out[M, N] = act(A @ B + bias) (+ residual) on its own (the GEMM of K1,
// K2, K13 and K16, for tests and timing): see sc::launch_gemm.
extern "C" int sc_gemm(const void* A, int64_t lda, const void* B, const void* bias,
                       const void* residual, int res_dtype, int64_t ldr, void* out,
                       int out_dtype, int64_t ldc, int M, int N, int K, int act,
                       void* stream) {
  return static_cast<int>(sc::launch_gemm(
      static_cast<const __nv_bfloat16*>(A), lda, static_cast<const __nv_bfloat16*>(B),
      static_cast<const __nv_bfloat16*>(bias), residual, res_dtype, ldr, out, out_dtype, ldc,
      M, N, K, act, static_cast<cudaStream_t>(stream)));
}

// Compiled attributes of the GEMM kernel with BN-wide tiles (128 or 256):
// out[0] registers per thread, out[1] local (spill) bytes per thread,
// out[2] static shared bytes, out[3] the dynamic shared bytes it launches
// with, out[4] the tile width launch_gemm picks for an [M, N] output.
extern "C" int sc_gemm_attributes(int bn, int M, int N, int* out) {
  cudaFuncAttributes a{};
  cudaError_t err;
  if (bn == 128)
    err = cudaFuncGetAttributes(&a, sc::gemm_kernel<128>);
  else if (bn == 256)
    err = cudaFuncGetAttributes(&a, sc::gemm_kernel<256>);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = bn == 128 ? sc::GemmLayout<128>::bytes : sc::GemmLayout<256>::bytes;
  out[4] = sc::wide_tiles(M, N) ? 256 : 128;
  return 0;
}
