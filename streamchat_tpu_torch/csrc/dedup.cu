// Scene-change similarity of consecutive frame descriptors (K12) on Hopper.
//
// Replaces the TPU kernel ops/dedup.py:select_changed_frames (_dedup_kernel):
// sim[i] = <x_i / |x_i|, x_{i-1} / |x_{i-1}|> over descriptors x [N, D]
// (f32 or bf16), with row 0 compared against row N - 1 (the TPU kernel's
// pltpu.roll wraps; the caller keeps frame 0 whatever its score). The TPU
// kernel normalized the whole [N, D] block in VMEM and multiplied it by its
// rolled copy; the result here is the same formula,
// sim[i] = sum x_i x_{i-1} * rsqrt(sum x_i^2 + 1e-8) * rsqrt(sum x_{i-1}^2 + 1e-8),
// with the +1e-8 inside each rsqrt.
//
// What bounds it: the bytes are one read of x (860 KB at a segment's
// [60, 3584] f32: 0.26 us at 3.35 TB/s), far below a launch (an empty
// kernel takes ~0.9 us of device time). So the pace is set by the launch and
// by how many DRAM round trips a block waits through one after another.
// Design:
// - One 256-thread block a row. A thread issues all of its loads of a pass
//   over both rows (UNROLL 16-byte vectors each: 4 f32 or 8 bf16, read past
//   L1) before its first multiply-add, so a row of up to 4,096 f32 (8,192
//   bf16) costs one round trip; longer rows take more passes.
// - The sums (sum x_i^2, sum x_{i-1}^2, sum x_i x_{i-1}) accumulate in f32
//   registers and are reduced with warp shuffles and one shared-memory step,
//   in a fixed order (equal bits on every launch).
// - A row starts on a 16-byte boundary only when D * bytes is a multiple of
//   16 (and the base is aligned); otherwise the same loop runs on scalar
//   loads (VEC false), UNROLL of them in flight a thread and row.
// - The grid is N blocks, fewer than the card's 132 SMs at a segment's 60
//   frames. Cutting each row over more blocks fills the card but needs their
//   partial sums to meet: a cluster barrier with distributed shared memory
//   or a last-block combine through global memory each cost more than the
//   idle SMs save at this size (measured: PERF.md section 6).
#include "kernels.cuh"

namespace sc {
namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;

__device__ __forceinline__ uint4 ld16(const void* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

__device__ __forceinline__ void acc3(float xa, float xb, float& saa, float& sbb, float& sab) {
  saa = fmaf(xa, xa, saa);
  sbb = fmaf(xb, xb, sbb);
  sab = fmaf(xa, xb, sab);
}

// The three sums over one 16-byte vector of each row.
template <typename T>
__device__ __forceinline__ void acc_vec(const uint4& a, const uint4& b, float& saa, float& sbb,
                                        float& sab) {
  const unsigned wa[4] = {a.x, a.y, a.z, a.w}, wb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (sizeof(T) == 4) {
      acc3(__uint_as_float(wa[k]), __uint_as_float(wb[k]), saa, sbb, sab);
    } else {    // two bf16 a word, the lower element in the low half
      acc3(__uint_as_float(wa[k] << 16), __uint_as_float(wb[k] << 16), saa, sbb, sab);
      acc3(__uint_as_float(wa[k] & 0xffff0000u), __uint_as_float(wb[k] & 0xffff0000u), saa,
           sbb, sab);
    }
  }
}

template <typename T>
__device__ __forceinline__ float ld1(const T* p) {
  if constexpr (sizeof(T) == 4) {
    return __ldg(reinterpret_cast<const float*>(p));
  } else {
    return __uint_as_float(static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p)))
                           << 16);
  }
}

// Block i: rows i and (i - 1) mod N.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
dedup_kernel(const T* __restrict__ x, float* __restrict__ sim, int N, int D) {
  constexpr int V = VEC ? 16 / static_cast<int>(sizeof(T)) : 1;
  constexpr int STEP = THREADS * V;
  __shared__ float part[3][WARPS];
  const int i = blockIdx.x;
  const int prev = i == 0 ? N - 1 : i - 1;
  const T* a = x + static_cast<int64_t>(i) * D;
  const T* b = x + static_cast<int64_t>(prev) * D;
  float saa = 0.0f, sbb = 0.0f, sab = 0.0f;
  for (int c = static_cast<int>(threadIdx.x) * V; c < D; c += STEP * UNROLL) {
    if constexpr (VEC) {
      uint4 ra[UNROLL], rb[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int cc = c + u * STEP;
        ra[u] = rb[u] = make_uint4(0u, 0u, 0u, 0u);
        if (cc < D) {
          ra[u] = ld16(a + cc);
          rb[u] = ld16(b + cc);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) acc_vec<T>(ra[u], rb[u], saa, sbb, sab);
    } else {
      float ra[UNROLL], rb[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int cc = c + u * STEP;
        ra[u] = rb[u] = 0.0f;
        if (cc < D) {
          ra[u] = ld1(a + cc);
          rb[u] = ld1(b + cc);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) acc3(ra[u], rb[u], saa, sbb, sab);
    }
  }
  saa = warp_sum(saa);
  sbb = warp_sum(sbb);
  sab = warp_sum(sab);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    part[0][warp] = saa;
    part[1][warp] = sbb;
    part[2][warp] = sab;
  }
  __syncthreads();
  if (warp == 0) {
    saa = lane < WARPS ? part[0][lane] : 0.0f;
    sbb = lane < WARPS ? part[1][lane] : 0.0f;
    sab = lane < WARPS ? part[2][lane] : 0.0f;
    saa = warp_sum(saa);
    sbb = warp_sum(sbb);
    sab = warp_sum(sab);
    if (lane == 0) sim[i] = sab * rsqrtf(saa + 1e-8f) * rsqrtf(sbb + 1e-8f);
  }
}

template <typename T>
void launch(const void* x, int vec, float* sim, int N, int D, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  if (vec) {
    dedup_kernel<T, true><<<N, THREADS, 0, stream>>>(xt, sim, N, D);
  } else {
    dedup_kernel<T, false><<<N, THREADS, 0, stream>>>(xt, sim, N, D);
  }
}

__global__ void empty_kernel() {}

}  // namespace
}  // namespace sc

// x [N, D] f32 (dtype 1) or bf16 (dtype 0), contiguous; sim [N] f32. vec 1
// takes 16-byte loads: the wrapper passes it only when D * bytes % 16 == 0
// and x is 16-byte aligned (ops/dedup.launch_plan).
extern "C" int sc_select_changed_frames(const void* x, int dtype, int vec, void* sim, int N,
                                        int D, void* stream) {
  const int v = dtype == sc::kF32 ? 4 : 8;
  if (N <= 0 || D <= 0 ||
      (vec && (static_cast<int64_t>(D) % v || reinterpret_cast<uintptr_t>(x) % 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(sim);
  if (dtype == sc::kF32) {
    sc::launch<float>(x, vec, out, N, D, st);
  } else {
    sc::launch<__nv_bfloat16>(x, vec, out, N, D, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// Compiled attributes of an instantiation (dtype as above, vec 0/1): out[0]
// registers a thread, out[1] local (spill) bytes a thread, out[2] static
// shared bytes.
extern "C" int sc_dedup_attributes(int dtype, int vec, int* out) {
  cudaFuncAttributes a{};
  cudaError_t err;
  if (dtype == sc::kF32) {
    err = vec ? cudaFuncGetAttributes(&a, sc::dedup_kernel<float, true>)
              : cudaFuncGetAttributes(&a, sc::dedup_kernel<float, false>);
  } else {
    err = vec ? cudaFuncGetAttributes(&a, sc::dedup_kernel<__nv_bfloat16, true>)
              : cudaFuncGetAttributes(&a, sc::dedup_kernel<__nv_bfloat16, false>);
  }
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  return static_cast<int>(err);
}

// An empty kernel of `blocks` x `threads`: the launch floor that a kernel as
// short as K12 is read against.
extern "C" int sc_empty_kernel(int blocks, int threads, void* stream) {
  sc::empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
