// Scene-change similarity of consecutive frame descriptors (K12).
//
// Replaces the TPU kernel ops/dedup.py:select_changed_frames (_dedup_kernel):
// sim[i] = <x_i / |x_i|, x_{i-1} / |x_{i-1}|> over descriptors x [N, D],
// with row 0 compared against row N - 1 (the TPU kernel's pltpu.roll wraps;
// the caller keeps frame 0 whatever its score). The TPU kernel normalized
// the whole [N, D] block in VMEM and multiplied it by its rolled copy. Here
// one block owns one row i: it reads rows i and (i - 1) mod N once (f32, or
// bf16 widened to f32), accumulates sum x_i^2, sum x_{i-1}^2 and
// sum x_i x_{i-1} in f32 registers, reduces them across the block with warp
// shuffles and one shared-memory step, and writes
// sim[i] = sum x_i x_{i-1} * rsqrt(sum x_i^2 + 1e-8) * rsqrt(sum x_{i-1}^2 + 1e-8),
// the TPU formula with the +1e-8 inside each rsqrt. The work is a read of
// the descriptors (each row by two blocks, the second read mostly from L2)
// and three multiply-adds per element: bound by device memory, and at a
// segment's N of ~60 rows of 3584 by the launch itself.
#include "kernels.cuh"

namespace sc {
namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
dedup_kernel(const void* __restrict__ x, int dtype, float* __restrict__ sim, int N, int D) {
  __shared__ float part[3][THREADS / 32];
  const int i = blockIdx.x;
  const int prev = (i + N - 1) % N;
  const int64_t a = (int64_t)i * D, b = (int64_t)prev * D;
  float saa = 0.0f, sbb = 0.0f, sab = 0.0f;
  for (int d = threadIdx.x; d < D; d += THREADS) {
    const float xa = load_as_float(x, dtype, a + d);
    const float xb = load_as_float(x, dtype, b + d);
    saa += xa * xa;
    sbb += xb * xb;
    sab += xa * xb;
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
    saa = lane < THREADS / 32 ? part[0][lane] : 0.0f;
    sbb = lane < THREADS / 32 ? part[1][lane] : 0.0f;
    sab = lane < THREADS / 32 ? part[2][lane] : 0.0f;
    saa = warp_sum(saa);
    sbb = warp_sum(sbb);
    sab = warp_sum(sab);
    if (lane == 0) sim[i] = sab * rsqrtf(saa + 1e-8f) * rsqrtf(sbb + 1e-8f);
  }
}

}  // namespace
}  // namespace sc

// x [N, D] f32 (dtype 1) or bf16 (dtype 0), contiguous; sim [N] f32.
extern "C" int sc_select_changed_frames(const void* x, int dtype, void* sim, int N, int D,
                                        void* stream) {
  if (N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  sc::dedup_kernel<<<N, sc::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, dtype, static_cast<float*>(sim), N, D);
  return static_cast<int>(cudaGetLastError());
}
