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
//           (^ 0x08080808, & 0x0F0F0F0F), the card's counterpart of the
//           TPU's i8-native lanes.
// The TPU grid was (block_out packed columns) x (gpb groups per k step). Here
// a block owns block_out packed columns (block_out / 4 threads, each reading
// its four packed bytes of a row with one 32-bit load, as K10's lanes do) and
// one k-slice of gpb groups; a thread sums each group's 128 rows into f32
// partials, scales them by the group's scales before they accumulate (K10's
// order), and the k-slices' partials are summed by the split-K reduce in a
// fixed order. Groups past the last (gpb not dividing the group count) are
// skipped, where the TPU kernel masked them. The GEMV is bound by reading the
// packed bytes (36 MB with the scales: 10.8 us at 3.35 TB/s); a small grid
// (20 blocks at block_out 1024, gpb 16) cannot reach that rate, which is what
// the sweep over the block shape shows. The dma variant folds every loaded
// word into one value and stores a flag when it equals a sentinel the caller
// passes, so the compiler keeps every load; the flag is never read.
#include "kernels.cuh"

namespace sc {
namespace {

constexpr int GROUP = 128, UNROLL = 16;
enum Variant : int { kDma = 0, kCast = 1, kCur = 2, kXor32 = 3, kXor8 = 4 };

__device__ __forceinline__ int sbyte(unsigned word, int j) {
  return static_cast<int>(static_cast<signed char>(word >> (8 * j)));
}

template <int NR, int V>
__global__ void __launch_bounds__(512)
int4_probe_kernel(const __nv_bfloat16* __restrict__ x, int n, int K,
                  const int8_t* __restrict__ w, const float* __restrict__ scale, int oh,
                  int block_out, int gpb, float* __restrict__ out, unsigned sentinel,
                  unsigned* __restrict__ flag) {
  __shared__ float xs[NR][GROUP];
  const int tid = threadIdx.x;
  const int pc = blockIdx.x * block_out + tid * 4;   // this thread's 4 packed columns
  const bool active = pc < oh;                       // oh % 4 == 0
  const int G = K / GROUP;
  const int g0 = blockIdx.y * gpb, g1 = min(G, g0 + gpb);
  const int cols = 2 * oh;

  float acc_lo[NR][4], acc_hi[NR][4];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_lo[r][j] = acc_hi[r][j] = 0.0f;
  unsigned live = 0;

  if (V == kDma && active) {   // the slice's first n rows, summed over slices
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      if (r >= n) break;
      const unsigned word =
          *reinterpret_cast<const unsigned*>(w + (int64_t)(g0 * GROUP + r) * oh + pc);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc_lo[r][j] = static_cast<float>(sbyte(word, j));
    }
  }

  for (int g = g0; g < g1; ++g) {
    if (V != kDma) {
      __syncthreads();                 // the previous group's readers of xs are done
      for (int i = tid; i < NR * GROUP; i += blockDim.x) {
        const int r = i / GROUP, kk = i % GROUP;
        xs[r][kk] = r < n ? __bfloat162float(x[(int64_t)r * K + g * GROUP + kk]) : 0.0f;
      }
      __syncthreads();
    }
    if (!active) continue;
    float plo[NR][4], phi[NR][4], sx[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      sx[r] = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) plo[r][j] = phi[r][j] = 0.0f;
    }
    for (int i0 = 0; i0 < GROUP; i0 += UNROLL) {
      unsigned words[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        words[u] = __ldcs(reinterpret_cast<const unsigned*>(
            w + (int64_t)(g * GROUP + i0 + u) * oh + pc));
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const unsigned word = words[u];
        if constexpr (V == kDma) {
          live ^= word;
        } else {
          float lo[4], hi[4];
          if constexpr (V == kXor8) {
            const unsigned wx = word ^ 0x08080808u, lw = wx & 0x0F0F0F0Fu;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              lo[j] = static_cast<float>((lw >> (8 * j)) & 0xFFu);
              hi[j] = static_cast<float>(sbyte(wx, j));
            }
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int b = sbyte(word, j);
              if constexpr (V == kCast) {
                lo[j] = hi[j] = static_cast<float>(b);
              } else if constexpr (V == kCur) {
                lo[j] = static_cast<float>(((b & 0xF) ^ 8) - 8);
                hi[j] = static_cast<float>(b >> 4);
              } else {   // kXor32
                const int u32 = b ^ 8;
                lo[j] = static_cast<float>(u32 & 0xF);
                hi[j] = static_cast<float>(u32);
              }
            }
          }
#pragma unroll
          for (int r = 0; r < NR; ++r) {
            const float xv = xs[r][i0 + u];
            if constexpr (V == kXor32 || V == kXor8) sx[r] += xv;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              plo[r][j] = fmaf(xv, lo[j], plo[r][j]);
              if constexpr (V != kCast) phi[r][j] = fmaf(xv, hi[j], phi[r][j]);
            }
          }
        }
      }
    }
    if constexpr (V != kDma) {
      float s_lo[4], s_hi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s_lo[j] = scale[((int64_t)g * 2) * oh + pc + j];
        s_hi[j] = scale[((int64_t)g * 2 + 1) * oh + pc + j];
      }
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float lo = plo[r][j], hi = V == kCast ? plo[r][j] : phi[r][j];
          if constexpr (V == kXor32 || V == kXor8) {
            hi = (phi[r][j] - plo[r][j]) * 0.0625f;
            lo = plo[r][j] - 8.0f * sx[r];
          }
          acc_lo[r][j] += lo * s_lo[j];
          acc_hi[r][j] += hi * s_hi[j];
        }
    }
  }

  if (!active) return;
  if (V == kDma && live == sentinel) *flag = 1u;
  float* o = out + (int64_t)blockIdx.y * n * cols;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    if (r >= n) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[(int64_t)r * cols + pc + j] = acc_lo[r][j];
      o[(int64_t)r * cols + oh + pc + j] = acc_hi[r][j];
    }
  }
}

template <int NR>
cudaError_t launch_probe(int variant, dim3 grid, int threads, const __nv_bfloat16* x, int n,
                         int K, const int8_t* w, const float* scale, int oh, int block_out,
                         int gpb, float* out, unsigned sentinel, unsigned* flag,
                         cudaStream_t st) {
#define SC_PROBE(V)                                                                        \
  int4_probe_kernel<NR, V><<<grid, threads, 0, st>>>(x, n, K, w, scale, oh, block_out, gpb, \
                                                     out, sentinel, flag)
  switch (variant) {
    case kDma: SC_PROBE(kDma); break;
    case kCast: SC_PROBE(kCast); break;
    case kCur: SC_PROBE(kCur); break;
    case kXor32: SC_PROBE(kXor32); break;
    case kXor8: SC_PROBE(kXor8); break;
    default: return cudaErrorInvalidValue;
  }
#undef SC_PROBE
  return cudaGetLastError();
}

}  // namespace
}  // namespace sc

// x: contiguous bf16 [n, K], n <= 8, K % 128 == 0; w: contiguous int8 [K, oh],
// oh % 4 == 0, 4-byte aligned; scale: f32 [K / 128, 2, oh]; y: f32 [n, 2 oh].
// variant 0-4: dma, cast, cur, xor32, xor8. block_out: packed columns per
// block (a multiple of 128, at most 2048); gpb: groups per k-slice; nsplit =
// ceil((K / 128) / gpb) slices, and with nsplit > 1 partial is f32 [nsplit, n,
// 2 oh] scratch. flag: one uint32 the dma variant may write (never read).
extern "C" int sc_int4_probe(const void* x, int n, int K, const void* w, const void* scale,
                             int oh, int variant, int block_out, int gpb, int nsplit,
                             void* partial, void* y, unsigned sentinel, void* flag,
                             void* stream) {
  if (K % sc::GROUP || block_out % 128 || block_out > 2048 || gpb < 1 || n < 1 || n > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((oh + block_out - 1) / block_out, nsplit);
  const int threads = block_out / 4;
  auto xp = static_cast<const __nv_bfloat16*>(x);
  auto wp = static_cast<const int8_t*>(w);
  auto sp = static_cast<const float*>(scale);
  auto st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(nsplit > 1 ? partial : y);
  auto fp = static_cast<unsigned*>(flag);
  cudaError_t err =
      n == 1 ? sc::launch_probe<1>(variant, grid, threads, xp, n, K, wp, sp, oh, block_out, gpb,
                                   out, sentinel, fp, st)
             : sc::launch_probe<8>(variant, grid, threads, xp, n, K, wp, sp, oh, block_out, gpb,
                                   out, sentinel, fp, st);
  if (err != cudaSuccess || nsplit == 1) return static_cast<int>(err);
  return static_cast<int>(sc::launch_splitk_reduce(static_cast<const float*>(partial), nsplit,
                                                   n, 2 * oh, nullptr, y, /*out_f32=*/1, st));
}
