// The paged decode step's elementwise glue (ops/decode_glue.py): add + RMSNorm,
// bias + RoPE + KV append, SiLU x up.
//
// Replaces no TPU kernel: on the TPU, XLA fuses this glue into the decode step's
// one program (streamchat_tpu/models/paged_kv.py `decode_step_paged`). Eager
// PyTorch runs it as ~70-83 kernels a layer, each on a 1 x 3584 (or 1 x 128) tensor, so
// a batch-1 step's glue is bound by its launches and the gaps between them, not
// by its bytes (a layer's glue moves ~0.2 MB, well under a microsecond at
// 3.35 TB/s). The design is one launch for each stretch of glue between two
// GEMVs or the attention, four a layer, each reading its inputs once with
// 16-byte loads where rows allow it, and rounding where the eager code rounds:
// - add_rmsnorm: x += delta rounded to bf16 (in place: the residual stream),
//   then h = bf16((x * rsqrt(mean(x^2) + eps)) * scale) in f32; one block a
//   row, the sum of squares reduced in a fixed order (only that order differs
//   from the eager mean);
// - bias_rope_append: one block a (head, row) of q, k and v; the bias add in
//   bf16, HF rotate-half RoPE in f32 with full-precision cosf / sinf (positions
//   reach 23k) and no contracted multiply-adds, then k and v stored into the
//   row's tail page through its page table, as bf16 or quantized to int8 per
//   (token, head) as ops/decode_glue.quantize_kv does; returns the rotated q;
// - silu_mul: bf16(silu(f32(gate))) * up, rounded as the eager code rounds.
#include "kernels.cuh"

namespace sc {
namespace {

constexpr int NORM_THREADS = 256;
constexpr int NORM_MAX_VECS = 4;        // 16-byte vectors a thread: rows up to 8,192 wide
constexpr int ROPE_DH = 128;            // the head size bias_rope_append is built for
constexpr int ROPE_THREADS = ROPE_DH / 2;
constexpr int SILU_THREADS = 256;

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 u;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Grid: one block a row of x [rows, D] (D % 8 == 0, D <= 8 * NORM_THREADS *
// NORM_MAX_VECS). delta may be null (no residual add).
__global__ void __launch_bounds__(NORM_THREADS)
add_rmsnorm_kernel(__nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ delta,
                   const __nv_bfloat16* __restrict__ scale, __nv_bfloat16* __restrict__ h,
                   int D, float eps) {
  __shared__ float warp_ss[NORM_THREADS / 32];
  const int64_t base = (int64_t)blockIdx.x * D;
  const int nvec = D / 8;
  float v[NORM_MAX_VECS][8];
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < NORM_MAX_VECS; ++i) {
    const int c = threadIdx.x + i * NORM_THREADS;
    if (c >= nvec) break;
    uint4* xp = reinterpret_cast<uint4*>(x + base) + c;
    unpack8(*xp, v[i]);
    if (delta) {
      float d[8];
      unpack8(reinterpret_cast<const uint4*>(delta + base)[c], d);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[i][e] = __fadd_rn(v[i][e], d[e]);
      const uint4 sum = pack8(v[i]);
      *xp = sum;
      unpack8(sum, v[i]);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) ss = fmaf(v[i][e], v[i][e], ss);
  }
  ss = warp_sum(ss);
  if (threadIdx.x % 32 == 0) warp_ss[threadIdx.x / 32] = ss;
  __syncthreads();
  ss = 0.0f;
#pragma unroll
  for (int w = 0; w < NORM_THREADS / 32; ++w) ss += warp_ss[w];
  const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, 1.0f / D), eps));
#pragma unroll
  for (int i = 0; i < NORM_MAX_VECS; ++i) {
    const int c = threadIdx.x + i * NORM_THREADS;
    if (c >= nvec) break;
    float s[8], o[8];
    unpack8(reinterpret_cast<const uint4*>(scale)[c], s);
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = __fmul_rn(__fmul_rn(v[i][e], r), s[e]);
    reinterpret_cast<uint4*>(h + base)[c] = pack8(o);
  }
}

// Grid (hq + 2 * hkv, rows): block x < hq is q head x, then the k heads, then
// the v heads; thread j holds elements j and j + 64 of the head (the two
// halves RoPE pairs). q/k/v rows are q_stride / k_stride / v_stride elements
// apart; biases may be null. The layer's pools: k/v pages [num_pages, hkv,
// ps, 128] bf16, or int8 with k/v scales [num_pages, hkv, ps] f32 (k_scale
// non-null). The row's position is positions[row], or length[row] when
// positions is null; the new token goes to page page_table[row, length // ps]
// (a negative entry counts from the pool's end, as a torch index does) at
// slot length % ps.
__global__ void __launch_bounds__(ROPE_THREADS)
bias_rope_append_kernel(const __nv_bfloat16* __restrict__ q, int64_t q_stride,
                        const __nv_bfloat16* __restrict__ k, int64_t k_stride,
                        const __nv_bfloat16* __restrict__ v, int64_t v_stride,
                        const __nv_bfloat16* __restrict__ bq, const __nv_bfloat16* __restrict__ bk,
                        const __nv_bfloat16* __restrict__ bv, const float* __restrict__ inv_freq,
                        const int* __restrict__ positions, const int* __restrict__ length,
                        const int* __restrict__ page_table, int maxp, void* __restrict__ k_pages,
                        void* __restrict__ v_pages, float* __restrict__ k_scale,
                        float* __restrict__ v_scale, int num_pages, int hq, int hkv, int ps,
                        __nv_bfloat16* __restrict__ q_out) {
  __shared__ float warp_amax[ROPE_THREADS / 32];
  const int row = blockIdx.y, j = threadIdx.x;
  int head = blockIdx.x, kind = 0;           // 0 q, 1 k, 2 v
  if (head >= hq + hkv) {
    kind = 2;
    head -= hq + hkv;
  } else if (head >= hq) {
    kind = 1;
    head -= hq;
  }
  const __nv_bfloat16* src = kind == 0 ? q + row * q_stride
                             : kind == 1 ? k + row * k_stride : v + row * v_stride;
  const __nv_bfloat16* bias = kind == 0 ? bq : kind == 1 ? bk : bv;
  src += head * ROPE_DH;
  float a = __bfloat162float(src[j]), b = __bfloat162float(src[j + ROPE_THREADS]);
  if (bias) {
    bias += head * ROPE_DH;
    a = round_bf16(__fadd_rn(a, __bfloat162float(bias[j])));
    b = round_bf16(__fadd_rn(b, __bfloat162float(bias[j + ROPE_THREADS])));
  }
  const int len = length[row];
  if (kind != 2) {
    const float pos = (float)(positions ? positions[row] : len);
    const float ang = __fmul_rn(pos, inv_freq[j]);
    const float c = cosf(ang), s = sinf(ang);
    const float lo = __fsub_rn(__fmul_rn(a, c), __fmul_rn(b, s));
    const float hi = __fadd_rn(__fmul_rn(b, c), __fmul_rn(a, s));
    a = round_bf16(lo);
    b = round_bf16(hi);
  }
  if (kind == 0) {
    __nv_bfloat16* dst = q_out + ((int64_t)row * hq + head) * ROPE_DH;
    dst[j] = __float2bfloat16(a);
    dst[j + ROPE_THREADS] = __float2bfloat16(b);
    return;
  }
  const int slot = len / ps;
  if (slot >= maxp) return;                  // past the row's table: nothing is mapped there
  int page = page_table[(int64_t)row * maxp + slot];
  if (page < 0) page += num_pages;
  const int64_t at = ((int64_t)page * hkv + head) * ps + len % ps;
  void* pages = kind == 1 ? k_pages : v_pages;
  if (!k_scale) {
    __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(pages) + at * ROPE_DH;
    dst[j] = __float2bfloat16(a);
    dst[j + ROPE_THREADS] = __float2bfloat16(b);
    return;
  }
  float amax = warp_max(fmaxf(fabsf(a), fabsf(b)));
  if (j % 32 == 0) warp_amax[j / 32] = amax;
  __syncthreads();
  amax = fmaxf(warp_amax[0], warp_amax[1]);
  // amax / 127 as PyTorch's CUDA division by a host scalar computes it: the
  // product with the scalar's reciprocal.
  const float sc = amax == 0.0f ? 1.0f : __fmul_rn(amax, 1.0f / 127.0f);
  int8_t* dst = static_cast<int8_t*>(pages) + at * ROPE_DH;
  dst[j] = static_cast<int8_t>(fminf(fmaxf(rintf(__fdiv_rn(a, sc)), -127.0f), 127.0f));
  dst[j + ROPE_THREADS] =
      static_cast<int8_t>(fminf(fmaxf(rintf(__fdiv_rn(b, sc)), -127.0f), 127.0f));
  if (j == 0) (kind == 1 ? k_scale : v_scale)[at] = sc;
}

// One thread a 16-byte vector of out [rows, F] (F % 8 == 0); gate / up rows
// are gate_stride / up_stride elements apart.
__global__ void __launch_bounds__(SILU_THREADS)
silu_mul_kernel(const __nv_bfloat16* __restrict__ gate, int64_t gate_stride,
                const __nv_bfloat16* __restrict__ up, int64_t up_stride,
                __nv_bfloat16* __restrict__ out, int F, int64_t total) {
  const int64_t t = (int64_t)blockIdx.x * SILU_THREADS + threadIdx.x;
  if (t >= total) return;
  const int vec_row = F / 8;
  const int64_t row = t / vec_row;
  const int c = (int)(t % vec_row);
  float g[8], u[8], o[8];
  unpack8(reinterpret_cast<const uint4*>(gate + row * gate_stride)[c], g);
  unpack8(reinterpret_cast<const uint4*>(up + row * up_stride)[c], u);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float s = round_bf16(__fdiv_rn(g[e], __fadd_rn(1.0f, expf(-g[e]))));
    o[e] = __fmul_rn(s, u[e]);
  }
  reinterpret_cast<uint4*>(out + row * (int64_t)F)[c] = pack8(o);
}

}  // namespace
}  // namespace sc

// x [rows, D] bf16, updated in place to x + delta (delta null: unchanged);
// h [rows, D] bf16 out; scale [D] bf16. D % 8 == 0, D <= 8192, 16-byte
// aligned rows.
extern "C" int sc_add_rmsnorm(void* x, const void* delta, const void* scale, void* h, int rows,
                              int D, float eps, void* stream) {
  if (rows < 1 || D % 8 || D > 8 * sc::NORM_THREADS * sc::NORM_MAX_VECS)
    return static_cast<int>(cudaErrorInvalidValue);
  sc::add_rmsnorm_kernel<<<rows, sc::NORM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<__nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(delta),
      static_cast<const __nv_bfloat16*>(scale), static_cast<__nv_bfloat16*>(h), D, eps);
  return static_cast<int>(cudaGetLastError());
}

// q [rows, hq * 128], k / v [rows, hkv * 128] bf16 (row strides in
// elements); bq / bk / bv bf16 or all null; inv_freq [64] f32; positions
// [rows] int32 or null; length [rows] int32; page_table [rows, maxp] int32;
// k_pages / v_pages one layer's [num_pages, hkv, ps, 128], bf16 when k_scale
// is null, else int8 with k_scale / v_scale [num_pages, hkv, ps] f32; q_out
// [rows, hq, 1, 128] bf16. rows <= 65535 (the grid's second dimension).
extern "C" int sc_bias_rope_append(const void* q, int64_t q_stride, const void* k,
                                   int64_t k_stride, const void* v, int64_t v_stride,
                                   const void* bq, const void* bk, const void* bv,
                                   const void* inv_freq, const void* positions,
                                   const void* length, const void* page_table, int maxp,
                                   void* k_pages, void* v_pages, void* k_scale, void* v_scale,
                                   int num_pages, int hq, int hkv, int ps, int rows,
                                   void* q_out, void* stream) {
  if (rows < 1 || rows > 65535 || hq < 1 || hkv < 1 || ps < 1 || maxp < 1 || num_pages < 1 ||
      (k_scale == nullptr) != (v_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(hq + 2 * hkv, rows);
  sc::bias_rope_append_kernel<<<grid, sc::ROPE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), q_stride, static_cast<const __nv_bfloat16*>(k),
      k_stride, static_cast<const __nv_bfloat16*>(v), v_stride,
      static_cast<const __nv_bfloat16*>(bq), static_cast<const __nv_bfloat16*>(bk),
      static_cast<const __nv_bfloat16*>(bv), static_cast<const float*>(inv_freq),
      static_cast<const int*>(positions), static_cast<const int*>(length),
      static_cast<const int*>(page_table), maxp, k_pages, v_pages,
      static_cast<float*>(k_scale), static_cast<float*>(v_scale), num_pages, hq, hkv, ps,
      static_cast<__nv_bfloat16*>(q_out));
  return static_cast<int>(cudaGetLastError());
}

// gate / up [rows, F] bf16 (row strides in elements, multiples of 8, 16-byte
// aligned); out [rows, F] bf16 contiguous. F % 8 == 0.
extern "C" int sc_silu_mul(const void* gate, int64_t gate_stride, const void* up,
                           int64_t up_stride, void* out, int rows, int F, void* stream) {
  if (rows < 1 || F < 8 || F % 8) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = (int64_t)rows * (F / 8);
  const unsigned blocks = (unsigned)((total + sc::SILU_THREADS - 1) / sc::SILU_THREADS);
  sc::silu_mul_kernel<<<blocks, sc::SILU_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(gate), gate_stride,
      static_cast<const __nv_bfloat16*>(up), up_stride, static_cast<__nv_bfloat16*>(out), F,
      total);
  return static_cast<int>(cudaGetLastError());
}
