// One-token GQA decode attention over a sequential page pool, bf16 pages (K4)
// or int8 pages with per-(token, head) f32 scales (K6).
//
// Replaces the TPU kernels ops/paged_attention.py:paged_decode_attention_pallas_seq
// (K4, _seq_decode_kernel) and paged_decode_attention_pallas_seq_int8 (K6,
// _seq_decode_int8_kernel), both via _seq_attention_call: pages in pool order (identity
// table at B = 1, statically partitioned rows at B > 1: row b owns pool pages
// [b * row_pages, (b + 1) * row_pages)), a per-row length mask, normalized
// output.
//
// On the H100 decode attention is bound by reading the KV pages (each byte is
// used by only g = Hq / Hkv query heads). The TPU grid gave one lane to each
// (row, kv head) and walked the pages in order; at batch 1 with 4 kv heads
// that would occupy 4 of 132 SMs. Here the page range is split into chunks of
// `pages_per_chunk` pages, one block per (chunk, kv head, row) — a 23k-token
// context gives ~180 blocks — and each block serves all g query heads of its
// kv head, so every K/V row is read once: warps take whole 256-byte K rows
// (coalesced) for the scores, then threads take V columns for P V. Each
// block writes an unnormalized f32 partial (acc, m, l); a second small
// kernel merges the chunks with the online-softmax rule. Chunks wholly past
// the row's length write m = -inf and are skipped by the merge.
//
// K6 is the same kernel on int8 pages. The scales commute out of both
// contractions (models/paged_kv.py PagedKVCacheInt8): s = (q . k_i8) * k_scale
// * D^-0.5, and the value row enters P V as v_scale * v_i8, so nothing is
// dequantized into memory and the page bytes read per token halve. Keys at or
// past the row's length are never loaded, so garbage (NaN or inf) in stale
// pages or scales cannot reach the accumulator.
#include <type_traits>

#include "kernels.cuh"

namespace sc {
namespace {

constexpr int THREADS = 128, NWARPS = THREADS / 32, G_MAX = 8;

__device__ __forceinline__ float page_val(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float page_val(int8_t v) { return static_cast<float>(v); }

// T is the page element type: __nv_bfloat16 (K4) or int8_t (K6, with the
// per-(page, head, slot) scales k_scale / v_scale; null for K4).
template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
paged_partial_kernel(const __nv_bfloat16* __restrict__ q, int64_t qsb, int64_t qsh,
                     const T* __restrict__ k_pages, const T* __restrict__ v_pages,
                     const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                     const int* __restrict__ length, int row_pages, int page_size,
                     int pages_per_chunk, int nchunks, int g, int Hkv, float scale,
                     float* __restrict__ acc_out, float* __restrict__ m_out,
                     float* __restrict__ l_out) {
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  extern __shared__ __align__(16) float sm[];
  const int chunk_keys = pages_per_chunk * page_size;
  float* qs = sm;                         // [G_MAX][D]
  float* sc = qs + G_MAX * D;             // [G_MAX][chunk_keys]
  float* red = sc + G_MAX * chunk_keys;   // [THREADS / D][G_MAX][D]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int64_t part = ((int64_t)(b * Hkv + hk) * nchunks + c) * g;
  const int key0 = c * chunk_keys;
  const int len = length[b];
  int nkeys = min(chunk_keys, len - key0);
  nkeys = min(nkeys, (row_pages - c * pages_per_chunk) * page_size);
  if (nkeys <= 0) {
    if (tid < g) {
      m_out[part + tid] = -INFINITY;
      l_out[part + tid] = 0.0f;
    }
    return;
  }

  for (int i = tid; i < g * D; i += THREADS) {
    const int hq = hk * g + i / D;
    qs[i] = __bfloat162float(q[b * qsb + hq * qsh + i % D]);
  }
  __syncthreads();

  // Scores: one warp per key row; lanes split D.
  constexpr int E = D / 32;
  const int64_t row_page0 = (int64_t)b * row_pages;
  for (int kk = warp; kk < nkeys; kk += NWARPS) {
    const int pos = key0 + kk;
    const int64_t page = row_page0 + pos / page_size;
    const int64_t slot = (page * Hkv + hk) * page_size + pos % page_size;
    const T* kr = k_pages + slot * D + lane * E;
    float kv[E];
#pragma unroll
    for (int e = 0; e < E; ++e) kv[e] = page_val(kr[e]);
    const float ks = kInt8 ? k_scale[slot] : 1.0f;
    for (int i = 0; i < g; ++i) {
      float s = 0.0f;
#pragma unroll
      for (int e = 0; e < E; ++e) s += qs[i * D + lane * E + e] * kv[e];
      s = warp_sum(s);
      if (lane == 0) sc[i * chunk_keys + kk] = kInt8 ? s * ks * scale : s * scale;
    }
  }
  __syncthreads();

  // Per-head max and exponent sum over the chunk.
  for (int i = warp; i < g; i += NWARPS) {
    float mx = -INFINITY;
    for (int kk = lane; kk < nkeys; kk += 32) mx = fmaxf(mx, sc[i * chunk_keys + kk]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int kk = lane; kk < nkeys; kk += 32) {
      const float p = expf(sc[i * chunk_keys + kk] - mx);
      sc[i * chunk_keys + kk] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_out[part + i] = mx;
      l_out[part + i] = sum;
    }
  }
  __syncthreads();

  // acc[i][d] = sum_k p[i][k] V[k][d]; thread = (key group, column).
  constexpr int KG = THREADS / D;
  const int d = tid % D, kg = tid / D;
  float acc[G_MAX];
#pragma unroll
  for (int i = 0; i < G_MAX; ++i) acc[i] = 0.0f;
  for (int kk = kg; kk < nkeys; kk += KG) {
    const int pos = key0 + kk;
    const int64_t page = row_page0 + pos / page_size;
    const int64_t slot = (page * Hkv + hk) * page_size + pos % page_size;
    float vv = page_val(v_pages[slot * D + d]);
    if (kInt8) vv *= v_scale[slot];
#pragma unroll
    for (int i = 0; i < G_MAX; ++i)
      if (i < g) acc[i] += sc[i * chunk_keys + kk] * vv;
  }
  if (KG > 1) {
#pragma unroll
    for (int i = 0; i < G_MAX; ++i) red[(kg * G_MAX + i) * D + d] = acc[i];
    __syncthreads();
    if (kg == 0) {
      for (int j = 1; j < KG; ++j)
#pragma unroll
        for (int i = 0; i < G_MAX; ++i) acc[i] += red[(j * G_MAX + i) * D + d];
    }
  }
  if (kg == 0) {
    for (int i = 0; i < g; ++i) acc_out[(part + i) * D + d] = acc[i];
  }
}

// out[b, hq, :] = sum_c acc_c exp(m_c - M) / sum_c l_c exp(m_c - M)
__global__ void paged_merge_kernel(const float* __restrict__ acc, const float* __restrict__ m,
                                   const float* __restrict__ l, __nv_bfloat16* __restrict__ out,
                                   int nchunks, int g, int Hkv, int D) {
  const int hq = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int hk = hq / g, i = hq % g;
  const int64_t base = (int64_t)(b * Hkv + hk) * nchunks;
  float M = -INFINITY;
  for (int c = 0; c < nchunks; ++c) M = fmaxf(M, m[(base + c) * g + i]);
  float L = 0.0f, o = 0.0f;
  if (M != -INFINITY) {
    for (int c = 0; c < nchunks; ++c) {
      const float mc = m[(base + c) * g + i];
      if (mc == -INFINITY) continue;
      const float w = expf(mc - M);
      L += l[(base + c) * g + i] * w;
      o += acc[((base + c) * g + i) * D + d] * w;
    }
  }
  out[((int64_t)b * gridDim.x + hq) * D + d] = __float2bfloat16(L > 0.0f ? o / L : 0.0f);
}

template <int D, typename T>
cudaError_t launch(const __nv_bfloat16* q, int64_t qsb, int64_t qsh, const T* kp, const T* vp,
                   const float* ks, const float* vs, const int* length, int B, int Hq,
                   int Hkv, int row_pages, int page_size, int pages_per_chunk, float scale,
                   float* acc, float* m, float* l, __nv_bfloat16* out, cudaStream_t stream) {
  const int g = Hq / Hkv;
  const int nchunks = (row_pages + pages_per_chunk - 1) / pages_per_chunk;
  const size_t bytes =
      sizeof(float) * (G_MAX * D + G_MAX * pages_per_chunk * page_size + THREADS * G_MAX);
  cudaError_t err = cudaFuncSetAttribute(
      paged_partial_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  paged_partial_kernel<D, T><<<dim3(nchunks, Hkv, B), THREADS, bytes, stream>>>(
      q, qsb, qsh, kp, vp, ks, vs, length, row_pages, page_size, pages_per_chunk, nchunks,
      g, Hkv, scale, acc, m, l);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_merge_kernel<<<dim3(Hq, B), D, 0, stream>>>(acc, m, l, out, nchunks, g, Hkv, D);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, int64_t qsb, int64_t qsh, const void* k_pages, const void* v_pages,
             const void* k_scale, const void* v_scale, const int* length, int B, int Hq,
             int Hkv, int row_pages, int page_size, int pages_per_chunk, int D, float scale,
             void* acc, void* m, void* l, void* out, void* stream) {
  auto qp = static_cast<const __nv_bfloat16*>(q);
  auto kp = static_cast<const T*>(k_pages);
  auto vp = static_cast<const T*>(v_pages);
  auto ks = static_cast<const float*>(k_scale);
  auto vs = static_cast<const float*>(v_scale);
  auto st = static_cast<cudaStream_t>(stream);
  auto accp = static_cast<float*>(acc);
  auto mp = static_cast<float*>(m);
  auto lp = static_cast<float*>(l);
  auto op = static_cast<__nv_bfloat16*>(out);
  cudaError_t err;
  if (D == 64)
    err = launch<64, T>(qp, qsb, qsh, kp, vp, ks, vs, length, B, Hq, Hkv, row_pages,
                        page_size, pages_per_chunk, scale, accp, mp, lp, op, st);
  else if (D == 128)
    err = launch<128, T>(qp, qsb, qsh, kp, vp, ks, vs, length, B, Hq, Hkv, row_pages,
                         page_size, pages_per_chunk, scale, accp, mp, lp, op, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace
}  // namespace sc

// q: [B, Hq, 1, D] addressed by (qsb, qsh) element strides; pages: contiguous
// [num_pages, Hkv, page_size, D] of one layer; length: [B] int32 on the
// device; acc/m/l: f32 scratch of [B, Hkv, nchunks, g(, D)]; out: [B, Hq, D].
extern "C" int sc_paged_decode(const void* q, int64_t qsb, int64_t qsh, const void* k_pages,
                               const void* v_pages, const int* length, int B, int Hq,
                               int Hkv, int row_pages, int page_size, int pages_per_chunk,
                               int D, float scale, void* acc, void* m, void* l, void* out,
                               void* stream) {
  return sc::dispatch<__nv_bfloat16>(q, qsb, qsh, k_pages, v_pages, nullptr, nullptr, length,
                                     B, Hq, Hkv, row_pages, page_size, pages_per_chunk, D,
                                     scale, acc, m, l, out, stream);
}

// As sc_paged_decode over int8 pages; k_scale / v_scale: contiguous f32
// [num_pages, Hkv, page_size] of the same layer.
extern "C" int sc_paged_decode_int8(const void* q, int64_t qsb, int64_t qsh,
                                    const void* k_pages, const void* v_pages,
                                    const void* k_scale, const void* v_scale,
                                    const int* length, int B, int Hq, int Hkv, int row_pages,
                                    int page_size, int pages_per_chunk, int D, float scale,
                                    void* acc, void* m, void* l, void* out, void* stream) {
  return sc::dispatch<int8_t>(q, qsb, qsh, k_pages, v_pages, k_scale, v_scale, length, B, Hq,
                              Hkv, row_pages, page_size, pages_per_chunk, D, scale, acc, m, l,
                              out, stream);
}
