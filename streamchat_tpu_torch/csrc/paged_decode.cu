// One-token GQA decode attention over a sequential page pool.
//
// Replaces the TPU kernel ops/paged_attention.py:paged_decode_attention_pallas_seq
// (_seq_decode_kernel via _seq_attention_call): pages in pool order (identity
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
#include "kernels.cuh"

namespace sc {
namespace {

constexpr int THREADS = 128, NWARPS = THREADS / 32, G_MAX = 8;

template <int D>
__global__ void __launch_bounds__(THREADS)
paged_partial_kernel(const __nv_bfloat16* __restrict__ q, int64_t qsb, int64_t qsh,
                     const __nv_bfloat16* __restrict__ k_pages,
                     const __nv_bfloat16* __restrict__ v_pages,
                     const int* __restrict__ length, int row_pages, int page_size,
                     int pages_per_chunk, int nchunks, int g, int Hkv, float scale,
                     float* __restrict__ acc_out, float* __restrict__ m_out,
                     float* __restrict__ l_out) {
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
    const __nv_bfloat16* kr =
        k_pages + ((page * Hkv + hk) * page_size + pos % page_size) * D + lane * E;
    float kv[E];
#pragma unroll
    for (int e = 0; e < E; ++e) kv[e] = __bfloat162float(kr[e]);
    for (int i = 0; i < g; ++i) {
      float s = 0.0f;
#pragma unroll
      for (int e = 0; e < E; ++e) s += qs[i * D + lane * E + e] * kv[e];
      s = warp_sum(s);
      if (lane == 0) sc[i * chunk_keys + kk] = s * scale;
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
    const float vv = __bfloat162float(
        v_pages[((page * Hkv + hk) * page_size + pos % page_size) * D + d]);
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

template <int D>
cudaError_t launch(const __nv_bfloat16* q, int64_t qsb, int64_t qsh, const __nv_bfloat16* kp,
                   const __nv_bfloat16* vp, const int* length, int B, int Hq, int Hkv,
                   int row_pages, int page_size, int pages_per_chunk, float scale,
                   float* acc, float* m, float* l, __nv_bfloat16* out, cudaStream_t stream) {
  const int g = Hq / Hkv;
  const int nchunks = (row_pages + pages_per_chunk - 1) / pages_per_chunk;
  const size_t bytes =
      sizeof(float) * (G_MAX * D + G_MAX * pages_per_chunk * page_size + THREADS * G_MAX);
  cudaError_t err = cudaFuncSetAttribute(
      paged_partial_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  paged_partial_kernel<D><<<dim3(nchunks, Hkv, B), THREADS, bytes, stream>>>(
      q, qsb, qsh, kp, vp, length, row_pages, page_size, pages_per_chunk, nchunks, g, Hkv,
      scale, acc, m, l);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_merge_kernel<<<dim3(Hq, B), D, 0, stream>>>(acc, m, l, out, nchunks, g, Hkv, D);
  return cudaGetLastError();
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
  auto qp = static_cast<const __nv_bfloat16*>(q);
  auto kp = static_cast<const __nv_bfloat16*>(k_pages);
  auto vp = static_cast<const __nv_bfloat16*>(v_pages);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 64)
    err = sc::launch<64>(qp, qsb, qsh, kp, vp, length, B, Hq, Hkv, row_pages, page_size,
                         pages_per_chunk, scale, static_cast<float*>(acc),
                         static_cast<float*>(m), static_cast<float*>(l),
                         static_cast<__nv_bfloat16*>(out), st);
  else if (D == 128)
    err = sc::launch<128>(qp, qsb, qsh, kp, vp, length, B, Hq, Hkv, row_pages, page_size,
                          pages_per_chunk, scale, static_cast<float*>(acc),
                          static_cast<float*>(m), static_cast<float*>(l),
                          static_cast<__nv_bfloat16*>(out), st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
