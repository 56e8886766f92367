// GQA attention over a sequential page pool: one-token decode over bf16 pages
// (K4) or int8 pages with per-(token, head) f32 scales (K6), and the
// multi-query partial form of both for the speculative verify step (K7); and
// one-token decode through a page table over bf16 or int8 pages (K8, K9).
//
// Replaces the TPU kernels ops/paged_attention.py:paged_decode_attention_pallas_seq
// (K4, _seq_decode_kernel), paged_decode_attention_pallas_seq_int8 (K6,
// _seq_decode_int8_kernel) and paged_seq_attention_partial{,_int8} (K7,
// emit_ml=True), all via _seq_attention_call: pages in pool order (identity
// table at B = 1, statically partitioned rows at B > 1: row b owns pool pages
// [b * row_pages, (b + 1) * row_pages)), a per-row length mask. K4 and K6
// write the normalized bf16 output; K7 writes the unnormalized f32 (acc, m, l)
// of T in-flight queries against the pool (the length excludes the block),
// which the caller merges with the staged block under one softmax.
//
// On the H100 decode attention is bound by reading the KV pages (each byte is
// used by only g = Hq / Hkv query heads, g * T query rows for K7). The TPU grid
// gave one lane to each (row, kv head) and walked the pages in order; at batch
// 1 with 4 kv heads that would occupy 4 of 132 SMs. Here the page range is
// split into chunks of `pages_per_chunk` pages, one block per (chunk, kv head,
// row) — a 23k-token context gives ~180 blocks — and each block serves all
// query rows of its kv head (R = g * T, folded head-major as on the TPU: row
// g_i * T + t_i is query head hk * g + g_i at token t_i), so every K/V row is
// read once: warps take whole 256-byte K rows (coalesced) for the scores, then
// threads take V columns for P V. Each block writes an unnormalized f32
// partial (acc, m, l); a second small kernel merges the chunks with the
// online-softmax rule and either normalizes (K4, K6) or emits the merged
// partial with m clamped to -1e30 (K7; a row with no live key gets acc 0 and
// l 0). Chunks wholly past the row's length write m = -inf and are skipped by
// the merge.
//
// K6 and K7-int8 run on int8 pages. The scales commute out of both
// contractions (models/paged_kv.py PagedKVCacheInt8): s = (q . k_i8) * k_scale
// * D^-0.5, and the value row enters P V as v_scale * v_i8, so nothing is
// dequantized into memory and the page bytes read per token halve. Keys at or
// past the row's length are never loaded, so garbage (NaN or inf) in stale
// pages or scales cannot reach the accumulator.
//
// K8 and K9 replace ops/paged_attention.py:paged_decode_attention_pallas
// (_paged_decode_kernel) and paged_decode_attention_pallas_int8
// (_paged_decode_int8_kernel): a shared pool whose rows' pages are wherever
// the allocator put them, read through page_table [B, maxp] (-1 = unmapped).
// They are the same kernel with another addressing (the kTable template
// parameter, so K4, K6 and K7 keep their compile-time code): the chunks split
// a row's table slots [0, maxp), each block first loads its chunk's table
// entries into shared memory, and the page of position pos is
// table[b, pos / page_size] instead of b * row_pages + pos / page_size. As in
// the TPU kernel, a slot that is unmapped or at or past the row's length
// contributes no key, so its page is never read (NaN there cannot leak); a
// chunk with no live key writes m = -inf and a row with none gets 0. Each
// (page, head) row of page_size * D elements is one contiguous read. K9 reads
// k_scale[page, hk, slot] directly where the TPU kernel selected the head's
// scale row by a one-hot sum (a Mosaic workaround).
#include <type_traits>

#include "kernels.cuh"

namespace sc {
namespace {

constexpr int THREADS = 128, NWARPS = THREADS / 32;
// Query rows per kv head: K4 / K6 serve g <= 8 heads, K7 g * T <= 64 rows
// (T <= 9 tokens at g = 7).
constexpr int R_DECODE = 8, R_PARTIAL = 64;

__device__ __forceinline__ float page_val(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float page_val(int8_t v) { return static_cast<float>(v); }

// T is the page element type: __nv_bfloat16 (K4, K7) or int8_t (K6, K7-int8,
// with the per-(page, head, slot) scales k_scale / v_scale; null otherwise).
// The block's R = g * ntok query rows: row i is query head hk * g + i / ntok
// at token i % ntok. kTable (K8, K9): pages come from table [B, row_pages]
// (row_pages is then the table's width maxp), else from the row's partition.
template <int D, typename T, int R_MAX, bool kTable>
__global__ void __launch_bounds__(THREADS)
paged_partial_kernel(const __nv_bfloat16* __restrict__ q, int64_t qsb, int64_t qsh,
                     int64_t qst, int ntok, const T* __restrict__ k_pages,
                     const T* __restrict__ v_pages, const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale, const int* __restrict__ length,
                     const int* __restrict__ table, int row_pages, int page_size,
                     int pages_per_chunk, int nchunks, int g, int Hkv, float scale, float* __restrict__ acc_out,
                     float* __restrict__ m_out, float* __restrict__ l_out) {
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  // K4 / K6 serve one token with compile-time layout strides; K7 sizes its
  // shared memory to its rows.
  constexpr bool kDecode = R_MAX == R_DECODE;
  constexpr int KG = THREADS / D;          // key groups of the P V loop
  extern __shared__ __align__(16) float sm[];
  const int nt = kDecode ? 1 : ntok;
  const int rows = g * nt;
  const int rs = kDecode ? R_MAX : rows;   // row stride of the buffers
  const int chunk_keys = pages_per_chunk * page_size;
  float* qs = sm;                          // [rs][D]
  float* sc = qs + rs * D;                 // [rs][chunk_keys]
  float* red = sc + rs * chunk_keys;       // [KG][rs][D]
  int* pg = reinterpret_cast<int*>(red + rs * THREADS);  // [pages_per_chunk] (kTable)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int64_t part = ((int64_t)(b * Hkv + hk) * nchunks + c) * rows;
  const int key0 = c * chunk_keys;
  const int len = length[b];
  int nkeys = min(chunk_keys, len - key0);
  nkeys = min(nkeys, (row_pages - c * pages_per_chunk) * page_size);
  if (nkeys <= 0) {
    for (int i = tid; i < rows; i += THREADS) {
      m_out[part + i] = -INFINITY;
      l_out[part + i] = 0.0f;
    }
    return;
  }

  if constexpr (kTable) {
    for (int j = tid; j < pages_per_chunk; j += THREADS) {
      const int slot = c * pages_per_chunk + j;
      pg[j] = slot < row_pages ? table[(int64_t)b * row_pages + slot] : -1;
    }
  }
  for (int i = tid; i < rows * D; i += THREADS) {
    const int r = i / D;
    const int hq = hk * g + r / nt;
    qs[i] = __bfloat162float(q[b * qsb + hq * qsh + (r % nt) * qst + i % D]);
  }
  __syncthreads();

  // Scores: one warp per key row; lanes split D.
  constexpr int E = D / 32;
  const int64_t row_page0 = (int64_t)b * row_pages;
  for (int kk = warp; kk < nkeys; kk += NWARPS) {
    const int pos = key0 + kk;
    int64_t page = row_page0 + pos / page_size;
    if constexpr (kTable) {
      page = pg[kk / page_size];
      if (page < 0) {                        // unmapped: no key
        if (lane == 0)
          for (int i = 0; i < rows; ++i) sc[i * chunk_keys + kk] = -INFINITY;
        continue;
      }
    }
    const int64_t slot = (page * Hkv + hk) * page_size + pos % page_size;
    const T* kr = k_pages + slot * D + lane * E;
    float kv[E];
#pragma unroll
    for (int e = 0; e < E; ++e) kv[e] = page_val(kr[e]);
    const float ks = kInt8 ? k_scale[slot] : 1.0f;
    for (int i = 0; i < rows; ++i) {
      float s = 0.0f;
#pragma unroll
      for (int e = 0; e < E; ++e) s += qs[i * D + lane * E + e] * kv[e];
      s = warp_sum(s);
      if (lane == 0) sc[i * chunk_keys + kk] = kInt8 ? s * ks * scale : s * scale;
    }
  }
  __syncthreads();

  // Per-row max and exponent sum over the chunk.
  for (int i = warp; i < rows; i += NWARPS) {
    float mx = -INFINITY;
    for (int kk = lane; kk < nkeys; kk += 32) mx = fmaxf(mx, sc[i * chunk_keys + kk]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int kk = lane; kk < nkeys; kk += 32) {
      float p = expf(sc[i * chunk_keys + kk] - mx);
      if constexpr (kTable) p = mx == -INFINITY ? 0.0f : p;   // no mapped page
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
  const int d = tid % D, kg = tid / D;
  float acc[R_MAX];
#pragma unroll
  for (int i = 0; i < R_MAX; ++i) acc[i] = 0.0f;
  for (int kk = kg; kk < nkeys; kk += KG) {
    const int pos = key0 + kk;
    int64_t page = row_page0 + pos / page_size;
    if constexpr (kTable) {
      page = pg[kk / page_size];
      if (page < 0) continue;
    }
    const int64_t slot = (page * Hkv + hk) * page_size + pos % page_size;
    float vv = page_val(v_pages[slot * D + d]);
    if (kInt8) vv *= v_scale[slot];
#pragma unroll
    for (int i = 0; i < R_MAX; ++i)
      if (i < rows) acc[i] += sc[i * chunk_keys + kk] * vv;
  }
  if (KG > 1) {
#pragma unroll
    for (int i = 0; i < R_MAX; ++i)
      if (i < rows) red[(kg * rs + i) * D + d] = acc[i];
    __syncthreads();
    if (kg == 0) {
      for (int j = 1; j < KG; ++j)
#pragma unroll
        for (int i = 0; i < R_MAX; ++i)
          if (i < rows) acc[i] += red[(j * rs + i) * D + d];
    }
  }
  if (kg == 0) {
    for (int i = 0; i < rows; ++i) acc_out[(part + i) * D + d] = acc[i];
  }
}

// Merge the chunks of row x = hk * rows + i of batch row b (one block each,
// one thread per column): M = max_c m_c, L = sum_c l_c exp(m_c - M),
// o = sum_c acc_c exp(m_c - M). K4 / K6 write o / L as bf16 (0 where L == 0)
// to out[b, x]; K7 writes o, max(M, -1e30) and L to acc_o / m_o / l_o[b, x].
template <bool kPartial>
__global__ void paged_merge_kernel(const float* __restrict__ acc, const float* __restrict__ m,
                                   const float* __restrict__ l, __nv_bfloat16* __restrict__ out,
                                   float* __restrict__ acc_o, float* __restrict__ m_o,
                                   float* __restrict__ l_o, int nchunks, int rows, int Hkv,
                                   int D) {
  const int x = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int hk = x / rows, i = x % rows;
  const int64_t base = (int64_t)(b * Hkv + hk) * nchunks;
  float M = -INFINITY;
  for (int c = 0; c < nchunks; ++c) M = fmaxf(M, m[(base + c) * rows + i]);
  float L = 0.0f, o = 0.0f;
  if (M != -INFINITY) {
    for (int c = 0; c < nchunks; ++c) {
      const float mc = m[(base + c) * rows + i];
      if (mc == -INFINITY) continue;
      const float w = expf(mc - M);
      L += l[(base + c) * rows + i] * w;
      o += acc[((base + c) * rows + i) * D + d] * w;
    }
  }
  const int64_t row = (int64_t)b * gridDim.x + x;
  if constexpr (kPartial) {
    acc_o[row * D + d] = o;
    if (d == 0) {
      m_o[row] = fmaxf(M, -1e30f);
      l_o[row] = L;
    }
  } else {
    out[row * D + d] = __float2bfloat16(L > 0.0f ? o / L : 0.0f);
  }
}

// Pointers of one launch. kp / vp: one layer's contiguous [num_pages, Hkv,
// page_size, D] pages; ks / vs: [num_pages, Hkv, page_size] f32 scales (int8
// only); table: [B, maxp] int32 (K8, K9; null otherwise); acc / m / l: f32
// scratch [B, Hkv, nchunks, R(, D)]; out (K4, K6, K8, K9) or acc_o / m_o /
// l_o (K7): the result.
struct Args {
  const void* q;
  int64_t qsb, qsh, qst;
  const void* kp;
  const void* vp;
  const float* ks;
  const float* vs;
  const int* length;
  const int* table;
  float* acc;
  float* m;
  float* l;
  __nv_bfloat16* out;
  float* acc_o;
  float* m_o;
  float* l_o;
};

template <int D, typename T, int R_MAX, bool kTable>
cudaError_t launch(const Args& a, int ntok, int B, int Hq, int Hkv, int row_pages,
                   int page_size, int pages_per_chunk, float scale, cudaStream_t stream) {
  const int g = Hq / Hkv, rows = g * ntok;
  if (rows > R_MAX) return cudaErrorInvalidValue;
  const int nchunks = (row_pages + pages_per_chunk - 1) / pages_per_chunk;
  const size_t rs = R_MAX == R_DECODE ? R_MAX : rows;
  const size_t bytes = sizeof(float) * rs * (D + pages_per_chunk * page_size + THREADS) +
                       (kTable ? sizeof(int) * pages_per_chunk : 0);
  auto kernel = paged_partial_kernel<D, T, R_MAX, kTable>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(nchunks, Hkv, B), THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), a.qsb, a.qsh, a.qst, ntok,
      static_cast<const T*>(a.kp), static_cast<const T*>(a.vp), a.ks, a.vs, a.length, a.table,
      row_pages, page_size, pages_per_chunk, nchunks, g, Hkv, scale, a.acc, a.m, a.l);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(Hkv * rows, B);
  if (a.out)
    paged_merge_kernel<false><<<grid, D, 0, stream>>>(a.acc, a.m, a.l, a.out, nullptr,
                                                      nullptr, nullptr, nchunks, rows, Hkv, D);
  else
    paged_merge_kernel<true><<<grid, D, 0, stream>>>(a.acc, a.m, a.l, nullptr, a.acc_o, a.m_o,
                                                     a.l_o, nchunks, rows, Hkv, D);
  return cudaGetLastError();
}

template <typename T, int R_MAX, bool kTable>
int dispatch(const Args& a, int ntok, int B, int Hq, int Hkv, int row_pages, int page_size,
             int pages_per_chunk, int D, float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 64)
    err = launch<64, T, R_MAX, kTable>(a, ntok, B, Hq, Hkv, row_pages, page_size,
                                       pages_per_chunk, scale, st);
  else if (D == 128)
    err = launch<128, T, R_MAX, kTable>(a, ntok, B, Hq, Hkv, row_pages, page_size,
                                        pages_per_chunk, scale, st);
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
  const sc::Args a{q, qsb, qsh, 0, k_pages, v_pages, nullptr, nullptr, length, nullptr,
                   static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l),
                   static_cast<__nv_bfloat16*>(out), nullptr, nullptr, nullptr};
  return sc::dispatch<__nv_bfloat16, sc::R_DECODE, false>(a, 1, B, Hq, Hkv, row_pages, page_size,
                                                   pages_per_chunk, D, scale, stream);
}

// As sc_paged_decode over int8 pages; k_scale / v_scale: contiguous f32
// [num_pages, Hkv, page_size] of the same layer.
extern "C" int sc_paged_decode_int8(const void* q, int64_t qsb, int64_t qsh,
                                    const void* k_pages, const void* v_pages,
                                    const void* k_scale, const void* v_scale,
                                    const int* length, int B, int Hq, int Hkv, int row_pages,
                                    int page_size, int pages_per_chunk, int D, float scale,
                                    void* acc, void* m, void* l, void* out, void* stream) {
  const sc::Args a{q, qsb, qsh, 0, k_pages, v_pages, static_cast<const float*>(k_scale),
                   static_cast<const float*>(v_scale), length, nullptr,
                   static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l),
                   static_cast<__nv_bfloat16*>(out), nullptr, nullptr, nullptr};
  return sc::dispatch<int8_t, sc::R_DECODE, false>(a, 1, B, Hq, Hkv, row_pages, page_size,
                                            pages_per_chunk, D, scale, stream);
}

// K7: q [B, Hq, ntok, D] addressed by (qsb, qsh, qst) element strides, the
// pages and length as above (length counts pool tokens only); acc/m/l: f32
// scratch of [B, Hkv, nchunks, g * ntok(, D)]; acc_o [B, Hq, ntok, D], m_o and
// l_o [B, Hq, ntok]: contiguous f32 results.
extern "C" int sc_paged_seq_partial(const void* q, int64_t qsb, int64_t qsh, int64_t qst,
                                    int ntok, const void* k_pages, const void* v_pages,
                                    const int* length, int B, int Hq, int Hkv, int row_pages,
                                    int page_size, int pages_per_chunk, int D, float scale,
                                    void* acc, void* m, void* l, void* acc_o, void* m_o,
                                    void* l_o, void* stream) {
  const sc::Args a{q, qsb, qsh, qst, k_pages, v_pages, nullptr, nullptr, length, nullptr,
                   static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l),
                   nullptr, static_cast<float*>(acc_o), static_cast<float*>(m_o),
                   static_cast<float*>(l_o)};
  return sc::dispatch<__nv_bfloat16, sc::R_PARTIAL, false>(a, ntok, B, Hq, Hkv, row_pages, page_size,
                                                    pages_per_chunk, D, scale, stream);
}

// K7 over int8 pages with their f32 scales.
extern "C" int sc_paged_seq_partial_int8(const void* q, int64_t qsb, int64_t qsh, int64_t qst,
                                         int ntok, const void* k_pages, const void* v_pages,
                                         const void* k_scale, const void* v_scale,
                                         const int* length, int B, int Hq, int Hkv,
                                         int row_pages, int page_size, int pages_per_chunk,
                                         int D, float scale, void* acc, void* m, void* l,
                                         void* acc_o, void* m_o, void* l_o, void* stream) {
  const sc::Args a{q, qsb, qsh, qst, k_pages, v_pages, static_cast<const float*>(k_scale),
                   static_cast<const float*>(v_scale), length, nullptr,
                   static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l),
                   nullptr, static_cast<float*>(acc_o), static_cast<float*>(m_o),
                   static_cast<float*>(l_o)};
  return sc::dispatch<int8_t, sc::R_PARTIAL, false>(a, ntok, B, Hq, Hkv, row_pages, page_size,
                                             pages_per_chunk, D, scale, stream);
}

// K8: as sc_paged_decode over a shared pool read through table [B, maxp]
// int32 (-1 = unmapped; every entry must be -1 or a page of the pool);
// acc/m/l: f32 scratch of [B, Hkv, ceil(maxp / pages_per_chunk), g(, D)].
extern "C" int sc_paged_decode_table(const void* q, int64_t qsb, int64_t qsh,
                                     const void* k_pages, const void* v_pages, const int* table,
                                     const int* length, int B, int Hq, int Hkv, int maxp,
                                     int page_size, int pages_per_chunk, int D, float scale,
                                     void* acc, void* m, void* l, void* out, void* stream) {
  const sc::Args a{q, qsb, qsh, 0, k_pages, v_pages, nullptr, nullptr, length, table,
                   static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l),
                   static_cast<__nv_bfloat16*>(out), nullptr, nullptr, nullptr};
  return sc::dispatch<__nv_bfloat16, sc::R_DECODE, true>(a, 1, B, Hq, Hkv, maxp, page_size,
                                                         pages_per_chunk, D, scale, stream);
}

// K9: K8 over int8 pages with their f32 scales [num_pages, Hkv, page_size].
extern "C" int sc_paged_decode_table_int8(const void* q, int64_t qsb, int64_t qsh,
                                          const void* k_pages, const void* v_pages,
                                          const void* k_scale, const void* v_scale,
                                          const int* table, const int* length, int B, int Hq,
                                          int Hkv, int maxp, int page_size, int pages_per_chunk,
                                          int D, float scale, void* acc, void* m, void* l,
                                          void* out, void* stream) {
  const sc::Args a{q, qsb, qsh, 0, k_pages, v_pages, static_cast<const float*>(k_scale),
                   static_cast<const float*>(v_scale), length, table,
                   static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l),
                   static_cast<__nv_bfloat16*>(out), nullptr, nullptr, nullptr};
  return sc::dispatch<int8_t, sc::R_DECODE, true>(a, 1, B, Hq, Hkv, maxp, page_size,
                                                  pages_per_chunk, D, scale, stream);
}
