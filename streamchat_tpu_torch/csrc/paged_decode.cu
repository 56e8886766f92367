// GQA attention over a sequential page pool: one-token decode over bf16 pages
// (K4) or int8 pages with per-(token, head) f32 scales (K6), and the
// multi-query partial form of both for the speculative verify step (K7); and
// one-token decode through a page table over bf16 or int8 pages (K8, K9).
//
// Replaces the TPU kernels ops/paged_attention.py:paged_decode_attention_pallas_seq
// (K4, _seq_decode_kernel, :209), paged_decode_attention_pallas_seq_int8 (K6,
// _seq_decode_int8_kernel) and paged_seq_attention_partial{,_int8} (K7,
// emit_ml=True; the head-major row fold of _seq_partial, :505), all via
// _seq_attention_call (:530, pallas_call :614): pages in pool order (identity
// table at B = 1, statically partitioned rows at B > 1: row b owns pool pages
// [b * row_pages, (b + 1) * row_pages)), a per-row length mask. K4 and K6
// write the normalized bf16 output; K7 writes the unnormalized f32 (acc, m, l)
// of T in-flight queries against the pool (the length excludes the block),
// which the caller merges with the staged block under one softmax.
//
// What bounds them on the H100: bytes. Every K/V byte of the row's live
// pages is read once and used by only g = Hq / Hkv query rows (g * T for
// K7): 23,105 tokens of Qwen2-7B's 4 kv heads are 47.3 MB, 0.0141 ms at
// 3.35 TB/s, while even K7's 1.66 GFLOP take 1.7 us on the tensor cores.
//
// K4 and K7 (the bf16 pool) run paged_tc_kernel, designed for this card:
// - Split-K over the pool (flash-decoding): one block per (page range, kv
//   head, row). The wrapper picks the number of ranges from row_pages alone,
//   never from the length on the device (ops/paged_attention.paged_split):
//   one wave of two blocks on each SM wherever the pool has pages enough,
//   the pages cut as evenly as whole pages allow (sizes differ by at most
//   one). Ranges wholly past the row's length exit at once.
// - K and V arrive by TMA (one 4-D map per pool over [num_pages, Hkv,
//   page_size, D], boxes of 64 columns by 64 keys, 128-byte swizzle) into a
//   ring of six 64-key tiles that hold K and V in turn, one mbarrier each:
//   three key tiles ahead, up to 96 KB in flight a block, two blocks an SM
//   (one warpgroup of 128 threads and 97 KB of shared memory each). The
//   warpgroup's first thread issues the loads, refilling a slot once every
//   warp is past it: a producer warp would make ten warps an SM, which caps
//   a thread at 168 registers and serializes the wgmmas.
// - The block's query rows (g for K4, g * T head-major for K7; row
//   g_i * T + t_i is query head hk * g + g_i at token t_i) are one 64-row
//   wgmma M tile, padded with zero rows; Q stays in registers as wgmma's A
//   fragment. S = Q K^T is wgmma m64n64k16 (K K-major in shared memory),
//   the online softmax runs on S's registers (exp2, scale * log2 e folded
//   into one FMA), and O += P V is wgmma m64n{D}k16 with P from S's
//   registers as the A fragment and V as the MN-major B operand. S of the
//   next key tile goes to the tensor cores before the softmax of this one,
//   so the softmax hides its latency. Padded rows cost tensor-core cycles
//   only and are never written.
// - Masking: in the tile that holds the row's length, keys at or past it
//   are -inf before the max (by select, so NaN scores of stale keys vanish)
//   and V rows at or past it are zeroed in shared memory and fenced to the
//   async proxy before P V (0 * NaN is NaN in the tensor core). Tiles wholly
//   past the length are never loaded.
// - Each block writes an unnormalized f32 partial (acc, m, l); a second
//   kernel merges a row's ranges, the ranges' weights at once and the sum
//   in range order (no atomics, so two launches give equal bits), and
//   normalizes to bf16 (K4, 0 where L == 0) or emits acc, max(M, -1e30) and
//   L (K7).
// The page addressing (PoolPages) and the bf16 page type are the points
// where int8 pages with scales (K6, K7') and table addressing (K8, K9) will
// enter the same template; those four still run paged_partial_kernel below.
//
// paged_partial_kernel (K6, K7', K8, K9): the page range is split into
// chunks of `pages_per_chunk` pages, one block per (chunk, kv head, row), and
// each block serves all query rows of its kv head, so every K/V row is read
// once: warps take whole K rows (coalesced) for the scores, then threads take
// V columns for P V. It writes the same partials for the same merge kernel;
// chunks wholly past the row's length write m = -inf and are skipped by the
// merge.
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
// parameter, so K6 and K7-int8 keep their compile-time code): the chunks split
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

#include "hopper.cuh"
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

// ---- K4 and K7: split-K over the bf16 pool on TMA and wgmma ----

namespace tc {

using namespace hopper;

constexpr int KEYS = 64;      // keys per tile: half a 128-slot page
constexpr int SLOTS = 6;      // ring slots, holding K and V tiles in turn
constexpr int THREADS = 128;  // one warpgroup: the 64-row M tile
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

template <int D>
struct Ring {
  static constexpr int BOX = KEYS * 128;       // 64 rows of 64 bf16 (8 KB)
  static constexpr int TILE = (D / 64) * BOX;  // one [64, D] K or V tile
  static constexpr int bars = SLOTS * TILE;
  static constexpr int bytes = bars + 8 * SLOTS + 1024;  // + alignment slack
};

// The pool page that holds slot `slot` of row b's pages: row b owns pages
// [b * row_pages, (b + 1) * row_pages) of the partitioned pool.
struct PoolPages {
  int row_pages, page_size;
  __device__ int page(int b, int slot) const { return b * row_pages + slot; }
};

struct Params {
  const __nv_bfloat16* q;  // [B, Hq, ntok, D] through (qsb, qsh, qst)
  int64_t qsb, qsh, qst;
  const int* length;
  PoolPages pool;
  int ntok, g, Hkv, nranges;
  int q_words;  // q's pairs are 4-byte aligned (even strides, aligned base)
  float scale_log2;
  float* acc;  // partials [B, Hkv, nranges, g * ntok(, D)]
  float* m;
  float* l;
};

// Columns col, col + 1 of query row `row` of kv head hk (row g_i * ntok + t_i
// is query head hk * g + g_i at token t_i), as a bf16 pair.
__device__ __forceinline__ uint32_t q_pair(const Params& p, int b, int hk, int row, int col) {
  const int hq = hk * p.g + row / p.ntok;
  const __nv_bfloat16* src = p.q + b * p.qsb + hq * p.qsh + (row % p.ntok) * p.qst + col;
  if (p.q_words) return *reinterpret_cast<const uint32_t*>(src);
  const unsigned short* h = reinterpret_cast<const unsigned short*>(src);
  return static_cast<uint32_t>(h[0]) | (static_cast<uint32_t>(h[1]) << 16);
}

// Ring tile i of a block: K (i even) or V (i odd) of its key tile i / 2, into
// slot i % SLOTS, completing on that slot's barrier.
template <int D>
__device__ __forceinline__ void load_tile(uint8_t* smem, uint64_t* full, const CUtensorMap* kmap,
                                          const CUtensorMap* vmap, const Params& p, int b,
                                          int hk, int page0, int i) {
  using L = Ring<D>;
  const int s = i % SLOTS, t = i / 2, per_page = p.pool.page_size / KEYS;
  const int page = p.pool.page(b, page0 + t / per_page), key = (t % per_page) * KEYS;
  mbar_expect_tx(&full[s], L::TILE);
  for (int hf = 0; hf < D / 64; ++hf)
    tma_load_4d(smem + s * L::TILE + hf * L::BOX, i % 2 ? vmap : kmap, &full[s], 64 * hf, key,
                hk, page);
}

// One block: range blockIdx.x of row blockIdx.z's pages for kv head
// blockIdx.y, pages [r row_pages / nranges, (r + 1) row_pages / nranges) of
// the row. Its thread 0 also issues the ring's loads: SLOTS / 2 key tiles
// ahead, each slot refilled once all four warps are past it.
template <int D, int R_MAX>
__global__ void __launch_bounds__(THREADS, 2)
    paged_tc_kernel(__grid_constant__ const CUtensorMap kmap,
                    __grid_constant__ const CUtensorMap vmap, const Params p) {
  using L = Ring<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);

  const int r = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int rows = p.g * p.ntok, ps = p.pool.page_size;
  const int64_t part = ((int64_t)(b * p.Hkv + hk) * p.nranges + r) * rows;
  const int page0 = (int)((int64_t)r * p.pool.row_pages / p.nranges);
  const int page1 = (int)((int64_t)(r + 1) * p.pool.row_pages / p.nranges);
  const int nkeys = min((page1 - page0) * ps, p.length[b] - page0 * ps);
  if (nkeys <= 0) {  // no live key: m = -inf, l = 0 and acc = 0
    for (int i = threadIdx.x; i < rows; i += THREADS) {
      p.m[part + i] = -INFINITY;
      p.l[part + i] = 0.0f;
    }
    for (int i = threadIdx.x; i < rows * D; i += THREADS) p.acc[part * D + i] = 0.0f;
    return;
  }
  const int ntiles = (nkeys + KEYS - 1) / KEYS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < SLOTS; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
    tma_prefetch_map(&kmap);
    tma_prefetch_map(&vmap);
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < min(SLOTS, 2 * ntiles); ++i)
      load_tile<D>(smem, full, &kmap, &vmap, p, b, hk, page0, i);

  // In wgmma's accumulator layout this thread holds rows rr and
  // rr + 8 (rr = 16 warp + lane / 4) at columns 8 j + c2 + {0, 1}: element
  // 4 j + e is row rr + 8 (e >> 1), column 8 j + c2 + (e & 1). Q's A
  // fragment for k-step kk holds the same rows at columns 16 kk + c2 (+ 8).
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rr = 16 * warp + lane / 4, c2 = 2 * (lane % 4);
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = rr + 8 * (i & 1);
      qa[kk][i] = row < rows && 16 * warp < R_MAX
                      ? q_pair(p, b, hk, row, 16 * kk + 8 * (i >> 1) + c2)
                      : 0u;
    }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m2[2] = {-INFINITY, -INFINITY};  // running max, exp2 domain
  float lsum[2] = {0.0f, 0.0f};          // this thread's share of l

  // S = Q K^T of key tile t into s: issued, not waited for.
  auto issue_s = [&](int t, float(&s)[32]) {
    const int ik = 2 * t;
    mbar_wait(&full[ik % SLOTS], (ik / SLOTS) & 1);
    const uint32_t ka = smem_addr(smem + (ik % SLOTS) * L::TILE);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_rs_n64(s, qa[kk], desc_sw128(ka + (kk / 4) * L::BOX + (kk % 4) * 32, 16, 1024),
                   kk > 0);
    wgmma_commit();
  };

  // Key tile t, whose S is in sc: its row maxima rescale O, then S of tile
  // t + 1 goes to the tensor cores and the exponentials of tile t run on the
  // CUDA cores beside it, then O += P V; one wait covers both products, and
  // the slots of K(t + 1) and V(t) are refilled.
  auto step = [&](int t, float(&sc)[32], float(&next)[32]) {
    const int iv = 2 * t + 1, sv = iv % SLOTS;
    const int valid = nkeys - t * KEYS;  // live keys of this tile, > 0
    if (valid < KEYS) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * j + e] = 8 * j + c2 + (e & 1) < valid ? sc[4 * j + e] : -INFINITY;
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float alpha[2], mneg[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m2[h], mx[h] * p.scale_log2);
      alpha[h] = m_new == -INFINITY ? 1.0f : exp2f(m2[h] - m_new);
      mneg[h] = m_new == -INFINITY ? 0.0f : -m_new;
      m2[h] = m_new;
      lsum[h] *= alpha[h];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    if (t + 1 < ntiles) issue_s(t + 1, next);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      sc[i] = exp2f(fmaf(sc[i], p.scale_log2, mneg[h]));
      lsum[h] += sc[i];
    }

    uint32_t pa[KEYS / 16][4];
#pragma unroll
    for (int ks = 0; ks < KEYS / 16; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[ks][i] = pack_bf16x2(sc[8 * ks + 2 * i], sc[8 * ks + 2 * i + 1]);

    mbar_wait(&full[sv], (iv / SLOTS) & 1);
    uint8_t* vt = smem + sv * L::TILE;
    if (valid < KEYS) {
      // V rows at and past the length may hold NaN: zero them (whole
      // 128-byte rows, so the swizzle does not matter) before P V reads them.
      const int chunks = (KEYS - valid) * 8;
      for (int hf = 0; hf < D / 64; ++hf)
        for (int i = threadIdx.x; i < chunks; i += THREADS)
          reinterpret_cast<uint4*>(vt + hf * L::BOX + valid * 128)[i] = make_uint4(0, 0, 0, 0);
      fence_proxy_async();
      named_barrier_sync(1, THREADS);
    }
    const uint32_t va = smem_addr(vt);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KEYS / 16; ++ks) {
      const uint64_t db = desc_sw128(va + ks * 16 * 128, L::BOX, 1024);
      if constexpr (D == 128)
        wgmma_rs_n128_tb(o, pa[ks], db);
      else
        wgmma_rs_n64_tb(o, pa[ks], db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(next);
    named_barrier_sync(1, THREADS);  // every warp has read V(t) and K(t + 1)
    if (threadIdx.x == 0) {
      if (iv + SLOTS < 2 * ntiles)
        load_tile<D>(smem, full, &kmap, &vmap, p, b, hk, page0, iv + SLOTS);
      if (iv + 1 + SLOTS < 2 * ntiles)
        load_tile<D>(smem, full, &kmap, &vmap, p, b, hk, page0, iv + 1 + SLOTS);
    }
  };

  float s0[32], s1[32];
  issue_s(0, s0);
  wgmma_wait<0>();
  fence_regs(s0);
  named_barrier_sync(1, THREADS);  // every warp has read K(0)
  if (threadIdx.x == 0 && SLOTS < 2 * ntiles)
    load_tile<D>(smem, full, &kmap, &vmap, p, b, hk, page0, SLOTS);
  for (int t = 0; t < ntiles; t += 2) {  // two steps, so that s0 / s1 stay in registers
    step(t, s0, s1);
    if (t + 1 < ntiles) step(t + 1, s1, s0);
  }

  float l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = lsum[h] + __shfl_xor_sync(0xffffffffu, lsum[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = rr + 8 * h;
    if (row >= rows) continue;
    float* dst = p.acc + (part + row) * D + c2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
    if (lane % 4 == 0) {
      p.m[part + row] = m2[h] * LN2;
      p.l[part + row] = l[h];
    }
  }
}

// Thread groups of the merge, each summing every MERGE_GROUPS-th range.
constexpr int MERGE_GROUPS = 4;

// v reduced over the block (max or sum), in a fixed order: the same bits on
// every launch. red: one float per warp.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  v = kMax ? warp_max(v) : warp_sum(v);
  __syncthreads();  // red is free, and earlier shared writes are visible
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  v = red[0];
  for (int j = 1; j < (int)blockDim.x / 32; ++j) v = kMax ? fmaxf(v, red[j]) : v + red[j];
  return v;
}

// Merge the ranges of query row x = hk * rows + i of batch row b (one block
// each, MERGE_GROUPS threads per column): M = max_r m_r, w_r = exp(m_r - M)
// (0 for a range with no live key, whose acc is 0), L = sum_r l_r w_r and
// o = sum_r acc_r w_r, the weights taken by all threads at once, o summed by
// group (group j takes ranges j, j + MERGE_GROUPS, ... in order), then over
// the groups in order. K4 writes o / L as bf16 (0 where L == 0) to out[b, x]; K7
// writes o, max(M, -1e30) and L to acc_o / m_o / l_o[b, x].
template <bool kPartial>
__global__ void __launch_bounds__(MERGE_GROUPS * 128)
    merge_kernel(const float* __restrict__ acc, const float* __restrict__ m,
                 const float* __restrict__ l, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ acc_o, float* __restrict__ m_o, float* __restrict__ l_o,
                 int nranges, int rows, int Hkv) {
  extern __shared__ float w[];  // [nranges]
  __shared__ float red[MERGE_GROUPS * 4];
  __shared__ float part[MERGE_GROUPS - 1][128];
  const int x = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int D = blockDim.x / MERGE_GROUPS, d = tid % D, grp = tid / D;
  const int hk = x / rows, i = x % rows;
  const int64_t base = (int64_t)(b * Hkv + hk) * nranges;
  float mx = -INFINITY;
  for (int r = tid; r < nranges; r += blockDim.x) mx = fmaxf(mx, m[(base + r) * rows + i]);
  const float M = block_reduce<true>(mx, red);
  float ls = 0.0f;
  for (int r = tid; r < nranges; r += blockDim.x) {
    const float mr = m[(base + r) * rows + i];
    w[r] = mr == -INFINITY ? 0.0f : expf(mr - M);
    ls += l[(base + r) * rows + i] * w[r];
  }
  const float L = block_reduce<false>(ls, red);
  const float* a = acc + (base * rows + i) * D + d;
  const int64_t stride = (int64_t)rows * D;
  float o = 0.0f;
#pragma unroll 4
  for (int r = grp; r < nranges; r += MERGE_GROUPS) o = fmaf(a[r * stride], w[r], o);
  if (grp > 0) part[grp - 1][d] = o;
  __syncthreads();
  if (grp > 0) return;
  for (int j = 0; j < MERGE_GROUPS - 1; ++j) o += part[j][d];
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

template <int D, int R_MAX>
cudaError_t launch(const Args& a, int ntok, int B, int Hq, int Hkv, int row_pages,
                   int page_size, int nranges, float scale, cudaStream_t stream) {
  const int g = Hq / Hkv, rows = g * ntok;
  if (rows > R_MAX || page_size % KEYS || nranges < 1 || nranges > row_pages)
    return cudaErrorInvalidValue;
  const int64_t strides[3] = {(int64_t)Hkv * page_size * D, (int64_t)page_size * D, D};
  CUtensorMap km, vm;
  cudaError_t err = make_map_bf16(&km, a.kp, strides, B * row_pages, Hkv, page_size, D, KEYS);
  if (err == cudaSuccess)
    err = make_map_bf16(&vm, a.vp, strides, B * row_pages, Hkv, page_size, D, KEYS);
  if (err != cudaSuccess) return err;
  const int q_words = reinterpret_cast<uintptr_t>(a.q) % 4 == 0 && a.qsb % 2 == 0 &&
                      a.qsh % 2 == 0 && a.qst % 2 == 0;
  const Params p{static_cast<const __nv_bfloat16*>(a.q), a.qsb, a.qsh, a.qst, a.length,
                 PoolPages{row_pages, page_size}, ntok, g, Hkv, nranges, q_words,
                 scale * LOG2E, a.acc, a.m, a.l};
  auto kernel = paged_tc_kernel<D, R_MAX>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Ring<D>::bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(nranges, Hkv, B), THREADS, Ring<D>::bytes, stream>>>(km, vm, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(Hkv * rows, B);
  const size_t wbytes = sizeof(float) * nranges;
  if (a.out)
    merge_kernel<false><<<grid, MERGE_GROUPS * D, wbytes, stream>>>(
        a.acc, a.m, a.l, a.out, nullptr, nullptr, nullptr, nranges, rows, Hkv);
  else
    merge_kernel<true><<<grid, MERGE_GROUPS * D, wbytes, stream>>>(
        a.acc, a.m, a.l, nullptr, a.acc_o, a.m_o, a.l_o, nranges, rows, Hkv);
  return cudaGetLastError();
}

template <int R_MAX>
int dispatch(const Args& a, int ntok, int B, int Hq, int Hkv, int row_pages, int page_size,
             int nranges, int D, float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 64)
    err = launch<64, R_MAX>(a, ntok, B, Hq, Hkv, row_pages, page_size, nranges, scale, st);
  else if (D == 128)
    err = launch<128, R_MAX>(a, ntok, B, Hq, Hkv, row_pages, page_size, nranges, scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

template <int D, int R_MAX>
cudaError_t attributes(int* out) {
  auto kernel = paged_tc_kernel<D, R_MAX>;
  cudaFuncAttributes a{};
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Ring<D>::bytes);
  int resident = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, THREADS,
                                                        Ring<D>::bytes);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = Ring<D>::bytes;
  out[4] = resident;
  return cudaSuccess;
}

}  // namespace tc
}  // namespace
}  // namespace sc

// K4. q: [B, Hq, 1, D] addressed by (qsb, qsh) element strides; pages:
// contiguous [num_pages, Hkv, page_size, D] of one layer (page_size a
// multiple of 64); length: [B] int32 on the device; each row's pages split
// into `pages_per_chunk` ranges as even as whole pages allow (the argument
// keeps K6's place and type; 1 <= ranges <= row_pages); acc/m/l: f32
// scratch of [B, Hkv, ranges, g(, D)]; out: [B, Hq, D].
extern "C" int sc_paged_decode(const void* q, int64_t qsb, int64_t qsh, const void* k_pages,
                               const void* v_pages, const int* length, int B, int Hq,
                               int Hkv, int row_pages, int page_size, int pages_per_chunk,
                               int D, float scale, void* acc, void* m, void* l, void* out,
                               void* stream) {
  const sc::Args a{q, qsb, qsh, 0, k_pages, v_pages, nullptr, nullptr, length, nullptr,
                   static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l),
                   static_cast<__nv_bfloat16*>(out), nullptr, nullptr, nullptr};
  return sc::tc::dispatch<sc::R_DECODE>(a, 1, B, Hq, Hkv, row_pages, page_size, pages_per_chunk,
                                        D, scale, stream);
}

// K6: as sc_paged_decode over int8 pages (any page_size); k_scale / v_scale:
// contiguous f32 [num_pages, Hkv, page_size] of the same layer.
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
// pages, length and ranges as for K4 (length counts pool tokens only); acc/m/l: f32
// scratch of [B, Hkv, ranges, g * ntok(, D)]; acc_o [B, Hq, ntok, D], m_o and
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
  return sc::tc::dispatch<sc::R_PARTIAL>(a, ntok, B, Hq, Hkv, row_pages, page_size,
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

// Compiled attributes of the K4 (partial = 0) or K7 (partial = 1) kernel for
// head dim D: out[0] registers per thread, out[1] local (spill) bytes per
// thread, out[2] static shared bytes, out[3] the dynamic shared bytes it
// launches with, out[4] the blocks resident on one SM.
extern "C" int sc_paged_decode_attributes(int D, int partial, int* out) {
  cudaError_t err;
  if (D == 64)
    err = partial ? sc::tc::attributes<64, sc::R_PARTIAL>(out)
                  : sc::tc::attributes<64, sc::R_DECODE>(out);
  else if (D == 128)
    err = partial ? sc::tc::attributes<128, sc::R_PARTIAL>(out)
                  : sc::tc::attributes<128, sc::R_DECODE>(out);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
