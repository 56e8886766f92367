// GQA attention over a sequential page pool: one-token decode over bf16 pages
// (K4) or int8 pages with per-(token, head) f32 scales (K6), and the
// multi-query partial form of both for the speculative verify step (K7,
// K7'); and one-token decode through a page table over bf16 or int8 pages
// (K8, K9).
//
// Replaces the TPU kernels ops/paged_attention.py:paged_decode_attention_pallas_seq
// (K4, _seq_decode_kernel, :209), paged_decode_attention_pallas_seq_int8 (K6,
// :423, _seq_decode_int8_kernel :295), paged_seq_attention_partial (K7, :454)
// and paged_seq_attention_partial_int8 (K7', :485; emit_ml=True, the
// head-major row fold of _seq_partial, :505), all via _seq_attention_call
// (:530, pallas_call :614): pages in pool order (identity table at B = 1,
// statically partitioned rows at B > 1: row b owns pool pages
// [b * row_pages, (b + 1) * row_pages)), a per-row length mask. K4 and K6
// write the normalized bf16 output; K7 and K7' write the unnormalized f32
// (acc, m, l) of T in-flight queries against the pool (the length excludes
// the block), which the caller merges with the staged block under one
// softmax.
//
// What bounds them on the H100: bytes. Every K/V byte of the row's live
// pages is read once and used by only g = Hq / Hkv query rows (g * T for
// K7, K7'): 23,105 tokens of Qwen2-7B's 4 kv heads are 47.3 MB of bf16
// pages (0.0141 ms at 3.35 TB/s) or 24.4 MB of int8 pages with their f32
// scales (0.0073 ms), while even K7's 1.66 GFLOP take 1.7 us on the tensor
// cores.
//
// All six (K8 and K9 below) run one design, paged_tc_kernel (bf16 pages)
// and its int8 twin paged_tc_i8_kernel:
// - Split-K over the pool (flash-decoding): one block per (page range, row
//   tile, kv head, row). The wrapper picks the number of ranges from
//   row_pages (K8 / K9: maxp) and the row tiles alone, never from the
//   length on the device (ops/paged_attention.paged_split): one wave of two
//   blocks on each SM wherever the pool has pages enough, the pages cut as
//   evenly as whole pages allow (sizes differ by at most one). Ranges wholly
//   past the row's length exit at once.
// - The block's query rows (g for K4 / K6 / K8 / K9, g * T head-major for
//   K7 / K7'; row g_i * T + t_i is query head hk * g + g_i at token t_i) are
//   cut into 64-row wgmma M tiles, one a block, padded with zero rows; Q
//   stays in registers as wgmma's A fragment. Any g * T is served: past 64
//   rows (T >= 10 at g 7) each tile's block re-reads its range's K/V, the tiles
//   of a range neighbours in launch order so that the second read comes
//   from L2. S = Q K^T is wgmma m64n64k16 (K K-major in shared memory), the
//   online softmax runs on S's registers (exp2, scale * log2 e folded into
//   one FMA), and O += P V is wgmma m64n{D}k16 with P from S's registers as
//   the A fragment and V as the MN-major B operand. S of the next key tile
//   goes to the tensor cores before the softmax of this one, so the softmax
//   hides its latency. Padded rows cost tensor-core cycles only and are
//   never written.
// - bf16 pages: K and V arrive by TMA (one 4-D map per pool over
//   [num_pages, Hkv, page_size, D], boxes of 64 columns by 64 keys, 128-byte
//   swizzle) into a ring of six 64-key tiles that hold K and V in turn, one
//   mbarrier each: three key tiles ahead, up to 96 KB in flight a block, two
//   blocks an SM (one warpgroup of 128 threads and 97 KB of shared memory
//   each). The warpgroup's first thread issues the loads, refilling a slot
//   once every warp is past it: a producer warp would make ten warps an SM,
//   which caps a thread at 168 registers and serializes the wgmmas.
// - int8 pages (K6, K7'): a 64-key tile is 64 rows of D bytes (8 KB at D
//   128, 128-byte swizzle; plain 64-byte rows at D 64), half a bf16 tile's
//   bytes. K and V tiles come by TMA into two rings of two slots, each with
//   the tile's 64 f32 scales by a bulk copy on the same barrier. The
//   warpgroup converts each tile to bf16 in shared memory (int8 is exact in
//   bf16: 2^23 + u in f32, less 2^23 + 128), written in the swizzled layout
//   a bf16 TMA tile has, and fenced to the async proxy: V(t + 1) during the
//   softmax of tile t, by the warps whose 16 rows are all padding (three of
//   four for K6's 7 rows) while the others run it, then K(t + 2) while
//   S(t + 1) and P V(t) are on the tensor cores (two converted K and two V
//   tiles). S(t + 1) issues once P(t) is packed, so one S tile of registers
//   serves and nothing writes an accumulator while a product runs (ptxas
//   serialized the wgmmas when the exponentials ran beside S(t + 1)). The
//   scales stay outside the products: s = (q . k_i8) k_scale D^-0.5 on S's
//   registers before the max, and P V takes p v_scale, rounded to bf16 once
//   as P alone is on bf16 pages, against the exact bf16 V; l sums p
//   unscaled. Padding warps skip the softmax's arithmetic. 99 KB of shared
//   memory and at most 255 registers a thread: two blocks an SM. Its pace is
//   set by the latency of a block's steps, one after another (softmax,
//   conversion, the two products, two barriers), not by the bytes
//   (PERF.md §6).
// - Masking: in the tile that holds the row's length, keys at or past it
//   are -inf before the max, by select and after the int8 scale, so NaN
//   scores or scales of stale slots vanish; V rows at or past it are zeroed
//   in shared memory and fenced to the async proxy before P V (0 * NaN is
//   NaN in the tensor core), and on int8 pages their p v_scale is 0 by
//   select (0 * inf is NaN). Tiles wholly past the length are never loaded.
// - Each block writes an unnormalized f32 partial (acc, m, l) of its rows; a
//   second kernel merges a row's ranges, the ranges' weights at once and the
//   sum in range order (no atomics, so two launches give equal bits), and
//   normalizes to bf16 (K4, K6; 0 where L == 0) or emits acc, max(M, -1e30)
//   and L (K7, K7').
//
// K8 and K9 replace ops/paged_attention.py:paged_decode_attention_pallas
// (_paged_decode_kernel, :135, pallas_call :196) and
// paged_decode_attention_pallas_int8 (_paged_decode_int8_kernel, :698,
// pallas_call :746): one-token decode over a shared pool whose rows' pages
// are wherever the allocator put them, read through page_table [B, maxp]
// (-1 = unmapped). They run the same two kernels, templated on how a block
// finds its pages (Pages): PoolPages reads row b's slot s at pool page
// b * row_pages + s, TablePages at table[b, s]. The grid is the same
// paged_split, counted from maxp and the row tiles (any g), never from the
// lengths on the device. A table block starts by listing, in order and in
// shared memory, its range's slots that are mapped and start below the
// row's length (one coalesced read of the range's table entries by warp 0,
// compacted by ballot), and walks only those: key tile t reads page
// live[t / (page_size / 64)]. Every live page is full but the one that holds
// the row's length, so the block's live keys are (n_live - 1) page_size +
// (length - last_slot page_size) when that slot is live, n_live page_size
// when it is a hole or in another range; with that count the masking above
// carries over as it is. As in the TPU kernel, a slot that is unmapped or
// at or past the row's length is never loaded (NaN there cannot leak), a
// range with no live key writes empty partials, and a row with none gets 0.
// The TMA maps span the whole pool. K9 reads k_scale[page, hk, slot]
// directly where the TPU kernel selected the head's scale row by a one-hot
// sum (a Mosaic workaround).
#include <type_traits>

#include "hopper.cuh"
#include "kernels.cuh"

namespace sc {
namespace {

// Pointers of one launch. kp / vp: one layer's contiguous [num_pages, Hkv,
// page_size, D] pages; ks / vs: [num_pages, Hkv, page_size] f32 scales (int8
// only); table: [B, maxp] int32 (K8, K9; null otherwise); acc / m / l: f32
// scratch [B, Hkv, ranges, R(, D)]; out (K4, K6, K8, K9) or acc_o / m_o /
// l_o (K7, K7'): the result.
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

// ---- K4, K6, K7 and K7': split-K over the pool on TMA and wgmma ----

namespace tc {

using namespace hopper;

constexpr int KEYS = 64;      // keys per tile: half a 128-slot page
constexpr int ROWS = 64;      // query rows per block: one wgmma M tile
constexpr int SLOTS = 6;      // bf16 ring slots, holding K and V tiles in turn
// The int8 kernel: raw ring slots for K and for V each, converted K and V
// tiles, and converted K tiles' scale rows (three: K(t + 2)'s are written
// while K(t)'s are read).
constexpr int RAW_SLOTS = 2, K_BUFS = 2, V_BUFS = 2, K_SCALE_BUFS = 3;
constexpr int THREADS = 128;  // one warpgroup
// Table slots a TablePages block can list (a range's slots; the launch
// refuses more): 8 KB of shared memory, which two blocks an SM still hold.
constexpr int TABLE_SLOTS = 2048;
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

template <int D>
struct Ring {
  static constexpr int BOX = KEYS * 128;       // 64 rows of 64 bf16 (8 KB)
  static constexpr int TILE = (D / 64) * BOX;  // one [64, D] K or V tile
  static constexpr int bars = SLOTS * TILE;
  static constexpr int list = bars + 8 * SLOTS;  // a TablePages block's slot list
  static constexpr int bytes = list + 1024;      // + alignment slack
};

// Shared memory of the int8 kernel: the converted K tiles and V tiles
// (bf16, laid out as TMA lays out a bf16 tile), the raw int8 rings (K
// slots, then V slots), the rings' 64 scales a slot, the converted tiles'
// scales, one barrier a raw slot and, in a TablePages block, its slot list.
template <int D>
struct RingI8 {
  static constexpr int BOX = KEYS * 128;
  static constexpr int TILE = (D / 64) * BOX;
  static constexpr int RAW = KEYS * D;             // one int8 [64, D] tile
  static constexpr int NRAW = 2 * RAW_SLOTS;
  static constexpr int kb = 0, vb = K_BUFS * TILE, raw = (K_BUFS + V_BUFS) * TILE;
  static constexpr int scales = raw + NRAW * RAW;
  static constexpr int ksc = scales + NRAW * KEYS * 4;
  static constexpr int vsc = ksc + K_SCALE_BUFS * KEYS * 4;
  static constexpr int bars = vsc + V_BUFS * KEYS * 4;
  static constexpr int list = bars + 8 * NRAW;
  static constexpr int bytes = list + 1024;  // + alignment slack
};

struct Params {
  const __nv_bfloat16* q;  // [B, Hq, ntok, D] through (qsb, qsh, qst)
  int64_t qsb, qsh, qst;
  const int* length;
  const int* table;  // TablePages: [B, slots] int32, -1 = unmapped
  int slots;         // a row's page slots: row_pages (PoolPages) or maxp (TablePages)
  int page_size;
  int ntok, g, Hkv, nranges, rtiles;
  int q_vec;    // q's rows are 16-byte aligned (strides % 8 == 0, aligned base)
  int q_words;  // q's pairs are 4-byte aligned (even strides, aligned base)
  float scale_log2;
  const float* k_scale;  // int8 pages: [num_pages, Hkv, page_size] f32
  const float* v_scale;
  float* acc;  // partials [B, Hkv, nranges, g * ntok(, D)]
  float* m;
  float* l;
};

// A block's place: range r of row b's page slots for kv head hk, slots
// [page0, page1) = [r slots / nranges, (r + 1) slots / nranges) of the row,
// and the head's query rows [row0, row0 + ROWS) (blockIdx.x = r * rtiles +
// row tile); nkeys of its keys are live.
struct Block {
  int r, hk, b, row0, rows, page0, page1, nkeys;
  int64_t part;  // the first partial row of (b, hk, r)
};

// How a block finds its pages, the kernels' template parameter: page(p, k,
// live, i) is the pool page of the block's i-th page (live: a TablePages
// block's list in shared memory).
// PoolPages (K4, K6, K7, K7'): row b owns pool pages [b * slots, (b + 1) *
// slots) of the partitioned pool, in order.
struct PoolPages {
  static constexpr bool kTable = false;
  __device__ static int page(const Params& p, const Block& k, const int*, int i) {
    return k.b * p.slots + k.page0 + i;
  }
};
// TablePages (K8, K9): row b's slot s is pool page table[b, s]; a block
// walks the pages of its range's live slots, listed in order.
struct TablePages {
  static constexpr bool kTable = true;
  __device__ static int page(const Params&, const Block&, const int* live, int i) {
    return live[i];
  }
};

// A TablePages block's live pages: warp 0 reads the range's table entries
// below the row's length, 32 at a time, and writes those that are mapped,
// in slot order, to list[1..] (a ballot gives each its place), and the
// block's live keys to list[0]: every page but the one that holds the
// length is full. Every thread returns the count after a block barrier.
__device__ __forceinline__ int collect_live(const Params& p, const Block& k, int* list) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x, len = p.length[k.b], ps = p.page_size;
    const int* row = p.table + (int64_t)k.b * p.slots;
    int n = 0, last = -1;  // live slots so far, the last of them
    for (int s0 = k.page0; s0 < k.page1 && s0 * ps < len; s0 += 32) {
      const int s = s0 + lane;
      const int page = s < k.page1 && s * ps < len ? row[s] : -1;
      const unsigned live = __ballot_sync(0xffffffffu, page >= 0);
      if (page >= 0) list[1 + n + __popc(live & ((1u << lane) - 1))] = page;
      if (live) last = s0 + 31 - __clz(live);
      n += __popc(live);
    }
    if (lane == 0) list[0] = n == 0 ? 0 : n * ps - max(0, (last + 1) * ps - len);
  }
  __syncthreads();
  return list[0];
}

template <typename Pages>
__device__ __forceinline__ Block block_of(const Params& p, int* list) {
  Block k;
  k.r = blockIdx.x / p.rtiles;
  k.row0 = (blockIdx.x % p.rtiles) * ROWS;
  k.hk = blockIdx.y;
  k.b = blockIdx.z;
  k.rows = p.g * p.ntok;
  k.part = ((int64_t)(k.b * p.Hkv + k.hk) * p.nranges + k.r) * k.rows;
  const int ps = p.page_size;
  k.page0 = (int)((int64_t)k.r * p.slots / p.nranges);
  k.page1 = (int)((int64_t)(k.r + 1) * p.slots / p.nranges);
  if constexpr (Pages::kTable)
    k.nkeys = collect_live(p, k, list);
  else
    k.nkeys = min((k.page1 - k.page0) * ps, p.length[k.b] - k.page0 * ps);
  return k;
}

// No live key in the block's range: m = -inf, l = 0 and acc = 0 for its rows.
template <int D>
__device__ __forceinline__ void write_empty(const Params& p, const Block& k) {
  const int n = min(ROWS, k.rows - k.row0);
  const int64_t first = k.part + k.row0;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    p.m[first + i] = -INFINITY;
    p.l[first + i] = 0.0f;
  }
  for (int i = threadIdx.x; i < n * D; i += THREADS) p.acc[first * D + i] = 0.0f;
}

// Query row `row` of kv head hk (row g_i * ntok + t_i is query head
// hk * g + g_i at token t_i).
__device__ __forceinline__ const __nv_bfloat16* q_row(const Params& p, int b, int hk, int row) {
  const int hq = hk * p.g + row / p.ntok;
  return p.q + b * p.qsb + hq * p.qsh + (row % p.ntok) * p.qst;
}

// Columns col, col + 1 of query row `row` of kv head hk, as a bf16 pair.
__device__ __forceinline__ uint32_t q_pair(const Params& p, int b, int hk, int row, int col) {
  const __nv_bfloat16* src = q_row(p, b, hk, row) + col;
  if (p.q_words) return *reinterpret_cast<const uint32_t*>(src);
  const unsigned short* h = reinterpret_cast<const unsigned short*>(src);
  return static_cast<uint32_t>(h[0]) | (static_cast<uint32_t>(h[1]) << 16);
}
// Q's wgmma A fragments, each pair read by its thread (the bf16 kernel: its
// ring's loads are in flight meanwhile). In wgmma's accumulator layout a
// thread holds rows rr and rr + 8 of the tile (rr = 16 warp + lane / 4) at
// columns 8 j + c2 + {0, 1} (c2 = 2 (lane % 4)): element 4 j + e is row
// rr + 8 (e >> 1), column 8 j + c2 + (e & 1). Q's A fragment for k-step kk
// holds the same rows at columns 16 kk + c2 (+ 8); rows past the head's are
// zero.
template <int D>
__device__ __forceinline__ void load_q(uint32_t (&qa)[D / 16][4], const Params& p,
                                       const Block& k, int rr, int c2) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = k.row0 + rr + 8 * (i & 1);
      qa[kk][i] = row < k.rows ? q_pair(p, k.b, k.hk, row, 16 * kk + 8 * (i >> 1) + c2) : 0u;
    }
}

// load_q's fragments through shared memory (the int8 kernel): the tile's
// rows are first read coalesced into `stage` (ROWS x D bf16: 16-byte chunk
// c of row r at chunk c ^ (r % 8), so that the fragment reads do not share
// banks), 16 bytes a thread where q's rows are 16-byte aligned. Ends in a
// barrier: `stage` is free again.
template <int D>
__device__ __forceinline__ void load_q_staged(uint32_t (&qa)[D / 16][4], const Params& p,
                                              const Block& k, int rr, int c2, uint8_t* stage) {
  constexpr int C = D / 8;  // 16-byte chunks a row
  auto at = [&](int r, int col) {  // bf16 column col of staged row r
    return reinterpret_cast<__nv_bfloat16*>(stage) + r * D + 8 * ((col / 8) ^ (r % 8)) + col % 8;
  };
  const int n = min(ROWS, k.rows - k.row0);
  if (p.q_vec) {
#pragma unroll 8
    for (int i = threadIdx.x; i < n * C; i += THREADS) {
      const int r = i / C, c = 8 * (i % C);
      *reinterpret_cast<uint4*>(at(r, c)) =
          *reinterpret_cast<const uint4*>(q_row(p, k.b, k.hk, k.row0 + r) + c);
    }
  } else {
#pragma unroll 8
    for (int i = threadIdx.x; i < n * D; i += THREADS)
      *at(i / D, i % D) = q_row(p, k.b, k.hk, k.row0 + i / D)[i % D];
  }
  named_barrier_sync(1, THREADS);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = rr + 8 * (i & 1);
      qa[kk][i] = row < n ? *reinterpret_cast<const uint32_t*>(at(row, 16 * kk + 8 * (i >> 1) + c2))
                          : 0u;
    }
  named_barrier_sync(1, THREADS);
}

// The row maxima of the masked scores sc update the running max m2 (exp2
// domain); O and this thread's share of l are rescaled, and mneg is the
// negated new max for the exponentials.
template <int D>
__device__ __forceinline__ void rescale(const float (&sc)[32], float (&m2)[2], float (&lsum)[2],
                                        float (&o)[D / 2], float (&mneg)[2], float scale_log2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  float alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m2[h], mx[h] * scale_log2);
    alpha[h] = m_new == -INFINITY ? 1.0f : exp2f(m2[h] - m_new);
    mneg[h] = m_new == -INFINITY ? 0.0f : -m_new;
    m2[h] = m_new;
    lsum[h] *= alpha[h];
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
}

// p = exp2(s scale log2 e - m) in place (flushed to 0 below 2^-126),
// summed into this thread's l.
__device__ __forceinline__ void exponentials(float (&sc)[32], const float (&mneg)[2],
                                             float (&lsum)[2], float scale_log2) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(sc[i]) : "f"(fmaf(sc[i], scale_log2, mneg[h])));
    lsum[h] += sc[i];
  }
}

// The block's unnormalized partials of its rows: acc, m (natural log
// domain) and l.
template <int D>
__device__ __forceinline__ void write_partials(const Params& p, const Block& k,
                                               const float (&o)[D / 2], const float (&m2)[2],
                                               const float (&lsum)[2], int rr, int c2) {
  float l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = lsum[h] + __shfl_xor_sync(0xffffffffu, lsum[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = k.row0 + rr + 8 * h;
    if (row >= k.rows) continue;
    float* dst = p.acc + (k.part + row) * D + c2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
    if (threadIdx.x % 4 == 0) {
      p.m[k.part + row] = m2[h] * LN2;
      p.l[k.part + row] = l[h];
    }
  }
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* raw) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}

// Ring tile i of a block: K (i even) or V (i odd) of its key tile i / 2, into
// slot i % SLOTS, completing on that slot's barrier.
template <int D, typename Pages>
__device__ __forceinline__ void load_tile(uint8_t* smem, uint64_t* full, const CUtensorMap* kmap,
                                          const CUtensorMap* vmap, const Params& p,
                                          const Block& k, int i) {
  using L = Ring<D>;
  const int s = i % SLOTS, t = i / 2, per_page = p.page_size / KEYS;
  const int page = Pages::page(p, k, reinterpret_cast<const int*>(smem + L::list) + 1,
                               t / per_page);
  const int key = (t % per_page) * KEYS;
  mbar_expect_tx(&full[s], L::TILE);
  for (int hf = 0; hf < D / 64; ++hf)
    tma_load_4d(smem + s * L::TILE + hf * L::BOX, i % 2 ? vmap : kmap, &full[s], 64 * hf, key,
                k.hk, page);
}

// K4, K7 and K8 (bf16 pages). Thread 0 also issues the ring's loads:
// SLOTS / 2 key tiles ahead, each slot refilled once all four warps are past
// it.
template <int D, typename Pages>
__global__ void __launch_bounds__(THREADS, 2)
    paged_tc_kernel(__grid_constant__ const CUtensorMap kmap,
                    __grid_constant__ const CUtensorMap vmap, const Params p) {
  using L = Ring<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);

  const Block k = block_of<Pages>(p, reinterpret_cast<int*>(smem + L::list));
  if (k.nkeys <= 0) {
    write_empty<D>(p, k);
    return;
  }
  const int ntiles = (k.nkeys + KEYS - 1) / KEYS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < SLOTS; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
    tma_prefetch_map(&kmap);
    tma_prefetch_map(&vmap);
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < min(SLOTS, 2 * ntiles); ++i)
      load_tile<D, Pages>(smem, full, &kmap, &vmap, p, k, i);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rr = 16 * warp + lane / 4, c2 = 2 * (lane % 4);
  uint32_t qa[D / 16][4];
  load_q<D>(qa, p, k, rr, c2);

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
    const int valid = k.nkeys - t * KEYS;  // live keys of this tile, > 0
    if (valid < KEYS) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * j + e] = 8 * j + c2 + (e & 1) < valid ? sc[4 * j + e] : -INFINITY;
    }
    float mneg[2];
    rescale<D>(sc, m2, lsum, o, mneg, p.scale_log2);
    if (t + 1 < ntiles) issue_s(t + 1, next);
    exponentials(sc, mneg, lsum, p.scale_log2);

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
      if (iv + SLOTS < 2 * ntiles) load_tile<D, Pages>(smem, full, &kmap, &vmap, p, k, iv + SLOTS);
      if (iv + 1 + SLOTS < 2 * ntiles)
        load_tile<D, Pages>(smem, full, &kmap, &vmap, p, k, iv + 1 + SLOTS);
    }
  };

  float s0[32], s1[32];
  issue_s(0, s0);
  wgmma_wait<0>();
  fence_regs(s0);
  named_barrier_sync(1, THREADS);  // every warp has read K(0)
  if (threadIdx.x == 0 && SLOTS < 2 * ntiles) load_tile<D, Pages>(smem, full, &kmap, &vmap, p, k, SLOTS);
  for (int t = 0; t < ntiles; t += 2) {  // two steps, so that s0 / s1 stay in registers
    step(t, s0, s1);
    if (t + 1 < ntiles) step(t + 1, s1, s0);
  }
  write_partials<D>(p, k, o, m2, lsum, rr, c2);
}

// ---- the int8 pages (K6, K7') ----

// The 16-byte chunk of a raw int8 tile (make_map_i8's layout) holding
// columns 16 c16 .. 16 c16 + 15 of key row `row`.
template <int D>
__device__ __forceinline__ const uint4* raw_chunk(const uint8_t* raw, int row, int c16) {
  return reinterpret_cast<const uint4*>(
      raw + (D == 128 ? row * 128 + ((c16 ^ (row % 8)) << 4) : row * 64 + (c16 << 4)));
}

// Four int8 (one little-endian word) as four bf16, exactly: the byte
// u = i + 128 becomes the mantissa of 2^23 in f32, 2^23 + 128 is taken off,
// and the upper half of each f32 is its bf16 (an integer of at most eight
// significant bits has no lower bits).
__device__ __forceinline__ uint2 i8x4_to_bf16(uint32_t w) {
  w ^= 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 + i)) - 8388736.0f;
  return make_uint2(__byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632),
                    __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632));
}

// A raw int8 [64, D] tile -> the bf16 tile `dst` in the layout TMA gives a
// bf16 [64, D] tile (boxes of 64 columns, 128-byte swizzle: chunk_sw128),
// rows at and past `valid` zero. The 8 threads of a quarter warp take 8
// consecutive rows at one 16-column group, so that at D 128 neither their
// reads nor their swizzled writes share a bank.
template <int D>
__device__ __forceinline__ void convert_tile(const uint8_t* __restrict__ raw,
                                             uint8_t* __restrict__ dst, int valid) {
  constexpr int C = D / 16, N = KEYS * C / THREADS;  // raw chunks a thread
  // All of this thread's raw chunks are read before any bf16 chunk is
  // written, so that the reads are in flight together.
  uint4 w[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int j = threadIdx.x + THREADS * n;
    w[n] = *raw_chunk<D>(raw, j % 8 + 8 * (j / (8 * C)), (j / 8) % C);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int j = threadIdx.x + THREADS * n;
    const int row = j % 8 + 8 * (j / (8 * C)), c16 = (j / 8) % C;
    uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
    if (row < valid) {
      const uint2 a = i8x4_to_bf16(w[n].x), b = i8x4_to_bf16(w[n].y), c = i8x4_to_bf16(w[n].z),
                  d = i8x4_to_bf16(w[n].w);
      lo = make_uint4(a.x, a.y, b.x, b.y);
      hi = make_uint4(c.x, c.y, d.x, d.y);
    }
    *chunk_sw128(dst, KEYS * 128, row, 16 * c16) = lo;
    *chunk_sw128(dst, KEYS * 128, row, 16 * c16 + 8) = hi;
  }
}

// Raw int8 tile t of the block, K or (with v) V, into its ring slot with its
// 64 scales (a bulk copy), both completing on the slot's barrier.
template <int D, typename Pages>
__device__ __forceinline__ void load_raw(uint8_t* smem, uint64_t* full, const CUtensorMap* map,
                                         const Params& p, const Block& k, int t, bool v) {
  using L = RingI8<D>;
  const int s = (v ? RAW_SLOTS : 0) + t % RAW_SLOTS, per_page = p.page_size / KEYS;
  const int page = Pages::page(p, k, reinterpret_cast<const int*>(smem + L::list) + 1,
                               t / per_page);
  const int key = (t % per_page) * KEYS;
  mbar_expect_tx(&full[s], L::RAW + KEYS * 4);
  tma_load_4d(smem + L::raw + s * L::RAW, map, &full[s], 0, key, k.hk, page);
  bulk_load(smem + L::scales + s * KEYS * 4,
            (v ? p.v_scale : p.k_scale) + ((int64_t)page * p.Hkv + k.hk) * p.page_size + key,
            KEYS * 4, &full[s]);
}

// K6, K7' and K9 (int8 pages). Thread 0 issues the rings' loads: K tile t
// into K slot t % RAW_SLOTS, V tile t into V slot t % RAW_SLOTS, each
// refilled once every warp is past it. K(t) is converted two steps ahead of
// its softmax into bf16 buffer t % K_BUFS, V(t) one step ahead into buffer
// t % V_BUFS, each with its scales.
template <int D, typename Pages>
__global__ void __launch_bounds__(THREADS, 2)
    paged_tc_i8_kernel(__grid_constant__ const CUtensorMap kmap,
                       __grid_constant__ const CUtensorMap vmap, const Params p) {
  using L = RingI8<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  float* ksc = reinterpret_cast<float*>(smem + L::ksc);  // [K_SCALE_BUFS][KEYS]
  float* vsc = reinterpret_cast<float*>(smem + L::vsc);  // [V_BUFS][KEYS]

  const Block k = block_of<Pages>(p, reinterpret_cast<int*>(smem + L::list));
  if (k.nkeys <= 0) {
    write_empty<D>(p, k);
    return;
  }
  const int ntiles = (k.nkeys + KEYS - 1) / KEYS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::NRAW; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
    tma_prefetch_map(&kmap);
    tma_prefetch_map(&vmap);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int t = 0; t < min(RAW_SLOTS, ntiles); ++t) load_raw<D, Pages>(smem, full, &kmap, p, k, t, false);
    for (int t = 0; t < min(RAW_SLOTS, ntiles); ++t) load_raw<D, Pages>(smem, full, &vmap, p, k, t, true);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rr = 16 * warp + lane / 4, c2 = 2 * (lane % 4);
  uint32_t qa[D / 16][4];
  load_q_staged<D>(qa, p, k, rr, c2, smem + L::kb);  // staged where K(0) is converted next
  // Warps whose 16 rows are all padding skip the softmax's arithmetic (their
  // P and O rows are never written) and leave the SM's issue slots to the
  // warps that hold query rows.
  const bool live = 16 * warp < k.rows - k.row0;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m2[2] = {-INFINITY, -INFINITY};  // running max, exp2 domain
  float lsum[2] = {0.0f, 0.0f};          // this thread's share of l (unscaled p)
  float sc[32];                          // S of the current key tile
  uint32_t pa[KEYS / 16][4] = {};        // P v_scale as wgmma's A fragment

  auto raw_slot = [&](int s) { return smem + L::raw + s * L::RAW; };
  auto slot_scales = [&](int s) {
    return reinterpret_cast<const float*>(smem + L::scales + s * KEYS * 4);
  };
  auto copy_scales = [&](int s, float* dst) {
    if (threadIdx.x < KEYS / 4)
      reinterpret_cast<float4*>(dst)[threadIdx.x] =
          reinterpret_cast<const float4*>(slot_scales(s))[threadIdx.x];
  };

  // K tile t, once arrived, into bf16 buffer t % K_BUFS with its scales,
  // fenced to the async proxy (the caller's barrier makes it visible).
  auto convert_k = [&](int t) {
    const int s = t % RAW_SLOTS;
    mbar_wait(&full[s], (t / RAW_SLOTS) & 1);
    convert_tile<D>(raw_slot(s), smem + L::kb + (t % K_BUFS) * L::TILE, KEYS);
    copy_scales(s, ksc + (t % K_SCALE_BUFS) * KEYS);
    fence_proxy_async();
  };
  // V tile t likewise into buffer t % V_BUFS, rows at and past the length
  // zero.
  auto convert_v = [&](int t) {
    const int s = RAW_SLOTS + t % RAW_SLOTS;
    mbar_wait(&full[s], (t / RAW_SLOTS) & 1);
    convert_tile<D>(raw_slot(s), smem + L::vb + (t % V_BUFS) * L::TILE, k.nkeys - t * KEYS);
    copy_scales(s, vsc + (t % V_BUFS) * KEYS);
    fence_proxy_async();
  };

  // S = Q K^T of key tile t into sc: issued, not waited for.
  auto issue_s = [&](int t) {
    const uint32_t ka = smem_addr(smem + L::kb + (t % K_BUFS) * L::TILE);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_rs_n64(sc, qa[kk], desc_sw128(ka + (kk / 4) * L::BOX + (kk % 4) * 32, 16, 1024),
                   kk > 0);
    wgmma_commit();
  };

  // O += (P v_scale) V of key tile t: issued, not waited for.
  auto issue_pv = [&](int t) {
    const uint32_t va = smem_addr(smem + L::vb + (t % V_BUFS) * L::TILE);
    wgmma_fence();
#pragma unroll
    for (int ks4 = 0; ks4 < KEYS / 16; ++ks4) {
      const uint64_t db = desc_sw128(va + ks4 * 16 * 128, L::BOX, 1024);
      if constexpr (D == 128)
        wgmma_rs_n128_tb(o, pa[ks4], db);
      else
        wgmma_rs_n64_tb(o, pa[ks4], db);
    }
    wgmma_commit();
  };

  // The softmax of key tile t, whose S is in sc: scaled by k_scale and
  // masked, its row maxima rescale O, and P v_scale goes to pa. S is then
  // spent: S of tile t + 1 may overwrite it.
  auto softmax = [&](int t) {
    const int valid = k.nkeys - t * KEYS;  // live keys of this tile, > 0
    const float* ks = ksc + (t % K_SCALE_BUFS) * KEYS;
    const float* vs = vsc + (t % V_BUFS) * KEYS;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 s2 = *reinterpret_cast<const float2*>(ks + 8 * j + c2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float s = sc[4 * j + e] * (e & 1 ? s2.y : s2.x);
        sc[4 * j + e] = 8 * j + c2 + (e & 1) < valid ? s : -INFINITY;
      }
    }
    float mneg[2];
    rescale<D>(sc, m2, lsum, o, mneg, p.scale_log2);
    exponentials(sc, mneg, lsum, p.scale_log2);
#pragma unroll
    for (int ks4 = 0; ks4 < KEYS / 16; ++ks4)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = 16 * ks4 + 8 * (i >> 1) + c2;
        const float2 v2 = *reinterpret_cast<const float2*>(vs + key);
        const float a = sc[8 * ks4 + 2 * i] * v2.x, b = sc[8 * ks4 + 2 * i + 1] * v2.y;
        pa[ks4][i] = pack_bf16x2(key < valid ? a : 0.0f, key + 1 < valid ? b : 0.0f);
      }
  };

  // Step t: the softmax of tile t (V(t) and K(t + 1) were converted the step
  // before); every warp converts K(t + 2) and V(t + 1), the warps without
  // query rows while the others run the softmax; then S(t + 1) and P V(t)
  // run on the tensor cores, one wait covers both, and the raw slots of
  // K(t + 2) and V(t + 1) are refilled.
  auto step = [&](int t) {
    if (live) softmax(t);
    if (t + 1 < ntiles) convert_v(t + 1);
    named_barrier_sync(1, THREADS);  // V(t + 1) converted
    fence_regs(o);
    if (t + 1 < ntiles) issue_s(t + 1);
    issue_pv(t);
    if (t + 2 < ntiles) convert_k(t + 2);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(sc);
    named_barrier_sync(1, THREADS);  // every warp is past the raw slots and buffers
    if (threadIdx.x == 0) {
      if (t + 1 + RAW_SLOTS < ntiles)
        load_raw<D, Pages>(smem, full, &vmap, p, k, t + 1 + RAW_SLOTS, true);
      if (t + 2 + RAW_SLOTS < ntiles)
        load_raw<D, Pages>(smem, full, &kmap, p, k, t + 2 + RAW_SLOTS, false);
    }
  };

  convert_k(0);
  if (ntiles > 1) convert_k(1);
  convert_v(0);
  named_barrier_sync(1, THREADS);  // K(0), K(1) and V(0) converted by every warp
  if (threadIdx.x == 0) {
    for (int t = RAW_SLOTS; t < min(RAW_SLOTS + 2, ntiles); ++t)
      load_raw<D, Pages>(smem, full, &kmap, p, k, t, false);
    if (RAW_SLOTS < ntiles) load_raw<D, Pages>(smem, full, &vmap, p, k, RAW_SLOTS, true);
  }
  issue_s(0);
  wgmma_wait<0>();
  fence_regs(sc);
  for (int t = 0; t < ntiles; ++t) step(t);
  write_partials<D>(p, k, o, m2, lsum, rr, c2);
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
// the groups in order. K4 / K6 write o / L as bf16 (0 where L == 0) to
// out[b, x]; K7 / K7' write o, max(M, -1e30) and L to acc_o / m_o / l_o[b, x].
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

// The kernel for page type T (bf16 or int8) and page policy Pages, and its
// shared bytes (a TablePages block's slot list: a count and TABLE_SLOTS
// pages).
template <int D, typename T, typename Pages>
struct Kernel {
  static constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  static constexpr int bytes = (kInt8 ? RingI8<D>::bytes : Ring<D>::bytes) +
                               (Pages::kTable ? 4 * (1 + TABLE_SLOTS) : 0);
  static auto fn() {
    if constexpr (kInt8)
      return paged_tc_i8_kernel<D, Pages>;
    else
      return paged_tc_kernel<D, Pages>;
  }
};

// One launch over a pool of num_pages pages, each row's `slots` page slots
// (PoolPages: row_pages; TablePages: maxp) cut into nranges ranges.
template <int D, typename T, typename Pages>
cudaError_t launch(const Args& a, int ntok, int B, int Hq, int Hkv, int num_pages, int slots,
                   int page_size, int nranges, float scale, cudaStream_t stream) {
  using K = Kernel<D, T, Pages>;
  const int g = Hq / Hkv, rows = g * ntok, rtiles = (rows + ROWS - 1) / ROWS;
  if (g < 1 || ntok < 1 || page_size % KEYS || nranges < 1 || nranges > slots ||
      (Pages::kTable && (slots + nranges - 1) / nranges > TABLE_SLOTS))
    return cudaErrorInvalidValue;
  const int64_t strides[3] = {(int64_t)Hkv * page_size * D, (int64_t)page_size * D, D};
  CUtensorMap km, vm;
  cudaError_t err;
  if constexpr (K::kInt8) {
    err = make_map_i8(&km, a.kp, strides, num_pages, Hkv, page_size, D, KEYS);
    if (err == cudaSuccess)
      err = make_map_i8(&vm, a.vp, strides, num_pages, Hkv, page_size, D, KEYS);
  } else {
    err = make_map_bf16(&km, a.kp, strides, num_pages, Hkv, page_size, D, KEYS);
    if (err == cudaSuccess)
      err = make_map_bf16(&vm, a.vp, strides, num_pages, Hkv, page_size, D, KEYS);
  }
  if (err != cudaSuccess) return err;
  const uintptr_t qa = reinterpret_cast<uintptr_t>(a.q);
  const int q_vec = qa % 16 == 0 && a.qsb % 8 == 0 && a.qsh % 8 == 0 && a.qst % 8 == 0;
  const int q_words = qa % 4 == 0 && a.qsb % 2 == 0 && a.qsh % 2 == 0 && a.qst % 2 == 0;
  const Params p{static_cast<const __nv_bfloat16*>(a.q), a.qsb, a.qsh, a.qst, a.length, a.table,
                 slots, page_size, ntok, g, Hkv, nranges, rtiles, q_vec, q_words,
                 scale * LOG2E, a.ks, a.vs, a.acc, a.m, a.l};
  auto kernel = K::fn();
  // Once per instantiation, at the first launch: a decode step replayed as
  // a CUDA graph (models/step_graph.py) runs its first launch eagerly, so
  // no attribute call happens while a stream captures.
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K::bytes);
  if (attr != cudaSuccess) return attr;
  kernel<<<dim3(nranges * rtiles, Hkv, B), THREADS, K::bytes, stream>>>(km, vm, p);
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

template <typename T, typename Pages>
int dispatch(const Args& a, int ntok, int B, int Hq, int Hkv, int num_pages, int slots,
             int page_size, int nranges, int D, float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 64)
    err = launch<64, T, Pages>(a, ntok, B, Hq, Hkv, num_pages, slots, page_size, nranges, scale,
                               st);
  else if (D == 128)
    err = launch<128, T, Pages>(a, ntok, B, Hq, Hkv, num_pages, slots, page_size, nranges, scale,
                                st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

template <int D, typename T, typename Pages>
cudaError_t attributes(int* out) {
  using K = Kernel<D, T, Pages>;
  auto kernel = K::fn();
  cudaFuncAttributes a{};
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K::bytes);
  int resident = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, THREADS, K::bytes);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = K::bytes;
  out[4] = resident;
  return cudaSuccess;
}

template <typename Pages>
cudaError_t attributes_of(int D, int int8, int* out) {
  if (D == 64)
    return int8 ? attributes<64, int8_t, Pages>(out) : attributes<64, __nv_bfloat16, Pages>(out);
  if (D == 128)
    return int8 ? attributes<128, int8_t, Pages>(out) : attributes<128, __nv_bfloat16, Pages>(out);
  return cudaErrorInvalidValue;
}

}  // namespace tc
}  // namespace
}  // namespace sc

// K4. q: [B, Hq, 1, D] addressed by (qsb, qsh) element strides; pages:
// contiguous [B * row_pages, Hkv, page_size, D] of one layer (page_size a
// multiple of 64); length: [B] int32 on the device; each row's pages split
// into `ranges` ranges as even as whole pages allow (1 <= ranges <=
// row_pages); acc/m/l: f32 scratch of [B, Hkv, ranges, g(, D)]; out:
// [B, Hq, D].
extern "C" int sc_paged_decode(const void* q, int64_t qsb, int64_t qsh, const void* k_pages,
                               const void* v_pages, const int* length, int B, int Hq,
                               int Hkv, int row_pages, int page_size, int ranges, int D,
                               float scale, void* acc, void* m, void* l, void* out,
                               void* stream) {
  const sc::Args a{q, qsb, qsh, 0, k_pages, v_pages, nullptr, nullptr, length, nullptr,
                   static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l),
                   static_cast<__nv_bfloat16*>(out), nullptr, nullptr, nullptr};
  return sc::tc::dispatch<__nv_bfloat16, sc::tc::PoolPages>(
      a, 1, B, Hq, Hkv, B * row_pages, row_pages, page_size, ranges, D, scale, stream);
}

// K6: as sc_paged_decode over int8 pages; k_scale / v_scale: contiguous f32
// [num_pages, Hkv, page_size] of the same layer, 16-byte aligned.
extern "C" int sc_paged_decode_int8(const void* q, int64_t qsb, int64_t qsh,
                                    const void* k_pages, const void* v_pages,
                                    const void* k_scale, const void* v_scale,
                                    const int* length, int B, int Hq, int Hkv, int row_pages,
                                    int page_size, int ranges, int D, float scale, void* acc,
                                    void* m, void* l, void* out, void* stream) {
  const sc::Args a{q, qsb, qsh, 0, k_pages, v_pages, static_cast<const float*>(k_scale),
                   static_cast<const float*>(v_scale), length, nullptr,
                   static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l),
                   static_cast<__nv_bfloat16*>(out), nullptr, nullptr, nullptr};
  return sc::tc::dispatch<int8_t, sc::tc::PoolPages>(a, 1, B, Hq, Hkv, B * row_pages, row_pages,
                                                     page_size, ranges, D, scale, stream);
}

// K7: q [B, Hq, ntok, D] addressed by (qsb, qsh, qst) element strides, the
// pages, length and ranges as for K4 (length counts pool tokens only); acc/m/l: f32
// scratch of [B, Hkv, ranges, g * ntok(, D)]; acc_o [B, Hq, ntok, D], m_o and
// l_o [B, Hq, ntok]: contiguous f32 results.
extern "C" int sc_paged_seq_partial(const void* q, int64_t qsb, int64_t qsh, int64_t qst,
                                    int ntok, const void* k_pages, const void* v_pages,
                                    const int* length, int B, int Hq, int Hkv, int row_pages,
                                    int page_size, int ranges, int D, float scale, void* acc,
                                    void* m, void* l, void* acc_o, void* m_o, void* l_o,
                                    void* stream) {
  const sc::Args a{q, qsb, qsh, qst, k_pages, v_pages, nullptr, nullptr, length, nullptr,
                   static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l),
                   nullptr, static_cast<float*>(acc_o), static_cast<float*>(m_o),
                   static_cast<float*>(l_o)};
  return sc::tc::dispatch<__nv_bfloat16, sc::tc::PoolPages>(
      a, ntok, B, Hq, Hkv, B * row_pages, row_pages, page_size, ranges, D, scale, stream);
}

// K7': K7 over int8 pages with their f32 scales (as for K6).
extern "C" int sc_paged_seq_partial_int8(const void* q, int64_t qsb, int64_t qsh, int64_t qst,
                                         int ntok, const void* k_pages, const void* v_pages,
                                         const void* k_scale, const void* v_scale,
                                         const int* length, int B, int Hq, int Hkv,
                                         int row_pages, int page_size, int ranges, int D,
                                         float scale, void* acc, void* m, void* l, void* acc_o,
                                         void* m_o, void* l_o, void* stream) {
  const sc::Args a{q, qsb, qsh, qst, k_pages, v_pages, static_cast<const float*>(k_scale),
                   static_cast<const float*>(v_scale), length, nullptr,
                   static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l),
                   nullptr, static_cast<float*>(acc_o), static_cast<float*>(m_o),
                   static_cast<float*>(l_o)};
  return sc::tc::dispatch<int8_t, sc::tc::PoolPages>(a, ntok, B, Hq, Hkv, B * row_pages,
                                                     row_pages, page_size, ranges, D, scale,
                                                     stream);
}

// K8: one-token decode (any g query heads per kv head) over a shared pool of
// num_pages pages read through table [B, maxp] int32 (-1 = unmapped; every
// entry must be -1 or a page of the pool), each row's maxp slots split into
// `ranges` ranges (1 <= ranges <= maxp, at most 2,048 slots a range); q,
// length, acc/m/l and out as for K4.
extern "C" int sc_paged_decode_table(const void* q, int64_t qsb, int64_t qsh,
                                     const void* k_pages, const void* v_pages, const int* table,
                                     const int* length, int B, int Hq, int Hkv, int num_pages,
                                     int maxp, int page_size, int ranges, int D, float scale,
                                     void* acc, void* m, void* l, void* out, void* stream) {
  const sc::Args a{q, qsb, qsh, 0, k_pages, v_pages, nullptr, nullptr, length, table,
                   static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l),
                   static_cast<__nv_bfloat16*>(out), nullptr, nullptr, nullptr};
  return sc::tc::dispatch<__nv_bfloat16, sc::tc::TablePages>(
      a, 1, B, Hq, Hkv, num_pages, maxp, page_size, ranges, D, scale, stream);
}

// K9: K8 over int8 pages with their f32 scales [num_pages, Hkv, page_size].
extern "C" int sc_paged_decode_table_int8(const void* q, int64_t qsb, int64_t qsh,
                                          const void* k_pages, const void* v_pages,
                                          const void* k_scale, const void* v_scale,
                                          const int* table, const int* length, int B, int Hq,
                                          int Hkv, int num_pages, int maxp, int page_size,
                                          int ranges, int D, float scale, void* acc, void* m,
                                          void* l, void* out, void* stream) {
  const sc::Args a{q, qsb, qsh, 0, k_pages, v_pages, static_cast<const float*>(k_scale),
                   static_cast<const float*>(v_scale), length, table,
                   static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l),
                   static_cast<__nv_bfloat16*>(out), nullptr, nullptr, nullptr};
  return sc::tc::dispatch<int8_t, sc::tc::TablePages>(a, 1, B, Hq, Hkv, num_pages, maxp,
                                                      page_size, ranges, D, scale, stream);
}

// Compiled attributes of the Hopper page kernel for head dim D over bf16
// pages (int8 = 0: K4, K7; with table = 1, K8) or int8 pages (int8 = 1: K6,
// K7'; with table = 1, K9): out[0] registers per thread, out[1] local
// (spill) bytes per thread, out[2] static shared bytes, out[3] the dynamic
// shared bytes it launches with, out[4] the blocks resident on one SM.
extern "C" int sc_paged_decode_attributes(int D, int int8, int table, int* out) {
  const cudaError_t err = table ? sc::tc::attributes_of<sc::tc::TablePages>(D, int8, out)
                                : sc::tc::attributes_of<sc::tc::PoolPages>(D, int8, out);
  return static_cast<int>(err);
}
