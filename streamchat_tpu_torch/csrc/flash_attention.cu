// Online-softmax (flash) attention for the ViT: the attention inside K1
// (ops/fused_vit.py:fused_vit_layer), K13 (fused_ln_attn) and K16 (the layer
// probe), and K14 (vit_attention). The decoder's prefill kernels K3 and K5
// are csrc/flash_prefill.cu.
//
// K1 / K13 replace the TPU kernels' _attn_body (ops/fused_vit.py): non-causal,
// 16 heads of 64, 577 tokens, with the TPU kernel's softmax modes: "exact"
// is this max-subtracting loop, "clamp" (kClamp) keeps m fixed at 0 and
// takes p = exp(min(x, 80)) with no rescale, then divides by max(l, 1e-30):
// logits above 80 flatten to equal weights and a row whose logits all sit
// below about -87 underflows to a zero output, as there. The folded (exp2)
// form is the same loop with scale = ln 2. kBf16S (clamp only) is the bf16s
// variant of the layer probe (scripts/probe_vit_variants.py _attn_mlp_body,
// K16): each f32 score is rounded to bf16 after the MMA, and min(s, 80) and
// the exp are taken on that bf16 value with p rounded to bf16 (H100 tensor
// cores have no bf16-accumulating MMA, so the rounding is of the f32 sum, as
// the TPU's bf16-output dot rounds its f32 accumulator).
//
// K14 replaces ops/vit_attention.py:vit_attention (_kernel): non-causal
// attention over [N, H, S, D] with one shared length, which the TPU kernel
// padded to 128 and masked. Here it is this tile loop with causal = 0,
// Hq = Hkv = H and kv_length = S (ragged tiles masked in the loop), so no
// pad is needed; sc_vit_attention is its own entry point so that its
// launches are counted apart.
//
// Each block owns one (batch, head, 64-row query tile) and loops over
// 64-key tiles: S = Q K^T and O += P V run as nvcuda::wmma bf16 16x16x16
// products with f32 accumulation, the running max / sum live in shared
// memory, and the f32 output tile is rescaled in shared memory before each
// P V product accumulates on top of it. Tiles past kv_length (and, causal,
// wholly above the diagonal) are never loaded. V rows past kv_length are
// zero-filled on load (0 * NaN would survive p == 0); masked scores are -inf
// and a row whose running max is still -inf takes p = 0, so a row with every
// key masked writes 0. Query heads read kv head h / (Hq / Hkv) from strided
// q/k/v, so the ViT's merged [rows, 3*D] QKV buffer is read in place.
#include "kernels.cuh"

namespace sc {
namespace {

using namespace nvcuda;

constexpr int BQ = 64, BKV = 64, THREADS = 128;
constexpr int S_LD = BKV + 4;   // f32 score tile
constexpr int P_LD = BKV + 8;   // bf16 probability tile

template <int D>
struct Smem {
  static constexpr int QKV_LD = D + 8;
  static constexpr int O_LD = D + 4;
  static constexpr size_t q = 0;
  static constexpr size_t k = q + BQ * QKV_LD * 2;
  static constexpr size_t v = k + BKV * QKV_LD * 2;
  static constexpr size_t s = v + BKV * QKV_LD * 2;
  static constexpr size_t p = s + BQ * S_LD * 4;
  static constexpr size_t o = p + BQ * P_LD * 2;
  static constexpr size_t m = o + BQ * O_LD * 4;
  static constexpr size_t l = m + BQ * 4;
  static constexpr size_t bytes = l + BQ * 4;
};

template <int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int64_t row_stride, int row0, int valid_rows,
                                          int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int c = tid; c < 64 * CH; c += THREADS) {
    int r = c / CH, col = (c % CH) * 8;
    bool ok = row0 + r < valid_rows;
    const __nv_bfloat16* g = ok ? src + (int64_t)(row0 + r) * row_stride + col : src;
    cp_async16(dst + r * Smem<D>::QKV_LD + col, g, ok ? 16 : 0);
  }
}

// kClamp is the clamp softmax of K1 / K13; kBf16S adds K16's bf16 scores.
template <int D, bool kClamp, bool kBf16S>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const __nv_bfloat16* __restrict__ q, int64_t qsb, int64_t qsh, int64_t qss,
             const __nv_bfloat16* __restrict__ k, int64_t ksb, int64_t ksh, int64_t kss,
             const __nv_bfloat16* __restrict__ v, int64_t vsb, int64_t vsh, int64_t vss,
             __nv_bfloat16* __restrict__ o, int64_t osb, int64_t osh, int64_t oss,
             const int* __restrict__ kv_len, int Hq, int Hkv, int Sq, int Sk, int causal,
             float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = Smem<D>;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L::q);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L::k);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::v);
  float* Ss = reinterpret_cast<float*>(smem + L::s);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + L::p);
  float* Os = reinterpret_cast<float*>(smem + L::o);
  float* m_row = reinterpret_cast<float*>(smem + L::m);
  float* l_row = reinterpret_cast<float*>(smem + L::l);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int hk = h / (Hq / Hkv);
  const int kvlen = kv_len ? min(kv_len[b], Sk) : Sk;

  load_rows<D>(Qs, q + b * qsb + h * qsh, qss, q0, Sq, tid);
  cp_async_commit();
  for (int i = tid; i < BQ * L::O_LD; i += THREADS) Os[i] = 0.0f;
  for (int i = tid; i < BQ; i += THREADS) {
    m_row[i] = -INFINITY;
    l_row[i] = 0.0f;
  }

  // Keys past the tile's last row's causal horizon or past kv_length are
  // never loaded.
  int kend = kvlen;
  if (causal) kend = min(kend, q0 + BQ);
  const int ntiles = kend > 0 ? (kend + BKV - 1) / BKV : 0;
  const __nv_bfloat16* kb = k + b * ksb + hk * ksh;
  const __nv_bfloat16* vb = v + b * vsb + hk * vsh;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BKV;
    load_rows<D>(Ks, kb, kss, k0, kvlen, tid);
    load_rows<D>(Vs, vb, vss, k0, kvlen, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // S[warp rows, 64] = Q K^T
#pragma unroll
    for (int j = 0; j < BKV / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bk;
        wmma::load_matrix_sync(a, Qs + (warp * 16) * L::QKV_LD + kk * 16, L::QKV_LD);
        wmma::load_matrix_sync(bk, Ks + (j * 16) * L::QKV_LD + kk * 16, L::QKV_LD);
        wmma::mma_sync(acc, a, bk, acc);
      }
      wmma::store_matrix_sync(Ss + (warp * 16) * S_LD + j * 16, acc, S_LD,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // Online-softmax update of the warp's 16 rows; lanes cover 2 columns.
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r;
      const int qpos = q0 + row;
      float x[2];
      bool ok[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kpos = k0 + lane + 32 * c;
        ok[c] = kpos < kvlen && (!causal || kpos <= qpos);
        x[c] = ok[c] ? Ss[row * S_LD + lane + 32 * c] * scale : -INFINITY;
      }
      float p[2] = {0.0f, 0.0f};
      float alpha = 1.0f;
      float m_new = 0.0f;
      if constexpr (kClamp && kBf16S) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float s = __bfloat162float(__float2bfloat16(x[c]));
          p[c] = ok[c] ? __bfloat162float(__float2bfloat16(expf(fminf(s, 80.0f)))) : 0.0f;
        }
      } else if constexpr (kClamp) {
#pragma unroll
        for (int c = 0; c < 2; ++c) p[c] = ok[c] ? expf(fminf(x[c], 80.0f)) : 0.0f;
      } else {
        const float m_old = m_row[row];
        m_new = fmaxf(m_old, warp_max(fmaxf(x[0], x[1])));
        if (m_new != -INFINITY) {
#pragma unroll
          for (int c = 0; c < 2; ++c) p[c] = ok[c] ? expf(x[c] - m_new) : 0.0f;
          alpha = expf(m_old - m_new);
        }
      }
      const float psum = warp_sum(p[0] + p[1]);
      Ps[row * P_LD + lane] = __float2bfloat16(p[0]);
      Ps[row * P_LD + lane + 32] = __float2bfloat16(p[1]);
      if constexpr (!kClamp) {
        for (int d = lane; d < D; d += 32) Os[row * L::O_LD + d] *= alpha;
      }
      __syncwarp();
      if (lane == 0) {
        m_row[row] = m_new;
        l_row[row] = l_row[row] * alpha + psum;
      }
      __syncwarp();
    }

    // O[warp rows, D] += P V
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* op = Os + (warp * 16) * L::O_LD + j * 16;
      wmma::load_matrix_sync(acc, op, L::O_LD, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, Ps + (warp * 16) * P_LD + kk * 16, P_LD);
        wmma::load_matrix_sync(bv, Vs + (kk * 16) * L::QKV_LD + j * 16, L::QKV_LD);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(op, acc, L::O_LD, wmma::mem_row_major);
    }
    __syncthreads();
  }
  cp_async_wait<0>();  // the Q load when no key tile ran
  __syncthreads();

  __nv_bfloat16* ob = o + b * osb + h * osh;
  for (int r = 0; r < 16; ++r) {
    const int row = warp * 16 + r;
    if (q0 + row >= Sq) break;
    const float l = l_row[row];
    const float inv = kClamp ? 1.0f / fmaxf(l, 1e-30f) : (l > 0.0f ? 1.0f / l : 0.0f);
    for (int d = lane; d < D; d += 32)
      ob[(int64_t)(q0 + row) * oss + d] = __float2bfloat16(Os[row * L::O_LD + d] * inv);
  }
}

template <int D, bool kClamp = false, bool kBf16S = false>
cudaError_t launch(const __nv_bfloat16* q, const int64_t* qs, const __nv_bfloat16* k,
                   const int64_t* ks, const __nv_bfloat16* v, const int64_t* vs,
                   __nv_bfloat16* o, const int64_t* os, const int* kv_len, int B, int Hq,
                   int Hkv, int Sq, int Sk, int causal, float scale, cudaStream_t stream) {
  constexpr size_t bytes = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<D, kClamp, kBf16S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_kernel<D, kClamp, kBf16S><<<grid, THREADS, bytes, stream>>>(
      q, qs[0], qs[1], qs[2], k, ks[0], ks[1], ks[2], v, vs[0], vs[1], vs[2], o, os[0],
      os[1], os[2], kv_len, Hq, Hkv, Sq, Sk, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_normalized(const __nv_bfloat16* q, const int64_t* qs,
                              const __nv_bfloat16* k, const int64_t* ks,
                              const __nv_bfloat16* v, const int64_t* vs, __nv_bfloat16* o,
                              const int64_t* os, const int* kv_len, int B, int Hq, int Hkv,
                              int Sq, int Sk, int causal, float scale, int clamp,
                              cudaStream_t stream) {
  if (clamp == 2)
    return launch<D, true, true>(q, qs, k, ks, v, vs, o, os, kv_len, B, Hq, Hkv, Sq, Sk,
                                 causal, scale, stream);
  if (clamp)
    return launch<D, true>(q, qs, k, ks, v, vs, o, os, kv_len, B, Hq, Hkv, Sq, Sk, causal,
                           scale, stream);
  return launch<D>(q, qs, k, ks, v, vs, o, os, kv_len, B, Hq, Hkv, Sq, Sk, causal, scale,
                   stream);
}

}  // namespace

cudaError_t launch_flash(const __nv_bfloat16* q, const int64_t* qs, const __nv_bfloat16* k,
                         const int64_t* ks, const __nv_bfloat16* v, const int64_t* vs,
                         __nv_bfloat16* o, const int64_t* os, const int* kv_len, int B,
                         int Hq, int Hkv, int Sq, int Sk, int D, int causal, float scale,
                         int clamp, cudaStream_t stream) {
  if (D == 64)
    return launch_normalized<64>(q, qs, k, ks, v, vs, o, os, kv_len, B, Hq, Hkv, Sq, Sk,
                                 causal, scale, clamp, stream);
  if (D == 128)
    return launch_normalized<128>(q, qs, k, ks, v, vs, o, os, kv_len, B, Hq, Hkv, Sq, Sk,
                                  causal, scale, clamp, stream);
  return cudaErrorInvalidValue;
}

}  // namespace sc

// K14: non-causal attention over q [N, H, Sq, D], k / v [N, H, Sk, D]
// (strides: three int64 (image, head, seq) per input, in elements) into a
// contiguous o [N, H, Sq, D]; every key of every image is valid.
extern "C" int sc_vit_attention(const void* q, const int64_t* q_strides, const void* k,
                                const int64_t* k_strides, const void* v,
                                const int64_t* v_strides, void* o, int N, int H, int Sq,
                                int Sk, int D, float scale, void* stream) {
  const int64_t o_strides[3] = {(int64_t)H * Sq * D, (int64_t)Sq * D, D};
  cudaError_t err = sc::launch_flash(
      static_cast<const __nv_bfloat16*>(q), q_strides, static_cast<const __nv_bfloat16*>(k),
      k_strides, static_cast<const __nv_bfloat16*>(v), v_strides,
      static_cast<__nv_bfloat16*>(o), o_strides, /*kv_len=*/nullptr, N, H, H, Sq, Sk, D,
      /*causal=*/0, scale, /*clamp=*/0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}
