// Attention for Hopper: the prefill kernels K3 flash_attention and K5
// flash_attention_partial, and the ViT's non-causal attention (K14
// vit_attention, and the attention step of K1, K13 and K16), as one
// warp-specialised kernel template.
//
// K3 replaces the TPU kernel streamchat_tpu/ops/attention.py:flash_attention
// (_flash_kernel, pallas_call :269): causal or non-causal GQA attention with
// a per-row kv_length mask and a normalized bf16 output (0 for a row that
// sees no key). K5 replaces :flash_attention_partial (_flash_partial_kernel,
// :555): the same loop under GLOBAL causality, k_off + col <= q_off + row,
// writing the unnormalized f32 accumulator, the running max m (natural
// scaled domain, clamped to neg_inf) and the exponent sum l; a row that sees
// no key keeps acc 0, l 0 and m = neg_inf.
//
// The ViT's attention replaces ops/vit_attention.py:vit_attention (_kernel,
// :98; K14) and the _attn_body of ops/fused_vit.py's fused_vit_layer (:411,
// K1) and fused_ln_attn (:476, K13), and the bf16-score variant of
// scripts/probe_vit_variants.py (K16): non-causal, every key valid (577
// tokens, 16 heads of 64; the TPU padded S to 128 and masked, here the
// ragged last tiles are masked in the loop and TMA's per-frame maps give
// zeros past S, never the next frame's tokens). Its softmax modes are a
// template parameter: kSoftmaxExact is the online softmax below (the only
// mode of K3 / K5); kSoftmaxClamp keeps m fixed at 0 and takes
// p = exp(min(x, 80)) as exp2(min(x log2 e, 80 log2 e)), with no max
// reduction and no rescale of O, then divides by max(l, 1e-30): logits above
// 80 flatten to equal weights and a row whose logits all sit below about -87
// underflows to a zero output, as on the TPU. The folded (exp2) form is the
// same loop with scale ln 2, scale_log2 exactly 1. kSoftmaxBf16S (K16's
// bf16s) rounds x = s * scale to bf16, then takes p = bf16(exp(min(x, 80))).
// Masked scores are -inf before the exponent, so they give p = 0 in every
// mode. Q, K and V of the ViT are read in place from the merged [N S, 3 D]
// QKV buffer through the maps' strides. Its bound at [16, 16, 577, 64] is
// its bytes (0.0226 ms) just above its 21.8 GFLOP; at D = 64 the
// exponentials (one per score) take as many SFU cycles as the products
// take tensor-core cycles, and a warpgroup's softmax does not overlap its
// own products.
//
// What bounds them on the H100: operations. The smoke's shapes (28 query
// heads over 4 kv heads, dh 128) need 3.85 TFLOP for a causal 23,168-token
// prefill (3.890 ms at 989 TFLOP/s) and 0.97 TFLOP for a 3,072-row chunk
// against a 23,552-token cache (0.9804 ms); their bytes need under 4% of that.
// Only wgmma reaches the tensor cores' rate, and the tile loop must keep the
// score and output tiles out of shared memory. The design:
// - A block owns one (batch, query head, 128-row query tile) with three
//   warpgroups: a producer whose one thread starts the TMA loads, and two
//   consumer warpgroups of 64 query rows each (wgmma's M). setmaxnreg moves
//   registers from the producer (24) to the consumers (240).
// - Q, K and V arrive by TMA (4-D maps built from the caller's strides,
//   128-byte swizzle, a 128-wide row as two 64-column boxes; rows past the
//   sequence arrive as zeros) into a 2-stage K/V ring with a "full" and an
//   "empty" mbarrier per stage: the next key tile loads while this one is
//   consumed. Shared memory is 160 KB at D = 128 (one block per SM).
// - S = Q K^T is wgmma m64n128k16 from shared-memory descriptors, D / 16
//   steps; S stays in registers. The online softmax runs on the accumulator
//   registers: a row lives in the 4 threads of a quad (two xor shuffles for
//   the max), exp2 with scale * log2(e) folded into one FMA, m and l in
//   registers, O rescaled in registers.
// - O += P V is wgmma m64n{D}k16 with P converted to bf16 in registers as
//   the A operand and V (D contiguous) as the MN-major B operand.
// - Masks apply only to tiles that cross the causal diagonal or kv_length,
//   by select, so NaN scores from garbage keys become -inf. V rows past
//   kv_length in the boundary tile are zeroed in shared memory before P V
//   (0 * NaN is NaN in the tensor core; attention.py:143-149, :435-439).
//   Key tiles wholly past kv_length or above the diagonal are never loaded,
//   and under causality the heaviest query tiles go to the first wave.
// Left for later: overlapping one tile's softmax with the next Q K^T,
// persistent blocks, clusters multicasting K/V to the query heads that share
// it, fp8.
#include "hopper.cuh"

namespace sc {
namespace {

using namespace hopper;

constexpr int BQ = 128, BKV = 128, STAGES = 2, CONSUMERS = 2;
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int HALF_BYTES = 128 * 128;  // one box: 128 rows of 64 bf16
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

template <int D>
struct Layout {
  static constexpr int TILE = (D / 64) * HALF_BYTES;  // [128, D] bf16
  static constexpr int q = 0;
  static constexpr int kv = q + TILE;  // stage s: K at kv + 2 s TILE, V one TILE on
  static constexpr int bars = kv + STAGES * 2 * TILE;
  static constexpr int bytes = bars + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
};

struct Params {
  const int* kv_len;
  int Hq, Hkv, Sq, Sk, causal, q_off, k_off, nq;
  float scale_log2;
  __nv_bfloat16* o;  // K3: bf16 output through (batch, head, seq) strides
  int64_t osb, osh, oss;
  float* acc;  // K5: contiguous f32 acc [B, Hq, Sq, D], m and l [B, Hq, Sq]
  float* m;
  float* l;
  float neg_inf;
  float scale;  // natural units, for kSoftmaxBf16S
};

constexpr float CLAMP_LOG2 = 80.0f * LOG2E;  // the clamp at 80, in exp2's domain

template <int D, bool kPartial, int kSoftmax>
__global__ void __launch_bounds__(THREADS, 1)
    flash_prefill_kernel(__grid_constant__ const CUtensorMap qmap,
                         __grid_constant__ const CUtensorMap kmap,
                         __grid_constant__ const CUtensorMap vmap, const Params p) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int b = blockIdx.x / p.Hq, h = blockIdx.x % p.Hq;
  const int q0 = (p.causal ? p.nq - 1 - (int)blockIdx.y : (int)blockIdx.y) * BQ;
  const int kvlen = p.kv_len ? min(p.kv_len[b], p.Sk) : p.Sk;
  // Keys past the tile's last row's causal horizon or past kv_length are
  // never loaded.
  const int kend = p.causal ? min(kvlen, p.q_off - p.k_off + q0 + BQ) : kvlen;
  const int ntiles = kend > 0 ? (kend + BKV - 1) / BKV : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // Producer: one thread keeps the K/V ring full.
    setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS * 128) {
      const int hk = h / (p.Hq / p.Hkv);
      tma_prefetch_map(&qmap);
      tma_prefetch_map(&kmap);
      tma_prefetch_map(&vmap);
      mbar_expect_tx(q_full, L::TILE);
      for (int hf = 0; hf < D / 64; ++hf)
        tma_load_4d(smem + L::q + hf * HALF_BYTES, &qmap, q_full, 64 * hf, q0, h, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[s], ((t / STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * L::TILE);
        uint8_t* kd = smem + L::kv + s * 2 * L::TILE;
        for (int hf = 0; hf < D / 64; ++hf) {
          tma_load_4d(kd + hf * HALF_BYTES, &kmap, &full[s], 64 * hf, t * BKV, hk, b);
          tma_load_4d(kd + L::TILE + hf * HALF_BYTES, &vmap, &full[s], 64 * hf, t * BKV, hk,
                      b);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63. In wgmma's
  // accumulator layout this thread holds rows rr and rr + 8 of them
  // (rr = 16 warp + lane / 4) at columns 8 j + c2 + {0, 1}: element
  // 4 j + e is row rr + 8 (e >> 1), column 8 j + c2 + (e & 1).
  setmaxnreg_inc<240>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int rr = 16 * warp + lane / 4, c2 = 2 * (lane % 4);
  const int row0 = q0 + 64 * wg + rr;  // this thread's first row (local)

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m2[2] = {-INFINITY, -INFINITY};  // running max, exp2 domain
  float lsum[2] = {0.0f, 0.0f};          // this thread's share of l
  const uint32_t qa = smem_addr(smem + L::q) + wg * 64 * 128;
  mbar_wait(q_full, 0);

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES, k0 = t * BKV;
    mbar_wait(&full[s], (t / STAGES) & 1);
    const uint32_t ka = smem_addr(smem + L::kv + s * 2 * L::TILE);
    const uint32_t va = ka + L::TILE;

    float sc[64];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * HALF_BYTES + (kk % 4) * 32;
      wgmma_ss_n128(sc, desc_sw128(qa + off, 16, 1024), desc_sw128(ka + off, 16, 1024),
                    kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    const bool ragged = k0 + BKV > kvlen;
    if (ragged) {
      // The boundary tile: zero V's rows past kv_length (both consumer
      // warpgroups, then a barrier among them) before either reads it.
      const int first = kvlen - k0;
      uint4* vz = reinterpret_cast<uint4*>(smem + L::kv + s * 2 * L::TILE + L::TILE);
      const int chunks = (BKV - first) * 8;  // 16-byte chunks of a 128-byte row
      for (int hf = 0; hf < D / 64; ++hf)
        for (int i = threadIdx.x; i < chunks; i += CONSUMERS * 128)
          vz[hf * (HALF_BYTES / 16) + first * 8 + i] = make_uint4(0, 0, 0, 0);
      fence_proxy_async();
      named_barrier_sync(1, CONSUMERS * 128);
    }
    if (ragged || (p.causal && p.k_off + k0 + BKV - 1 > p.q_off + q0 + 64 * wg)) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + c2 + (e & 1), row = row0 + 8 * (e >> 1);
          const bool ok = col < kvlen && (!p.causal || p.k_off + col <= p.q_off + row);
          sc[4 * j + e] = ok ? sc[4 * j + e] : -INFINITY;
        }
    }

    if constexpr (kSoftmax == kSoftmaxExact) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float alpha[2], mneg[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m2[r], mx[r] * p.scale_log2);
        alpha[r] = m_new == -INFINITY ? 1.0f : exp2f(m2[r] - m_new);
        mneg[r] = m_new == -INFINITY ? 0.0f : -m_new;
        m2[r] = m_new;
        lsum[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = exp2f(fmaf(sc[i], p.scale_log2, mneg[r]));
        lsum[r] += sc[i];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    } else {
      // The clamp softmax: m fixed at 0, so no max and no rescale of O.
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        if constexpr (kSoftmax == kSoftmaxClamp) {
          sc[i] = exp2f(fminf(sc[i] * p.scale_log2, CLAMP_LOG2));
        } else {
          const float x = __bfloat162float(__float2bfloat16(sc[i] * p.scale));
          sc[i] = __bfloat162float(__float2bfloat16(expf(fminf(x, 80.0f))));
        }
        lsum[(i >> 1) & 1] += sc[i];
      }
    }

    // O += P V: P's accumulator fragment for keys 16 ks .. + 15 is wgmma's
    // register A fragment for that k-step.
    uint32_t pa[BKV / 16][4];
#pragma unroll
    for (int ks = 0; ks < BKV / 16; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[ks][i] = pack_bf16x2(sc[8 * ks + 2 * i], sc[8 * ks + 2 * i + 1]);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BKV / 16; ++ks) {
      const uint64_t db = desc_sw128(va + ks * 16 * 128, HALF_BYTES, 1024);
      if constexpr (D == 128)
        wgmma_rs_n128_tb(o, pa[ks], db);
      else
        wgmma_rs_n64_tb(o, pa[ks], db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = lsum[r] + __shfl_xor_sync(0xffffffffu, lsum[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  if constexpr (kPartial) {
    const int64_t base = (int64_t)(b * p.Hq + h) * p.Sq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= p.Sq) continue;
      float* dst = p.acc + (base + row) * D + c2;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(o[4 * j + 2 * r],
                                                              o[4 * j + 2 * r + 1]);
      if (lane % 4 == 0) {
        p.m[base + row] = fmaxf(m2[r] * LN2, p.neg_inf);
        p.l[base + row] = l[r];
      }
    }
  } else {
    // Normalize, round to bf16 and stage the warpgroup's 64 rows in its own
    // (swizzled) rows of the Q tile, then write 16-byte rows through o's
    // strides.
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      inv[r] = kSoftmax == kSoftmaxExact ? (l[r] > 0.0f ? 1.0f / l[r] : 0.0f)
                                         : 1.0f / fmaxf(l[r], 1e-30f);
    uint8_t* stage = smem + L::q + wg * 64 * 128;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = rr + 8 * r;
        *reinterpret_cast<uint32_t*>(stage + (j / 8) * HALF_BYTES + row * 128 +
                                     (((j % 8) ^ (row % 8)) * 16) + c2 * 2) =
            pack_bf16x2(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
      }
    named_barrier_sync(2 + wg, 128);
    __nv_bfloat16* ob = p.o + b * p.osb + h * p.osh;
    for (int i = tid; i < 64 * (D / 8); i += 128) {
      const int row = i / (D / 8), j = i % (D / 8);
      const int qrow = q0 + 64 * wg + row;
      if (qrow >= p.Sq) continue;
      *reinterpret_cast<uint4*>(ob + (int64_t)qrow * p.oss + 8 * j) =
          *reinterpret_cast<const uint4*>(stage + (j / 8) * HALF_BYTES + row * 128 +
                                          (((j % 8) ^ (row % 8)) * 16));
    }
  }
}

template <int D, bool kPartial, int kSoftmax>
cudaError_t launch(const void* q, const int64_t* qs, const void* k, const int64_t* ks,
                   const void* v, const int64_t* vs, Params p, int B, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  cudaError_t err = make_map_bf16(&qm, q, qs, B, p.Hq, p.Sq, D, BQ);
  if (err == cudaSuccess) err = make_map_bf16(&km, k, ks, B, p.Hkv, p.Sk, D, BKV);
  if (err == cudaSuccess) err = make_map_bf16(&vm, v, vs, B, p.Hkv, p.Sk, D, BKV);
  if (err != cudaSuccess) return err;
  constexpr int bytes = Layout<D>::bytes;
  err = cudaFuncSetAttribute(flash_prefill_kernel<D, kPartial, kSoftmax>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  p.nq = (p.Sq + BQ - 1) / BQ;
  const dim3 grid(B * p.Hq, p.nq);
  flash_prefill_kernel<D, kPartial, kSoftmax><<<grid, THREADS, bytes, stream>>>(qm, km, vm, p);
  return cudaGetLastError();
}

template <bool kPartial, int kSoftmax = kSoftmaxExact>
cudaError_t launch_d(const void* q, const int64_t* qs, const void* k, const int64_t* ks,
                     const void* v, const int64_t* vs, const Params& p, int B, int D,
                     cudaStream_t stream) {
  if (D == 64) return launch<64, kPartial, kSoftmax>(q, qs, k, ks, v, vs, p, B, stream);
  if (D == 128) return launch<128, kPartial, kSoftmax>(q, qs, k, ks, v, vs, p, B, stream);
  return cudaErrorInvalidValue;
}

Params params(const int* kv_len, int Hq, int Hkv, int Sq, int Sk, int causal, float scale,
              int q_off, int k_off) {
  Params p{};
  p.kv_len = kv_len;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.Sq = Sq;
  p.Sk = Sk;
  p.causal = causal;
  p.q_off = q_off;
  p.k_off = k_off;
  p.scale_log2 = scale * LOG2E;
  p.scale = scale;
  return p;
}

template <int D>
cudaError_t attributes(int partial, int softmax, cudaFuncAttributes* a) {
  if (partial)
    return softmax == kSoftmaxExact
               ? cudaFuncGetAttributes(a, flash_prefill_kernel<D, true, kSoftmaxExact>)
               : cudaErrorInvalidValue;
  if (softmax == kSoftmaxExact)
    return cudaFuncGetAttributes(a, flash_prefill_kernel<D, false, kSoftmaxExact>);
  if (softmax == kSoftmaxClamp)
    return cudaFuncGetAttributes(a, flash_prefill_kernel<D, false, kSoftmaxClamp>);
  if (softmax == kSoftmaxBf16S)
    return cudaFuncGetAttributes(a, flash_prefill_kernel<D, false, kSoftmaxBf16S>);
  return cudaErrorInvalidValue;
}

}  // namespace

cudaError_t launch_vit_attention(const __nv_bfloat16* q, const int64_t* qs,
                                 const __nv_bfloat16* k, const int64_t* ks,
                                 const __nv_bfloat16* v, const int64_t* vs, __nv_bfloat16* o,
                                 const int64_t* os, int B, int H, int Sq, int Sk, int D,
                                 float scale, float scale_log2, int softmax,
                                 cudaStream_t stream) {
  Params p = params(/*kv_len=*/nullptr, H, H, Sq, Sk, /*causal=*/0, scale, 0, 0);
  p.scale_log2 = scale_log2;
  p.o = o;
  p.osb = os[0];
  p.osh = os[1];
  p.oss = os[2];
  if (softmax == kSoftmaxExact)
    return launch_d<false, kSoftmaxExact>(q, qs, k, ks, v, vs, p, B, D, stream);
  if (softmax == kSoftmaxClamp)
    return launch_d<false, kSoftmaxClamp>(q, qs, k, ks, v, vs, p, B, D, stream);
  if (softmax == kSoftmaxBf16S)
    return launch_d<false, kSoftmaxBf16S>(q, qs, k, ks, v, vs, p, B, D, stream);
  return cudaErrorInvalidValue;
}

}  // namespace sc

// K3. strides: three int64 (batch, head, seq) per tensor, in elements; o is
// bf16 [B, Hq, Sq, D] through its strides.
extern "C" int sc_flash_attention(const void* q, const int64_t* q_strides, const void* k,
                                  const int64_t* k_strides, const void* v,
                                  const int64_t* v_strides, void* o,
                                  const int64_t* o_strides, const int* kv_len, int B,
                                  int Hq, int Hkv, int Sq, int Sk, int D, int causal,
                                  float scale, void* stream) {
  sc::Params p = sc::params(kv_len, Hq, Hkv, Sq, Sk, causal, scale, 0, 0);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.osb = o_strides[0];
  p.osh = o_strides[1];
  p.oss = o_strides[2];
  return static_cast<int>(sc::launch_d<false>(q, q_strides, k, k_strides, v, v_strides, p,
                                              B, D, static_cast<cudaStream_t>(stream)));
}

// K5. strides: three int64 (batch, head, seq) per input, in elements; acc
// [B, Hq, Sq, D], m and l [B, Hq, Sq]: contiguous f32.
extern "C" int sc_flash_attention_partial(const void* q, const int64_t* q_strides,
                                          const void* k, const int64_t* k_strides,
                                          const void* v, const int64_t* v_strides, void* acc,
                                          void* m, void* l, const int* kv_len, int B, int Hq,
                                          int Hkv, int Sq, int Sk, int D, int causal,
                                          float scale, int q_off, int k_off, float neg_inf,
                                          void* stream) {
  sc::Params p = sc::params(kv_len, Hq, Hkv, Sq, Sk, causal, scale, q_off, k_off);
  p.acc = static_cast<float*>(acc);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.neg_inf = neg_inf;
  return static_cast<int>(sc::launch_d<true>(q, q_strides, k, k_strides, v, v_strides, p, B,
                                             D, static_cast<cudaStream_t>(stream)));
}

// K14: non-causal attention over q [N, H, Sq, D], k / v [N, H, Sk, D]
// (strides: three int64 (image, head, seq) per input, in elements) into a
// contiguous o [N, H, Sq, D]; every key of every image is valid. Its own
// entry point, so that its launches are counted apart from K3's.
extern "C" int sc_vit_attention(const void* q, const int64_t* q_strides, const void* k,
                                const int64_t* k_strides, const void* v,
                                const int64_t* v_strides, void* o, int N, int H, int Sq,
                                int Sk, int D, float scale, void* stream) {
  const int64_t o_strides[3] = {(int64_t)H * Sq * D, (int64_t)Sq * D, D};
  return static_cast<int>(sc::launch_vit_attention(
      static_cast<const __nv_bfloat16*>(q), q_strides, static_cast<const __nv_bfloat16*>(k),
      k_strides, static_cast<const __nv_bfloat16*>(v), v_strides,
      static_cast<__nv_bfloat16*>(o), o_strides, N, H, Sq, Sk, D, scale, scale * sc::LOG2E,
      sc::kSoftmaxExact, static_cast<cudaStream_t>(stream)));
}

// Compiled attributes of the kernel for head dim D: K3 (partial = 0,
// softmax 0), K5 (partial = 1) or the ViT's attention in softmax mode
// `softmax` (sc::Softmax): out[0] registers per thread, out[1] local
// (spill) bytes per thread, out[2] static shared bytes, out[3] the dynamic
// shared bytes it launches with.
extern "C" int sc_flash_prefill_attributes(int D, int partial, int softmax, int* out) {
  cudaFuncAttributes a{};
  cudaError_t err = D == 64    ? sc::attributes<64>(partial, softmax, &a)
                    : D == 128 ? sc::attributes<128>(partial, softmax, &a)
                               : cudaErrorInvalidValue;
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = D == 64 ? sc::Layout<64>::bytes : sc::Layout<128>::bytes;
  return 0;
}
