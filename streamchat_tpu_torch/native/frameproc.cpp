// frameproc: native host-side frame preprocessing for StreamChat-TPU.
//
// The reference's data-loader layer leans on native libraries (OpenCV decode
// + PIL/HF CLIPImageProcessor per-frame Python preprocessing,
// inference_streaming_longva_v2.py:503-511). This library is the TPU build's
// native equivalent for the host half of ingest: batched
// uint8 RGB [N,H,W,3]  ->  CLIP-normalized float32 [N,3,S,S]
// (shortest-edge ANTIALIASED bicubic resize, center crop, mean/std
// normalize), threaded across frames so decode/preprocess of segment N+1
// overlaps device compute of segment N. The device path
// (pipeline/preprocess.py, jax.image.resize antialias=True) remains the
// default; this one matches it numerically and wins when the TPU is
// saturated or when shipping f32 336x336 beats full-res u8 over the link.
//
// Resize is separable with per-axis weight tables computed once per batch
// geometry: Catmull-Rom kernel (a=-0.5) stretched by the scale factor on
// downscale — the same convention as PIL and jax.image.resize(antialias).
// C ABI only — loaded via ctypes (no pybind11 in this image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr float kMean[3] = {0.48145466f, 0.4578275f, 0.40821073f};
constexpr float kStd[3] = {0.26862954f, 0.26130258f, 0.27577711f};

inline float cubic_kernel(float x) {
  constexpr float a = -0.5f;  // Catmull-Rom
  x = std::fabs(x);
  if (x < 1.0f) return ((a + 2.0f) * x - (a + 3.0f)) * x * x + 1.0f;
  if (x < 2.0f) return (((x - 5.0f) * x + 8.0f) * x - 4.0f) * a;
  return 0.0f;
}

struct AxisTaps {
  // For each output index: first input tap and normalized weights.
  std::vector<int> first;
  std::vector<int> count;
  std::vector<float> weights;  // flattened, max_taps per output
  int max_taps = 0;
};

// Weight table for resizing an axis of length `in` to `resized`, but only
// for the `out_count` outputs starting at `out_offset` (the center crop).
AxisTaps make_taps(int in, int resized, int out_offset, int out_count) {
  AxisTaps t;
  const float scale = static_cast<float>(in) / static_cast<float>(resized);
  const float kscale = std::max(scale, 1.0f);  // antialias stretch
  const float support = 2.0f * kscale;
  t.max_taps = static_cast<int>(std::ceil(support)) * 2 + 2;
  t.first.resize(out_count);
  t.count.resize(out_count);
  t.weights.assign(static_cast<size_t>(out_count) * t.max_taps, 0.0f);
  for (int o = 0; o < out_count; ++o) {
    const float center =
        (static_cast<float>(o + out_offset) + 0.5f) * scale - 0.5f;
    int lo = static_cast<int>(std::floor(center - support)) + 1;
    int hi = static_cast<int>(std::floor(center + support));
    lo = std::max(lo, 0);
    hi = std::min(hi, in - 1);
    float sum = 0.0f;
    const int cnt = hi - lo + 1;
    t.first[o] = lo;
    t.count[o] = cnt;
    float* w = &t.weights[static_cast<size_t>(o) * t.max_taps];
    for (int i = 0; i < cnt; ++i) {
      const float v =
          cubic_kernel((static_cast<float>(lo + i) - center) / kscale);
      w[i] = v;
      sum += v;
    }
    if (sum != 0.0f) {
      for (int i = 0; i < cnt; ++i) w[i] /= sum;
    }
  }
  return t;
}

// One frame: HWC u8 [h, w, 3] -> CHW f32 [3, s, s] using precomputed taps.
// scratch: [h, s, 3] floats (horizontal pass output).
void process_one(const uint8_t* in, int h, int w, float* out, int s,
                 const AxisTaps& tx, const AxisTaps& ty, float* scratch) {
  // Horizontal: rows stay, columns -> s.
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = in + static_cast<size_t>(y) * w * 3;
    float* dst = scratch + static_cast<size_t>(y) * s * 3;
    for (int x = 0; x < s; ++x) {
      const int lo = tx.first[x];
      const int cnt = tx.count[x];
      const float* wgt = &tx.weights[static_cast<size_t>(x) * tx.max_taps];
      float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;
      const uint8_t* p = row + static_cast<size_t>(lo) * 3;
      for (int i = 0; i < cnt; ++i, p += 3) {
        const float wv = wgt[i];
        acc0 += wv * static_cast<float>(p[0]);
        acc1 += wv * static_cast<float>(p[1]);
        acc2 += wv * static_cast<float>(p[2]);
      }
      float* q = dst + static_cast<size_t>(x) * 3;
      q[0] = acc0;
      q[1] = acc1;
      q[2] = acc2;
    }
  }
  // Vertical: rows -> s; fuse normalize + CHW transpose.
  for (int c = 0; c < 3; ++c) {
    const float inv255_std = 1.0f / (255.0f * kStd[c]);
    const float mean_over_std = kMean[c] / kStd[c];
    float* plane = out + static_cast<size_t>(c) * s * s;
    for (int y = 0; y < s; ++y) {
      const int lo = ty.first[y];
      const int cnt = ty.count[y];
      const float* wgt = &ty.weights[static_cast<size_t>(y) * ty.max_taps];
      float* dst = plane + static_cast<size_t>(y) * s;
      for (int x = 0; x < s; ++x) {
        float acc = 0.0f;
        for (int i = 0; i < cnt; ++i) {
          acc += wgt[i] *
                 scratch[(static_cast<size_t>(lo + i) * s + x) * 3 + c];
        }
        dst[x] = acc * inv255_std - mean_over_std;
      }
    }
  }
}

}  // namespace

extern "C" {

// in:  [n, h, w, 3] uint8 RGB, contiguous.
// out: [n, 3, s, s] float32, contiguous (caller-allocated).
// num_threads <= 0 -> hardware concurrency.
void preprocess_frames(const uint8_t* in, int n, int h, int w, float* out,
                       int s, int num_threads) {
  if (n <= 0) return;
  // Shortest-edge resize geometry + center crop window.
  int rh, rw;
  if (h <= w) {
    rh = s;
    rw = std::max(
        s, static_cast<int>(std::lround(static_cast<double>(w) * s / h)));
  } else {
    rw = s;
    rh = std::max(
        s, static_cast<int>(std::lround(static_cast<double>(h) * s / w)));
  }
  const int top = (rh - s) / 2;
  const int left = (rw - s) / 2;
  const AxisTaps tx = make_taps(w, rw, left, s);
  const AxisTaps ty = make_taps(h, rh, top, s);

  int threads = num_threads > 0
                    ? num_threads
                    : static_cast<int>(std::thread::hardware_concurrency());
  threads = std::max(1, std::min(threads, n));
  const size_t in_stride = static_cast<size_t>(h) * w * 3;
  const size_t out_stride = static_cast<size_t>(3) * s * s;

  auto work = [&](int t) {
    std::vector<float> scratch(static_cast<size_t>(h) * s * 3);
    for (int i = t; i < n; i += threads) {
      process_one(in + i * in_stride, h, w, out + i * out_stride, s, tx, ty,
                  scratch.data());
    }
  };
  if (threads == 1) {
    work(0);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) pool.emplace_back(work, t);
  for (auto& th : pool) th.join();
}

// Luma grayscale: [n, 3, h, w] f32 -> [n, h, w] f32 (reference weights,
// utiles.py:110). Used by the host-side optical-flow path.
void grayscale_chw(const float* in, int n, int h, int w, float* out) {
  const size_t plane = static_cast<size_t>(h) * w;
  for (int i = 0; i < n; ++i) {
    const float* r = in + i * 3 * plane;
    const float* g = r + plane;
    const float* b = g + plane;
    float* dst = out + i * plane;
    for (size_t p = 0; p < plane; ++p) {
      dst[p] = 0.2989f * r[p] + 0.5870f * g[p] + 0.1140f * b[p];
    }
  }
}

int frameproc_abi_version() { return 1; }

}  // extern "C"
