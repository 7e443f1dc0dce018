// The two per-pixel window filters of the depth fill: the 5x5 median and
// the bilateral filter of a float32 plane.
//
// Host code of gdm_tpu_torch/data/augment.py (not a device kernel): in
// numpy each needs 13-25 full-plane temporaries per crop.  The caller pads
// the plane by the window's radius (its border rule), so every window
// read is in bounds.  Built at first use with the host C++ compiler
// (gdm_tpu_torch/_build.py) and called through ctypes, which releases
// the GIL for the loader threads.  The default x86-64 target has no FMA,
// so the compiler contracts nothing: the bilateral sums round as numpy's
// float32 operations would.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <utility>
#include <vector>

namespace {

// Compare-exchanges of Batcher's odd-even merge sort of 32 values; the
// window's 25 fill the first slots, the other 7 hold +inf and stay there,
// so the exchanges that touch them are dropped.
std::vector<std::pair<int, int>> median25_network() {
  std::vector<std::pair<int, int>> net;
  const int n = 32;
  for (int p = 1; p < n; p <<= 1)
    for (int k = p; k >= 1; k >>= 1)
      for (int j = k % p; j + k < n; j += 2 * k)
        for (int i = 0; i < std::min(k, n - j - k); ++i)
          if ((i + j) / (2 * p) == (i + j + k) / (2 * p) && i + j + k < 25)
            net.emplace_back(i + j, i + j + k);
  return net;
}

}  // namespace

// The 5x5 median of an h x w plane given padded by 2 on every side: the
// 13th of the 25 window values.  A row at a time, each window slot a
// vector of the row's pixels, so the network's min/max vectorise.
extern "C" int gdm_median5(const float* pad, float* out, int h, int w) {
  static const std::vector<std::pair<int, int>> net = median25_network();
  const int64_t pw = w + 4;
  std::vector<float> win(static_cast<size_t>(25) * w);
  for (int y = 0; y < h; ++y) {
    for (int t = 0; t < 25; ++t) {
      const float* src = pad + (y + t / 5) * pw + t % 5;
      std::copy(src, src + w, win.data() + static_cast<size_t>(t) * w);
    }
    for (const auto& [a, b] : net) {
      float* pa = win.data() + static_cast<size_t>(a) * w;
      float* pb = win.data() + static_cast<size_t>(b) * w;
      for (int x = 0; x < w; ++x) {
        const float lo = std::min(pa[x], pb[x]), hi = std::max(pa[x], pb[x]);
        pa[x] = lo;
        pb[x] = hi;
      }
    }
    std::copy(win.data() + static_cast<size_t>(12) * w,
              win.data() + static_cast<size_t>(13) * w,
              out + static_cast<int64_t>(y) * w);
  }
  return 0;
}

// OpenCV's bilateral filter of an h x w plane given padded by ``radius``
// on every side, with the taps (dy, dx, space weight) and the colour
// table: per tap in order,
//   a = |v - c| * scale_index, i = (int)a, a -= i,
//   wt = space_w * (lut[i] + a * (lut[i+1] - lut[i])),
//   wsum += wt, acc += v * wt;  out = acc / wsum.
// Returns 1 if a colour index falls beyond the table.
extern "C" int gdm_bilateral(const float* pad, float* out, int h, int w,
                             int radius, const int* dy, const int* dx,
                             const float* space_w, int n_taps,
                             const float* lut, int n_lut,
                             float scale_index) {
  const int64_t pw = w + 2 * radius;
  std::vector<float> wsum(w), acc(w);
  for (int y = 0; y < h; ++y) {
    const float* centre = pad + (y + radius) * pw + radius;
    std::fill(wsum.begin(), wsum.end(), 0.0f);
    std::fill(acc.begin(), acc.end(), 0.0f);
    for (int t = 0; t < n_taps; ++t) {
      const float* tap = centre + dy[t] * pw + dx[t];
      const float sw = space_w[t];
      for (int x = 0; x < w; ++x) {
        const float v = tap[x];
        float a = std::fabs(v - centre[x]) * scale_index;
        const int i = static_cast<int>(a);
        if (i > n_lut - 2) return 1;
        a -= static_cast<float>(i);
        const float wt = sw * (lut[i] + a * (lut[i + 1] - lut[i]));
        wsum[x] += wt;
        acc[x] += v * wt;
      }
    }
    float* dst = out + static_cast<int64_t>(y) * w;
    for (int x = 0; x < w; ++x) dst[x] = acc[x] / wsum[x];
  }
  return 0;
}
