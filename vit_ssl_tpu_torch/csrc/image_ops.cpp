// OpenCV's uint8 image arithmetic for the host transforms, equal bit for bit to
// the port's numpy versions (vit_ssl_tpu_torch/data/image_ops.py, resize_plain,
// rgb_to_hsv_plain, hsv_to_rgb_plain, gaussian_blur_plain), which are held
// against cv2.resize, cv2.cvtColor and cv2.GaussianBlur (OpenCV 5.0, x86-64):
//
//   - image_resize, INTER_LINEAR (1): source coordinate (d + 0.5)·scale - 0.5
//     in float32, 11-bit weights rounded one by one, a horizontal pass in
//     integers, then the vertical pass as OpenCV's vector code computes it,
//     ((r0 >> 4)·b0 >> 16) + ((r1 >> 4)·b1 >> 16), rounded by (s + 2) >> 2. A
//     shrink by exactly 2 on both axes is the 2x2 box (INTER_AREA).
//   - image_resize, INTER_AREA (0): when both axes shrink, an integer factor
//     is a box average ((sum + 2) >> 2 for 2x2, else sum·(1/area) in float32
//     rounded half to even), any other factor sums each destination pixel's
//     covered source pixels with float32 coverage weights, rows then
//     columns, rounded half to even; where an axis grows, the linear path
//     with the area variant of the coordinates.
//   - image_rgb_to_hsv: the 12-bit division tables, all integer.
//   - image_hsv_to_rgb: float32 with its products fused (std::fma), times 255;
//     each row in blocks of 32 pixels, which truncate, its remaining (width
//     mod 32) pixels rounded half to even.
//   - image_gaussian_blur: getGaussianKernel's float64 kernel (its sum taken
//     as Python 3.12's sum() takes it, compensated) made an 8-bit fixed-point
//     kernel by error diffusion, one separable pass in integers with
//     reflect-101 borders, (sum + 2^15) >> 16.
//
// Built in ISO C++17 mode (kernels.py HOST_FLAGS): floating-point
// contraction stays off, so every float32 product and sum rounds where the
// numpy version's does. Images are (H, W, C) uint8 with C channels and rows
// `row_stride` bytes apart; outputs are allocated by the caller. The C entries
// keep no state, so any number of threads may call them at once; they are
// bound with ctypes (data/image_ops.py), which releases the GIL.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include "host_image.h"

namespace {

constexpr int kCoefScale = 2048;  // INTER_RESIZE_COEF_SCALE
constexpr int kHsvShift = 12;
constexpr int kHsvBlock = 32;
constexpr double kDblEpsilon = 2.220446049250313e-16;

struct Axis {
  std::vector<int> s0, s1;   // the two source columns a destination column reads
  std::vector<int> w0, w1;   // their 11-bit weights
  std::vector<uint8_t> one;  // 1 where it reads one source pixel (the last column and past it)
};

// each destination index's first source index and float32 fraction
void linear_coords(int dsize, double scale, double inv_scale, bool area_mode,
                   std::vector<int64_t>& s, std::vector<float>& f) {
  s.resize(dsize);
  f.resize(dsize);
  for (int d = 0; d < dsize; ++d) {
    if (area_mode) {
      const int64_t si = static_cast<int64_t>(std::floor(d * scale));
      float fi = static_cast<float>(static_cast<double>(d + 1) -
                                    static_cast<double>(si + 1) * inv_scale);
      fi = fi <= 0.0f ? 0.0f : fi - std::floor(fi);
      s[d] = si;
      f[d] = fi;
    } else {
      const float fi = static_cast<float>((d + 0.5) * scale - 0.5);
      const int64_t si = static_cast<int64_t>(std::floor(fi));
      s[d] = si;
      f[d] = fi - static_cast<float>(si);
    }
  }
}

inline int weight(float v) { return static_cast<int>(std::nearbyint(v * 2048.0f)); }

void resize_linear(const uint8_t* src, int sh, int sw, int cn, int64_t stride, uint8_t* dst,
                   int dh, int dw, bool area_mode) {
  const double inv_x = static_cast<double>(dw) / sw, inv_y = static_cast<double>(dh) / sh;
  std::vector<int64_t> sx, sy;
  std::vector<float> fx, fy;
  linear_coords(dw, 1.0 / inv_x, inv_x, area_mode, sx, fx);
  linear_coords(dh, 1.0 / inv_y, inv_y, area_mode, sy, fy);
  Axis x;
  x.s0.resize(dw);
  x.s1.resize(dw);
  x.w0.resize(dw);
  x.w1.resize(dw);
  x.one.resize(dw);
  for (int d = 0; d < dw; ++d) {
    int64_t s = sx[d];
    float f = fx[d];
    if (s < 0) {
      f = 0.0f;
      s = 0;
    }
    const bool edge = s >= sw - 1;
    if (edge) {
      f = 0.0f;
      s = sw - 1;
    }
    x.s0[d] = static_cast<int>(s);
    x.s1[d] = static_cast<int>(std::min<int64_t>(s + 1, sw - 1));
    x.w0[d] = weight(1.0f - f);
    x.w1[d] = weight(f);
    x.one[d] = edge;
  }
  const size_t row_len = static_cast<size_t>(dw) * cn;
  // two horizontal passes held at a time: the source rows they hold
  std::vector<int32_t> held[2] = {std::vector<int32_t>(row_len), std::vector<int32_t>(row_len)};
  int tag[2] = {-1, -1};
  auto horizontal = [&](int y, int32_t* out) {
    const uint8_t* row = src + y * stride;
    for (int d = 0; d < dw; ++d) {
      const uint8_t* p0 = row + static_cast<size_t>(x.s0[d]) * cn;
      const uint8_t* p1 = row + static_cast<size_t>(x.s1[d]) * cn;
      int32_t* o = out + static_cast<size_t>(d) * cn;
      if (x.one[d]) {
        for (int c = 0; c < cn; ++c) o[c] = p0[c] * kCoefScale;
      } else {
        for (int c = 0; c < cn; ++c) o[c] = p0[c] * x.w0[d] + p1[c] * x.w1[d];
      }
    }
  };
  // source row y's horizontal pass, kept beside row `keep` if that is held
  auto source_row = [&](int y, int keep) -> const int32_t* {
    for (int k = 0; k < 2; ++k)
      if (tag[k] == y) return held[k].data();
    const int slot = tag[0] == keep ? 1 : 0;
    horizontal(y, held[slot].data());
    tag[slot] = y;
    return held[slot].data();
  };
  for (int d = 0; d < dh; ++d) {
    const int y0 = static_cast<int>(std::clamp<int64_t>(sy[d], 0, sh - 1));
    const int y1 = static_cast<int>(std::clamp<int64_t>(sy[d] + 1, 0, sh - 1));
    const int b0 = weight(1.0f - fy[d]), b1 = weight(fy[d]);
    const int32_t* r0 = source_row(y0, y1);
    const int32_t* r1 = source_row(y1, y0);
    uint8_t* o = dst + static_cast<size_t>(d) * row_len;
    for (size_t i = 0; i < row_len; ++i) {
      const int32_t v = (((r0[i] >> 4) * b0 >> 16) + ((r1[i] >> 4) * b1 >> 16) + 2) >> 2;
      o[i] = static_cast<uint8_t>(std::clamp(v, 0, 255));
    }
  }
}

// OpenCV's computeResizeAreaTab: each destination index's source indices
// and float32 weights, in its order
void area_table(int ssize, int dsize, double scale, std::vector<std::vector<int>>& index,
                std::vector<std::vector<float>>& alpha) {
  index.assign(dsize, {});
  alpha.assign(dsize, {});
  for (int dx = 0; dx < dsize; ++dx) {
    const double fsx1 = dx * scale;
    const double fsx2 = fsx1 + scale;
    const double cell = std::min(scale, ssize - fsx1);
    int64_t sx1 = static_cast<int64_t>(std::ceil(fsx1));
    int64_t sx2 = static_cast<int64_t>(std::floor(fsx2));
    sx2 = std::min<int64_t>(sx2, ssize - 1);
    sx1 = std::min(sx1, sx2);
    if (sx1 - fsx1 > 1e-3) {
      index[dx].push_back(static_cast<int>(sx1 - 1));
      alpha[dx].push_back(static_cast<float>((sx1 - fsx1) / cell));
    }
    for (int64_t s = sx1; s < sx2; ++s) {
      index[dx].push_back(static_cast<int>(s));
      alpha[dx].push_back(static_cast<float>(1.0 / cell));
    }
    if (fsx2 - sx2 > 1e-3) {
      index[dx].push_back(static_cast<int>(sx2));
      alpha[dx].push_back(static_cast<float>(std::min(std::min(fsx2 - sx2, 1.0), cell) / cell));
    }
  }
}

void resize_area(const uint8_t* src, int sh, int sw, int cn, int64_t stride, uint8_t* dst,
                 int dh, int dw) {
  const double scale_x = 1.0 / (static_cast<double>(dw) / sw);
  const double scale_y = 1.0 / (static_cast<double>(dh) / sh);
  const int ix = static_cast<int>(std::nearbyint(scale_x));
  const int iy = static_cast<int>(std::nearbyint(scale_y));
  if (std::fabs(scale_x - ix) < kDblEpsilon && std::fabs(scale_y - iy) < kDblEpsilon) {
    const float inv_area = static_cast<float>(1.0 / (ix * iy));
    for (int y = 0; y < dh; ++y) {
      for (int x = 0; x < dw; ++x) {
        for (int c = 0; c < cn; ++c) {
          int32_t total = 0;
          for (int j = 0; j < iy; ++j) {
            const uint8_t* row = src + (static_cast<int64_t>(y) * iy + j) * stride;
            for (int i = 0; i < ix; ++i) total += row[(static_cast<size_t>(x) * ix + i) * cn + c];
          }
          uint8_t& o = dst[(static_cast<size_t>(y) * dw + x) * cn + c];
          if (ix == 2 && iy == 2) {
            o = static_cast<uint8_t>((total + 2) >> 2);
          } else {
            const float mean = static_cast<float>(total) * inv_area;
            o = static_cast<uint8_t>(std::clamp(std::nearbyint(mean), 0.0f, 255.0f));
          }
        }
      }
    }
    return;
  }
  std::vector<std::vector<int>> x_index, y_index;
  std::vector<std::vector<float>> x_alpha, y_alpha;
  area_table(sw, dw, scale_x, x_index, x_alpha);
  area_table(sh, dh, scale_y, y_index, y_alpha);
  const size_t row_len = static_cast<size_t>(dw) * cn;
  std::vector<float> cols(static_cast<size_t>(sh) * row_len);
  for (int y = 0; y < sh; ++y) {
    const uint8_t* row = src + y * stride;
    float* o = cols.data() + y * row_len;
    for (int d = 0; d < dw; ++d) {
      for (int c = 0; c < cn; ++c) {
        float acc = 0.0f;
        for (size_t j = 0; j < x_index[d].size(); ++j)
          acc = acc + static_cast<float>(row[static_cast<size_t>(x_index[d][j]) * cn + c]) *
                          x_alpha[d][j];
        o[static_cast<size_t>(d) * cn + c] = acc;
      }
    }
  }
  std::vector<float> acc(row_len);
  for (int d = 0; d < dh; ++d) {
    std::fill(acc.begin(), acc.end(), 0.0f);
    for (size_t j = 0; j < y_index[d].size(); ++j) {
      const float* r = cols.data() + static_cast<size_t>(y_index[d][j]) * row_len;
      const float a = y_alpha[d][j];
      for (size_t i = 0; i < row_len; ++i) acc[i] = acc[i] + r[i] * a;
    }
    uint8_t* o = dst + static_cast<size_t>(d) * row_len;
    for (size_t i = 0; i < row_len; ++i)
      o[i] = static_cast<uint8_t>(std::clamp(std::nearbyint(acc[i]), 0.0f, 255.0f));
  }
}

// getGaussianKernel(size, sigma) in float64, as data/image_ops.py computes
// it: the side values' sum taken as Python 3.12's sum() takes a list of
// floats (Neumaier's compensated sum)
std::vector<double> gaussian_kernel(int size, double sigma) {
  const double scale = -0.125 / (sigma * sigma);
  std::vector<double> values;
  for (int x = 1 - size; x < 0; x += 2) values.push_back(std::exp(static_cast<double>(x * x) * scale));
  double total = 0.0, c = 0.0;
  for (size_t i = 0; i < values.size(); ++i) {
    const double v = values[i];
    if (i == 0) {
      total = v;
      continue;
    }
    const double t = total + v;
    if (std::fabs(total) >= std::fabs(v)) {
      c += (total - t) + v;
    } else {
      c += (v - t) + total;
    }
    total = t;
  }
  if (c != 0.0 && std::isfinite(c)) total += c;
  const double mul = 1.0 / (2.0 * total + 1.0);
  std::vector<double> kernel(size);
  const int half = size / 2;
  for (int i = 0; i < half; ++i) kernel[i] = kernel[size - 1 - i] = values[i] * mul;
  kernel[half] = mul;
  return kernel;
}

// the 8-bit fixed-point kernel: error diffusion from the outside in, the
// centre taking what makes the sum exactly 256
std::vector<int32_t> gaussian_kernel_fixed(int size, double sigma) {
  const std::vector<double> kernel = gaussian_kernel(size, sigma);
  const int half = size / 2;
  std::vector<int32_t> out(size);
  double err = 0.0;
  int32_t side = 0;
  for (int i = 0; i < half; ++i) {
    const double adjusted = kernel[i] * 256.0 + err;
    const double value = std::nearbyint(adjusted);  // half to even, as cvRound
    err = adjusted - value;
    out[i] = out[size - 1 - i] = static_cast<int32_t>(value);
    side += out[i];
  }
  out[half] = 256 - 2 * side;
  return out;
}

// reflect-101 (numpy's "reflect"): the source index of padded index i - pad
inline int reflect101(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i < n ? i : period - i;
}

}  // namespace

extern "C" {

// cv2.resize of the uint8 (sh, sw, cn) image src, rows src_row_stride bytes
// apart, into dst (dh, dw, cn), contiguous: interpolation 0 INTER_AREA, 1
// INTER_LINEAR. Returns 0, or 1 for an argument out of range.
int image_resize(const uint8_t* src, int sh, int sw, int cn, int64_t src_row_stride,
                 uint8_t* dst, int dh, int dw, int interpolation) {
  if (sh <= 0 || sw <= 0 || dh <= 0 || dw <= 0 || cn <= 0 || interpolation < 0 ||
      interpolation > 1)
    return 1;
  if (sh == dh && sw == dw) {
    for (int y = 0; y < sh; ++y)
      std::memcpy(dst + static_cast<size_t>(y) * sw * cn, src + y * src_row_stride,
                  static_cast<size_t>(sw) * cn);
    return 0;
  }
  bool area = interpolation == 0;
  const double scale_x = 1.0 / (static_cast<double>(dw) / sw);
  const double scale_y = 1.0 / (static_cast<double>(dh) / sh);
  if (!area && std::fabs(scale_x - 2) < kDblEpsilon && std::fabs(scale_y - 2) < kDblEpsilon)
    area = true;  // OpenCV takes an exact 2x shrink as INTER_AREA
  if (area && scale_x >= 1 && scale_y >= 1)
    resize_area(src, sh, sw, cn, src_row_stride, dst, dh, dw);
  else
    resize_linear(src, sh, sw, cn, src_row_stride, dst, dh, dw, area);
  return 0;
}

// cv2.cvtColor(RGB2HSV) of n pixels (r, g, b) into (h, s, v), h in [0, 180)
void image_rgb_to_hsv(const uint8_t* src, uint8_t* dst, int64_t n) {
  int32_t sdiv[256] = {0}, hdiv[256] = {0};
  for (int i = 1; i < 256; ++i) {
    sdiv[i] = static_cast<int32_t>(std::nearbyint((255 << kHsvShift) / static_cast<double>(i)));
    hdiv[i] = static_cast<int32_t>(
        std::nearbyint((180 << kHsvShift) / (6.0 * static_cast<double>(i))));
  }
  const int64_t half = 1 << (kHsvShift - 1);
  for (int64_t p = 0; p < n; ++p) {
    const int64_t r = src[3 * p], g = src[3 * p + 1], b = src[3 * p + 2];
    const int64_t v = std::max(std::max(b, g), r);
    const int64_t diff = v - std::min(std::min(b, g), r);
    const int64_t s = (diff * sdiv[v] + half) >> kHsvShift;
    int64_t h = v == r ? g - b : v == g ? b - r + 2 * diff : r - g + 4 * diff;
    h = (h * hdiv[diff] + half) >> kHsvShift;
    if (h < 0) h += 180;
    dst[3 * p] = static_cast<uint8_t>(h);
    dst[3 * p + 1] = static_cast<uint8_t>(s);
    dst[3 * p + 2] = static_cast<uint8_t>(v);
  }
}

// cv2.cvtColor(HSV2RGB) of rows of width pixels (h, s, v) into (r, g, b)
void image_hsv_to_rgb(const uint8_t* src, uint8_t* dst, int64_t rows, int width) {
  // each sector's (b, g, r) entries of (v, p, q, t)
  static const int kSectors[6][3] = {{1, 3, 0}, {1, 0, 2}, {3, 0, 1},
                                     {0, 2, 1}, {0, 1, 3}, {2, 1, 0}};
  const float hscale = static_cast<float>(6.0 / 180.0);
  const float inv = static_cast<float>(1.0 / 255.0);
  const int body = width - width % kHsvBlock;
  for (int64_t y = 0; y < rows; ++y) {
    for (int x = 0; x < width; ++x) {
      const int64_t p = y * width + x;
      float h = static_cast<float>(src[3 * p]) * hscale;
      const float s = static_cast<float>(src[3 * p + 1]) * inv;
      const float v = static_cast<float>(src[3 * p + 2]) * inv;
      h = std::fmod(h, 6.0f);
      int sector = static_cast<int>(std::floor(h));
      h = h - static_cast<float>(sector);
      if (sector < 0 || sector >= 6) {
        sector = 0;
        h = 0.0f;
      }
      const float table[4] = {
          v, v * (1.0f - s),
          v * static_cast<float>(std::fma(static_cast<double>(-s), static_cast<double>(h), 1.0)),
          v * static_cast<float>(
                  std::fma(static_cast<double>(-s), static_cast<double>(1.0f - h), 1.0))};
      float bgr[3];
      for (int k = 0; k < 3; ++k) bgr[k] = (s == 0.0f ? v : table[kSectors[sector][k]]) * 255.0f;
      for (int k = 0; k < 3; ++k) {
        const float q = x < body ? std::trunc(bgr[k]) : std::nearbyint(bgr[k]);
        dst[3 * p + 2 - k] = static_cast<uint8_t>(std::clamp(q, 0.0f, 255.0f));
      }
    }
  }
}

// getGaussianKernel's 8-bit fixed-point kernel of size (odd) and sigma > 0
// into out[0, size)
void image_gaussian_kernel_fixed(int size, double sigma, int32_t* out) {
  const std::vector<int32_t> k = gaussian_kernel_fixed(size, sigma);
  std::copy(k.begin(), k.end(), out);
}

// cv2.GaussianBlur of the uint8 (h, w, cn) image src, rows src_row_stride
// bytes apart, into dst (h, w, cn), contiguous, with kernel sizes kx, ky
// (odd) and sigmas sx, sy (> 0). Returns 0, or 1 for an argument out of range.
int image_gaussian_blur(const uint8_t* src, int h, int w, int cn, int64_t src_row_stride,
                        uint8_t* dst, int kx, int ky, double sx, double sy) {
  if (h <= 0 || w <= 0 || cn <= 0 || kx % 2 != 1 || ky % 2 != 1 || !(sx > 0) || !(sy > 0))
    return 1;
  const std::vector<int32_t> wx = gaussian_kernel_fixed(kx, sx);
  const std::vector<int32_t> wy = gaussian_kernel_fixed(ky, sy);
  const int rx = kx / 2, ry = ky / 2;
  std::vector<int> xmap(static_cast<size_t>(w) + 2 * rx);
  for (int i = 0; i < w + 2 * rx; ++i) xmap[i] = reflect101(i - rx, w) * cn;
  const size_t row_len = static_cast<size_t>(w) * cn;
  std::vector<int32_t> rows(static_cast<size_t>(h) * row_len);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = src + y * src_row_stride;
    int32_t* o = rows.data() + y * row_len;
    for (int x = 0; x < w; ++x) {
      for (int c = 0; c < cn; ++c) {
        int32_t acc = 0;
        for (int j = 0; j < kx; ++j) acc += wx[j] * row[xmap[x + j] + c];
        o[static_cast<size_t>(x) * cn + c] = acc;
      }
    }
  }
  std::vector<int32_t> acc(row_len);
  for (int y = 0; y < h; ++y) {
    std::fill(acc.begin(), acc.end(), 0);
    for (int i = 0; i < ky; ++i) {
      const int32_t* r = rows.data() + static_cast<size_t>(reflect101(y + i - ry, h)) * row_len;
      const int32_t k = wy[i];
      for (size_t t = 0; t < row_len; ++t) acc[t] += k * r[t];
    }
    uint8_t* o = dst + static_cast<size_t>(y) * row_len;
    for (size_t t = 0; t < row_len; ++t)
      o[t] = static_cast<uint8_t>(std::clamp((acc[t] + (1 << 15)) >> 16, 0, 255));
  }
  return 0;
}

}  // extern "C"
