// Host-side image math of the port's data pipeline: a copy of
// t2igan/native/image_core.h (the triangle-filter resize, the per-sample
// pyramid and the CLIP normalisation, unchanged, so the port's records equal
// the JAX package's), plus PIL's own BILINEAR resample for the Inception
// Score's Scale(32).
//
// Used by the per-sample calls of image_ops.cc and by the async executor of
// image_exec.cc.  The pyramid's resize is a separable triangle (bilinear)
// filter with antialiasing on downscale, in float (reference transform:
// datasets.py:86-115 + main.py:163-166).

#ifndef T2IGAN_TORCH_IMAGE_CORE_H_
#define T2IGAN_TORCH_IMAGE_CORE_H_

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace t2i {

struct Tap {
  int first;                // first source index
  std::vector<float> w;     // weights
};

// Precompute triangle-filter taps for 1-D resize from `in` to `out` samples.
inline void make_taps(int in, int out, std::vector<Tap>& taps) {
  taps.resize(out);
  const double scale = static_cast<double>(in) / out;
  const double support = std::max(1.0, scale);  // antialias on downscale
  for (int o = 0; o < out; ++o) {
    const double center = (o + 0.5) * scale;
    int lo = static_cast<int>(std::floor(center - support));
    int hi = static_cast<int>(std::ceil(center + support));
    lo = std::max(lo, 0);
    hi = std::min(hi, in);
    Tap& t = taps[o];
    t.first = lo;
    t.w.assign(hi - lo, 0.f);
    double sum = 0.0;
    for (int i = lo; i < hi; ++i) {
      const double x = (i + 0.5 - center) / support;
      const double w = std::max(0.0, 1.0 - std::fabs(x));  // triangle
      t.w[i - lo] = static_cast<float>(w);
      sum += w;
    }
    if (sum > 0) {
      for (auto& w : t.w) w = static_cast<float>(w / sum);
    } else {
      // degenerate window: nearest
      t.first = std::min(static_cast<int>(center), in - 1);
      t.w.assign(1, 1.f);
    }
  }
}

// Separable resize of interleaved RGB uint8 -> float32 [0,255].
inline void resize_rgb(const uint8_t* src, int sh, int sw, float* dst, int dh,
                       int dw) {
  std::vector<Tap> xt, yt;
  make_taps(sw, dw, xt);
  make_taps(sh, dh, yt);
  // horizontal pass: sh x dw x 3
  std::vector<float> tmp(static_cast<size_t>(sh) * dw * 3);
  for (int y = 0; y < sh; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * sw * 3;
    float* orow = tmp.data() + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      const Tap& t = xt[x];
      float r = 0.f, g = 0.f, b = 0.f;
      for (size_t k = 0; k < t.w.size(); ++k) {
        const uint8_t* p = row + (t.first + k) * 3;
        r += t.w[k] * p[0];
        g += t.w[k] * p[1];
        b += t.w[k] * p[2];
      }
      orow[x * 3 + 0] = r;
      orow[x * 3 + 1] = g;
      orow[x * 3 + 2] = b;
    }
  }
  // vertical pass: dh x dw x 3
  for (int y = 0; y < dh; ++y) {
    const Tap& t = yt[y];
    float* orow = dst + static_cast<size_t>(y) * dw * 3;
    std::memset(orow, 0, sizeof(float) * dw * 3);
    for (size_t k = 0; k < t.w.size(); ++k) {
      const float* irow = tmp.data() + static_cast<size_t>(t.first + k) * dw * 3;
      const float w = t.w[k];
      for (int i = 0; i < dw * 3; ++i) orow[i] += w * irow[i];
    }
  }
}

inline void normalize_clip_inplace(float* img, int n_px, const float* mean,
                                   const float* stdv) {
  for (int i = 0; i < n_px; ++i) {
    float* p = img + static_cast<size_t>(i) * 3;
    p[0] = (p[0] / 255.f - mean[0]) / stdv[0];
    p[1] = (p[1] / 255.f - mean[1]) / stdv[1];
    p[2] = (p[2] / 255.f - mean[2]) / stdv[2];
  }
}

// torchvision Scale semantics: shorter side -> scale_size.
inline void scaled_dims(int sh, int sw, int scale_size, int* nh, int* nw) {
  if (sw < sh) {
    *nw = scale_size;
    *nh = static_cast<int>(
        std::lround(static_cast<double>(scale_size) * sh / sw));
  } else {
    *nh = scale_size;
    *nw = static_cast<int>(
        std::lround(static_cast<double>(scale_size) * sw / sh));
  }
}

// Full per-sample pipeline (datasets.py:86-115 + main.py:163-166):
//   1. scale shorter side to `scale_size` (triangle filter),
//   2. crop `crop` x `crop` at (crop_x, crop_y),
//   3. optional horizontal flip,
//   4. for each of `n_branches` target sizes: resize + CLIP-normalize,
//      writing float32 HWC into outs[b].
// Returns 0 on success.
inline int pyramid_from_rgb(const uint8_t* src, int sh, int sw, int scale_size,
                            int crop, int crop_x, int crop_y, int flip,
                            const int* branch_sizes, int n_branches,
                            float** outs, const float* mean,
                            const float* stdv) {
  // 1. scale shorter side
  int nh, nw;
  scaled_dims(sh, sw, scale_size, &nh, &nw);
  std::vector<float> scaled(static_cast<size_t>(nh) * nw * 3);
  resize_rgb(src, sh, sw, scaled.data(), nh, nw);

  // 2+3. crop + flip back into a uint8 buffer (still [0,255])
  if (crop_x < 0 || crop_y < 0 || crop_x + crop > nw || crop_y + crop > nh)
    return 1;
  std::vector<uint8_t> cropped(static_cast<size_t>(crop) * crop * 3);
  for (int y = 0; y < crop; ++y) {
    const float* irow = scaled.data() +
        (static_cast<size_t>(crop_y + y) * nw + crop_x) * 3;
    uint8_t* orow = cropped.data() + static_cast<size_t>(y) * crop * 3;
    if (flip) {
      for (int x = 0; x < crop; ++x) {
        const float* p = irow + (crop - 1 - x) * 3;
        for (int c = 0; c < 3; ++c)
          orow[x * 3 + c] = static_cast<uint8_t>(
              std::min(255.f, std::max(0.f, std::lround(p[c]) * 1.f)));
      }
    } else {
      for (int x = 0; x < crop; ++x) {
        const float* p = irow + x * 3;
        for (int c = 0; c < 3; ++c)
          orow[x * 3 + c] = static_cast<uint8_t>(
              std::min(255.f, std::max(0.f, std::lround(p[c]) * 1.f)));
      }
    }
  }

  // 4. per-branch resize + normalize
  for (int b = 0; b < n_branches; ++b) {
    const int s = branch_sizes[b];
    if (s == crop) {
      for (size_t i = 0; i < static_cast<size_t>(crop) * crop * 3; ++i)
        outs[b][i] = static_cast<float>(cropped[i]);
    } else {
      resize_rgb(cropped.data(), crop, crop, outs[b], s, s);
    }
    normalize_clip_inplace(outs[b], s * s, mean, stdv);
  }
  return 0;
}

// PIL's Image.resize((dw, dh), BILINEAR or BICUBIC) of 8-bit RGB, bit for
// bit (Pillow's Resample.c: precompute_coeffs, normalize_coeffs_8bpc and
// the two 8bpc passes).  Support = the filter's (1 triangle, 2 cubic) times
// max(1, in/out); each output's window is [int(center - support + 0.5),
// int(center + support + 0.5)), its filter weights in double, normalised,
// then fixed point at 22 bits with a round-half bias (away from zero for
// the cubic's negative lobes); a horizontal pass to a uint8 intermediate,
// then a vertical one, each rounded and clipped.  A pass whose size is
// unchanged is skipped, as PIL skips it.
constexpr int kPilPrecision = 22;

struct PilBilinear {
  static constexpr double kSupport = 1.0;
  static double weight(double x) {
    if (x < 0.0) x = -x;
    return x < 1.0 ? 1.0 - x : 0.0;
  }
};

// Cubic convolution with a = -0.5 (Resample.c's bicubic_filter).
struct PilBicubic {
  static constexpr double kSupport = 2.0;
  static double weight(double x) {
    const double a = -0.5;
    if (x < 0.0) x = -x;
    if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
    if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
    return 0.0;
  }
};

template <typename Filter>
inline int pil_coeffs(int in_size, int out_size, std::vector<int>& bounds,
                      std::vector<int32_t>& kk) {
  const double scale = static_cast<double>(static_cast<float>(in_size)) /
                       out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = Filter::kSupport * filterscale;
  const int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  bounds.assign(static_cast<size_t>(out_size) * 2, 0);
  kk.assign(static_cast<size_t>(out_size) * ksize, 0);
  std::vector<double> k(ksize);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    const double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double ww = 0.0;
    for (int x = 0; x < xmax; ++x) {
      const double w = Filter::weight((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; ++x) {
      if (ww != 0.0) k[x] /= ww;
    }
    for (int x = 0; x < ksize; ++x) {
      const double v = x < xmax ? k[x] : 0.0;
      kk[static_cast<size_t>(xx) * ksize + x] = static_cast<int32_t>(
          v < 0 ? -0.5 + v * (1 << kPilPrecision)
                : 0.5 + v * (1 << kPilPrecision));
    }
    bounds[2 * xx] = xmin;
    bounds[2 * xx + 1] = xmax;
  }
  return ksize;
}

inline uint8_t pil_clip8(int in) {
  if (in >= (1 << kPilPrecision << 8)) return 255;
  if (in <= 0) return 0;
  return static_cast<uint8_t>(in >> kPilPrecision);
}

template <typename Filter>
inline void resize_pil(const uint8_t* src, int sh, int sw, uint8_t* dst,
                       int dh, int dw) {
  std::vector<uint8_t> tmp;
  const uint8_t* in = src;
  int w = sw;
  std::vector<int> bounds;
  std::vector<int32_t> kk;
  if (dw != sw) {
    const int ksize = pil_coeffs<Filter>(sw, dw, bounds, kk);
    tmp.resize(static_cast<size_t>(sh) * dw * 3);
    for (int y = 0; y < sh; ++y) {
      const uint8_t* row = src + static_cast<size_t>(y) * sw * 3;
      uint8_t* orow = tmp.data() + static_cast<size_t>(y) * dw * 3;
      for (int x = 0; x < dw; ++x) {
        const int xmin = bounds[2 * x], xmax = bounds[2 * x + 1];
        const int32_t* k = kk.data() + static_cast<size_t>(x) * ksize;
        int s0 = 1 << (kPilPrecision - 1), s1 = s0, s2 = s0;
        for (int i = 0; i < xmax; ++i) {
          const uint8_t* p = row + (xmin + i) * 3;
          s0 += p[0] * k[i];
          s1 += p[1] * k[i];
          s2 += p[2] * k[i];
        }
        orow[3 * x] = pil_clip8(s0);
        orow[3 * x + 1] = pil_clip8(s1);
        orow[3 * x + 2] = pil_clip8(s2);
      }
    }
    in = tmp.data();
    w = dw;
  }
  if (dh != sh) {
    const int ksize = pil_coeffs<Filter>(sh, dh, bounds, kk);
    for (int y = 0; y < dh; ++y) {
      const int ymin = bounds[2 * y], ymax = bounds[2 * y + 1];
      const int32_t* k = kk.data() + static_cast<size_t>(y) * ksize;
      uint8_t* orow = dst + static_cast<size_t>(y) * w * 3;
      for (int x = 0; x < w * 3; ++x) {
        int s = 1 << (kPilPrecision - 1);
        for (int i = 0; i < ymax; ++i)
          s += in[(static_cast<size_t>(ymin + i) * w) * 3 + x] * k[i];
        orow[x] = pil_clip8(s);
      }
    }
  } else {
    std::memcpy(dst, in, static_cast<size_t>(sh) * w * 3);
  }
}

}  // namespace t2i

#endif  // T2IGAN_TORCH_IMAGE_CORE_H_
