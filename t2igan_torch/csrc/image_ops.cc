// Host-side image calls of the port's data pipeline, with a plain C
// interface for ctypes (t2igan_torch/data/native.py).
//
// The pyramid calls are copies of t2igan/native/image_ops.cc (the batched
// one parallel on std::thread instead of OpenMP); the decode calls wrap the
// port's own decoder (image_decode.cc), and t2i_load_sample is one sample of
// the thread engine: read, decode, CUB bbox crop, then the pyramid at a given
// crop.  Calls that can fail return 0 or an error code (T2I_ERR_*) and
// write a message into `err`.  None holds the Python interpreter lock:
// ctypes releases it around every call.
//
// Build (t2igan_torch/data/native.py does it at first use):
//   g++ -O3 -fPIC -shared -std=c++17 -pthread image_ops.cc image_decode.cc
//       image_exec.cc -o libt2igan_host.so -lz

#include <algorithm>
#include <cstdlib>
#include <string>
#include <thread>
#include <vector>

#include "image_core.h"
#include "image_decode.h"

namespace t2i {

void copy_message(const std::string& m, char* err, int errlen) {
  if (!err || errlen <= 0) return;
  const size_t n = std::min(m.size(), static_cast<size_t>(errlen - 1));
  std::memcpy(err, m.data(), n);
  err[n] = '\0';
}

void crop_to_bbox(std::vector<uint8_t>& rgb, int* h, int* w,
                  const int bbox[4]) {
  const int width = *w, height = *h;
  const int r = static_cast<int>(std::max(bbox[2], bbox[3]) * 0.75);
  const int cx = (2 * bbox[0] + bbox[2]) / 2;
  const int cy = (2 * bbox[1] + bbox[3]) / 2;
  const int y1 = std::max(0, cy - r), y2 = std::min(height, cy + r);
  const int x1 = std::max(0, cx - r), x2 = std::min(width, cx + r);
  const int nh = std::max(0, y2 - y1), nw = std::max(0, x2 - x1);
  if (nh <= 0 || nw <= 0) return;  // degenerate box: keep full image
  std::vector<uint8_t> out(static_cast<size_t>(nh) * nw * 3);
  for (int y = 0; y < nh; ++y) {
    std::memcpy(out.data() + static_cast<size_t>(y) * nw * 3,
                rgb.data() + (static_cast<size_t>(y1 + y) * width + x1) * 3,
                static_cast<size_t>(nw) * 3);
  }
  rgb.swap(out);
  *h = nh;
  *w = nw;
}

int load_rgb(const std::string& path, const int* bbox,
             std::vector<uint8_t>& rgb, int* h, int* w, std::string* msg) {
  std::vector<uint8_t> bytes;
  if (!read_file(path, bytes)) {
    *msg = path + ": cannot read the file";
    return T2I_ERR_READ;
  }
  try {
    decode_image(bytes.data(), bytes.size(), rgb, h, w);
  } catch (const DecodeError& e) {
    *msg = path + ": " + e.what();
    return T2I_ERR_DECODE;
  }
  if (bbox && bbox[2] >= 0) crop_to_bbox(rgb, h, w, bbox);
  return T2I_OK;
}

}  // namespace t2i

extern "C" {

// Resize interleaved RGB uint8 (sh x sw) to float32 [0,255] (dh x dw).
void t2i_resize_rgb(const uint8_t* src, int sh, int sw, float* dst, int dh,
                    int dw) {
  t2i::resize_rgb(src, sh, sw, dst, dh, dw);
}

// PIL's BILINEAR resize of RGB uint8 (sh x sw) to RGB uint8 (dh x dw).
void t2i_resize_pil_bilinear(const uint8_t* src, int sh, int sw, uint8_t* dst,
                             int dh, int dw) {
  t2i::resize_pil<t2i::PilBilinear>(src, sh, sw, dst, dh, dw);
}

// PIL's BICUBIC resize (Image.resize's default for RGB), as above.
void t2i_resize_pil_bicubic(const uint8_t* src, int sh, int sw, uint8_t* dst,
                            int dh, int dw) {
  t2i::resize_pil<t2i::PilBicubic>(src, sh, sw, dst, dh, dw);
}

// Full per-sample pipeline (see image_core.h::pyramid_from_rgb).
int t2i_pyramid(const uint8_t* src, int sh, int sw, int scale_size, int crop,
                int crop_x, int crop_y, int flip, const int* branch_sizes,
                int n_branches, float** outs, const float* mean,
                const float* stdv) {
  return t2i::pyramid_from_rgb(src, sh, sw, scale_size, crop, crop_x, crop_y,
                               flip, branch_sizes, n_branches, outs, mean,
                               stdv);
}

// Batched pyramid over `n` samples, parallel across samples on up to
// `n_threads` threads.  srcs/heights/widths/crop_xs/crop_ys/flips are
// per-sample; outs is [n * n_branches] pointers ordered sample-major.
int t2i_pyramid_batch(const uint8_t** srcs, const int* heights,
                      const int* widths, int scale_size, int crop,
                      const int* crop_xs, const int* crop_ys,
                      const int* flips, const int* branch_sizes,
                      int n_branches, float** outs, const float* mean,
                      const float* stdv, int n, int n_threads) {
  std::vector<int> errs(n, 0);
  auto work = [&](int t, int nt) {
    for (int i = t; i < n; i += nt)
      errs[i] = t2i::pyramid_from_rgb(
          srcs[i], heights[i], widths[i], scale_size, crop, crop_xs[i],
          crop_ys[i], flips[i], branch_sizes, n_branches,
          outs + static_cast<size_t>(i) * n_branches, mean, stdv);
  };
  const int nt = std::max(1, std::min(n_threads, n));
  std::vector<std::thread> pool;
  for (int t = 1; t < nt; ++t) pool.emplace_back(work, t, nt);
  work(0, nt);
  for (auto& th : pool) th.join();
  int err = 0;
  for (int e : errs) err |= e;
  return err;
}

// Decode the image file at `path` to RGB.  On success *out is a malloc'd
// h x w x 3 buffer (free it with t2i_free).
int t2i_decode_file(const char* path, uint8_t** out, int* h, int* w,
                    char* err, int errlen) {
  std::vector<uint8_t> rgb;
  std::string msg;
  const int rc = t2i::load_rgb(path, nullptr, rgb, h, w, &msg);
  if (rc) {
    t2i::copy_message(msg, err, errlen);
    return rc;
  }
  *out = static_cast<uint8_t*>(std::malloc(rgb.size()));
  if (!*out) {
    t2i::copy_message("out of memory", err, errlen);
    return t2i::T2I_ERR_DECODE;
  }
  std::memcpy(*out, rgb.data(), rgb.size());
  return t2i::T2I_OK;
}

void t2i_free(void* p) { std::free(p); }

// Height and width from the file's header alone.
int t2i_image_dims(const char* path, int* h, int* w, char* err, int errlen) {
  std::vector<uint8_t> bytes;
  if (!t2i::read_file(path, bytes)) {
    t2i::copy_message(std::string(path) + ": cannot read the file", err,
                      errlen);
    return t2i::T2I_ERR_READ;
  }
  try {
    t2i::image_dims(bytes.data(), bytes.size(), h, w);
  } catch (const t2i::DecodeError& e) {
    t2i::copy_message(std::string(path) + ": " + e.what(), err, errlen);
    return t2i::T2I_ERR_DECODE;
  }
  return t2i::T2I_OK;
}

// One sample at an integer crop: read + decode + bbox crop (bbox [x, y, w,
// h], w < 0 for none) + the pyramid with its crop at (crop_x, crop_y).
int t2i_load_sample(const char* path, const int* bbox, int scale_size,
                    int crop, int crop_x, int crop_y, int flip,
                    const int* branch_sizes, int n_branches, float** outs,
                    const float* mean, const float* stdv, char* err,
                    int errlen) {
  std::vector<uint8_t> rgb;
  int h = 0, w = 0;
  std::string msg;
  int rc = t2i::load_rgb(path, bbox, rgb, &h, &w, &msg);
  if (rc == t2i::T2I_OK &&
      t2i::pyramid_from_rgb(rgb.data(), h, w, scale_size, crop, crop_x,
                            crop_y, flip, branch_sizes, n_branches, outs,
                            mean, stdv)) {
    rc = t2i::T2I_ERR_CROP;
    msg = std::string(path) + ": crop window outside the scaled image";
  }
  if (rc) t2i::copy_message(msg, err, errlen);
  return rc;
}

}  // extern "C"
