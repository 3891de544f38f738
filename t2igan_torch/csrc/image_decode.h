// The port's image decoder: JPEG and PNG files to interleaved 8-bit RGB,
// pixel for pixel what PIL gives for Image.open(path).convert("RGB").
//
// The machine with the card has neither PIL nor libjpeg nor libpng, so the
// port carries its own decoder.  The JAX package decodes through PIL, or
// through libjpeg/libpng (t2igan/native/image_exec.cc:56-112); PIL's wheels
// carry libjpeg-turbo, whose decompression arithmetic this file
// re-implements: the baseline and progressive Huffman decoders, the ISLOW
// integer IDCT (jidctint.c), the "fancy" triangle upsampling of jdsample.c
// and the fixed-point YCbCr->RGB tables of jdcolor.c.  PNG inflates through
// zlib.
//
// What it does not decode it refuses with an error that names the feature:
// arithmetic-coded, lossless, hierarchical and 12-bit JPEG, YCCK, progressive
// files whose refinement is incomplete (libjpeg would smooth the blocks),
// interlaced and 16-bit PNG, BMP, WebP and anything else.  There is no
// fallback to another decoder.

#ifndef T2IGAN_TORCH_IMAGE_DECODE_H_
#define T2IGAN_TORCH_IMAGE_DECODE_H_

#include <cstddef>
#include <cstdint>
#include <stdexcept>
#include <string>
#include <vector>

namespace t2i {

// A file the decoder refuses: corrupt, truncated or of a feature it does
// not decode.  what() names the feature.
struct DecodeError : std::runtime_error {
  explicit DecodeError(const std::string& m) : std::runtime_error(m) {}
};

// Decode a JPEG or PNG held in memory to h x w x 3 uint8 RGB.  Throws
// DecodeError.
void decode_image(const uint8_t* data, size_t len, std::vector<uint8_t>& rgb,
                  int* h, int* w);

// The image's height and width from its header alone (no pixel is
// decoded).  Throws DecodeError.
void image_dims(const uint8_t* data, size_t len, int* h, int* w);

// The whole file at `path`; false when it cannot be read.
bool read_file(const std::string& path, std::vector<uint8_t>& out);

// Per-sample error codes of the host library's calls and of the executor
// (the JAX package's, t2igan/native/__init__.py: EXEC_ERR_*).
enum SampleErr {
  T2I_OK = 0,
  T2I_ERR_READ = 1,    // file missing or unreadable
  T2I_ERR_DECODE = 2,  // corrupt, truncated or unsupported image
  T2I_ERR_CROP = 4,    // crop window outside the scaled image
};

// 75%-padded square crop around the CUB bbox's centre, bbox = [x, y, w, h]
// (datasets.py:91-98), in place (image_ops.cc).
void crop_to_bbox(std::vector<uint8_t>& rgb, int* h, int* w,
                  const int bbox[4]);

// Read and decode `path`, then crop to `bbox` unless it is null or its
// width is negative.  Returns a SampleErr; on error `msg` names the file
// and the fault (image_ops.cc).
int load_rgb(const std::string& path, const int* bbox,
             std::vector<uint8_t>& rgb, int* h, int* w, std::string* msg);

// `m` into err[0 .. errlen), cut and NUL-terminated (image_ops.cc).
void copy_message(const std::string& m, char* err, int errlen);

}  // namespace t2i

#endif  // T2IGAN_TORCH_IMAGE_DECODE_H_
