// Whole-batch image decode and resize for the data loader: the port's
// counterpart of the JAX package's csrc/fastloader.cpp, with its C signature
// and contract, on the port's own decoders instead of OpenCV.
//
// vitssl_decode_batch reads each file of a batch, decodes it by its magic
// bytes (PNG: png_decode.cpp; JPEG: jpeg_decode.cpp; WebP: webp_decode.cpp)
// as the JAX package's dataset reader
// (cv2.imread(path, IMREAD_COLOR) then BGR -> RGB) gives it, the EXIF
// orientation applied, resizes it to (out_h, out_w) with INTER_AREA where
// either axis shrinks and INTER_LINEAR otherwise (image_ops.cpp), and writes
// it into out[i]. A file this path does not decode (BMP, TIFF, another
// format, a refused or damaged file) gets ok[i] = 0 and a zero-filled slot;
// the caller's per-sample path then decodes it or names it. The files are
// spread over a std::thread pool of num_threads, and the call holds no
// Python state, so ctypes releases the GIL for the whole batch.
//
// Built into one library with the decoders' and the image ops' sources
// (kernels.py HOST_SOURCES[HOST_IMAGE]), whose C entries it calls.

#include <algorithm>
#include <atomic>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <thread>
#include <vector>

#include "host_image.h"

namespace {

constexpr int kMessage = 512;

bool read_file(const char* path, std::vector<uint8_t>& data) {
  std::FILE* f = std::fopen(path, "rb");
  if (f == nullptr) return false;
  data.clear();
  uint8_t buf[1 << 16];
  size_t got;
  while ((got = std::fread(buf, 1, sizeof buf, f)) > 0) data.insert(data.end(), buf, buf + got);
  const bool ok = !std::ferror(f);
  std::fclose(f);
  return ok;
}

// The file's RGB image as the JAX package's dataset reader gives it, or
// false where this path does not decode it
bool decode_file(const char* path, std::vector<uint8_t>& rgb, int& h, int& w) {
  std::vector<uint8_t> d;
  if (!read_file(path, d)) return false;
  static const uint8_t kPng[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  uint8_t* out = nullptr;
  char msg[kMessage];
  int status;
  if (d.size() >= 8 && std::memcmp(d.data(), kPng, 8) == 0) {
    status = png_decode(d.data(), d.size(), 0, &out, &h, &w, msg, kMessage);
    if (status == 0) {
      rgb.assign(out, out + static_cast<size_t>(h) * w * 3);
      png_free(out);
    }
    return status == 0;
  }
  if (d.size() >= 3 && d[0] == 0xff && d[1] == 0xd8 && d[2] == 0xff) {
    // flags 1: the EXIF orientation applied, OpenCV's CMYK
    status = jpeg_decode(d.data(), d.size(), 1, &out, &h, &w, msg, kMessage);
    if (status == 0) {
      rgb.assign(out, out + static_cast<size_t>(h) * w * 3);
      jpeg_free(out);
    }
    return status == 0;
  }
  if (d.size() >= 12 && std::memcmp(d.data(), "RIFF", 4) == 0 &&
      std::memcmp(d.data() + 8, "WEBP", 4) == 0) {
    // the RIFF container read by the entry, the EXIF orientation applied
    status = webp_decode(d.data(), d.size(), 1, &out, &h, &w, msg, kMessage);
    if (status == 0) {
      rgb.assign(out, out + static_cast<size_t>(h) * w * 3);
      webp_free(out);
    }
    return status == 0;
  }
  return false;
}

}  // namespace

extern "C" {

// Decode paths[i], resize it to (out_h, out_w) and write it into
// out[i * out_h * out_w * 3], for i in [0, n), across num_threads threads.
// Returns the number of images decoded; a slot that failed is zero-filled
// and reported by ok[i] = 0.
int vitssl_decode_batch(const char** paths, int n, int out_h, int out_w, unsigned char* out,
                        unsigned char* ok, int num_threads) {
  const size_t stride = static_cast<size_t>(out_h) * out_w * 3;
  std::atomic<int> next{0};
  std::atomic<int> succeeded{0};

  auto worker = [&]() {
    std::vector<uint8_t> rgb;
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      unsigned char* dst = out + static_cast<size_t>(i) * stride;
      int h = 0, w = 0;
      bool done = false;
      try {
        if (decode_file(paths[i], rgb, h, w)) {
          // INTER_AREA where either axis shrinks, else INTER_LINEAR
          const int interpolation = out_h < h || out_w < w ? 0 : 1;
          done = image_resize(rgb.data(), h, w, 3, static_cast<int64_t>(w) * 3, dst, out_h,
                              out_w, interpolation) == 0;
        }
      } catch (const std::exception&) {  // out of memory: nothing may cross the C interface
        done = false;
      }
      if (!done) std::memset(dst, 0, stride);
      ok[i] = done ? 1 : 0;
      if (done) succeeded.fetch_add(1);
    }
  };

  const int threads = std::min(num_threads > 0 ? num_threads : 1, n);
  if (threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return succeeded.load();
}

}  // extern "C"
