// Declarations the sources of the host image library share: the zlib inflate
// that the PNG decoder takes its image data through, the EXIF orientation
// that the JPEG, PNG and WebP decoders apply as OpenCV's reader does, and the
// C entries that the whole-batch decode (batch_decode.cpp) calls. The library
// is built from all of them by vit_ssl_tpu_torch/kernels.py
// (HOST_SOURCES[HOST_IMAGE]), each source compiled once; the C entry names
// are unique across them.

#pragma once

#include <cstddef>
#include <cstdint>
#include <string>
#include <vector>

namespace vitssl {

// The zlib stream (RFC 1950) data[0, size) inflated (RFC 1951) into out,
// which is cleared first; size_hint reserves room. Returns true, or false
// with a message in zlib's words ("Error -3 while decompressing data: ...").
// Bytes after the stream's Adler-32 are ignored, as zlib.decompress does.
bool zlib_inflate(const uint8_t* data, size_t size, size_t size_hint,
                  std::vector<uint8_t>& out, std::string& error);

// IFD0's orientation tag (0x0112) of the TIFF stream t[0, n): 1 when the
// stream, its IFD or the tag is absent or out of range (data/exif.py).
inline int exif_orientation(const uint8_t* t, size_t n) {
  if (n < 8) return 1;
  bool le;
  if (t[0] == 'I' && t[1] == 'I') le = true;
  else if (t[0] == 'M' && t[1] == 'M') le = false;
  else return 1;
  auto u16 = [&](size_t at) -> uint32_t {
    return le ? (t[at] | t[at + 1] << 8) : (t[at] << 8 | t[at + 1]);
  };
  auto u32 = [&](size_t at) -> uint32_t {
    return le ? (u16(at) | u16(at + 2) << 16) : (u16(at) << 16 | u16(at + 2));
  };
  if (u16(2) != 42) return 1;
  const uint64_t ifd = u32(4);
  if (ifd + 2 > n) return 1;
  const uint32_t entries = u16(ifd);
  for (uint32_t i = 0; i < entries; ++i) {
    const uint64_t at = ifd + 2 + 12ull * i;
    if (at + 12 > n) return 1;
    if (u16(at) == 0x0112) {
      const uint32_t kind = u16(at + 2);
      const uint32_t value = kind == 3 ? u16(at + 8) : kind == 4 ? u32(at + 8) : 0;
      return value >= 1 && value <= 8 ? static_cast<int>(value) : 1;
    }
  }
  return 1;
}

// The RGB rows (h, w, 3) turned upright for orientation 1 to 8, as OpenCV's
// ApplyExifOrientation turns them; h and w become the turned image's.
inline void apply_orientation(std::vector<uint8_t>& rgb, int& h, int& w, int orientation) {
  if (orientation < 2 || orientation > 8) return;
  const bool swap = orientation >= 5;
  const int oh = swap ? w : h, ow = swap ? h : w;
  std::vector<uint8_t> out(rgb.size());
  for (int i = 0; i < oh; ++i) {
    for (int j = 0; j < ow; ++j) {
      int y, x;  // the source pixel of out(i, j)
      switch (orientation) {
        case 2: y = i; x = w - 1 - j; break;
        case 3: y = h - 1 - i; x = w - 1 - j; break;
        case 4: y = h - 1 - i; x = j; break;
        case 5: y = j; x = i; break;
        case 6: y = h - 1 - j; x = i; break;
        case 7: y = h - 1 - j; x = w - 1 - i; break;
        default: y = j; x = w - 1 - i; break;  // 8
      }
      const uint8_t* s = &rgb[(static_cast<size_t>(y) * w + x) * 3];
      uint8_t* d = &out[(static_cast<size_t>(i) * ow + j) * 3];
      d[0] = s[0];
      d[1] = s[1];
      d[2] = s[2];
    }
  }
  rgb.swap(out);
  h = oh;
  w = ow;
}

}  // namespace vitssl

extern "C" {
int png_decode(const uint8_t* data, size_t size, int reference, uint8_t** out, int* height,
               int* width, char* msg, int msg_size);
void png_free(uint8_t* p);
int image_resize(const uint8_t* src, int sh, int sw, int cn, int64_t src_row_stride,
                 uint8_t* dst, int dh, int dw, int interpolation);
int jpeg_decode(const uint8_t* data, size_t size, int flags, uint8_t** out, int* height,
                int* width, char* msg, int msg_size);
void jpeg_free(uint8_t* p);
int webp_decode(const uint8_t* data, size_t size, int exif_orientation, uint8_t** out,
                int* height, int* width, char* msg, int msg_size);
void webp_free(uint8_t* p);
}
