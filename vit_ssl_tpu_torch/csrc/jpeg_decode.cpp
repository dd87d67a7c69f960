// A JPEG decoder for the host: baseline, extended sequential and progressive
// Huffman JPEG at 8-bit precision, from memory to RGB uint8 (H, W, 3).
//
// Written from ITU-T T.81 (the JPEG standard) and the integer algorithms of
// libjpeg-turbo that OpenCV and PIL decode with, so that the output is
// bit-equal to theirs:
//   - the "islow" inverse DCT (jidctint.c's jpeg_idct_islow: 13-bit
//     constants, 2 pass-1 bits, the post-IDCT range limit of 1024 entries);
//   - fancy upsampling (jdsample.c: h2v1, h2v2 and h1v2 triangle filters with
//     their rounding biases; the box filter where libjpeg uses it, a 2x
//     horizontal ratio over a component at most 2 samples wide);
//   - the fixed-point YCbCr -> RGB tables (jdcolor.c, 16 scale bits) and
//     the YCCK -> CMYK conversion;
//   - the colour-space rules of jdapimin.c (JFIF, Adobe APP14 transform,
//     component ids).
// CMYK goes to RGB by OpenCV's formula or PIL's (flags), and the EXIF
// orientation (APP1, tag 0x0112; read and applied by host_image.h, as the
// PNG decoder and the whole-batch decode do) is applied only when asked for.
//
// It uses the C++ standard library only and keeps no global state, so any
// number of threads may decode at once. The plain C interface is bound with
// ctypes (vit_ssl_tpu_torch/data/jpeg.py), which releases the GIL.
//
// Refused by name (status 1): arithmetic coding, lossless and hierarchical
// frames, 12-bit precision, sampling factors outside 1-2, two components, and
// progressive files that leave low-frequency coefficients unrefined (where
// libjpeg would smooth blocks). Damaged data (status 2) raises where libjpeg
// would warn and recover: a truncated file, a missing EOI, a bad Huffman code,
// a missing or misplaced restart marker; the message names the byte offset.

#include <algorithm>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <string>
#include <vector>

#include "host_image.h"

namespace {

enum Status { kOk = 0, kUnsupported = 1, kInvalid = 2 };

struct Failure {
  Status status;
  std::string message;
};

[[noreturn]] void fail(Status status, const char* format, ...) {
  char buf[512];
  va_list args;
  va_start(args, format);
  vsnprintf(buf, sizeof(buf), format, args);
  va_end(args);
  throw Failure{status, buf};
}

// zigzag position -> natural (row-major) position, with 16 extra entries that
// catch a run past the block's end as libjpeg's table does
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// the standard Huffman tables of Annex K.3, which libjpeg supplies for a scan
// whose table was never defined (Motion-JPEG frames carry none)
const uint8_t kStdDcBits[2][17] = {
    {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
const uint8_t kStdDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdAcBits[2][17] = {
    {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
    {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
const uint8_t kStdAcVals[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
     0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
     0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
     0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
     0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
     0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
     0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
     0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
     0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
     0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
     0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
     0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
     0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
     0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
     0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
     0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
     0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
     0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
     0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
     0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
     0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
     0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
     0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

constexpr int kFastBits = 9;

// A Huffman table as DHT defines it, and its decoding form (T.81 F.2.2.3,
// with a lookup of the codes of up to kFastBits bits).
struct Huffman {
  bool defined = false;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint16_t fast[1 << kFastBits];  // (length << 8) | symbol; 0: longer code

  void build(const uint8_t bits[17], const uint8_t* symbols, bool dc, const char* what) {
    int count = 0;
    uint8_t sizes[257];
    for (int len = 1; len <= 16; ++len)
      for (int i = 0; i < bits[len]; ++i) {
        if (count >= 256) fail(kInvalid, "%s: more than 256 Huffman codes", what);
        sizes[count++] = static_cast<uint8_t>(len);
      }
    sizes[count] = 0;
    uint32_t codes[256];
    uint32_t code = 0;
    int size = sizes[0], p = 0;
    while (sizes[p]) {
      while (sizes[p] == size) codes[p++] = code++;
      if (code >= (1u << size)) fail(kInvalid, "%s: Huffman code lengths overflow", what);
      code <<= 1;
      ++size;
    }
    p = 0;
    for (int len = 1; len <= 16; ++len) {
      if (bits[len]) {
        valoffset[len] = p - static_cast<int32_t>(codes[p]);
        p += bits[len];
        maxcode[len] = static_cast<int32_t>(codes[p - 1]);
      } else {
        maxcode[len] = -1;
      }
    }
    maxcode[17] = 0x7fffffff;
    std::memcpy(vals, symbols, count);
    for (int i = 0; i < count; ++i)
      if (dc && symbols[i] > 15) fail(kInvalid, "%s: DC symbol %d above 15", what, symbols[i]);
    std::memset(fast, 0, sizeof(fast));
    for (int i = 0; i < count; ++i) {
      int len = sizes[i];
      if (len > kFastBits) break;
      int shift = kFastBits - len;
      uint32_t lo = codes[i] << shift;
      for (uint32_t j = 0; j < (1u << shift); ++j)
        fast[lo + j] = static_cast<uint16_t>((len << 8) | symbols[i]);
    }
    defined = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_table = 0, ac_table = 0;
  int blocks_w = 0, blocks_h = 0;    // the block grid, padded to whole MCUs
  int real_blocks_w = 0, real_blocks_h = 0;  // blocks a non-interleaved scan covers
  int sampled_w = 0, sampled_h = 0;  // libjpeg's downsampled_width/height
  bool quant_latched = false;
  uint16_t quant[64];  // natural order, latched at the component's first scan
  std::vector<int16_t> coefs;  // blocks_w * blocks_h blocks of 64
  std::vector<uint32_t> offsets;  // the byte offset of each block's last decode
  int coef_bits[10];  // progressive: the Al last coded, -1 never
  int dc_pred = 0;
  std::vector<uint8_t> plane;  // blocks_w * 8 wide after the IDCT
};

// Entropy-coded bits: byte stuffing undone, stopping at a marker or at the
// end of the data; bits past that stop read as 0 but may not be consumed.
struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;       // next byte to read
  uint64_t acc = 0;     // MSB-aligned
  int nbits = 0;        // bits in acc
  int pad = 0;          // of those, zero bits past the stop
  bool stopped = false;
  size_t stop_pos = 0;  // the byte at which the data stopped (a 0xFF or the end)

  void start(size_t at) {
    pos = at;
    acc = 0;
    nbits = pad = 0;
    stopped = false;
  }

  void refill() {
    while (nbits <= 56) {
      uint64_t byte = 0;
      if (!stopped) {
        if (pos >= size) {
          stopped = true;
          stop_pos = pos;
        } else if (data[pos] == 0xFF) {
          if (pos + 1 < size && data[pos + 1] == 0x00) {
            byte = 0xFF;
            pos += 2;
          } else {
            stopped = true;
            stop_pos = pos;
          }
        } else {
          byte = data[pos++];
        }
      }
      if (stopped) pad += 8;
      acc |= byte << (56 - nbits);
      nbits += 8;
    }
  }

  // the byte offset of the next unread bit (approximate across stuffing)
  size_t offset() const {
    size_t read = stopped ? stop_pos : pos;
    size_t left = static_cast<size_t>((nbits - pad) / 8);
    return read > left ? read - left : 0;
  }

  void consume(int n) {
    if (n > nbits - pad)
      fail(kInvalid, "entropy-coded data ends early (at %s, byte offset %zu)",
           stop_pos >= size ? "the end of the file" : "a marker", stop_pos);
    acc <<= n;
    nbits -= n;
  }

  int bits(int n) {
    if (n == 0) return 0;
    if (nbits < n) refill();
    int v = static_cast<int>(acc >> (64 - n));
    consume(n);
    return v;
  }

  int bit() { return bits(1); }

  int decode(const Huffman& t) {
    if (nbits < 16) refill();
    uint32_t peek = static_cast<uint32_t>(acc >> 48);
    uint16_t e = t.fast[peek >> (16 - kFastBits)];
    if (e) {
      consume(e >> 8);
      return e & 0xFF;
    }
    int len = kFastBits + 1;
    int32_t code = static_cast<int32_t>(peek >> (16 - len));
    while (len <= 16 && code > t.maxcode[len]) {
      ++len;
      code = static_cast<int32_t>(peek >> (16 - len));
    }
    if (len > 16)
      fail(kInvalid, "bad Huffman code near byte offset %zu", offset());
    consume(len);
    return t.vals[(code + t.valoffset[len]) & 0xFF];
  }
};

inline int extend(int r, int s) {
  return r < (1 << (s - 1)) ? r + static_cast<int>((~0u << s) + 1u) : r;
}

inline uint16_t be16(const uint8_t* p) { return static_cast<uint16_t>((p[0] << 8) | p[1]); }

const char* frame_name(int marker) {
  switch (marker) {
    case 0xC3: return "SOF3 (lossless)";
    case 0xC5: return "SOF5 (hierarchical: differential sequential)";
    case 0xC6: return "SOF6 (hierarchical: differential progressive)";
    case 0xC7: return "SOF7 (hierarchical: differential lossless)";
    case 0xC9: return "SOF9 (arithmetic coding: extended sequential)";
    case 0xCA: return "SOF10 (arithmetic coding: progressive)";
    case 0xCB: return "SOF11 (arithmetic coding: lossless)";
    case 0xCD: return "SOF13 (arithmetic coding, hierarchical: differential sequential)";
    case 0xCE: return "SOF14 (arithmetic coding, hierarchical: differential progressive)";
    case 0xCF: return "SOF15 (arithmetic coding, hierarchical: differential lossless)";
    default: return "an unknown frame";
  }
}

// ---------------------------------------------------------------------------
// The islow inverse DCT (jidctint.c)

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t F0_298631336 = 2446, F0_390180644 = 3196, F0_541196100 = 4433,
                  F0_765366865 = 6270, F0_899976223 = 7373, F1_175875602 = 9633,
                  F1_501321110 = 12299, F1_847759065 = 15137, F1_961570560 = 16069,
                  F2_053119869 = 16819, F2_562915447 = 20995, F3_072711026 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }
inline int32_t lshift(int32_t x, int n) {
  return static_cast<int32_t>(static_cast<uint32_t>(x) << n);
}

// nonzero where v lies outside [-2^bits, 2^bits - 1]
inline uint32_t fold(int32_t v, int bits = 14) {
  return static_cast<uint32_t>(v < 0 ? ~v : v) >> bits;
}

// x is the IDCT output before its +128 level shift; libjpeg indexes a
// 1024-entry table with x & 1023: clamped over [-512, 511], wrapped beyond
inline uint8_t idct_limit(int32_t x) {
  int32_t t = x & 1023;
  if (t >= 512) t -= 1024;
  t += 128;
  return static_cast<uint8_t>(t < 0 ? 0 : (t > 255 ? 255 : t));
}

// Returns false where the block leaves the range that 8-bit samples give: a
// dequantized coefficient or a pass-1 output outside [-16384, 16383], or an
// output outside [-512, 511]. Only corrupt data gets there, and there libjpeg-turbo's
// C and SIMD forms disagree (the SIMD form's 16-bit lanes saturate, the
// C form's range table wraps), so the caller refuses it.
bool idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int32_t ws[64];
  uint32_t wide = 0;  // nonzero once a value leaves its range
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int32_t* wp = ws + c;
    for (int r = 0; r < 8; ++r) wide |= fold(ip[8 * r] * static_cast<int32_t>(qp[8 * r]));
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int32_t dc = lshift(ip[0] * static_cast<int32_t>(qp[0]), kPass1Bits);
      wide |= fold(dc);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int32_t z2 = ip[16] * static_cast<int32_t>(qp[16]);
    int32_t z3 = ip[48] * static_cast<int32_t>(qp[48]);
    int32_t z1 = (z2 + z3) * F0_541196100;
    int32_t tmp2 = z1 + z3 * (-F1_847759065);
    int32_t tmp3 = z1 + z2 * F0_765366865;
    z2 = ip[0] * static_cast<int32_t>(qp[0]);
    z3 = ip[32] * static_cast<int32_t>(qp[32]);
    int32_t tmp0 = lshift(z2 + z3, kConstBits);
    int32_t tmp1 = lshift(z2 - z3, kConstBits);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * static_cast<int32_t>(qp[56]);
    tmp1 = ip[40] * static_cast<int32_t>(qp[40]);
    tmp2 = ip[24] * static_cast<int32_t>(qp[24]);
    tmp3 = ip[8] * static_cast<int32_t>(qp[8]);
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * F1_175875602;
    tmp0 *= F0_298631336;
    tmp1 *= F2_053119869;
    tmp2 *= F3_072711026;
    tmp3 *= F1_501321110;
    z1 *= -F0_899976223;
    z2 *= -F2_562915447;
    z3 *= -F1_961570560;
    z4 *= -F0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int n = kConstBits - kPass1Bits;
    wp[0] = descale(tmp10 + tmp3, n);
    wp[56] = descale(tmp10 - tmp3, n);
    wp[8] = descale(tmp11 + tmp2, n);
    wp[48] = descale(tmp11 - tmp2, n);
    wp[16] = descale(tmp12 + tmp1, n);
    wp[40] = descale(tmp12 - tmp1, n);
    wp[24] = descale(tmp13 + tmp0, n);
    wp[32] = descale(tmp13 - tmp0, n);
    for (int r = 0; r < 8; ++r) wide |= fold(wp[8 * r]);
  }
  for (int r = 0; r < 8; ++r) {
    const int32_t* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      int32_t dc = descale(wp[0], kPass1Bits + 3);
      wide |= fold(dc, 9);  // outputs stay within [-512, 511]
      std::memset(op, idct_limit(dc), 8);
      continue;
    }
    int32_t z2 = wp[2], z3 = wp[6];
    int32_t z1 = (z2 + z3) * F0_541196100;
    int32_t tmp2 = z1 + z3 * (-F1_847759065);
    int32_t tmp3 = z1 + z2 * F0_765366865;
    int32_t tmp0 = lshift(wp[0] + wp[4], kConstBits);
    int32_t tmp1 = lshift(wp[0] - wp[4], kConstBits);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * F1_175875602;
    tmp0 *= F0_298631336;
    tmp1 *= F2_053119869;
    tmp2 *= F3_072711026;
    tmp3 *= F1_501321110;
    z1 *= -F0_899976223;
    z2 *= -F2_562915447;
    z3 *= -F1_961570560;
    z4 *= -F0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int n = kConstBits + kPass1Bits + 3;
    const int32_t o[8] = {descale(tmp10 + tmp3, n), descale(tmp11 + tmp2, n),
                          descale(tmp12 + tmp1, n), descale(tmp13 + tmp0, n),
                          descale(tmp13 - tmp0, n), descale(tmp12 - tmp1, n),
                          descale(tmp11 - tmp2, n), descale(tmp10 - tmp3, n)};
    for (int x = 0; x < 8; ++x) {
      wide |= fold(o[x], 9);
      op[x] = idct_limit(o[x]);
    }
  }
  return wide == 0;
}

// ---------------------------------------------------------------------------
// The decoder

enum Space { kGray, kYCbCr, kRGB, kCMYK, kYCCK };

struct Decoder {
  const uint8_t* data;
  size_t size;
  bool exif_orientation;
  bool pil_cmyk;

  bool frame_seen = false, progressive = false;
  int width = 0, height = 0, max_h = 1, max_v = 1, mcus_x = 0, mcus_y = 0;
  std::vector<Component> comps;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc_tables[4], ac_tables[4];
  int restart_interval = 0;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;
  int orientation = 1;
  int scans = 0;

  size_t segment(size_t pos, const char* name, size_t* len) {
    if (pos + 2 > size) fail(kInvalid, "%s segment is truncated (byte offset %zu)", name, pos);
    size_t n = be16(data + pos);
    if (n < 2 || pos + n > size)
      fail(kInvalid, "%s segment at byte offset %zu runs past the end of the file", name, pos);
    *len = n - 2;
    return pos + 2;
  }

  void read_dqt(size_t p, size_t len) {
    size_t end = p + len;
    while (p < end) {
      int pq = data[p] >> 4, tq = data[p] & 15;
      ++p;
      if (tq > 3 || pq > 1) fail(kInvalid, "DQT: bad table %d or precision %d", tq, pq);
      size_t need = pq ? 128 : 64;
      if (p + need > end) fail(kInvalid, "DQT segment is truncated");
      for (int k = 0; k < 64; ++k)
        qt[tq][kNatural[k]] = pq ? be16(data + p + 2 * k) : data[p + k];
      qt_defined[tq] = true;
      p += need;
    }
  }

  void read_dht(size_t p, size_t len) {
    size_t end = p + len;
    while (p < end) {
      if (p + 17 > end) fail(kInvalid, "DHT segment is truncated");
      int tc = data[p] >> 4, th = data[p] & 15;
      if (tc > 1 || th > 3) fail(kInvalid, "DHT: bad table class %d or id %d", tc, th);
      uint8_t bits[17] = {0};
      int count = 0;
      for (int i = 1; i <= 16; ++i) {
        bits[i] = data[p + i];
        count += bits[i];
      }
      p += 17;
      if (count > 256 || p + count > end) fail(kInvalid, "DHT: bad symbol count %d", count);
      (tc ? ac_tables : dc_tables)[th].build(bits, data + p, tc == 0, "DHT");
      p += count;
    }
  }

  void read_sof(int marker, size_t p, size_t len) {
    if (frame_seen) fail(kInvalid, "a second SOF marker");
    if (len < 6) fail(kInvalid, "SOF segment is truncated");
    int precision = data[p];
    height = be16(data + p + 1);
    width = be16(data + p + 3);
    int n = data[p + 5];
    const char* name = marker == 0xC0 ? "SOF0" : marker == 0xC1 ? "SOF1" : "SOF2";
    if (precision != 8)
      fail(kUnsupported, "%d-bit precision (%s header); this decoder takes 8-bit samples",
           precision, name);
    if (height == 0)
      fail(kUnsupported, "a height given by a DNL marker (%s height 0)", name);
    if (width == 0) fail(kInvalid, "%s: empty image", name);
    if (n == 2 || n > 4)
      fail(kUnsupported, "%d components (%s); this decoder takes 1, 3 or 4", n, name);
    if (n == 0 || len < 6 + 3 * static_cast<size_t>(n)) fail(kInvalid, "SOF segment is truncated");
    comps.resize(n);
    for (int i = 0; i < n; ++i) {
      const uint8_t* c = data + p + 6 + 3 * i;
      comps[i].id = c[0];
      comps[i].h = c[1] >> 4;
      comps[i].v = c[1] & 15;
      comps[i].tq = c[2];
      if (comps[i].h < 1 || comps[i].h > 4 || comps[i].v < 1 || comps[i].v > 4 ||
          comps[i].tq > 3)
        fail(kInvalid, "%s: component %d has sampling %dx%d, table %d", name, i,
             comps[i].h, comps[i].v, comps[i].tq);
      if (comps[i].h > 2 || comps[i].v > 2)
        fail(kUnsupported, "sampling factors %dx%d (component %d, %s); this decoder takes "
             "1 and 2", comps[i].h, comps[i].v, i, name);
      max_h = std::max(max_h, comps[i].h);
      max_v = std::max(max_v, comps[i].v);
    }
    progressive = marker == 0xC2;
    mcus_x = (width + 8 * max_h - 1) / (8 * max_h);
    mcus_y = (height + 8 * max_v - 1) / (8 * max_v);
    for (auto& c : comps) {
      c.blocks_w = mcus_x * c.h;
      c.blocks_h = mcus_y * c.v;
      c.sampled_w = (width * c.h + max_h - 1) / max_h;
      c.sampled_h = (height * c.v + max_v - 1) / max_v;
      c.real_blocks_w = (c.sampled_w + 7) / 8;
      c.real_blocks_h = (c.sampled_h + 7) / 8;
      c.coefs.assign(static_cast<size_t>(c.blocks_w) * c.blocks_h * 64, 0);
      c.offsets.assign(static_cast<size_t>(c.blocks_w) * c.blocks_h, 0);
      for (int& b : c.coef_bits) b = -1;
    }
    frame_seen = true;
  }

  void read_app(int marker, size_t p, size_t len) {
    if (marker == 0xE0 && len >= 5 && std::memcmp(data + p, "JFIF\0", 5) == 0) saw_jfif = true;
    if (marker == 0xEE && len >= 12 && std::memcmp(data + p, "Adobe", 5) == 0) {
      saw_adobe = true;
      adobe_transform = data[p + 11];
    }
    if (marker == 0xE1 && len >= 14 && std::memcmp(data + p, "Exif\0\0", 6) == 0 &&
        orientation == 1)
      orientation = vitssl::exif_orientation(data + p + 6, len - 6);
  }

  // the scan's header; returns the components in it
  std::vector<int> read_sos(size_t p, size_t len, int* ss, int* se, int* ah, int* al) {
    if (!frame_seen) fail(kInvalid, "SOS before any SOF marker");
    if (len < 1) fail(kInvalid, "SOS segment is truncated");
    int n = data[p];
    if (n < 1 || n > 4 || len != 4 + 2 * static_cast<size_t>(n))
      fail(kInvalid, "SOS segment has a bad length for %d components", n);
    std::vector<int> in_scan;
    int blocks = 0;
    for (int i = 0; i < n; ++i) {
      int id = data[p + 1 + 2 * i], tables = data[p + 2 + 2 * i];
      int ci = -1;
      for (size_t k = 0; k < comps.size(); ++k)
        if (comps[k].id == id) ci = static_cast<int>(k);
      if (ci < 0 || std::find(in_scan.begin(), in_scan.end(), ci) != in_scan.end())
        fail(kInvalid, "SOS names component id %d, not in the frame or twice", id);
      comps[ci].dc_table = tables >> 4;
      comps[ci].ac_table = tables & 15;
      if (comps[ci].dc_table > 3 || comps[ci].ac_table > 3)
        fail(kInvalid, "SOS names Huffman table %d/%d", comps[ci].dc_table, comps[ci].ac_table);
      in_scan.push_back(ci);
      blocks += comps[ci].h * comps[ci].v;
    }
    if (n > 1 && blocks > 10) fail(kInvalid, "an MCU of %d blocks (at most 10)", blocks);
    size_t q = p + 1 + 2 * n;
    *ss = data[q];
    *se = data[q + 1];
    *ah = data[q + 2] >> 4;
    *al = data[q + 2] & 15;
    return in_scan;
  }

  void latch_quant(Component& c) {
    if (c.quant_latched) return;
    if (!qt_defined[c.tq]) fail(kInvalid, "quantization table %d was never defined", c.tq);
    std::memcpy(c.quant, qt[c.tq], sizeof(c.quant));
    c.quant_latched = true;
  }

  Huffman& table(Huffman* tables, int id, bool dc) {
    Huffman& t = tables[id];
    if (!t.defined) {
      if (id > 1) fail(kInvalid, "Huffman table %d was never defined", id);
      if (dc) t.build(kStdDcBits[id], kStdDcVals, true, "standard DC table");
      else t.build(kStdAcBits[id], kStdAcVals[id], false, "standard AC table");
    }
    return t;
  }

  // decode one scan starting at byte `start`; returns where its data ends
  size_t decode_scan(size_t start, const std::vector<int>& in_scan, int ss, int se, int ah,
                     int al) {
    ++scans;
    for (int ci : in_scan) latch_quant(comps[ci]);
    bool dc_scan = true, ac_scan = true;
    if (progressive) {
      bool bad = false;
      if (ss == 0) {
        if (se != 0) bad = true;
      } else {
        if (ss > se || se > 63 || in_scan.size() != 1) bad = true;
      }
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad)
        fail(kInvalid, "progressive scan %d has Ss=%d Se=%d Ah=%d Al=%d", scans, ss, se, ah, al);
      dc_scan = ss == 0;
      ac_scan = !dc_scan;
      for (int ci : in_scan)
        for (int k = ss; k <= std::min(se, 9); ++k) comps[ci].coef_bits[k] = al;
    }
    Huffman* dc[4] = {nullptr, nullptr, nullptr, nullptr};
    Huffman* ac[4] = {nullptr, nullptr, nullptr, nullptr};
    for (size_t i = 0; i < in_scan.size(); ++i) {
      const Component& c = comps[in_scan[i]];
      if (dc_scan && !(progressive && ah != 0)) dc[i] = &table(dc_tables, c.dc_table, true);
      if (ac_scan) ac[i] = &table(ac_tables, c.ac_table, false);
    }
    BitReader br{data, size};
    br.start(start);
    for (int ci : in_scan) comps[ci].dc_pred = 0;
    int eobrun = 0;
    bool single = in_scan.size() == 1;
    int units_x = single ? comps[in_scan[0]].real_blocks_w : mcus_x;
    int units_y = single ? comps[in_scan[0]].real_blocks_h : mcus_y;
    long total = static_cast<long>(units_x) * units_y;
    int next_rst = 0, left = restart_interval;
    for (long unit = 0; unit < total; ++unit) {
      if (restart_interval) {
        if (left == 0) {
          restart(br, next_rst);
          next_rst = (next_rst + 1) & 7;
          left = restart_interval;
          for (int ci : in_scan) comps[ci].dc_pred = 0;
          eobrun = 0;
        }
        --left;
      }
      int ux = static_cast<int>(unit % units_x), uy = static_cast<int>(unit / units_x);
      for (size_t i = 0; i < in_scan.size(); ++i) {
        Component& c = comps[in_scan[i]];
        int bh = single ? 1 : c.h, bv = single ? 1 : c.v;
        for (int y = 0; y < bv; ++y)
          for (int x = 0; x < bh; ++x) {
            int bx = ux * bh + x, by = uy * bv + y;
            size_t index = static_cast<size_t>(by) * c.blocks_w + bx;
            int16_t* block = &c.coefs[index * 64];
            c.offsets[index] = static_cast<uint32_t>(br.offset());
            if (!progressive) {
              decode_sequential(br, c, *dc[i], *ac[i], block);
            } else if (dc_scan) {
              if (ah == 0) {
                int s = br.decode(*dc[i]);
                int diff = s ? extend(br.bits(s), s) : 0;
                c.dc_pred = static_cast<int>(static_cast<uint32_t>(c.dc_pred) + diff);
                block[0] = static_cast<int16_t>(lshift(c.dc_pred, al));
              } else if (br.bit()) {
                block[0] = static_cast<int16_t>(block[0] | (1 << al));
              }
            } else if (ah == 0) {
              decode_ac_first(br, *ac[i], block, ss, se, al, eobrun);
            } else {
              decode_ac_refine(br, *ac[i], block, ss, se, al, eobrun);
            }
          }
      }
    }
    // what is left of the scan's data: at most the padding of the last byte
    br.refill();
    if (br.stopped) return br.stop_pos;
    size_t p = br.pos;  // extraneous data: libjpeg skips to the next marker
    while (p + 1 < size && !(data[p] == 0xFF && data[p + 1] != 0x00 && data[p + 1] != 0xFF))
      ++p;
    return p;
  }

  void restart(BitReader& br, int expected) {
    br.refill();
    if (!br.stopped || br.nbits - br.pad >= 8)
      fail(kInvalid, "expected RST%d near byte offset %zu, found more entropy-coded data",
           expected, br.offset());
    size_t p = br.stop_pos;
    while (p < size && data[p] == 0xFF) ++p;
    if (p >= size)
      fail(kInvalid, "expected RST%d, the file ends (byte offset %zu)", expected, p);
    if (data[p] != 0xD0 + expected)
      fail(kInvalid, "expected RST%d at byte offset %zu, found marker 0x%02X", expected,
           br.stop_pos, data[p]);
    br.start(p + 1);
  }

  void decode_sequential(BitReader& br, Component& c, const Huffman& dc, const Huffman& ac,
                         int16_t* block) {
    int s = br.decode(dc);
    int diff = s ? extend(br.bits(s), s) : 0;
    c.dc_pred = static_cast<int>(static_cast<uint32_t>(c.dc_pred) + diff);
    block[0] = static_cast<int16_t>(c.dc_pred);
    for (int k = 1; k < 64; ++k) {
      int rs = br.decode(ac);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        block[kNatural[k]] = static_cast<int16_t>(extend(br.bits(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void decode_ac_first(BitReader& br, const Huffman& ac, int16_t* block, int ss, int se,
                       int al, int& eobrun) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      int rs = br.decode(ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        block[kNatural[k]] = static_cast<int16_t>(lshift(extend(br.bits(s), s), al));
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br.bits(r);
        --eobrun;
        break;
      }
    }
  }

  void decode_ac_refine(BitReader& br, const Huffman& ac, int16_t* block, int ss, int se,
                        int al, int& eobrun) {
    int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    auto correct = [&](int16_t& coef) {
      if (br.bit() && (coef & p1) == 0)
        coef = static_cast<int16_t>(coef >= 0 ? coef + p1 : coef + m1);
    };
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int rs = br.decode(ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.bit() ? p1 : m1;  // a size other than 1 is a warning in libjpeg
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.bits(r);
          break;
        }
        do {
          int16_t& coef = block[kNatural[k]];
          if (coef != 0) {
            correct(coef);
          } else {
            if (--r < 0) break;
          }
          ++k;
        } while (k <= se);
        if (s) block[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t& coef = block[kNatural[k]];
        if (coef != 0) correct(coef);
      }
      --eobrun;
    }
  }

  void parse() {
    if (size < 3 || data[0] != 0xFF || data[1] != 0xD8)
      fail(kInvalid, "not a JPEG file (no SOI marker)");
    size_t p = 2;
    for (;;) {
      if (p >= size) fail(kInvalid, "the file ends before its EOI marker (byte offset %zu)", p);
      while (p < size && data[p] != 0xFF) ++p;  // extraneous bytes: libjpeg skips them
      while (p < size && data[p] == 0xFF) ++p;
      if (p >= size) fail(kInvalid, "the file ends before its EOI marker (byte offset %zu)", p);
      int marker = data[p++];
      size_t len;
      switch (marker) {
        case 0xD9:
          if (!frame_seen || scans == 0) fail(kInvalid, "EOI before any scan");
          return;
        case 0xC0:
        case 0xC1:
        case 0xC2: {
          size_t q = segment(p, "SOF", &len);
          read_sof(marker, q, len);
          p = q + len;
          break;
        }
        case 0xC3: case 0xC5: case 0xC6: case 0xC7: case 0xC9: case 0xCA: case 0xCB:
        case 0xCD: case 0xCE: case 0xCF:
          fail(kUnsupported, "%s frame (marker 0x%02X at byte offset %zu)", frame_name(marker),
               marker, p - 2);
        case 0xC4: {
          size_t q = segment(p, "DHT", &len);
          read_dht(q, len);
          p = q + len;
          break;
        }
        case 0xDB: {
          size_t q = segment(p, "DQT", &len);
          read_dqt(q, len);
          p = q + len;
          break;
        }
        case 0xDD: {
          size_t q = segment(p, "DRI", &len);
          if (len != 2) fail(kInvalid, "DRI segment has length %zu", len + 2);
          restart_interval = be16(data + q);
          p = q + len;
          break;
        }
        case 0xDA: {
          size_t q = segment(p, "SOS", &len);
          int ss, se, ah, al;
          std::vector<int> in_scan = read_sos(q, len, &ss, &se, &ah, &al);
          p = decode_scan(q + len, in_scan, ss, se, ah, al);
          break;
        }
        case 0xDE:
        case 0xDF:
          fail(kUnsupported, "hierarchical mode (marker 0x%02X at byte offset %zu)", marker,
               p - 2);
        case 0xD8:
          fail(kInvalid, "a second SOI marker at byte offset %zu", p - 2);
        case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4: case 0xD5: case 0xD6:
        case 0xD7: case 0x01:
          break;  // no segment; libjpeg ignores a stray RSTn or TEM
        default: {
          size_t q = segment(p, "marker", &len);
          if (marker >= 0xE0 && marker <= 0xEF) read_app(marker, q, len);
          p = q + len;  // COM, DNL, DAC and the rest: skipped
          break;
        }
      }
    }
  }

  Space color_space() const {
    size_t n = comps.size();
    if (n == 1) return kGray;
    if (n == 3) {
      if (saw_jfif) return kYCbCr;
      if (saw_adobe) return adobe_transform == 0 ? kRGB : kYCbCr;
      if (comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B') return kRGB;
      return kYCbCr;
    }
    if (saw_adobe && adobe_transform != 0) return kYCCK;
    return kCMYK;
  }

  void inverse_dct() {
    for (auto& c : comps) {
      if (!c.quant_latched)
        fail(kInvalid, "component id %d appears in no scan", c.id);
      int stride = c.blocks_w * 8;
      c.plane.assign(static_cast<size_t>(stride) * c.blocks_h * 8, 0);
      for (int by = 0; by < c.blocks_h; ++by)
        for (int bx = 0; bx < c.blocks_w; ++bx) {
          size_t index = static_cast<size_t>(by) * c.blocks_w + bx;
          if (!idct_islow(&c.coefs[index * 64], c.quant,
                          &c.plane[static_cast<size_t>(by) * 8 * stride + bx * 8], stride))
            fail(kInvalid, "block (%d, %d) of component id %d, decoded near byte offset %u, "
                 "holds coefficients no 8-bit image gives (corrupt data)", by, bx, c.id,
                 c.offsets[index]);
        }
      std::vector<int16_t>().swap(c.coefs);
      std::vector<uint32_t>().swap(c.offsets);
    }
  }

  // one full-resolution row of component c, libjpeg's upsampling
  void upsample_row(const Component& c, int y, uint8_t* out, std::vector<int>& sums) const {
    int stride = c.blocks_w * 8;
    int rh = max_h / c.h, rv = max_v / c.v;
    int dw = c.sampled_w, dh = c.sampled_h;
    const uint8_t* plane = c.plane.data();
    if (rv == 1) {
      const uint8_t* in = plane + static_cast<size_t>(y) * stride;
      if (rh == 1) {
        std::memcpy(out, in, width);
      } else if (dw > 2) {  // h2v1 fancy
        out[0] = in[0];
        out[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
        for (int x = 1; x < dw - 1; ++x) {
          int v = in[x] * 3;
          out[2 * x] = static_cast<uint8_t>((v + in[x - 1] + 1) >> 2);
          out[2 * x + 1] = static_cast<uint8_t>((v + in[x + 1] + 2) >> 2);
        }
        out[2 * dw - 2] = static_cast<uint8_t>((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
        out[2 * dw - 1] = in[dw - 1];
      } else {  // box
        for (int x = 0; x < dw; ++x) out[2 * x] = out[2 * x + 1] = in[x];
      }
      return;
    }
    int row = y >> 1;
    if (rh == 2 && dw <= 2) {  // h2v2 box: no vertical filter either
      const uint8_t* in = plane + static_cast<size_t>(row) * stride;
      for (int x = 0; x < dw; ++x) out[2 * x] = out[2 * x + 1] = in[x];
      return;
    }
    int other = (y & 1) ? std::min(row + 1, dh - 1) : std::max(row - 1, 0);
    const uint8_t* in0 = plane + static_cast<size_t>(row) * stride;
    const uint8_t* in1 = plane + static_cast<size_t>(other) * stride;
    if (rh == 1) {  // h1v2 fancy
      int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < dw; ++x)
        out[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
      return;
    }
    // h2v2 fancy
    for (int x = 0; x < dw; ++x) sums[x] = in0[x] * 3 + in1[x];
    out[0] = static_cast<uint8_t>((sums[0] * 4 + 8) >> 4);
    out[1] = static_cast<uint8_t>((sums[0] * 3 + sums[1] + 7) >> 4);
    for (int x = 1; x < dw - 1; ++x) {
      out[2 * x] = static_cast<uint8_t>((sums[x] * 3 + sums[x - 1] + 8) >> 4);
      out[2 * x + 1] = static_cast<uint8_t>((sums[x] * 3 + sums[x + 1] + 7) >> 4);
    }
    out[2 * dw - 2] = static_cast<uint8_t>((sums[dw - 1] * 3 + sums[dw - 2] + 8) >> 4);
    out[2 * dw - 1] = static_cast<uint8_t>((sums[dw - 1] * 4 + 7) >> 4);
  }

  // the decoded image as RGB rows, before any EXIF orientation
  std::vector<uint8_t> to_rgb() const {
    constexpr int kScale = 16;
    constexpr int32_t kHalf = 1 << (kScale - 1);
    auto fix = [](double x) { return static_cast<int32_t>(x * (1 << kScale) + 0.5); };
    int cr_r[256], cb_b[256];
    int32_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      int32_t x = i - 128;
      cr_r[i] = (fix(1.40200) * x + kHalf) >> kScale;
      cb_b[i] = (fix(1.77200) * x + kHalf) >> kScale;
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
    auto clamp = [](int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    Space space = color_space();
    size_t n = comps.size();
    std::vector<uint8_t> rgb(static_cast<size_t>(width) * height * 3);
    int row_len = std::max(mcus_x * max_h * 8, 2 * width + 16);
    std::vector<std::vector<uint8_t>> rows(n, std::vector<uint8_t>(row_len));
    std::vector<int> sums(row_len);
    for (int y = 0; y < height; ++y) {
      for (size_t i = 0; i < n; ++i) upsample_row(comps[i], y, rows[i].data(), sums);
      uint8_t* out = &rgb[static_cast<size_t>(y) * width * 3];
      const uint8_t* c0 = rows[0].data();
      if (space == kGray) {
        for (int x = 0; x < width; ++x) out[3 * x] = out[3 * x + 1] = out[3 * x + 2] = c0[x];
        continue;
      }
      const uint8_t* c1 = rows[1].data();
      const uint8_t* c2 = rows[2].data();
      if (space == kRGB) {
        for (int x = 0; x < width; ++x) {
          out[3 * x] = c0[x];
          out[3 * x + 1] = c1[x];
          out[3 * x + 2] = c2[x];
        }
        continue;
      }
      if (space == kYCbCr) {
        for (int x = 0; x < width; ++x) {
          int yy = c0[x], cb = c1[x], cr = c2[x];
          out[3 * x] = clamp(yy + cr_r[cr]);
          out[3 * x + 1] = clamp(yy + ((cb_g[cb] + cr_g[cr]) >> kScale));
          out[3 * x + 2] = clamp(yy + cb_b[cb]);
        }
        continue;
      }
      const uint8_t* c3 = rows[3].data();
      for (int x = 0; x < width; ++x) {
        int cmyk[4] = {c0[x], c1[x], c2[x], c3[x]};
        if (space == kYCCK) {  // jdcolor.c's ycck_cmyk_convert
          int yy = c0[x], cb = c1[x], cr = c2[x];
          cmyk[0] = clamp(255 - (yy + cr_r[cr]));
          cmyk[1] = clamp(255 - (yy + ((cb_g[cb] + cr_g[cr]) >> kScale)));
          cmyk[2] = clamp(255 - (yy + cb_b[cb]));
        }
        // libjpeg's CMYK as stored: Adobe writes each ink inverted
        int k = cmyk[3];
        for (int j = 0; j < 3; ++j) {
          int v = cmyk[j], o;
          if (pil_cmyk) {
            // PIL reads Adobe files inverted ("CMYK;I"), then cmyk2rgb:
            // nk - nk * ink / 255, rounded with its MULDIV255
            int ink = saw_adobe ? 255 - v : v, nk = 255 - (saw_adobe ? 255 - k : k);
            int t = ink * nk + 128;
            o = nk - (((t >> 8) + t) >> 8);
          } else {
            // OpenCV's icvCvt_CMYK2BGR_8u_C4C3R on the stored values
            o = k - ((255 - v) * k >> 8);
          }
          out[3 * x + j] = clamp(o);
        }
      }
    }
    return rgb;
  }

  std::vector<uint8_t> run(int* out_h, int* out_w) {
    parse();
    if (progressive)
      for (size_t i = 0; i < comps.size(); ++i)
        for (int k = 0; k < 10; ++k)
          if (comps[i].coef_bits[k] != 0)
            fail(kUnsupported, "a progressive file whose coefficient %d of component %zu is %s "
                 "(libjpeg smooths such blocks)", k, i,
                 comps[i].coef_bits[k] < 0 ? "never coded" : "left unrefined");
    inverse_dct();
    std::vector<uint8_t> rgb = to_rgb();
    int h = height, w = width;
    if (exif_orientation) vitssl::apply_orientation(rgb, h, w, orientation);
    *out_h = h;
    *out_w = w;
    return rgb;
  }
};

}  // namespace

extern "C" {

// Decode the JPEG in data[0, size) to RGB uint8 (height, width, 3) rows.
// flags: 1 applies the EXIF orientation; 2 converts CMYK as PIL does (else
// as OpenCV does). Returns 0 and sets *out (release it with jpeg_free),
// *height and *width; 1 for a valid file this decoder does not take, 2 for a
// damaged or invalid file, with a message in msg.
int jpeg_decode(const uint8_t* data, size_t size, int flags, uint8_t** out, int* height,
                int* width, char* msg, int msg_size) {
  *out = nullptr;
  try {
    Decoder d{data, size, (flags & 1) != 0, (flags & 2) != 0};
    std::vector<uint8_t> rgb = d.run(height, width);
    *out = static_cast<uint8_t*>(std::malloc(rgb.size()));
    if (*out == nullptr) throw std::bad_alloc();
    std::memcpy(*out, rgb.data(), rgb.size());
    return kOk;
  } catch (const Failure& f) {
    std::snprintf(msg, msg_size, "%s", f.message.c_str());
    return f.status;
  } catch (const std::bad_alloc&) {
    std::snprintf(msg, msg_size, "out of memory");
    return kInvalid;
  }
}

void jpeg_free(uint8_t* p) { std::free(p); }

}  // extern "C"
