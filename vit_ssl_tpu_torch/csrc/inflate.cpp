// Inflate for the host: a zlib stream (RFC 1950) holding DEFLATE data (RFC
// 1951), the PNG decoder's image data (png_decode.cpp).
//
// Stored, fixed-Huffman and dynamic-Huffman blocks; the Adler-32 check. Codes
// are decoded through a 10-bit lookup table, longer codes bit by bit in
// canonical order. The code-set rules are zlib's: an over-subscribed or
// incomplete set is refused, except a literal/length or distance set of a
// single one-bit code, and a block whose literal/length set has no
// end-of-block code. A damaged stream fails with zlib's message, in the words
// Python's zlib.decompress raises it ("Error -3 while decompressing data:
// ..."), so the PNG decoder names a fault as the numpy decoder does.
//
// It uses the C++ standard library only and keeps no global state but the
// fixed tables, built once.

#include <algorithm>
#include <cstring>
#include <string>
#include <vector>

#include "host_image.h"

namespace {

constexpr int kFastBits = 10;
constexpr int kMaxBits = 15;

struct Failure {
  std::string message;
};

[[noreturn]] void data_error(const char* what) {
  throw Failure{std::string("Error -3 while decompressing data: ") + what};
}

[[noreturn]] void truncated() {
  throw Failure{"Error -5 while decompressing data: incomplete or truncated stream"};
}

struct Huffman {
  uint16_t count[kMaxBits + 1];
  uint16_t symbol[320];
  // (length << 9) | symbol of the code that the next kFastBits bits start
  // with; 0 where that code is longer (or there is none)
  uint16_t fast[1 << kFastBits];
};

// Build the canonical code of lengths[0, n). Returns 0 for a complete set,
// a negative number for an over-subscribed one, a positive one (the codes
// left) for an incomplete one; a set of no codes counts as complete.
int build(Huffman& h, const uint8_t* lengths, int n) {
  std::memset(h.count, 0, sizeof h.count);
  for (int i = 0; i < n; ++i) h.count[lengths[i]]++;
  std::memset(h.fast, 0, sizeof h.fast);
  if (h.count[0] == n) return 0;
  int left = 1;
  for (int len = 1; len <= kMaxBits; ++len) {
    left = (left << 1) - h.count[len];
    if (left < 0) return left;
  }
  uint16_t offset[kMaxBits + 2];
  offset[1] = 0;
  for (int len = 1; len <= kMaxBits; ++len) offset[len + 1] = offset[len] + h.count[len];
  for (int i = 0; i < n; ++i)
    if (lengths[i]) h.symbol[offset[lengths[i]]++] = static_cast<uint16_t>(i);
  int code = 0, index = 0;
  for (int len = 1; len <= kFastBits; ++len) {
    for (int k = 0; k < h.count[len]; ++k, ++code, ++index) {
      int reversed = 0;  // the code's bits as the stream holds them, first bit lowest
      for (int b = 0; b < len; ++b) reversed |= ((code >> b) & 1) << (len - 1 - b);
      const uint16_t entry = static_cast<uint16_t>(len << 9 | h.symbol[index]);
      for (int r = reversed; r < (1 << kFastBits); r += 1 << len) h.fast[r] = entry;
    }
    code <<= 1;
  }
  return left;
}

struct Bits {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  uint64_t buf = 0;
  int count = 0;

  void fill() {
    while (count <= 56 && pos < size) {
      buf |= static_cast<uint64_t>(data[pos++]) << count;
      count += 8;
    }
  }
  uint32_t take(int k) {
    if (count < k) {
      fill();
      if (count < k) truncated();
    }
    const uint32_t v = static_cast<uint32_t>(buf & ((1ull << k) - 1));
    buf >>= k;
    count -= k;
    return v;
  }
  // the next symbol of h, or -1 for a code h does not hold
  int decode(const Huffman& h) {
    if (count < kMaxBits) fill();
    const uint16_t entry = h.fast[buf & ((1u << kFastBits) - 1)];
    if (entry) {
      const int len = entry >> 9;
      if (len > count) truncated();
      buf >>= len;
      count -= len;
      return entry & 511;
    }
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= kMaxBits; ++len) {
      code |= static_cast<int>(take(1));
      const int n = h.count[len];
      if (code - n < first) return h.symbol[index + (code - first)];
      index += n;
      first = (first + n) << 1;
      code <<= 1;
    }
    return -1;
  }
};

constexpr uint16_t kLengthBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,
                                      15, 17, 19, 23, 27, 31, 35, 43, 51,  59,
                                      67, 83, 99, 115, 131, 163, 195, 227, 258};
constexpr uint8_t kLengthExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                      2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
constexpr uint16_t kDistBase[30] = {1,    2,    3,    4,    5,    7,     9,     13,
                                    17,   25,   33,   49,   65,   97,    129,   193,
                                    257,  385,  513,  769,  1025, 1537,  2049,  3073,
                                    4097, 6145, 8193, 12289, 16385, 24577};
constexpr uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2,  2,  3,  3,  4,  4,  5,  5,  6,
                                    6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
constexpr uint8_t kCodeOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                    11, 4, 12, 3, 13, 2, 14, 1, 15};

struct Fixed {
  Huffman lit, dist;
  Fixed() {
    uint8_t lengths[288];
    for (int i = 0; i < 288; ++i) lengths[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
    build(lit, lengths, 288);
    for (int i = 0; i < 30; ++i) lengths[i] = 5;
    build(dist, lengths, 30);
  }
};

struct Output {
  std::vector<uint8_t>& buf;
  size_t n = 0;

  void room(size_t more) {
    if (n + more > buf.size()) buf.resize(std::max(buf.size() * 2, n + more + 4096));
  }
};

void codes(Bits& in, Output& out, const Huffman& lit, const Huffman& dist) {
  for (;;) {
    const int sym = in.decode(lit);
    if (sym < 0) data_error("invalid literal/length code");
    if (sym < 256) {
      out.room(1);
      out.buf[out.n++] = static_cast<uint8_t>(sym);
      continue;
    }
    if (sym == 256) return;
    if (sym > 285) data_error("invalid literal/length code");
    const int len = kLengthBase[sym - 257] + static_cast<int>(in.take(kLengthExtra[sym - 257]));
    const int dsym = in.decode(dist);
    if (dsym < 0 || dsym >= 30) data_error("invalid distance code");
    const size_t d = kDistBase[dsym] + in.take(kDistExtra[dsym]);
    if (d > out.n) data_error("invalid distance too far back");
    out.room(len);
    uint8_t* to = out.buf.data() + out.n;
    const uint8_t* from = to - d;
    for (int i = 0; i < len; ++i) to[i] = from[i];
    out.n += len;
  }
}

void dynamic_block(Bits& in, Output& out) {
  const int nlen = static_cast<int>(in.take(5)) + 257;
  const int ndist = static_cast<int>(in.take(5)) + 1;
  const int ncode = static_cast<int>(in.take(4)) + 4;
  if (nlen > 286 || ndist > 30) data_error("too many length or distance symbols");
  uint8_t lengths[320] = {0};
  for (int i = 0; i < ncode; ++i) lengths[kCodeOrder[i]] = static_cast<uint8_t>(in.take(3));
  Huffman lencode, distcode;
  if (build(lencode, lengths, 19) != 0) data_error("invalid code lengths set");
  int index = 0;
  while (index < nlen + ndist) {
    const int sym = in.decode(lencode);
    if (sym < 0) data_error("invalid code lengths set");
    if (sym < 16) {
      lengths[index++] = static_cast<uint8_t>(sym);
      continue;
    }
    int value = 0, repeat;
    if (sym == 16) {
      if (index == 0) data_error("invalid bit length repeat");
      value = lengths[index - 1];
      repeat = 3 + static_cast<int>(in.take(2));
    } else if (sym == 17) {
      repeat = 3 + static_cast<int>(in.take(3));
    } else {
      repeat = 11 + static_cast<int>(in.take(7));
    }
    if (index + repeat > nlen + ndist) data_error("invalid bit length repeat");
    while (repeat--) lengths[index++] = static_cast<uint8_t>(value);
  }
  if (lengths[256] == 0) data_error("invalid code -- missing end-of-block");
  int err = build(lencode, lengths, nlen);
  if (err < 0 || (err > 0 && nlen - lencode.count[0] != 1))
    data_error("invalid literal/lengths set");
  err = build(distcode, lengths + nlen, ndist);
  if (err < 0 || (err > 0 && ndist - distcode.count[0] != 1))
    data_error("invalid distances set");
  codes(in, out, lencode, distcode);
}

uint32_t adler32(const uint8_t* p, size_t n) {
  uint32_t a = 1, b = 0;
  while (n) {
    const size_t k = n < 5552 ? n : 5552;
    for (size_t i = 0; i < k; ++i) {
      a += p[i];
      b += a;
    }
    a %= 65521;
    b %= 65521;
    p += k;
    n -= k;
  }
  return b << 16 | a;
}

}  // namespace

namespace vitssl {

bool zlib_inflate(const uint8_t* data, size_t size, size_t size_hint,
                  std::vector<uint8_t>& out, std::string& error) {
  static const Fixed fixed;
  out.clear();
  out.resize(size_hint);
  Output sink{out};
  try {
    if (size < 2) truncated();
    const int cmf = data[0], flg = data[1];
    if ((cmf << 8 | flg) % 31) data_error("incorrect header check");
    if ((cmf & 15) != 8) data_error("unknown compression method");
    if ((cmf >> 4) + 8 > 15) data_error("invalid window size");
    if (flg & 0x20) throw Failure{"Error 2 while decompressing data"};  // a preset dictionary
    Bits in{data + 2, size - 2};
    int last;
    do {
      last = static_cast<int>(in.take(1));
      const int type = static_cast<int>(in.take(2));
      if (type == 0) {
        in.take(in.count & 7);  // to the byte boundary
        const uint32_t len = in.take(16), nlen = in.take(16);
        if (len != (~nlen & 0xffff)) data_error("invalid stored block lengths");
        sink.room(len);
        uint32_t done = 0;
        for (; done < len && in.count >= 8; ++done)
          sink.buf[sink.n++] = static_cast<uint8_t>(in.take(8));
        const size_t rest = len - done;
        if (in.pos + rest > in.size) truncated();
        std::memcpy(sink.buf.data() + sink.n, in.data + in.pos, rest);
        sink.n += rest;
        in.pos += rest;
      } else if (type == 1) {
        codes(in, sink, fixed.lit, fixed.dist);
      } else if (type == 2) {
        dynamic_block(in, sink);
      } else {
        data_error("invalid block type");
      }
    } while (!last);
    in.take(in.count & 7);
    uint32_t check = 0;
    for (int i = 0; i < 4; ++i) check = check << 8 | in.take(8);
    if (check != adler32(out.data(), sink.n)) data_error("incorrect data check");
  } catch (const Failure& f) {
    error = f.message;
    out.clear();
    return false;
  }
  out.resize(sink.n);
  return true;
}

}  // namespace vitssl
