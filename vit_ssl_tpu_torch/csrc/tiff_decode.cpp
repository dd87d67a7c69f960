// The byte-serial parts of the port's TIFF reader (data/tiff.py): LZW and
// PackBits strips and tiles expanded into the caller's buffer. Standard
// library only, a plain C interface for ctypes.
//
// LZW is TIFF's: codes MSB first, 9 to 12 bits, the code width raised one
// code early (at 511, 1023 and 2047 entries), 256 clears the table and 257
// ends the data. Old-style (LSB-first) LZW is refused. PackBits: a byte n in
// 0..127 copies the next n + 1 bytes, 129..255 repeats the next byte 257 - n
// times, 128 is skipped.
//
// Both return 0 and set *produced (at most cap bytes: a strip may hold
// more codes than the image needs), 1 for a form not taken, 2 for damaged
// data, with a message naming the byte offset.

#include <cstdarg>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

constexpr int kOk = 0, kUnsupported = 1, kInvalid = 2;

int say(char* msg, int msg_size, int status, const char* fmt, ...) {
  va_list args;
  va_start(args, fmt);
  std::vsnprintf(msg, msg_size, fmt, args);
  va_end(args);
  return status;
}

struct Entry {
  uint16_t prefix;  // the code this one extends (0xFFFF for a single byte)
  uint16_t length;
  uint8_t last;     // its last byte
  uint8_t first;    // its first byte
};

}  // namespace

extern "C" {

int tiff_lzw(const uint8_t* src, size_t n, uint8_t* dst, size_t cap, size_t* produced,
             char* msg, int msg_size) {
  *produced = 0;
  if (n >= 2 && src[0] == 0 && (src[1] & 1))
    return say(msg, msg_size, kUnsupported, "old-style (LSB-first) LZW");
  static thread_local Entry table[4096];
  for (int i = 0; i < 256; ++i) table[i] = {0xFFFF, 1, static_cast<uint8_t>(i), static_cast<uint8_t>(i)};
  int width = 9, next = 258, prev = -1;
  size_t out = 0, bitpos = 0;
  const size_t nbits = n * 8;
  while (out < cap) {
    if (bitpos + width > nbits) break;  // the data ends without an end code
    uint32_t code = 0;
    for (int b = 0; b < width; ++b, ++bitpos)
      code = (code << 1) | ((src[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
    if (code == 257) break;
    if (code == 256) {
      width = 9;
      next = 258;
      prev = -1;
      continue;
    }
    if (prev < 0) {
      if (code > 255)
        return say(msg, msg_size, kInvalid, "LZW code %u after a clear at byte %zu", code,
                   (bitpos - width) / 8);
      dst[out++] = static_cast<uint8_t>(code);
      prev = static_cast<int>(code);
      continue;
    }
    if (static_cast<int>(code) > next || next >= 4096)
      return say(msg, msg_size, kInvalid, "LZW code %u past the table's %d entries at byte %zu",
                 code, next, (bitpos - width) / 8);
    uint8_t first = code == static_cast<uint32_t>(next) ? table[prev].first : table[code].first;
    table[next] = {static_cast<uint16_t>(prev), static_cast<uint16_t>(table[prev].length + 1),
                   first, table[prev].first};
    ++next;
    // write the string of `code` backwards from its end
    size_t len = table[code].length;
    size_t end = out + len;
    size_t keep = end > cap ? cap : end;
    int c = static_cast<int>(code);
    for (size_t i = end; i-- > out;) {
      if (i < keep) dst[i] = table[c].last;
      c = table[c].prefix;
    }
    out = keep;
    prev = static_cast<int>(code);
    if (next >= (1 << width) - 1 && width < 12) ++width;
  }
  *produced = out;
  return kOk;
}

int tiff_packbits(const uint8_t* src, size_t n, uint8_t* dst, size_t cap, size_t* produced,
                  char* msg, int msg_size) {
  size_t in = 0, out = 0;
  while (in < n && out < cap) {
    int8_t head = static_cast<int8_t>(src[in++]);
    if (head >= 0) {
      size_t count = static_cast<size_t>(head) + 1;
      if (in + count > n)
        return say(msg, msg_size, kInvalid, "PackBits literal at byte %zu runs past the data",
                   in - 1);
      if (out + count > cap) count = cap - out;
      std::memcpy(dst + out, src + in, count);
      in += static_cast<size_t>(head) + 1;
      out += count;
    } else if (head != -128) {
      if (in >= n)
        return say(msg, msg_size, kInvalid, "PackBits run at byte %zu runs past the data",
                   in - 1);
      size_t count = static_cast<size_t>(1 - head);
      if (out + count > cap) count = cap - out;
      std::memset(dst + out, src[in++], count);
      out += count;
    }
  }
  *produced = out;
  return kOk;
}

}  // extern "C"
