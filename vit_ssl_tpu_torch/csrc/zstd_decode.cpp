// A Zstandard decoder for the host (RFC 8878), from memory to memory, and
// the CRC-32C that OCDBT files end with.
//
// It reads what the JAX package's checkpoints hold (orbax writes zarr
// chunks and OCDBT B-tree nodes as zstd frames through tensorstore) and
// anything else a zstd encoder writes without a dictionary:
//   - frames with and without the content size, with and without the
//     XXH64 content checksum (checked when present), in single-segment
//     form or with a window descriptor (any window the format allows; the
//     whole frame is decoded in memory, so the window only bounds offsets);
//   - skippable frames, and several frames back to back in one buffer;
//   - Raw, RLE and Compressed blocks;
//   - literals Raw, RLE, Huffman-coded (one or four streams, the table
//     described by direct 4-bit weights or FSE-compressed weights) and
//     treeless (the previous block's table);
//   - sequences whose literal-length, offset and match-length codes are in
//     predefined, RLE, FSE-compressed or repeat mode, and the three repeat
//     offsets.
// A frame that needs a dictionary (dictionary id != 0) is refused by name.
// Damaged input raises: the message names the byte offset in the buffer and
// what was wrong, and no partial output is returned.
//
// Standard library only, no global state; the plain C interface is bound
// with ctypes (vit_ssl_tpu_torch/utils/zstd.py), which releases the GIL.

#include <algorithm>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

constexpr int kOk = 0;
constexpr int kUnsupported = 1;
constexpr int kInvalid = 2;
constexpr int kTooSmall = 3;

constexpr uint32_t kFrameMagic = 0xFD2FB528u;
constexpr uint32_t kSkippableMask = 0xFFFFFFF0u;
constexpr uint32_t kSkippableMagic = 0x184D2A50u;
constexpr size_t kBlockMax = 128 * 1024;

struct Failure {
  int status;
  std::string message;
};

[[noreturn]] void fail_status(int status, size_t offset, const char* fmt, ...) {
  char buf[384];
  va_list args;
  va_start(args, fmt);
  std::vsnprintf(buf, sizeof buf, fmt, args);
  va_end(args);
  char full[480];
  std::snprintf(full, sizeof full, "byte %zu: %s", offset, buf);
  throw Failure{status, full};
}

#define FAIL(offset, ...) fail_status(kInvalid, (offset), __VA_ARGS__)

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

inline uint64_t load_le(const uint8_t* p, int n) {
  uint64_t v = 0;
  if (n == 8) {
    std::memcpy(&v, p, 8);  // hosts are little-endian (x86-64, aarch64)
    return v;
  }
  for (int i = 0; i < n; ++i) v |= uint64_t(p[i]) << (8 * i);
  return v;
}

// ---------------------------------------------------------------------------
// XXH64 (the frame checksum is its low 32 bits, seed 0)

constexpr uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull,
                   P3 = 1609587929392839161ull, P4 = 9650029242287828579ull,
                   P5 = 2870177450012600261ull;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xxround(uint64_t acc, uint64_t in) {
  acc += in * P2;
  acc = rotl(acc, 31);
  return acc * P1;
}
inline uint64_t xxmerge(uint64_t acc, uint64_t v) {
  acc ^= xxround(0, v);
  return acc * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xxround(v1, load_le(p, 8));
      v2 = xxround(v2, load_le(p + 8, 8));
      v3 = xxround(v3, load_le(p + 16, 8));
      v4 = xxround(v4, load_le(p + 24, 8));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xxmerge(h, v1);
    h = xxmerge(h, v2);
    h = xxmerge(h, v3);
    h = xxmerge(h, v4);
  } else {
    h = seed + P5;
  }
  h += uint64_t(n);
  while (p + 8 <= end) {
    h ^= xxround(0, load_le(p, 8));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= uint64_t(uint32_t(load_le(p, 4))) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= uint64_t(*p) * P5;
    h = rotl(h, 11) * P1;
    ++p;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------------------
// CRC-32C (Castagnoli, reflected, as OCDBT's manifests and nodes end with),
// slicing by 8.

struct Crc32cTables {
  uint32_t t[8][256];
  Crc32cTables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

uint32_t crc32c_update(uint32_t crc, const uint8_t* p, size_t n) {
  static const Crc32cTables tables;
  const auto& t = tables.t;
  crc = ~crc;
  while (n >= 8) {
    uint64_t v = load_le(p, 8) ^ crc;
    crc = t[7][v & 0xFF] ^ t[6][(v >> 8) & 0xFF] ^ t[5][(v >> 16) & 0xFF] ^
          t[4][(v >> 24) & 0xFF] ^ t[3][(v >> 32) & 0xFF] ^ t[2][(v >> 40) & 0xFF] ^
          t[1][(v >> 48) & 0xFF] ^ t[0][v >> 56];
    p += 8;
    n -= 8;
  }
  while (n--) crc = t[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

// ---------------------------------------------------------------------------
// Bit readers

// Reads little-endian bit fields forward (FSE table descriptions).
struct ForwardBits {
  const uint8_t* data;
  size_t size;    // bytes available
  size_t base;    // offset of data[0] in the input, for messages
  uint64_t pos = 0;  // bits read

  uint32_t peek(int n) const {
    size_t b = size_t(pos >> 3);
    int s = int(pos & 7);
    uint64_t v = 0;
    if (b < size) v = load_le(data + b, int(std::min<size_t>(8, size - b)));
    return uint32_t((v >> s) & ((uint64_t(1) << n) - 1));
  }
  void skip(int n) {
    pos += n;
    if (pos > uint64_t(size) * 8) FAIL(base + size, "table description runs past its section");
  }
  uint32_t read(int n) {
    uint32_t v = peek(n);
    skip(n);
    return v;
  }
  size_t bytes_used() const { return size_t((pos + 7) >> 3); }
};

// Reads a zstd backward bitstream: bits are taken from the end towards the
// start, the last byte's highest set bit marking where they begin. Bits
// below the start read as zero; `overflowed` tells a reader that took them.
struct BackwardBits {
  const uint8_t* data = nullptr;
  size_t size = 0;
  size_t base = 0;
  int64_t pos = 0;  // bits not yet read

  void init(const uint8_t* d, size_t n, size_t offset) {
    data = d;
    size = n;
    base = offset;
    if (n == 0) FAIL(offset, "empty bitstream");
    uint8_t last = d[n - 1];
    if (last == 0) FAIL(offset + n - 1, "bitstream's last byte is 0 (no start marker)");
    pos = int64_t(n - 1) * 8 + highbit(last);
  }
  // the n bits ending at pos (n <= 56), without consuming them; bits below 0
  // are zeros
  uint64_t peek(int n) const {
    if (n == 0) return 0;
    int64_t lo = pos - n;
    if (lo >= 0) {
      size_t b = size_t(lo >> 3);
      int s = int(lo & 7);
      uint64_t v = load_le(data + b, int(std::min<size_t>(8, size - b)));
      return (v >> s) & ((uint64_t(1) << n) - 1);
    }
    if (pos <= 0) return 0;
    uint64_t v = load_le(data, int(std::min<size_t>(8, size)));
    return (v & ((uint64_t(1) << pos) - 1)) << (-lo);
  }
  uint64_t read(int n) {
    uint64_t v = peek(n);
    pos -= n;
    return v;
  }
  bool overflowed() const { return pos < 0; }
};

// ---------------------------------------------------------------------------
// FSE tables

struct FseEntry {
  uint16_t symbol;
  uint8_t bits;
  uint16_t base;  // next state = base + read(bits)
};

struct FseTable {
  int log = 0;
  std::vector<FseEntry> e;
  bool valid = false;

  void build(const int16_t* norm, int max_symbol, int accuracy_log, size_t offset) {
    log = accuracy_log;
    size_t size = size_t(1) << accuracy_log;
    e.assign(size, FseEntry{0, 0, 0});
    std::vector<uint16_t> next(max_symbol + 1);
    size_t high = size - 1;
    for (int s = 0; s <= max_symbol; ++s) {
      if (norm[s] == -1) {
        e[high--].symbol = uint16_t(s);
        next[s] = 1;
      } else {
        next[s] = uint16_t(norm[s] > 0 ? norm[s] : 0);
      }
    }
    size_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1, p = 0;
    for (int s = 0; s <= max_symbol; ++s) {
      for (int i = 0; i < norm[s]; ++i) {
        e[p].symbol = uint16_t(s);
        do {
          p = (p + step) & mask;
        } while (p > high);
      }
    }
    if (p != 0) FAIL(offset, "FSE table description does not fill its table");
    for (size_t u = 0; u < size; ++u) {
      uint16_t s = e[u].symbol;
      uint32_t n = next[s]++;
      int bits = accuracy_log - highbit(n);
      e[u].bits = uint8_t(bits);
      e[u].base = uint16_t((n << bits) - size);
    }
    valid = true;
  }

  void build_rle(uint16_t symbol) {
    log = 0;
    e.assign(1, FseEntry{symbol, 0, 0});
    valid = true;
  }
};

// Reads an FSE table description (RFC 8878 4.1.1) at data[0, size); returns
// the bytes it took.
size_t read_fse_description(const uint8_t* data, size_t size, size_t offset, int max_log,
                            int max_symbol, FseTable& table) {
  ForwardBits in{data, size, offset};
  if (size == 0) FAIL(offset, "missing FSE table description");
  int log = int(in.read(4)) + 5;
  if (log > max_log)
    FAIL(offset, "FSE accuracy log %d above the maximum %d", log, max_log);
  std::vector<int16_t> norm(max_symbol + 1, 0);
  int remaining = (1 << log) + 1;
  int threshold = 1 << log;
  int bits = log + 1;
  int symbol = 0;
  bool previous0 = false;
  while (remaining > 1) {
    if (previous0) {
      uint32_t r = in.read(2);
      while (r == 3) {
        symbol += 3;
        r = in.read(2);
      }
      symbol += int(r);
      previous0 = false;
      if (symbol > max_symbol) FAIL(offset, "FSE table description: symbol past the maximum");
      continue;
    }
    if (symbol > max_symbol) FAIL(offset, "FSE table description: symbol past the maximum");
    int max = (2 * threshold - 1) - remaining;
    int count;
    uint32_t low = in.peek(bits - 1);
    if (int(low) < max) {
      count = int(low);
      in.skip(bits - 1);
    } else {
      count = int(in.peek(bits));
      if (count >= threshold) count -= max;
      in.skip(bits);
    }
    --count;  // -1: a "less than one" probability
    remaining -= count < 0 ? -count : count;
    norm[symbol++] = int16_t(count);
    previous0 = count == 0;
    while (remaining < threshold) {
      --bits;
      threshold >>= 1;
    }
  }
  if (remaining != 1) FAIL(offset, "FSE table description's probabilities do not sum up");
  size_t used = in.bytes_used();
  if (used > size) FAIL(offset, "FSE table description runs past its section");
  table.build(norm.data(), symbol - 1, log, offset);
  return used;
}

// The predefined distributions (RFC 8878 3.1.1.3.2.2)
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,   6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,  20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  12,   13,   14,   15,   16,
                              17, 18, 19, 20, 21, 22, 23, 24,  25,  26,   27,   28,   29,   30,
                              31, 32, 33, 34, 35, 37, 39, 41,  43,  47,   51,   59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

// ---------------------------------------------------------------------------
// Huffman tables for literals

struct HufEntry {
  uint8_t symbol;
  uint8_t bits;
};

struct HufTable {
  int max_bits = 0;
  std::vector<HufEntry> e;
  bool valid = false;
};

// Reads a Huffman tree description at data[0, size); returns the bytes it took.
size_t read_huffman_description(const uint8_t* data, size_t size, size_t offset,
                                HufTable& table) {
  if (size == 0) FAIL(offset, "missing Huffman tree description");
  uint8_t header = data[0];
  uint8_t weights[258];
  int n = 0;
  size_t used;
  if (header >= 128) {
    n = header - 127;
    used = 1 + size_t(n + 1) / 2;
    if (used > size) FAIL(offset, "Huffman weights run past the literals section");
    for (int i = 0; i < n; ++i) {
      uint8_t b = data[1 + i / 2];
      weights[i] = (i % 2 == 0) ? b >> 4 : b & 15;
    }
  } else {
    size_t csize = header;
    used = 1 + csize;
    if (used > size) FAIL(offset, "Huffman weights run past the literals section");
    FseTable fse;
    size_t d = read_fse_description(data + 1, csize, offset + 1, 6, 255, fse);
    if (d >= csize) FAIL(offset + 1, "FSE-coded Huffman weights have no bitstream");
    BackwardBits in;
    in.init(data + 1 + d, csize - d, offset + 1 + d);
    uint32_t s1 = uint32_t(in.read(fse.log)), s2 = uint32_t(in.read(fse.log));
    auto step = [&](uint32_t& s) {
      const FseEntry& x = fse.e[s];
      s = x.base + uint32_t(in.read(x.bits));
      return uint8_t(x.symbol);
    };
    while (true) {
      if (n >= 255) FAIL(offset, "more than 255 Huffman weights");
      weights[n++] = step(s1);
      if (in.overflowed()) {
        weights[n++] = uint8_t(fse.e[s2].symbol);
        break;
      }
      if (n >= 255) FAIL(offset, "more than 255 Huffman weights");
      weights[n++] = step(s2);
      if (in.overflowed()) {
        weights[n++] = uint8_t(fse.e[s1].symbol);
        break;
      }
    }
  }
  if (n > 255) FAIL(offset, "more than 255 Huffman weights");
  uint32_t sum = 0;
  int rank[13] = {0};
  for (int i = 0; i < n; ++i) {
    if (weights[i] > 11) FAIL(offset, "Huffman weight %d above 11", int(weights[i]));
    if (weights[i]) sum += uint32_t(1) << (weights[i] - 1);
  }
  if (sum == 0) FAIL(offset, "Huffman weights are all zero");
  int max_bits = highbit(sum) + 1;
  if (max_bits > 11) FAIL(offset, "Huffman codes longer than 11 bits");
  uint32_t left = (uint32_t(1) << max_bits) - sum;
  if (left == 0 || (left & (left - 1)))
    FAIL(offset, "Huffman weights do not complete a prefix code");
  weights[n++] = uint8_t(highbit(left) + 1);
  for (int i = 0; i < n; ++i) rank[weights[i]]++;
  uint32_t start[13] = {0};
  uint32_t next = 0;
  for (int w = 1; w <= max_bits; ++w) {
    start[w] = next;
    next += uint32_t(rank[w]) << (w - 1);
  }
  table.max_bits = max_bits;
  table.e.assign(size_t(1) << max_bits, HufEntry{0, 0});
  for (int s = 0; s < n; ++s) {
    int w = weights[s];
    if (!w) continue;
    uint32_t len = uint32_t(1) << (w - 1);
    for (uint32_t k = 0; k < len; ++k)
      table.e[start[w] + k] = HufEntry{uint8_t(s), uint8_t(max_bits + 1 - w)};
    start[w] += len;
  }
  table.valid = true;
  return used;
}

void decode_huffman_stream(const HufTable& t, const uint8_t* data, size_t size,
                           size_t offset, uint8_t* out, size_t count) {
  BackwardBits in;
  in.init(data, size, offset);
  const int mb = t.max_bits;
  const uint64_t mask = (uint64_t(1) << mb) - 1;
  size_t i = 0;
  // the body: one 8-byte load a literal, the 8 bytes that end with the one
  // holding the bit below pos
  for (; i < count && in.pos >= 64; ++i) {
    int64_t top = (in.pos + 7) >> 3;
    uint64_t v;
    std::memcpy(&v, data + top - 8, 8);
    const HufEntry& x = t.e[(v >> (in.pos - mb - (top - 8) * 8)) & mask];
    in.pos -= x.bits;
    out[i] = x.symbol;
  }
  for (; i < count; ++i) {
    const HufEntry& x = t.e[in.peek(t.max_bits)];
    if (x.bits > in.pos) FAIL(offset, "Huffman stream ends early (literal %zu of %zu)", i, count);
    in.pos -= x.bits;
    out[i] = x.symbol;
  }
  if (in.pos != 0)
    FAIL(offset, "Huffman stream holds %lld bits past its %zu literals",
         (long long)in.pos, count);
}

// ---------------------------------------------------------------------------
// Output

struct Output {
  uint8_t* p;
  size_t len;
  size_t cap;
  std::vector<uint8_t>* grow;  // null: fixed capacity

  void reserve(size_t extra, size_t offset) {
    if (len + extra <= cap) return;
    if (!grow)
      fail_status(kTooSmall, offset, "output larger than the %zu bytes expected", cap);
    size_t want = std::max(len + extra, cap * 2 + 4096);
    grow->resize(want);
    p = grow->data();
    cap = want;
  }
};

// ---------------------------------------------------------------------------
// Frame decoding

struct FrameState {
  HufTable huf;
  FseTable ll, of, ml;
  uint32_t rep[3] = {1, 4, 8};
};

struct Decoder {
  const uint8_t* src;
  size_t n;
  Output& out;

  // Literals section; returns the bytes it took. lits receives the literals.
  size_t read_literals(const uint8_t* d, size_t size, size_t off, FrameState& fs,
                       std::vector<uint8_t>& lits) {
    if (size < 1) FAIL(off, "block has no literals section");
    int type = d[0] & 3, format = (d[0] >> 2) & 3;
    size_t regen, csize = 0, header;
    if (type <= 1) {
      if (format == 0 || format == 2) {
        regen = d[0] >> 3;
        header = 1;
      } else if (format == 1) {
        if (size < 2) FAIL(off, "literals header cut short");
        regen = (d[0] >> 4) + (size_t(d[1]) << 4);
        header = 2;
      } else {
        if (size < 3) FAIL(off, "literals header cut short");
        regen = (d[0] >> 4) + (size_t(d[1]) << 4) + (size_t(d[2]) << 12);
        header = 3;
      }
    } else {
      header = format <= 1 ? 3 : size_t(format) + 2;
      if (size < header) FAIL(off, "literals header cut short");
      uint64_t v = load_le(d, int(header));
      int field = format <= 1 ? 10 : format == 2 ? 14 : 18;
      regen = size_t((v >> 4) & ((uint64_t(1) << field) - 1));
      csize = size_t(v >> (4 + field));
    }
    if (regen > kBlockMax) FAIL(off, "%zu literals, above the block maximum", regen);
    lits.resize(regen);
    if (type == 0) {
      if (header + regen > size) FAIL(off, "raw literals run past the block");
      std::memcpy(lits.data(), d + header, regen);
      return header + regen;
    }
    if (type == 1) {
      if (header + 1 > size) FAIL(off, "RLE literals run past the block");
      std::memset(lits.data(), d[header], regen);
      return header + 1;
    }
    if (header + csize > size) FAIL(off, "compressed literals run past the block");
    const uint8_t* p = d + header;
    size_t avail = csize, at = off + header;
    if (type == 2) {
      size_t used = read_huffman_description(p, avail, at, fs.huf);
      p += used;
      avail -= used;
      at += used;
    } else if (!fs.huf.valid) {
      FAIL(off, "treeless literals with no earlier Huffman table in the frame");
    }
    bool four = format != 0;
    if (!four) {
      decode_huffman_stream(fs.huf, p, avail, at, lits.data(), regen);
    } else {
      if (avail < 6) FAIL(at, "literals jump table cut short");
      size_t s1 = load_le(p, 2), s2 = load_le(p + 2, 2), s3 = load_le(p + 4, 2);
      if (6 + s1 + s2 + s3 > avail) FAIL(at, "literals jump table points past the streams");
      size_t s4 = avail - 6 - s1 - s2 - s3;
      size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) FAIL(at, "%zu literals are too few for four streams", regen);
      const uint8_t* q = p + 6;
      size_t qa = at + 6;
      size_t sizes[4] = {s1, s2, s3, s4};
      for (int k = 0; k < 4; ++k) {
        size_t cnt = k < 3 ? seg : regen - 3 * seg;
        decode_huffman_stream(fs.huf, q, sizes[k], qa, lits.data() + k * seg, cnt);
        q += sizes[k];
        qa += sizes[k];
      }
    }
    return header + csize;
  }

  size_t read_table(const uint8_t* d, size_t size, size_t off, int mode, FseTable& t,
                    const int16_t* def, int def_max, int def_log, int max_log,
                    int max_symbol, const char* what) {
    switch (mode) {
      case 0:
        t.build(def, def_max, def_log, off);
        return 0;
      case 1:
        if (size < 1) FAIL(off, "%s RLE symbol missing", what);
        if (d[0] > max_symbol) FAIL(off, "%s RLE symbol %d out of range", what, int(d[0]));
        t.build_rle(d[0]);
        return 1;
      case 2:
        return read_fse_description(d, size, off, max_log, max_symbol, t);
      default:
        if (!t.valid) FAIL(off, "%s table repeated with no earlier table in the frame", what);
        return 0;
    }
  }

  void block_compressed(const uint8_t* d, size_t size, size_t off, FrameState& fs,
                        size_t frame_start, size_t block_max) {
    std::vector<uint8_t> lits;
    size_t used = read_literals(d, size, off, fs, lits);
    const uint8_t* p = d + used;
    size_t avail = size - used, at = off + used;
    if (avail < 1) FAIL(at, "block has no sequences section");
    size_t nseq;
    if (p[0] < 128) {
      nseq = p[0];
      p += 1;
      avail -= 1;
      at += 1;
    } else if (p[0] < 255) {
      if (avail < 2) FAIL(at, "sequence count cut short");
      nseq = (size_t(p[0] - 128) << 8) + p[1];
      p += 2;
      avail -= 2;
      at += 2;
    } else {
      if (avail < 3) FAIL(at, "sequence count cut short");
      nseq = size_t(p[1]) + (size_t(p[2]) << 8) + 0x7F00;
      p += 3;
      avail -= 3;
      at += 3;
    }
    size_t block_start = out.len;
    if (nseq == 0) {
      if (avail != 0) FAIL(at, "%zu bytes after a block with no sequences", avail);
      out.reserve(lits.size(), at);
      std::memcpy(out.p + out.len, lits.data(), lits.size());
      out.len += lits.size();
      return;
    }
    if (avail < 1) FAIL(at, "sequence modes missing");
    uint8_t modes = p[0];
    if (modes & 3) FAIL(at, "reserved bits set in the sequence modes");
    p += 1;
    avail -= 1;
    at += 1;
    size_t k;
    k = read_table(p, avail, at, modes >> 6, fs.ll, kLLDefault, 35, 6, 9, 35, "literal length");
    p += k, avail -= k, at += k;
    k = read_table(p, avail, at, (modes >> 4) & 3, fs.of, kOFDefault, 28, 5, 8, 31, "offset");
    p += k, avail -= k, at += k;
    k = read_table(p, avail, at, (modes >> 2) & 3, fs.ml, kMLDefault, 52, 6, 9, 52, "match length");
    p += k, avail -= k, at += k;

    BackwardBits in;
    in.init(p, avail, at);
    uint32_t sll = uint32_t(in.read(fs.ll.log));
    uint32_t sof = uint32_t(in.read(fs.of.log));
    uint32_t sml = uint32_t(in.read(fs.ml.log));
    size_t lit_pos = 0;
    for (size_t i = 0; i < nseq; ++i) {
      const FseEntry& ell = fs.ll.e[sll];
      const FseEntry& eof = fs.of.e[sof];
      const FseEntry& eml = fs.ml.e[sml];
      uint32_t ofc = eof.symbol;
      if (ofc > 31) FAIL(at, "offset code %u above 31", ofc);
      uint64_t ofv = (uint64_t(1) << ofc) + in.read(int(ofc));
      uint32_t mlc = eml.symbol, llc = ell.symbol;
      size_t ml = kMLBase[mlc] + size_t(in.read(kMLBits[mlc]));
      size_t ll = kLLBase[llc] + size_t(in.read(kLLBits[llc]));
      if (i + 1 < nseq) {
        sll = ell.base + uint32_t(in.read(ell.bits));
        sml = eml.base + uint32_t(in.read(eml.bits));
        sof = eof.base + uint32_t(in.read(eof.bits));
      }
      if (in.overflowed()) FAIL(at, "sequence bitstream ends early (sequence %zu of %zu)", i, nseq);
      uint64_t offset;
      if (ofv > 3) {
        offset = ofv - 3;
        fs.rep[2] = fs.rep[1];
        fs.rep[1] = fs.rep[0];
        fs.rep[0] = uint32_t(offset);
      } else {
        int idx = int(ofv) - 1 + (ll == 0 ? 1 : 0);
        if (idx == 0) {
          offset = fs.rep[0];
        } else {
          offset = idx == 3 ? uint64_t(fs.rep[0]) - 1 : fs.rep[idx];
          if (idx >= 2) fs.rep[2] = fs.rep[1];
          fs.rep[1] = fs.rep[0];
          fs.rep[0] = uint32_t(offset);
        }
      }
      if (ll > lits.size() - lit_pos)
        FAIL(at, "sequence %zu takes %zu literals, %zu are left", i, ll, lits.size() - lit_pos);
      out.reserve(ll + ml, at);
      std::memcpy(out.p + out.len, lits.data() + lit_pos, ll);
      out.len += ll;
      lit_pos += ll;
      if (offset == 0 || offset > out.len - frame_start)
        FAIL(at, "sequence %zu: offset %llu reaches before the frame's start", i,
             (unsigned long long)offset);
      uint8_t* dst = out.p + out.len;
      const uint8_t* from = dst - offset;
      if (offset >= ml) {
        std::memcpy(dst, from, ml);
      } else {
        for (size_t j = 0; j < ml; ++j) dst[j] = from[j];
      }
      out.len += ml;
    }
    if (in.pos != 0) FAIL(at, "sequence bitstream holds %lld unread bits", (long long)in.pos);
    size_t rest = lits.size() - lit_pos;
    out.reserve(rest, at);
    std::memcpy(out.p + out.len, lits.data() + lit_pos, rest);
    out.len += rest;
    if (out.len - block_start > block_max)
      FAIL(off, "block decodes to %zu bytes, above its maximum %zu", out.len - block_start,
           block_max);
  }

  // Decodes one frame starting at src[pos]; returns the position after it.
  size_t frame(size_t pos) {
    size_t start = pos;
    if (n - pos < 6) FAIL(pos, "frame header cut short");
    uint8_t fhd = src[pos + 4];
    pos += 5;
    int fcs_flag = fhd >> 6;
    bool single = (fhd >> 5) & 1;
    if (fhd & 8) FAIL(start + 4, "reserved bit set in the frame header");
    bool checksum = (fhd >> 2) & 1;
    int dict_flag = fhd & 3;
    uint64_t window = 0;
    if (!single) {
      uint8_t wd = src[pos++];
      int wlog = 10 + (wd >> 3);
      uint64_t wbase = uint64_t(1) << wlog;
      window = wbase + (wbase / 8) * (wd & 7);
    }
    static const int kDictSize[4] = {0, 1, 2, 4};
    int dsize = kDictSize[dict_flag];
    int fsize = fcs_flag == 0 ? (single ? 1 : 0) : (1 << fcs_flag);
    if (n - pos < size_t(dsize + fsize)) FAIL(pos, "frame header cut short");
    uint64_t dict_id = load_le(src + pos, dsize);
    if (dict_id != 0)
      fail_status(kUnsupported, pos,
                  "frame needs dictionary %llu: dictionaries are not supported",
                  (unsigned long long)dict_id);
    pos += dsize;
    bool has_size = fsize > 0;
    uint64_t content = load_le(src + pos, fsize);
    if (fsize == 2) content += 256;
    pos += fsize;
    if (single) window = content;
    size_t block_max = size_t(std::min<uint64_t>(window, kBlockMax));
    // a damaged header may claim any size: reserve no more than the input
    // could plausibly expand to, and grow past it as blocks decode
    if (has_size && out.grow)
      out.reserve(size_t(std::min<uint64_t>(content, 32 * uint64_t(n) + 65536)), start);
    size_t frame_out = out.len;
    FrameState fs;
    while (true) {
      if (n - pos < 3) FAIL(pos, "block header cut short");
      uint32_t bh = uint32_t(load_le(src + pos, 3));
      size_t bpos = pos;
      pos += 3;
      bool last = bh & 1;
      int type = (bh >> 1) & 3;
      size_t bsize = bh >> 3;
      if (type == 3) FAIL(bpos, "reserved block type");
      if (type == 1) {
        if (bsize > block_max) FAIL(bpos, "RLE block of %zu bytes above its maximum", bsize);
        if (n - pos < 1) FAIL(pos, "RLE block cut short");
        out.reserve(bsize, bpos);
        std::memset(out.p + out.len, src[pos], bsize);
        out.len += bsize;
        pos += 1;
      } else {
        if (bsize > block_max)
          FAIL(bpos, "block of %zu bytes above its maximum %zu", bsize, block_max);
        if (n - pos < bsize) FAIL(bpos, "block of %zu bytes runs past the input", bsize);
        if (type == 0) {
          out.reserve(bsize, bpos);
          std::memcpy(out.p + out.len, src + pos, bsize);
          out.len += bsize;
        } else {
          block_compressed(src + pos, bsize, pos, fs, frame_out, block_max);
        }
        pos += bsize;
      }
      if (last) break;
    }
    size_t produced = out.len - frame_out;
    if (has_size && produced != content)
      FAIL(start, "frame decodes to %zu bytes, its header says %llu", produced,
           (unsigned long long)content);
    if (checksum) {
      if (n - pos < 4) FAIL(pos, "content checksum cut short");
      uint32_t want = uint32_t(load_le(src + pos, 4));
      uint32_t got = uint32_t(xxh64(out.p + frame_out, produced, 0));
      if (want != got)
        FAIL(pos, "content checksum mismatch (frame says %08x, content has %08x)", want, got);
      pos += 4;
    }
    return pos;
  }

  void run() {
    size_t pos = 0;
    if (n == 0) FAIL(0, "empty input");
    while (pos < n) {
      if (n - pos < 4) FAIL(pos, "%zu stray bytes after the last frame", n - pos);
      uint32_t magic = uint32_t(load_le(src + pos, 4));
      if ((magic & kSkippableMask) == kSkippableMagic) {
        if (n - pos < 8) FAIL(pos, "skippable frame header cut short");
        size_t len = size_t(load_le(src + pos + 4, 4));
        if (n - pos - 8 < len) FAIL(pos, "skippable frame runs past the input");
        pos += 8 + len;
      } else if (magic == kFrameMagic) {
        pos = frame(pos);
      } else {
        FAIL(pos, "bad magic number %08x (not a zstd frame)", magic);
      }
    }
  }
};

int run_decoder(const uint8_t* src, size_t n, Output& out, char* msg, int msg_size) {
  try {
    Decoder d{src, n, out};
    d.run();
    return kOk;
  } catch (const Failure& f) {
    std::snprintf(msg, msg_size, "%s", f.message.c_str());
    return f.status;
  } catch (const std::exception&) {
    std::snprintf(msg, msg_size, "out of memory");
    return kInvalid;
  }
}

}  // namespace

extern "C" {

// Decodes every frame in src[0, n) into a new buffer: returns 0 and sets *out
// (release it with zstd_free) and *out_size; 1 for a frame this decoder does
// not take (a dictionary), 2 for damaged input, with a message in msg.
int zstd_decompress(const uint8_t* src, size_t n, uint8_t** out, size_t* out_size, char* msg,
                    int msg_size) {
  *out = nullptr;
  *out_size = 0;
  std::vector<uint8_t> buf;
  Output o{nullptr, 0, 0, &buf};
  int status = run_decoder(src, n, o, msg, msg_size);
  if (status != kOk) return status;
  *out = static_cast<uint8_t*>(std::malloc(o.len ? o.len : 1));
  if (*out == nullptr) {
    std::snprintf(msg, msg_size, "out of memory");
    return kInvalid;
  }
  std::memcpy(*out, o.p, o.len);
  *out_size = o.len;
  return kOk;
}

// Decodes every frame in src[0, n) into dst[0, capacity): returns 0 and sets
// *out_size; 3 when the content is larger than capacity; else as
// zstd_decompress.
int zstd_decompress_into(const uint8_t* src, size_t n, uint8_t* dst, size_t capacity,
                         size_t* out_size, char* msg, int msg_size) {
  Output o{dst, 0, capacity, nullptr};
  int status = run_decoder(src, n, o, msg, msg_size);
  *out_size = status == kOk ? o.len : 0;
  return status;
}

void zstd_free(uint8_t* p) { std::free(p); }

uint64_t zstd_xxh64(const uint8_t* p, size_t n, uint64_t seed) { return xxh64(p, n, seed); }

uint32_t ocdbt_crc32c(const uint8_t* p, size_t n) { return crc32c_update(0, p, n); }

}  // extern "C"
