// A PNG decoder for the host, from memory to RGB uint8 (H, W, 3) rows, equal
// bit for bit to the port's numpy decoder (vit_ssl_tpu_torch/data/png.py,
// decode_bytes_plain) and so to the reader it names:
//   - reference 0, "cv2": cv2.imread(path, IMREAD_COLOR) then BGR -> RGB (the
//     JAX package's dataset reader): 16-bit samples keep their high byte, the
//     eXIf chunk's orientation is applied;
//   - reference 1, "pil": Image.open(path).convert("RGB") (its server's):
//     16-bit grey is clipped to 255, no orientation.
// Under both, grey is replicated, a palette expanded (an index past the
// palette reads black), alpha dropped and no gamma or colour chunk applied.
//
// Every colour type and bit depth of the PNG specification: grey (1, 2, 4, 8
// and 16 bits), RGB (8, 16), palette (1, 2, 4, 8), grey with alpha and RGBA
// (8, 16), interlaced (Adam7: seven passes, each unfiltered on its own) or
// not. The chunk walk checks every CRC-32 up to IEND; the IDAT chunks are
// inflated by inflate.cpp; the five row filters are undone row by row in
// place. A damaged file fails (status 2) with the numpy decoder's message.
//
// It uses the C++ standard library only and keeps no global state but the CRC
// table, so any number of threads may decode at once. The plain C interface
// is bound with ctypes (data/png.py), which releases the GIL.

#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <new>
#include <string>
#include <vector>

#include "host_image.h"

namespace {

constexpr int kOk = 0, kInvalid = 2;
constexpr uint8_t kSignature[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
// Adam7's passes: first row, first column, row step, column step
constexpr int kAdam7[7][4] = {{0, 0, 8, 8}, {0, 4, 8, 8}, {4, 0, 8, 4}, {0, 2, 4, 4},
                              {2, 0, 4, 2}, {0, 1, 2, 2}, {1, 0, 2, 1}};

struct Failure {
  std::string message;
};

[[noreturn]] void fail(const std::string& message) { throw Failure{message}; }

// CRC-32 (ISO 3309, as zlib.crc32), eight bytes a step ("slicing by 8")
struct CrcTable {
  uint32_t t[8][256];
  CrcTable() {
    for (uint32_t n = 0; n < 256; ++n) {
      uint32_t c = n;
      for (int k = 0; k < 8; ++k) c = c & 1 ? 0xedb88320u ^ (c >> 1) : c >> 1;
      t[0][n] = c;
    }
    for (uint32_t n = 0; n < 256; ++n)
      for (int k = 1; k < 8; ++k) t[k][n] = t[0][t[k - 1][n] & 0xff] ^ (t[k - 1][n] >> 8);
  }
};

uint32_t crc32(const uint8_t* p, size_t n) {
  static const CrcTable table;
  const auto& t = table.t;
  uint32_t c = 0xffffffffu;
  for (; n >= 8; n -= 8, p += 8) {
    const uint32_t lo = c ^ (p[0] | p[1] << 8 | p[2] << 16 | static_cast<uint32_t>(p[3]) << 24);
    c = t[7][lo & 0xff] ^ t[6][(lo >> 8) & 0xff] ^ t[5][(lo >> 16) & 0xff] ^ t[4][lo >> 24] ^
        t[3][p[4]] ^ t[2][p[5]] ^ t[1][p[6]] ^ t[0][p[7]];
  }
  for (; n; --n, ++p) c = t[0][(c ^ *p) & 0xff] ^ (c >> 8);
  return c ^ 0xffffffffu;
}

uint32_t be32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) << 24 | p[1] << 16 | p[2] << 8 | p[3];
}

// Python's repr of a bytes object, as the numpy decoder's messages print a
// chunk type
std::string bytes_repr(const uint8_t* p, size_t n) {
  bool single = false, dbl = false;
  for (size_t i = 0; i < n; ++i) {
    single |= p[i] == '\'';
    dbl |= p[i] == '"';
  }
  const char quote = single && !dbl ? '"' : '\'';
  std::string out = "b";
  out += quote;
  for (size_t i = 0; i < n; ++i) {
    const uint8_t c = p[i];
    char buf[8];
    if (c == quote || c == '\\') {
      out += '\\';
      out += static_cast<char>(c);
    } else if (c == '\t') {
      out += "\\t";
    } else if (c == '\n') {
      out += "\\n";
    } else if (c == '\r') {
      out += "\\r";
    } else if (c < 0x20 || c >= 0x7f) {
      std::snprintf(buf, sizeof buf, "\\x%02x", c);
      out += buf;
    } else {
      out += static_cast<char>(c);
    }
  }
  out += quote;
  return out;
}

struct Chunk {
  const uint8_t* kind;
  const uint8_t* body;
  uint32_t length;
  bool is(const char* name) const { return std::memcmp(kind, name, 4) == 0; }
};

struct Pass {
  int y0, x0, dy, dx, rows, cols;
  size_t start, row_bytes;  // where its rows start in the inflated data; bytes a row
};

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t size, bool pil) : data_(data), size_(size), pil_(pil) {}

  std::vector<uint8_t> run(int* out_h, int* out_w) {
    walk_chunks();
    header();
    // the image data: the one IDAT chunk's body in place, or the chunks joined
    std::vector<uint8_t> joined;
    const uint8_t* idat = nullptr;
    size_t idat_size = 0;
    int idat_chunks = 0;
    for (const Chunk& c : chunks_) {
      if (!c.is("IDAT")) continue;
      if (idat_chunks++ == 0) idat = c.body;
      idat_size += c.length;
    }
    if (idat_size == 0) fail("PNG file holds no IDAT chunk");
    if (idat_chunks > 1) {
      joined.reserve(idat_size);
      for (const Chunk& c : chunks_)
        if (c.is("IDAT")) joined.insert(joined.end(), c.body, c.body + c.length);
      idat = joined.data();
    }
    const int bits = channels_ * depth_;
    size_t needed = 0;
    for (Pass& p : passes()) {
      p.row_bytes = (static_cast<size_t>(p.cols) * bits + 7) / 8;
      p.start = needed;
      needed += static_cast<size_t>(p.rows) * (p.row_bytes + 1);
      passes_.push_back(p);
    }
    std::vector<uint8_t> inflated;
    std::string error;
    // room for what the header asks, but no more than DEFLATE's largest
    // ratio (1032:1) gives this stream: a header may claim any size
    const size_t hint = std::min<uint64_t>(needed, 1032ull * idat_size + 1024);
    if (!vitssl::zlib_inflate(idat, idat_size, hint, inflated, error))
      fail("PNG image data does not inflate: " + error);
    if (inflated.size() < needed)
      fail("PNG image data holds " + std::to_string(inflated.size()) + " bytes, " +
           std::to_string(needed) + " needed");
    const int bpp = bits / 8 > 1 ? bits / 8 : 1;
    for (const Pass& p : passes_) unfilter(inflated.data() + p.start, p.rows, p.row_bytes, bpp);
    std::vector<uint8_t> rgb(static_cast<size_t>(height_) * width_ * 3);
    uint8_t palette[256][3] = {};
    if (ctype_ == 3) read_palette(palette);
    for (const Pass& p : passes_) to_rgb(inflated.data() + p.start, p, palette, rgb.data());
    int h = height_, w = width_;
    if (!pil_) {
      for (const Chunk& c : chunks_) {
        if (c.is("eXIf")) {
          vitssl::apply_orientation(rgb, h, w, vitssl::exif_orientation(c.body, c.length));
          break;
        }
      }
    }
    *out_h = h;
    *out_w = w;
    return rgb;
  }

 private:
  void walk_chunks() {
    if (size_ < 8 || std::memcmp(data_, kSignature, 8) != 0)
      fail("not a PNG file (bad signature)");
    size_t pos = 8;
    while (pos + 12 <= size_) {
      const uint32_t length = be32(data_ + pos);
      const uint8_t* kind = data_ + pos + 4;
      if (pos + 12 + static_cast<uint64_t>(length) > size_)
        fail("PNG chunk " + bytes_repr(kind, 4) + " is truncated");
      const uint32_t crc = be32(data_ + pos + 8 + length);
      if (crc32(kind, 4 + static_cast<size_t>(length)) != crc)
        fail("PNG chunk " + bytes_repr(kind, 4) + " fails its CRC");
      chunks_.push_back({kind, data_ + pos + 8, length});
      pos += 12 + static_cast<size_t>(length);
      if (chunks_.back().is("IEND")) return;
    }
    fail("PNG file ends before its IEND chunk");
  }

  void header() {
    if (chunks_.empty() || !chunks_[0].is("IHDR") || chunks_[0].length != 13)
      fail("PNG file does not start with an IHDR chunk");
    const uint8_t* b = chunks_[0].body;
    const uint32_t width = be32(b), height = be32(b + 4);
    depth_ = b[8];
    ctype_ = b[9];
    const int comp = b[10], filt = b[11];
    interlace_ = b[12];
    const int c = ctype_;
    const bool type_ok = c == 0 || c == 2 || c == 3 || c == 4 || c == 6;
    const int d = depth_;
    bool depth_ok = false;
    if (c == 0) depth_ok = d == 1 || d == 2 || d == 4 || d == 8 || d == 16;
    if (c == 3) depth_ok = d == 1 || d == 2 || d == 4 || d == 8;
    if (c == 2 || c == 4 || c == 6) depth_ok = d == 8 || d == 16;
    if (!type_ok || !depth_ok)
      fail("PNG colour type " + std::to_string(c) + " at bit depth " + std::to_string(d) +
           " is invalid");
    if (width == 0 || height == 0 || comp != 0 || filt != 0 || interlace_ > 1)
      fail("PNG header holds an empty size or an unknown method");
    if (width > 0x7fffffffu || height > 0x7fffffffu ||
        static_cast<uint64_t>(width) * height > (1ull << 40))
      throw std::bad_alloc();  // no stream this large inflates in memory
    width_ = static_cast<int>(width);
    height_ = static_cast<int>(height);
    channels_ = c == 0 || c == 3 ? 1 : c == 4 ? 2 : c == 2 ? 3 : 4;
  }

  std::vector<Pass> passes() const {
    std::vector<Pass> out;
    if (!interlace_) {
      out.push_back({0, 0, 1, 1, height_, width_, 0, 0});
      return out;
    }
    for (const auto& a : kAdam7) {
      const int rows = (height_ - a[0] + a[2] - 1) / a[2];
      const int cols = (width_ - a[1] + a[3] - 1) / a[3];
      if (rows > 0 && cols > 0) out.push_back({a[0], a[1], a[2], a[3], rows, cols, 0, 0});
    }
    return out;
  }

  // the row filters of one pass, undone in place: each row is its filter
  // byte, then row_bytes filtered bytes
  static void unfilter(uint8_t* rows, int n, size_t row_bytes, int bpp) {
    int worst = 0;
    for (int y = 0; y < n; ++y) worst = std::max<int>(worst, rows[y * (row_bytes + 1)]);
    if (worst > 4) fail("PNG row filter type " + std::to_string(worst) + " is invalid");
    const size_t stride = row_bytes + 1;
    for (int y = 0; y < n; ++y) {
      uint8_t* row = rows + y * stride + 1;
      const uint8_t* up = y ? rows + (y - 1) * stride + 1 : nullptr;
      switch (row[-1]) {
        case 1:
          for (size_t i = bpp; i < row_bytes; ++i) row[i] = static_cast<uint8_t>(row[i] + row[i - bpp]);
          break;
        case 2:
          if (up)
            for (size_t i = 0; i < row_bytes; ++i) row[i] = static_cast<uint8_t>(row[i] + up[i]);
          break;
        case 3:
          for (size_t i = 0; i < row_bytes; ++i) {
            const int a = i >= static_cast<size_t>(bpp) ? row[i - bpp] : 0;
            const int b = up ? up[i] : 0;
            row[i] = static_cast<uint8_t>(row[i] + ((a + b) >> 1));
          }
          break;
        case 4:
          for (size_t i = 0; i < row_bytes; ++i) {
            const bool left = i >= static_cast<size_t>(bpp);
            const int a = left ? row[i - bpp] : 0;
            const int b = up ? up[i] : 0;
            const int c = up && left ? up[i - bpp] : 0;
            const int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
            const int pred = pa <= pb && pa <= pc ? a : pb <= pc ? b : c;
            row[i] = static_cast<uint8_t>(row[i] + pred);
          }
          break;
        default:
          break;
      }
    }
  }

  void read_palette(uint8_t palette[256][3]) const {
    const Chunk* plte = nullptr;
    for (const Chunk& c : chunks_) {
      if (c.is("PLTE")) {
        plte = &c;
        break;
      }
    }
    if (plte == nullptr || plte->length % 3 || plte->length == 0)
      fail("palette PNG without a valid PLTE chunk");
    const uint32_t entries = std::min<uint32_t>(plte->length / 3, 256);
    std::memcpy(palette, plte->body, entries * 3);
  }

  // one pass's unfiltered rows as RGB, scattered to their places
  void to_rgb(const uint8_t* rows, const Pass& p, const uint8_t palette[256][3],
              uint8_t* rgb) const {
    const size_t stride = p.row_bytes + 1;
    const size_t step = static_cast<size_t>(p.dx) * 3;
    const int ch = channels_, cols = p.cols;
    auto put = [](uint8_t* d, uint8_t r, uint8_t g, uint8_t b) {
      d[0] = r;
      d[1] = g;
      d[2] = b;
    };
    for (int r = 0; r < p.rows; ++r) {
      const uint8_t* s = rows + r * stride + 1;
      uint8_t* d = rgb + (static_cast<size_t>(p.y0 + r * p.dy) * width_ + p.x0) * 3;
      if (depth_ == 16 && ch <= 2) {
        const bool clip = ctype_ == 0 && pil_;  // PIL clips 16-bit grey to 255
        for (int x = 0; x < cols; ++x, d += step, s += 2 * ch) {
          const uint8_t g = clip && s[0] > 0 ? 255 : clip ? s[1] : s[0];  // else the high byte
          put(d, g, g, g);
        }
      } else if (depth_ == 16) {
        for (int x = 0; x < cols; ++x, d += step, s += 2 * ch) put(d, s[0], s[2], s[4]);
      } else if (depth_ < 8) {  // samples most significant first
        const int per_byte = 8 / depth_, mask = (1 << depth_) - 1;
        const int scale = 255 / mask;  // grey to 8 bits, as libpng expands it
        for (int x = 0; x < cols; ++x, d += step) {
          const int shift = 8 - depth_ * (x % per_byte + 1);
          const int sample = (s[x / per_byte] >> shift) & mask;
          if (ctype_ == 3) {
            put(d, palette[sample][0], palette[sample][1], palette[sample][2]);
          } else {
            const uint8_t g = static_cast<uint8_t>(sample * scale);
            put(d, g, g, g);
          }
        }
      } else if (ctype_ == 3) {
        for (int x = 0; x < cols; ++x, d += step, ++s)
          put(d, palette[*s][0], palette[*s][1], palette[*s][2]);
      } else if (ch <= 2) {
        for (int x = 0; x < cols; ++x, d += step, s += ch) put(d, s[0], s[0], s[0]);
      } else {
        for (int x = 0; x < cols; ++x, d += step, s += ch) put(d, s[0], s[1], s[2]);
      }
    }
  }

  const uint8_t* data_;
  size_t size_;
  bool pil_;
  std::vector<Chunk> chunks_;
  std::vector<Pass> passes_;
  int width_ = 0, height_ = 0, depth_ = 0, ctype_ = 0, interlace_ = 0, channels_ = 0;
};

}  // namespace

extern "C" {

// Decode the PNG in data[0, size) to RGB uint8 (height, width, 3) rows as
// reference 0 (cv2) or 1 (pil) reads it. Returns 0 and sets *out (release
// it with png_free), *height and *width; 2 for a damaged or invalid file,
// with the message in msg.
int png_decode(const uint8_t* data, size_t size, int reference, uint8_t** out, int* height,
               int* width, char* msg, int msg_size) {
  *out = nullptr;
  try {
    Decoder d(data, size, reference == 1);
    std::vector<uint8_t> rgb = d.run(height, width);
    *out = static_cast<uint8_t*>(std::malloc(rgb.size()));
    if (*out == nullptr) throw std::bad_alloc();
    std::memcpy(*out, rgb.data(), rgb.size());
    return kOk;
  } catch (const Failure& f) {
    std::snprintf(msg, msg_size, "%s", f.message.c_str());
    return kInvalid;
  } catch (const std::bad_alloc&) {
    std::snprintf(msg, msg_size, "out of memory");
    return kInvalid;
  } catch (const std::exception& e) {  // nothing may cross the C interface
    std::snprintf(msg, msg_size, "%s", e.what());
    return kInvalid;
  }
}

void png_free(uint8_t* p) { std::free(p); }

}  // extern "C"
