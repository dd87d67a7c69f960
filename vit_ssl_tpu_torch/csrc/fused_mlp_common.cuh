// Device code shared by kernel B4's two libraries (fused_mlp_fwd.cu,
// fused_mlp_bwd.cu): the exact GELU and its derivative, the ldmatrix
// fragment addresses, and the row kernel that both the forward and the
// backward's first pass run.
//
// The row kernel streams the d_ff axis of a (T, d_model) row tile through
// two products, never holding more than one d_ff chunk of the wide
// activation:
//
//   forward:  pre = x . W1^T + b1 ; h = gelu(pre) [* mask / keep] ;
//             out = h . W2^T + b2
//   backward: dh = do . W2 ; dpre = (dh [* mask / keep]) * gelu'(pre) ;
//             dx = dpre . W1
//
// W1 is (d_ff, d_model) and W2 (d_model, d_ff), the nn.Linear layout. Per
// d_ff chunk the block copies W1's rows [f0, f0 + kChunk) and W2's columns
// [f0, f0 + kChunk) into shared memory; the forward reads the two tiles as
// stored and the backward reads them transposed (ldmatrix.trans), so one
// kernel body serves both.
//
// The kernels are templated on d_model and built for 384, 768 and 1024 (the
// widths of ViT-S, ViT-B and ViT-L). Rows per block and the chunk width
// follow d_model (MlpShape), so that the in tile, the two double-buffered
// weight chunks and the fp32 accumulators fit the block's 227 KB of shared
// memory and 255 registers a thread.
//
// kernels.py rebuilds a library when this header (or the attention header
// it includes for the mma.sync / ldmatrix / cp.async building blocks) is
// newer than it.

#pragma once

#include <type_traits>

#include "attention_nhd_common.cuh"

namespace {

constexpr int kMlpWarps = 8;  // bf16 row kernel: row groups of 16 x d_model splits
constexpr int kMlpThreads = 32 * kMlpWarps;
constexpr int kF32Threads = 256;

// Per d_model: token rows per block and d_ff columns per chunk of the bf16
// row kernel (kRows, kChunk) and of the fp32 one (kF32Rows, kF32Chunk). At
// 384, 64 rows x 32 columns; at 768 and 1024 a 64-row block would need
// 192 or 256 fp32 sums a thread and more than 227 KB, so 32 rows x 16.
template <int D>
struct MlpShape;
template <>
struct MlpShape<384> {
  static constexpr int kRows = 64, kChunk = 32, kF32Rows = 32, kF32Chunk = 32;
};
template <>
struct MlpShape<768> {
  static constexpr int kRows = 32, kChunk = 16, kF32Rows = 16, kF32Chunk = 16;
};
template <>
struct MlpShape<1024> : MlpShape<768> {};

// Calls fn(std::integral_constant<int, D>{}) for a d_model the kernels are
// built for; any other width is cudaErrorInvalidValue.
template <typename Fn>
cudaError_t for_d_model(int d_model, Fn&& fn) {
  switch (d_model) {
    case 384: return fn(std::integral_constant<int, 384>{});
    case 768: return fn(std::integral_constant<int, 768>{});
    case 1024: return fn(std::integral_constant<int, 1024>{});
  }
  return cudaErrorInvalidValue;
}

constexpr float kSqrt2Inv = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

// The JAX package's operation order: x * 0.5 * (1 + erf(x / sqrt 2)).
__device__ __forceinline__ float gelu_exact(float x) {
  return x * 0.5f * (1.f + erff(x * kSqrt2Inv));
}

// d/dx [x Phi(x)] = Phi(x) + x phi(x), in the JAX package's order.
__device__ __forceinline__ float gelu_grad(float x) {
  const float cdf = 0.5f * (1.f + erff(x * kSqrt2Inv));
  const float pdf = kInvSqrt2Pi * expf(-0.5f * x * x);
  return cdf + x * pdf;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

// Rounds to the element type: the identity for fp32.
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16(x); }

// ---------------------------------------------------------------------------
// ldmatrix.x4 fragment addresses. Lane l gives the address of row l & 7 of
// 8x8 matrix l >> 3 of a 16x16 region at (r0, c0) of a row-major shared
// tile. "split rows" puts matrices 0, 1 on rows r0 .. r0 + 15 at column c0
// and 2, 3 at column c0 + 8: mma A fragments of a tile stored [m][k], and B
// fragments (two 8-wide n tiles) of a tile stored [k][n] read with .trans.
// "split cols" puts matrices 0, 1 on columns c0, c0 + 8 of rows r0 .. r0 + 7
// and 2, 3 on rows r0 + 8 .. r0 + 15: B fragments of a tile stored [n][k],
// and A fragments of a tile stored [k][m] read with .trans. The *_rc forms
// give the lane's (row, column), for tiles that are not plainly strided.

__device__ __forceinline__ int2 split_rows_rc(int r0, int c0) {
  const int lane = threadIdx.x & 31;
  return make_int2(r0 + (lane & 7) + 8 * ((lane >> 3) & 1), c0 + 8 * (lane >> 4));
}

__device__ __forceinline__ int2 split_cols_rc(int r0, int c0) {
  const int lane = threadIdx.x & 31;
  return make_int2(r0 + (lane & 7) + 8 * (lane >> 4), c0 + 8 * ((lane >> 3) & 1));
}

__device__ __forceinline__ const bf16* frag_split_rows(const bf16* tile, int stride,
                                                       int r0, int c0) {
  const int2 rc = split_rows_rc(r0, c0);
  return tile + rc.x * stride + rc.y;
}

__device__ __forceinline__ const bf16* frag_split_cols(const bf16* tile, int stride,
                                                       int r0, int c0) {
  const int2 rc = split_cols_rc(r0, c0);
  return tile + rc.x * stride + rc.y;
}

// A 16x16 A fragment from a tile stored [m][k].
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int stride,
                                       int m0, int k0) {
  ldmatrix_x4<false>(a, frag_split_rows(tile, stride, m0, k0));
}

// B fragments of two 8-wide n tiles over 16 k: b[0], b[1] for columns
// n0 .. n0 + 7, b[2], b[3] for n0 + 8 .. n0 + 15. kKN: the tile is stored
// [k][n] (read with .trans); otherwise [n][k].
template <bool kKN>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* tile, int stride,
                                       int k0, int n0) {
  if (kKN)
    ldmatrix_x4<true>(b, frag_split_rows(tile, stride, k0, n0));
  else
    ldmatrix_x4<false>(b, frag_split_cols(tile, stride, n0, k0));
}

// ---------------------------------------------------------------------------
// The row kernel's arguments. Forward: in = x, out = out, pre written when
// the kernel saves it. Backward: in = do, out = dx, pre read, dpre and h
// (the rounded h * mask / keep that dW2 needs) written. mask: (T, d_ff)
// bytes, 0 = dropped, or null. All rows are contiguous.
template <typename T>
struct RowArgs {
  const T* in;
  const T* w1;  // (d_ff, d_model)
  const T* b1;  // (d_ff)    forward only
  const T* w2;  // (d_model, d_ff)
  const T* b2;  // (d_model) forward only
  const uint8_t* mask;
  T* pre;
  T* out;
  T* dpre;  // backward only
  T* h;     // backward only
  int rows;
  int d_ff;
  float keep_prob;
};

// The float32 row kernel's step between the two products for one element,
// d_ff column f of token row `row` (`valid`: row < T): v is the first
// product's fp32 sum. Returns what the second product takes, rounded to T
// as the JAX kernels round it: h in the forward, dpre in the backward. (The
// bfloat16 kernel does the same on pairs of columns, from shared memory.)
template <typename T, bool kBwd, bool kMask, bool kPre>
__device__ __forceinline__ float chunk_epilogue(const RowArgs<T>& p, float v, size_t row,
                                                bool valid, int f, float inv_keep) {
  const size_t at = row * p.d_ff + f;
  float scale = 1.f;
  if (kMask) scale = valid && p.mask[at] ? inv_keep : 0.f;
  if (!kBwd) {
    v += to_float(p.b1[f]);
    if (kPre && valid) p.pre[at] = from_float<T>(v);
    float h = gelu_exact(v);  // on the unrounded fp32 pre
    if (kMask) h = h * scale;
    return to_float(from_float<T>(h));
  }
  const float pre = valid ? to_float(p.pre[at]) : 0.f;  // the rounded saved pre
  float h = gelu_exact(pre);
  if (kMask) {
    h = h * scale;
    v = v * scale;
  }
  const T dpre = from_float<T>(v * gelu_grad(pre));
  if (valid) {
    p.dpre[at] = dpre;
    p.h[at] = from_float<T>(h);
  }
  return to_float(dpre);
}


// ---------------------------------------------------------------------------
// bfloat16 row kernel, tensor cores (mma.sync m16n8k16, fp32 sums).
//
// One block of 8 warps owns kRows token rows (64 at d_model 384, 32 at 768
// and 1024); warp w takes the 16 rows of row group w % kGroups and is split
// w / kGroups of the kSplits warps that share the group. Per d_ff chunk:
//
// - product 1 (kRows x kChunk over d_model): each warp sums its 16 rows
//   over all kChunk columns but over its split's share of d_model (kSpan),
//   the group's warps hand each other the partial sums through shared
//   memory, and each finishes kKeep of a lane's sums, adding the splits'
//   parts in split order;
// - the epilogue (bias, pre, GELU or GELU', mask) writes the chunk's h (or
//   dpre) to a shared (kRows, kChunk) tile;
// - product 2 (kRows x d_model over kChunk, kRows x d_model / 8 a warp)
//   adds into fp32 accumulators that live across all chunks: 96 a thread
//   at 384 and at 768, 128 at 1024.
//
// The in tile (x or do) stays in shared memory. Each chunk's weight tiles,
// b1 slice, keep-mask bytes and (backward) saved pre are copied with
// cp.async into one of two buffers while the previous chunk computes, so
// the epilogue reads nothing from device memory. With 16-column chunks a
// W2 chunk row is 32 bytes; its two 16-byte halves are stored swapped on
// rows 4 .. 7 of every 8 (an XOR swizzle) instead of padding each row by
// half its size, which would not fit at 1024.

template <int D>
struct RowTile {
  static constexpr int kRows = MlpShape<D>::kRows;
  static constexpr int kChunk = MlpShape<D>::kChunk;
  static constexpr int kGroups = kRows / 16;           // row groups of 16
  static constexpr int kSplits = kMlpWarps / kGroups;  // warps sharing a group
  static constexpr int kSpan = D / kSplits;            // product 1's depth a warp
  static constexpr int kNTiles = kChunk / 8;           // product 1's 8-wide tiles
  static constexpr int kVals = 4 * kNTiles;            // a lane's product-1 sums
  static constexpr int kKeep = kVals / kSplits;        // of them, each warp finishes
  static constexpr bool kSwizzle = kChunk == 16;
  static constexpr int kXStride = D + kBPad;           // tiles [.][d_model]
  static constexpr int kCStride = kChunk + kBPad;      // tiles [.][kChunk]
  static constexpr int kW2Stride = kSwizzle ? kChunk : kCStride;
  // byte offsets into the dynamic shared memory
  static constexpr size_t xs = 0;
  static constexpr size_t w1s = xs + sizeof(bf16) * kRows * kXStride;
  static constexpr size_t w2s = w1s + sizeof(bf16) * 2 * kChunk * kXStride;
  static constexpr size_t hs = w2s + sizeof(bf16) * 2 * D * kW2Stride;
  static constexpr size_t pres = hs + sizeof(bf16) * kRows * kCStride;
  static constexpr size_t b1s = pres + sizeof(bf16) * 2 * kRows * kCStride;
  static constexpr size_t masks = b1s + sizeof(bf16) * 2 * kChunk;
  static constexpr size_t swap = masks + 2 * kRows * kChunk;
  static constexpr size_t bytes = swap + sizeof(float) * kMlpWarps * kVals * 32;
  static_assert(kSplits * kGroups == kMlpWarps && kKeep % 2 == 0 && kKeep >= 2 &&
                    kSpan % 16 == 0 && D % (8 * 16) == 0,
                "the row kernel's tiling does not divide this d_model");
  static_assert(b1s % 16 == 0 && masks % 16 == 0 && swap % 16 == 0,
                "cp.async and float4 need 16-byte aligned buffers");
  static_assert(bytes <= 232448, "more shared memory than a block gets");
};

// Element offset of (row, col) in a W2 chunk tile stored [d][f].
template <int D>
__device__ __forceinline__ int w2_offset(int row, int col) {
  using S = RowTile<D>;
  return row * S::kW2Stride + (S::kSwizzle ? col ^ ((row & 4) << 1) : col);
}

// B fragments of the W2 chunk tile: read as [k = d][n = f] with .trans
// (kKN: backward product 1), or as stored, [n = d][k = f] (forward product
// 2); as load_b.
template <int D, bool kKN>
__device__ __forceinline__ void load_w2(uint32_t (&b)[4], const bf16* tile, int k0, int n0) {
  const int2 rc = kKN ? split_rows_rc(k0, n0) : split_cols_rc(n0, k0);
  ldmatrix_x4<kKN>(b, tile + w2_offset<D>(rc.x, rc.y));
}

__device__ __forceinline__ void bar_group(int id, int threads) {  // one row group's warps
  asm volatile("bar.sync %0, %1;\n" :: "r"(id + 1), "r"(threads) : "memory");
}

template <int D, bool kBwd, bool kMask, bool kPre>
__global__ void __launch_bounds__(kMlpThreads, 1) mlp_rows_bf16(RowArgs<bf16> p) {
  using S = RowTile<D>;
  constexpr int kRows = S::kRows, kChunk = S::kChunk;
  constexpr int kXStride = S::kXStride, kCStride = S::kCStride;
  constexpr int kMTiles = kRows / 16;        // product 2: all rows a warp
  constexpr int kOutCols = D / kMlpWarps;    // and d_model / 8 output columns
  constexpr int kOutTiles = kOutCols / 8;
  extern __shared__ uint4 smem_mlp[];
  char* smem = reinterpret_cast<char*>(smem_mlp);
  bf16* xs = reinterpret_cast<bf16*>(smem + S::xs);
  bf16* w1s = reinterpret_cast<bf16*>(smem + S::w1s);    // [2][kChunk][kXStride]
  bf16* w2s = reinterpret_cast<bf16*>(smem + S::w2s);    // [2][D][kW2Stride]
  bf16* hs = reinterpret_cast<bf16*>(smem + S::hs);      // [kRows][kCStride]
  bf16* pres = reinterpret_cast<bf16*>(smem + S::pres);  // [2][kRows][kCStride]
  bf16* b1s = reinterpret_cast<bf16*>(smem + S::b1s);    // [2][kChunk]
  uint8_t* masks = reinterpret_cast<uint8_t*>(smem + S::masks);  // [2][kRows][kChunk]
  float* swap = reinterpret_cast<float*>(smem + S::swap);        // [warp][kVals][lane]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int group = warp % S::kGroups;  // the row group
  const int m0 = 16 * group;            // its first row in the tile
  const int split = warp / S::kGroups;  // which share of d_model it sums
  const int row0 = blockIdx.x * kRows;
  const int chunks = p.d_ff / kChunk;
  const float inv_keep = 1.f / p.keep_prob;

  // the in tile: kRows rows x D, 16 bytes a copy, rows past T zero
  for (int idx = threadIdx.x; idx < kRows * D / 8; idx += kMlpThreads) {
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    const bool ok = row0 + r < p.rows;
    cp_async16(xs + r * kXStride + c, ok ? p.in + (size_t)(row0 + r) * D + c : p.in, ok);
  }
  // chunk c's copies into buffer c & 1, committed as one group
  auto copy_chunk = [&](int chunk) {
    const int buf = chunk & 1, f0 = chunk * kChunk;
    bf16* w1d = w1s + buf * kChunk * kXStride;
    bf16* w2d = w2s + buf * D * S::kW2Stride;
    for (int idx = threadIdx.x; idx < kChunk * D / 8; idx += kMlpThreads) {
      const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;  // W1 row f0 + r
      cp_async16(w1d + r * kXStride + c, p.w1 + (size_t)(f0 + r) * D + c, true);
    }
    for (int idx = threadIdx.x; idx < D * kChunk / 8; idx += kMlpThreads) {
      const int r = idx / (kChunk / 8), c = (idx % (kChunk / 8)) * 8;  // W2 row r
      cp_async16(w2d + w2_offset<D>(r, c), p.w2 + (size_t)r * p.d_ff + f0 + c, true);
    }
    const int idx = threadIdx.x;
    if (kMask && idx < kRows * kChunk / 16) {  // kChunk / 16 copies a row
      const int r = idx / (kChunk / 16), c = (idx % (kChunk / 16)) * 16;
      const bool ok = row0 + r < p.rows;
      cp_async16(masks + buf * kRows * kChunk + r * kChunk + c,
                 ok ? p.mask + (size_t)(row0 + r) * p.d_ff + f0 + c : p.mask, ok);
    }
    if (kBwd && idx < kRows * kChunk / 8) {  // kChunk / 8 copies a row
      const int r = idx / (kChunk / 8), c = (idx % (kChunk / 8)) * 8;
      const bool ok = row0 + r < p.rows;
      cp_async16(pres + buf * kRows * kCStride + r * kCStride + c,
                 ok ? p.pre + (size_t)(row0 + r) * p.d_ff + f0 + c : p.pre, ok);
    }
    if (!kBwd && idx < kChunk / 8)
      cp_async16(b1s + buf * kChunk + idx * 8, p.b1 + f0 + idx * 8, true);
    cp_async_commit();
  };
  copy_chunk(0);  // one group with the in tile

  float acc[kMTiles][kOutTiles][4] = {};

  for (int chunk = 0; chunk < chunks; ++chunk) {
    const int buf = chunk & 1;
    cp_async_wait<0>();
    __syncthreads();  // chunk's data is in; every warp is done with chunk - 1
    if (chunk + 1 < chunks) copy_chunk(chunk + 1);  // into the buffer chunk - 1 used
    const bf16* w1t = w1s + buf * kChunk * kXStride;  // [f][d]
    const bf16* w2t = w2s + buf * D * S::kW2Stride;   // [d][f]

    // product 1: rows m0 .. +15, all kChunk columns, this split's span of D
    float c1[S::kNTiles][4] = {};
#pragma unroll 4
    for (int k0 = split * S::kSpan; k0 < (split + 1) * S::kSpan; k0 += 16) {
      uint32_t a[4], b[S::kNTiles / 2][4];
      load_a(a, xs, kXStride, m0, k0);
#pragma unroll
      for (int nb = 0; nb < S::kNTiles / 2; ++nb) {
        if (kBwd)
          load_w2<D, true>(b[nb], w2t, k0, 16 * nb);         // W2: [k = d][n = f]
        else
          load_b<false>(b[nb], w1t, kXStride, k0, 16 * nb);  // W1: [n = f][k = d]
      }
#pragma unroll
      for (int nb = 0; nb < S::kNTiles / 2; ++nb) {
        mma_bf16(c1[2 * nb], a, b[nb][0], b[nb][1]);
        mma_bf16(c1[2 * nb + 1], a, b[nb][2], b[nb][3]);
      }
    }
    // sums kKeep * split .. +kKeep - 1 of the lane's kVals are this warp's
    // to finish: hand the others to their warps, then add the splits'
    // parts in split order (selects, not indexing by split: c1 stays in
    // registers)
#pragma unroll
    for (int v = 0; v < S::kVals; ++v)
      if (v / S::kKeep != split) swap[(warp * S::kVals + v) * 32 + lane] = c1[v / 4][v % 4];
    bar_group(group, 32 * S::kSplits);
    float own[S::kKeep];
#pragma unroll
    for (int i = 0; i < S::kKeep; ++i) {
      float sum = 0.f;
#pragma unroll
      for (int s = 0; s < S::kSplits; ++s) {
        float x = 0.f;
        if (s == split) {
#pragma unroll
          for (int o = 0; o < S::kSplits; ++o)
            if (o == split) x = c1[(o * S::kKeep + i) / 4][(o * S::kKeep + i) % 4];
        } else {
          const int from = group + S::kGroups * s;  // that split's warp
          x = swap[(from * S::kVals + split * S::kKeep + i) * 32 + lane];
        }
        sum = s == 0 ? x : sum + x;
      }
      own[i] = sum;
    }

    // the epilogue on the kept sums, a pair of columns at a time
#pragma unroll
    for (int i = 0; i < S::kKeep / 2; ++i) {
      const int v = split * S::kKeep + 2 * i;  // tile v / 4, row half (v % 4) / 2
      const int r = m0 + g + 8 * ((v % 4) / 2);
      const int col = 8 * (v / 4) + 2 * t;
      const bool valid = row0 + r < p.rows;
      const size_t at = (size_t)(row0 + r) * p.d_ff + chunk * kChunk + col;
      float v0 = own[2 * i], v1 = own[2 * i + 1];
      float s0 = 1.f, s1 = 1.f;
      if (kMask) {
        const uint8_t* m = masks + buf * kRows * kChunk + r * kChunk + col;
        s0 = m[0] ? inv_keep : 0.f;
        s1 = m[1] ? inv_keep : 0.f;
      }
      uint32_t next;  // what product 2 takes: h (forward) or dpre (backward)
      if (!kBwd) {
        v0 += __bfloat162float(b1s[buf * kChunk + col]);
        v1 += __bfloat162float(b1s[buf * kChunk + col + 1]);
        if (kPre && valid)
          *reinterpret_cast<uint32_t*>(p.pre + at) = pack_bf16(v0, v1);
        float h0 = gelu_exact(v0), h1 = gelu_exact(v1);  // on the unrounded pre
        if (kMask) {
          h0 = h0 * s0;
          h1 = h1 * s1;
        }
        next = pack_bf16(h0, h1);
      } else {
        const uint32_t pr = ld32(pres + buf * kRows * kCStride + r * kCStride + col);
        const float p0 = bf16_lo(pr), p1 = bf16_hi(pr);  // the rounded saved pre
        float h0 = gelu_exact(p0), h1 = gelu_exact(p1);
        if (kMask) {
          h0 = h0 * s0;
          h1 = h1 * s1;
          v0 = v0 * s0;
          v1 = v1 * s1;
        }
        next = pack_bf16(v0 * gelu_grad(p0), v1 * gelu_grad(p1));
        if (valid) {
          *reinterpret_cast<uint32_t*>(p.dpre + at) = next;
          *reinterpret_cast<uint32_t*>(p.h + at) = pack_bf16(h0, h1);
        }
      }
      *reinterpret_cast<uint32_t*>(hs + r * kCStride + col) = next;
    }
    __syncthreads();  // the chunk's h (or dpre) tile is complete

    // product 2: all rows, output columns kOutCols warp .. +kOutCols - 1,
    // over the chunk
#pragma unroll
    for (int k0 = 0; k0 < kChunk; k0 += 16) {
      uint32_t a[kMTiles][4];
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) load_a(a[mt], hs, kCStride, 16 * mt, k0);
#pragma unroll
      for (int nb = 0; nb < kOutTiles / 2; ++nb) {
        const int n0 = kOutCols * warp + 16 * nb;
        uint32_t b[4];
        if (kBwd)
          load_b<true>(b, w1t, kXStride, k0, n0);  // W1 as stored: [k = f][n = d]
        else
          load_w2<D, false>(b, w2t, k0, n0);       // W2 as stored: [n = d][k = f]
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) {
          mma_bf16(acc[mt][2 * nb], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * nb + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }

#pragma unroll
  for (int nt = 0; nt < kOutTiles; ++nt) {
    const int col = kOutCols * warp + 8 * nt + 2 * t;
    const float bias0 = kBwd ? 0.f : to_float(p.b2[col]);
    const float bias1 = kBwd ? 0.f : to_float(p.b2[col + 1]);
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = row0 + 16 * mt + g + 8 * hr;
        if (row < p.rows)
          *reinterpret_cast<uint32_t*>(p.out + (size_t)row * D + col) =
              pack_bf16(acc[mt][nt][2 * hr] + bias0, acc[mt][nt][2 * hr + 1] + bias1);
      }
  }
}

// ---------------------------------------------------------------------------
// float32 row kernel, CUDA cores (full fp32 products: TF32 would miss the
// fp32 tolerances). One block of 256 threads owns kRows token rows (32 at
// d_model 384, 16 at 768 and 1024); thread (r, s) = (tid / kSlots, tid %
// kSlots) owns row r and, of each product, the columns s + kSlots j. Per
// chunk the two weight tiles sit in shared memory as [f][d_model] and
// [d_model][f] (the backward transposes them on the copy), so both
// products are dot products along a contiguous row.

template <int D>
struct F32Tile {
  static constexpr int kRows = MlpShape<D>::kF32Rows;
  static constexpr int kChunk = MlpShape<D>::kF32Chunk;
  static constexpr int kSlots = kF32Threads / kRows;  // threads a row
  static constexpr int kXStride = D + 4;              // float4 rows, 4 banks apart
  static constexpr int kCStride = kChunk + 4;
  static constexpr size_t bytes = sizeof(float) * ((size_t)kRows * kXStride  // in tile
                                                   + (size_t)kChunk * kXStride  // [f][d]
                                                   + (size_t)D * kCStride       // [d][f]
                                                   + (size_t)kRows * kCStride);  // h / dpre
  static_assert(D % kSlots == 0 && kChunk % kSlots == 0, "columns split unevenly");
  static_assert(bytes <= 232448, "more shared memory than a block gets");
};

template <int N, int K, int kSlots>
__device__ __forceinline__ void dot_rows_f32(float (&acc)[N], const float* a,
                                             const float* rows, int stride, int s) {
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + k);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float4 y =
          *reinterpret_cast<const float4*>(rows + (s + kSlots * j) * stride + k);
      acc[j] = fmaf(x.x, y.x, acc[j]);
      acc[j] = fmaf(x.y, y.y, acc[j]);
      acc[j] = fmaf(x.z, y.z, acc[j]);
      acc[j] = fmaf(x.w, y.w, acc[j]);
    }
  }
}

template <int D, bool kBwd, bool kMask, bool kPre>
__global__ void __launch_bounds__(kF32Threads) mlp_rows_f32(RowArgs<float> p) {
  using S = F32Tile<D>;
  constexpr int kRows = S::kRows, kChunk = S::kChunk, kSlots = S::kSlots;
  constexpr int kXStride = S::kXStride, kCStride = S::kCStride;
  constexpr int kOut = D / kSlots;  // output columns a thread
  extern __shared__ float4 smem_mlp_f32[];
  float* xs = reinterpret_cast<float*>(smem_mlp_f32);
  float* wf = xs + kRows * kXStride;  // [kChunk][kXStride]
  float* wd = wf + kChunk * kXStride;  // [D][kCStride]
  float* hs = wd + D * kCStride;       // [kRows][kCStride]

  const int r = threadIdx.x / kSlots, s = threadIdx.x % kSlots;
  const int row0 = blockIdx.x * kRows;
  const size_t row = (size_t)(row0 + r);
  const bool valid = row0 + r < p.rows;
  const float inv_keep = 1.f / p.keep_prob;

  for (int idx = threadIdx.x; idx < kRows * D / 4; idx += kF32Threads) {
    const int rr = idx / (D / 4), c = (idx % (D / 4)) * 4;
    const float4 v = row0 + rr < p.rows
                         ? *reinterpret_cast<const float4*>(p.in + (size_t)(row0 + rr) * D + c)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(xs + rr * kXStride + c) = v;
  }

  float acc[kOut];
#pragma unroll
  for (int j = 0; j < kOut; ++j) acc[j] = 0.f;

  for (int f0 = 0; f0 < p.d_ff; f0 += kChunk) {
    __syncthreads();  // the previous chunk's tiles are consumed
    for (int idx = threadIdx.x; idx < kChunk * D / 4; idx += kF32Threads) {
      // W1 rows f0 .. : forward [f][d] as stored, backward [d][f]
      const int f = idx / (D / 4), d = (idx % (D / 4)) * 4;
      const float4 v = *reinterpret_cast<const float4*>(p.w1 + (size_t)(f0 + f) * D + d);
      if (kBwd) {
        wd[(d + 0) * kCStride + f] = v.x;
        wd[(d + 1) * kCStride + f] = v.y;
        wd[(d + 2) * kCStride + f] = v.z;
        wd[(d + 3) * kCStride + f] = v.w;
      } else {
        *reinterpret_cast<float4*>(wf + f * kXStride + d) = v;
      }
    }
    for (int idx = threadIdx.x; idx < D * kChunk / 4; idx += kF32Threads) {
      // W2 columns f0 .. : forward [d][f] as stored, backward [f][d]
      const int d = idx / (kChunk / 4), f = (idx % (kChunk / 4)) * 4;
      const float4 v = *reinterpret_cast<const float4*>(p.w2 + (size_t)d * p.d_ff + f0 + f);
      if (kBwd) {
        wf[(f + 0) * kXStride + d] = v.x;
        wf[(f + 1) * kXStride + d] = v.y;
        wf[(f + 2) * kXStride + d] = v.z;
        wf[(f + 3) * kXStride + d] = v.w;
      } else {
        *reinterpret_cast<float4*>(wd + d * kCStride + f) = v;
      }
    }
    __syncthreads();

    float c1[kChunk / kSlots];
#pragma unroll
    for (int j = 0; j < kChunk / kSlots; ++j) c1[j] = 0.f;
    dot_rows_f32<kChunk / kSlots, D, kSlots>(c1, xs + r * kXStride, wf, kXStride, s);
#pragma unroll
    for (int j = 0; j < kChunk / kSlots; ++j) {
      const int col = s + kSlots * j;
      hs[r * kCStride + col] = chunk_epilogue<float, kBwd, kMask, kPre>(
          p, c1[j], row, valid, f0 + col, inv_keep);
    }
    __syncthreads();
    dot_rows_f32<kOut, kChunk, kSlots>(acc, hs + r * kCStride, wd, kCStride, s);
  }

  if (valid) {
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const int col = s + kSlots * j;
      p.out[row * D + col] = acc[j] + (kBwd ? 0.f : p.b2[col]);
    }
  }
}

}  // namespace
