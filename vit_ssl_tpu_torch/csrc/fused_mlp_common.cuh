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
// kernels.py rebuilds a library when this header (or the attention header
// it includes for the mma.sync / ldmatrix / cp.async building blocks) is
// newer than it.

#pragma once

#include "attention_nhd_common.cuh"

namespace {

constexpr int kDModel = 384;     // the d_model the row kernels take
constexpr int kChunk = 32;       // d_ff columns per chunk
constexpr int kMlpWarps = 8;     // bf16 row kernel: 4 row groups of 2 warps
constexpr int kMlpThreads = 32 * kMlpWarps;
constexpr int kMlpRows = 64;     // bf16 row kernel: token rows per block
constexpr int kXStride = kDModel + kBPad;  // bf16 row tiles [row][d_model]
constexpr int kCStride = kChunk + kBPad;   // bf16 chunk tiles [.][kChunk]

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
// and A fragments of a tile stored [k][m] read with .trans.

__device__ __forceinline__ const bf16* frag_split_rows(const bf16* tile, int stride,
                                                       int r0, int c0) {
  const int lane = threadIdx.x & 31;
  return tile + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * stride + c0 + 8 * (lane >> 4);
}

__device__ __forceinline__ const bf16* frag_split_cols(const bf16* tile, int stride,
                                                       int r0, int c0) {
  const int lane = threadIdx.x & 31;
  return tile + (r0 + (lane & 7) + 8 * (lane >> 4)) * stride + c0 + 8 * ((lane >> 3) & 1);
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
// One block of 8 warps owns kMlpRows = 64 token rows; warp w takes rows
// 16 (w & 3) .. +15 and is half w >> 2 of its row group. Per d_ff chunk:
//
// - product 1 (64 x kChunk over d_model): each warp of a pair sums its 16
//   rows over all kChunk columns but over its half of d_model (4 mma chains
//   of 12 steps), the pair swaps the partial sums of the columns it does
//   not keep through shared memory, and each keeps 16 columns;
// - the epilogue (bias, pre, GELU or GELU', mask) writes the chunk's h (or
//   dpre) to a shared (64, kChunk) tile;
// - product 2 (64 x d_model over kChunk, 64 x 48 a warp) adds into 96 fp32
//   accumulators a thread that live across all chunks.
//
// The in tile (x or do) stays in shared memory. Each chunk's weight tiles,
// b1 slice, keep-mask bytes and (backward) saved pre are copied with
// cp.async into one of two buffers while the previous chunk computes, so
// the epilogue reads nothing from device memory.

struct RowSmemBf16 {  // byte offsets into the dynamic shared memory
  static constexpr size_t xs = 0;
  static constexpr size_t w1s = xs + sizeof(bf16) * kMlpRows * kXStride;
  static constexpr size_t w2s = w1s + sizeof(bf16) * 2 * kChunk * kXStride;
  static constexpr size_t hs = w2s + sizeof(bf16) * 2 * kDModel * kCStride;
  static constexpr size_t pres = hs + sizeof(bf16) * kMlpRows * kCStride;
  static constexpr size_t b1s = pres + sizeof(bf16) * 2 * kMlpRows * kCStride;
  static constexpr size_t masks = b1s + sizeof(bf16) * 2 * kChunk;
  static constexpr size_t swap = masks + 2 * kMlpRows * kChunk;
  static constexpr size_t bytes = swap + sizeof(float) * kMlpWarps * 32 * 8;
};
static_assert(RowSmemBf16::b1s % 16 == 0 && RowSmemBf16::masks % 16 == 0 &&
                  RowSmemBf16::swap % 16 == 0,
              "cp.async and float4 need 16-byte aligned buffers");

__device__ __forceinline__ void bar_pair(int id) {  // warps id and id + 4
  asm volatile("bar.sync %0, %1;\n" :: "r"(id + 1), "n"(64) : "memory");
}

template <bool kBwd, bool kMask, bool kPre>
__global__ void __launch_bounds__(kMlpThreads, 1) mlp_rows_bf16(RowArgs<bf16> p) {
  using S = RowSmemBf16;
  constexpr int D = kDModel;
  constexpr int kMTiles = kMlpRows / 16;     // product 2: all 64 rows a warp
  constexpr int kOutCols = D / kMlpWarps;    // and 48 output columns
  constexpr int kOutTiles = kOutCols / 8;    // 6 tiles of 8
  extern __shared__ uint4 smem_mlp[];
  char* smem = reinterpret_cast<char*>(smem_mlp);
  bf16* xs = reinterpret_cast<bf16*>(smem + S::xs);
  bf16* w1s = reinterpret_cast<bf16*>(smem + S::w1s);    // [2][kChunk][kXStride]
  bf16* w2s = reinterpret_cast<bf16*>(smem + S::w2s);    // [2][D][kCStride]
  bf16* hs = reinterpret_cast<bf16*>(smem + S::hs);      // [kMlpRows][kCStride]
  bf16* pres = reinterpret_cast<bf16*>(smem + S::pres);  // [2][kMlpRows][kCStride]
  bf16* b1s = reinterpret_cast<bf16*>(smem + S::b1s);    // [2][kChunk]
  uint8_t* masks = reinterpret_cast<uint8_t*>(smem + S::masks);  // [2][kMlpRows][kChunk]
  float* swap = reinterpret_cast<float*>(smem + S::swap);        // [warp][lane][8]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int pair = warp & 3;        // the row group
  const int m0 = 16 * pair;         // its first row in the tile
  const int half = warp >> 2;       // which half of the pair
  const int row0 = blockIdx.x * kMlpRows;
  const int chunks = p.d_ff / kChunk;
  const float inv_keep = 1.f / p.keep_prob;

  // the in tile: 64 rows x D, 16 bytes a copy, rows past T zero
  for (int idx = threadIdx.x; idx < kMlpRows * D / 8; idx += kMlpThreads) {
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    const bool ok = row0 + r < p.rows;
    cp_async16(xs + r * kXStride + c, ok ? p.in + (size_t)(row0 + r) * D + c : p.in, ok);
  }
  // chunk c's copies into buffer c & 1, committed as one group
  auto copy_chunk = [&](int chunk) {
    const int buf = chunk & 1, f0 = chunk * kChunk;
    bf16* w1d = w1s + buf * kChunk * kXStride;
    bf16* w2d = w2s + buf * D * kCStride;
    for (int idx = threadIdx.x; idx < kChunk * D / 8; idx += kMlpThreads) {
      const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;  // W1 row f0 + r
      cp_async16(w1d + r * kXStride + c, p.w1 + (size_t)(f0 + r) * D + c, true);
    }
    for (int idx = threadIdx.x; idx < D * kChunk / 8; idx += kMlpThreads) {
      const int r = idx / (kChunk / 8), c = (idx % (kChunk / 8)) * 8;  // W2 row r
      cp_async16(w2d + r * kCStride + c, p.w2 + (size_t)r * p.d_ff + f0 + c, true);
    }
    const int idx = threadIdx.x;
    if (kMask && idx < kMlpRows * kChunk / 16) {  // 2 copies a row
      const int r = idx / 2, c = (idx % 2) * 16;
      const bool ok = row0 + r < p.rows;
      cp_async16(masks + buf * kMlpRows * kChunk + r * kChunk + c,
                 ok ? p.mask + (size_t)(row0 + r) * p.d_ff + f0 + c : p.mask, ok);
    }
    if (kBwd && idx < kMlpRows * kChunk / 8) {  // 4 copies a row
      const int r = idx / 4, c = (idx % 4) * 8;
      const bool ok = row0 + r < p.rows;
      cp_async16(pres + buf * kMlpRows * kCStride + r * kCStride + c,
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
    const bf16* w2t = w2s + buf * D * kCStride;       // [d][f]

    // product 1: rows m0 .. +15, all kChunk columns, this half of D
    float c1[4][4] = {};
#pragma unroll 4
    for (int k0 = half * D / 2; k0 < (half + 1) * D / 2; k0 += 16) {
      uint32_t a[4], b[2][4];
      load_a(a, xs, kXStride, m0, k0);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        if (kBwd)
          load_b<true>(b[nb], w2t, kCStride, k0, 16 * nb);   // W2: [k = d][n = f]
        else
          load_b<false>(b[nb], w1t, kXStride, k0, 16 * nb);  // W1: [n = f][k = d]
      }
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        mma_bf16(c1[2 * nb], a, b[nb][0], b[nb][1]);
        mma_bf16(c1[2 * nb + 1], a, b[nb][2], b[nb][3]);
      }
    }
    // keep columns 16 half .. +15 (tiles 2 half, 2 half + 1), hand the
    // other two tiles' partial sums to the pair's other warp (selects, not
    // indexing by half: c1 stays in registers)
    float own[2][4], give[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        own[j][e] = half ? c1[2 + j][e] : c1[j][e];
        give[j][e] = half ? c1[j][e] : c1[2 + j][e];
      }
    {
      float4* out = reinterpret_cast<float4*>(swap + ((pair + 4 * (half ^ 1)) * 32 + lane) * 8);
      out[0] = make_float4(give[0][0], give[0][1], give[0][2], give[0][3]);
      out[1] = make_float4(give[1][0], give[1][1], give[1][2], give[1][3]);
      bar_pair(pair);
      const float4* in = reinterpret_cast<const float4*>(swap + (warp * 32 + lane) * 8);
      const float4 u = in[0], v = in[1];
      own[0][0] += u.x; own[0][1] += u.y; own[0][2] += u.z; own[0][3] += u.w;
      own[1][0] += v.x; own[1][1] += v.y; own[1][2] += v.z; own[1][3] += v.w;
    }

#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = m0 + g + 8 * hr;
        const int col = 16 * half + 8 * j + 2 * t;
        const bool valid = row0 + r < p.rows;
        const size_t at = (size_t)(row0 + r) * p.d_ff + chunk * kChunk + col;
        float v0 = own[j][2 * hr], v1 = own[j][2 * hr + 1];
        float s0 = 1.f, s1 = 1.f;
        if (kMask) {
          const uint8_t* m = masks + buf * kMlpRows * kChunk + r * kChunk + col;
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
          const uint32_t pr = ld32(pres + buf * kMlpRows * kCStride + r * kCStride + col);
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
    }
    __syncthreads();  // the chunk's h (or dpre) tile is complete

    // product 2: all 64 rows, output columns 48 warp .. +47, over the chunk
#pragma unroll
    for (int k0 = 0; k0 < kChunk; k0 += 16) {
      uint32_t a[kMTiles][4], b[kOutTiles / 2][4];
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) load_a(a[mt], hs, kCStride, 16 * mt, k0);
#pragma unroll
      for (int nb = 0; nb < kOutTiles / 2; ++nb) {
        const int n0 = kOutCols * warp + 16 * nb;
        if (kBwd)
          load_b<true>(b[nb], w1t, kXStride, k0, n0);   // W1 as stored: [k = f][n = d]
        else
          load_b<false>(b[nb], w2t, kCStride, k0, n0);  // W2 as stored: [n = d][k = f]
      }
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
        for (int nb = 0; nb < kOutTiles / 2; ++nb) {
          mma_bf16(acc[mt][2 * nb], a[mt], b[nb][0], b[nb][1]);
          mma_bf16(acc[mt][2 * nb + 1], a[mt], b[nb][2], b[nb][3]);
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
// fp32 tolerances). One block of 256 threads owns 32 token rows; thread
// (r, s) = (tid / 8, tid % 8) owns row r and, of each product, the columns
// s + 8j. Per chunk the two weight tiles sit in shared memory as
// [f][d_model] and [d_model][f] (the backward transposes them on the copy),
// so both products are dot products along a contiguous row.

constexpr int kF32Rows = 32;
constexpr int kF32Threads = 256;
constexpr int kF32XStride = kDModel + 4;  // float4 rows, 4 banks apart
constexpr int kF32CStride = kChunk + 4;

constexpr size_t row_smem_f32() {
  return sizeof(float) * ((size_t)kF32Rows * kF32XStride      // in tile
                          + (size_t)kChunk * kF32XStride      // [f][d]
                          + (size_t)kDModel * kF32CStride     // [d][f]
                          + (size_t)kF32Rows * kF32CStride);  // h / dpre chunk
}

template <int N, int K>
__device__ __forceinline__ void dot_rows_f32(float (&acc)[N], const float* a,
                                             const float* rows, int stride, int s) {
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + k);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float4 y = *reinterpret_cast<const float4*>(rows + (s + 8 * j) * stride + k);
      acc[j] = fmaf(x.x, y.x, acc[j]);
      acc[j] = fmaf(x.y, y.y, acc[j]);
      acc[j] = fmaf(x.z, y.z, acc[j]);
      acc[j] = fmaf(x.w, y.w, acc[j]);
    }
  }
}

template <bool kBwd, bool kMask, bool kPre>
__global__ void __launch_bounds__(kF32Threads) mlp_rows_f32(RowArgs<float> p) {
  constexpr int D = kDModel;
  constexpr int kOut = D / 8;  // output columns a thread: 48
  extern __shared__ float4 smem_mlp_f32[];
  float* xs = reinterpret_cast<float*>(smem_mlp_f32);
  float* wf = xs + kF32Rows * kF32XStride;  // [kChunk][kF32XStride]
  float* wd = wf + kChunk * kF32XStride;    // [D][kF32CStride]
  float* hs = wd + D * kF32CStride;         // [kF32Rows][kF32CStride]

  const int r = threadIdx.x >> 3, s = threadIdx.x & 7;
  const int row0 = blockIdx.x * kF32Rows;
  const size_t row = (size_t)(row0 + r);
  const bool valid = row0 + r < p.rows;
  const float inv_keep = 1.f / p.keep_prob;

  for (int idx = threadIdx.x; idx < kF32Rows * D / 4; idx += kF32Threads) {
    const int rr = idx / (D / 4), c = (idx % (D / 4)) * 4;
    const float4 v = row0 + rr < p.rows
                         ? *reinterpret_cast<const float4*>(p.in + (size_t)(row0 + rr) * D + c)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(xs + rr * kF32XStride + c) = v;
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
        wd[(d + 0) * kF32CStride + f] = v.x;
        wd[(d + 1) * kF32CStride + f] = v.y;
        wd[(d + 2) * kF32CStride + f] = v.z;
        wd[(d + 3) * kF32CStride + f] = v.w;
      } else {
        *reinterpret_cast<float4*>(wf + f * kF32XStride + d) = v;
      }
    }
    for (int idx = threadIdx.x; idx < D * kChunk / 4; idx += kF32Threads) {
      // W2 columns f0 .. : forward [d][f] as stored, backward [f][d]
      const int d = idx / (kChunk / 4), f = (idx % (kChunk / 4)) * 4;
      const float4 v = *reinterpret_cast<const float4*>(p.w2 + (size_t)d * p.d_ff + f0 + f);
      if (kBwd) {
        wf[(f + 0) * kF32XStride + d] = v.x;
        wf[(f + 1) * kF32XStride + d] = v.y;
        wf[(f + 2) * kF32XStride + d] = v.z;
        wf[(f + 3) * kF32XStride + d] = v.w;
      } else {
        *reinterpret_cast<float4*>(wd + d * kF32CStride + f) = v;
      }
    }
    __syncthreads();

    float c1[kChunk / 8];
#pragma unroll
    for (int j = 0; j < kChunk / 8; ++j) c1[j] = 0.f;
    dot_rows_f32<kChunk / 8, D>(c1, xs + r * kF32XStride, wf, kF32XStride, s);
#pragma unroll
    for (int j = 0; j < kChunk / 8; ++j) {
      const int col = s + 8 * j;
      hs[r * kF32CStride + col] = chunk_epilogue<float, kBwd, kMask, kPre>(
          p, c1[j], row, valid, f0 + col, inv_keep);
    }
    __syncthreads();
    dot_rows_f32<kOut, kChunk>(acc, hs + r * kF32CStride, wd, kF32CStride, s);
  }

  if (valid) {
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const int col = s + 8 * j;
      p.out[row * D + col] = acc[j] + (kBwd ? 0.f : p.b2[col]);
    }
  }
}

}  // namespace
