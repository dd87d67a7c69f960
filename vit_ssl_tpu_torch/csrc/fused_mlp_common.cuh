// Device code shared by kernel B4's two libraries (fused_mlp_fwd.cu,
// fused_mlp_bwd.cu) and kernel P2's (masked_matmul.cu, through
// mlp_gemm_sm90.cuh and weight_grad.cuh): the exact GELU and its
// derivative, and the float32 row kernel that B4's float32 forward and the
// backward's first pass run. The bfloat16 bodies of B4 and P2 are the
// wgmma/TMA products of mlp_gemm_sm90.cuh.
//
// The float32 row kernel streams the d_ff axis of a (T, d_model) row tile
// through two products, never holding more than one d_ff chunk of the wide
// activation:
//
//   forward:  pre = x . W1^T + b1 ; h = gelu(pre) [* mask / keep] ;
//             out = h . W2^T + b2
//   backward: dh = do . W2 ; dpre = (dh [* mask / keep]) * gelu'(pre) ;
//             dx = dpre . W1
//
// W1 is (d_ff, d_model) and W2 (d_model, d_ff), the nn.Linear layout. It is
// templated on d_model and built for 384, 768 and 1024 (the widths of
// ViT-S, ViT-B and ViT-L); rows per block and the chunk width follow
// d_model (MlpShape), so that the in tile and the chunk's weight tiles fit
// the block's 227 KB of shared memory.
//
// kernels.py rebuilds a library when this header (or the attention header
// it includes for bf16 and its packing) is newer than it.

#pragma once

#include <type_traits>

#include "attention_nhd_common.cuh"

namespace {

constexpr int kF32Threads = 256;

// Per d_model: token rows per block and d_ff columns per chunk of the fp32
// row kernel: 32 x 32 at 384, 16 x 16 at 768 and 1024.
template <int D>
struct MlpShape;
template <>
struct MlpShape<384> {
  static constexpr int kF32Rows = 32, kF32Chunk = 32;
};
template <>
struct MlpShape<768> {
  static constexpr int kF32Rows = 16, kF32Chunk = 16;
};
template <>
struct MlpShape<1024> : MlpShape<768> {};

// Calls fn(std::integral_constant<int, D>{}) for a d_model the kernels are
// built for; any other width is cudaErrorInvalidValue. (The bf16 bodies
// take any multiple of 128, and use this as the width check only.)
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

// gelu_exact(x) and gelu_grad(x), bit for bit as those two, from one erff.
struct GeluAndGrad {
  float gelu, grad;
};
__device__ __forceinline__ GeluAndGrad gelu_and_grad(float x) {
  const float e = erff(x * kSqrt2Inv);
  const float pdf = kInvSqrt2Pi * expf(-0.5f * x * x);
  return {x * 0.5f * (1.f + e), 0.5f * (1.f + e) + x * pdf};
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
// The float32 row kernel's arguments. Forward: in = x, out = out, pre written when
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
// as the JAX kernels round it: h in the forward, dpre in the backward.
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
