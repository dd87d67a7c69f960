// The float32 attention forward of kernels B1 and B3, inference and
// training, for Hopper (sm_90a): the kernel body on the CUDA cores,
// templated on the layout (kHeadMajor, attention_nhd_common.cuh::
// head_rows). attention_nhd_fwd.cu instantiates it for B1's (B, N, H*D)
// layout, fused_attention.cu for B3's (B, H, N, D) layout; the C entry
// points live there. bfloat16 runs the Hopper body of both kernels
// (attention_fwd_sm90.cuh: wgmma, TMA). Per head:
//
//   s  = (q_h . k_h^T) * scale            fp32 products and sums
//   s  = -inf where i/bs != j/bs          only when block_size > 0 (B1)
//   p  = exp(s - rowmax(s)) ; l = rowsum(p)   fp32
//   pn = p / l
//   o  = pn . v_h                         fp32 accumulation
//
// Keys at or past n are never kept (the TPU kernels pad N and set the
// padded keys to -inf; here the ragged edge is masked in the kernel and
// nothing is padded in memory).
//
// Softmax statistics (training entries): stats is fp32 (B, H, Np, 2) with
// Np = round_up(N, 64); [b, h, i] holds (m, 1/l), m the row max of the
// scaled, masked scores and l the row sum of exp(s - m). The backward
// (attention_bwd.cuh) recomputes the scores with the same instructions
// (dot8_f32) and rebuilds p from (m, 1/l). Rows at or past N are not
// written: the caller zero-fills stats, and (m, 1/l) = (0, 0) makes those
// rows' probabilities zero. With and without statistics the kernel is the
// same, and so is its output, bit for bit.
//
// The products must stay full fp32 (TF32 would miss the 1e-5 tolerance),
// so they run on the CUDA cores. One block of 8 warps owns 32 query rows,
// keeps their fp32 score rows (N <= 1024) in shared memory, streams K and
// then V through a 64-row shared tile, and does the softmax between the
// two passes; the (N, N) scores never leave the chip.
//
// kernels.py rebuilds a library when this header is newer than it.

#pragma once

#include "attention_nhd_common.cuh"

namespace {

constexpr int kQTile = 32;  // query rows per block

static_assert(kThreads == kQTile * 8, "8 threads per query row");

template <int D>
size_t smem_bytes_f32(int n) {
  return sizeof(float) * ((size_t)(kQTile + kKTile) * (D + kPad) +
                          (size_t)kQTile * (round_up(n, kKTile) + kPad));
}

// grid (ceil(n / kQTile), heads, batch), kThreads threads. stats may be null.
template <int D, bool kHeadMajor>
__global__ void __launch_bounds__(kThreads)
    attention_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, float* __restrict__ o,
                             float2* __restrict__ stats, int n, int heads,
                             float scale, int block_size) {
  static_assert(D % 32 == 0, "head_dim must be a multiple of 32");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n_keys = round_up(n, kKTile);
  const int s_stride = n_keys + kPad;
  float* qs = smem;                      // [kQTile][D + kPad]
  float* kv = qs + kQTile * (D + kPad);  // [kKTile][D + kPad], K then V
  float* s = kv + kKTile * (D + kPad);   // [kQTile][s_stride] scores / probs

  const int q0 = blockIdx.x * kQTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const HeadRows rows = head_rows<kHeadMajor, D>(b, h, n, heads);
  const size_t base = rows.base;
  const int stride = rows.stride;
  const int t = threadIdx.x;
  const int r = t >> 3;    // this thread's query row in the tile
  const int sub = t & 7;   // its lane among the row's 8 threads
  const int i = q0 + r;    // global query index
  const Span span = key_span(i, n, block_size);

  load_tile_f32<D>(qs, q + base, q0, kQTile, n, stride);

  // Pass 1: scores. Thread (r, sub) owns columns sub + 8j of each key tile;
  // the 8 key rows a quarter-warp reads are 4 banks apart (no conflicts).
  const float* qrow = qs + r * (D + kPad);
  for (int k0 = 0; k0 < n_keys; k0 += kKTile) {
    __syncthreads();  // the Q tile is in; the previous K tile is consumed
    load_tile_f32<D>(kv, k + base, k0, kKTile, n, stride);
    __syncthreads();
    float acc[8];
    dot8_f32<D>(acc, qrow, kv, sub);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = k0 + sub + 8 * j;
      s[r * s_stride + col] = span.has(col) ? acc[j] * scale : -INFINITY;
    }
  }
  __syncthreads();

  // Pass 2: softmax, one warp per row, normalised in place. Padded query
  // rows (i >= n) get p = 0; their output is never stored.
  {
    const int warp = t >> 5, lane = t & 31;
    for (int row = warp; row < kQTile; row += kThreads / 32) {
      float* sr = s + row * s_stride;
      if (q0 + row >= n) {
        for (int c = lane; c < n_keys; c += 32) sr[c] = 0.f;
        continue;
      }
      float m = -INFINITY;
      for (int c = lane; c < n_keys; c += 32) m = fmaxf(m, sr[c]);
      m = warp_max(m);  // finite: column i is always kept
      float l = 0.f;
      for (int c = lane; c < n_keys; c += 32) {
        const float e = expf(sr[c] - m);
        sr[c] = e;
        l += e;
      }
      l = warp_sum(l);
      for (int c = lane; c < n_keys; c += 32) sr[c] /= l;
      if (stats != nullptr && lane == 0)
        stats[((size_t)b * heads + h) * n_keys + q0 + row] = make_float2(m, 1.f / l);
    }
  }

  // Pass 3: o = p . v. Thread (r, sub) owns output columns 4*(sub + 8jj)
  // .. +3; a quarter-warp reads 128 contiguous bytes of one V row.
  constexpr int kVec = D / 32;
  float4 acc[kVec];
#pragma unroll
  for (int jj = 0; jj < kVec; ++jj) acc[jj] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* prow = s + r * s_stride;
  for (int k0 = 0; k0 < n_keys; k0 += kKTile) {
    __syncthreads();  // softmax done; the previous V tile is consumed
    load_tile_f32<D>(kv, v + base, k0, kKTile, n, stride);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kKTile; ++c) {
      const float p = prow[k0 + c];
      const float4* vrow = reinterpret_cast<const float4*>(kv + c * (D + kPad));
#pragma unroll
      for (int jj = 0; jj < kVec; ++jj) {
        const float4 vv = vrow[sub + 8 * jj];
        acc[jj].x = fmaf(p, vv.x, acc[jj].x);
        acc[jj].y = fmaf(p, vv.y, acc[jj].y);
        acc[jj].z = fmaf(p, vv.z, acc[jj].z);
        acc[jj].w = fmaf(p, vv.w, acc[jj].w);
      }
    }
  }
  if (i < n) {
    float4* orow = reinterpret_cast<float4*>(o + base + (size_t)i * stride);
#pragma unroll
    for (int jj = 0; jj < kVec; ++jj) orow[sub + 8 * jj] = acc[jj];
  }
}

// ---------------------------------------------------------------------------
// launch

template <int D, bool kHeadMajor>
cudaError_t fwd_launch(const void* q, const void* k, const void* v, void* o,
                       void* stats, int batch, int n, int heads, float scale,
                       int block_size, cudaStream_t stream) {
  const size_t smem = smem_bytes_f32<D>(n);
  auto kernel = attention_fwd_f32_kernel<D, kHeadMajor>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kQTile - 1) / kQTile, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float2*>(stats), n, heads, scale, block_size);
  return cudaGetLastError();
}

// Checks the sizes, then launches the float32 body for the head dim;
// returns a cudaError_t.
template <bool kHeadMajor>
int fwd_dispatch(const void* q, const void* k, const void* v, void* o, void* stats,
                 int batch, int n, int heads, int head_dim, float scale, int block_size,
                 void* stream) {
  if (n < 1 || n > kMaxSeq || batch < 1 || heads < 1 || block_size < 0 ||
      batch > 65535 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return (int)fwd_launch<32, kHeadMajor>(q, k, v, o, stats, batch, n, heads, scale,
                                             block_size, s);
    case 64:
      return (int)fwd_launch<64, kHeadMajor>(q, k, v, o, stats, batch, n, heads, scale,
                                             block_size, s);
    case 128:
      return (int)fwd_launch<128, kHeadMajor>(q, k, v, o, stats, batch, n, heads, scale,
                                              block_size, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
