// Weight gradients summed over token rows, shared by kernel B4's backward
// (fused_mlp_bwd.cu: dW1, db1, dW2, db2) and kernel P2's
// (masked_matmul.cu: dW2, db2).
//
// One product is c (m, n) = a^T . b over the rows, a (rows, m), b (rows,
// n), with bias (m) = the column sums of a. The TPU kernels sum these
// across their sequential grid. Blocks on Hopper run in parallel and in no
// order, so the rows are cut into at most kMaxSplits slices, each block
// writes one tile's fp32 partial sums over one slice, and reduce_splits
// adds the slices in slice order and rounds once: no atomics, and results
// repeat run to run. The bf16 slices are the wgmma/TMA weight products of
// mlp_gemm_sm90.cuh (gemm_splits sets their count); the float32 ones the
// CUDA-core weight kernel here. With kMaskB, b is h and is taken as
// h * mask / keep on its way in (P2's hm; mask (rows, n) bytes, 0 =
// dropped).
//
// kernels.py rebuilds a library when this header is newer than it.

#pragma once

#include "fused_mlp_common.cuh"

namespace {

constexpr int kMaxSplits = 8;  // the rows split into at most this many slices

// Each split writes fp32 partial sums at part (m, n) and part_bias (m),
// offset by its index times the split stride.
template <typename T>
struct WeightProblem {
  const T* a;
  const T* b;
  const uint8_t* mask_b;  // with kMaskB: b's keep-mask
  float* part;
  float* part_bias;
  int m, n;
};

// Block blockIdx.x's kTileMN x kTileMN output tile: the first problem's
// tiles, then the second's.
template <int kTileMN, typename T>
__device__ __forceinline__ void pick_tile(const WeightProblem<T>& p0,
                                          const WeightProblem<T>& p1,
                                          WeightProblem<T>& p, int& m0, int& n0) {
  const int tiles0 = (p0.m / kTileMN) * (p0.n / kTileMN);
  int tile = blockIdx.x;
  p = tile < tiles0 ? p0 : p1;
  if (tile >= tiles0) tile -= tiles0;
  m0 = (tile / (p.n / kTileMN)) * kTileMN;
  n0 = (tile % (p.n / kTileMN)) * kTileMN;
}

// The steps of kStepRows rows [begin, end) of split blockIdx.y; empty past
// the rows.
template <int kStepRows>
__device__ __forceinline__ void split_steps(int rows, int& begin, int& end) {
  const int steps = (rows + kStepRows - 1) / kStepRows;
  const int per = (steps + gridDim.y - 1) / gridDim.y;
  begin = blockIdx.y * per;
  end = min(steps, begin + per);
}

// ---------------------------------------------------------------------------
// float32 weight kernel, CUDA cores: 256 threads, 4 x 4 outputs each,
// 16-row stages of A and B in shared memory.

constexpr int kWF32Tile = 64;
constexpr int kWF32Threads = 256;
constexpr int kWF32Rows = 16;

template <bool kMaskB>
__global__ void __launch_bounds__(kWF32Threads)
    mlp_weights_f32(WeightProblem<float> p0, WeightProblem<float> p1, int rows,
                    size_t split_stride, float inv_keep) {
  __shared__ float4 as[kWF32Rows][kWF32Tile / 4];
  __shared__ float4 bs[kWF32Rows][kWF32Tile / 4];
  WeightProblem<float> p;
  int m0, n0, begin, end;
  pick_tile<kWF32Tile>(p0, p1, p, m0, n0);
  split_steps<kWF32Tile>(rows, begin, end);
  const bool with_bias = n0 == 0;
  const int tm = threadIdx.x >> 4, tn = threadIdx.x & 15;
  const int lr = threadIdx.x >> 4, lc = threadIdx.x & 15;  // this thread's copy
  const int last = min(rows, end * kWF32Tile);
  float acc[4][4] = {};
  float cs = 0.f;

  for (int row0 = begin * kWF32Tile; row0 < last; row0 += kWF32Rows) {
    __syncthreads();  // the previous stage is consumed
    const int row = row0 + lr;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    as[lr][lc] = row < last
                     ? *reinterpret_cast<const float4*>(p.a + (size_t)row * p.m + m0 + 4 * lc)
                     : zero;
    float4 bv = row < last
                    ? *reinterpret_cast<const float4*>(p.b + (size_t)row * p.n + n0 + 4 * lc)
                    : zero;
    if (kMaskB && row < last) {
      const uint32_t m =
          *reinterpret_cast<const uint32_t*>(p.mask_b + (size_t)row * p.n + n0 + 4 * lc);
      bv.x *= (m & 0xffu) ? inv_keep : 0.f;
      bv.y *= (m & 0xff00u) ? inv_keep : 0.f;
      bv.z *= (m & 0xff0000u) ? inv_keep : 0.f;
      bv.w *= (m & 0xff000000u) ? inv_keep : 0.f;
    }
    bs[lr][lc] = bv;
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kWF32Rows; ++r) {
      const float4 a = as[r][tm], b = bs[r][tn];
      const float av[4] = {a.x, a.y, a.z, a.w}, bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
    if (with_bias && threadIdx.x < kWF32Tile) {
      const float* col = reinterpret_cast<const float*>(&as[0][0]) + threadIdx.x;
#pragma unroll
      for (int r = 0; r < kWF32Rows; ++r) cs += col[r * kWF32Tile];
    }
  }
  float* c = p.part + blockIdx.y * split_stride;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(c + (size_t)(m0 + 4 * tm + i) * p.n + n0 + 4 * tn) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  if (with_bias && threadIdx.x < kWF32Tile)
    p.part_bias[blockIdx.y * split_stride + m0 + threadIdx.x] = cs;
}

// The gradients from the splits' partial sums, added in split order and
// rounded once. One split's partials are the outputs back to back:
// element i belongs to the first output whose end lies past i.
template <typename T, int kOutputs>
struct SplitOutputs {
  T* dst[kOutputs];
  size_t end[kOutputs];  // cumulative element counts
};

// Each thread loads an element's kMaxSplits partials at once (those past
// `splits` as 0, unused), then adds them in slice order.
constexpr int kReduceBlocks = 1056;  // 8 blocks of 256 an SM

template <typename T, int kOutputs>
__global__ void reduce_splits(const float* __restrict__ part, size_t split_stride,
                              int splits, SplitOutputs<T, kOutputs> out) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < split_stride;
       i += (size_t)gridDim.x * blockDim.x) {
    float v[kMaxSplits];
#pragma unroll
    for (int k = 0; k < kMaxSplits; ++k) v[k] = k < splits ? part[k * split_stride + i] : 0.f;
    float s = v[0];
#pragma unroll
    for (int k = 1; k < kMaxSplits; ++k)
      if (k < splits) s += v[k];
    size_t begin = 0;
#pragma unroll
    for (int o = 0; o < kOutputs; ++o) {
      if (i >= begin && i < out.end[o]) out.dst[o][i - begin] = from_float<T>(s);
      begin = out.end[o];
    }
  }
}

// Splits of at least 64 steps each, at most kMaxSplits.
inline int weight_splits(int rows, int step_rows) {
  const int steps = (rows + step_rows - 1) / step_rows;
  return max(1, min(kMaxSplits, steps / 64));
}

// The slices of a bf16 weight product's `steps` row steps: at most
// kMaxSplits, each at least kMinSplitSteps steps, as many as fill the most
// of their last wave of `tiles` x slices blocks over the card's SMs
// (`blocks` an SM); the fewest of those that fill it equally well.
constexpr int kMinSplitSteps = 8;

inline int gemm_splits(int tiles, int steps, int blocks) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    sms = 132;
  int best = 1;
  double best_waves = 1e30;  // waves a unit of K
  for (int s = 1; s <= kMaxSplits && (s == 1 || s * kMinSplitSteps <= steps); ++s) {
    const double waves = (double)((tiles * s + blocks * sms - 1) / (blocks * sms)) / s;
    if (waves < best_waves * (1 - 1e-9)) {
      best = s;
      best_waves = waves;
    }
  }
  return best;
}

// The float32 weight kernel over p0's and p1's tiles (p1 may have none:
// m = 0), then the reduction into `out` (split_stride: one split's
// partials).
template <bool kMaskB, int kOutputs>
cudaError_t launch_weights(const WeightProblem<float>& p0, const WeightProblem<float>& p1,
                           int rows, size_t split_stride, float keep_prob,
                           const SplitOutputs<float, kOutputs>& out, cudaStream_t stream) {
  const float inv_keep = 1.f / keep_prob;
  const int splits = weight_splits(rows, kWF32Tile);
  const dim3 grid((p0.m / kWF32Tile) * (p0.n / kWF32Tile) +
                      (p1.m / kWF32Tile) * (p1.n / kWF32Tile),
                  splits);
  mlp_weights_f32<kMaskB><<<grid, kWF32Threads, 0, stream>>>(p0, p1, rows, split_stride,
                                                             inv_keep);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_splits<float, kOutputs><<<kReduceBlocks, 256, 0, stream>>>(p0.part, split_stride,
                                                                    splits, out);
  return cudaGetLastError();
}

}  // namespace
