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
// repeat run to run. With kMaskB, b is h and is taken as round(h * mask /
// keep) on its way in (P2's hm; mask (rows, n) bytes, 0 = dropped).
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

// Eight bf16 values times their keep-mask bytes over keep, rounded back.
__device__ __forceinline__ uint4 mask_bf16x8(uint4 v, uint2 m, float inv_keep) {
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t bytes = q < 2 ? m.x >> (16 * q) : m.y >> (16 * (q - 2));
    const float s0 = (bytes & 0xffu) ? inv_keep : 0.f;
    const float s1 = (bytes & 0xff00u) ? inv_keep : 0.f;
    w[q] = pack_bf16(bf16_lo(w[q]) * s0, bf16_hi(w[q]) * s1);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// ---------------------------------------------------------------------------
// bfloat16 weight kernel, tensor cores. A block owns a 128 x 128 tile; its 4
// warps each a 64 x 64 corner (4 x 8 mma tiles, 128 fp32 sums a thread, 8
// ldmatrix per 32 mma). 32-row stages of A and B stream through a ring of
// kWStages cp.async buffers, so that copies several stages ahead cover
// device-memory latency; both are stored [row][.] so their fragments come
// from ldmatrix.trans. The blocks owning a tile's first column also sum A's
// columns on the tensor cores, as A^T . 1 (one more 8-wide tile of ones in
// the two warps at column 0): exact products, fp32 sums in a fixed order.
// With kMaskB each stage's B is masked in place before the products.

constexpr int kWTile = 128;
constexpr int kWRows = 32;  // rows a stage
constexpr int kWThreads = 128;
constexpr int kWStages = 4;
constexpr int kWStride = kWTile + kBPad;
constexpr size_t kWStageElems = 2 * (size_t)kWRows * kWStride;  // A and B
constexpr size_t kWMaskBytes = (size_t)kWRows * kWTile;          // B's mask, a stage

template <bool kMaskB>
constexpr size_t weight_smem_bf16() {
  return sizeof(bf16) * kWStages * kWStageElems + (kMaskB ? kWStages * kWMaskBytes : 0);
}

template <bool kMaskB>
__global__ void __launch_bounds__(kWThreads)
    mlp_weights_bf16(WeightProblem<bf16> p0, WeightProblem<bf16> p1, int rows,
                     size_t split_stride, float inv_keep) {
  extern __shared__ uint4 smem_w[];
  bf16* stage = reinterpret_cast<bf16*>(smem_w);  // [kWStages][A, B][kWRows][kWStride]
  uint8_t* mstage = reinterpret_cast<uint8_t*>(stage + kWStages * kWStageElems);

  WeightProblem<bf16> p;
  int m0, n0, begin, end;
  pick_tile<kWTile>(p0, p1, p, m0, n0);
  split_steps<kWRows>(rows, begin, end);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = 64 * (warp & 1), wn = 64 * (warp >> 1);
  const bool with_bias = n0 == 0 && wn == 0;  // warp-uniform
  const uint32_t ones = 0x3f803f80u;          // two bf16 1.0

  // stage `step`'s copies (or none past the end), committed as one group
  auto copy_stage = [&](int step) {
    if (step < end) {
      const int slot = (step - begin) % kWStages;
      bf16* as = stage + slot * kWStageElems;
      bf16* bs = as + kWRows * kWStride;
      for (int idx = threadIdx.x; idx < kWRows * kWTile / 8; idx += kWThreads) {
        const int r = idx / (kWTile / 8), c = (idx % (kWTile / 8)) * 8;
        const int row = step * kWRows + r;
        const bool ok = row < rows;
        cp_async16(as + r * kWStride + c, ok ? p.a + (size_t)row * p.m + m0 + c : p.a, ok);
        cp_async16(bs + r * kWStride + c, ok ? p.b + (size_t)row * p.n + n0 + c : p.b, ok);
      }
      if (kMaskB) {
        uint8_t* ms = mstage + slot * kWMaskBytes;
        for (int idx = threadIdx.x; idx < kWRows * kWTile / 16; idx += kWThreads) {
          const int r = idx / (kWTile / 16), c = (idx % (kWTile / 16)) * 16;
          const int row = step * kWRows + r;
          const bool ok = row < rows;
          cp_async16(ms + r * kWTile + c,
                     ok ? p.mask_b + (size_t)row * p.n + n0 + c : p.mask_b, ok);
        }
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < kWStages - 1; ++s) copy_stage(begin + s);

  float acc[4][8][4] = {};
  float colsum[4][4] = {};  // A^T . 1: every column of each tile is the sum

  for (int step = begin; step < end; ++step) {
    cp_async_wait<kWStages - 2>();
    __syncthreads();  // this stage is in; every warp is done with the last one
    copy_stage(step + kWStages - 1);  // into the buffer the last stage used
    const int slot = (step - begin) % kWStages;
    bf16* as = stage + slot * kWStageElems;
    bf16* bs = as + kWRows * kWStride;
    if (kMaskB) {  // b = round(h * mask / keep), in place
      const uint8_t* ms = mstage + slot * kWMaskBytes;
      for (int idx = threadIdx.x; idx < kWRows * kWTile / 8; idx += kWThreads) {
        const int r = idx / (kWTile / 8), c = (idx % (kWTile / 8)) * 8;
        uint4* hv = reinterpret_cast<uint4*>(bs + r * kWStride + c);
        *hv = mask_bf16x8(*hv, *reinterpret_cast<const uint2*>(ms + r * kWTile + c),
                          inv_keep);
      }
      __syncthreads();
    }
#pragma unroll
    for (int k0 = 0; k0 < kWRows; k0 += 16) {
      uint32_t a[4][4], b[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)  // A stored [k = row][m]: .trans
        ldmatrix_x4<true>(a[i], frag_split_cols(as, kWStride, k0, wm + 16 * i));
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) load_b<true>(b[jp], bs, kWStride, k0, wn + 16 * jp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          mma_bf16(acc[i][2 * jp], a[i], b[jp][0], b[jp][1]);
          mma_bf16(acc[i][2 * jp + 1], a[i], b[jp][2], b[jp][3]);
        }
        if (with_bias) mma_bf16(colsum[i], a[i], ones, ones);
      }
    }
  }
  cp_async_wait<0>();  // the empty groups past the end

  float* c = p.part + blockIdx.y * split_stride;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int m = m0 + wm + 16 * i + g, n = n0 + wn + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(c + (size_t)m * p.n + n) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(c + (size_t)(m + 8) * p.n + n) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
  if (with_bias && t == 0) {
    float* bias = p.part_bias + blockIdx.y * split_stride;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bias[m0 + wm + 16 * i + g] = colsum[i][0];
      bias[m0 + wm + 16 * i + g + 8] = colsum[i][2];
    }
  }
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

// The weight kernel over p0's and p1's tiles (p1 may have none: m = 0),
// then the reduction into `out` (split_stride: one split's partials).
template <typename T, bool kMaskB, int kOutputs>
cudaError_t launch_weights(const WeightProblem<T>& p0, const WeightProblem<T>& p1,
                           int rows, size_t split_stride, float keep_prob,
                           const SplitOutputs<T, kOutputs>& out, cudaStream_t stream) {
  const float inv_keep = 1.f / keep_prob;
  int splits;
  if constexpr (sizeof(T) == 2) {
    constexpr size_t smem = weight_smem_bf16<kMaskB>();
    cudaError_t err = cudaFuncSetAttribute(
        mlp_weights_bf16<kMaskB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    splits = weight_splits(rows, kWRows);
    const dim3 grid((p0.m / kWTile) * (p0.n / kWTile) + (p1.m / kWTile) * (p1.n / kWTile),
                    splits);
    mlp_weights_bf16<kMaskB><<<grid, kWThreads, smem, stream>>>(p0, p1, rows, split_stride,
                                                                inv_keep);
  } else {
    splits = weight_splits(rows, kWF32Tile);
    const dim3 grid((p0.m / kWF32Tile) * (p0.n / kWF32Tile) +
                        (p1.m / kWF32Tile) * (p1.n / kWF32Tile),
                    splits);
    mlp_weights_f32<kMaskB><<<grid, kWF32Threads, 0, stream>>>(p0, p1, rows, split_stride,
                                                               inv_keep);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_splits<T, kOutputs><<<kReduceBlocks, 256, 0, stream>>>(p0.part, split_stride, splits,
                                                                out);
  return cudaGetLastError();
}

}  // namespace
