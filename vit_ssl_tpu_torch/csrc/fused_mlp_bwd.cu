// Fused MLP backward for Hopper (sm_90a): kernel B4's backward.
//
// Replaces the TPU kernel vit_ssl_tpu/ops/fused_mlp.py::_mlp_bwd_kernel
// (the pallas_call of _fused_mlp_bwd_impl). Same math and the same rounding
// points, from the forward's saved pre (rounded to the input dtype):
//
//   h    = gelu(pre) [* mask / keep]          fp32, rounded to the dtype
//   dh   = do . W2 [* mask / keep]            fp32 sums
//   dpre = dh * gelu'(pre)                    rounded to the dtype
//   dx   = dpre . W1                          fp32 sums, rounded
//   dW2  = do^T . h ; db2 = sum_rows do       fp32 sums, rounded
//   dW1  = dpre^T . x ; db1 = sum_rows dpre   fp32 sums, rounded
//
// with do already in the input dtype, and the four weight and bias
// gradients returned in that dtype, as the JAX custom VJP returns them.
// W1 is (d_ff, d_model) and W2 (d_model, d_ff), the nn.Linear layout, and
// dW1, dW2 come back in the same layouts.
//
// The TPU kernel sums dW1, db1, dW2 and db2 across its sequential grid.
// Blocks on Hopper run in parallel and in no order, so the backward is two
// kernels and uses no atomics; its results repeat run to run:
//
// 1. the row kernel (fused_mlp_common.cuh, run backward): per 64-row tile,
//    dh chunk by chunk over d_ff, dpre and h written to device memory in the
//    input dtype, and dx = dpre . W1 accumulated in registers;
// 2. the weight kernel: each block owns one 128 x 128 tile of dW1 or of dW2
//    (both in one launch) and one of up to 8 slices of the rows, walked in a
//    fixed order: C = A^T . B with A = dpre, B = x (dW1) or A = do, B = h
//    (dW2); the blocks owning a tile's first column also sum A's columns
//    into db1 or db2. They write fp32 partial sums;
// 3. a reduction adds the slices' partial sums in slice order and rounds.
//
// What bounds it on an H100 SXM: operations. At T = 37120 (d_model 384,
// d_ff 1536, bf16) the four products are 175 GFLOP, 0.177 ms at the 989
// TFLOP/s bf16 rate, against about 0.08 ms to move x, pre, do, the mask,
// the weights and the gradients once (data sheet). The split adds dpre and
// h, written by the first kernel and read by the second: 4 x 114 MB at
// T = 37120, about 0.14 ms more at 3.35 TB/s. The products run on the
// tensor cores (mma.sync bf16, fp32 sums); float32 runs on the CUDA cores.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (vit_ssl_tpu_torch/kernels.py); called through
// ctypes from vit_ssl_tpu_torch/ops/fused_mlp.py.

#include "fused_mlp_common.cuh"

namespace {

constexpr int kMaxSplits = 8;  // the rows split into at most this many slices

// One of the two weight-gradient products, c (m, n) = a^T . b over the
// rows, a (rows, m), b (rows, n), and bias (m) = the column sums of a.
// Each split writes fp32 partial sums at part (m, n) and part_bias (m),
// offset by its index times the split stride.
template <typename T>
struct WeightProblem {
  const T* a;
  const T* b;
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
// bfloat16 weight kernel, tensor cores. A block owns a 128 x 128 tile; its 4
// warps each a 64 x 64 corner (4 x 8 mma tiles, 128 fp32 sums a thread, 8
// ldmatrix per 32 mma). 32-row stages of A and B stream through a ring of
// kWStages cp.async buffers, so that copies several stages ahead cover
// device-memory latency; both are stored [row][.] so their fragments come
// from ldmatrix.trans. The blocks owning a tile's first column also sum A's
// columns on the tensor cores, as A^T . 1 (one more 8-wide tile of ones in
// the two warps at column 0): exact products, fp32 sums in a fixed order.

constexpr int kWTile = 128;
constexpr int kWRows = 32;  // rows a stage
constexpr int kWThreads = 128;
constexpr int kWStages = 4;
constexpr int kWStride = kWTile + kBPad;
constexpr size_t kWStageElems = 2 * (size_t)kWRows * kWStride;  // A and B
constexpr size_t weight_smem_bf16() { return sizeof(bf16) * kWStages * kWStageElems; }

__global__ void __launch_bounds__(kWThreads)
    mlp_weights_bf16(WeightProblem<bf16> p0, WeightProblem<bf16> p1, int rows,
                     size_t split_stride) {
  extern __shared__ uint4 smem_w[];
  bf16* stage = reinterpret_cast<bf16*>(smem_w);  // [kWStages][A, B][kWRows][kWStride]

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
      bf16* as = stage + ((step - begin) % kWStages) * kWStageElems;
      bf16* bs = as + kWRows * kWStride;
      for (int idx = threadIdx.x; idx < kWRows * kWTile / 8; idx += kWThreads) {
        const int r = idx / (kWTile / 8), c = (idx % (kWTile / 8)) * 8;
        const int row = step * kWRows + r;
        const bool ok = row < rows;
        cp_async16(as + r * kWStride + c, ok ? p.a + (size_t)row * p.m + m0 + c : p.a, ok);
        cp_async16(bs + r * kWStride + c, ok ? p.b + (size_t)row * p.n + n0 + c : p.b, ok);
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
    const bf16* as = stage + ((step - begin) % kWStages) * kWStageElems;
    const bf16* bs = as + kWRows * kWStride;
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

__global__ void __launch_bounds__(kWF32Threads)
    mlp_weights_f32(WeightProblem<float> p0, WeightProblem<float> p1, int rows,
                    size_t split_stride) {
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
    bs[lr][lc] = row < last
                     ? *reinterpret_cast<const float4*>(p.b + (size_t)row * p.n + n0 + 4 * lc)
                     : zero;
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kWF32Rows; ++r) {
      const float4 a = as[r][tm], b = bs[r][tn];
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
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
// rounded once. One split's partials: [dW1 | dW2 | db1 | db2].
template <typename T>
__global__ void reduce_splits(const float* __restrict__ part, size_t split_stride,
                              int splits, T* __restrict__ dw1, T* __restrict__ dw2,
                              T* __restrict__ db1, T* __restrict__ db2, int d_model,
                              int d_ff) {
  const size_t n_w = (size_t)d_model * d_ff;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < split_stride;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = part[i];
    for (int k = 1; k < splits; ++k) s += part[k * split_stride + i];
    const T v = from_float<T>(s);
    if (i < n_w)
      dw1[i] = v;
    else if (i < 2 * n_w)
      dw2[i - n_w] = v;
    else if (i < 2 * n_w + d_ff)
      db1[i - 2 * n_w] = v;
    else
      db2[i - 2 * n_w - d_ff] = v;
  }
}

// ---------------------------------------------------------------------------
// launch

template <typename T, bool kMask>
cudaError_t launch_rows(const RowArgs<T>& p, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    constexpr size_t smem = RowSmemBf16::bytes;
    auto kernel = mlp_rows_bf16<true, kMask, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<(p.rows + kMlpRows - 1) / kMlpRows, kMlpThreads, smem, stream>>>(p);
  } else {
    constexpr size_t smem = row_smem_f32();
    auto kernel = mlp_rows_f32<true, kMask, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<(p.rows + kF32Rows - 1) / kF32Rows, kF32Threads, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

// Splits of at least 64 steps each, at most kMaxSplits.
int weight_splits(int rows, int step_rows) {
  const int steps = (rows + step_rows - 1) / step_rows;
  return max(1, min(kMaxSplits, steps / 64));
}

template <typename T>
cudaError_t launch_weights(const WeightProblem<T>& p0, const WeightProblem<T>& p1,
                           int rows, size_t split_stride, T* dw1, T* dw2, T* db1, T* db2,
                           cudaStream_t stream) {
  int splits;
  if constexpr (sizeof(T) == 2) {
    constexpr size_t smem = weight_smem_bf16();
    cudaError_t err = cudaFuncSetAttribute(
        mlp_weights_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    splits = weight_splits(rows, kWRows);
    const dim3 grid((p0.m / kWTile) * (p0.n / kWTile) + (p1.m / kWTile) * (p1.n / kWTile),
                    splits);
    mlp_weights_bf16<<<grid, kWThreads, smem, stream>>>(p0, p1, rows, split_stride);
  } else {
    splits = weight_splits(rows, kWF32Tile);
    const dim3 grid((p0.m / kWF32Tile) * (p0.n / kWF32Tile) +
                        (p1.m / kWF32Tile) * (p1.n / kWF32Tile),
                    splits);
    mlp_weights_f32<<<grid, kWF32Threads, 0, stream>>>(p0, p1, rows, split_stride);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_splits<T><<<264, 256, 0, stream>>>(p0.part, split_stride, splits, dw1, dw2, db1,
                                            db2, p1.m, p0.m);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* pre, const void* dout, const void* w1,
             const void* w2, const void* mask, void* dx, void* dw1, void* db1,
             void* dw2, void* db2, void* dpre, void* h, void* partial, int rows,
             int d_model, int d_ff, float keep_prob, void* stream) {
  if (rows < 1 || d_model != kDModel || d_ff < kWTile || d_ff % kWTile != 0 ||
      (mask != nullptr && !(keep_prob > 0.f)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RowArgs<T> p{static_cast<const T*>(dout), static_cast<const T*>(w1), nullptr,
               static_cast<const T*>(w2), nullptr, static_cast<const uint8_t*>(mask),
               const_cast<T*>(static_cast<const T*>(pre)), static_cast<T*>(dx),
               static_cast<T*>(dpre), static_cast<T*>(h), rows, d_ff, keep_prob};
  cudaError_t err = mask != nullptr ? launch_rows<T, true>(p, s) : launch_rows<T, false>(p, s);
  if (err != cudaSuccess) return (int)err;
  // one split's partials: [dW1 (d_ff, d_model) | dW2 (d_model, d_ff) | db1 | db2]
  float* part = static_cast<float*>(partial);
  const size_t n_w = (size_t)d_model * d_ff;
  const size_t split_stride = 2 * n_w + d_ff + d_model;
  const WeightProblem<T> p_w1{static_cast<const T*>(dpre), static_cast<const T*>(x), part,
                              part + 2 * n_w, d_ff, d_model};
  const WeightProblem<T> p_w2{static_cast<const T*>(dout), static_cast<const T*>(h),
                              part + n_w, part + 2 * n_w + d_ff, d_model, d_ff};
  return (int)launch_weights<T>(p_w1, p_w2, rows, split_stride, static_cast<T*>(dw1),
                                static_cast<T*>(dw2), static_cast<T*>(db1),
                                static_cast<T*>(db2), s);
}

}  // namespace

// x, dout, dx: (rows, d_model); pre, and the scratch dpre and h: (rows,
// d_ff); w1, dw1: (d_ff, d_model); w2, dw2: (d_model, d_ff); db1 (d_ff),
// db2 (d_model). All contiguous, one dtype (is_bf16 = 1: bfloat16, 0:
// float32), 16-byte aligned. partial: fp32 scratch of
// fused_mlp_bwd_partial_floats(d_model, d_ff) elements. mask: (rows, d_ff)
// bytes, nonzero = keep, or null. d_model must be 384 and d_ff a multiple
// of 64. Three kernels on `stream` (a cudaStream_t); returns the first
// launch's cudaError_t that is not 0, else 0; the wrapper raises on
// non-zero.
extern "C" int fused_mlp_bwd(const void* x, const void* pre, const void* dout,
                             const void* w1, const void* w2, const void* mask, void* dx,
                             void* dw1, void* db1, void* dw2, void* db2, void* dpre,
                             void* h, void* partial, int rows, int d_model, int d_ff,
                             int is_bf16, float keep_prob, void* stream) {
  if (is_bf16)
    return dispatch<bf16>(x, pre, dout, w1, w2, mask, dx, dw1, db1, dw2, db2, dpre, h,
                          partial, rows, d_model, d_ff, keep_prob, stream);
  return dispatch<float>(x, pre, dout, w1, w2, mask, dx, dw1, db1, dw2, db2, dpre, h,
                         partial, rows, d_model, d_ff, keep_prob, stream);
}

// The fp32 scratch fused_mlp_bwd needs: its most splits' partial sums.
extern "C" long long fused_mlp_bwd_partial_floats(int d_model, int d_ff) {
  return (long long)kMaxSplits * (2LL * d_model * d_ff + d_ff + d_model);
}
