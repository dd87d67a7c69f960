// Dropout-masked second FFN product for Hopper (sm_90a): kernel P2,
// forward and backward.
//
// Replaces the TPU kernels of scripts/dropout_epilogue_probe.py:
// _masked_mm_kernel (the pallas_call of _masked_mm_fwd_impl) and
// _masked_mm_bwd_kernel (the pallas_call of _mm_bwd), at their rounding
// points:
//
//   forward:  hm  = h * mask / keep       fp32, rounded to h's dtype
//             o   = hm . W2^T + b2        fp32 sums plus b2, rounded
//   backward: dh  = (do . W2) * mask / keep        fp32, rounded
//             dW2 = do^T . hm ; db2 = sum_rows do  fp32 sums, rounded
//
// h is (T, d_ff), the mask (T, d_ff) bytes (0 = dropped), W2 (d_out, d_ff)
// in the nn.Linear layout, do (T, d_out), all in one dtype. The point of
// the kernel is that the masked activation hm never reaches device memory
// as a tensor of its own: a product scales its h tile in shared memory
// between the copy that lands it and the tensor cores that read it.
//
// bfloat16 runs kernel B4's wgmma/TMA product (mlp_gemm_sm90.cuh's
// gemm_body: 128 x 128 tiles, two consumer warpgroups and a producer warp,
// K in stages of 64), with h masked on its way in by the MaskedOperand
// policy: each stage's full barrier also counts h's keep-mask box (8 KB by
// TMA), and the consumers scale h's tile before the stage's products.
// Three kernels, on rings of 40 KB stages (kFwdStages, kWgradStages) or on
// B4's ring:
//
// - masked_mm_fwd_sm90_kernel: B4's fc2 with A = h masked in registers
//   (each warp's fragments by ldmatrix, scaled, then wgmma's register-A
//   form); b2's slice by TMA into a side slot, o staged and stored by TMA
//   (StoreRows<true>);
// - masked_mm_dh_sm90_kernel: B4's dh product (A = do, B = W2 MN-major)
//   with the mask-only epilogue MaskRows: the mask tile by TMA, dh =
//   round(acc * mask / keep) staged and stored by TMA;
// - masked_mm_wgrad_sm90_kernel: B4's weight product, A = do and B = h
//   both MN-major, B rewritten in place in shared memory (each consumer
//   half of its K rows, behind a barrier of both consumers, which both
//   read all of B), the
//   ones product for db2, fp32 partials (Partials) over gemm_splits slices
//   of T; weight_grad.cuh's reduce_splits adds the slices in slice order
//   and rounds: no atomics, a second call repeats the first bit for bit.
//
// TMA zero-fills rows past T (h, do and the mask alike) and writes none;
// nothing is padded in memory. float32 runs on the CUDA cores (full fp32
// products: masked_mm_f32 here, weight_grad.cuh's fp32 weight kernel).
//
// What bounds it on an H100 SXM: bytes. At the DINO student-globals FFN
// (T = 37120, d_ff 1536, d_out 384, bf16) the forward moves h, the mask,
// W2 and o, about 201 MB, 0.060 ms at 3.35 TB/s, against 43.8 GFLOP, 0.044
// ms at 989 TFLOP/s; the backward moves h, the mask, do, W2, dh and dW2,
// about 317 MB, 0.095 ms, against two products, 0.089 ms (data sheet). The
// design reads h and the mask once a column tile of o (three times at
// d_out 384, mostly from L2) and never writes hm. Scaling h costs shared-
// memory traffic: in the forward 12 KB a consumer and stage of ldmatrix
// and mask reads, which take the place of wgmma's own 8 KB of A; in the
// weight product 20 KB of reads and writes beside the products' 33 KB.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (vit_ssl_tpu_torch/kernels.py); called through
// ctypes from vit_ssl_tpu_torch/ops/masked_matmul.py.

#include "mlp_gemm_sm90.cuh"
#include "weight_grad.cuh"

namespace {
namespace sm90 {

// The masked products' rings of 40 KB stages, one block an SM, chosen by
// timing two to five stages of each on an H100 (PERF.md): the forward
// three (its A fragments take 128 registers; at two stages and two blocks
// an SM ptxas spills and serialises the products); the weight product four
// (7 % faster than two stages and two blocks an SM at d_out 384, even at
// 768)
constexpr int kFwdStages = 3;
constexpr int kWgradStages = 4;
using FwdOperand = MaskedOperand<true, kFwdStages>;
using WgradOperand = MaskedOperand<false, kWgradStages>;

// grid (d_out / 128, row tiles); A = h, B = W2 (K-major, as stored)
__global__ void __launch_bounds__(kGemmThreads, 1)
    masked_mm_fwd_sm90_kernel(const __grid_constant__ CUtensorMap th,
                              const __grid_constant__ CUtensorMap tmask,
                              const __grid_constant__ CUtensorMap tw2,
                              const __grid_constant__ CUtensorMap tout, StoreRows<true> epi,
                              FwdOperand op, int k_steps) {
  epi.tout = &tout;
  op.tmask = &tmask;
  gemm_body<false, false, false, StoreRows<true>, FwdOperand>(
      &th, &tw2, blockIdx.y * kGemmRows, blockIdx.x * kGemmCols, 0, k_steps, epi, op);
}

// grid (d_ff / 128, row tiles); A = do, B = W2 as (k = d_out, n = d_ff)
__global__ void __launch_bounds__(kGemmThreads, 2)
    masked_mm_dh_sm90_kernel(const __grid_constant__ CUtensorMap tdo,
                             const __grid_constant__ CUtensorMap tw2,
                             const __grid_constant__ CUtensorMap tmask,
                             const __grid_constant__ CUtensorMap tdh, MaskRows epi,
                             int k_steps) {
  epi.tmask = &tmask;
  epi.tout = &tdh;
  gemm_body<false, true, false>(&tdo, &tw2, blockIdx.y * kGemmRows, blockIdx.x * kGemmCols, 0,
                                k_steps, epi);
}

// grid (dW2's tiles, slices); blockIdx.y is the slice of the k_steps row
// steps
__global__ void __launch_bounds__(kGemmThreads, 1)
    masked_mm_wgrad_sm90_kernel(const __grid_constant__ CUtensorMap tdo,
                                const __grid_constant__ CUtensorMap th,
                                const __grid_constant__ CUtensorMap tmask, Partials epi,
                                WgradOperand op, int k_steps) {
  op.tmask = &tmask;
  const int n_tiles = epi.width / kGemmCols;
  const int per = (k_steps + gridDim.y - 1) / gridDim.y;
  const int begin = min(k_steps, (int)blockIdx.y * per);
  gemm_body<true, true, true, Partials, WgradOperand>(
      &tdo, &th, blockIdx.x / n_tiles * kGemmRows, blockIdx.x % n_tiles * kGemmCols, begin,
      min(k_steps, begin + per), epi, op);
}

// The forward. Maps: boxes of 128 rows for the K-major operands, of 64
// for the store; the mask's boxes 64 columns x 128 rows.
cudaError_t forward(const bf16* h, const uint8_t* mask, const bf16* w2, const bf16* b2,
                    bf16* out, int rows, int d_ff, int d_out, float keep_prob,
                    cudaStream_t stream) {
  CUtensorMap th, tmask, tw2, tout;
  if (!encode_matrix(&th, h, d_ff, rows, kGemmRows) ||
      !encode_mask_box(&tmask, mask, d_ff, rows, kGemmK, kGemmRows) ||
      !encode_matrix(&tw2, w2, d_ff, d_out, kGemmCols) ||
      !encode_matrix(&tout, out, d_out, rows, 64))
    return cudaErrorInvalidValue;
  return launch_gemm<FwdOperand>(masked_mm_fwd_sm90_kernel,
                                 dim3(d_out / kGemmCols, row_tiles(rows)), stream, th, tmask,
                                 tw2, tout, StoreRows<true>{b2, nullptr},
                                 FwdOperand{1.f / keep_prob, nullptr}, d_ff / kGemmK);
}

// The backward's three launches: dh, dW2's and db2's slices into fp32
// partials (part: one slice's [dW2 (d_out, d_ff) | db2 (d_out)]), then
// their ordered reduction. Maps: boxes of 128 rows for the K-major A (do),
// of 64 for the MN-major operands and the store; the mask as dh's side
// tile (128 x 128, swizzled) and as the weight product's B mask (128
// columns x 64 rows).
cudaError_t backward(const bf16* h, const uint8_t* mask, const bf16* dout, const bf16* w2,
                     bf16* dh, bf16* dw2, bf16* db2, float* part, int rows, int d_ff,
                     int d_out, float keep_prob, cudaStream_t stream) {
  CUtensorMap tdo, tw2, tmask, tdh, tdo64, th64, tmask_b;
  if (!encode_matrix(&tdo, dout, d_out, rows, kGemmRows) ||
      !encode_matrix(&tw2, w2, d_ff, d_out, 64) ||  // W2 as (k = d_out, n = d_ff)
      !encode_mask(&tmask, mask, d_ff, rows) || !encode_matrix(&tdh, dh, d_ff, rows, 64) ||
      !encode_matrix(&tdo64, dout, d_out, rows, 64) ||
      !encode_matrix(&th64, h, d_ff, rows, 64) ||
      !encode_mask_box(&tmask_b, mask, d_ff, rows, kGemmCols, kGemmK))
    return cudaErrorInvalidValue;
  const float inv_keep = 1.f / keep_prob;
  cudaError_t err = launch_gemm(masked_mm_dh_sm90_kernel,
                                dim3(d_ff / kGemmCols, row_tiles(rows)), stream, tdo, tw2,
                                tmask, tdh, MaskRows{inv_keep, nullptr, nullptr},
                                d_out / kGemmK);
  if (err != cudaSuccess) return err;
  const size_t n_w = (size_t)d_out * d_ff, split_stride = n_w + d_out;
  const int tiles = (d_out / kGemmCols) * (d_ff / kGemmCols);
  const int steps = (rows + kGemmK - 1) / kGemmK;
  const int splits = gemm_splits(tiles, steps, 1);
  err = launch_gemm<WgradOperand>(masked_mm_wgrad_sm90_kernel, dim3(tiles, splits), stream,
                                  tdo64, th64, tmask_b,
                                  Partials{part, part + n_w, d_ff, split_stride},
                                  WgradOperand{inv_keep, nullptr}, steps);
  if (err != cudaSuccess) return err;
  const SplitOutputs<bf16, 2> out{{dw2, db2}, {n_w, split_stride}};
  reduce_splits<bf16, 2><<<kReduceBlocks, 256, 0, stream>>>(part, split_stride, splits, out);
  return cudaGetLastError();
}

}  // namespace sm90

// ---------------------------------------------------------------------------
// The tiled float32 product c (rows, n) = a (rows, k) . B over k, B from
// W2: forward a = h (k = d_ff), B = W2^T (n = d_out), a masked on the way
// in, b2 added in the epilogue; backward a = do (k = d_out), B = W2 (n =
// d_ff), c masked in the epilogue.
struct TileArgs {
  const float* a;
  const float* w2;       // (d_out, d_ff)
  const float* b2;       // (d_out), forward only
  const uint8_t* mask;   // (rows, d_ff)
  float* out;            // (rows, n): o or dh
  int rows, n, k;
  float keep_prob;
};

// CUDA cores: a block of 256 threads owns 64 rows x 64 columns,
// 4 x 4 a thread; 16-deep stages of a (masked on the copy in the forward)
// and B sit in shared memory as [k][m] and [k][n].

constexpr int kF32Tile = 64, kF32K = 16;

template <bool kFwd>
__global__ void __launch_bounds__(kF32Threads) masked_mm_f32(TileArgs p) {
  __shared__ float4 as[kF32K][kF32Tile / 4];
  __shared__ float4 bs[kF32K][kF32Tile / 4];
  float* af = reinterpret_cast<float*>(&as[0][0]);
  float* bf = reinterpret_cast<float*>(&bs[0][0]);
  const int tm = threadIdx.x >> 4, tn = threadIdx.x & 15;
  const int row0 = blockIdx.x * kF32Tile, n0 = blockIdx.y * kF32Tile;
  const float inv_keep = 1.f / p.keep_prob;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float acc[4][4] = {};

  for (int k0 = 0; k0 < p.k; k0 += kF32K) {
    __syncthreads();  // the previous stage is consumed
    {  // a: 64 rows x 16, a float4 a thread, stored transposed
      const int r = threadIdx.x >> 2, kq = (threadIdx.x & 3) * 4;
      const int row = row0 + r;
      float4 v = zero;
      if (row < p.rows) {
        v = *reinterpret_cast<const float4*>(p.a + (size_t)row * p.k + k0 + kq);
        if (kFwd) {
          const uint32_t m =
              *reinterpret_cast<const uint32_t*>(p.mask + (size_t)row * p.k + k0 + kq);
          v.x *= (m & 0xffu) ? inv_keep : 0.f;
          v.y *= (m & 0xff00u) ? inv_keep : 0.f;
          v.z *= (m & 0xff0000u) ? inv_keep : 0.f;
          v.w *= (m & 0xff000000u) ? inv_keep : 0.f;
        }
      }
      af[(kq + 0) * kF32Tile + r] = v.x;
      af[(kq + 1) * kF32Tile + r] = v.y;
      af[(kq + 2) * kF32Tile + r] = v.z;
      af[(kq + 3) * kF32Tile + r] = v.w;
    }
    if (kFwd) {  // W2 rows n0 .. (d_out) as [n][k]: stored transposed
      const int n = threadIdx.x >> 2, kq = (threadIdx.x & 3) * 4;
      const float4 v = *reinterpret_cast<const float4*>(p.w2 + (size_t)(n0 + n) * p.k + k0 + kq);
      bf[(kq + 0) * kF32Tile + n] = v.x;
      bf[(kq + 1) * kF32Tile + n] = v.y;
      bf[(kq + 2) * kF32Tile + n] = v.z;
      bf[(kq + 3) * kF32Tile + n] = v.w;
    } else {  // W2 rows k0 .. (d_out) as [k][n]: as stored
      const int kr = threadIdx.x >> 4, nq = threadIdx.x & 15;
      bs[kr][nq] = *reinterpret_cast<const float4*>(p.w2 + (size_t)(k0 + kr) * p.n + n0 + 4 * nq);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kF32K; ++k) {
      const float4 a = as[k][tm], b = bs[k][tn];
      const float av[4] = {a.x, a.y, a.z, a.w}, bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
  }

  const int col = n0 + 4 * tn;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * tm + i;
    if (row >= p.rows) continue;
    float v[4] = {acc[i][0], acc[i][1], acc[i][2], acc[i][3]};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (kFwd)
        v[j] += p.b2[col + j];
      else
        v[j] *= p.mask[(size_t)row * p.n + col + j] ? inv_keep : 0.f;
    }
    *reinterpret_cast<float4*>(p.out + (size_t)row * p.n + col) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <bool kFwd>
cudaError_t launch_tiles(const TileArgs& p, cudaStream_t stream) {
  const dim3 grid((p.rows + kF32Tile - 1) / kF32Tile, p.n / kF32Tile);
  masked_mm_f32<kFwd><<<grid, kF32Threads, 0, stream>>>(p);
  return cudaGetLastError();
}

bool shapes_ok(int rows, int d_ff, int d_out, float keep_prob) {
  return rows >= 1 && d_ff >= 128 && d_ff % 128 == 0 && d_out >= 128 && d_out % 128 == 0 &&
         keep_prob > 0.f;
}

int fwd(const void* h, const void* mask, const void* w2, const void* b2, void* out,
        int rows, int d_ff, int d_out, int is_bf16, float keep_prob, void* stream) {
  if (!shapes_ok(rows, d_ff, d_out, keep_prob)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)sm90::forward(static_cast<const bf16*>(h), static_cast<const uint8_t*>(mask),
                              static_cast<const bf16*>(w2), static_cast<const bf16*>(b2),
                              static_cast<bf16*>(out), rows, d_ff, d_out, keep_prob, s);
  const TileArgs p{static_cast<const float*>(h), static_cast<const float*>(w2),
                          static_cast<const float*>(b2), static_cast<const uint8_t*>(mask),
                          static_cast<float*>(out), rows, d_out, d_ff, keep_prob};
  return (int)launch_tiles<true>(p, s);
}

int bwd(const void* h, const void* mask, const void* dout, const void* w2, void* dh,
        void* dw2, void* db2, void* partial, int rows, int d_ff, int d_out, int is_bf16,
        float keep_prob, void* stream) {
  if (!shapes_ok(rows, d_ff, d_out, keep_prob)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // one split's partials: [dW2 (d_out, d_ff) | db2 (d_out)]
  float* part = static_cast<float*>(partial);
  if (is_bf16)
    return (int)sm90::backward(static_cast<const bf16*>(h), static_cast<const uint8_t*>(mask),
                               static_cast<const bf16*>(dout), static_cast<const bf16*>(w2),
                               static_cast<bf16*>(dh), static_cast<bf16*>(dw2),
                               static_cast<bf16*>(db2), part, rows, d_ff, d_out, keep_prob, s);
  const TileArgs p{static_cast<const float*>(dout), static_cast<const float*>(w2),
                          nullptr, static_cast<const uint8_t*>(mask), static_cast<float*>(dh),
                          rows, d_ff, d_out, keep_prob};
  cudaError_t err = launch_tiles<false>(p, s);
  if (err != cudaSuccess) return (int)err;
  const size_t n_w = (size_t)d_out * d_ff;
  const WeightProblem<float> p_w2{static_cast<const float*>(dout),
                                  static_cast<const float*>(h),
                                  static_cast<const uint8_t*>(mask), part, part + n_w, d_out,
                                  d_ff};
  const WeightProblem<float> none{nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0};
  const SplitOutputs<float, 2> out{{static_cast<float*>(dw2), static_cast<float*>(db2)},
                                   {n_w, n_w + d_out}};
  return (int)launch_weights<true, 2>(p_w2, none, rows, n_w + d_out, keep_prob, out, s);
}

}  // namespace

// h (rows, d_ff), mask (rows, d_ff) bytes (nonzero = keep), w2 (d_out,
// d_ff), b2 (d_out), out (rows, d_out): contiguous, one dtype (is_bf16 = 1:
// bfloat16, 0: float32) for the tensors, 16-byte aligned. d_ff and d_out
// must be multiples of 128, keep_prob in (0, 1]. stream: a cudaStream_t.
// Returns the cudaError_t of the launch (0 = launched); the wrapper raises
// on non-zero.
extern "C" int masked_mm_fwd(const void* h, const void* mask, const void* w2,
                             const void* b2, void* out, int rows, int d_ff, int d_out,
                             int is_bf16, float keep_prob, void* stream) {
  return fwd(h, mask, w2, b2, out, rows, d_ff, d_out, is_bf16, keep_prob, stream);
}

// The backward for the upstream gradient dout (rows, d_out): dh (rows,
// d_ff), dw2 (d_out, d_ff) and db2 (d_out), in the tensors' dtype. partial:
// fp32 scratch of masked_mm_bwd_partial_floats(d_ff, d_out) elements. Three
// kernels on `stream` (dh, the weight product's slices, their reduction);
// returns the first launch's cudaError_t that is not 0, else 0.
extern "C" int masked_mm_bwd(const void* h, const void* mask, const void* dout,
                             const void* w2, void* dh, void* dw2, void* db2, void* partial,
                             int rows, int d_ff, int d_out, int is_bf16, float keep_prob,
                             void* stream) {
  return bwd(h, mask, dout, w2, dh, dw2, db2, partial, rows, d_ff, d_out, is_bf16, keep_prob,
             stream);
}

// The fp32 scratch masked_mm_bwd needs: its most splits' partial sums.
extern "C" long long masked_mm_bwd_partial_floats(int d_ff, int d_out) {
  return (long long)kMaxSplits * ((long long)d_out * d_ff + d_out);
}
