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
// Blocks on Hopper run in parallel and in no order, so the weight
// gradients are summed over fixed slices of the rows into fp32 partials
// and a reduction adds the slices in slice order: no atomics, the results
// repeat run to run. bfloat16, on wgmma and TMA (mlp_gemm_sm90.cuh):
//
// 1. dh = do . W2 (W2 read MN-major), its epilogue writing dpre and
//    h = round(gelu(pre) [* mask / keep]) to (T, d_ff) scratch;
// 2. dx = dpre . W1 (W1 read MN-major);
// 3. dW1 = dpre^T . x and dW2 = do^T . h in one grid, both operands
//    MN-major, each block one 128 x 128 tile over one slice of the rows,
//    and the blocks on a tile's first column the bias sums (A^T . 1);
// 4. reduce_splits (weight_grad.cuh) adds the slices and rounds.
//
// The slice count fills whole waves of blocks (two an SM) where it can:
// weight_grad.cuh's gemm_splits. float32 runs the CUDA-core row kernel
// (fused_mlp_common.cuh, run backward) and weight kernel (weight_grad.cuh)
// over the same partials.
//
// What bounds it on an H100 SXM: operations. At T = 37120 (d_model 384,
// d_ff 1536, bf16) the four products are 175 GFLOP, 0.177 ms at the 989
// TFLOP/s bf16 rate, against about 0.08 ms to move x, pre, do, the mask,
// the weights and the gradients once (data sheet). The split adds dpre and
// h, written by the first kernel and read by the others: 4 x 114 MB at
// T = 37120, about 0.14 ms more at 3.35 TB/s.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (vit_ssl_tpu_torch/kernels.py); called through
// ctypes from vit_ssl_tpu_torch/ops/fused_mlp.py.

#include "mlp_gemm_sm90.cuh"
#include "weight_grad.cuh"

namespace {

// ---------------------------------------------------------------------------
// launch

template <int D, bool kMask>
cudaError_t launch_rows_f32(const RowArgs<float>& p, cudaStream_t stream) {
  using S = F32Tile<D>;
  auto kernel = mlp_rows_f32<D, true, kMask, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(p.rows + S::kRows - 1) / S::kRows, kF32Threads, S::bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* pre, const void* dout, const void* w1,
             const void* w2, const void* mask, void* dx, void* dw1, void* db1,
             void* dw2, void* db2, void* dpre, void* h, void* partial, int rows,
             int d_model, int d_ff, float keep_prob, void* stream) {
  if (rows < 1 || d_ff < sm90::kGemmCols || d_ff % sm90::kGemmCols != 0 ||
      (mask != nullptr && !(keep_prob > 0.f)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // one split's partials: [dW1 (d_ff, d_model) | dW2 (d_model, d_ff) | db1 | db2]
  float* part = static_cast<float*>(partial);
  const size_t n_w = (size_t)d_model * d_ff;
  const size_t split_stride = 2 * n_w + d_ff + d_model;
  const SplitOutputs<T, 4> out{
      {static_cast<T*>(dw1), static_cast<T*>(dw2), static_cast<T*>(db1), static_cast<T*>(db2)},
      {n_w, 2 * n_w, 2 * n_w + d_ff, split_stride}};
  if constexpr (sizeof(T) == 2) {
    const int splits =
        gemm_splits(2 * (d_ff / sm90::kGemmCols) * (d_model / sm90::kGemmCols),
                    (rows + sm90::kGemmK - 1) / sm90::kGemmK, 2);
    cudaError_t err = for_d_model(d_model, [&](auto) {
      auto run = [&](auto with_mask) {
        return sm90::mlp_backward<decltype(with_mask)::value>(
            static_cast<const bf16*>(x), static_cast<const bf16*>(pre),
            static_cast<const bf16*>(dout), static_cast<const bf16*>(w1),
            static_cast<const bf16*>(w2), static_cast<const uint8_t*>(mask),
            static_cast<bf16*>(dx), static_cast<bf16*>(dpre), static_cast<bf16*>(h), part,
            split_stride, splits, rows, d_model, d_ff, keep_prob, s);
      };
      return mask != nullptr ? run(std::true_type{}) : run(std::false_type{});
    });
    if (err != cudaSuccess) return (int)err;
    reduce_splits<T, 4><<<kReduceBlocks, 256, 0, s>>>(part, split_stride, splits, out);
    return (int)cudaGetLastError();
  } else {
    RowArgs<T> p{static_cast<const T*>(dout), static_cast<const T*>(w1), nullptr,
                 static_cast<const T*>(w2), nullptr, static_cast<const uint8_t*>(mask),
                 const_cast<T*>(static_cast<const T*>(pre)), static_cast<T*>(dx),
                 static_cast<T*>(dpre), static_cast<T*>(h), rows, d_ff, keep_prob};
    cudaError_t err = for_d_model(d_model, [&](auto dm) {
      constexpr int D = decltype(dm)::value;
      return mask != nullptr ? launch_rows_f32<D, true>(p, s) : launch_rows_f32<D, false>(p, s);
    });
    if (err != cudaSuccess) return (int)err;
    const WeightProblem<T> p_w1{static_cast<const T*>(dpre), static_cast<const T*>(x),
                                nullptr, part, part + 2 * n_w, d_ff, d_model};
    const WeightProblem<T> p_w2{static_cast<const T*>(dout), static_cast<const T*>(h),
                                nullptr, part + n_w, part + 2 * n_w + d_ff, d_model, d_ff};
    return (int)launch_weights<false, 4>(p_w1, p_w2, rows, split_stride, 1.f, out, s);
  }
}

}  // namespace

// x, dout, dx: (rows, d_model); pre, and the scratch dpre and h: (rows,
// d_ff); w1, dw1: (d_ff, d_model); w2, dw2: (d_model, d_ff); db1 (d_ff),
// db2 (d_model). All contiguous, one dtype (is_bf16 = 1: bfloat16, 0:
// float32), 16-byte aligned. partial: fp32 scratch of
// fused_mlp_bwd_partial_floats(d_model, d_ff) elements. mask: (rows, d_ff)
// bytes, nonzero = keep, or null. d_model must be 384, 768 or 1024 and d_ff
// a multiple of 128. Four kernels on `stream` (a cudaStream_t; float32:
// three); returns the first launch's cudaError_t that is not 0, else 0; the
// wrapper raises on non-zero.
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
