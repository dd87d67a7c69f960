// Fused MLP forward for Hopper (sm_90a): kernel B4's forward.
//
// Replaces the TPU kernels vit_ssl_tpu/ops/fused_mlp.py::_mlp_kernel and
// _mlp_dropout_kernel, both pallas_calls of _fused_mlp_impl, with and
// without the saved pre-activation:
//
//   pre = x . W1^T + b1        fp32 sums, b1 taken to fp32
//   pre stored in x's dtype    (fused_mlp_fwd_pre only: the backward's input)
//   h   = gelu(pre)            exact erf GELU on the UNROUNDED fp32 pre
//   h   = h * (mask / keep)    fp32, only with a keep-mask
//   out = round(h) . W2^T + b2 h rounded to x's dtype before the product;
//                              fp32 sums plus b2, rounded on the store
//
// x is (T, d_model), W1 (d_ff, d_model), W2 (d_model, d_ff): the nn.Linear
// layout the module holds, so no transpose is made per call. The JAX kernel
// evaluates erf with the Abramowitz-Stegun polynomial (|error| <= 1.5e-7);
// this one with erff.
//
// What bounds it on an H100 SXM: operations. At the student's globals
// (T = 37120, d_model 384, d_ff 1536, bf16) the two products are 87.6
// GFLOP, 0.089 ms at the 989 TFLOP/s bf16 tensor-core rate, against about
// 0.07 ms to move x, the weights, the int8 mask, out and the saved pre
// (data sheet). How the design answers that: the (T, d_ff) activation
// never reaches device memory (one 64 x 32 chunk of it lives in shared
// memory at a time; 32 x 16 at d_model 768 and 1024), the products run on
// the tensor cores (mma.sync bf16, fp32 sums), the block's x tile is read
// once and the weight chunks stream through two cp.async buffers. The
// weights are re-read by every block from L2 (2.4 MB a 64-row block at
// 384; 9.4 MB a 32-row block at ViT-B's 768 / 3072). Two entry points:
//
// - fused_mlp_fwd: no saved pre (serving, eval, the DINO teacher);
// - fused_mlp_fwd_pre: the training forward, pre saved for fused_mlp_bwd.
//
// Each takes a keep-mask or null. float32 runs on the CUDA cores (full
// fp32 products); the main path is bf16.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (vit_ssl_tpu_torch/kernels.py); called through
// ctypes from vit_ssl_tpu_torch/ops/fused_mlp.py.

#include "fused_mlp_common.cuh"

namespace {

template <int D, typename T, bool kMask, bool kPre>
cudaError_t launch(const RowArgs<T>& p, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    using S = RowTile<D>;
    auto kernel = mlp_rows_bf16<D, false, kMask, kPre>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::bytes);
    if (err != cudaSuccess) return err;
    kernel<<<(p.rows + S::kRows - 1) / S::kRows, kMlpThreads, S::bytes, stream>>>(p);
  } else {
    using S = F32Tile<D>;
    auto kernel = mlp_rows_f32<D, false, kMask, kPre>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::bytes);
    if (err != cudaSuccess) return err;
    kernel<<<(p.rows + S::kRows - 1) / S::kRows, kF32Threads, S::bytes, stream>>>(p);
  }
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* w1, const void* b1, const void* w2,
             const void* b2, const void* mask, void* out, void* pre, int rows,
             int d_model, int d_ff, float keep_prob, void* stream) {
  if (rows < 1 || d_ff < 128 || d_ff % 128 != 0 ||
      (mask != nullptr && !(keep_prob > 0.f)))
    return (int)cudaErrorInvalidValue;
  RowArgs<T> p{static_cast<const T*>(x), static_cast<const T*>(w1),
               static_cast<const T*>(b1), static_cast<const T*>(w2),
               static_cast<const T*>(b2), static_cast<const uint8_t*>(mask),
               static_cast<T*>(pre), static_cast<T*>(out), nullptr, nullptr,
               rows, d_ff, keep_prob};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)for_d_model(d_model, [&](auto dm) {
    constexpr int D = decltype(dm)::value;
    if (mask != nullptr)
      return pre != nullptr ? launch<D, T, true, true>(p, s) : launch<D, T, true, false>(p, s);
    return pre != nullptr ? launch<D, T, false, true>(p, s) : launch<D, T, false, false>(p, s);
  });
}

int fwd(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
        const void* mask, void* out, void* pre, int rows, int d_model, int d_ff,
        int is_bf16, float keep_prob, void* stream) {
  if (out == nullptr) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return dispatch<bf16>(x, w1, b1, w2, b2, mask, out, pre, rows, d_model, d_ff,
                          keep_prob, stream);
  return dispatch<float>(x, w1, b1, w2, b2, mask, out, pre, rows, d_model, d_ff,
                         keep_prob, stream);
}

}  // namespace

// x (rows, d_model), w1 (d_ff, d_model), b1 (d_ff), w2 (d_model, d_ff),
// b2 (d_model), out (rows, d_model): contiguous, one dtype (is_bf16 = 1:
// bfloat16, 0: float32), 16-byte aligned. mask: (rows, d_ff) bytes, nonzero
// = keep, or null (no dropout; keep_prob unused). d_model must be 384, 768
// or 1024 and d_ff a multiple of 128. stream: a cudaStream_t. Returns the cudaError_t of
// the launch (0 = launched); the wrapper raises on non-zero.
extern "C" int fused_mlp_fwd(const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, const void* mask,
                             void* out, int rows, int d_model, int d_ff, int is_bf16,
                             float keep_prob, void* stream) {
  return fwd(x, w1, b1, w2, b2, mask, out, nullptr, rows, d_model, d_ff, is_bf16,
             keep_prob, stream);
}

// The training forward: fused_mlp_fwd's output, bit for bit, and pre
// (rows, d_ff) in the input dtype.
extern "C" int fused_mlp_fwd_pre(const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* b2, const void* mask,
                                 void* out, void* pre, int rows, int d_model, int d_ff,
                                 int is_bf16, float keep_prob, void* stream) {
  if (pre == nullptr) return (int)cudaErrorInvalidValue;
  return fwd(x, w1, b1, w2, b2, mask, out, pre, rows, d_model, d_ff, is_bf16, keep_prob,
             stream);
}
