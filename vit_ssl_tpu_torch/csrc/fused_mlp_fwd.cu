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
// (data sheet). bfloat16 runs two wgmma/TMA products (mlp_gemm_sm90.cuh):
// fc1 writes pre (training) and h = round(gelu(pre) [* mask / keep]) to
// (T, d_ff) scratch from its epilogue, fc2 reads h back and writes out.
// Both entries run the same two kernels, so their outputs are equal bit
// for bit. float32 runs the CUDA-core row kernel of fused_mlp_common.cuh
// (full fp32 products, the activation chunk by chunk in shared memory).
// Two entry points:
//
// - fused_mlp_fwd: no saved pre (serving, eval, the DINO teacher);
// - fused_mlp_fwd_pre: the training forward, pre saved for fused_mlp_bwd.
//
// Each takes a keep-mask or null.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (vit_ssl_tpu_torch/kernels.py); called through
// ctypes from vit_ssl_tpu_torch/ops/fused_mlp.py.

#include "fused_mlp_common.cuh"
#include "mlp_gemm_sm90.cuh"

namespace {

template <int D, bool kMask, bool kPre>
cudaError_t launch_f32(const RowArgs<float>& p, cudaStream_t stream) {
  using S = F32Tile<D>;
  auto kernel = mlp_rows_f32<D, false, kMask, kPre>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(p.rows + S::kRows - 1) / S::kRows, kF32Threads, S::bytes, stream>>>(p);
  return cudaGetLastError();
}

template <bool kMask, bool kPre>
cudaError_t launch_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                        const void* b2, const void* mask, void* out, void* pre, void* h,
                        int rows, int d_model, int d_ff, float keep_prob,
                        cudaStream_t stream) {
  return sm90::mlp_forward<kMask, kPre>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(b2), static_cast<const uint8_t*>(mask),
      static_cast<bf16*>(out), static_cast<bf16*>(pre), static_cast<bf16*>(h), rows, d_model,
      d_ff, keep_prob, stream);
}

int fwd(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
        const void* mask, void* out, void* pre, void* h, int rows, int d_model, int d_ff,
        int is_bf16, float keep_prob, void* stream) {
  if (out == nullptr || rows < 1 || d_ff < 128 || d_ff % 128 != 0 ||
      (mask != nullptr && !(keep_prob > 0.f)) || (is_bf16 && h == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool with_mask = mask != nullptr, with_pre = pre != nullptr;
  if (is_bf16)
    return (int)for_d_model(d_model, [&](auto) {
      if (with_mask)
        return with_pre ? launch_bf16<true, true>(x, w1, b1, w2, b2, mask, out, pre, h, rows,
                                                  d_model, d_ff, keep_prob, s)
                        : launch_bf16<true, false>(x, w1, b1, w2, b2, mask, out, pre, h,
                                                   rows, d_model, d_ff, keep_prob, s);
      return with_pre ? launch_bf16<false, true>(x, w1, b1, w2, b2, mask, out, pre, h, rows,
                                                 d_model, d_ff, keep_prob, s)
                      : launch_bf16<false, false>(x, w1, b1, w2, b2, mask, out, pre, h, rows,
                                                  d_model, d_ff, keep_prob, s);
    });
  RowArgs<float> p{static_cast<const float*>(x), static_cast<const float*>(w1),
                   static_cast<const float*>(b1), static_cast<const float*>(w2),
                   static_cast<const float*>(b2), static_cast<const uint8_t*>(mask),
                   static_cast<float*>(pre), static_cast<float*>(out), nullptr, nullptr,
                   rows, d_ff, keep_prob};
  return (int)for_d_model(d_model, [&](auto dm) {
    constexpr int D = decltype(dm)::value;
    if (with_mask)
      return with_pre ? launch_f32<D, true, true>(p, s) : launch_f32<D, true, false>(p, s);
    return with_pre ? launch_f32<D, false, true>(p, s) : launch_f32<D, false, false>(p, s);
  });
}

}  // namespace

// x (rows, d_model), w1 (d_ff, d_model), b1 (d_ff), w2 (d_model, d_ff),
// b2 (d_model), out (rows, d_model): contiguous, one dtype (is_bf16 = 1:
// bfloat16, 0: float32), 16-byte aligned. h: (rows, d_ff) scratch in that
// dtype for bfloat16 (the activation between the two products), unused
// (may be null) for float32. mask: (rows, d_ff) bytes, nonzero = keep, or
// null (no dropout; keep_prob unused). d_model must be 384, 768 or 1024 and
// d_ff a multiple of 128. stream: a cudaStream_t. Returns the cudaError_t
// of the launches (0 = launched); the wrapper raises on non-zero.
extern "C" int fused_mlp_fwd(const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, const void* mask,
                             void* out, void* h, int rows, int d_model, int d_ff,
                             int is_bf16, float keep_prob, void* stream) {
  return fwd(x, w1, b1, w2, b2, mask, out, nullptr, h, rows, d_model, d_ff, is_bf16,
             keep_prob, stream);
}

// The training forward: fused_mlp_fwd's output, bit for bit, and pre
// (rows, d_ff) in the input dtype.
extern "C" int fused_mlp_fwd_pre(const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* b2, const void* mask,
                                 void* out, void* pre, void* h, int rows, int d_model,
                                 int d_ff, int is_bf16, float keep_prob, void* stream) {
  if (pre == nullptr) return (int)cudaErrorInvalidValue;
  return fwd(x, w1, b1, w2, b2, mask, out, pre, h, rows, d_model, d_ff, is_bf16, keep_prob,
             stream);
}
