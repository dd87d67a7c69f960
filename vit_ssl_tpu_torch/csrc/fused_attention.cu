// Multi-head attention on the head-major (B, H, N, D) layout, for Hopper
// (sm_90a): kernel B3, forward (inference and training) and backward.
//
// Replaces the TPU kernels of vit_ssl_tpu/ops/flash_attention.py::
// fused_attention: _attn_kernel in both pallas_calls of
// _fused_attention_fwd_impl (the inference call is the C entry
// fused_attention_fwd; the training call, which saves the (B*H, N_pad,
// N_pad) probabilities, is fused_attention_fwd_stats, which saves each
// row's softmax statistics (m, 1/l) instead), and _attn_bwd_kernel in
// _fused_attention_bwd_impl (fused_attention_bwd, which rebuilds the
// rounded probabilities from q, k and the statistics). Same math and the
// same rounding points as kernel B1 without its mask: the TPU kernel pads N
// to a multiple of 8 and sets the padded keys to -inf; here the ragged edge
// is masked inside the kernel and nothing is padded.
//
// B3 computes B1's function on another layout: head h of token i of image
// b at [((b*H + h)*N + i)*D], one head's rows contiguous, D elements apart
// (B1: H*D apart). The JAX package sends a self-attention here when B1 does
// not fit the TPU's VMEM (ViT-B/16 at 384 px: N = 577, 12 heads of 64).
// The bfloat16 forward is the Hopper body B1 shares (attention_fwd_sm90.cuh:
// wgmma, TMA, its two-pass form at every N here); the bfloat16 backward is
// the Hopper backward B1 and B2 share (attention_bwd_sm90.cuh, instantiated
// here in B3's (m, 1/l) form on its layout); the float32 forward and
// backward (CUDA cores) are B1's kernel bodies (attention_fwd.cuh,
// attention_bwd.cuh).
// All are instantiated with kHeadMajor. The dispatch is by dtype alone.
//
// What bounds it on an H100 SXM, at ViT-B/16's (64, 12, 577, 64) bf16
// (56.7 MB a tensor, 32.7 GFLOP a product; data sheet: 3.35 TB/s, 989
// TFLOP/s bf16):
//   inference forward  q, k, v, o 227 MB, 0.068 ms; 2 products 0.066 ms
//   training forward   + 3.5 MB of statistics, 0.069 ms: bytes
//   backward           q, k, v, do, dq, dk, dv + statistics 401 MB,
//                      0.120 ms; 5 products (the scores again, dv, dp, dq,
//                      dk) 0.165 ms: operations
// Reading JAX's saved probabilities instead would save one product but
// move 511 MB more.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (vit_ssl_tpu_torch/kernels.py); called through
// ctypes from vit_ssl_tpu_torch/ops/flash_attention.py::fused_attention_*.

#include "attention_bwd.cuh"
#include "attention_bwd_sm90.cuh"
#include "attention_fwd.cuh"
#include "attention_fwd_sm90.cuh"

// q, k, v, o: contiguous (batch, heads, n, head_dim) of one dtype
// (is_bf16 = 1: bfloat16, 0: float32), 16-byte aligned. stream: a
// cudaStream_t. Returns the cudaError_t of the launch (0 = launched); the
// wrapper raises on non-zero.
extern "C" int fused_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int batch, int n, int heads, int head_dim,
                                   int is_bf16, float scale, void* stream) {
  if (o == nullptr) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return sm90::dispatch<true>(q, k, v, o, nullptr, batch, n, heads, head_dim, scale, 0,
                                stream);
  return fwd_dispatch<true>(q, k, v, o, nullptr, batch, n, heads, head_dim, scale, 0,
                            stream);
}

// The training forward: fused_attention_fwd's output, bit for bit, and the
// softmax statistics. stats: fp32 (batch, heads, round_up(n, 64), 2),
// zero-filled by the caller; rows < n get (row max, 1 / row sum).
extern "C" int fused_attention_fwd_stats(const void* q, const void* k, const void* v,
                                         void* o, void* stats, int batch, int n,
                                         int heads, int head_dim, int is_bf16,
                                         float scale, void* stream) {
  if (o == nullptr || stats == nullptr) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return sm90::dispatch<true>(q, k, v, o, stats, batch, n, heads, head_dim, scale, 0,
                                stream);
  return fwd_dispatch<true>(q, k, v, o, stats, batch, n, heads, head_dim, scale, 0,
                            stream);
}

// q, k, v, dout (the upstream gradient, already in the input dtype), dq, dk,
// dv: contiguous (batch, heads, n, head_dim) of one dtype, 16-byte aligned.
// stats: from fused_attention_fwd_stats. delta: fp32 scratch (batch, heads,
// round_up(n, 64)), zero-filled by the caller. Launches two kernels;
// returns the first non-zero cudaError_t (0 = both launched).
extern "C" int fused_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* dout, const void* stats, void* dq,
                                   void* dk, void* dv, void* delta, int batch, int n,
                                   int heads, int head_dim, int is_bf16, float scale,
                                   void* stream) {
  if (is_bf16) {
    if (sm90::bad_bwd_sizes(batch, n, heads, scale) || n > kMaxSeq || stats == nullptr ||
        delta == nullptr)
      return (int)cudaErrorInvalidValue;
    return sm90::for_head_dim(head_dim, [&](auto d) {
      return sm90::launch_bwd<decltype(d)::value>(q, k, v, dout, stats, dq, dk, dv, delta,
                                                  batch, n, heads, scale,
                                                  static_cast<cudaStream_t>(stream));
    });
  }
  return bwd_dispatch<true>(q, k, v, dout, stats, dq, dk, dv, delta, batch, n, heads,
                            head_dim, scale, 0, stream);
}
