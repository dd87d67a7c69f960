// Multi-head attention backward on the (B, N, H*D) projection layout, for
// Hopper (sm_90a): kernel B1's backward.
//
// Replaces the TPU kernel vit_ssl_tpu/ops/flash_attention.py::_nhd_bwd_kernel
// (the pallas_call of _attention_nhd_vjp_bwd). Same math and the same
// rounding points, per head:
//
//   p     = the forward's normalised probabilities, rounded to the input dtype
//   dv    = p^T . do                        fp32 accumulation
//   dp    = do . v^T                        fp32
//   delta = sum_j p * dp                    fp32, per query row
//   ds    = (p * (dp - delta) * scale) rounded to the input dtype
//   dq    = ds . k ; dk = ds^T . q          fp32 accumulation
//
// each result cast to the input dtype on store; do arrives already cast to
// the input dtype. The TPU kernel reads the (B, H, N, N) probabilities its
// training forward saved; this one recomputes them from q, k and the
// softmax statistics (m, 1/l) that attention_nhd_fwd_stats saved (fp32,
// (B, H, round_up(N, 64), 2)), with the forward's own instructions (bf16:
// the same wgmma scores; fp32: dot8_f32), so p is the forward's bit for
// bit (bf16: in the dq kernel, whose scores are Q.K^T). Recomputing p
// means applying the block-diagonal mask again (the saved probabilities
// were zero off the blocks; recomputed ones would not be), and zeroing rows
// and keys past N.
//
// What bounds it on an H100 SXM: bytes. At the training shape (256, 145,
// 6x64) bf16 it must read q, k, v, do (4 x 57 MB) and the statistics
// (1.8 MB) and write dq, dk, dv (3 x 57 MB): about 200 MB, 60 us at
// 3.35 TB/s, against 21 GFLOP of products, 21 us at the 989 TFLOP/s bf16
// tensor-core rate (data sheet). At the packed locals (128, 148, 6x64,
// block_size 37) it is about 31 us.
//
// bfloat16 runs the Hopper backward of attention_bwd_sm90.cuh (wgmma, TMA;
// B3's and B2's body) on B1's layout, with the mask: at n <= 256 (DINO's
// N = 145 and 148) in its resident form (64-row blocks, several an SM,
// every tile a block needs loaded once; under the mask the tiles off a
// block's diagonal blocks are skipped), above in its streamed form (128-row
// blocks, a ring of tiles). Its design and how it answers the bound are
// written there; ops/flash_attention.py::attention_nhd_bwd_form names the
// rule. It takes scale > 0 only. float32 runs the CUDA-core bodies of
// attention_bwd.cuh (shared with kernel B3, fused_attention.cu).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (vit_ssl_tpu_torch/kernels.py); called through
// ctypes from vit_ssl_tpu_torch/ops/flash_attention.py::attention_nhd_bwd.

#include "attention_bwd.cuh"       // float32
#include "attention_bwd_sm90.cuh"  // bfloat16

// q, k, v, dout (the upstream gradient, already in the input dtype), dq, dk,
// dv: contiguous (batch, n, heads * head_dim) of one dtype (is_bf16 = 1:
// bfloat16, 0: float32), 16-byte aligned. stats: fp32 (batch, heads,
// round_up(n, 64), 2) from attention_nhd_fwd_stats. delta: fp32 scratch
// (batch, heads, round_up(n, 64)), zero-filled by the caller. stream: a
// cudaStream_t. Launches two kernels; returns the first non-zero
// cudaError_t (0 = both launched); the wrapper raises on non-zero.
extern "C" int attention_nhd_bwd(const void* q, const void* k, const void* v,
                                 const void* dout, const void* stats, void* dq,
                                 void* dk, void* dv, void* delta, int batch, int n,
                                 int heads, int head_dim, int is_bf16, float scale,
                                 int block_size, void* stream) {
  if (is_bf16) {
    if (sm90::bad_bwd_sizes(batch, n, heads, scale) || n > kMaxSeq || block_size < 0 ||
        stats == nullptr || delta == nullptr)
      return (int)cudaErrorInvalidValue;
    return sm90::for_head_dim(head_dim, [&](auto d) {
      return sm90::launch_nhd_bwd<decltype(d)::value>(q, k, v, dout, stats, dq, dk, dv, delta,
                                                      batch, n, heads, scale, block_size,
                                                      static_cast<cudaStream_t>(stream));
    });
  }
  return bwd_dispatch<false>(q, k, v, dout, stats, dq, dk, dv, delta, batch, n, heads,
                             head_dim, scale, block_size, stream);
}
