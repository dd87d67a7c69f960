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
// (B, H, round_up(N, 64), 2)): the scores with the forward's very
// instructions (attention_nhd_common.cuh: mma_abt8 for bf16, dot8_f32 for
// fp32), then p = exp(s - m) * (1/l) rounded as the forward rounded it. So
// the bf16 p here is the one the forward fed to P.V. Recomputing p means
// applying the block-diagonal mask again (the saved probabilities were zero
// off the blocks; recomputed ones would not be), and zeroing rows and keys
// past N.
//
// What bounds it on an H100 SXM: bytes. At the training shape (256, 145,
// 6x64) bf16 it must read q, k, v, do (4 x 57 MB) and the statistics
// (1.8 MB) and write dq, dk, dv (3 x 57 MB): about 200 MB, 60 us at
// 3.35 TB/s, against 21 GFLOP of products, 21 us at the 989 TFLOP/s bf16
// tensor-core rate (data sheet). At the packed locals (128, 148, 6x64,
// block_size 37) it is about 30 us.
//
// The kernel bodies (a dq kernel and a dk/dv kernel, bf16 on the tensor
// cores, fp32 on the CUDA cores) and how their design answers that bound
// are in attention_bwd.cuh, shared with kernel B3 (fused_attention.cu).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (vit_ssl_tpu_torch/kernels.py); called through
// ctypes from vit_ssl_tpu_torch/ops/flash_attention.py::attention_nhd_bwd.

#include "attention_bwd.cuh"

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
  return bwd_dispatch<false>(q, k, v, dout, stats, dq, dk, dv, delta, batch, n, heads,
                             head_dim, is_bf16, scale, block_size, stream);
}
