// Multi-head attention forward on the (B, N, H*D) projection layout, for
// Hopper (sm_90a): kernel B1's forward, inference and training.
//
// Replaces the TPU kernel vit_ssl_tpu/ops/flash_attention.py::_nhd_fwd_kernel
// in both of its pallas_calls in _attention_nhd_fwd_impl: the inference call
// (no probabilities) is the C entry attention_nhd_fwd; the training call,
// which saves the (B, H, N, N) probabilities for the backward, is the C
// entry attention_nhd_fwd_stats, which instead saves the softmax statistics
// of each row (see below). Same math and the same rounding points:
//
//   s  = (q_h . k_h^T) * scale            fp32 products and sums
//   s  = -inf where i/bs != j/bs          only when block_size > 0
//   p  = exp(s - rowmax(s)) ; l = rowsum(p)   fp32
//   pn = (p / l) cast to the input dtype  normalise, THEN round
//   o  = pn . v_h                         fp32 accumulation, cast on store
//
// q, k, v and o are read and written in place in (B, N, H*D): head h of
// token i lives at [b, i, h*D : (h+1)*D]. No transpose exists anywhere.
//
// Softmax statistics (training entry): stats is fp32 (B, H, Np, 2) with
// Np = round_up(N, 64); [b, h, i] holds (m, 1/l), m the row max of the
// scaled, masked scores and l the row sum of exp(s - m). The backward
// (attention_nhd_bwd.cu) recomputes the scores with the same instructions
// and rebuilds, from (m, 1/l), the very bf16 pn that this kernel fed to
// P.V. Rows at or past N are not written: the caller zero-fills stats, and
// (m, 1/l) = (0, 0) makes those rows' probabilities zero. The two entries
// run one kernel; the output is the same bit for bit.
//
// What bounds it on an H100 SXM: bytes. At the serving shape (128, 145,
// 6x64) bf16 q/k/v/o move 4 * 128*145*384 * 2 B = 57 MB, 17 us at
// 3.35 TB/s, against 4.1 GFLOP, 4.2 us at the 989 TFLOP/s bf16 tensor-core
// rate (data sheet). At the teacher's and the student globals' (256, 145,
// 6x64) 114 MB, 34 us (training: plus 1.8 MB of statistics, 35 us),
// against 8 us of operations; at the packed locals (128, 148, 6x64, block
// 37) 59 MB, 18 us, against 1 us.
//
// The bfloat16 body is the Hopper forward of attention_fwd_sm90.cuh
// (wgmma, TMA; one pass over the keys at N <= 256, two above), shared
// with kernel B3; how its design answers that bound is written there. The
// float32 body runs on the CUDA cores (attention_fwd.cuh). The dispatch is
// by dtype alone: a bf16 call that the Hopper body refuses (a scale <= 0,
// a tensor map cuTensorMapEncodeTiled refuses) fails; it never takes another
// body.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (vit_ssl_tpu_torch/kernels.py); called through
// ctypes from vit_ssl_tpu_torch/ops/flash_attention.py.

#include "attention_fwd.cuh"      // float32
#include "attention_fwd_sm90.cuh"  // bfloat16

// q, k, v, o: contiguous (batch, n, heads * head_dim) of one dtype
// (is_bf16 = 1: bfloat16, 0: float32), 16-byte aligned; bf16 takes
// scale > 0 only (the Hopper body folds it into the exponent). stream: a
// cudaStream_t. Returns the cudaError_t of the launch (0 = launched); the
// wrapper raises on non-zero.
extern "C" int attention_nhd_fwd(const void* q, const void* k, const void* v,
                                 void* o, int batch, int n, int heads,
                                 int head_dim, int is_bf16, float scale,
                                 int block_size, void* stream) {
  if (o == nullptr) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return sm90::dispatch<false>(q, k, v, o, nullptr, batch, n, heads, head_dim, scale,
                                 block_size, stream);
  return fwd_dispatch<false>(q, k, v, o, nullptr, batch, n, heads, head_dim, scale,
                             block_size, stream);
}

// The training forward: attention_nhd_fwd's output, bit for bit, and the
// softmax statistics. stats: fp32 (batch, heads, round_up(n, 64), 2),
// zero-filled by the caller; rows < n get (row max, 1 / row sum).
extern "C" int attention_nhd_fwd_stats(const void* q, const void* k, const void* v,
                                       void* o, void* stats, int batch, int n,
                                       int heads, int head_dim, int is_bf16,
                                       float scale, int block_size, void* stream) {
  if (o == nullptr || stats == nullptr) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return sm90::dispatch<false>(q, k, v, o, stats, batch, n, heads, head_dim, scale,
                                 block_size, stream);
  return fwd_dispatch<false>(q, k, v, o, stats, batch, n, heads, head_dim, scale,
                             block_size, stream);
}
