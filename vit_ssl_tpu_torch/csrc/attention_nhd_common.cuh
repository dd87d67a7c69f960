// Device helpers shared by the attention kernels of kernels B1 and B3
// (attention_fwd.cuh, attention_bwd.cuh, and the Hopper bodies through
// sm90_common.cuh) and the fused MLP: the two layouts, the block-diagonal
// mask's spans, warp reductions, the bf16 mma.sync / ldmatrix / cp.async
// building blocks and the fp32 tile loads and dot products.
//
// The fp32 forward and backward compute the scores with the very same
// instruction sequence (dot8_f32), so that the backward rebuilds the
// forward's probabilities bit for bit. In bf16 both B1 and B3 compute their
// scores by wgmma.m64n64k16 with the same operands in the Hopper forward
// and in the Hopper backward's dq kernel.
//
// kernels.py rebuilds a library when this header is newer than it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMaxSeq = 1024;
constexpr int kKTile = 64;  // rows per shared-memory tile

__device__ __forceinline__ float quad_max(float x) {  // over the 4 lanes of a row
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Where the n rows of head h of image b lie. B1 reads the projections'
// (B, N, H*D) layout: head h of token i at [(b*N + i)*H*D + h*D], rows H*D
// apart. B3 reads the head-major (B, H, N, D) layout: at
// [((b*H + h)*N + i)*D], rows D apart, one head's rows contiguous. The
// kernels take every address from these two numbers, so one body serves
// both layouts.
struct HeadRows {
  size_t base;  // element offset of row 0
  int stride;   // elements from one row to the next
};

template <bool kHeadMajor, int D>
__device__ __forceinline__ HeadRows head_rows(int b, int h, int n, int heads) {
  if (kHeadMajor) return {((size_t)b * heads + h) * n * D, D};
  return {(size_t)b * n * heads * D + (size_t)h * D, heads * D};
}

// The keys [lo, hi) that query `row` attends: its diagonal block of the
// block-diagonal mask (row / bs == col / bs), or all n keys when
// block_size is 0; empty for a row at or past n. The mask is symmetric, so
// the same span gives the queries that attend key `row`. A score is kept
// iff its column lies in the span: two compares, no division.
struct Span {
  int lo, hi;
  __device__ __forceinline__ bool has(int col) const { return col >= lo && col < hi; }
};

__device__ __forceinline__ Span key_span(int row, int n, int block_size) {
  if (row >= n) return {0, 0};
  if (block_size == 0) return {0, n};
  const int lo = row - row % block_size;
  return {lo, min(lo + block_size, n)};
}

// The keys any of `rows` rows row0 .. row0 + rows - 1 attends (row0 < n):
// tiles outside it hold no kept score for those rows and may be skipped.
__device__ __forceinline__ Span rows_key_span(int row0, int rows, int n, int block_size) {
  return {key_span(row0, n, block_size).lo,
          key_span(min(row0 + rows - 1, n - 1), n, block_size).hi};
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores

constexpr int kBPad = 8;                 // row padding in bf16: 16-byte rows
                                         // whose 8 neighbours sit 4 banks apart

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two floats rounded to bf16 in one register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// The two halves of a pack_bf16 register, back as floats (exact).
__device__ __forceinline__ float bf16_lo(uint32_t r) { return __uint_as_float(r << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t r) { return __uint_as_float(r & 0xffff0000u); }

// c += a . b on one 16x8 fp32 tile; a is 16x16 bf16 (row), b 16x8 (col).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, one row address per lane
// (lanes 8i .. 8i+7 give matrix i's rows): mma B fragments of a row-major
// tile, as stored (K: [key][d] is B = K^T's column-major form) or, with
// kTrans, transposed (V: [key][d] is B's row-major form).
template <bool kTrans>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  if (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit; 2^-inf = 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes from global to shared memory without passing through registers;
// with pred false nothing is read and the 16 bytes are zero.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `pending` committed groups are still in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(pending) : "memory");
}

// ---------------------------------------------------------------------------
// float32 on the CUDA cores

constexpr int kThreads = 256;  // 8 warps
constexpr int kPad = 4;        // row padding in floats: keeps float4 alignment
                               // and puts neighbouring rows 4 banks apart

// Rows [row0, row0 + rows) of one head into a padded shared tile. Rows at
// or past n are zero.
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* __restrict__ src,
                                              int row0, int rows, int n,
                                              int row_stride) {
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int g = row0 + r;
    dst[r * (D + kPad) + c] = g < n ? src[(size_t)g * row_stride + c] : 0.f;
  }
}

// acc[j] = a . rows[sub + 8j] for j < 8: one padded shared row against 8
// rows of a padded shared tile, over D floats, one fma at a time in order
// of d. The forward and the backward compute their fp32 scores with it, so
// the backward's scores are the forward's bit for bit. Thread (r, sub) of a
// row's 8 threads reads rows 4 banks apart (no conflicts).
template <int D>
__device__ __forceinline__ void dot8_f32(float (&acc)[8], const float* a,
                                         const float* rows, int sub) {
  const float4* a4 = reinterpret_cast<const float4*>(a);
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
#pragma unroll 4
  for (int d4 = 0; d4 < D / 4; ++d4) {
    const float4 x = a4[d4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 y = reinterpret_cast<const float4*>(rows + (sub + 8 * j) * (D + kPad))[d4];
      acc[j] = fmaf(x.x, y.x, acc[j]);
      acc[j] = fmaf(x.y, y.y, acc[j]);
      acc[j] = fmaf(x.z, y.z, acc[j]);
      acc[j] = fmaf(x.w, y.w, acc[j]);
    }
  }
}

}  // namespace
