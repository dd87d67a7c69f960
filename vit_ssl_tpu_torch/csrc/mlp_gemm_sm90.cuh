// Kernel B4's bfloat16 bodies for Hopper (sm_90a): one tiled product on
// wgmma and TMA, C = A . B over K with fp32 sums, and the epilogues that
// make it the fused MLP's forward and backward. Included by fused_mlp_fwd.cu
// (the forward's two products) and fused_mlp_bwd.cu (the backward's three);
// float32 stays on the CUDA-core bodies of fused_mlp_common.cuh and
// weight_grad.cuh. The tiles' ring, mbarriers, TMA loads, wgmma descriptors
// and tensor maps are sm90_common.cuh's. Kernel P2 (masked_matmul.cu) runs
// the same product with one operand scaled by a keep-mask on its way in
// (the MaskedOperand policy of gemm_body) and the MaskRows epilogue.
//
// Replaces the TPU kernels vit_ssl_tpu/ops/fused_mlp.py::_mlp_kernel,
// _mlp_dropout_kernel (the pallas_calls of _fused_mlp_impl) and
// _mlp_bwd_kernel (the pallas_call of _fused_mlp_bwd_impl). The TPU design
// keeps both weights resident in VMEM and never writes the (T, d_ff)
// activation to memory. On Hopper a block's (rows x d_model) fp32 output
// does not fit beside the streamed weights (64 rows at 768 are 192 KB of
// registers), while writing h through device memory costs little (at
// T = 37120, d_ff 1536: 228 MB written and read back, 0.068 ms at 3.35
// TB/s) and the training forward writes the same-sized pre anyway. So each
// product is one large wgmma GEMM and the elementwise work sits in its
// epilogue:
//
//   forward   fc1:  pre = x . W1^T + b1   stored rounded (training entry)
//                   h   = round(gelu(pre) [* mask / keep])   gelu of the
//                         unrounded fp32 pre; h is bf16 scratch
//             fc2:  out = round(h . W2^T + b2)
//   backward  dh:   dh = do . W2 ; with the rounded saved pre:
//                   dpre = round(dh [* mask / keep] * gelu'(pre))
//                   h    = round(gelu(pre) [* mask / keep])  (for dW2)
//             dx:   dx = round(dpre . W1)
//             wgrad dW1 = dpre^T . x, db1 = sum_rows dpre and
//                   dW2 = do^T . h,   db2 = sum_rows do, in one grid: each
//                   block one 128 x 128 tile of one of them over one slice
//                   of the rows, fp32 partial sums; the caller's ordered
//                   reduction (weight_grad.cuh::reduce_splits) adds the
//                   slices in slice order: no atomics, the result repeats
//                   bit for bit
//
// the JAX kernels' rounding points. W1 is (d_ff, d_model) and W2 (d_model,
// d_ff), the nn.Linear layout, so every operand is read as stored: x, h,
// dpre and do as K-major A (the forward's and dh/dx's rows), W1 and W2
// K-major (fc1, fc2) or MN-major (dh: W2 as (k = d, n = f); dx: W1 as
// (k = f, n = d)) B, and the weight products' operands all MN-major (K is
// the token axis). wgmma reads an MN-major bf16 operand from shared memory
// through the instruction's transpose flag and the descriptor's leading
// offset (the next 64-column box) and stride offset (the next 8 K rows).
//
// What bounds it on an H100 SXM (data sheet: 989 TFLOP/s bf16, 3.35 TB/s):
// operations. At DINO's student globals (T = 37120, 384 -> 1536) the
// training forward's two products are 87.6 GFLOP, 0.089 ms, against
// 0.069 ms to move x, the weights, the mask, pre and out once; the
// backward's four products 175 GFLOP, 0.177 ms. At ViT-B/16 384's
// (T = 36928, 768 -> 3072) 0.352 ms and 0.705 ms. The design keeps the
// products on wgmma at the full width of a 128 x 128 tile: both weights
// are streamed through the ring once a tile instead of once a 32-row
// block; the elementwise work runs from and into shared memory, its
// inputs (pre, the keep-mask bytes, a bias slice) loaded and its outputs
// (pre, h, dpre, out, dx) stored by TMA.
//
// The block: 128 output rows x 128 columns, two consumer warpgroups of 64
// rows (kConsumers x kRowsWG) and one producer warp, one thread of which
// issues every TMA copy: 64-wide K tiles (128-byte swizzle, HeadTile<64>'s
// box) of A and B through a ring of three stages (sm90_common.cuh's
// StageRing), 98 KB, so that two blocks share an SM and one's epilogue runs
// beside the other's products. The epilogue's side tiles come by TMA into
// the stages of the ring's jobs after the last K step, issued while the
// last products run; its outputs are staged, swizzled as TMA lays a box,
// in the stages left over, and each consumer stores its 64 rows by TMA. A
// consumer issues a stage's four k16 products as one group, keeps one
// group in flight (wgmma.wait_group 1) and then releases the stage before;
// every product is issued unconditionally (a wgmma under a branch makes
// ptxas serialise every wgmma of the kernel, C7520), so the weight
// kernel's bias sums, A^T . 1, are an m64n8 product against a tile of bf16
// ones in every block, stored only by the blocks of a tile's first column.
// TMA zero-fills rows past T, which add nothing to the weight products
// (both operands are zero there), and writes no row past T.
//
// kernels.py rebuilds a library when this header is newer than it.

#pragma once

#include "fused_mlp_common.cuh"  // gelu_exact, gelu_and_grad, bf16, pack_bf16
#include "sm90_common.cuh"       // ring, mbarriers, TMA, descriptors, tensor maps

namespace {
namespace sm90 {

constexpr int kGemmK = 64;             // K a stage: one swizzled 128-byte row of bf16
constexpr int kGemmRows = kRowsBlock;  // output rows a block: two consumers of 64
constexpr int kGemmCols = 128;         // output columns a block
constexpr int kGemmThreads = 128 * kConsumers + 32;  // + the producer warp
constexpr int kGemmStages = 3;         // two blocks an SM
constexpr int kBoxBytes = 64 * 128;    // a box of 64 rows x 64 bf16

// An operand policy of gemm_body: the ring's stages, and whether each
// stage also brings a keep-mask box by which the consumers scale one
// operand before any product reads it (MaskedOperand, kernel P2's). B4's
// products take AsLoaded: three stages, both operands as TMA lands them.
struct AsLoaded {
  static constexpr int kStages = kGemmStages;
  static constexpr int kMaskBytes = 0;
  static constexpr bool kMasked = false;
  static constexpr bool kRegisterA = false;
};

// A block's shared memory: [stage][A, B, the operand's mask box], 8 rows
// of bf16 ones (the weight kernel's bias product), the ring's barriers;
// + 1024 to round the base up to the swizzle atom: 98 KB with AsLoaded,
// two blocks an SM. The epilogue's side tiles take the stages of the
// ring's jobs after the last K step: a stage holds the (128, 128) bf16 pre
// tile as two 128-byte-swizzled boxes of 64 columns, or the (128, 128)
// keep-mask bytes as one swizzled box at 0 and the 128 bias values at
// kSideBias.
template <typename Op>
struct GemmTileOf {
  static constexpr int kABytes = kGemmRows * kGemmK * 2;
  static constexpr int kBBytes = kGemmCols * kGemmK * 2;
  static constexpr int kMaskAt = kABytes + kBBytes;
  static constexpr int kStageBytes = kMaskAt + Op::kMaskBytes;
  static constexpr int kOnes = Op::kStages * kStageBytes;
  static constexpr int kBarriers = kOnes + 1024;
  static constexpr size_t kSmem = 1024 + kBarriers + 8 * (2 * Op::kStages + 1);
  static constexpr int kSideBias = kGemmRows * kGemmCols;  // past the mask bytes
  static_assert(kStageBytes % 1024 == 0, "stages on the swizzle atom");
  static_assert(kGemmRows * kGemmCols * 2 <= kStageBytes &&
                    kSideBias + kGemmCols * 2 <= kStageBytes,
                "a side tile fits a stage");
};
using GemmTile = GemmTileOf<AsLoaded>;

// Eight bf16 values times their keep-mask bytes (0 = dropped) over keep,
// rounded back.
__device__ __forceinline__ uint4 keep_scale_x8(uint4 v, uint2 m, float inv_keep) {
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t bytes = q < 2 ? m.x >> (16 * q) : m.y >> (16 * (q - 2));
    const float s0 = (bytes & 0xffu) ? inv_keep : 0.f;
    const float s1 = (bytes & 0xff00u) ? inv_keep : 0.f;
    w[q] = pack_bf16(bf16_lo(w[q]) * s0, bf16_hi(w[q]) * s1);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The operand policy that takes one operand x as round(x * mask / keep)
// (kernel P2's h): kOnA, A K-major (128 rows x 64 K a stage); else B
// MN-major (64 K rows x 128 columns). Each stage's full barrier also
// counts the operand's keep-mask box, 8 KB by TMA, unswizzled: 128 rows of
// 64 bytes (A), or 64 rows of 128 bytes (B). kN >= 3 stages of 40 KB: one
// block an SM.
// - A goes through registers (wgmma's register-A form): each warp loads
//   its 16 rows of a k16 step by ldmatrix, scales each pair by its mask
//   bytes and rounds (fragments), and the products read A from there;
//   nothing is written back, and no barrier is needed.
// - B is read by both consumers from shared memory: each rewrites 32 of
//   the 64 K rows in place (apply), fences the writes to the async proxy
//   that wgmma reads through, and waits at a named barrier for the other.
template <bool kOnA, int kN>
struct MaskedOperand {
  static constexpr int kStages = kN;
  static constexpr int kMaskBytes = kGemmRows * kGemmK;
  static constexpr bool kMasked = true;
  static constexpr bool kRegisterA = kOnA;
  float inv_keep;
  const CUtensorMap* tmask;  // set in the kernel

  // K step k's mask box into `dst`, counted on `bar`.
  __device__ void load(uint32_t dst, uint32_t bar, int m0, int n0, int k) const {
    if (kOnA)
      tma_load_3d(dst, tmask, bar, k * kGemmK, m0, 0);
    else
      tma_load_3d(dst, tmask, bar, n0, k * kGemmK, 0);
  }

  // B: consumer c's share of the operand in `stage` (generic address),
  // scaled in place; then the fence and the barrier. The consumer's 128
  // threads take the 16-byte chunks of K rows 32c .. 32c + 31 of both
  // 128-byte-swizzled boxes, a half-warp one row's 128 mask bytes.
  __device__ void apply(uint8_t* stage, int c) const {
    using S = GemmTileOf<MaskedOperand>;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = threadIdx.x % 128 + 128 * i, q = idx % 8, box = (idx / 8) % 2;
      const int r = 32 * c + idx / 16;  // the K row
      uint4& v = *reinterpret_cast<uint4*>(stage + S::kABytes + box * kBoxBytes + r * 128 +
                                           ((q ^ (r & 7)) << 4));
      v = keep_scale_x8(v,
                        *reinterpret_cast<const uint2*>(stage + S::kMaskAt + r * kGemmCols +
                                                        64 * box + 8 * q),
                        inv_keep);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" :: "n"(128 * kConsumers) : "memory");
  }

  // A: warp `warp` of consumer c's A fragments of a stage's four k16
  // steps (ldmatrix from the swizzled tile: the lane's 16 rows as an
  // mma.sync A fragment), each pair scaled by its two mask bytes (the
  // lane's two rows of the mask box, read whole) and rounded.
  __device__ void fragments(uint32_t (&af)[kGemmK / 16][4], const uint8_t* stage, int c,
                            int warp, int lane) const {
    using S = GemmTileOf<MaskedOperand>;
    const int row = 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);  // in consumer c's box
    const uint8_t* x = stage + c * kBoxBytes + row * 128;
#pragma unroll
    for (int kk = 0; kk < kGemmK / 16; ++kk)
      ldmatrix_x4<false>(af[kk], reinterpret_cast<const bf16*>(
                                     x + (((2 * kk + (lane >> 4)) ^ (row & 7)) << 4)));
    const uint4* m = reinterpret_cast<const uint4*>(
        stage + S::kMaskAt + (kRowsWG * c + 16 * warp + lane / 4) * kGemmK);
    uint4 rows[2][kGemmK / 16];  // the lane's rows g and g + 8, 64 bytes each
#pragma unroll
    for (int i = 0; i < kGemmK / 16; ++i) {
      rows[0][i] = m[i];
      rows[1][i] = m[8 * kGemmK / 16 + i];
    }
    const int t = lane % 4;
#pragma unroll
    for (int kk = 0; kk < kGemmK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // rows g, g + 8 at k 2t; again at k 2t + 8
        const uint4 w = rows[i & 1][kk];
        const uint32_t word = i < 2 ? (t < 2 ? w.x : w.y) : (t < 2 ? w.z : w.w);
        const uint32_t bytes = word >> (16 * (t & 1));
        const float s0 = (bytes & 0xffu) ? inv_keep : 0.f;
        const float s1 = (bytes & 0xff00u) ? inv_keep : 0.f;
        af[kk][i] = pack_bf16(bf16_lo(af[kk][i]) * s0, bf16_hi(af[kk][i]) * s1);
      }
  }
};

// d (+)= A . B for a 64 x N fp32 tile, both operands from shared memory;
// kTA / kTB: the operand is MN-major (the instruction's transpose flags).
template <int N, bool kTA, bool kTB>
__device__ __forceinline__ void gemm_ss(float (&d)[N / 2], uint64_t a, uint64_t b) {
  static_assert(N == 128 || N == 8, "the product widths the bodies issue");
  if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1), "n"(int(kTA)), "n"(int(kTB)));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, "
        "%4, %5, p, 1, 1, %7, %8;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(1), "n"(int(kTA)), "n"(int(kTB)));
  }
}

// d += A . B for a 64 x 128 fp32 tile, A (64 x 16 bf16) from registers
// (each warp's 16 rows as an mma.sync A fragment), B from shared memory
// (kTB: MN-major).
template <bool kTB>
__device__ __forceinline__ void gemm_rs(float (&d)[kGemmCols / 2], const uint32_t (&a)[4],
                                        uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(int(kTB)));
}

// Waits until at most N committed product groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// The descriptor of step kk (16 deep) of a 64-deep operand tile at `base`:
// K-major (64 rows of 64 K), or MN-major (64 K rows of 64-column boxes
// side by side).
template <bool kMN>
__device__ __forceinline__ uint64_t operand_desc(uint32_t base, int kk) {
  return kMN ? mnmajor_desc<64>(base, kk) : kmajor_desc<64>(base, kk);
}

// K step k's A tile (rows [m0, m0 + 128)) and B tile (columns [n0, n0 +
// 128)) into a stage, both counted on `bar`. A K-major operand is one box
// of 64 K x 128 rows (map boxes of 128 rows); an MN-major one two boxes of
// 64 columns x 64 K rows (map boxes of 64 rows).
template <bool kAMN, bool kBMN>
__device__ __forceinline__ void load_stage(uint32_t a, uint32_t b, const CUtensorMap* ta,
                                           const CUtensorMap* tb, uint32_t bar, int m0,
                                           int n0, int k) {
  const int k0 = k * kGemmK;
  if (kAMN) {
    tma_load_3d(a, ta, bar, m0, k0, 0);
    tma_load_3d(a + kBoxBytes, ta, bar, m0 + 64, k0, 0);
  } else {
    tma_load_3d(a, ta, bar, k0, m0, 0);
  }
  if (kBMN) {
    tma_load_3d(b, tb, bar, n0, k0, 0);
    tma_load_3d(b + kBoxBytes, tb, bar, n0 + 64, k0, 0);
  } else {
    tma_load_3d(b, tb, bar, k0, n0, 0);
  }
}

// The ring's first three stages after a block's last K step, in job order:
// the epilogue's side tiles come into the first Epi::kSideSlots (the
// ring's next jobs), its outputs are staged in the rest (and may overwrite
// a side tile in place). Generic and shared addresses.
struct Slots {
  uint8_t* ptr[kGemmStages];
  uint32_t addr[kGemmStages];
};

// One block's 128 x 128 tile at (m0, n0) over K steps [k_begin, k_end):
// the producer warp's thread 0 loads the stages, then the epilogue's
// Epi::kSideSlots side tiles as the ring's next jobs (epi.load_side(i,
// stage, bar, m0, n0), Epi::side_bytes(i)), issued while the last K steps
// multiply. The consumers multiply, wait for the side tiles and for each
// other (every stage is then free), and hand their accumulators to
// epi(acc, bias, row_lo, n0, t, slots): warp w of consumer c holds rows
// row_lo = m0 + 64c + 16w + g and row_lo + 8 (g = lane / 4); for column
// block j (8 columns) acc[4j], acc[4j + 1] are row_lo's columns n0 + 8j +
// 2t, + 1 (t = lane % 4), acc[4j + 2], acc[4j + 3] row_lo + 8's (row_lo %
// 128: the row in the slots' tiles). kBias: bias[0] and bias[2] are the
// two rows' sums of A over K. Then one thread of each consumer stores its
// 64 rows of the staged outputs by TMA (epi.store(c, slots, m0, n0); rows
// past the tensor's end are not written) and waits until they are read.
// Op: the ring's stages and the operand masking (AsLoaded, or a
// MaskedOperand: each stage's mask box loaded beside A and B; before the
// stage's products, A's fragments scaled in registers (op.fragments; the
// products then read A from there and are waited for within the stage),
// or B rewritten in place (op.apply)).
template <bool kAMN, bool kBMN, bool kBias, typename Epi, typename Op = AsLoaded>
__device__ __forceinline__ void gemm_body(const CUtensorMap* ta, const CUtensorMap* tb,
                                          int m0, int n0, int k_begin, int k_end,
                                          const Epi& epi, const Op& op = Op()) {
  using S = GemmTileOf<Op>;
  constexpr int kN = Op::kStages;
  static_assert(kN >= kGemmStages, "the epilogue's slots are stages of the ring");
  extern __shared__ uint8_t smem_gemm[];
  uint8_t* aligned = smem_gemm + ((1024 - (smem_u32(smem_gemm) & 1023)) & 1023);
  const uint32_t base = smem_u32(aligned);
  const StageRing<kN> ring(base + S::kBarriers);
  auto a_tile = [&](int s) { return base + s * S::kStageBytes; };
  auto b_tile = [&](int s) { return base + s * S::kStageBytes + S::kABytes; };
  const int steps = k_end - k_begin;
  const int warp_id = threadIdx.x / 32;

  if (threadIdx.x == 0) ring.init(kConsumers);
  if (kBias) {  // 8 rows of 64 bf16 ones, read by the async proxy
    uint32_t* ones = reinterpret_cast<uint32_t*>(aligned + S::kOnes);
    for (int i = threadIdx.x; i < 1024 / 4; i += kGemmThreads) ones[i] = 0x3f803f80u;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp_id == 4 * kConsumers) {  // producer: one thread issues every copy
    if (threadIdx.x % 32 != 0) return;
    for (int s = 0; s < steps; ++s) {
      ring.wait_free(s);
      const uint32_t bar = ring.full(s % kN);
      mbar_expect_tx(bar, S::kStageBytes);
      load_stage<kAMN, kBMN>(a_tile(s % kN), b_tile(s % kN), ta, tb, bar, m0, n0,
                             k_begin + s);
      if constexpr (Op::kMasked)
        op.load(a_tile(s % kN) + S::kMaskAt, bar, m0, n0, k_begin + s);
    }
#pragma unroll
    for (int i = 0; i < Epi::kSideSlots; ++i) {
      ring.wait_free(steps + i);
      const uint32_t bar = ring.full((steps + i) % kN);
      mbar_expect_tx(bar, Epi::side_bytes(i));
      epi.load_side(i, a_tile((steps + i) % kN), bar, m0, n0);
    }
    return;
  }

  const int c = warp_id / 4, warp = warp_id % 4, lane = threadIdx.x % 32;
  float acc[kGemmCols / 2], bias[4];
#pragma unroll
  for (int i = 0; i < kGemmCols / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) bias[i] = 0.f;
  for (int s = 0; s < steps; ++s) {
    ring.wait_full(s);
    if constexpr (Op::kRegisterA) {  // A from registers, the stage read in full
      static_assert(!kAMN && !kBias, "the register form takes a K-major A");
      uint32_t af[kGemmK / 16][4];
      op.fragments(af, aligned + (s % kN) * S::kStageBytes, c, warp, lane);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kGemmK / 16; ++kk)
        gemm_rs<kBMN>(acc, af[kk], operand_desc<kBMN>(b_tile(s % kN), kk));
      wgmma_commit();
      wgmma_wait<0>();
      ring.arrive(s);
      continue;
    }
    if constexpr (Op::kMasked) op.apply(aligned + (s % kN) * S::kStageBytes, c);
    const uint32_t a = a_tile(s % kN) + c * kBoxBytes, b = b_tile(s % kN);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kGemmK / 16; ++kk)
      gemm_ss<kGemmCols, kAMN, kBMN>(acc, operand_desc<kAMN>(a, kk), operand_desc<kBMN>(b, kk));
    if (kBias) {
#pragma unroll
      for (int kk = 0; kk < kGemmK / 16; ++kk)
        gemm_ss<8, kAMN, false>(bias, operand_desc<kAMN>(a, kk),
                                kmajor_desc<64>(base + S::kOnes, kk));
    }
    wgmma_commit();
    wgmma_wait<1>();                  // the stage before is read
    if (s > 0) ring.arrive(s - 1);
  }
  wgmma_wait<0>();
  reg_fence(acc);
  reg_fence(bias);
  Slots slots;
#pragma unroll
  for (int i = 0; i < kGemmStages; ++i) {
    slots.ptr[i] = aligned + ((steps + i) % kN) * S::kStageBytes;
    slots.addr[i] = a_tile((steps + i) % kN);
  }
#pragma unroll
  for (int i = 0; i < Epi::kSideSlots; ++i) ring.wait_full(steps + i);
  if constexpr (Epi::kStaged) {
    // both consumers' products are done: no stage is read any more
    asm volatile("bar.sync 1, %0;\n" :: "n"(128 * kConsumers) : "memory");
  }
  epi(acc, bias, m0 + kRowsWG * c + 16 * warp + (lane >> 2), n0, lane & 3, slots);
  if constexpr (Epi::kStaged) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" :: "r"(2 + c) : "memory");
    if (warp == 0 && lane == 0) {
      epi.store(c, slots, m0, n0);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

using Acc = float[kGemmCols / 2];

// The offset of a tile's row r (0 .. 127), columns c and c + 1 (c even) in
// a slot laid out as TMA lays boxes of 64 columns x 128 rows (box c / 64)
// with the 128-byte swizzle: the side tile of pre, and the staged outputs.
__device__ __forceinline__ int tile_at(int r, int c) {
  return (c / 64) * kGemmRows * 128 + HeadTile<64>::chunk_at(r, (c % 64) / 8) + 2 * (c % 8);
}

__device__ __forceinline__ uint32_t& tile_pair(uint8_t* slot, int r, int c) {
  return *reinterpret_cast<uint32_t*>(slot + tile_at(r, c));
}

// The scale mask / keep of a tile's row r, columns c and c + 1: their
// keep-mask bytes in a side slot (one 128-byte-swizzled box).
__device__ __forceinline__ float2 side_keep(const uint8_t* slot, int r, int c,
                                            float inv_keep) {
  const uint32_t m =
      *reinterpret_cast<const uint16_t*>(slot + ((r * 128 + c) ^ ((r & 7) << 4)));
  return make_float2(m & 0xffu ? inv_keep : 0.f, m & 0xff00u ? inv_keep : 0.f);
}

// A side slot's bias values of columns n0 + c and n0 + c + 1 (c even).
__device__ __forceinline__ uint32_t side_bias(const uint8_t* slot, int c) {
  return ld32(reinterpret_cast<const bf16*>(slot + GemmTile::kSideBias) + c);
}

// The keep-mask's tile, rows [m0, m0 + 128) x columns [n0, n0 + 128), and
// a bias's slice [n0, n0 + 128) into a side slot.
__device__ __forceinline__ void load_mask(uint32_t slot, const CUtensorMap* tmask,
                                          uint32_t bar, int m0, int n0) {
  tma_load_3d(slot, tmask, bar, n0, m0, 0);
}
__device__ __forceinline__ void load_bias(uint32_t slot, const bf16* bias, uint32_t bar,
                                          int n0) {
  bulk_load(slot + GemmTile::kSideBias, bias + n0, kGemmCols * 2, bar);
}

// Consumer c's 64 rows of a tile staged in `slot` to rows [m0 + 64c, +64)
// x columns [n0, n0 + 128) of a map with boxes of 64 x 64 (encode_matrix's
// box_rows 64); TMA writes no row past the map's end.
__device__ __forceinline__ void store_rows(const CUtensorMap* map, uint32_t slot, int c,
                                           int m0, int n0) {
#pragma unroll
  for (int box = 0; box < kGemmCols / 64; ++box)
    asm volatile(
        "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
        :: "l"(reinterpret_cast<uint64_t>(map)),
           "r"(slot + box * kGemmRows * 128 + c * kRowsWG * 128), "r"(n0 + 64 * box),
           "r"(m0 + kRowsWG * c), "r"(0)
        : "memory");
}

constexpr uint32_t kMaskTileBytes = kGemmRows * kGemmCols;
constexpr uint32_t kBiasBytes = kGemmCols * 2;
constexpr uint32_t kTileBytes = kGemmRows * kGemmCols * 2;

// fc1's epilogue: pre = acc + b1 (stored rounded with kPre), h =
// round(gelu(pre) [* mask / keep]). One side slot: the mask, b1's slice;
// h staged in the next slot, pre in the last.
template <bool kMask, bool kPre>
struct Fc1 {
  static constexpr int kSideSlots = 1;
  static constexpr bool kStaged = true;
  __device__ static constexpr uint32_t side_bytes(int) {
    return kBiasBytes + (kMask ? kMaskTileBytes : 0);
  }
  const bf16* b1;
  float inv_keep;
  const CUtensorMap* tmask;  // these set in the kernel
  const CUtensorMap* th;
  const CUtensorMap* tpre;
  __device__ void load_side(int, uint32_t slot, uint32_t bar, int m0, int n0) const {
    load_bias(slot, b1, bar, n0);
    if (kMask) load_mask(slot, tmask, bar, m0, n0);
  }
  __device__ void operator()(const Acc& acc, const float (&)[4], int row_lo, int, int t,
                             const Slots& slots) const {
#pragma unroll
    for (int j = 0; j < kGemmCols / 8; ++j) {
      const int c = 8 * j + 2 * t;
      const uint32_t bias = side_bias(slots.ptr[0], c);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row_lo % kGemmRows + 8 * half;
        const float v0 = acc[4 * j + 2 * half] + bf16_lo(bias);
        const float v1 = acc[4 * j + 2 * half + 1] + bf16_hi(bias);
        if (kPre) tile_pair(slots.ptr[2], r, c) = pack_bf16(v0, v1);
        float h0 = gelu_exact(v0), h1 = gelu_exact(v1);  // of the unrounded pre
        if (kMask) {
          const float2 s = side_keep(slots.ptr[0], r, c, inv_keep);
          h0 = h0 * s.x;
          h1 = h1 * s.y;
        }
        tile_pair(slots.ptr[1], r, c) = pack_bf16(h0, h1);
      }
    }
  }
  __device__ void store(int c, const Slots& slots, int m0, int n0) const {
    store_rows(th, slots.addr[1], c, m0, n0);
    if (kPre) store_rows(tpre, slots.addr[2], c, m0, n0);
  }
};

// fc2's (kBias: one side slot, b2's slice) and dx's epilogue:
// out = round(acc [+ bias]), staged in the slot after the side slots.
template <bool kBias>
struct StoreRows {
  static constexpr int kSideSlots = kBias ? 1 : 0;
  static constexpr bool kStaged = true;
  __device__ static constexpr uint32_t side_bytes(int) { return kBiasBytes; }
  const bf16* bias;
  const CUtensorMap* tout;  // set in the kernel
  __device__ void load_side(int, uint32_t slot, uint32_t bar, int, int n0) const {
    load_bias(slot, bias, bar, n0);
  }
  __device__ void operator()(const Acc& acc, const float (&)[4], int row_lo, int, int t,
                             const Slots& slots) const {
#pragma unroll
    for (int j = 0; j < kGemmCols / 8; ++j) {
      const int c = 8 * j + 2 * t;
      const uint32_t b = kBias ? side_bias(slots.ptr[0], c) : 0u;
#pragma unroll
      for (int half = 0; half < 2; ++half)
        tile_pair(slots.ptr[kSideSlots], row_lo % kGemmRows + 8 * half, c) =
            pack_bf16(acc[4 * j + 2 * half] + bf16_lo(b),
                      acc[4 * j + 2 * half + 1] + bf16_hi(b));
    }
  }
  __device__ void store(int c, const Slots& slots, int m0, int n0) const {
    store_rows(tout, slots.addr[kSideSlots], c, m0, n0);
  }
};

// dh's epilogue, from the rounded saved pre: dpre = round(dh [* mask /
// keep] * gelu'(pre)) and h = round(gelu(pre) [* mask / keep]). Side
// slots: pre's tile (dpre staged over it in place: each value's own
// thread reads it first), the mask; h staged in the last slot.
template <bool kMask>
struct Dh {
  static constexpr int kSideSlots = kMask ? 2 : 1;
  static constexpr bool kStaged = true;
  __device__ static constexpr uint32_t side_bytes(int i) {
    return i == 0 ? kTileBytes : kMaskTileBytes;
  }
  float inv_keep;
  const CUtensorMap* tpre;  // these set in the kernel
  const CUtensorMap* tmask;
  const CUtensorMap* tdpre;
  const CUtensorMap* th;
  __device__ void load_side(int i, uint32_t slot, uint32_t bar, int m0, int n0) const {
    if (i == 0) {
      tma_load_3d(slot, tpre, bar, n0, m0, 0);
      tma_load_3d(slot + kGemmRows * 128, tpre, bar, n0 + 64, m0, 0);
    } else {
      load_mask(slot, tmask, bar, m0, n0);
    }
  }
  __device__ void operator()(const Acc& acc, const float (&)[4], int row_lo, int, int t,
                             const Slots& slots) const {
#pragma unroll
    for (int j = 0; j < kGemmCols / 8; ++j) {
      const int c = 8 * j + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row_lo % kGemmRows + 8 * half;
        uint32_t& pr = tile_pair(slots.ptr[0], r, c);
        const float p0 = bf16_lo(pr), p1 = bf16_hi(pr);
        const GeluAndGrad g0 = gelu_and_grad(p0), g1 = gelu_and_grad(p1);
        float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
        float h0 = g0.gelu, h1 = g1.gelu;
        if (kMask) {
          const float2 s = side_keep(slots.ptr[1], r, c, inv_keep);
          h0 = h0 * s.x;
          h1 = h1 * s.y;
          v0 = v0 * s.x;
          v1 = v1 * s.y;
        }
        pr = pack_bf16(v0 * g0.grad, v1 * g1.grad);
        tile_pair(slots.ptr[2], r, c) = pack_bf16(h0, h1);
      }
    }
  }
  __device__ void store(int c, const Slots& slots, int m0, int n0) const {
    store_rows(tdpre, slots.addr[0], c, m0, n0);
    store_rows(th, slots.addr[2], c, m0, n0);
  }
};

// Kernel P2's dh epilogue: dh = round(acc * mask / keep). One side slot:
// the mask; dh staged in the next slot.
struct MaskRows {
  static constexpr int kSideSlots = 1;
  static constexpr bool kStaged = true;
  __device__ static constexpr uint32_t side_bytes(int) { return kMaskTileBytes; }
  float inv_keep;
  const CUtensorMap* tmask;  // these set in the kernel
  const CUtensorMap* tout;
  __device__ void load_side(int, uint32_t slot, uint32_t bar, int m0, int n0) const {
    load_mask(slot, tmask, bar, m0, n0);
  }
  __device__ void operator()(const Acc& acc, const float (&)[4], int row_lo, int, int t,
                             const Slots& slots) const {
#pragma unroll
    for (int j = 0; j < kGemmCols / 8; ++j) {
      const int c = 8 * j + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row_lo % kGemmRows + 8 * half;
        const float2 s = side_keep(slots.ptr[0], r, c, inv_keep);
        tile_pair(slots.ptr[1], r, c) =
            pack_bf16(acc[4 * j + 2 * half] * s.x, acc[4 * j + 2 * half + 1] * s.y);
      }
    }
  }
  __device__ void store(int c, const Slots& slots, int m0, int n0) const {
    store_rows(tout, slots.addr[1], c, m0, n0);
  }
};

// The weight kernel's epilogue: the tile's fp32 partial sums over this
// block's slice (slice blockIdx.y at split_stride floats from slice 0), and
// on a tile's first column the rows' sums of A (the bias gradient).
struct Partials {
  static constexpr int kSideSlots = 0;
  static constexpr bool kStaged = false;
  __device__ static constexpr uint32_t side_bytes(int) { return 0; }
  float* part;       // (m, width) of slice 0
  float* part_bias;  // (m) of slice 0
  int width;
  size_t split_stride;
  __device__ void load_side(int, uint32_t, uint32_t, int, int) const {}
  __device__ void store(int, const Slots&, int, int) const {}
  __device__ void operator()(const Acc& acc, const float (&bias)[4], int row_lo, int n0,
                             int t, const Slots&) const {
    float* c = part + blockIdx.y * split_stride;
#pragma unroll
    for (int j = 0; j < kGemmCols / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(c + (size_t)row_lo * width + col) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(c + (size_t)(row_lo + 8) * width + col) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    if (n0 == 0 && t == 0) {
      float* b = part_bias + blockIdx.y * split_stride;
      b[row_lo] = bias[0];
      b[row_lo + 8] = bias[2];
    }
  }
};

// ---------------------------------------------------------------------------
// kernels: grid (column tiles, row tiles), kGemmThreads threads,
// GemmTile::kSmem bytes of dynamic shared memory, two blocks an SM (at most
// 112 registers a thread); the weight kernel's grid (both products' tiles,
// slices). Each is a template, so that a library builds only those it
// launches.

template <bool kMask, bool kPre>
__global__ void __launch_bounds__(kGemmThreads, 2)
    mlp_fc1_sm90_kernel(const __grid_constant__ CUtensorMap tx,
                        const __grid_constant__ CUtensorMap tw1,
                        const __grid_constant__ CUtensorMap tmask,
                        const __grid_constant__ CUtensorMap th,
                        const __grid_constant__ CUtensorMap tpre, Fc1<kMask, kPre> epi,
                        int k_steps) {
  epi.tmask = &tmask;
  epi.th = &th;
  epi.tpre = &tpre;
  gemm_body<false, false, false>(&tx, &tw1, blockIdx.y * kGemmRows, blockIdx.x * kGemmCols, 0,
                                 k_steps, epi);
}

template <typename Epi>  // StoreRows<true>
__global__ void __launch_bounds__(kGemmThreads, 2)
    mlp_fc2_sm90_kernel(const __grid_constant__ CUtensorMap th,
                        const __grid_constant__ CUtensorMap tw2,
                        const __grid_constant__ CUtensorMap tout, Epi epi, int k_steps) {
  epi.tout = &tout;
  gemm_body<false, false, false>(&th, &tw2, blockIdx.y * kGemmRows, blockIdx.x * kGemmCols, 0,
                                 k_steps, epi);
}

template <bool kMask>
__global__ void __launch_bounds__(kGemmThreads, 2)
    mlp_dh_sm90_kernel(const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tw2,
                       const __grid_constant__ CUtensorMap tpre,
                       const __grid_constant__ CUtensorMap tmask,
                       const __grid_constant__ CUtensorMap tdpre,
                       const __grid_constant__ CUtensorMap th, Dh<kMask> epi, int k_steps) {
  epi.tpre = &tpre;
  epi.tmask = &tmask;
  epi.tdpre = &tdpre;
  epi.th = &th;
  gemm_body<false, true, false>(&tdo, &tw2, blockIdx.y * kGemmRows, blockIdx.x * kGemmCols, 0,
                                k_steps, epi);
}

template <typename Epi>  // StoreRows<false>
__global__ void __launch_bounds__(kGemmThreads, 2)
    mlp_dx_sm90_kernel(const __grid_constant__ CUtensorMap tdpre,
                       const __grid_constant__ CUtensorMap tw1,
                       const __grid_constant__ CUtensorMap tdx, Epi epi, int k_steps) {
  epi.tout = &tdx;
  gemm_body<false, true, false>(&tdpre, &tw1, blockIdx.y * kGemmRows, blockIdx.x * kGemmCols,
                                0, k_steps, epi);
}

// Blocks [0, tiles0) take dW1's tiles (A = dpre, B = x), the rest dW2's
// (A = do, B = h); blockIdx.y is the slice of the k_steps row steps.
template <typename Epi>  // Partials
__global__ void __launch_bounds__(kGemmThreads, 2)
    mlp_wgrad_sm90_kernel(const __grid_constant__ CUtensorMap tdpre,
                          const __grid_constant__ CUtensorMap tx,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap th, Epi dw1, Epi dw2, int tiles0,
                          int k_steps) {
  const bool second = blockIdx.x >= tiles0;
  const Epi epi = second ? dw2 : dw1;
  const int tile = second ? blockIdx.x - tiles0 : blockIdx.x;
  const int n_tiles = epi.width / kGemmCols;
  const int per = (k_steps + gridDim.y - 1) / gridDim.y;
  const int begin = min(k_steps, (int)blockIdx.y * per);
  gemm_body<true, true, true>(second ? &tdo : &tdpre, second ? &th : &tx,
                              tile / n_tiles * kGemmRows, tile % n_tiles * kGemmCols, begin,
                              min(k_steps, begin + per), epi);
}

// ---------------------------------------------------------------------------
// host

// A row-major (rows, width) bf16 matrix's tensor map: boxes of 64 columns x
// box_rows rows, 128-byte swizzle, zero fill past the last row.
inline bool encode_matrix(CUtensorMap* map, const void* ptr, int width, int rows,
                          int box_rows) {
  return encode_rows<64>(map, ptr, width, rows, 1, box_rows);
}

// The keep-mask's (rows, width) bytes as a map like encode_matrix's, boxes
// of 128 columns x 128 rows. A null mask leaves the map zero (unused).
inline bool encode_mask(CUtensorMap* map, const uint8_t* mask, int width, int rows) {
  *map = CUtensorMap{};
  if (mask == nullptr) return true;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)rows, 1};
  const cuuint64_t strides[2] = {(cuuint64_t)width, (cuuint64_t)width * rows};
  const cuuint32_t box[3] = {kGemmCols, kGemmRows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<uint8_t*>(mask), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A mask's (rows, width) bytes as a map with unswizzled boxes of box_cols
// x box_rows (a MaskedOperand's mask boxes), zero fill past the last row.
inline bool encode_mask_box(CUtensorMap* map, const uint8_t* mask, int width, int rows,
                            int box_cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)rows, 1};
  const cuuint64_t strides[2] = {(cuuint64_t)width, (cuuint64_t)width * rows};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<uint8_t*>(mask), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Op: the kernel's operand policy, which sets its shared memory.
template <typename Op = AsLoaded, typename Kernel, typename... Args>
cudaError_t launch_gemm(Kernel kernel, dim3 grid, cudaStream_t stream, Args... args) {
  constexpr size_t smem = GemmTileOf<Op>::kSmem;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kGemmThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

inline int row_tiles(int rows) { return (rows + kGemmRows - 1) / kGemmRows; }

// The forward: fc1 (pre with kPre, h), then fc2 (out). h: (rows, d_ff)
// scratch. d_model and d_ff multiples of 128. Maps: boxes of 128 rows for
// the K-major A operands (x, h) and the K-major weights, of 64 rows for
// the stores.
template <bool kMask, bool kPre>
cudaError_t mlp_forward(const bf16* x, const bf16* w1, const bf16* b1, const bf16* w2,
                        const bf16* b2, const uint8_t* mask, bf16* out, bf16* pre, bf16* h,
                        int rows, int d, int d_ff, float keep_prob, cudaStream_t stream) {
  CUtensorMap tx, tw1, tmask, th_out, tpre, th, tw2, tout;
  tpre = CUtensorMap{};
  if (!encode_matrix(&tx, x, d, rows, kGemmRows) ||
      !encode_matrix(&tw1, w1, d, d_ff, kGemmCols) || !encode_mask(&tmask, mask, d_ff, rows) ||
      !encode_matrix(&th_out, h, d_ff, rows, 64) ||
      (kPre && !encode_matrix(&tpre, pre, d_ff, rows, 64)) ||
      !encode_matrix(&th, h, d_ff, rows, kGemmRows) ||
      !encode_matrix(&tw2, w2, d_ff, d, kGemmCols) || !encode_matrix(&tout, out, d, rows, 64))
    return cudaErrorInvalidValue;
  const float inv_keep = kMask ? 1.f / keep_prob : 1.f;
  cudaError_t err = launch_gemm(mlp_fc1_sm90_kernel<kMask, kPre>,
                                dim3(d_ff / kGemmCols, row_tiles(rows)), stream, tx, tw1, tmask,
                                th_out, tpre,
                                Fc1<kMask, kPre>{b1, inv_keep, nullptr, nullptr, nullptr},
                                d / kGemmK);
  if (err != cudaSuccess) return err;
  return launch_gemm(mlp_fc2_sm90_kernel<StoreRows<true>>,
                     dim3(d / kGemmCols, row_tiles(rows)), stream, th, tw2, tout,
                     StoreRows<true>{b2, nullptr}, d_ff / kGemmK);
}

// The backward's three launches: dh (dpre, h), dx, then both weight
// products into `splits` slices of fp32 partials (part: one slice's
// [dW1 (d_ff, d) | dW2 (d, d_ff) | db1 | db2], split_stride floats apart),
// which the caller reduces.
template <bool kMask>
cudaError_t mlp_backward(const bf16* x, const bf16* pre, const bf16* dout, const bf16* w1,
                         const bf16* w2, const uint8_t* mask, bf16* dx, bf16* dpre, bf16* h,
                         float* part, size_t split_stride, int splits, int rows, int d,
                         int d_ff, float keep_prob, cudaStream_t stream) {
  // boxes of 64 rows: the MN-major operands and the stores
  CUtensorMap tdo, tw2, tpre, tmask, tdpre64, th64, tdpre, tw1, tdx, tx64, tdo64;
  if (!encode_matrix(&tdo, dout, d, rows, kGemmRows) ||
      !encode_matrix(&tw2, w2, d_ff, d, 64) ||  // W2 as (k = d, n = f)
      !encode_matrix(&tpre, pre, d_ff, rows, kGemmRows) ||
      !encode_mask(&tmask, mask, d_ff, rows) || !encode_matrix(&tdpre64, dpre, d_ff, rows, 64) ||
      !encode_matrix(&th64, h, d_ff, rows, 64) ||
      !encode_matrix(&tdpre, dpre, d_ff, rows, kGemmRows) ||
      !encode_matrix(&tw1, w1, d, d_ff, 64) ||  // W1 as (k = f, n = d)
      !encode_matrix(&tdx, dx, d, rows, 64) || !encode_matrix(&tx64, x, d, rows, 64) ||
      !encode_matrix(&tdo64, dout, d, rows, 64))
    return cudaErrorInvalidValue;
  const float inv_keep = kMask ? 1.f / keep_prob : 1.f;
  cudaError_t err = launch_gemm(mlp_dh_sm90_kernel<kMask>,
                                dim3(d_ff / kGemmCols, row_tiles(rows)), stream, tdo, tw2,
                                tpre, tmask, tdpre64, th64,
                                Dh<kMask>{inv_keep, nullptr, nullptr, nullptr, nullptr},
                                d / kGemmK);
  if (err != cudaSuccess) return err;
  err = launch_gemm(mlp_dx_sm90_kernel<StoreRows<false>>,
                    dim3(d / kGemmCols, row_tiles(rows)), stream, tdpre, tw1, tdx,
                    StoreRows<false>{nullptr, nullptr}, d_ff / kGemmK);
  if (err != cudaSuccess) return err;
  const size_t n_w = (size_t)d * d_ff;
  const int tiles = (d_ff / kGemmCols) * (d / kGemmCols);  // each product's
  return launch_gemm(mlp_wgrad_sm90_kernel<Partials>, dim3(2 * tiles, splits), stream,
                     tdpre64, tx64, tdo64, th64, Partials{part, part + 2 * n_w, d, split_stride},
                     Partials{part + n_w, part + 2 * n_w + d_ff, d_ff, split_stride}, tiles,
                     (rows + kGemmK - 1) / kGemmK);
}

}  // namespace sm90
}  // namespace
