// Kernel B3's bfloat16 forward, inference and training, redesigned for
// Hopper (sm_90a) with wgmma, TMA and warp specialisation. Instantiated by
// fused_attention.cu only (B1's libraries do not include this header);
// float32 stays on the CUDA-core body of attention_fwd.cuh.
//
// Replaces the TPU kernel vit_ssl_tpu/ops/flash_attention.py::_attn_kernel
// in both pallas_calls of _fused_attention_fwd_impl (the inference call,
// C entry fused_attention_fwd; the training call, which saves the
// probabilities, C entry fused_attention_fwd_stats, which saves each row's
// (m, 1/l) instead). Per (b, h), on the head-major (B, H, N, D) layout:
//
//   s  = (q . k^T) * scale                fp32 (wgmma accumulators)
//   s  = -inf for keys at or past n
//   p  = exp(s - rowmax(s)) ; l = rowsum(p)   fp32
//   pn = (p / l) rounded to bf16          normalise, THEN round
//   o  = pn . v                           fp32 accumulation, bf16 on store
//
// pn is rounded after normalising, as the plain version
// (ops/flash_attention.py::fused_attention_reference) and the JAX kernel
// round it, and as B3's backward (attention_bwd.cuh) rebuilds it from
// (m, 1/l): p = 2^(s log2e - m log2e) * (1/l), the same instructions as
// here. So the row max and sum must be known before any p is formed: the
// kernel keeps two passes over the keys (pass 1: max and rescaled sum;
// pass 2: the scores again, pn, and P.V), not online rounding as B2 does.
//
// What bounds it on an H100 SXM, at ViT-B/16's (64, 12, 577, 64) bf16
// (data sheet: 3.35 TB/s, 989 TFLOP/s bf16): q, k, v read and o written,
// 227 MB, 0.068 ms (training: + 3.5 MB of statistics); two products, 65.5
// GFLOP, 0.066 ms, three with pass 1's recompute, 0.099 ms; exponentials,
// B*H*N^2 = 256 M a pass, about 0.07 ms a pass on the special-function
// units (16 ex2 a clock per SM). Bytes bound the function; the two-pass
// form puts the exponentials and the third product beside them, and the
// 64-row granularity of wgmma pads N = 577 to 640 rows and keys.
//
// Design:
// - one block per (b, h, 128 query rows), two blocks an SM (D <= 64):
//   warps 0-3 and 4-7 are two consumer warpgroups of 64 query rows each,
//   warp 8 the producer, one thread of which issues every copy with TMA.
//   The consumers share the block's K and V tiles and run independently;
//   the four consumers of an SM overlap one another's products and
//   exponentials.
// - TMA copies through 3-D tensor maps over (D, N, B*H) of q, k and v
//   (encoded on the host per call, passed as __grid_constant__
//   parameters): a tile that runs past row n of one head is zero-filled by
//   the hardware, never read from the next head. Keys >= n are then set to
//   -inf in the last tile (a zero-filled key gives s = 0, not -inf).
//   Swizzle 128 B (64 bf16 a row; D = 128 takes two boxes side by side),
//   64 B at D = 32, matched by the wgmma descriptors.
// - Q is loaded once per block. K and V stream through a ring of kStages
//   64-key stages tracked by mbarriers (full: the TMA bytes landed; empty:
//   every consumer warp finished reading). The producer walks 2T jobs, T
//   key tiles: K tiles for pass 1, then K and V tiles for pass 2.
// - S = Q.K^T is wgmma.m64n64k16 with both operands in shared memory and
//   the accumulator in registers. P.V is wgmma.m64nDk16 with A from
//   registers: the S accumulator's layout, packed to bf16, is the A
//   fragment, so p never touches shared memory; V is the transposed
//   (MN-major) B operand, straight from its TMA tile. Every product is
//   issued unconditionally (the last tile's keys past n have p = 0 and
//   zero-filled V rows): a product under a branch makes ptxas serialise
//   every wgmma of the kernel (its message C7520), which was slower.
// - the softmax scale is folded into the exponent's fma (the row max is
//   taken of the unscaled scores, so scale must be positive).
// - the output is stored from registers, rows < n only; the statistics as
//   the old body stores them (rows < n; the caller zero-fills the rest).
//
// Tried on the card and slower, so not kept: software pipelining within
// a consumer (the next tile's score product in flight during this tile's
// exponentials), which made ptxas serialise the wgmmas (C7514, C7515:
// accumulator registers read while a group is in flight) and spill at two
// blocks an SM; the two consumers taking turns through named barriers;
// 32-key tiles at three blocks an SM (spills); one block an SM.
// The single-pass form that keeps a block's fp32 scores in shared memory
// (one exponential a score) is ROADMAP.md's next step for this kernel.
//
// kernels.py rebuilds a library when this header is newer than it.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, no -lcuda
#include <cuda_runtime.h>

#include "attention_nhd_common.cuh"

namespace {
namespace sm90 {

constexpr int kConsumers = 2;                     // consumer warpgroups
constexpr int kRowsWG = 64;                       // query rows a consumer
constexpr int kRowsBlock = kConsumers * kRowsWG;  // query rows a block
constexpr int kProducerWarp = 4 * kConsumers;     // after the consumers
constexpr int kBlockThreads = 32 * (kProducerWarp + 1);
constexpr int kStages = 4;
constexpr int kKeys = 64;  // keys a tile

template <int D>
struct Shape {
  static_assert(D == 32 || D == 64 || D == 128, "head_dim 32, 64 or 128");
  static constexpr int kSwz = D >= 64 ? 64 : 32;         // bf16 a swizzled row
  static constexpr int kRowBytes = 2 * kSwz;             // 128 or 64
  static constexpr int kSubs = D / kSwz;                 // boxes side by side
  static constexpr uint64_t kLayout = D >= 64 ? 1 : 2;   // descriptor: B128, B64
  static constexpr int kQBytes = kRowsWG * D * 2;        // one consumer's Q
  static constexpr int kTileBytes = kKeys * D * 2;       // one K or V tile
  static constexpr int kQSub = kRowsWG * kRowBytes;      // Q box bytes
  static constexpr int kTileSub = kKeys * kRowBytes;     // K/V box bytes
  static constexpr int kBarrierOffset =
      kConsumers * kQBytes + kStages * 2 * kTileBytes;
  // + 1024 so the base can be rounded up to the 1024-byte swizzle atom
  static constexpr size_t kSmem = 1024 + kBarrierOffset + 8 * (2 * kStages + 1);
  // blocks an SM holds: two at D <= 64 (at most 113 registers a thread and
  // 81 KB of shared memory each), one at D = 128 (its O accumulator needs
  // more registers)
  static constexpr int kMinBlocks = D <= 64 ? 2 : 1;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// Spins until the barrier's phase differs from `parity`. A wait that never
// ends (a fault in the pipeline) traps, so the launch fails instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

// One box of a 3-D tensor map into shared memory; completion counted in
// bytes on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
         "r"(c2)
      : "memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout (1: 128 B, 2: 64 B).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                         uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from touching accumulator registers across the
// asynchronous products.
template <int R>
__device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A . B for a 64 x N fp32 tile, both operands from shared memory
// (K-major), accumulate = 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                                         int accumulate);
// d += A . B for a 64 x N fp32 tile, A (64 x 16 bf16) from registers (each
// warp's 16 rows as an mma.sync A fragment), B MN-major (transposed) from
// shared memory.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// grid (ceil(n / kRowsBlock), heads, batch), kBlockThreads threads (warps
// 0-3 and 4-7 the two consumer warpgroups, warp 8 the producer),
// Shape<D>::kSmem bytes of dynamic shared memory. stats may be null.
//
// Accumulator layout (wgmma m64nN, as mma.sync's m16n8 per warp): warp w
// of a consumer holds rows 16w + g and 16w + g + 8 (g = lane / 4); for
// column block j (8 columns), d[4j], d[4j + 1] are row 16w + g, columns
// 8j + 2t, 8j + 2t + 1 (t = lane % 4), and d[4j + 2], d[4j + 3] the same
// columns of row 16w + g + 8. Columns 16kk .. 16kk + 15 of S, packed to
// bf16, are P.V's A fragment for keys 16kk .. 16kk + 15.
template <int D>
__global__ void __launch_bounds__(kBlockThreads, Shape<D>::kMinBlocks)
    attention_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              bf16* __restrict__ o, float2* __restrict__ stats, int n,
                              int heads, float scale) {
  using S = Shape<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_smem = base;  // [consumer][sub][64 rows][kSwz]
  const uint32_t kv_smem = base + kConsumers * S::kQBytes;  // [stage][K, V][sub][rows][kSwz]
  const uint32_t bars = base + S::kBarrierOffset;
  auto full_bar = [&](int s) { return bars + 8 * s; };
  auto empty_bar = [&](int s) { return bars + 8 * (kStages + s); };
  const uint32_t q_bar = bars + 16 * kStages;
  auto k_tile = [&](int s) { return kv_smem + s * 2 * S::kTileBytes; };
  auto v_tile = [&](int s) { return kv_smem + s * 2 * S::kTileBytes + S::kTileBytes; };

  const int h = blockIdx.y, b = blockIdx.z;
  const int bh = b * heads + h;
  const int q0 = blockIdx.x * kRowsBlock;
  const int consumers = min(kConsumers, (n - q0 + kRowsWG - 1) / kRowsWG);  // with rows < n
  const int tiles = (n + kKeys - 1) / kKeys;
  const int warp_id = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), 4 * consumers);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp_id == kProducerWarp) {  // producer: one thread issues every copy
    if (threadIdx.x != 32 * kProducerWarp) return;
    mbar_expect_tx(q_bar, consumers * S::kQBytes);
    for (int c = 0; c < consumers; ++c)
#pragma unroll
      for (int sub = 0; sub < S::kSubs; ++sub)
        tma_load_3d(q_smem + c * S::kQBytes + sub * S::kQSub, &tq, q_bar, sub * S::kSwz,
                    q0 + c * kRowsWG, bh);
    for (int job = 0; job < 2 * tiles; ++job) {
      const int s = job % kStages;
      mbar_wait(empty_bar(s), ((job / kStages) & 1) ^ 1);
      const bool with_v = job >= tiles;  // pass 2
      const int k0 = (job % tiles) * kKeys;
      mbar_expect_tx(full_bar(s), (with_v ? 2 : 1) * S::kTileBytes);
#pragma unroll
      for (int sub = 0; sub < S::kSubs; ++sub) {
        tma_load_3d(k_tile(s) + sub * S::kTileSub, &tk, full_bar(s), sub * S::kSwz, k0, bh);
        if (with_v)
          tma_load_3d(v_tile(s) + sub * S::kTileSub, &tv, full_bar(s), sub * S::kSwz, k0,
                      bh);
      }
    }
    return;
  }

  const int c = warp_id / 4;  // this consumer
  if (c >= consumers) return;  // all its rows lie past n
  const int warp = warp_id % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row_lo = q0 + c * kRowsWG + 16 * warp + g;  // and row_lo + 8

  // descriptors: Q (A, K-major), K (B, K-major), V (B, MN-major)
  constexpr uint32_t kSbo = 8 * S::kRowBytes;  // 8 rows of one box
  const uint32_t q_addr = q_smem + c * S::kQBytes;
  auto q_desc = [&](int kk) {  // head-dim step kk: 16 columns
    const int col = 16 * kk;
    return desc(q_addr + (col / S::kSwz) * S::kQSub + (col % S::kSwz) * 2, 16, kSbo,
                S::kLayout);
  };
  auto k_desc = [&](int s, int kk) {
    const int col = 16 * kk;
    return desc(k_tile(s) + (col / S::kSwz) * S::kTileSub + (col % S::kSwz) * 2, 16, kSbo,
                S::kLayout);
  };
  auto v_desc = [&](int s, int kk) {  // key step kk: 16 rows; LBO: the next box
    return desc(v_tile(s) + 16 * kk * S::kRowBytes, S::kTileSub, kSbo, S::kLayout);
  };

  mbar_wait(q_bar, 0);

  float sacc[kKeys / 2];
  auto wait_full = [&](int job) { mbar_wait(full_bar(job % kStages), (job / kStages) & 1); };
  auto release = [&](int job) {  // this warp is done reading job's stage
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar(job % kStages));
  };
  auto scores = [&](int job) {  // sacc = Q . K^T of job's stage
    wait_full(job);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kKeys>(sacc, q_desc(kk), k_desc(job % kStages, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(sacc);
  };
  // -inf for keys at or past n (only the last tile has any). The scores
  // stay unscaled: scale > 0, so the row max of s * scale is the scaled
  // row max, and exp(s * scale - m) = 2^(s * scale log2e - m log2e) takes
  // the scale in one fma.
  const float sl2e = scale * kLog2e;
  auto mask = [&](int k0) {
    if (k0 + kKeys <= n) return;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + 8 * j + 2 * t + (e & 1) >= n) sacc[4 * j + e] = -INFINITY;
  };

  // Pass 1: row max and row sum. Each lane keeps the sum of its own
  // columns, rescaled whenever the (quad-wide) row max grows. m is the max
  // of the unscaled scores until the statistics are written.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int job = 0; job < tiles; ++job) {
    scores(job);
    release(job);
    const int k0 = job * kKeys;
    mask(k0);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j)
        tile_max = fmaxf(tile_max, fmaxf(sacc[4 * j + 2 * half], sacc[4 * j + 2 * half + 1]));
      const float m_new = fmaxf(m[half], quad_max(tile_max));
      if (m_new == -INFINITY) continue;  // nothing kept in this row yet
      const float ml = m_new * sl2e;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j)  // keys past n: 2^-inf = 0
        sum += exp2_approx(fmaf(sacc[4 * j + 2 * half], sl2e, -ml)) +
               exp2_approx(fmaf(sacc[4 * j + 2 * half + 1], sl2e, -ml));
      l[half] = l[half] * exp2_approx((m[half] - m_new) * sl2e) + sum;
      m[half] = m_new;
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] = 1.f / quad_sum(l[half]);  // from here on, the reciprocal
    m[half] *= scale;                   // the max of the scaled scores
    if (m[half] == -INFINITY) {         // no key kept: p = 0
      m[half] = 0.f;
      l[half] = 1.f;
    }
  }
  if (stats != nullptr && t == 0) {
    const size_t srow = (size_t)bh * round_up(n, kKTile);
    if (row_lo < n) stats[srow + row_lo] = make_float2(m[0], l[0]);
    if (row_lo + 8 < n) stats[srow + row_lo + 8] = make_float2(m[1], l[1]);
  }
  m[0] *= kLog2e;  // from here on, the max times log2 e
  m[1] *= kLog2e;

  // Pass 2: the same scores again, pn = 2^(q.k scale log2e - m log2e) *
  // (1/l) rounded to bf16 in registers, then o += pn . v.
  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  for (int job = tiles; job < 2 * tiles; ++job) {
    scores(job);
    const int k0 = (job - tiles) * kKeys;
    mask(k0);
    uint32_t pa[kKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * (2 * kk + (e >> 1)) + 2 * (e & 1);
        const int half = e & 1;  // keys past n: p = 2^-inf = 0
        pa[kk][e] = pack_bf16(exp2_approx(fmaf(sacc[i], sl2e, -m[half])) * l[half],
                              exp2_approx(fmaf(sacc[i + 1], sl2e, -m[half])) * l[half]);
      }
    // keys at or past n: p = 0, and TMA zero-filled their V rows
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      wgmma_rs<D>(oacc, pa[kk], v_desc(job % kStages, kk));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(oacc);
    release(job);
  }

  // o rows < n, from registers
  bf16* lo = o + ((size_t)bh * n + row_lo) * D + 2 * t;
  bf16* hi = lo + 8 * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (row_lo < n)
      *reinterpret_cast<uint32_t*>(lo + 8 * j) = pack_bf16(oacc[4 * j], oacc[4 * j + 1]);
    if (row_lo + 8 < n)
      *reinterpret_cast<uint32_t*>(hi + 8 * j) = pack_bf16(oacc[4 * j + 2], oacc[4 * j + 3]);
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps and launch

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, reached through the runtime (so the
// library needs no -lcuda); null if it is not there.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 3-D map over (D, n, batch * heads) bf16, boxes of (kSwz, rows, 1),
// zero fill past each dimension's end.
template <int D>
bool encode_heads(CUtensorMap* map, const void* ptr, int n, int bh, int rows) {
  using S = Shape<D>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)n, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)n * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)S::kSwz, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            D >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* stats,
                   int batch, int n, int heads, float scale, cudaStream_t stream) {
  using S = Shape<D>;
  CUtensorMap tq, tk, tv;
  const int bh = batch * heads;
  if (!encode_heads<D>(&tq, q, n, bh, kRowsWG) || !encode_heads<D>(&tk, k, n, bh, kKeys) ||
      !encode_heads<D>(&tv, v, n, bh, kKeys))
    return cudaErrorInvalidValue;
  auto kernel = attention_fwd_sm90_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kRowsBlock - 1) / kRowsBlock, heads, batch);
  kernel<<<grid, kBlockThreads, S::kSmem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float2*>(stats), n, heads, scale);
  return cudaGetLastError();
}

// Checks the sizes, then launches for the head dim; returns a cudaError_t.
inline int dispatch(const void* q, const void* k, const void* v, void* o, void* stats,
                    int batch, int n, int heads, int head_dim, float scale, void* stream) {
  if (n < 1 || n > kMaxSeq || batch < 1 || heads < 1 || batch > 65535 || heads > 65535 ||
      !(scale > 0.f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return (int)launch<32>(q, k, v, o, stats, batch, n, heads, scale, s);
    case 64:
      return (int)launch<64>(q, k, v, o, stats, batch, n, heads, scale, s);
    case 128:
      return (int)launch<128>(q, k, v, o, stats, batch, n, heads, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace sm90
}  // namespace
