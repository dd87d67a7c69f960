// Hopper (sm_90a) pieces of the wgmma/TMA attention bodies: kernels
// B1's and B3's bf16 forwards (attention_fwd_sm90.cuh), kernel B2's bf16
// forward (flash_blockwise_fwd_sm90.cuh) and the bf16 backward of B3 and
// B2 (attention_bwd_sm90.cuh). Shared-memory addresses, mbarriers and the
// ring of stages, TMA loads through 3-D tensor maps, wgmma descriptors and
// products, the tiles all three share, the masking of keys past n, the
// row-guarded bf16 store, and the host's encoding of the tensor maps. Each
// library that includes it builds only the bodies it instantiates.
//
// kernels.py rebuilds a library when this header is newer than it.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, no -lcuda
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "attention_nhd_common.cuh"  // bf16, pack_bf16

namespace {
namespace sm90 {

// The TMA box and wgmma swizzle of a head dim: rows of kSwz bf16, 128-byte
// swizzle at D >= 64 (D = 128 takes two boxes side by side), 64-byte at
// D = 32.
template <int D>
struct HeadTile {
  static_assert(D == 32 || D == 64 || D == 128, "head_dim 32, 64 or 128");
  static constexpr int kSwz = D >= 64 ? 64 : 32;         // bf16 a swizzled row
  static constexpr int kRowBytes = 2 * kSwz;             // 128 or 64
  static constexpr int kSubs = D / kSwz;                 // boxes side by side
  static constexpr uint64_t kLayout = D >= 64 ? 1 : 2;   // descriptor: B128, B64
  // Where TMA put 16-byte chunk `chunk` of row r of a box (the box 1024-byte
  // aligned): the swizzle XORs the chunk index with address bits 7 and up,
  // three of them at 128 B (r % 8), two at 64 B ((r / 2) % 4).
  __device__ static int chunk_at(int r, int chunk) {
    const int off = r * kRowBytes + 16 * chunk;
    return off ^ (((off >> 7) & (D >= 64 ? 7 : 3)) << 4);
  }
};

// The tiles of every body here: blocks of kConsumers consumer warpgroups of
// kRowsWG rows each; key (or query) tiles of kKeys rows stream through a
// ring of kStages stages.
constexpr int kConsumers = 2;                     // consumer warpgroups a block
constexpr int kRowsWG = 64;                       // rows a consumer
constexpr int kRowsBlock = kConsumers * kRowsWG;  // rows a block
constexpr int kStages = 4;
constexpr int kKeys = 64;  // keys a tile (B2's KERNEL_BLOCK_K in ops/flash_blockwise.py)

template <int D>
struct Shape : HeadTile<D> {  // kSwz, kRowBytes, kSubs, kLayout
  using HeadTile<D>::kRowBytes;
  static constexpr int kQBytes = kRowsWG * D * 2;        // one consumer's Q
  static constexpr int kTileBytes = kKeys * D * 2;       // one K or V tile
  static constexpr int kQSub = kRowsWG * kRowBytes;      // Q box bytes
  static constexpr int kTileSub = kKeys * kRowBytes;     // K/V box bytes
  static_assert(kQSub == kTileSub, "one box shape for rows and tiles");
  // the forwards' shared memory: [consumer] Q, [stage][K, V], the ring's
  // barriers; + 1024 so the base can be rounded up to the 1024-byte
  // swizzle atom
  static constexpr int kBarrierOffset =
      kConsumers * kQBytes + kStages * 2 * kTileBytes;
  static constexpr size_t kSmem = 1024 + kBarrierOffset + 8 * (2 * kStages + 1);
  // blocks an SM a forward holds: two at D <= 64 (81 KB of shared memory
  // each at D = 64), one at D = 128 (its O accumulator needs more
  // registers)
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

// ---------------------------------------------------------------------------
// device: the pieces the bodies share

// Bytes from global to shared memory by the bulk-copy engine; completion
// counted on `bar`. dst, src and bytes multiples of 16.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma descriptors of a 64-row TMA tile at `base` (Shape<D>'s swizzle,
// boxes of kSwz columns side by side): K-major (the reduction runs along
// D), step kk = 16 columns; MN-major (the reduction runs along the rows),
// step kk = 16 rows, LBO the next box.
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t base, int kk) {
  using S = Shape<D>;
  const int col = 16 * kk;
  return desc(base + (col / S::kSwz) * S::kTileSub + (col % S::kSwz) * 2, 16,
              8 * S::kRowBytes, S::kLayout);
}

template <int D>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t base, int kk) {
  using S = Shape<D>;
  return desc(base + 16 * kk * S::kRowBytes, S::kTileSub, 8 * S::kRowBytes, S::kLayout);
}

// Loads one head's 64 rows at `row` of a 3-D map into `dst`, box by box:
// the head's columns start at `col` of plane `plane` (B3 and B2: column 0
// of plane b*H + h; B1: column h*D of plane b).
template <int D>
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int row, int plane, int col = 0) {
  using S = Shape<D>;
#pragma unroll
  for (int sub = 0; sub < S::kSubs; ++sub)
    tma_load_3d(dst + sub * S::kTileSub, map, bar, col + sub * S::kSwz, row, plane);
}

// acc (64 x 64 fp32) = A . B^T over the head dim, both tiles K-major.
template <int D>
__device__ __forceinline__ void scores(float (&acc)[kKeys / 2], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<kKeys>(acc, kmajor_desc<D>(a, kk), kmajor_desc<D>(b, kk), kk > 0);
}

// acc (64 x D fp32) += P . B over 64 rows of B (MN-major), P in registers.
template <int D>
__device__ __forceinline__ void product_rs(float (&acc)[D / 2],
                                           const uint32_t (&pa)[kKeys / 16][4], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) wgmma_rs<D>(acc, pa[kk], mnmajor_desc<D>(b, kk));
}

// Accumulator layout (wgmma m64nN, as mma.sync's m16n8 per warp): warp w
// of a consumer holds rows 16w + g and 16w + g + 8 (g = lane / 4); for
// column block j (8 columns), d[4j], d[4j + 1] are row 16w + g, columns
// 8j + 2t, 8j + 2t + 1 (t = lane % 4), and d[4j + 2], d[4j + 3] the same
// columns of row 16w + g + 8. Columns 16kk .. 16kk + 15 of a 64 x 64 tile,
// packed to bf16, are the A fragment of a product over rows 16kk .. 16kk +
// 15 of its B operand.

struct AsIs {
  __device__ float operator()(float x, int) const { return x; }
};

// A warp's 16 accumulator rows (row_lo, row_lo + 8) as bf16, rows >= n
// skipped; dst points at row 0, rows `stride` elements apart. Each value
// is stored as value(x, half), half 0 for row_lo and 1 for row_lo + 8 (B2's
// forward divides by the row sum there, only for the rows it stores).
template <int D, typename Value = AsIs>
__device__ __forceinline__ void store_acc(bf16* dst, const float (&acc)[D / 2], int row_lo,
                                          int n, int t, int stride = D, Value value = {}) {
  bf16* lo = dst + (size_t)row_lo * stride + 2 * t;
  bf16* hi = lo + (size_t)8 * stride;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (row_lo < n)
      *reinterpret_cast<uint32_t*>(lo + 8 * j) =
          pack_bf16(value(acc[4 * j], 0), value(acc[4 * j + 1], 0));
    if (row_lo + 8 < n)
      *reinterpret_cast<uint32_t*>(hi + 8 * j) =
          pack_bf16(value(acc[4 * j + 2], 1), value(acc[4 * j + 3], 1));
  }
}

// -inf for the columns at or past n of a 64-column score tile starting at
// column c0 (uniform: only the last tile has any).
__device__ __forceinline__ void mask_columns(float (&acc)[kKeys / 2], int c0, int n, int t) {
  if (c0 + kKeys <= n) return;
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c0 + 8 * j + 2 * t + (e & 1) >= n) acc[4 * j + e] = -INFINITY;
}

// The A-fragment slot of accumulator column block j, row half `half`:
// columns 16kk .. 16kk + 15 of a 64 x 64 tile are fragment kk.
__device__ __forceinline__ uint32_t& frag(uint32_t (&a)[kKeys / 16][4], int j, int half) {
  return a[j >> 1][2 * (j & 1) + half];
}

// The ring's mbarriers: full[s] (the stage's copies landed), empty[s]
// (every consumer warp finished reading it) and one for the rows a block
// loads once. Either a producer warp issues the copies (wait_free before
// each), or, with no producer warp, thread 0 does: it fills the first
// kStages jobs before the sweep and, in release, when job j is done,
// refills job j - 1's stage with job j - 1 + kStages (one job behind, so
// that it seldom waits for the other consumer to release the stage).
struct Ring {
  uint32_t bars;
  __device__ explicit Ring(uint32_t b) : bars(b) {}
  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 8 * (kStages + s); }
  __device__ uint32_t rows() const { return bars + 16 * kStages; }
  __device__ void init(int consumers) const {
    mbar_init(rows(), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * consumers);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __device__ void wait_full(int job) const {
    mbar_wait(full(job % kStages), (job / kStages) & 1);
  }
  // Producer: waits until job's stage is free (job - kStages released).
  __device__ void wait_free(int job) const {
    mbar_wait(empty(job % kStages), ((job / kStages) & 1) ^ 1);
  }
  // This warp is done with job's stage.
  __device__ void arrive(int job) const {
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(empty(job % kStages));
  }
  // arrive, then thread 0 refills the stage before it (no producer warp).
  template <typename Load>
  __device__ void release(int job, int jobs, Load& load_job) const {
    arrive(job);
    const int prev = job - 1;
    if (threadIdx.x == 0 && prev >= 0 && prev + kStages < jobs) {
      mbar_wait(empty(prev % kStages), (prev / kStages) & 1);
      load_job(prev + kStages);
    }
    __syncwarp();
  }
};

// ---------------------------------------------------------------------------
// host: tensor maps

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

// A 3-D map over (width, n, planes) bf16: rows of `width` elements, n rows
// a plane, planes back to back; boxes of (kSwz, rows, 1), zero fill past
// each dimension's end. A head-major (B, H, N, D) tensor is (D, n, B*H):
// a box that runs past row n of one head is zero-filled, never read from
// the next head. B1's (B, N, H*D) tensor is (H*D, n, B), head h's boxes at
// column h*D: a box never reaches the neighbouring head's columns (kSwz
// divides D), and one that runs past row n of one image is zero-filled,
// never read from the next image. Returns false if cuTensorMapEncodeTiled
// refuses the map or cannot be found.
template <int D>
bool encode_rows(CUtensorMap* map, const void* ptr, int width, int n, int planes, int rows) {
  using S = HeadTile<D>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)n, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)width * 2, (cuuint64_t)n * width * 2};
  const cuuint32_t box[3] = {(cuuint32_t)S::kSwz, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            D >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A head-major (B, H, N, D) tensor's map: (D, n, batch * heads).
template <int D>
bool encode_heads(CUtensorMap* map, const void* ptr, int n, int bh, int rows) {
  return encode_rows<D>(map, ptr, D, n, bh, rows);
}

}  // namespace sm90
}  // namespace
