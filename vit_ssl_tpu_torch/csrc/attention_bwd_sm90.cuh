// Kernel B3's bfloat16 backward, redesigned for Hopper (sm_90a) with wgmma
// and TMA. Included by fused_attention.cu only (B1's libraries reach
// neither this header nor attention_fwd_sm90.cuh, whose tile shapes it
// uses; the Hopper primitives are sm90_common.cuh's); float32 stays on
// the CUDA-core body of attention_bwd.cuh. Every head dim the bf16
// forward takes (32, 64, 128) runs it.
//
// Replaces the TPU kernel vit_ssl_tpu/ops/flash_attention.py::
// _attn_bwd_kernel, called from _fused_attention_bwd_impl (C entry
// fused_attention_bwd). Per (b, h), on the head-major (B, H, N, D) layout:
//
//   p     = the forward's normalised probabilities, rounded to bf16
//   dv    = p^T . do                          fp32 accumulation
//   dp    = do . v^T                          fp32
//   delta = sum_j p * dp                      fp32, per query row
//   ds    = (p * (dp - delta) * scale) rounded to bf16
//   dq    = ds . k ; dk = ds^T . q            fp32 accumulation
//
// each result cast to bf16 on store. The TPU kernel reads the (N, N)
// probabilities its training forward saved; this one rebuilds p from q, k
// and the forward's statistics (m, 1/l) with the forward's own
// instructions (attention_fwd_sm90.cuh: the scores by the same wgmma,
// p = 2^(s scale log2e - m log2e) * (1/l) as one fma and ex2), so p is the
// forward's bit for bit where the scores are Q.K^T.
//
// delta is summed exactly as the plain version sums it, not taken as
// do . o (the identity JAX's kernel states): o is rounded to bf16, and
// do . o misses sum_j p * dp by that rounding, which leaves dp - delta as
// noise where it is exactly 0 (one key: p = 1, dq = dk = 0). That costs
// the dq kernel a first sweep (two products a key tile).
//
// What bounds it on an H100 SXM, at ViT-B/16's (64, 12, 577, 64) bf16
// (data sheet: 3.35 TB/s, 989 TFLOP/s bf16): q, k, v, do read and dq, dk,
// dv written, 401 MB with the statistics, 0.120 ms; the function's 5
// products (the scores again, dv, dp, dq, dk), 164 GFLOP, 0.165 ms:
// operations. This design does 9 (the scores and dp twice in the dq
// kernel and once in the dk/dv kernel) at N padded to 640 keys and
// queries, about 0.37 ms at peak, and 3 exponential passes.
//
// Design: two kernels, no atomics (the result repeats bit for bit). Both
// are blocks of two consumer warpgroups of 64 rows each, one block an SM;
// thread 0 issues every copy by TMA through 3-D tensor maps over
// (D, N, B*H) (a box that runs past row n of a head is zero-filled, never
// read from the next head) into a ring of kStages stages tracked by
// mbarriers. There is no producer warp: ptxas sizes a block's registers by
// whole warpgroups, so a ninth warp costs a warpgroup's registers (288
// threads get at most 168 a thread; D = 128's dk/dv consumer takes 237).
//
// - dq kernel, launched first: one block per (b, h, 128 query rows). Each
//   consumer loads its 64 rows of Q and dO once; K and V tiles of 64 keys
//   stream through the ring twice. Per tile S = Q.K^T and dP = dO.V^T
//   (wgmma, both operands K-major in shared memory), p rebuilt, keys >= n
//   forced to p = 0 (a zero-filled key gives s = 0, not -inf). Sweep 1
//   sums delta; sweep 2 packs ds to bf16 in registers as the A fragment of
//   dQ += dS.K (K as the MN-major B operand, the way the forward takes V).
//   It writes delta for the second kernel.
// - dk/dv kernel: one block per (b, h, 128 keys); each consumer loads its
//   64 rows of K and V once. Q and dO tiles of 64 queries, with their
//   (m, 1/l) and delta (bulk copies), stream through the ring; per tile
//   S^T = K.Q^T and dP^T = V.dO^T, so that p^T and ds^T land in the
//   accumulator layout that is wgmma's register A fragment: dV += p^T.dO
//   and dK += ds^T.Q (dO and Q as MN-major B operands). 4 products a tile.
//
// Every product is issued unconditionally (a wgmma under a branch makes
// ptxas serialise every wgmma of the kernel, C7520), and each group is
// waited for before its accumulators are read.
//
// Tried on the card and slower, so not kept: leaving a tile's last
// products (dQ; dV and dK) in flight while the next tile's scores are
// issued (ptxas serialised the wgmmas, C7515); Q and dO (K and V) as
// register A operands of the scores (207 registers at D = 64); two dq
// blocks an SM (4 consumer warpgroups, at most 128 registers: no faster);
// two dk/dv blocks an SM (spills); three consumer warpgroups a block at
// D <= 64 (dq slower by a sixth, dk/dv faster by 6 %); a ring of 2
// stages; the delta of do . o in place of sweep 1 (see above).
//
// The statistics and delta have round_up(n, 64) rows a head, not 128: the
// dq kernel reads them only for rows < n; the dk/dv kernel's query tiles
// are 64 rows, inside round_up(n, 64). Rows >= n of the statistics hold
// (0, 0), and queries >= n get s = -inf, so p = 0 there.
//
// kernels.py rebuilds a library when this header is newer than it.

#pragma once

#include "attention_fwd_sm90.cuh"  // B3's tiles: Shape, kConsumers, kKeys, ...
#include "sm90_common.cuh"         // mbarriers, TMA, wgmma, tensor maps

namespace {
namespace sm90 {

constexpr int kBwdThreads = 128 * kConsumers;  // no producer warp

template <int D>
struct BwdShape {
  using S = Shape<D>;
  static constexpr int kRowsBytes = kRowsWG * D * 2;  // 64 rows of one head
  // dq kernel: [Q, dO][consumer] rows, then [stage][K, V] tiles
  static constexpr int kDqRing = 2 * kConsumers * kRowsBytes;
  static constexpr int kDqBarriers = kDqRing + kStages * 2 * S::kTileBytes;
  static constexpr size_t kDqSmem = 1024 + kDqBarriers + 8 * (2 * kStages + 1);
  // dk/dv kernel: [K, V][consumer] rows, then [stage][Q, dO] tiles, then
  // [stage] 64 (m, 1/l) pairs and 64 deltas
  static constexpr int kStatBytes = kKeys * 8;
  static constexpr int kDeltaBytes = kKeys * 4;
  static constexpr int kDkvRing = 2 * kConsumers * kRowsBytes;
  static constexpr int kDkvStats = kDkvRing + kStages * 2 * S::kTileBytes;
  static constexpr int kDkvBarriers = kDkvStats + kStages * (kStatBytes + kDeltaBytes);
  static constexpr size_t kDkvSmem = 1024 + kDkvBarriers + 8 * (2 * kStages + 1);
};

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

// Loads one head's 64 rows at `row` of a 3-D map into `dst`, box by box.
template <int D>
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int row, int bh) {
  using S = Shape<D>;
#pragma unroll
  for (int sub = 0; sub < S::kSubs; ++sub)
    tma_load_3d(dst + sub * S::kTileSub, map, bar, sub * S::kSwz, row, bh);
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

// A warp's 16 accumulator rows (row_lo, row_lo + 8) as bf16, rows >= n
// skipped; dst points at row 0 of the head.
template <int D>
__device__ __forceinline__ void store_acc(bf16* dst, const float (&acc)[D / 2], int row_lo,
                                          int n, int t) {
  bf16* lo = dst + (size_t)row_lo * D + 2 * t;
  bf16* hi = lo + 8 * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (row_lo < n)
      *reinterpret_cast<uint32_t*>(lo + 8 * j) = pack_bf16(acc[4 * j], acc[4 * j + 1]);
    if (row_lo + 8 < n)
      *reinterpret_cast<uint32_t*>(hi + 8 * j) = pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
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
// columns 16kk .. 16kk + 15 of a 64 x 64 tile are fragment kk (see
// attention_fwd_sm90.cuh's accumulator layout).
__device__ __forceinline__ uint32_t& frag(uint32_t (&a)[kKeys / 16][4], int j, int half) {
  return a[j >> 1][2 * (j & 1) + half];
}

// The ring's mbarriers: full[s] (the stage's copies landed), empty[s]
// (every consumer warp finished reading it) and one for the rows a block
// loads once. There is no producer warp: thread 0 issues every copy. It
// fills the first kStages jobs before the sweep and, when job j is done,
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
  // This warp is done with job's stage; thread 0 then refills the stage
  // before it.
  template <typename Load>
  __device__ void release(int job, int jobs, Load& load_job) const {
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(empty(job % kStages));
    const int prev = job - 1;
    if (threadIdx.x == 0 && prev >= 0 && prev + kStages < jobs) {
      mbar_wait(empty(prev % kStages), (prev / kStages) & 1);
      load_job(prev + kStages);
    }
    __syncwarp();
  }
};

// grid (ceil(n / kRowsBlock), heads, batch), kBwdThreads threads,
// BwdShape<D>::kDqSmem bytes of dynamic shared memory. Writes dq (rows < n)
// and delta (rows < n of the (B, H, round_up(n, 64)) scratch).
//
// The block walks 2T jobs, T = ceil(n / 64) key tiles, each a K and a V
// tile: sweep 1 (jobs 0 .. T-1) sums delta, sweep 2 accumulates dq.
template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
    attention_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 const __grid_constant__ CUtensorMap tdo,
                                 const float2* __restrict__ stats, bf16* __restrict__ dq,
                                 float* __restrict__ delta, int n, int heads, float scale) {
  using S = Shape<D>;
  using B = BwdShape<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_smem = base;                                // [consumer] 64 rows
  const uint32_t do_smem = base + kConsumers * B::kRowsBytes;  // [consumer] 64 rows
  const Ring ring(base + B::kDqBarriers);
  auto k_tile = [&](int s) { return base + B::kDqRing + s * 2 * S::kTileBytes; };
  auto v_tile = [&](int s) { return k_tile(s) + S::kTileBytes; };

  const int bh = blockIdx.z * heads + blockIdx.y;
  const int q0 = blockIdx.x * kRowsBlock;
  const int consumers = min(kConsumers, (n - q0 + kRowsWG - 1) / kRowsWG);
  const int tiles = (n + kKeys - 1) / kKeys;
  const int jobs = 2 * tiles;
  auto load_job = [&](int job) {  // one thread: job's K and V tiles
    const int s = job % kStages, k0 = (job % tiles) * kKeys;
    mbar_expect_tx(ring.full(s), 2 * S::kTileBytes);
    tma_rows<D>(k_tile(s), &tk, ring.full(s), k0, bh);
    tma_rows<D>(v_tile(s), &tv, ring.full(s), k0, bh);
  };
  if (threadIdx.x == 0) {
    ring.init(consumers);
    mbar_expect_tx(ring.rows(), 2 * consumers * B::kRowsBytes);
    for (int c = 0; c < consumers; ++c) {
      tma_rows<D>(q_smem + c * B::kRowsBytes, &tq, ring.rows(), q0 + c * kRowsWG, bh);
      tma_rows<D>(do_smem + c * B::kRowsBytes, &tdo, ring.rows(), q0 + c * kRowsWG, bh);
    }
    for (int job = 0; job < min(kStages, jobs); ++job) load_job(job);
  }
  __syncthreads();

  const int c = threadIdx.x / 128;  // this consumer
  if (c >= consumers) return;       // all its rows lie past n
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int g = lane >> 2, t = lane & 3;
  const int row_lo = q0 + c * kRowsWG + 16 * warp + g;  // and row_lo + 8
  const size_t srow = (size_t)bh * round_up(n, kKTile);
  // the forward's (m log2 e, 1/l) of rows row_lo, row_lo + 8; (0, 0) past
  // n (the statistics hold round_up(n, 64) rows, the block 128)
  float ml[2], il[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_lo + 8 * half;
    const float2 st = row < n ? stats[srow + row] : make_float2(0.f, 0.f);
    ml[half] = st.x * kLog2e;
    il[half] = st.y;
  }
  const uint32_t q_addr = q_smem + c * B::kRowsBytes;
  const uint32_t do_addr = do_smem + c * B::kRowsBytes;
  const float sl2e = scale * kLog2e;
  mbar_wait(ring.rows(), 0);

  float sacc[kKeys / 2], dpacc[kKeys / 2], dqacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqacc[i] = 0.f;
  // S = Q . K^T and dP = dO . V^T of job's tiles; keys >= n get s = -inf
  auto products = [&](int job) {
    const int s = job % kStages;
    ring.wait_full(job);
    wgmma_fence();
    scores<D>(sacc, q_addr, k_tile(s));
    scores<D>(dpacc, do_addr, v_tile(s));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(sacc);
    reg_fence(dpacc);
    mask_columns(sacc, (job % tiles) * kKeys, n, t);
  };
  // p as the forward rounded it: 2^(s scale log2e - m log2e) * (1/l)
  auto probs = [&](int i, int half) {
    return pack_bf16(exp2_approx(fmaf(sacc[i], sl2e, -ml[half])) * il[half],
                     exp2_approx(fmaf(sacc[i + 1], sl2e, -ml[half])) * il[half]);
  };

  // sweep 1: delta = sum_j p * dp, each lane over its own columns
  float dsum[2] = {0.f, 0.f};
  for (int job = 0; job < tiles; ++job) {
    products(job);
    ring.release(job, jobs, load_job);
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 4 * j + 2 * half;
        const uint32_t p = probs(i, half);
        dsum[half] += bf16_lo(p) * dpacc[i] + bf16_hi(p) * dpacc[i + 1];
      }
  }
  const float dl[2] = {quad_sum(dsum[0]), quad_sum(dsum[1])};
  if (t == 0) {
    if (row_lo < n) delta[srow + row_lo] = dl[0];
    if (row_lo + 8 < n) delta[srow + row_lo + 8] = dl[1];
  }

  // sweep 2: ds = p (dp - delta) scale packed as dQ's A fragment, then
  // dQ += dS . K
  for (int job = tiles; job < jobs; ++job) {
    products(job);
    uint32_t dsa[kKeys / 16][4];
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 4 * j + 2 * half;
        const uint32_t p = probs(i, half);
        frag(dsa, j, half) = pack_bf16(bf16_lo(p) * (dpacc[i] - dl[half]) * scale,
                                       bf16_hi(p) * (dpacc[i + 1] - dl[half]) * scale);
      }
    wgmma_fence();
    product_rs<D>(dqacc, dsa, k_tile(job % kStages));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(dqacc);
    ring.release(job, jobs, load_job);
  }
  store_acc<D>(dq + (size_t)bh * n * D, dqacc, row_lo, n, t);
}

// grid (ceil(n / kRowsBlock), heads, batch), kBwdThreads threads,
// BwdShape<D>::kDkvSmem bytes of dynamic shared memory. Block x owns keys
// 128x .. 128x + 127, consumer c 64 of them. Reads delta from the dq
// kernel; writes dk and dv (rows < n).
template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
    attention_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                  const __grid_constant__ CUtensorMap tk,
                                  const __grid_constant__ CUtensorMap tv,
                                  const __grid_constant__ CUtensorMap tdo,
                                  const float2* __restrict__ stats,
                                  const float* __restrict__ delta, bf16* __restrict__ dk,
                                  bf16* __restrict__ dv, int n, int heads, float scale) {
  using S = Shape<D>;
  using B = BwdShape<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t k_smem = base;                                // [consumer] 64 rows
  const uint32_t v_smem = base + kConsumers * B::kRowsBytes;  // [consumer] 64 rows
  const Ring ring(base + B::kDkvBarriers);
  auto q_tile = [&](int s) { return base + B::kDkvRing + s * 2 * S::kTileBytes; };
  auto do_tile = [&](int s) { return q_tile(s) + S::kTileBytes; };
  auto st_tile = [&](int s) {  // (m, 1/l) pairs, then deltas
    return base + B::kDkvStats + s * (B::kStatBytes + B::kDeltaBytes);
  };

  const int bh = blockIdx.z * heads + blockIdx.y;
  const int k0 = blockIdx.x * kRowsBlock;
  const int consumers = min(kConsumers, (n - k0 + kRowsWG - 1) / kRowsWG);
  const int jobs = (n + kKeys - 1) / kKeys;  // query tiles
  const size_t srow = (size_t)bh * round_up(n, kKTile);
  auto load_job = [&](int job) {  // one thread: Q, dO, (m, 1/l) and delta
    const int s = job % kStages, q0 = job * kKeys;  // 64 rows inside round_up(n, 64)
    mbar_expect_tx(ring.full(s), 2 * S::kTileBytes + B::kStatBytes + B::kDeltaBytes);
    tma_rows<D>(q_tile(s), &tq, ring.full(s), q0, bh);
    tma_rows<D>(do_tile(s), &tdo, ring.full(s), q0, bh);
    bulk_load(st_tile(s), stats + srow + q0, B::kStatBytes, ring.full(s));
    bulk_load(st_tile(s) + B::kStatBytes, delta + srow + q0, B::kDeltaBytes, ring.full(s));
  };
  if (threadIdx.x == 0) {
    ring.init(consumers);
    mbar_expect_tx(ring.rows(), 2 * consumers * B::kRowsBytes);
    for (int c = 0; c < consumers; ++c) {
      tma_rows<D>(k_smem + c * B::kRowsBytes, &tk, ring.rows(), k0 + c * kRowsWG, bh);
      tma_rows<D>(v_smem + c * B::kRowsBytes, &tv, ring.rows(), k0 + c * kRowsWG, bh);
    }
    for (int job = 0; job < min(kStages, jobs); ++job) load_job(job);
  }
  __syncthreads();

  const int c = threadIdx.x / 128;
  if (c >= consumers) return;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int g = lane >> 2, t = lane & 3;
  const int key_lo = k0 + c * kRowsWG + 16 * warp + g;  // and key_lo + 8
  const uint32_t k_addr = k_smem + c * B::kRowsBytes;
  const uint32_t v_addr = v_smem + c * B::kRowsBytes;
  const float sl2e = scale * kLog2e;
  mbar_wait(ring.rows(), 0);

  float sacc[kKeys / 2], dpacc[kKeys / 2], dkacc[D / 2], dvacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dkacc[i] = dvacc[i] = 0.f;
  for (int job = 0; job < jobs; ++job) {
    const int s = job % kStages;
    ring.wait_full(job);
    wgmma_fence();
    scores<D>(sacc, k_addr, q_tile(s));    // S^T = K . Q^T
    scores<D>(dpacc, v_addr, do_tile(s));  // dP^T = V . dO^T
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(sacc);
    reg_fence(dpacc);
    mask_columns(sacc, job * kKeys, n, t);  // queries >= n: p = 0
    // each column is a query: its (m, 1/l) and delta from the stage
    const uint8_t* stage = smem_raw + (st_tile(s) - smem_u32(smem_raw));
    const float4* st = reinterpret_cast<const float4*>(stage);
    const float2* dlt = reinterpret_cast<const float2*>(stage + B::kStatBytes);
    uint32_t pa[kKeys / 16][4], dsa[kKeys / 16][4];
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      const int col = 8 * j + 2 * t;  // and col + 1
      const float4 mi = st[col / 2];  // (m, 1/l) of both columns
      const float2 de = dlt[col / 2];  // their deltas
      const float m0 = mi.x * kLog2e, m1 = mi.z * kLog2e;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 4 * j + 2 * half;
        const uint32_t p = pack_bf16(exp2_approx(fmaf(sacc[i], sl2e, -m0)) * mi.y,
                                     exp2_approx(fmaf(sacc[i + 1], sl2e, -m1)) * mi.w);
        frag(pa, j, half) = p;
        frag(dsa, j, half) = pack_bf16(bf16_lo(p) * (dpacc[i] - de.x) * scale,
                                       bf16_hi(p) * (dpacc[i + 1] - de.y) * scale);
      }
    }
    wgmma_fence();
    product_rs<D>(dvacc, pa, do_tile(s));  // dV += p^T . dO
    product_rs<D>(dkacc, dsa, q_tile(s));  // dK += dS^T . Q
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(dvacc);
    reg_fence(dkacc);
    ring.release(job, jobs, load_job);
  }
  const size_t head = (size_t)bh * n * D;
  store_acc<D>(dk + head, dkacc, key_lo, n, t);
  store_acc<D>(dv + head, dvacc, key_lo, n, t);
}

// ---------------------------------------------------------------------------
// host: launch

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                       const void* stats, void* dq, void* dk, void* dv, void* delta,
                       int batch, int n, int heads, float scale, cudaStream_t stream) {
  using B = BwdShape<D>;
  CUtensorMap tq, tk, tv, tdo;
  const int bh = batch * heads;
  if (!encode_heads<D>(&tq, q, n, bh, kRowsWG) || !encode_heads<D>(&tk, k, n, bh, kKeys) ||
      !encode_heads<D>(&tv, v, n, bh, kKeys) || !encode_heads<D>(&tdo, dout, n, bh, kKeys))
    return cudaErrorInvalidValue;
  const dim3 grid((n + kRowsBlock - 1) / kRowsBlock, heads, batch);
  const float2* st = static_cast<const float2*>(stats);
  float* dl = static_cast<float*>(delta);
  auto dq_kernel = attention_bwd_dq_sm90_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)B::kDqSmem);
  if (err != cudaSuccess) return err;
  dq_kernel<<<grid, kBwdThreads, B::kDqSmem, stream>>>(tq, tk, tv, tdo, st,
                                                       static_cast<bf16*>(dq), dl, n, heads,
                                                       scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  auto dkv_kernel = attention_bwd_dkv_sm90_kernel<D>;
  err = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)B::kDkvSmem);
  if (err != cudaSuccess) return err;
  dkv_kernel<<<grid, kBwdThreads, B::kDkvSmem, stream>>>(
      tq, tk, tv, tdo, st, dl, static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, heads,
      scale);
  return cudaGetLastError();
}

// Checks the sizes, then launches both kernels for the head dim; returns
// the first non-zero cudaError_t (0 = both launched).
inline int bwd_dispatch(const void* q, const void* k, const void* v, const void* dout,
                        const void* stats, void* dq, void* dk, void* dv, void* delta,
                        int batch, int n, int heads, int head_dim, float scale, void* stream) {
  if (n < 1 || n > kMaxSeq || batch < 1 || heads < 1 || batch > 65535 || heads > 65535 ||
      !(scale > 0.f) || stats == nullptr || delta == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return (int)launch_bwd<32>(q, k, v, dout, stats, dq, dk, dv, delta, batch, n, heads,
                                 scale, s);
    case 64:
      return (int)launch_bwd<64>(q, k, v, dout, stats, dq, dk, dv, delta, batch, n, heads,
                                 scale, s);
    case 128:
      return (int)launch_bwd<128>(q, k, v, dout, stats, dq, dk, dv, delta, batch, n, heads,
                                  scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace sm90
}  // namespace
