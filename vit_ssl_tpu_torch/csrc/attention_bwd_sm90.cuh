// The bfloat16 attention backward of kernels B3 and B2 on the head-major
// (B, H, N, D) layout, for Hopper (sm_90a) with wgmma and TMA: two kernels
// (dq, then dk/dv), templated on the softmax statistics the forward saved.
// Included by fused_attention.cu (B3's form) and flash_blockwise_bwd.cu
// (B2's form); each library instantiates its own form only. The tiles and
// Hopper pieces are sm90_common.cuh's; float32 stays on the CUDA-core bodies
// (attention_bwd.cuh for B3, flash_blockwise_bwd.cu for B2). Every head dim
// the bf16 forwards take (32, 64, 128) runs it.
//
// Replaces the TPU kernels vit_ssl_tpu/ops/flash_attention.py::
// _attn_bwd_kernel, called from _fused_attention_bwd_impl (B3; C entry
// fused_attention_bwd), and vit_ssl_tpu/ops/flash_blockwise.py::_dq_kernel
// and ::_dkv_kernel, called from _flash_bwd (B2; C entries blockwise_bwd_dq
// and blockwise_bwd_dkv). Per (b, h):
//
//   p     = softmax probabilities of s = q . k^T * scale, keys past n 0
//   dv    = p.bf16^T . do                     fp32 accumulation
//   dp    = do . v^T                          fp32
//   ds    = (p * (dp - delta) * scale) rounded to bf16
//   dq    = ds . k ; dk = ds^T . q            fp32 accumulation
//
// each result cast to bf16 on store. The two forms:
//
// - B3 (kLse false): the forward saved each row's (m, 1/l); p is its
//   normalised probability rounded to bf16, rebuilt with the forward's own
//   instructions (attention_fwd_sm90.cuh: the scores by the same wgmma,
//   p = 2^(s scale log2e - m log2e) * (1/l) as one fma and ex2), so p is
//   the forward's bit for bit where the scores are Q.K^T. delta = sum_j
//   p * dp, summed exactly as the plain version sums it, not taken as
//   do . o (the identity JAX's kernel states): o is rounded to bf16, and
//   do . o misses sum_j p * dp by that rounding, which leaves dp - delta as
//   noise where it is exactly 0 (one key: p = 1, dq = dk = 0). That costs
//   the dq kernel a first sweep (two products a key tile).
// - B2 (kLse true): the forward saved each row's lse; p = exp(s - lse) in
//   fp32, as 2^(s scale log2e - lse log2e) (one fma, one ex2.approx), NOT
//   rounded before ds (dv takes it rounded), as JAX's kernels form it.
//   delta = rowsum(do . o) - dlse (dlse: the lse output's cotangent, 0 when
//   not given), the contract of JAX's _flash_bwd: the dq kernel sums it in
//   fp32 for its rows before its one sweep (three products a key tile).
//
// What bounds it on an H100 SXM (data sheet: 3.35 TB/s, 989 TFLOP/s bf16):
// - B3 at ViT-B/16's (64, 12, 577, 64): q, k, v, do read and dq, dk, dv
//   written, 401 MB with the statistics, 0.120 ms; the function's 5
//   products (the scores again, dv, dp, dq, dk), 164 GFLOP, 0.165 ms:
//   operations. This design does 9 (the scores and dp twice in the dq
//   kernel and once in the dk/dv kernel) at N padded to 640.
// - B2 at ViT-B/16's (64, 12, 1025, 64): 103.3 GFLOP a product; the dq
//   kernel reads q, k, v, o, do and lse and writes dq and delta (605 MB,
//   0.181 ms) and does 3 products (0.313 ms); the dk/dv kernel reads q, k,
//   v, do, lse and delta and writes dk and dv (605 MB) and does 4 (0.418
//   ms): operations. Both at N padded to 1088 keys and 1152 queries.
//
// Design, both forms: no atomics (the result repeats bit for bit). Both
// kernels are blocks of two consumer warpgroups of 64 rows each, one block
// an SM; thread 0 issues every copy by TMA through 3-D tensor maps over
// (D, N, B*H) (a box that runs past row n of a head is zero-filled, never
// read from the next head) into sm90_common.cuh's Ring of kStages stages.
// There is no producer warp: ptxas sizes a block's registers by whole
// warpgroups, so a ninth warp costs a warpgroup's registers (288 threads
// get at most 168 a thread; D = 128's dk/dv consumer takes 237).
//
// - dq kernel, launched first: one block per (b, h, 128 query rows). Each
//   consumer loads its 64 rows of Q and dO once; K and V tiles of 64 keys
//   stream through the ring (B3: twice; B2: once). Per tile S = Q.K^T and
//   dP = dO.V^T (wgmma, both operands K-major in shared memory), p rebuilt,
//   keys >= n forced to p = 0 (a zero-filled key gives s = 0, not -inf).
//   B3's sweep 1 sums delta; the last sweep packs ds to bf16 in registers as
//   the A fragment of dQ += dS.K (K as the MN-major B operand, the way the
//   forward takes V). B2 sums delta before its sweep: each lane dO . O over
//   a quarter of the head dim of its two rows, O from device memory (loaded
//   while the rows land), dO from its swizzled TMA tile, then over the
//   quad. It writes delta for the second kernel.
// - dk/dv kernel: one block per (b, h, 128 keys); each consumer loads its
//   64 rows of K and V once. Q and dO tiles of 64 queries, with their
//   statistics and delta (bulk copies), stream through the ring; per tile
//   S^T = K.Q^T and dP^T = V.dO^T, so that p^T and ds^T land in the
//   accumulator layout that is wgmma's register A fragment: dV += p^T.dO
//   and dK += ds^T.Q (dO and Q as MN-major B operands). 4 products a tile.
//
// Every product is issued unconditionally (a wgmma under a branch makes
// ptxas serialise every wgmma of the kernel, C7520), and each group is
// waited for before its accumulators are read. At N = 1025 the ninth
// 128-row block of a head holds one live row (dq) or key (dk/dv): its
// second consumer returns before the loop, and the ring's empty barriers
// count the live consumers only.
//
// Tried on the card for B3 and slower, so not kept: leaving a tile's last
// products (dQ; dV and dK) in flight while the next tile's scores are
// issued (ptxas serialised the wgmmas, C7515); Q and dO (K and V) as
// register A operands of the scores (207 registers at D = 64); two dq
// blocks an SM (4 consumer warpgroups, at most 128 registers: no faster);
// two dk/dv blocks an SM (spills); three consumer warpgroups a block at
// D <= 64 (dq slower by a sixth, dk/dv faster by 6 %); a ring of 2
// stages; the delta of do . o in place of sweep 1 (see above).
//
// The statistics and delta have round_up(n, 64) rows a head, not 128: the
// dq kernel reads them only for rows inside a live consumer's 64; the
// dk/dv kernel's query tiles are 64 rows, inside round_up(n, 64). Past n,
// B3's statistics hold (0, 0) and its delta 0 (the caller zero-fills
// both), B2's lse +inf (the caller pads it) and its delta 0 (the dq kernel
// writes every row of a live consumer); queries >= n get s = -inf, so
// p = 0 there, and dP = 0 (dO zero-filled), with no NaN.
//
// kernels.py rebuilds a library when this header is newer than it.

#pragma once

#include <type_traits>

#include "attention_nhd_common.cuh"  // bf16, pack_bf16, exp2_approx, quad_sum
#include "sm90_common.cuh"           // tiles, ring, TMA, wgmma, descriptors, tensor maps

namespace {
namespace sm90 {

constexpr int kBwdThreads = 128 * kConsumers;  // no producer warp

// A query row's softmax statistics: B3's (m, 1/l), B2's lse.
template <bool kLse>
using BwdStat = std::conditional_t<kLse, float, float2>;

template <int D, bool kLse>
struct BwdShape {
  using S = Shape<D>;
  static constexpr int kRowsBytes = kRowsWG * D * 2;  // 64 rows of one head
  // dq kernel: [Q, dO][consumer] rows, then [stage][K, V] tiles
  static constexpr int kDqRing = 2 * kConsumers * kRowsBytes;
  static constexpr int kDqBarriers = kDqRing + kStages * 2 * S::kTileBytes;
  static constexpr size_t kDqSmem = 1024 + kDqBarriers + 8 * (2 * kStages + 1);
  // dk/dv kernel: [K, V][consumer] rows, then [stage][Q, dO] tiles, then
  // [stage] 64 statistics and 64 deltas
  static constexpr int kStatBytes = kKeys * (int)sizeof(BwdStat<kLse>);
  static constexpr int kDeltaBytes = kKeys * 4;
  static constexpr int kDkvRing = 2 * kConsumers * kRowsBytes;
  static constexpr int kDkvStats = kDkvRing + kStages * 2 * S::kTileBytes;
  static constexpr int kDkvBarriers = kDkvStats + kStages * (kStatBytes + kDeltaBytes);
  static constexpr size_t kDkvSmem = 1024 + kDkvBarriers + 8 * (2 * kStages + 1);
};

// d + the 8 products of two rows of 8 bf16, in order.
__device__ __forceinline__ float bf16_dot8(uint4 a, uint4 b, float d) {
  const uint32_t* x = reinterpret_cast<const uint32_t*>(&a);
  const uint32_t* y = reinterpret_cast<const uint32_t*>(&b);
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    d = fmaf(bf16_lo(x[w]), bf16_lo(y[w]), d);
    d = fmaf(bf16_hi(x[w]), bf16_hi(y[w]), d);
  }
  return d;
}

// The dq kernel of either form: grid (ceil(n / kRowsBlock), heads, batch),
// kBwdThreads threads, BwdShape<D, kLse>::kDqSmem bytes of dynamic shared
// memory. stats: round_up(n, 64) rows a head. B3: (m, 1/l), o and dlse
// unused; writes delta for rows < n. B2: the lse (+inf past n), o
// (B, H, n, D), dlse (B, H, n) or null; writes delta for every row of a
// live consumer (0 past n). Writes dq (rows < n).
//
// The block walks the key tiles, T = ceil(n / 64), each a K and a V tile:
// B3 in 2T jobs (sweep 1, jobs 0 .. T-1, sums delta; sweep 2 accumulates
// dq), B2 in T (delta first, from dO and O).
template <int D, bool kLse>
__device__ __forceinline__ void bwd_dq(const CUtensorMap& tq, const CUtensorMap& tk,
                                       const CUtensorMap& tv, const CUtensorMap& tdo,
                                       const BwdStat<kLse>* __restrict__ stats,
                                       const bf16* __restrict__ o,
                                       const float* __restrict__ dlse, bf16* __restrict__ dq,
                                       float* __restrict__ delta, int n, int heads,
                                       float scale) {
  using S = Shape<D>;
  using B = BwdShape<D, kLse>;
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
  const int jobs = kLse ? tiles : 2 * tiles;
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
  // rows row_lo, row_lo + 8: B3 the forward's (m log2 e, 1/l), (0, 0) past
  // n (the statistics hold round_up(n, 64) rows, the block 128); B2 the
  // lse times log2 e (+inf past n: p = 0)
  float ml[2], il[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_lo + 8 * half;
    if constexpr (kLse) {
      ml[half] = stats[srow + row] * kLog2e;
    } else {
      const float2 st = row < n ? stats[srow + row] : make_float2(0.f, 0.f);
      ml[half] = st.x * kLog2e;
      il[half] = st.y;
    }
  }
  const uint32_t q_addr = q_smem + c * B::kRowsBytes;
  const uint32_t do_addr = do_smem + c * B::kRowsBytes;
  const float sl2e = scale * kLog2e;
  // B2: this lane's quarter of the head dim of O's rows row_lo, row_lo + 8
  // (kChunks 16-byte chunks a row; 0 past n), loaded while the rows land
  constexpr int kChunks = D / 32;
  uint4 ov[2][kChunks];
  if constexpr (kLse) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row_lo + 8 * half;
      const uint4* src = reinterpret_cast<const uint4*>(o + ((size_t)bh * n + row) * D);
#pragma unroll
      for (int u = 0; u < kChunks; ++u)
        ov[half][u] = row < n ? src[t * kChunks + u] : make_uint4(0u, 0u, 0u, 0u);
    }
  }
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
  // B3: p as the forward rounded it, 2^(s scale log2e - m log2e) * (1/l)
  auto probs = [&](int i, int half) {
    return pack_bf16(exp2_approx(fmaf(sacc[i], sl2e, -ml[half])) * il[half],
                     exp2_approx(fmaf(sacc[i + 1], sl2e, -ml[half])) * il[half]);
  };

  float dl[2];  // delta of rows row_lo, row_lo + 8
  if constexpr (kLse) {
    // delta = sum_d dO O - dlse; dO from its TMA tile (the swizzled boxes of
    // kSwz columns; zero-filled past n)
    const uint8_t* do_rows = smem_raw + (do_addr - smem_u32(smem_raw));
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * warp + g + 8 * half;  // row of the consumer's tile
      float d = 0.f;
#pragma unroll
      for (int u = 0; u < kChunks; ++u) {
        const int chunk = t * kChunks + u;  // columns 8 chunk .. 8 chunk + 7
        constexpr int kBoxChunks = S::kSwz / 8;
        const uint4 dov = *reinterpret_cast<const uint4*>(
            do_rows + (chunk / kBoxChunks) * S::kTileSub + S::chunk_at(r, chunk % kBoxChunks));
        d = bf16_dot8(dov, ov[half][u], d);
      }
      const int row = row_lo + 8 * half;
      dl[half] = quad_sum(d);
      if (dlse != nullptr && row < n) dl[half] -= dlse[(size_t)bh * n + row];
    }
    if (t == 0) {  // every row of this consumer lies inside round_up(n, 64)
      delta[srow + row_lo] = dl[0];
      delta[srow + row_lo + 8] = dl[1];
    }
  } else {
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
    dl[0] = quad_sum(dsum[0]);
    dl[1] = quad_sum(dsum[1]);
    if (t == 0) {
      if (row_lo < n) delta[srow + row_lo] = dl[0];
      if (row_lo + 8 < n) delta[srow + row_lo + 8] = dl[1];
    }
  }

  // the last sweep: ds = p (dp - delta) scale packed as dQ's A fragment,
  // then dQ += dS . K
  for (int job = kLse ? 0 : tiles; job < jobs; ++job) {
    products(job);
    uint32_t dsa[kKeys / 16][4];
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 4 * j + 2 * half;
        if constexpr (kLse) {  // p = 2^(s scale log2e - lse log2e), fp32
          const float p0 = exp2_approx(fmaf(sacc[i], sl2e, -ml[half]));
          const float p1 = exp2_approx(fmaf(sacc[i + 1], sl2e, -ml[half]));
          frag(dsa, j, half) = pack_bf16(p0 * (dpacc[i] - dl[half]) * scale,
                                         p1 * (dpacc[i + 1] - dl[half]) * scale);
        } else {
          const uint32_t p = probs(i, half);
          frag(dsa, j, half) = pack_bf16(bf16_lo(p) * (dpacc[i] - dl[half]) * scale,
                                         bf16_hi(p) * (dpacc[i + 1] - dl[half]) * scale);
        }
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

// The dk/dv kernel of either form: grid (ceil(n / kRowsBlock), heads,
// batch), kBwdThreads threads, BwdShape<D, kLse>::kDkvSmem bytes of dynamic
// shared memory. Block x owns keys 128x .. 128x + 127, consumer c 64 of
// them. stats and delta (from the dq kernel): round_up(n, 64) rows a head.
// Writes dk and dv (rows < n).
template <int D, bool kLse>
__device__ __forceinline__ void bwd_dkv(const CUtensorMap& tq, const CUtensorMap& tk,
                                        const CUtensorMap& tv, const CUtensorMap& tdo,
                                        const BwdStat<kLse>* __restrict__ stats,
                                        const float* __restrict__ delta,
                                        bf16* __restrict__ dk, bf16* __restrict__ dv, int n,
                                        int heads, float scale) {
  using S = Shape<D>;
  using B = BwdShape<D, kLse>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t k_smem = base;                                // [consumer] 64 rows
  const uint32_t v_smem = base + kConsumers * B::kRowsBytes;  // [consumer] 64 rows
  const Ring ring(base + B::kDkvBarriers);
  auto q_tile = [&](int s) { return base + B::kDkvRing + s * 2 * S::kTileBytes; };
  auto do_tile = [&](int s) { return q_tile(s) + S::kTileBytes; };
  auto st_tile = [&](int s) {  // statistics, then deltas
    return base + B::kDkvStats + s * (B::kStatBytes + B::kDeltaBytes);
  };

  const int bh = blockIdx.z * heads + blockIdx.y;
  const int k0 = blockIdx.x * kRowsBlock;
  const int consumers = min(kConsumers, (n - k0 + kRowsWG - 1) / kRowsWG);
  const int jobs = (n + kKeys - 1) / kKeys;  // query tiles
  const size_t srow = (size_t)bh * round_up(n, kKTile);
  auto load_job = [&](int job) {  // one thread: Q, dO, statistics and delta
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
    // each column is a query: its statistics and delta from the stage
    const uint8_t* stage = smem_raw + (st_tile(s) - smem_u32(smem_raw));
    const float2* dlt = reinterpret_cast<const float2*>(stage + B::kStatBytes);
    uint32_t pa[kKeys / 16][4], dsa[kKeys / 16][4];
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      const int col = 8 * j + 2 * t;  // and col + 1
      if constexpr (kLse) {
        // p = 2^(s scale log2e - lse log2e) in fp32; dv takes it rounded
        const float2 ls = reinterpret_cast<const float2*>(stage)[col / 2];  // both lse
        const float2 de = dlt[col / 2];                                     // both deltas
        const float l0 = ls.x * kLog2e, l1 = ls.y * kLog2e;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = 4 * j + 2 * half;
          const float p0 = exp2_approx(fmaf(sacc[i], sl2e, -l0));
          const float p1 = exp2_approx(fmaf(sacc[i + 1], sl2e, -l1));
          frag(pa, j, half) = pack_bf16(p0, p1);
          frag(dsa, j, half) = pack_bf16(p0 * (dpacc[i] - de.x) * scale,
                                         p1 * (dpacc[i + 1] - de.y) * scale);
        }
      } else {
        const float4 mi = reinterpret_cast<const float4*>(stage)[col / 2];  // both (m, 1/l)
        const float2 de = dlt[col / 2];                                     // both deltas
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
// the kernels: B3's (statistics (m, 1/l)) and B2's (lse), one body each

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
    attention_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 const __grid_constant__ CUtensorMap tdo,
                                 const float2* __restrict__ stats, bf16* __restrict__ dq,
                                 float* __restrict__ delta, int n, int heads, float scale) {
  bwd_dq<D, false>(tq, tk, tv, tdo, stats, nullptr, nullptr, dq, delta, n, heads, scale);
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
    attention_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                  const __grid_constant__ CUtensorMap tk,
                                  const __grid_constant__ CUtensorMap tv,
                                  const __grid_constant__ CUtensorMap tdo,
                                  const float2* __restrict__ stats,
                                  const float* __restrict__ delta, bf16* __restrict__ dk,
                                  bf16* __restrict__ dv, int n, int heads, float scale) {
  bwd_dkv<D, false>(tq, tk, tv, tdo, stats, delta, dk, dv, n, heads, scale);
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
    blockwise_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 const __grid_constant__ CUtensorMap tdo,
                                 const float* __restrict__ lse, const bf16* __restrict__ o,
                                 const float* __restrict__ dlse, bf16* __restrict__ dq,
                                 float* __restrict__ delta, int n, int heads, float scale) {
  bwd_dq<D, true>(tq, tk, tv, tdo, lse, o, dlse, dq, delta, n, heads, scale);
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
    blockwise_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                  const __grid_constant__ CUtensorMap tk,
                                  const __grid_constant__ CUtensorMap tv,
                                  const __grid_constant__ CUtensorMap tdo,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ delta, bf16* __restrict__ dk,
                                  bf16* __restrict__ dv, int n, int heads, float scale) {
  bwd_dkv<D, true>(tq, tk, tv, tdo, lse, delta, dk, dv, n, heads, scale);
}

// ---------------------------------------------------------------------------
// host: launch. Templates only, so that a library instantiates the form it
// calls: fused_attention.cu B3's (launch_bwd), flash_blockwise_bwd.cu B2's
// (launch_blockwise_dq, launch_blockwise_dkv).

// q, k, v and dout's maps: (D, n, batch * heads), boxes of 64 rows.
template <int D>
bool encode_bwd(CUtensorMap (&maps)[4], const void* q, const void* k, const void* v,
                const void* dout, int n, int bh) {
  const void* ptrs[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i)
    if (!encode_heads<D>(&maps[i], ptrs[i], n, bh, kKeys)) return false;
  return true;
}

// grid (ceil(n / kRowsBlock), heads, batch), kBwdThreads threads, smem bytes.
template <typename Kernel, typename... Args>
cudaError_t launch_kernel(Kernel kernel, size_t smem, int batch, int n, int heads,
                          cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kRowsBlock - 1) / kRowsBlock, heads, batch);
  kernel<<<grid, kBwdThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// B3: both kernels; returns the first non-zero cudaError_t (0 = both
// launched). stats: (m, 1/l); delta: zero-filled scratch.
template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                       const void* stats, void* dq, void* dk, void* dv, void* delta,
                       int batch, int n, int heads, float scale, cudaStream_t stream) {
  using B = BwdShape<D, false>;
  CUtensorMap m[4];
  if (!encode_bwd<D>(m, q, k, v, dout, n, batch * heads)) return cudaErrorInvalidValue;
  const float2* st = static_cast<const float2*>(stats);
  float* dl = static_cast<float*>(delta);
  cudaError_t err = launch_kernel(attention_bwd_dq_sm90_kernel<D>, B::kDqSmem, batch, n,
                                  heads, stream, m[0], m[1], m[2], m[3], st,
                                  static_cast<bf16*>(dq), dl, n, heads, scale);
  if (err != cudaSuccess) return err;
  return launch_kernel(attention_bwd_dkv_sm90_kernel<D>, B::kDkvSmem, batch, n, heads,
                       stream, m[0], m[1], m[2], m[3], st, static_cast<const float*>(dl),
                       static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, heads, scale);
}

// B2's dq kernel. lse: +inf past n; delta: written; both round_up(n, 64)
// rows a head. dlse: (batch, heads, n) or null.
template <int D>
cudaError_t launch_blockwise_dq(const void* q, const void* k, const void* v, const void* o,
                                const void* dout, const void* lse, const void* dlse,
                                void* dq, void* delta, int batch, int n, int heads,
                                float scale, cudaStream_t stream) {
  CUtensorMap m[4];
  if (!encode_bwd<D>(m, q, k, v, dout, n, batch * heads)) return cudaErrorInvalidValue;
  return launch_kernel(blockwise_bwd_dq_sm90_kernel<D>, BwdShape<D, true>::kDqSmem, batch,
                       n, heads, stream, m[0], m[1], m[2], m[3],
                       static_cast<const float*>(lse), static_cast<const bf16*>(o),
                       static_cast<const float*>(dlse), static_cast<bf16*>(dq),
                       static_cast<float*>(delta), n, heads, scale);
}

// B2's dk/dv kernel. lse and delta (from the dq kernel) as above.
template <int D>
cudaError_t launch_blockwise_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dk, void* dv, int batch, int n, int heads, float scale,
                                 cudaStream_t stream) {
  CUtensorMap m[4];
  if (!encode_bwd<D>(m, q, k, v, dout, n, batch * heads)) return cudaErrorInvalidValue;
  return launch_kernel(blockwise_bwd_dkv_sm90_kernel<D>, BwdShape<D, true>::kDkvSmem, batch,
                       n, heads, stream, m[0], m[1], m[2], m[3],
                       static_cast<const float*>(lse), static_cast<const float*>(delta),
                       static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, heads, scale);
}

// fn(std::integral_constant<int, D>{}) for the head dim, as an int; an
// invalid value for a head dim the bodies do not take.
template <typename Fn>
int for_head_dim(int head_dim, Fn&& fn) {
  switch (head_dim) {
    case 32:
      return (int)fn(std::integral_constant<int, 32>{});
    case 64:
      return (int)fn(std::integral_constant<int, 64>{});
    case 128:
      return (int)fn(std::integral_constant<int, 128>{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Sizes neither form takes (the grid's limits; scale <= 0: the scale is
// folded into the exponent after the mask's -inf).
inline bool bad_bwd_sizes(int batch, int n, int heads, float scale) {
  return n < 1 || batch < 1 || heads < 1 || batch > 65535 || heads > 65535 || !(scale > 0.f);
}

}  // namespace sm90
}  // namespace
