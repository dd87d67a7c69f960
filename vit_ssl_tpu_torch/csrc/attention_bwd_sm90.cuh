// The bfloat16 attention backward of kernels B1, B3 and B2, for Hopper
// (sm_90a) with wgmma and TMA: two kernels (dq, then dk/dv), templated on
// the softmax statistics the forward saved, on the layout (kHeadMajor, as
// the Hopper forward is) and on B1's block-diagonal mask. Included by
// attention_nhd_bwd.cu (B1: (B, N, H*D), (m, 1/l), the mask), by
// fused_attention.cu (B3: (B, H, N, D), (m, 1/l)) and by
// flash_blockwise_bwd.cu (B2: (B, H, N, D), the lse); each library
// instantiates its own form only. The tiles and Hopper pieces are
// sm90_common.cuh's; float32 stays on the CUDA-core bodies
// (attention_bwd.cuh for B1 and B3, flash_blockwise_bwd.cu for B2). Every
// head dim the bf16 forwards take (32, 64, 128) runs it.
//
// Replaces the TPU kernels vit_ssl_tpu/ops/flash_attention.py::
// _nhd_bwd_kernel, called from _attention_nhd_vjp_bwd (B1; C entry
// attention_nhd_bwd), ::_attn_bwd_kernel, called from
// _fused_attention_bwd_impl (B3; C entry fused_attention_bwd), and
// vit_ssl_tpu/ops/flash_blockwise.py::_dq_kernel and ::_dkv_kernel, called
// from _flash_bwd (B2; C entries blockwise_bwd_dq and blockwise_bwd_dkv).
// Per (b, h):
//
//   p     = softmax probabilities of s = q . k^T * scale, keys past n 0
//           (B1: and keys off the row's diagonal block, i/bs != j/bs)
//   dv    = p.bf16^T . do                     fp32 accumulation
//   dp    = do . v^T                          fp32
//   ds    = (p * (dp - delta) * scale) rounded to bf16
//   dq    = ds . k ; dk = ds^T . q            fp32 accumulation
//
// each result cast to bf16 on store. The two statistics forms:
//
// - B1 and B3 (kLse false): the forward saved each row's (m, 1/l); p is its
//   normalised probability rounded to bf16, rebuilt with the forward's own
//   instructions (the Hopper forward's: the scores by the same wgmma,
//   p = 2^(s scale log2e - m log2e) * (1/l) as one fma and ex2), so p is
//   the forward's bit for bit where the scores are Q.K^T. delta = sum_j
//   p * dp, summed exactly as the plain version sums it, not taken as
//   do . o (the identity JAX's kernels state): o is rounded to bf16, and
//   do . o misses sum_j p * dp by that rounding, which leaves dp - delta as
//   noise where it is exactly 0 (one key kept: N = 1, or B1's blocks of one
//   token: p = 1, dq = dk = 0). That costs the dq kernel a first sweep (two
//   products a key tile). B1's mask is applied again as -inf on the
//   scores, which the products compute unconditionally.
// - B2 (kLse true): the forward saved each row's lse; p = exp(s - lse) in
//   fp32, as 2^(s scale log2e - lse log2e) (one fma, one ex2.approx), NOT
//   rounded before ds (dv takes it rounded), as JAX's kernels form it.
//   delta = rowsum(do . o) - dlse (dlse: the lse output's cotangent, 0 when
//   not given), the contract of JAX's _flash_bwd: the dq kernel sums it in
//   fp32 for its rows before its one sweep (three products a key tile).
//
// What bounds it on an H100 SXM (data sheet: 3.35 TB/s, 989 TFLOP/s bf16):
// - B1 at DINO ViT-S/8's (256, 145, 6x64): q, k, v, do read and dq, dk, dv
//   written, 201 MB with the statistics, 0.060 ms; the function's 5
//   products, 20.7 GFLOP, 0.021 ms: bytes. At the packed locals (128, 148,
//   6x64, block 37): 103 MB, 0.031 ms. This design does 9 products at N
//   padded to 192 (fewer under the mask: the tiles off the diagonal blocks
//   are skipped), 65 GFLOP at the globals.
// - B3 at ViT-B/16's (64, 12, 577, 64): 401 MB, 0.120 ms; 5 products,
//   164 GFLOP, 0.165 ms: operations. This design does 9 (the scores and dp
//   twice in the dq kernel and once in the dk/dv kernel) at N padded to 640.
// - B2 at ViT-B/16's (64, 12, 1025, 64): 103.3 GFLOP a product; the dq
//   kernel reads q, k, v, o, do and lse and writes dq and delta (605 MB,
//   0.181 ms) and does 3 products (0.313 ms); the dk/dv kernel reads q, k,
//   v, do, lse and delta and writes dk and dv (605 MB) and does 4 (0.418
//   ms): operations. Both at N padded to 1088 keys and 1152 queries.
//
// Design, every form: no atomics (the result repeats bit for bit); thread 0
// issues every copy by TMA through 3-D tensor maps (sm90_common.cuh::
// encode_rows: over (D, N, B*H) for B3 and B2, over (H*D, N, B) for B1 with
// head h's boxes at column h*D; a box that runs past row n of a head or
// image is zero-filled, never read from the next one, and never reaches a
// neighbouring head's columns). There is no producer warp: ptxas sizes a
// block's registers by whole warpgroups, so a ninth warp costs a
// warpgroup's registers (288 threads get at most 168 a thread; D = 128's
// dk/dv consumer takes 237). Two ways to bring the tiles in:
//
// - streamed (B3, B2, and B1 above kResidentMaxSeq): blocks of two consumer
//   warpgroups of 64 rows each, one block an SM; the tiles stream through
//   sm90_common.cuh's Ring of kStages stages.
// - resident (B1 at n <= kResidentMaxSeq = 256: DINO's N = 145 and 148):
//   blocks of one consumer warpgroup of 64 rows, several an SM (three at
//   D <= 64); every tile the block needs is loaded once into a slot of its
//   own, each on its own mbarrier, so the products of the first tile start
//   while the others land and nothing is released. At N = 145 a 128-row
//   block would leave its second consumer 17 live rows of 64 in half the
//   blocks; 64-row blocks waste no warpgroup, and three blocks an SM overlap
//   one another's loads, exponentials and products. Under the mask a block
//   visits only the tiles that hold a key (a query) its 64 rows keep: at
//   (148, block 37) 7 of the 9 (row, key) tile pairs.
//   ops/flash_attention.py::attention_nhd_bwd_form names the rule.
//
// - dq kernel, launched first: one block per (b, h, 128 or 64 query rows).
//   Each consumer loads its 64 rows of Q and dO once; K and V tiles of 64
//   keys come in (B1 and B3: twice streamed, once resident; B2: once). Per
//   tile S = Q.K^T and dP = dO.V^T (wgmma, both operands K-major in shared
//   memory), p rebuilt, keys >= n (and B1's keys off the diagonal blocks)
//   forced to p = 0 (a zero-filled key gives s = 0, not -inf). B1's and
//   B3's sweep 1 sums delta; the last sweep packs ds to bf16 in registers
//   as the A fragment of dQ += dS.K (K as the MN-major B operand, the way
//   the forward takes V). B2 sums delta before its sweep: each lane dO . O
//   over a quarter of the head dim of its two rows, O from device memory
//   (loaded while the rows land), dO from its swizzled TMA tile, then over
//   the quad. It writes delta for the second kernel.
// - dk/dv kernel: one block per (b, h, 128 or 64 keys); each consumer
//   loads its 64 rows of K and V once. Q and dO tiles of 64 queries, with
//   their statistics and delta (bulk copies), come in; per tile
//   S^T = K.Q^T and dP^T = V.dO^T, so that p^T and ds^T land in the
//   accumulator layout that is wgmma's register A fragment: dV += p^T.dO
//   and dK += ds^T.Q (dO and Q as MN-major B operands). 4 products a tile.
//
// Every product is issued unconditionally (a wgmma under a branch makes
// ptxas serialise every wgmma of the kernel, C7520), and each group is
// waited for before its accumulators are read; the mask skips whole tiles
// only in the loop's bounds. Streamed, at N = 1025 the ninth 128-row block
// of a head holds one live row (dq) or key (dk/dv): its second consumer
// returns before the loop, and the ring's empty barriers count the live
// consumers only.
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
// B1's and B3's statistics hold (0, 0) and their delta 0 (the caller
// zero-fills both), B2's lse +inf (the caller pads it) and its delta 0 (the
// dq kernel writes every row of a live consumer); queries >= n get
// s = -inf, so p = 0 there, and dP = 0 (dO zero-filled), with no NaN.
//
// kernels.py rebuilds a library when this header is newer than it.

#pragma once

#include <type_traits>

#include "attention_nhd_common.cuh"  // bf16, pack_bf16, exp2_approx, quad_sum, spans
#include "sm90_common.cuh"           // tiles, ring, TMA, wgmma, descriptors, tensor maps

namespace {
namespace sm90 {

constexpr int kBwdThreads = 128 * kConsumers;  // streamed: no producer warp
// The resident form: up to four 64-row tiles, one consumer warpgroup a
// block; the longest sequence B1's backward takes in it
// (ops/flash_attention.py::RESIDENT_MAX_SEQ).
constexpr int kResidentTiles = 4;
constexpr int kResidentMaxSeq = kResidentTiles * kKeys;

// A query row's softmax statistics: B1's and B3's (m, 1/l), B2's lse.
template <bool kLse>
using BwdStat = std::conditional_t<kLse, float, float2>;

template <int D, bool kLse>
struct BwdShape {
  using S = Shape<D>;
  static constexpr int kRowsBytes = kRowsWG * D * 2;  // 64 rows of one head
  // streamed dq kernel: [Q, dO][consumer] rows, then [stage][K, V] tiles
  static constexpr int kDqRing = 2 * kConsumers * kRowsBytes;
  static constexpr int kDqBarriers = kDqRing + kStages * 2 * S::kTileBytes;
  static constexpr size_t kDqSmem = 1024 + kDqBarriers + 8 * (2 * kStages + 1);
  // streamed dk/dv kernel: [K, V][consumer] rows, then [stage][Q, dO]
  // tiles, then [stage] 64 statistics and 64 deltas
  static constexpr int kStatBytes = kKeys * (int)sizeof(BwdStat<kLse>);
  static constexpr int kDeltaBytes = kKeys * 4;
  static constexpr int kDkvRing = 2 * kConsumers * kRowsBytes;
  static constexpr int kDkvStats = kDkvRing + kStages * 2 * S::kTileBytes;
  static constexpr int kDkvBarriers = kDkvStats + kStages * (kStatBytes + kDeltaBytes);
  static constexpr size_t kDkvSmem = 1024 + kDkvBarriers + 8 * (2 * kStages + 1);
  // resident, `slots` tiles: one consumer's two rows (Q, dO or K, V), then
  // [slot][K, V] or [slot][Q, dO] tiles, then (dk/dv) [slot] statistics and
  // deltas, then the rows' mbarrier and one a slot
  static constexpr int kResRows = 2 * kRowsBytes;
  __host__ __device__ static constexpr int res_stats(int slots) {
    return kResRows + slots * 2 * S::kTileBytes;
  }
  __host__ __device__ static constexpr int res_barriers(int slots, bool dkv) {
    return res_stats(slots) + (dkv ? slots * (kStatBytes + kDeltaBytes) : 0);
  }
  static constexpr size_t res_smem(int slots, bool dkv) {
    return 1024 + res_barriers(slots, dkv) + 8 * (1 + slots);
  }
  // resident blocks an SM: registers decide at D <= 64 (at most 168 a
  // thread at three; 67 KB of shared memory at D = 64 and three tiles),
  // shared memory at D = 128 (129 KB at three tiles)
  static constexpr int kResMinBlocks = D <= 64 ? 3 : 1;
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

// The tiles a resident block visits, [lo, hi) of 64 rows each: those that
// hold a key (dq) or a query (dk/dv) that one of its 64 rows row0 ..
// row0 + 63 keeps (the mask is symmetric); all T when block_size is 0.
struct TileRange {
  int lo, hi;
};

__device__ __forceinline__ TileRange visited_tiles(int row0, int n, int block_size) {
  const Span s = rows_key_span(row0, kRowsWG, n, block_size);
  return {s.lo / kKeys, (s.hi + kKeys - 1) / kKeys};
}

// Thread 0 of a resident block: its mbarriers at `bars`, the rows' and
// then one for each of `slots` slots.
__device__ __forceinline__ void init_resident(uint32_t bars, int slots) {
  for (int s = 0; s <= slots; ++s) mbar_init(bars + 8 * s, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The dq kernel of every form. Streamed: grid (ceil(n / kRowsBlock),
// heads, batch), kBwdThreads threads, BwdShape<D, kLse>::kDqSmem bytes of
// dynamic shared memory. Resident (B1, n <= kResidentMaxSeq): grid
// (ceil(n / 64), heads, batch), 128 threads, BwdShape<D, false>::
// res_smem(ceil(n / 64), false) bytes. stats: round_up(n, 64) rows a head.
// B1 and B3: (m, 1/l), o and dlse unused; writes delta for rows < n. B2:
// the lse (+inf past n), o (B, H, n, D), dlse (B, H, n) or null; writes
// delta for every row of a live consumer (0 past n). Writes dq (rows < n).
// block_size: B1's mask (kMasked), else unused.
//
// The block walks the key tiles, T = ceil(n / 64), each a K and a V tile:
// B1 and B3 in 2T jobs (sweep 1, jobs 0 .. T-1, sums delta; sweep 2, jobs
// T .. 2T-1, accumulates dq; resident: only the jobs of visited tiles), B2
// in T (delta first, from dO and O).
template <int D, bool kLse, bool kHeadMajor = true, bool kMasked = false,
          bool kResident = false>
__device__ __forceinline__ void bwd_dq(const CUtensorMap& tq, const CUtensorMap& tk,
                                       const CUtensorMap& tv, const CUtensorMap& tdo,
                                       const BwdStat<kLse>* __restrict__ stats,
                                       const bf16* __restrict__ o,
                                       const float* __restrict__ dlse, bf16* __restrict__ dq,
                                       float* __restrict__ delta, int n, int heads,
                                       float scale, int block_size = 0) {
  static_assert(kHeadMajor || !kLse, "B2's lse form is head-major");
  static_assert(!(kLse && (kMasked || kResident)), "the mask and the resident form are B1's");
  using S = Shape<D>;
  using B = BwdShape<D, kLse>;
  constexpr int kCons = kResident ? 1 : kConsumers;  // consumer warpgroups a block
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_smem = base;                           // [consumer] 64 rows
  const uint32_t do_smem = base + kCons * B::kRowsBytes;  // [consumer] 64 rows
  const int tiles = (n + kKeys - 1) / kKeys;
  // streamed: the ring's barriers; resident: the rows' mbarrier, then one a slot
  const uint32_t bars = base + (kResident ? B::res_barriers(tiles, false) : B::kDqBarriers);
  const Ring ring(bars);
  const uint32_t rows_bar = kResident ? bars : ring.rows();
  auto k_tile = [&](int s) { return base + 2 * kCons * B::kRowsBytes + s * 2 * S::kTileBytes; };
  auto v_tile = [&](int s) { return k_tile(s) + S::kTileBytes; };

  const int h = blockIdx.y, b = blockIdx.z;
  const int bh = b * heads + h;
  const MapAt at = map_at<kHeadMajor, D>(b, h, heads);
  const int bs = kMasked ? block_size : 0;
  const int q0 = blockIdx.x * kCons * kRowsWG;
  const int consumers = kResident ? 1 : min(kConsumers, (n - q0 + kRowsWG - 1) / kRowsWG);
  const int jobs = kLse ? tiles : 2 * tiles;
  const TileRange visit = kResident ? visited_tiles(q0, n, bs) : TileRange{0, tiles};
  // job's K and V tiles: its stage of the ring, or its slot
  auto slot = [&](int job) { return kResident ? job % tiles - visit.lo : job % kStages; };
  // one thread: key tile j's K and V into `s` on `bar`
  auto load_tiles = [&](int j, int s, uint32_t bar) {
    mbar_expect_tx(bar, 2 * S::kTileBytes);
    tma_rows<D>(k_tile(s), &tk, bar, j * kKeys, at.plane, at.col);
    tma_rows<D>(v_tile(s), &tv, bar, j * kKeys, at.plane, at.col);
  };
  auto load_job = [&](int job) {
    load_tiles(job % tiles, job % kStages, ring.full(job % kStages));
  };
  if (threadIdx.x == 0) {
    if constexpr (kResident)
      init_resident(bars, visit.hi - visit.lo);
    else
      ring.init(consumers);
    mbar_expect_tx(rows_bar, 2 * consumers * B::kRowsBytes);
    for (int c = 0; c < consumers; ++c) {
      tma_rows<D>(q_smem + c * B::kRowsBytes, &tq, rows_bar, q0 + c * kRowsWG, at.plane,
                  at.col);
      tma_rows<D>(do_smem + c * B::kRowsBytes, &tdo, rows_bar, q0 + c * kRowsWG, at.plane,
                  at.col);
    }
    if constexpr (kResident) {
      for (int j = visit.lo; j < visit.hi; ++j)
        load_tiles(j, j - visit.lo, bars + 8 * (1 + j - visit.lo));
    } else {
      for (int job = 0; job < min(kStages, jobs); ++job) load_job(job);
    }
  }
  __syncthreads();

  const int c = threadIdx.x / 128;  // this consumer
  if (c >= consumers) return;       // all its rows lie past n
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int g = lane >> 2, t = lane & 3;
  const int row_lo = q0 + c * kRowsWG + 16 * warp + g;  // and row_lo + 8
  const size_t srow = (size_t)bh * round_up(n, kKTile);
  // rows row_lo, row_lo + 8: B1 and B3 the forward's (m log2 e, 1/l), (0, 0)
  // past n (the statistics hold round_up(n, 64) rows, the block 128); B2
  // the lse times log2 e (+inf past n: p = 0)
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
  // B1's mask: the keys rows row_lo and row_lo + 8 keep
  const Span lo = row_keys(row_lo, n, bs), hi = row_keys(row_lo + 8, n, bs);
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
  mbar_wait(rows_bar, 0);

  float sacc[kKeys / 2], dpacc[kKeys / 2], dqacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqacc[i] = 0.f;
  // S = Q . K^T and dP = dO . V^T of job's tiles; keys >= n (and B1's keys
  // off the rows' diagonal blocks) get s = -inf
  auto products = [&](int job) {
    const int s = slot(job);
    if constexpr (kResident)
      mbar_wait(bars + 8 * (1 + s), 0);
    else
      ring.wait_full(job);
    wgmma_fence();
    scores<D>(sacc, q_addr, k_tile(s));
    scores<D>(dpacc, do_addr, v_tile(s));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(sacc);
    reg_fence(dpacc);
    if constexpr (kMasked)
      mask_keys(sacc, (job % tiles) * kKeys, t, lo, hi, n, bs);
    else
      mask_columns(sacc, (job % tiles) * kKeys, n, t);
  };
  // streamed: this warp is done with job's stage (thread 0 refills it)
  auto release = [&](int job) {
    if constexpr (!kResident) ring.release(job, jobs, load_job);
  };
  // B1 and B3: p as the forward rounded it, 2^(s scale log2e - m log2e) * (1/l)
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
    for (int job = visit.lo; job < visit.hi; ++job) {
      products(job);
      release(job);
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
  const int sweep = kLse ? 0 : tiles;  // its first job
  for (int job = sweep + visit.lo; job < sweep + visit.hi; ++job) {
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
    product_rs<D>(dqacc, dsa, k_tile(slot(job)));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(dqacc);
    release(job);
  }
  const HeadRows out = head_rows<kHeadMajor, D>(b, h, n, heads);
  store_acc<D>(dq + out.base, dqacc, row_lo, n, t, out.stride);
}

// The dk/dv kernel of every form: grid and threads as bwd_dq's, BwdShape<D,
// kLse>::kDkvSmem (streamed) or res_smem(ceil(n / 64), true) (resident)
// bytes of dynamic shared memory. Block x owns keys 128x .. 128x + 127
// (resident: 64x .. 64x + 63), consumer c 64 of them. stats and delta (from
// the dq kernel): round_up(n, 64) rows a head. Writes dk and dv (rows < n).
// The block walks the query tiles (resident: the visited ones), each a Q
// and a dO tile with their statistics and deltas.
template <int D, bool kLse, bool kHeadMajor = true, bool kMasked = false,
          bool kResident = false>
__device__ __forceinline__ void bwd_dkv(const CUtensorMap& tq, const CUtensorMap& tk,
                                        const CUtensorMap& tv, const CUtensorMap& tdo,
                                        const BwdStat<kLse>* __restrict__ stats,
                                        const float* __restrict__ delta,
                                        bf16* __restrict__ dk, bf16* __restrict__ dv, int n,
                                        int heads, float scale, int block_size = 0) {
  static_assert(kHeadMajor || !kLse, "B2's lse form is head-major");
  static_assert(!(kLse && (kMasked || kResident)), "the mask and the resident form are B1's");
  using S = Shape<D>;
  using B = BwdShape<D, kLse>;
  constexpr int kCons = kResident ? 1 : kConsumers;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t k_smem = base;                          // [consumer] 64 rows
  const uint32_t v_smem = base + kCons * B::kRowsBytes;  // [consumer] 64 rows
  const int jobs = (n + kKeys - 1) / kKeys;              // query tiles
  const uint32_t bars = base + (kResident ? B::res_barriers(jobs, true) : B::kDkvBarriers);
  const Ring ring(bars);
  const uint32_t rows_bar = kResident ? bars : ring.rows();
  auto q_tile = [&](int s) { return base + 2 * kCons * B::kRowsBytes + s * 2 * S::kTileBytes; };
  auto do_tile = [&](int s) { return q_tile(s) + S::kTileBytes; };
  auto st_tile = [&](int s) {  // statistics, then deltas
    return base + (kResident ? B::res_stats(jobs) : B::kDkvStats) +
           s * (B::kStatBytes + B::kDeltaBytes);
  };

  const int h = blockIdx.y, b = blockIdx.z;
  const int bh = b * heads + h;
  const MapAt at = map_at<kHeadMajor, D>(b, h, heads);
  const int bs = kMasked ? block_size : 0;
  const int k0 = blockIdx.x * kCons * kRowsWG;
  const int consumers = kResident ? 1 : min(kConsumers, (n - k0 + kRowsWG - 1) / kRowsWG);
  const size_t srow = (size_t)bh * round_up(n, kKTile);
  const TileRange visit = kResident ? visited_tiles(k0, n, bs) : TileRange{0, jobs};
  auto slot = [&](int job) { return kResident ? job - visit.lo : job % kStages; };
  // one thread: job's Q, dO, statistics and delta into `s` on `bar`
  auto load_tiles = [&](int job, int s, uint32_t bar) {
    const int q0 = job * kKeys;  // 64 rows inside round_up(n, 64)
    mbar_expect_tx(bar, 2 * S::kTileBytes + B::kStatBytes + B::kDeltaBytes);
    tma_rows<D>(q_tile(s), &tq, bar, q0, at.plane, at.col);
    tma_rows<D>(do_tile(s), &tdo, bar, q0, at.plane, at.col);
    bulk_load(st_tile(s), stats + srow + q0, B::kStatBytes, bar);
    bulk_load(st_tile(s) + B::kStatBytes, delta + srow + q0, B::kDeltaBytes, bar);
  };
  auto load_job = [&](int job) { load_tiles(job, job % kStages, ring.full(job % kStages)); };
  if (threadIdx.x == 0) {
    if constexpr (kResident)
      init_resident(bars, visit.hi - visit.lo);
    else
      ring.init(consumers);
    mbar_expect_tx(rows_bar, 2 * consumers * B::kRowsBytes);
    for (int c = 0; c < consumers; ++c) {
      tma_rows<D>(k_smem + c * B::kRowsBytes, &tk, rows_bar, k0 + c * kRowsWG, at.plane,
                  at.col);
      tma_rows<D>(v_smem + c * B::kRowsBytes, &tv, rows_bar, k0 + c * kRowsWG, at.plane,
                  at.col);
    }
    if constexpr (kResident) {
      for (int j = visit.lo; j < visit.hi; ++j)
        load_tiles(j, j - visit.lo, bars + 8 * (1 + j - visit.lo));
    } else {
      for (int job = 0; job < min(kStages, jobs); ++job) load_job(job);
    }
  }
  __syncthreads();

  const int c = threadIdx.x / 128;
  if (c >= consumers) return;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int g = lane >> 2, t = lane & 3;
  const int key_lo = k0 + c * kRowsWG + 16 * warp + g;  // and key_lo + 8
  // B1's mask: the queries that keep keys key_lo and key_lo + 8
  const Span lo = row_keys(key_lo, n, bs), hi = row_keys(key_lo + 8, n, bs);
  const uint32_t k_addr = k_smem + c * B::kRowsBytes;
  const uint32_t v_addr = v_smem + c * B::kRowsBytes;
  const float sl2e = scale * kLog2e;
  mbar_wait(rows_bar, 0);

  float sacc[kKeys / 2], dpacc[kKeys / 2], dkacc[D / 2], dvacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dkacc[i] = dvacc[i] = 0.f;
  for (int job = visit.lo; job < visit.hi; ++job) {
    const int s = slot(job);
    if constexpr (kResident)
      mbar_wait(bars + 8 * (1 + s), 0);
    else
      ring.wait_full(job);
    wgmma_fence();
    scores<D>(sacc, k_addr, q_tile(s));    // S^T = K . Q^T
    scores<D>(dpacc, v_addr, do_tile(s));  // dP^T = V . dO^T
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(sacc);
    reg_fence(dpacc);
    if constexpr (kMasked)  // queries >= n or off the keys' blocks: p = 0
      mask_keys(sacc, job * kKeys, t, lo, hi, n, bs);
    else  // queries >= n: p = 0
      mask_columns(sacc, job * kKeys, n, t);
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
    if constexpr (!kResident) ring.release(job, jobs, load_job);
  }
  const HeadRows out = head_rows<kHeadMajor, D>(b, h, n, heads);
  store_acc<D>(dk + out.base, dkacc, key_lo, n, t, out.stride);
  store_acc<D>(dv + out.base, dvacc, key_lo, n, t, out.stride);
}

// ---------------------------------------------------------------------------
// the kernels: B3's (statistics (m, 1/l)), B2's (lse) and B1's ((m, 1/l) on
// (B, N, H*D), each streamed and resident, with and without the mask), one
// body each

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

template <int D, bool kMasked>
__global__ void __launch_bounds__(kBwdThreads, 1)
    attention_nhd_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                     const __grid_constant__ CUtensorMap tk,
                                     const __grid_constant__ CUtensorMap tv,
                                     const __grid_constant__ CUtensorMap tdo,
                                     const float2* __restrict__ stats, bf16* __restrict__ dq,
                                     float* __restrict__ delta, int n, int heads, float scale,
                                     int block_size) {
  bwd_dq<D, false, false, kMasked>(tq, tk, tv, tdo, stats, nullptr, nullptr, dq, delta, n,
                                   heads, scale, block_size);
}

template <int D, bool kMasked>
__global__ void __launch_bounds__(kBwdThreads, 1)
    attention_nhd_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                      const __grid_constant__ CUtensorMap tk,
                                      const __grid_constant__ CUtensorMap tv,
                                      const __grid_constant__ CUtensorMap tdo,
                                      const float2* __restrict__ stats,
                                      const float* __restrict__ delta, bf16* __restrict__ dk,
                                      bf16* __restrict__ dv, int n, int heads, float scale,
                                      int block_size) {
  bwd_dkv<D, false, false, kMasked>(tq, tk, tv, tdo, stats, delta, dk, dv, n, heads, scale,
                                    block_size);
}

template <int D, bool kMasked>
__global__ void __launch_bounds__(128, BwdShape<D, false>::kResMinBlocks)
    attention_nhd_bwd_dq_resident_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                              const __grid_constant__ CUtensorMap tk,
                                              const __grid_constant__ CUtensorMap tv,
                                              const __grid_constant__ CUtensorMap tdo,
                                              const float2* __restrict__ stats,
                                              bf16* __restrict__ dq, float* __restrict__ delta,
                                              int n, int heads, float scale, int block_size) {
  bwd_dq<D, false, false, kMasked, true>(tq, tk, tv, tdo, stats, nullptr, nullptr, dq, delta,
                                         n, heads, scale, block_size);
}

template <int D, bool kMasked>
__global__ void __launch_bounds__(128, BwdShape<D, false>::kResMinBlocks)
    attention_nhd_bwd_dkv_resident_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                               const __grid_constant__ CUtensorMap tk,
                                               const __grid_constant__ CUtensorMap tv,
                                               const __grid_constant__ CUtensorMap tdo,
                                               const float2* __restrict__ stats,
                                               const float* __restrict__ delta,
                                               bf16* __restrict__ dk, bf16* __restrict__ dv,
                                               int n, int heads, float scale, int block_size) {
  bwd_dkv<D, false, false, kMasked, true>(tq, tk, tv, tdo, stats, delta, dk, dv, n, heads,
                                          scale, block_size);
}

// ---------------------------------------------------------------------------
// host: launch. Templates only, so that a library instantiates the form it
// calls: attention_nhd_bwd.cu B1's (launch_nhd_bwd), fused_attention.cu
// B3's (launch_bwd), flash_blockwise_bwd.cu B2's (launch_blockwise_dq,
// launch_blockwise_dkv).

// q, k, v and dout's maps, boxes of 64 rows: (D, n, batch * heads) for the
// head-major layout, (heads * D, n, batch) for B1's.
template <int D, bool kHeadMajor = true>
bool encode_bwd(CUtensorMap (&maps)[4], const void* q, const void* k, const void* v,
                const void* dout, int n, int batch, int heads) {
  const void* ptrs[4] = {q, k, v, dout};
  const int width = kHeadMajor ? D : heads * D, planes = kHeadMajor ? batch * heads : batch;
  for (int i = 0; i < 4; ++i)
    if (!encode_rows<D>(&maps[i], ptrs[i], width, n, planes, kKeys)) return false;
  return true;
}

// grid (ceil(n / rows), heads, batch), 2 * rows threads (a consumer
// warpgroup per 64 rows), smem bytes.
template <typename Kernel, typename... Args>
cudaError_t launch_kernel(Kernel kernel, size_t smem, int rows, int batch, int n, int heads,
                          cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + rows - 1) / rows, heads, batch);
  kernel<<<grid, 2 * rows, smem, stream>>>(args...);
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
  if (!encode_bwd<D>(m, q, k, v, dout, n, batch, heads)) return cudaErrorInvalidValue;
  const float2* st = static_cast<const float2*>(stats);
  float* dl = static_cast<float*>(delta);
  cudaError_t err = launch_kernel(attention_bwd_dq_sm90_kernel<D>, B::kDqSmem, kRowsBlock,
                                  batch, n, heads, stream, m[0], m[1], m[2], m[3], st,
                                  static_cast<bf16*>(dq), dl, n, heads, scale);
  if (err != cudaSuccess) return err;
  return launch_kernel(attention_bwd_dkv_sm90_kernel<D>, B::kDkvSmem, kRowsBlock, batch, n,
                       heads, stream, m[0], m[1], m[2], m[3], st,
                       static_cast<const float*>(dl), static_cast<bf16*>(dk),
                       static_cast<bf16*>(dv), n, heads, scale);
}

// B1's two kernels in the form that n picks (resident at n <=
// kResidentMaxSeq, else streamed), masked or not.
template <int D, bool kMasked>
cudaError_t launch_nhd_form(const CUtensorMap (&m)[4], const float2* st, bf16* dq, bf16* dk,
                            bf16* dv, float* dl, int batch, int n, int heads, float scale,
                            int block_size, cudaStream_t stream) {
  using B = BwdShape<D, false>;
  const bool resident = n <= kResidentMaxSeq;
  const int tiles = (n + kKeys - 1) / kKeys, rows = resident ? kRowsWG : kRowsBlock;
  cudaError_t err =
      resident ? launch_kernel(attention_nhd_bwd_dq_resident_sm90_kernel<D, kMasked>,
                               B::res_smem(tiles, false), rows, batch, n, heads, stream, m[0],
                               m[1], m[2], m[3], st, dq, dl, n, heads, scale, block_size)
               : launch_kernel(attention_nhd_bwd_dq_sm90_kernel<D, kMasked>, B::kDqSmem, rows,
                               batch, n, heads, stream, m[0], m[1], m[2], m[3], st, dq, dl, n,
                               heads, scale, block_size);
  if (err != cudaSuccess) return err;
  const float* dlc = dl;
  return resident
             ? launch_kernel(attention_nhd_bwd_dkv_resident_sm90_kernel<D, kMasked>,
                             B::res_smem(tiles, true), rows, batch, n, heads, stream, m[0],
                             m[1], m[2], m[3], st, dlc, dk, dv, n, heads, scale, block_size)
             : launch_kernel(attention_nhd_bwd_dkv_sm90_kernel<D, kMasked>, B::kDkvSmem, rows,
                             batch, n, heads, stream, m[0], m[1], m[2], m[3], st, dlc, dk, dv,
                             n, heads, scale, block_size);
}

// B1: both kernels on (B, N, H*D); returns the first non-zero cudaError_t
// (0 = both launched). stats: (m, 1/l); delta: zero-filled scratch;
// block_size > 0 masks block-diagonally.
template <int D>
cudaError_t launch_nhd_bwd(const void* q, const void* k, const void* v, const void* dout,
                           const void* stats, void* dq, void* dk, void* dv, void* delta,
                           int batch, int n, int heads, float scale, int block_size,
                           cudaStream_t stream) {
  CUtensorMap m[4];
  if (!encode_bwd<D, false>(m, q, k, v, dout, n, batch, heads)) return cudaErrorInvalidValue;
  const float2* st = static_cast<const float2*>(stats);
  bf16 *gq = static_cast<bf16*>(dq), *gk = static_cast<bf16*>(dk), *gv = static_cast<bf16*>(dv);
  float* dl = static_cast<float*>(delta);
  if (block_size)
    return launch_nhd_form<D, true>(m, st, gq, gk, gv, dl, batch, n, heads, scale, block_size,
                                    stream);
  return launch_nhd_form<D, false>(m, st, gq, gk, gv, dl, batch, n, heads, scale, 0, stream);
}

// B2's dq kernel. lse: +inf past n; delta: written; both round_up(n, 64)
// rows a head. dlse: (batch, heads, n) or null.
template <int D>
cudaError_t launch_blockwise_dq(const void* q, const void* k, const void* v, const void* o,
                                const void* dout, const void* lse, const void* dlse,
                                void* dq, void* delta, int batch, int n, int heads,
                                float scale, cudaStream_t stream) {
  CUtensorMap m[4];
  if (!encode_bwd<D>(m, q, k, v, dout, n, batch, heads)) return cudaErrorInvalidValue;
  return launch_kernel(blockwise_bwd_dq_sm90_kernel<D>, BwdShape<D, true>::kDqSmem,
                       kRowsBlock, batch, n, heads, stream, m[0], m[1], m[2], m[3],
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
  if (!encode_bwd<D>(m, q, k, v, dout, n, batch, heads)) return cudaErrorInvalidValue;
  return launch_kernel(blockwise_bwd_dkv_sm90_kernel<D>, BwdShape<D, true>::kDkvSmem,
                       kRowsBlock, batch, n, heads, stream, m[0], m[1], m[2], m[3],
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

// Sizes no form takes (the grid's limits; scale <= 0: the scale is folded
// into the exponent after the mask's -inf).
inline bool bad_bwd_sizes(int batch, int n, int heads, float scale) {
  return n < 1 || batch < 1 || heads < 1 || batch > 65535 || heads > 65535 || !(scale > 0.f);
}

}  // namespace sm90
}  // namespace
