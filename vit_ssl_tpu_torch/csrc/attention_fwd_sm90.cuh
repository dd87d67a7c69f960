// The bfloat16 attention forward of kernels B1 and B3, inference and
// training, for Hopper (sm_90a) with wgmma and TMA. Templated on the layout
// (kHeadMajor, as attention_fwd.cuh's bodies are): attention_nhd_fwd.cu
// instantiates it for B1's (B, N, H*D) layout, fused_attention.cu for B3's
// (B, H, N, D) layout. float32 stays on the CUDA-core body of
// attention_fwd.cuh. Its tiles and Hopper pieces (mbarriers and the ring,
// TMA, wgmma, descriptors, the row-guarded store, tensor maps) are
// sm90_common.cuh's.
//
// Replaces the TPU kernels vit_ssl_tpu/ops/flash_attention.py::
// _nhd_fwd_kernel (B1, both pallas_calls of _attention_nhd_fwd_impl) and
// _attn_kernel (B3, both pallas_calls of _fused_attention_fwd_impl): the
// inference calls are the C entries attention_nhd_fwd and
// fused_attention_fwd; the training calls, which save the probabilities,
// are attention_nhd_fwd_stats and fused_attention_fwd_stats, which save
// each row's (m, 1/l) instead. Per (b, h):
//
//   s  = (q . k^T) * scale                fp32 (wgmma accumulators)
//   s  = -inf where i/bs != j/bs          only when block_size > 0 (B1)
//   s  = -inf for keys at or past n
//   p  = exp(s - rowmax(s)) ; l = rowsum(p)   fp32
//   pn = (p / l) rounded to bf16          normalise, THEN round
//   o  = pn . v                           fp32 accumulation, bf16 on store
//
// pn is rounded after normalising, as the plain versions
// (ops/flash_attention.py) and the JAX kernels round it, and as the Hopper
// backward of B1 and B3 rebuilds it from (m, 1/l): p = 2^(s log2e -
// m log2e) * (1/l). So the row max and sum must be known before any pn is
// formed. Two forms:
//
// - one pass (B1 at n <= kOnePassMaxSeq = 256, up to four 64-key tiles:
//   DINO's N = 145 and 148 take three): a consumer warpgroup's whole
//   64 x 64T fp32 score block fits its registers (32T a thread). All score
//   products, then the exact row max and sum, then pn, then P.V: one
//   exponential and two products a score.
// - two passes (B1 above 256 keys; B3 at every N): pass 1 keeps the
//   running row max and the rescaled sum; pass 2 computes the scores
//   again, pn and P.V. Two exponentials and three products a score.
// ops/flash_attention.py::attention_nhd_form names the rule on the host.
// The boundary, from the card (NVIDIA H100 80GB HBM3, 700 W, D = 64): the
// one-pass kernel holds three blocks an SM up to four tiles (130 registers
// at T = 3, 154 at T = 4, no spills) and takes 0.60x the two-pass time at
// (128, 145), 0.63x at (128, 197), 0.70x at (128, 256); five tiles would
// need 160 score registers a thread, past the 168 that three blocks allow.
//
// What bounds it on an H100 SXM (data sheet: 3.35 TB/s, 989 TFLOP/s bf16;
// q, k, v read once and o written once; two products over the kept keys):
//   B1 (128, 145, 6x64) served batch    57.0 MB, 0.0170 ms; 4.1 GFLOP,
//                                       0.0042 ms: bytes
//   B1 (256, 145, 6x64) teacher         114.0 MB, 0.0340 ms; 8.3 GFLOP,
//                                       0.0084 ms: bytes
//   B1 (256, 145, 6x64) training        + 1.8 MB of statistics, 0.0346 ms
//   B1 (128, 148, 6x64, bs 37) locals   58.2 + 0.9 MB, 0.0176 ms; 1.1
//                                       GFLOP (the diagonal blocks): bytes
//   B3 (64, 12, 577, 64) ViT-B/16 384   227 MB, 0.068 ms; 65.5 GFLOP,
//                                       0.066 ms: bytes
// Beside them the exponentials: at (128, 145) the one-pass form computes
// 192 x 192 a (b, h), 28 M, about 8 us on the special-function units (16
// ex2 a clock an SM); the 64-row granularity of wgmma pads 145 rows and
// keys to 192 (76 % live) and 577 to 640. At DINO's shapes the kernel now
// takes about as long on the card as its wrapper's checks and allocations
// take on the host. The design's answer: the (N, N)
// scores never leave the registers, each block reads its Q rows once and
// writes its O rows once, K and V of one (b, h) are read from device
// memory once and from L2 by the head's other blocks, and at DINO's N
// the one-pass form drops pass 1's product and exponential.
//
// Design, both forms:
// - TMA copies through 3-D tensor maps (sm90_common.cuh::encode_rows;
//   encoded on the host per call, passed as __grid_constant__
//   parameters): over (D, N, B*H) for B3, over (H*D, N, B) for B1 with
//   head h's boxes at column h*D. A box that runs past row n of one head
//   (B3) or image (B1) is zero-filled by the hardware, never read from the
//   next one; a box never reaches a neighbouring head's columns. Keys >= n
//   and keys outside a row's diagonal block are then set to -inf in the
//   accumulator registers (a zero-filled key gives s = 0, not -inf).
//   Swizzle 128 B (64 bf16 a row; D = 128 takes two boxes side by side),
//   64 B at D = 32, matched by the wgmma descriptors.
// - S = Q.K^T is wgmma.m64n64k16 with both operands in shared memory and
//   the accumulator in registers. P.V is wgmma.m64nDk16 with A from
//   registers: the S accumulator's layout, packed to bf16, is the A
//   fragment, so p never touches shared memory; V is the transposed
//   (MN-major) B operand, straight from its TMA tile. Every product is
//   issued unconditionally, over zero-filled and masked keys alike: a
//   product under a branch makes ptxas serialise every wgmma of the kernel
//   (its message C7520). The block-diagonal mask skips no key tile.
// - the softmax scale is folded into the exponent's fma (the row max is
//   taken of the unscaled scores), so scale must be positive; the
//   wrappers refuse others.
// - the output is stored from registers, rows < n only; the statistics
//   rows < n (the caller zero-fills the rest). Both entries run the same
//   kernel, so their outputs are equal bit for bit.
//
// The one-pass form: one consumer warpgroup a block (64 query rows of one
// (b, h); N = 145 is three blocks a head), no producer warp: thread 0
// issues Q and all T key tiles of K on one mbarrier and all of V on a
// second, so the softmax runs while V lands. 128 threads and 57 KB at
// D = 64, T = 3: three blocks an SM (at most 168 registers a thread), whose
// loads, products and exponentials overlap one another's. Each block
// re-reads its head's K and V from L2 (the head's blocks are neighbours in
// the grid); one block a head whose consumers shared one K/V load would
// hold one block an SM at these registers, with nothing to overlap its
// loads. Templated on T = ceil(n / 64), so the score block is a register
// array of fixed size.
//
// The two-pass form: one block per (b, h, 128 query rows), two blocks an
// SM (D <= 64): warps 0-3 and 4-7 are two consumer warpgroups of 64 query
// rows each, warp 8 the producer, one thread of which issues every copy.
// Q is loaded once per block; K and V stream through a ring of kStages
// 64-key stages tracked by mbarriers (full: the TMA bytes landed; empty:
// every consumer warp finished reading). The producer walks 2T jobs: K
// tiles for pass 1, then K and V tiles for pass 2. B1 and B3 run the same
// instructions on it, so on the same data their outputs and statistics are
// equal bit for bit.
//
// Tried on the card for the two-pass form and slower, so not kept:
// software pipelining within a consumer (the next tile's score product in
// flight during this tile's exponentials), which made ptxas serialise the
// wgmmas (C7514, C7515: accumulator registers read while a group is in
// flight) and spill at two blocks an SM; the two consumers taking turns
// through named barriers; 32-key tiles at three blocks an SM (spills); one
// block an SM.
//
// kernels.py rebuilds a library when this header is newer than it.

#pragma once

#include "attention_nhd_common.cuh"
#include "sm90_common.cuh"  // tiles, ring, TMA, wgmma, descriptors, tensor maps

namespace {
namespace sm90 {

// The two-pass form: Shape<D>'s blocks (two consumer warpgroups, at most
// 113 registers a thread at two blocks an SM) and a producer warp.
constexpr int kProducerWarp = 4 * kConsumers;     // after the consumers
constexpr int kBlockThreads = 32 * (kProducerWarp + 1);
// The longest sequence the one-pass form takes (B1 only): four key tiles,
// 128 score registers a thread, three blocks an SM still at D = 64.
// ops/flash_attention.py::ONE_PASS_MAX_SEQ.
constexpr int kOnePassTiles = 4;
constexpr int kOnePassMaxSeq = kOnePassTiles * kKeys;

// The one-pass form's shared memory: Q (64 rows), T tiles of K, T tiles of
// V, two mbarriers.
template <int D, int T>
struct OnePass : Shape<D> {
  using Shape<D>::kQBytes;
  using Shape<D>::kTileBytes;
  static constexpr int kKOffset = kQBytes;
  static constexpr int kVOffset = kKOffset + T * kTileBytes;
  static constexpr int kBarrierOffset = kVOffset + T * kTileBytes;
  static constexpr size_t kSmem = 1024 + kBarrierOffset + 16;
  // three blocks an SM at D <= 64 (at most 168 registers a thread; 57 KB
  // of shared memory at D = 64, T = 3, 73 KB at T = 4); at D = 128 shared
  // memory decides (two blocks at T <= 2, one at T >= 3)
  static constexpr int kMinBlocks = D <= 64 ? 3 : 1;
};

// A warp's 16 output rows (row_lo, row_lo + 8) from the O accumulator as
// bf16, rows >= n skipped. The accumulator layout is sm90_common.cuh's:
// columns 16kk .. 16kk + 15 of S, packed to bf16, are P.V's A fragment for
// keys 16kk .. 16kk + 15.
template <int D, bool kHeadMajor>
__device__ __forceinline__ void store_o(bf16* __restrict__ o, const float (&acc)[D / 2],
                                        int b, int h, int n, int heads, int row_lo, int t) {
  const HeadRows rows = head_rows<kHeadMajor, D>(b, h, n, heads);
  store_acc<D>(o + rows.base, acc, row_lo, n, t, rows.stride);
}

// ---------------------------------------------------------------------------
// one pass: grid (ceil(n / 64), heads, batch), 128 threads (one consumer
// warpgroup), OnePass<D, T>::kSmem bytes of dynamic shared memory, T =
// ceil(n / 64) <= kOnePassTiles. stats may be null.
template <int D, int T, bool kHeadMajor>
__global__ void __launch_bounds__(128, OnePass<D, T>::kMinBlocks)
    attention_fwd_onepass_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                      const __grid_constant__ CUtensorMap tk,
                                      const __grid_constant__ CUtensorMap tv,
                                      bf16* __restrict__ o, float2* __restrict__ stats,
                                      int n, int heads, float scale, int block_size) {
  using S = OnePass<D, T>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_smem = base;                  // [sub][64 rows][kSwz]
  const uint32_t k_smem = base + S::kKOffset;    // [tile][sub][64 rows][kSwz]
  const uint32_t v_smem = base + S::kVOffset;    // [tile][sub][64 rows][kSwz]
  const uint32_t qk_bar = base + S::kBarrierOffset, v_bar = qk_bar + 8;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kRowsWG;
  const MapAt at = map_at<kHeadMajor, D>(b, h, heads);
  if (threadIdx.x == 0) {  // every copy of the block, at once
    mbar_init(qk_bar, 1);
    mbar_init(v_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(qk_bar, S::kQBytes + T * S::kTileBytes);
    tma_rows<D>(q_smem, &tq, qk_bar, q0, at.plane, at.col);
#pragma unroll
    for (int j = 0; j < T; ++j)
      tma_rows<D>(k_smem + j * S::kTileBytes, &tk, qk_bar, j * kKeys, at.plane, at.col);
    mbar_expect_tx(v_bar, T * S::kTileBytes);
#pragma unroll
    for (int j = 0; j < T; ++j)
      tma_rows<D>(v_smem + j * S::kTileBytes, &tv, v_bar, j * kKeys, at.plane, at.col);
  }
  __syncthreads();  // the barriers are initialised

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row_lo = q0 + 16 * warp + g;  // and row_lo + 8

  // every score of the block's rows: T tiles of 64 keys, unscaled (Q and K
  // both K-major)
  float sacc[T][kKeys / 2];
  mbar_wait(qk_bar, 0);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < T; ++j) scores<D>(sacc[j], q_smem, k_smem + j * S::kTileBytes);
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int j = 0; j < T; ++j) reg_fence(sacc[j]);

  const Span lo = row_keys(row_lo, n, block_size), hi = row_keys(row_lo + 8, n, block_size);
#pragma unroll
  for (int j = 0; j < T; ++j) mask_keys(sacc[j], j * kKeys, t, lo, hi, n, block_size);

  // The exact row max and sum, then p = 2^(s scale log2e - m log2e) kept
  // in place of the score. The scale is positive, so the row max of the
  // unscaled scores times scale is the scaled scores' row max.
  const float sl2e = scale * kLog2e;
  float m[2], inv_l[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < T; ++j)
#pragma unroll
      for (int c = 0; c < kKeys / 8; ++c)
        mx = fmaxf(mx, fmaxf(sacc[j][4 * c + 2 * half], sacc[j][4 * c + 2 * half + 1]));
    mx = quad_max(mx);
    const bool none = mx == -INFINITY;  // no key kept (a padded row): p = 0
    m[half] = none ? 0.f : mx * scale;  // the max of the scaled scores
    const float ml = m[half] * kLog2e;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < T; ++j)
#pragma unroll
      for (int c = 0; c < kKeys / 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {  // keys not kept: 2^-inf = 0
          float& s = sacc[j][4 * c + 2 * half + e];
          s = exp2_approx(fmaf(s, sl2e, -ml));
          sum += s;
        }
    const float l = quad_sum(sum);
    inv_l[half] = none ? 1.f : 1.f / l;
  }
  if (stats != nullptr && t == 0) {
    const size_t srow = ((size_t)b * heads + h) * round_up(n, kKTile);
    if (row_lo < n) stats[srow + row_lo] = make_float2(m[0], inv_l[0]);
    if (row_lo + 8 < n) stats[srow + row_lo + 8] = make_float2(m[1], inv_l[1]);
  }

  // pn = p * (1/l) rounded to bf16, in registers, as P.V's A fragments
  uint32_t pa[T][kKeys / 16][4];
#pragma unroll
  for (int j = 0; j < T; ++j)
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // column block 2kk + e/2, row half e % 2
        const int i = 4 * (2 * kk + (e >> 1)) + 2 * (e & 1);
        pa[j][kk][e] = pack_bf16(sacc[j][i] * inv_l[e & 1], sacc[j][i + 1] * inv_l[e & 1]);
      }

  // o = pn . v; keys not kept have pn = 0, and TMA zero-filled V's rows
  // past n
  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  mbar_wait(v_bar, 0);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < T; ++j) product_rs<D>(oacc, pa[j], v_smem + j * S::kTileBytes);
  wgmma_commit();
  wgmma_wait_all();
  reg_fence(oacc);

  store_o<D, kHeadMajor>(o, oacc, b, h, n, heads, row_lo, t);
}

// ---------------------------------------------------------------------------
// two passes: grid (ceil(n / kRowsBlock), heads, batch), kBlockThreads
// threads (warps 0-3 and 4-7 the two consumer warpgroups, warp 8 the
// producer), Shape<D>::kSmem bytes of dynamic shared memory. stats may be
// null.
template <int D, bool kHeadMajor>
__global__ void __launch_bounds__(kBlockThreads, Shape<D>::kMinBlocks)
    attention_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              bf16* __restrict__ o, float2* __restrict__ stats, int n,
                              int heads, float scale, int block_size) {
  using S = Shape<D>;
  if constexpr (kHeadMajor) block_size = 0;  // B3 has no mask: fold it away
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_smem = base;  // [consumer][sub][64 rows][kSwz]
  const uint32_t kv_smem = base + kConsumers * S::kQBytes;  // [stage][K, V][sub][rows][kSwz]
  const Ring ring(base + S::kBarrierOffset);  // its rows() barrier: Q's
  auto k_tile = [&](int s) { return kv_smem + s * 2 * S::kTileBytes; };
  auto v_tile = [&](int s) { return kv_smem + s * 2 * S::kTileBytes + S::kTileBytes; };

  const int h = blockIdx.y, b = blockIdx.z;
  const MapAt at = map_at<kHeadMajor, D>(b, h, heads);
  const int q0 = blockIdx.x * kRowsBlock;
  const int consumers = min(kConsumers, (n - q0 + kRowsWG - 1) / kRowsWG);  // with rows < n
  const int tiles = (n + kKeys - 1) / kKeys;
  const int warp_id = threadIdx.x / 32;

  if (threadIdx.x == 0) ring.init(consumers);
  __syncthreads();

  if (warp_id == kProducerWarp) {  // producer: one thread issues every copy
    if (threadIdx.x != 32 * kProducerWarp) return;
    mbar_expect_tx(ring.rows(), consumers * S::kQBytes);
    for (int c = 0; c < consumers; ++c)
      tma_rows<D>(q_smem + c * S::kQBytes, &tq, ring.rows(), q0 + c * kRowsWG, at.plane,
                  at.col);
    for (int job = 0; job < 2 * tiles; ++job) {
      const int s = job % kStages;
      ring.wait_free(job);
      const bool with_v = job >= tiles;  // pass 2
      const int k0 = (job % tiles) * kKeys;
      mbar_expect_tx(ring.full(s), (with_v ? 2 : 1) * S::kTileBytes);
      tma_rows<D>(k_tile(s), &tk, ring.full(s), k0, at.plane, at.col);
      if (with_v) tma_rows<D>(v_tile(s), &tv, ring.full(s), k0, at.plane, at.col);
    }
    return;
  }

  const int c = warp_id / 4;  // this consumer
  if (c >= consumers) return;  // all its rows lie past n
  const int warp = warp_id % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row_lo = q0 + c * kRowsWG + 16 * warp + g;  // and row_lo + 8
  const uint32_t q_addr = q_smem + c * S::kQBytes;
  mbar_wait(ring.rows(), 0);

  float sacc[kKeys / 2];
  auto qk = [&](int job) {  // sacc = Q . K^T of job's stage (both K-major)
    ring.wait_full(job);
    wgmma_fence();
    scores<D>(sacc, q_addr, k_tile(job % kStages));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(sacc);
  };
  // The scores stay unscaled: scale > 0, so the row max of s * scale is
  // the scaled row max, and exp(s * scale - m) = 2^(s * scale log2e -
  // m log2e) takes the scale in one fma.
  const float sl2e = scale * kLog2e;
  const Span lo = row_keys(row_lo, n, block_size), hi = row_keys(row_lo + 8, n, block_size);

  // Pass 1: row max and row sum. Each lane keeps the sum of its own
  // columns, rescaled whenever the (quad-wide) row max grows. m is the max
  // of the unscaled scores until the statistics are written.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int job = 0; job < tiles; ++job) {
    qk(job);
    ring.arrive(job);
    mask_keys(sacc, job * kKeys, t, lo, hi, n, block_size);
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
      for (int j = 0; j < kKeys / 8; ++j)  // keys not kept: 2^-inf = 0
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
    const size_t srow = ((size_t)b * heads + h) * round_up(n, kKTile);
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
    qk(job);
    mask_keys(sacc, (job - tiles) * kKeys, t, lo, hi, n, block_size);
    uint32_t pa[kKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * (2 * kk + (e >> 1)) + 2 * (e & 1);
        const int half = e & 1;  // keys not kept: p = 2^-inf = 0
        pa[kk][e] = pack_bf16(exp2_approx(fmaf(sacc[i], sl2e, -m[half])) * l[half],
                              exp2_approx(fmaf(sacc[i + 1], sl2e, -m[half])) * l[half]);
      }
    // keys not kept: p = 0, and TMA zero-filled V's rows past n (V the
    // MN-major B operand)
    wgmma_fence();
    product_rs<D>(oacc, pa, v_tile(job % kStages));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(oacc);
    ring.arrive(job);
  }

  store_o<D, kHeadMajor>(o, oacc, b, h, n, heads, row_lo, t);
}

// ---------------------------------------------------------------------------
// host: launch

template <int D, int T, bool kHeadMajor>
cudaError_t launch_onepass(const CUtensorMap& tq, const CUtensorMap& tk,
                           const CUtensorMap& tv, void* o, void* stats, int batch, int n,
                           int heads, float scale, int block_size, cudaStream_t stream) {
  using S = OnePass<D, T>;
  auto kernel = attention_fwd_onepass_sm90_kernel<D, T, kHeadMajor>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kRowsWG - 1) / kRowsWG, heads, batch);
  kernel<<<grid, 128, S::kSmem, stream>>>(tq, tk, tv, static_cast<bf16*>(o),
                                          static_cast<float2*>(stats), n, heads, scale,
                                          block_size);
  return cudaGetLastError();
}

// The one-pass kernel for `tiles` key tiles (1 .. T).
template <int D, int T>
cudaError_t launch_onepass_tiles(int tiles, const CUtensorMap& tq, const CUtensorMap& tk,
                                 const CUtensorMap& tv, void* o, void* stats, int batch,
                                 int n, int heads, float scale, int block_size,
                                 cudaStream_t stream) {
  if constexpr (T > 1)
    if (tiles < T)
      return launch_onepass_tiles<D, T - 1>(tiles, tq, tk, tv, o, stats, batch, n, heads,
                                            scale, block_size, stream);
  return launch_onepass<D, T, false>(tq, tk, tv, o, stats, batch, n, heads, scale,
                                     block_size, stream);
}

template <int D, bool kHeadMajor>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* stats,
                   int batch, int n, int heads, float scale, int block_size,
                   cudaStream_t stream) {
  using S = Shape<D>;
  // B3: (D, n, B*H); B1: (H*D, n, B). Boxes of 64 rows: Q's and K's / V's.
  const int width = kHeadMajor ? D : heads * D, planes = kHeadMajor ? batch * heads : batch;
  CUtensorMap tq, tk, tv;
  if (!encode_rows<D>(&tq, q, width, n, planes, kRowsWG) ||
      !encode_rows<D>(&tk, k, width, n, planes, kKeys) ||
      !encode_rows<D>(&tv, v, width, n, planes, kKeys))
    return cudaErrorInvalidValue;
  if constexpr (!kHeadMajor)  // B1: the one-pass form up to kOnePassMaxSeq
    if (n <= kOnePassMaxSeq)
      return launch_onepass_tiles<D, kOnePassTiles>((n + kKeys - 1) / kKeys, tq, tk, tv, o,
                                                    stats, batch, n, heads, scale,
                                                    block_size, stream);
  auto kernel = attention_fwd_sm90_kernel<D, kHeadMajor>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kRowsBlock - 1) / kRowsBlock, heads, batch);
  kernel<<<grid, kBlockThreads, S::kSmem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float2*>(stats), n, heads, scale,
      block_size);
  return cudaGetLastError();
}

// Checks the sizes, then launches for the head dim; returns a cudaError_t.
// kHeadMajor: B3's layout (block_size must be 0), else B1's.
template <bool kHeadMajor>
int dispatch(const void* q, const void* k, const void* v, void* o, void* stats, int batch,
             int n, int heads, int head_dim, float scale, int block_size, void* stream) {
  if (n < 1 || n > kMaxSeq || batch < 1 || heads < 1 || batch > 65535 || heads > 65535 ||
      !(scale > 0.f) || block_size < 0 || (kHeadMajor && block_size != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return (int)launch<32, kHeadMajor>(q, k, v, o, stats, batch, n, heads, scale,
                                         block_size, s);
    case 64:
      return (int)launch<64, kHeadMajor>(q, k, v, o, stats, batch, n, heads, scale,
                                         block_size, s);
    case 128:
      return (int)launch<128, kHeadMajor>(q, k, v, o, stats, batch, n, heads, scale,
                                          block_size, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace sm90
}  // namespace
