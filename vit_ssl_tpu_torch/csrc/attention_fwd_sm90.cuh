// Kernel B3's bfloat16 forward, inference and training, redesigned for
// Hopper (sm_90a) with wgmma, TMA and warp specialisation. Instantiated by
// fused_attention.cu only (B1's libraries do not include this header);
// float32 stays on the CUDA-core body of attention_fwd.cuh. Its Hopper
// primitives (mbarriers, TMA, wgmma, tensor maps) are sm90_common.cuh's.
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

#include "attention_nhd_common.cuh"
#include "sm90_common.cuh"  // mbarriers, TMA, wgmma, tensor maps

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
struct Shape : HeadTile<D> {  // kSwz, kRowBytes, kSubs, kLayout
  using HeadTile<D>::kRowBytes;
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
// host: launch

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
