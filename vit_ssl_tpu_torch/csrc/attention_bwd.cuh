// The attention backward of kernels B1 and B3, for Hopper (sm_90a): the
// kernel bodies, templated on the layout (kHeadMajor,
// attention_nhd_common.cuh::head_rows). attention_nhd_bwd.cu instantiates
// them for B1's (B, N, H*D) layout, fused_attention.cu for B3's
// (B, H, N, D) layout; the C entry points live there. Per head:
//
//   p     = the forward's normalised probabilities, rounded to the input dtype
//   dv    = p^T . do                        fp32 accumulation
//   dp    = do . v^T                        fp32
//   delta = sum_j p * dp                    fp32, per query row
//   ds    = (p * (dp - delta) * scale) rounded to the input dtype
//   dq    = ds . k ; dk = ds^T . q          fp32 accumulation
//
// each result cast to the input dtype on store; do arrives already cast to
// the input dtype. The TPU kernels read the (B, H, N, N) probabilities
// their training forwards saved; this one recomputes them from q, k and the
// softmax statistics (m, 1/l) that the training forward saved (fp32,
// (B, H, round_up(N, 64), 2)): the scores with the forward's very
// instructions (attention_nhd_common.cuh: mma_abt8 for bf16, dot8_f32 for
// fp32), then p = exp(s - m) * (1/l) rounded as the forward rounded it. So
// the bf16 p here is the one the forward fed to P.V. Recomputing p means
// applying the block-diagonal mask again (the saved probabilities were zero
// off the blocks; recomputed ones would not be), and zeroing rows and keys
// past N.
//
// How the design keeps the bytes down: no (N, N) matrix is ever written
// (the TPU kernels read 2 bytes per score; this one 8 bytes per row), and each
// block keeps its own rows' operands and gradients in registers for the
// whole sweep, so q, k, v and do are each read about twice from device
// memory, the re-reads of one (b, h)'s few tiles coming mostly from L2.
// The work splits in two kernels, as the JAX package's own blockwise
// backward does (flash_blockwise.py: a dq pass and a dk/dv pass), so that
// no gradient needs atomics and the result is the same from run to run:
//
// - dq kernel: one block per (b, h, 64-query tile), 4 warps of 16 rows,
//   Q and dO fragments in registers. It sweeps the key tiles twice (K and V
//   through two cp.async buffers): the first sweep sums delta = sum p * dp,
//   the second forms ds and accumulates dq += ds . k. It writes dq and
//   delta ((B, H, round_up(N, 64)) fp32, for the second kernel).
// - dk/dv kernel: one block per (b, h, 64-key tile), 4 warps of 16 keys,
//   K and V fragments in registers. It sweeps the query tiles (Q, dO, the
//   statistics and delta through two buffers) and computes the transposed
//   scores S^T = K . Q^T and dP^T = V . dO^T, so that p^T and ds^T land in
//   the accumulator layout that mma.sync takes as its A operand:
//   dv += p^T . do and dk += ds^T . q, in fp32 registers.
//
// bfloat16 runs on the tensor cores (mma.sync m16n8k16, ldmatrix), 16
// queries or keys at a time so that only two 16x8 score tiles are live in
// registers. As in the forward, the mask is a key span per row, and tiles
// outside a warp's span (past n, or off its diagonal blocks) are skipped:
// their p is exactly 0. float32 keeps full fp32 products on the CUDA cores (TF32
// would miss the fp32 tolerance), with the same two-kernel split: 32 rows a
// block of 8 warps, 8 threads a row, score tiles through shared memory.
//
// kernels.py rebuilds a library when this header is newer than it.

#pragma once

#include "attention_nhd_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// bfloat16: tensor cores

template <int D>
constexpr size_t smem_bytes_dq_bf16() {  // K and V, two buffers each
  return 4 * sizeof(bf16) * kKTile * (D + kBPad);
}

template <int D>
constexpr size_t smem_bytes_dkv_bf16() {  // Q, dO, (m, 1/l) and delta, two buffers each
  return 4 * sizeof(bf16) * kKTile * (D + kBPad) + 2 * kKTile * (sizeof(float2) + sizeof(float));
}

// grid (ceil(n / kRows16), heads, batch), 32 * kWarps16 threads,
// smem_bytes_dq_bf16<D>() of dynamic shared memory. kMasked: block_size > 0.
// The unmasked instantiation keeps no key spans (every key < n is kept):
// with them it needs 128 registers at D = 64 and spills 16 bytes, 11 %
// slower at (256, 145) on an H100; without, 127 and no spill.
//
// The block walks 2T tile jobs, T = ceil(n / kKTile), each a K and a V tile:
// sweep 1 (jobs 0 .. T-1) sums delta, sweep 2 accumulates dq. Job i + 1's
// copies are in flight while job i computes, in the other of two buffers.
template <int D, bool kMasked, bool kHeadMajor>
__global__ void __launch_bounds__(32 * kWarps16)
    attention_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                                     const bf16* __restrict__ k,
                                     const bf16* __restrict__ v,
                                     const bf16* __restrict__ dout,
                                     const float2* __restrict__ stats,
                                     bf16* __restrict__ dq, float* __restrict__ delta,
                                     int n, int heads, float scale, int block_size) {
  static_assert(D % 32 == 0, "head_dim must be a multiple of 32");
  constexpr int kTileElems = kKTile * (D + kBPad);
  extern __shared__ uint4 smem_bf16[];
  bf16* ks = reinterpret_cast<bf16*>(smem_bf16);  // [2][kKTile][D + kBPad]
  bf16* vs = ks + 2 * kTileElems;                 // [2][kKTile][D + kBPad]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const HeadRows rows = head_rows<kHeadMajor, D>(b, h, n, heads);
  const size_t base = rows.base;
  const int stride = rows.stride;
  const size_t srow = ((size_t)b * heads + h) * round_up(n, kKTile);
  const int row_lo = blockIdx.x * kRows16 + 16 * warp + g;  // and row_lo + 8
  const int row_hi = row_lo + 8;
  const bool active = blockIdx.x * kRows16 + 16 * warp < n;
  const int tiles = (n + kKTile - 1) / kKTile;
  const Span all_keys = {0, n};
  const Span span_lo = kMasked ? key_span(row_lo, n, block_size) : all_keys;
  const Span span_hi = kMasked ? key_span(row_hi, n, block_size) : all_keys;
  const Span warp_keys =
      kMasked ? warp_key_span(blockIdx.x * kRows16 + 16 * warp, n, block_size) : all_keys;

  auto start_copies = [&](int job) {
    const int buf = job & 1, k0 = (job % tiles) * kKTile;
    load_tile_bf16<D>(ks + buf * kTileElems, k + base, k0, n, stride);
    load_tile_bf16<D>(vs + buf * kTileElems, v + base, k0, n, stride);
    cp_async_commit();
  };
  start_copies(0);

  uint32_t qa[D / 16][4], da[D / 16][4];  // this warp's Q and dO rows
  load_a_frags<D>(qa, q + base, row_lo, n, stride);
  load_a_frags<D>(da, dout + base, row_lo, n, stride);
  // the forward's (m log2 e, 1/l) of rows row_lo, row_hi; (0, 0) past n
  float ml[2], il[2];
  {
    const float2 lo = stats[srow + row_lo], hi = stats[srow + row_hi];
    ml[0] = lo.x * kLog2e;
    il[0] = lo.y;
    ml[1] = hi.x * kLog2e;
    il[1] = hi.y;
  }

  float dsum[2] = {0.f, 0.f};  // this lane's share of delta, sweep 1
  float dl[2] = {0.f, 0.f};    // delta of rows row_lo, row_hi, sweep 2
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  for (int job = 0; job < 2 * tiles; ++job) {
    if (job + 1 < 2 * tiles) {
      start_copies(job + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bool second = job >= tiles;
    const int k0 = (job % tiles) * kKTile;
    if (active) {
      const bf16* kt = ks + (job & 1) * kTileElems;
      const bf16* vt = vs + (job & 1) * kTileElems;
      const bool unmasked = !kMasked && k0 + kKTile <= n;  // uniform
#pragma unroll
      for (int kk = 0; kk < kKTile / 16; ++kk) {  // 16 keys: score tiles 2kk, 2kk+1
        // keys outside the warp's span give p = 0: nothing to add
        if (!warp_keys.meets(k0 + 16 * kk, 16)) continue;  // uniform
        float p[2][4], dp[2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * kk + jj;
          if (!warp_keys.meets(k0 + 8 * j, 8)) {  // uniform: p = 0
            p[jj][0] = p[jj][1] = p[jj][2] = p[jj][3] = 0.f;
            dp[jj][0] = dp[jj][1] = dp[jj][2] = dp[jj][3] = 0.f;
            continue;
          }
          float s[4];
          mma_abt8<D>(s, qa, kt + 8 * j * (D + kBPad));
          mma_abt8<D>(dp[jj], da, vt + 8 * j * (D + kBPad));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int half = e >> 1, col = k0 + 8 * j + 2 * t + (e & 1);
            const float sv =
                unmasked || (half ? span_hi : span_lo).has(col) ? s[e] * scale : -INFINITY;
            p[jj][e] = exp2_approx(fmaf(sv, kLog2e, -ml[half])) * il[half];
          }
        }
        // p rounded as the forward rounded it, packed as an A fragment:
        // register r holds tile r >> 1, row half r & 1
        uint32_t pa[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[r] = pack_bf16(p[r >> 1][2 * (r & 1)], p[r >> 1][2 * (r & 1) + 1]);
        if (!second) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int jj = r >> 1, half = r & 1;
            dsum[half] += bf16_lo(pa[r]) * dp[jj][2 * half] +
                          bf16_hi(pa[r]) * dp[jj][2 * half + 1];
          }
        } else {
          uint32_t dsa[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int jj = r >> 1, half = r & 1;
            dsa[r] = pack_bf16(bf16_lo(pa[r]) * (dp[jj][2 * half] - dl[half]) * scale,
                               bf16_hi(pa[r]) * (dp[jj][2 * half + 1] - dl[half]) * scale);
          }
          mma_ab16<D>(acc, dsa, kt + 16 * kk * (D + kBPad));
        }
      }
      if (job == tiles - 1) {  // sweep 1 done: delta of the whole row
        dl[0] = quad_sum(dsum[0]);
        dl[1] = quad_sum(dsum[1]);
      }
    }
    __syncthreads();  // buffer job & 1 is free for job + 2
  }

  store_rows_bf16<D>(dq + base, acc, row_lo, n, stride);
  if (active && t == 0) {
    if (row_lo < n) delta[srow + row_lo] = dl[0];
    if (row_hi < n) delta[srow + row_hi] = dl[1];
  }
}

// grid (ceil(n / kRows16), heads, batch), 32 * kWarps16 threads,
// smem_bytes_dkv_bf16<D>() of dynamic shared memory. Block x owns keys
// 64x .. 64x + 63, warp w keys 16w .. 16w + 15 of them.
//
// The block walks T query-tile jobs: Q, dO, their (m, 1/l) and delta. Job
// i + 1's copies are in flight while job i computes.
template <int D, bool kHeadMajor>
__global__ void __launch_bounds__(32 * kWarps16)
    attention_bwd_dkv_bf16_kernel(const bf16* __restrict__ q,
                                      const bf16* __restrict__ k,
                                      const bf16* __restrict__ v,
                                      const bf16* __restrict__ dout,
                                      const float2* __restrict__ stats,
                                      const float* __restrict__ delta,
                                      bf16* __restrict__ dk, bf16* __restrict__ dv,
                                      int n, int heads, float scale, int block_size) {
  static_assert(D % 32 == 0, "head_dim must be a multiple of 32");
  constexpr int kTileElems = kKTile * (D + kBPad);
  extern __shared__ uint4 smem_bf16[];
  bf16* qs = reinterpret_cast<bf16*>(smem_bf16);               // [2][kKTile][D + kBPad]
  bf16* dos = qs + 2 * kTileElems;                             // [2][kKTile][D + kBPad]
  float2* sts = reinterpret_cast<float2*>(dos + 2 * kTileElems);  // [2][kKTile] (m, 1/l)
  float* dls = reinterpret_cast<float*>(sts + 2 * kKTile);        // [2][kKTile] delta

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const HeadRows rows = head_rows<kHeadMajor, D>(b, h, n, heads);
  const size_t base = rows.base;
  const int stride = rows.stride;
  const size_t srow = ((size_t)b * heads + h) * round_up(n, kKTile);
  const int key_lo = blockIdx.x * kRows16 + 16 * warp + g;  // and key_lo + 8
  const bool active = blockIdx.x * kRows16 + 16 * warp < n;
  const int tiles = (n + kKTile - 1) / kKTile;
  // the queries that attend keys key_lo, key_lo + 8, and any of the warp's
  const Span span_lo = key_span(key_lo, n, block_size);
  const Span span_hi = key_span(key_lo + 8, n, block_size);
  const Span warp_queries = warp_key_span(blockIdx.x * kRows16 + 16 * warp, n, block_size);

  auto start_copies = [&](int job) {
    const int buf = job & 1, q0 = job * kKTile;
    load_tile_bf16<D>(qs + buf * kTileElems, q + base, q0, n, stride);
    load_tile_bf16<D>(dos + buf * kTileElems, dout + base, q0, n, stride);
    // the tile's 64 (m, 1/l) pairs and 64 deltas: 512 + 256 bytes, 16 a
    // thread; both arrays run to round_up(n, 64), zero past n
    const int x = threadIdx.x;
    if (x < 32)
      cp_async16(sts + buf * kKTile + 2 * x, stats + srow + q0 + 2 * x, true);
    else if (x < 48)
      cp_async16(dls + buf * kKTile + 4 * (x - 32), delta + srow + q0 + 4 * (x - 32), true);
    cp_async_commit();
  };
  start_copies(0);

  uint32_t ka[D / 16][4], va[D / 16][4];  // this warp's K and V rows
  load_a_frags<D>(ka, k + base, key_lo, n, stride);
  load_a_frags<D>(va, v + base, key_lo, n, stride);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    dk_acc[dn][0] = dk_acc[dn][1] = dk_acc[dn][2] = dk_acc[dn][3] = 0.f;
    dv_acc[dn][0] = dv_acc[dn][1] = dv_acc[dn][2] = dv_acc[dn][3] = 0.f;
  }

  for (int job = 0; job < tiles; ++job) {
    if (job + 1 < tiles) {
      start_copies(job + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = job * kKTile;
    if (active) {
      const bf16* qt = qs + (job & 1) * kTileElems;
      const bf16* dot = dos + (job & 1) * kTileElems;
      const float2* st = sts + (job & 1) * kKTile;
      const float* dlt = dls + (job & 1) * kKTile;
#pragma unroll
      for (int kk = 0; kk < kKTile / 16; ++kk) {  // 16 queries: tiles 2kk, 2kk+1
        // queries outside the warp's span give p = 0: nothing to add
        if (!warp_queries.meets(q0 + 16 * kk, 16)) continue;  // uniform
        float p[2][4], dp[2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * kk + jj;
          if (!warp_queries.meets(q0 + 8 * j, 8)) {  // uniform: p = 0
            p[jj][0] = p[jj][1] = p[jj][2] = p[jj][3] = 0.f;
            dp[jj][0] = dp[jj][1] = dp[jj][2] = dp[jj][3] = 0.f;
            continue;
          }
          float s[4];
          mma_abt8<D>(s, ka, qt + 8 * j * (D + kBPad));   // S^T = K . Q^T
          mma_abt8<D>(dp[jj], va, dot + 8 * j * (D + kBPad));  // dP^T = V . dO^T
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int lc = 8 * j + 2 * t + (e & 1);
            const float sv =
                (e >> 1 ? span_hi : span_lo).has(q0 + lc) ? s[e] * scale : -INFINITY;
            const float2 mi = st[lc];
            p[jj][e] = exp2_approx(fmaf(sv, kLog2e, -(mi.x * kLog2e))) * mi.y;
          }
        }
        // p^T rounded as the forward rounded p, and ds^T, as A fragments
        uint32_t pa[4], dsa[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int jj = r >> 1, half = r & 1;
          const int lc = 8 * (2 * kk + jj) + 2 * t;
          pa[r] = pack_bf16(p[jj][2 * half], p[jj][2 * half + 1]);
          dsa[r] = pack_bf16(bf16_lo(pa[r]) * (dp[jj][2 * half] - dlt[lc]) * scale,
                             bf16_hi(pa[r]) * (dp[jj][2 * half + 1] - dlt[lc + 1]) * scale);
        }
        mma_ab16<D>(dv_acc, pa, dot + 16 * kk * (D + kBPad));
        mma_ab16<D>(dk_acc, dsa, qt + 16 * kk * (D + kBPad));
      }
    }
    __syncthreads();  // buffer job & 1 is free for job + 2
  }

  store_rows_bf16<D>(dk + base, dk_acc, key_lo, n, stride);
  store_rows_bf16<D>(dv + base, dv_acc, key_lo, n, stride);
}

// ---------------------------------------------------------------------------
// float32: CUDA cores

constexpr int kRows32 = 32;  // query or key rows per block, 8 threads a row

static_assert(kThreads == kRows32 * 8, "8 threads per row");

template <int D>
constexpr size_t smem_bytes_dq_f32() {  // Q, dO; K, V; the ds tile
  return sizeof(float) * ((size_t)(2 * kRows32 + 2 * kKTile) * (D + kPad) +
                          (size_t)kRows32 * (kKTile + kPad));
}

template <int D>
constexpr size_t smem_bytes_dkv_f32() {  // K, V; Q, dO; p^T, ds^T; m, 1/l, delta
  return sizeof(float) * ((size_t)(2 * kRows32 + 2 * kKTile) * (D + kPad) +
                          (size_t)2 * kRows32 * (kKTile + kPad) + 3 * kKTile);
}

// grid (ceil(n / kRows32), heads, batch), kThreads threads. Thread (r, sub)
// owns query row r of the block, score columns sub + 8j of each key tile
// and dq columns 4 * (sub + 8jj) .. + 3.
template <int D, bool kHeadMajor>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dq_f32_kernel(const float* __restrict__ q,
                                    const float* __restrict__ k,
                                    const float* __restrict__ v,
                                    const float* __restrict__ dout,
                                    const float2* __restrict__ stats,
                                    float* __restrict__ dq, float* __restrict__ delta,
                                    int n, int heads, float scale, int block_size) {
  static_assert(D % 32 == 0, "head_dim must be a multiple of 32");
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kRows32][D + kPad]
  float* dos = qs + kRows32 * (D + kPad);       // [kRows32][D + kPad]
  float* ks = dos + kRows32 * (D + kPad);       // [kKTile][D + kPad]
  float* vs = ks + kKTile * (D + kPad);         // [kKTile][D + kPad]
  float* dss = vs + kKTile * (D + kPad);        // [kRows32][kKTile + kPad]

  const int n_keys = round_up(n, kKTile);
  const int q0 = blockIdx.x * kRows32;
  const int h = blockIdx.y, b = blockIdx.z;
  const HeadRows rows = head_rows<kHeadMajor, D>(b, h, n, heads);
  const size_t base = rows.base;
  const int stride = rows.stride;
  const size_t srow = ((size_t)b * heads + h) * n_keys;
  const int tid = threadIdx.x, r = tid >> 3, sub = tid & 7;
  const int i = q0 + r;  // < n_keys: the statistics exist (zero past n)
  const Span span = key_span(i, n, block_size);

  load_tile_f32<D>(qs, q + base, q0, kRows32, n, stride);
  load_tile_f32<D>(dos, dout + base, q0, kRows32, n, stride);
  const float2 st = stats[srow + i];
  const float* qrow = qs + r * (D + kPad);
  const float* drow = dos + r * (D + kPad);

  // sweep 1: delta = sum_j p * dp over the row's 8 threads
  float dl = 0.f;
  for (int k0 = 0; k0 < n_keys; k0 += kKTile) {
    __syncthreads();  // Q and dO are in; the previous tiles are consumed
    load_tile_f32<D>(ks, k + base, k0, kKTile, n, stride);
    load_tile_f32<D>(vs, v + base, k0, kKTile, n, stride);
    __syncthreads();
    float s[8], dp[8];
    dot8_f32<D>(s, qrow, ks, sub);
    dot8_f32<D>(dp, drow, vs, sub);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = k0 + sub + 8 * j;
      const float p = span.has(col) ? expf(s[j] * scale - st.x) * st.y : 0.f;
      dl += p * dp[j];
    }
  }
  dl += __shfl_xor_sync(0xffffffffu, dl, 1);
  dl += __shfl_xor_sync(0xffffffffu, dl, 2);
  dl += __shfl_xor_sync(0xffffffffu, dl, 4);

  // sweep 2: ds into shared memory, then dq += ds . k
  constexpr int kVec = D / 32;
  float4 acc[kVec];
#pragma unroll
  for (int jj = 0; jj < kVec; ++jj) acc[jj] = make_float4(0.f, 0.f, 0.f, 0.f);
  float* dsrow = dss + r * (kKTile + kPad);
  for (int k0 = 0; k0 < n_keys; k0 += kKTile) {
    __syncthreads();  // the previous tiles and ds are consumed
    load_tile_f32<D>(ks, k + base, k0, kKTile, n, stride);
    load_tile_f32<D>(vs, v + base, k0, kKTile, n, stride);
    __syncthreads();
    float s[8], dp[8];
    dot8_f32<D>(s, qrow, ks, sub);
    dot8_f32<D>(dp, drow, vs, sub);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = k0 + sub + 8 * j;
      const float p = span.has(col) ? expf(s[j] * scale - st.x) * st.y : 0.f;
      dsrow[sub + 8 * j] = p * (dp[j] - dl) * scale;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kKTile; ++c) {
      const float d = dsrow[c];
      const float4* krow = reinterpret_cast<const float4*>(ks + c * (D + kPad));
#pragma unroll
      for (int jj = 0; jj < kVec; ++jj) {
        const float4 kv = krow[sub + 8 * jj];
        acc[jj].x = fmaf(d, kv.x, acc[jj].x);
        acc[jj].y = fmaf(d, kv.y, acc[jj].y);
        acc[jj].z = fmaf(d, kv.z, acc[jj].z);
        acc[jj].w = fmaf(d, kv.w, acc[jj].w);
      }
    }
  }
  if (i < n) {
    float4* out = reinterpret_cast<float4*>(dq + base + (size_t)i * stride);
#pragma unroll
    for (int jj = 0; jj < kVec; ++jj) out[sub + 8 * jj] = acc[jj];
    if (sub == 0) delta[srow + i] = dl;
  }
}

// grid (ceil(n / kRows32), heads, batch), kThreads threads. Thread (r, sub)
// owns key row r of the block, transposed score columns sub + 8j of each
// query tile and dk/dv columns 4 * (sub + 8jj) .. + 3.
template <int D, bool kHeadMajor>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dkv_f32_kernel(const float* __restrict__ q,
                                     const float* __restrict__ k,
                                     const float* __restrict__ v,
                                     const float* __restrict__ dout,
                                     const float2* __restrict__ stats,
                                     const float* __restrict__ delta,
                                     float* __restrict__ dk, float* __restrict__ dv,
                                     int n, int heads, float scale, int block_size) {
  static_assert(D % 32 == 0, "head_dim must be a multiple of 32");
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [kRows32][D + kPad]
  float* vs = ks + kRows32 * (D + kPad);        // [kRows32][D + kPad]
  float* qs = vs + kRows32 * (D + kPad);        // [kKTile][D + kPad]
  float* dos = qs + kKTile * (D + kPad);        // [kKTile][D + kPad]
  float* ps = dos + kKTile * (D + kPad);        // [kRows32][kKTile + kPad] p^T
  float* dss = ps + kRows32 * (kKTile + kPad);  // [kRows32][kKTile + kPad] ds^T
  float* ms = dss + kRows32 * (kKTile + kPad);  // [kKTile] m
  float* ils = ms + kKTile;                     // [kKTile] 1/l
  float* dls = ils + kKTile;                    // [kKTile] delta

  const int n_keys = round_up(n, kKTile);
  const int key0 = blockIdx.x * kRows32;
  const int h = blockIdx.y, b = blockIdx.z;
  const HeadRows rows = head_rows<kHeadMajor, D>(b, h, n, heads);
  const size_t base = rows.base;
  const int stride = rows.stride;
  const size_t srow = ((size_t)b * heads + h) * n_keys;
  const int tid = threadIdx.x, r = tid >> 3, sub = tid & 7;
  const int key = key0 + r;
  const Span span = key_span(key, n, block_size);  // the queries attending it

  load_tile_f32<D>(ks, k + base, key0, kRows32, n, stride);
  load_tile_f32<D>(vs, v + base, key0, kRows32, n, stride);
  const float* krow = ks + r * (D + kPad);
  const float* vrow = vs + r * (D + kPad);
  float* prow = ps + r * (kKTile + kPad);
  float* dsrow = dss + r * (kKTile + kPad);

  constexpr int kVec = D / 32;
  float4 dk_acc[kVec], dv_acc[kVec];
#pragma unroll
  for (int jj = 0; jj < kVec; ++jj) {
    dk_acc[jj] = make_float4(0.f, 0.f, 0.f, 0.f);
    dv_acc[jj] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int q0 = 0; q0 < n_keys; q0 += kKTile) {
    __syncthreads();  // K and V are in; the previous tiles are consumed
    load_tile_f32<D>(qs, q + base, q0, kKTile, n, stride);
    load_tile_f32<D>(dos, dout + base, q0, kKTile, n, stride);
    if (tid < kKTile) {
      const float2 st = stats[srow + q0 + tid];
      ms[tid] = st.x;
      ils[tid] = st.y;
      dls[tid] = delta[srow + q0 + tid];
    }
    __syncthreads();
    float s[8], dp[8];
    dot8_f32<D>(s, krow, qs, sub);   // S^T = K . Q^T
    dot8_f32<D>(dp, vrow, dos, sub);  // dP^T = V . dO^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int lc = sub + 8 * j, query = q0 + lc;
      const float p = span.has(query) ? expf(s[j] * scale - ms[lc]) * ils[lc] : 0.f;
      prow[lc] = p;
      dsrow[lc] = p * (dp[j] - dls[lc]) * scale;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kKTile; ++c) {
      const float pv = prow[c], dsv = dsrow[c];
      const float4* dorow = reinterpret_cast<const float4*>(dos + c * (D + kPad));
      const float4* qrow = reinterpret_cast<const float4*>(qs + c * (D + kPad));
#pragma unroll
      for (int jj = 0; jj < kVec; ++jj) {
        const float4 o = dorow[sub + 8 * jj], x = qrow[sub + 8 * jj];
        dv_acc[jj].x = fmaf(pv, o.x, dv_acc[jj].x);
        dv_acc[jj].y = fmaf(pv, o.y, dv_acc[jj].y);
        dv_acc[jj].z = fmaf(pv, o.z, dv_acc[jj].z);
        dv_acc[jj].w = fmaf(pv, o.w, dv_acc[jj].w);
        dk_acc[jj].x = fmaf(dsv, x.x, dk_acc[jj].x);
        dk_acc[jj].y = fmaf(dsv, x.y, dk_acc[jj].y);
        dk_acc[jj].z = fmaf(dsv, x.z, dk_acc[jj].z);
        dk_acc[jj].w = fmaf(dsv, x.w, dk_acc[jj].w);
      }
    }
  }
  if (key < n) {
    float4* dko = reinterpret_cast<float4*>(dk + base + (size_t)key * stride);
    float4* dvo = reinterpret_cast<float4*>(dv + base + (size_t)key * stride);
#pragma unroll
    for (int jj = 0; jj < kVec; ++jj) {
      dko[sub + 8 * jj] = dk_acc[jj];
      dvo[sub + 8 * jj] = dv_acc[jj];
    }
  }
}

// ---------------------------------------------------------------------------
// launch

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int D, bool kHeadMajor>
cudaError_t bwd_launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* stats, void* dq, void* dk, void* dv, void* delta,
                   int batch, int n, int heads, int is_bf16, float scale,
                   int block_size, cudaStream_t stream) {
  const float2* st = static_cast<const float2*>(stats);
  float* dl = static_cast<float*>(delta);
  cudaError_t err;
  if (is_bf16) {
    const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
               *vb = static_cast<const bf16*>(v), *db = static_cast<const bf16*>(dout);
    const dim3 grid((n + kRows16 - 1) / kRows16, heads, batch);
    constexpr size_t smem_dq = smem_bytes_dq_bf16<D>();
    auto dq_kernel = block_size ? &attention_bwd_dq_bf16_kernel<D, true, kHeadMajor>
                                : &attention_bwd_dq_bf16_kernel<D, false, kHeadMajor>;
    if ((err = set_smem(dq_kernel, smem_dq)) != cudaSuccess) return err;
    dq_kernel<<<grid, 32 * kWarps16, smem_dq, stream>>>(
        qb, kb, vb, db, st, static_cast<bf16*>(dq), dl, n, heads, scale, block_size);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    constexpr size_t smem_dkv = smem_bytes_dkv_bf16<D>();
    auto dkv_kernel = attention_bwd_dkv_bf16_kernel<D, kHeadMajor>;
    if ((err = set_smem(dkv_kernel, smem_dkv)) != cudaSuccess) return err;
    dkv_kernel<<<grid, 32 * kWarps16, smem_dkv, stream>>>(
        qb, kb, vb, db, st, dl, static_cast<bf16*>(dk), static_cast<bf16*>(dv), n,
        heads, scale, block_size);
    return cudaGetLastError();
  }
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v), *df = static_cast<const float*>(dout);
  const dim3 grid((n + kRows32 - 1) / kRows32, heads, batch);
  constexpr size_t smem_dq = smem_bytes_dq_f32<D>();
  auto dq_kernel = attention_bwd_dq_f32_kernel<D, kHeadMajor>;
  if ((err = set_smem(dq_kernel, smem_dq)) != cudaSuccess) return err;
  dq_kernel<<<grid, kThreads, smem_dq, stream>>>(
      qf, kf, vf, df, st, static_cast<float*>(dq), dl, n, heads, scale, block_size);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  constexpr size_t smem_dkv = smem_bytes_dkv_f32<D>();
  auto dkv_kernel = attention_bwd_dkv_f32_kernel<D, kHeadMajor>;
  if ((err = set_smem(dkv_kernel, smem_dkv)) != cudaSuccess) return err;
  dkv_kernel<<<grid, kThreads, smem_dkv, stream>>>(
      qf, kf, vf, df, st, dl, static_cast<float*>(dk), static_cast<float*>(dv), n,
      heads, scale, block_size);
  return cudaGetLastError();
}

// Checks the sizes, then launches for the head dim; returns the first
// non-zero cudaError_t (0 = both kernels launched).
template <bool kHeadMajor>
int bwd_dispatch(const void* q, const void* k, const void* v, const void* dout,
                 const void* stats, void* dq, void* dk, void* dv, void* delta,
                 int batch, int n, int heads, int head_dim, int is_bf16, float scale,
                 int block_size, void* stream) {
  if (n < 1 || n > kMaxSeq || batch < 1 || heads < 1 || block_size < 0 ||
      batch > 65535 || heads > 65535 || stats == nullptr || delta == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return (int)bwd_launch<32, kHeadMajor>(q, k, v, dout, stats, dq, dk, dv, delta,
                                             batch, n, heads, is_bf16, scale,
                                             block_size, s);
    case 64:
      return (int)bwd_launch<64, kHeadMajor>(q, k, v, dout, stats, dq, dk, dv, delta,
                                             batch, n, heads, is_bf16, scale,
                                             block_size, s);
    case 128:
      return (int)bwd_launch<128, kHeadMajor>(q, k, v, dout, stats, dq, dk, dv, delta,
                                              batch, n, heads, is_bf16, scale,
                                              block_size, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
