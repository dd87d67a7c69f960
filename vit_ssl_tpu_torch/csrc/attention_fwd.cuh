// The attention forward of kernels B1 and B3, inference and training, for
// Hopper (sm_90a): the kernel bodies, templated on the layout
// (kHeadMajor, attention_nhd_common.cuh::head_rows). attention_nhd_fwd.cu
// instantiates them for B1's (B, N, H*D) layout, fused_attention.cu for
// B3's (B, H, N, D) layout; the C entry points live there. Per head:
//
//   s  = (q_h . k_h^T) * scale            fp32 products and sums
//   s  = -inf where i/bs != j/bs          only when block_size > 0 (B1)
//   p  = exp(s - rowmax(s)) ; l = rowsum(p)   fp32
//   pn = (p / l) cast to the input dtype  normalise, THEN round
//   o  = pn . v_h                         fp32 accumulation, cast on store
//
// Keys at or past n are never kept (the TPU kernels pad N and set the
// padded keys to -inf; here the ragged edge is masked in the kernel and
// nothing is padded in memory).
//
// Softmax statistics (training entries): stats is fp32 (B, H, Np, 2) with
// Np = round_up(N, 64); [b, h, i] holds (m, 1/l), m the row max of the
// scaled, masked scores and l the row sum of exp(s - m). The backward
// (attention_bwd.cuh) recomputes the scores with the same instructions and
// rebuilds, from (m, 1/l), the very bf16 pn that this kernel fed to P.V.
// Rows at or past N are not written: the caller zero-fills stats, and
// (m, 1/l) = (0, 0) makes those rows' probabilities zero. With and without
// statistics the kernel is the same, and so is its output, bit for bit.
//
// How the design answers a bytes bound: the (N, N) scores never leave the
// chip (the TPU kernels' training calls write them out; this one writes 8
// bytes a row instead), each block reads its Q rows once and writes its O
// rows once, and the query tiles of one (b, h) run side by side, so their
// re-reads of K and V can come from L2 rather than device memory. Two
// kernels:
//
// - bfloat16: tensor cores through mma.sync m16n8k16 with fp32
//   accumulation. One block of 4 warps owns 64 query rows of one (b, h),
//   16 rows a warp, its Q fragments held in registers. K and V stream
//   through 64-row shared tiles, copied with cp.async into two buffers: the
//   next tile's copies are in flight while this one computes. Pass 1
//   computes each score tile and keeps the running row max and the
//   rescaled row sum; pass 2 recomputes the scores, forms
//   p = exp(s - max) * (1 / sum), rounds it to bf16 in registers (where the
//   reference rounds it) and feeds it straight to the P.V product as the A
//   operand. K's B fragments come from ldmatrix, V's from ldmatrix.trans;
//   neither pass writes scores anywhere. exp(s - m) is
//   2^(s log2e - m log2e) on the special-function unit and the division a
//   reciprocal multiply: each within a few fp32 ulps of the reference, far
//   below the bf16 rounding that follows. The block-diagonal mask is a key
//   span [lo, hi) per row (two compares a score, no division); key tiles
//   outside the span of a warp's 16 rows, which include the tiles past n,
//   and warps whose rows all lie past n skip their arithmetic.
// - float32: the products must stay full fp32 (TF32 would miss the 1e-5
//   tolerance), so they run on the CUDA cores. One block of 8 warps owns
//   32 query rows, keeps their fp32 score rows (N <= 1024) in shared
//   memory, streams K and then V through a 64-row shared tile, and does
//   the softmax between the two passes.
//
// kernels.py rebuilds a library when this header is newer than it.

#pragma once

#include "attention_nhd_common.cuh"

namespace {

// One warp's 16 x kKTile scores: s[j] is the 16x8 tile of keys k0 + 8j ..,
// scaled and masked. Lane (g, t) holds rows g and g + 8 (key spans lo, hi),
// columns 2t, 2t + 1. Tiles outside the warp's key span are skipped (-inf),
// so a ragged last tile costs only its live 8-key columns and a masked
// one only the columns of the warp's diagonal blocks; a whole tile with no
// mask skips the mask test.
template <int D>
__device__ __forceinline__ void score_tile(float (&s)[kKTile / 8][4],
                                           const uint32_t (&qa)[D / 16][4],
                                           const bf16* ks, int k0, Span lo,
                                           Span hi, Span warp_keys, int n,
                                           float scale, int block_size) {
  const int t = threadIdx.x & 3;
  const bool unmasked = block_size == 0 && k0 + kKTile <= n;  // uniform
#pragma unroll
  for (int j = 0; j < kKTile / 8; ++j) {
    if (!warp_keys.meets(k0 + 8 * j, 8)) {  // uniform across the warp
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = -INFINITY;
      continue;
    }
    mma_abt8<D>(s[j], qa, ks + 8 * j * (D + kBPad));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + 8 * j + 2 * t + (e & 1);
      s[j][e] = unmasked || (e >> 1 ? hi : lo).has(col) ? s[j][e] * scale
                                                         : -INFINITY;
    }
  }
}

template <int D>
constexpr size_t smem_bytes_bf16() {  // K and V, two buffers each
  return 4 * sizeof(bf16) * kKTile * (D + kBPad);
}

// grid (ceil(n / kRows16), heads, batch), 32 * kWarps16 threads,
// smem_bytes_bf16<D>() of dynamic shared memory. stats may be null.
//
// The block walks 2T tile jobs, T = ceil(n / kKTile): K tiles 0 .. T-1
// (pass 1), then K and V tiles 0 .. T-1 (pass 2). Job i + 1's copies are in
// flight while job i computes, in the other of two buffers.
template <int D, bool kHeadMajor>
__global__ void __launch_bounds__(32 * kWarps16)
    attention_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, bf16* __restrict__ o,
                              float2* __restrict__ stats, int n, int heads,
                              float scale, int block_size) {
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
  const int row_lo = blockIdx.x * kRows16 + 16 * warp + g;  // and row_lo + 8
  const int row_hi = row_lo + 8;
  // A warp whose 16 rows all lie past n only helps load the tiles.
  const bool active = blockIdx.x * kRows16 + 16 * warp < n;
  const int tiles = (n + kKTile - 1) / kKTile;
  const Span span_lo = key_span(row_lo, n, block_size);
  const Span span_hi = key_span(row_hi, n, block_size);
  const Span warp_keys = warp_key_span(blockIdx.x * kRows16 + 16 * warp, n, block_size);

  // job j's copies into buffer j & 1, committed as one group
  auto start_copies = [&](int job) {
    const int buf = job & 1, k0 = (job % tiles) * kKTile;
    load_tile_bf16<D>(ks + buf * kTileElems, k + base, k0, n, stride);
    if (job >= tiles) load_tile_bf16<D>(vs + buf * kTileElems, v + base, k0, n, stride);
    cp_async_commit();
  };
  start_copies(0);

  // This warp's Q rows as mma A fragments, loaded once; rows past n are 0.
  uint32_t qa[D / 16][4];
  load_a_frags<D>(qa, q + base, row_lo, n, stride);

  // Pass 1: row max and row sum over all key tiles. Each lane keeps the sum
  // of its own columns, rescaled whenever the (quad-wide) row max grows.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float s[kKTile / 8][4];
  for (int job = 0; job < tiles; ++job) {
    start_copies(job + 1);  // the next K tile, or pass 2's first K and V tiles
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = job * kKTile;
    if (active) {
      score_tile<D>(s, qa, ks + (job & 1) * kTileElems, k0, span_lo, span_hi,
                    warp_keys, n, scale, block_size);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float tile_max = -INFINITY;
#pragma unroll
        for (int j = 0; j < kKTile / 8; ++j)
          tile_max = fmaxf(tile_max, fmaxf(s[j][2 * half], s[j][2 * half + 1]));
        const float m_new = fmaxf(m[half], quad_max(tile_max));
        if (m_new == -INFINITY) continue;  // nothing kept in this row yet
        const float ml = m_new * kLog2e;  // exp(s - m) = 2^(s log2e - m log2e)
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kKTile / 8; ++j)
          if (warp_keys.meets(k0 + 8 * j, 8))
            sum += exp2_approx(fmaf(s[j][2 * half], kLog2e, -ml)) +
                   exp2_approx(fmaf(s[j][2 * half + 1], kLog2e, -ml));
        l[half] = l[half] * exp2_approx((m[half] - m_new) * kLog2e) + sum;
        m[half] = m_new;
      }
    }
    __syncthreads();  // buffer job & 1 is free for job + 2
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] = 1.f / quad_sum(l[half]);  // from here on, the reciprocal
    if (m[half] == -INFINITY) {  // a padded row with nothing kept: p = 0
      m[half] = 0.f;
      l[half] = 1.f;
    }
  }
  if (stats != nullptr && active && t == 0) {
    const size_t srow = ((size_t)b * heads + h) * round_up(n, kKTile);
    if (row_lo < n) stats[srow + row_lo] = make_float2(m[0], l[0]);
    if (row_hi < n) stats[srow + row_hi] = make_float2(m[1], l[1]);
  }
  m[0] *= kLog2e;  // from here on, the max times log2 e
  m[1] *= kLog2e;

  // Pass 2: the same scores again, p = exp(s - m) * (1 / l) rounded to bf16
  // in registers, then o += p . v with V's fragments from ldmatrix.trans.
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  for (int job = tiles; job < 2 * tiles; ++job) {
    if (job + 1 < 2 * tiles) {
      start_copies(job + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = (job - tiles) * kKTile;
    if (active) {
      const bf16* vt = vs + (job & 1) * kTileElems;
      score_tile<D>(s, qa, ks + (job & 1) * kTileElems, k0, span_lo, span_hi,
                    warp_keys, n, scale, block_size);
#pragma unroll
      for (int kk = 0; kk < kKTile / 16; ++kk) {  // 16 keys: score tiles 2kk, 2kk+1
        // p is exactly 0 outside the warp's key span: no product to add
        if (!warp_keys.meets(k0 + 16 * kk, 16)) continue;  // uniform
        uint32_t pa[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* sj = s[2 * kk + (e >> 1)];
          const int half = e & 1;
          pa[e] = pack_bf16(exp2_approx(fmaf(sj[2 * half], kLog2e, -m[half])) * l[half],
                            exp2_approx(fmaf(sj[2 * half + 1], kLog2e, -m[half])) * l[half]);
        }
        mma_ab16<D>(acc, pa, vt + 16 * kk * (D + kBPad));
      }
    }
    __syncthreads();  // buffer job & 1 is free for job + 2
  }

  store_rows_bf16<D>(o + base, acc, row_lo, n, stride);
}

// ---------------------------------------------------------------------------
// float32: CUDA cores

constexpr int kQTile = 32;  // query rows per block

static_assert(kThreads == kQTile * 8, "8 threads per query row");

template <int D>
size_t smem_bytes_f32(int n) {
  return sizeof(float) * ((size_t)(kQTile + kKTile) * (D + kPad) +
                          (size_t)kQTile * (round_up(n, kKTile) + kPad));
}

// grid (ceil(n / kQTile), heads, batch), kThreads threads. stats may be null.
template <int D, bool kHeadMajor>
__global__ void __launch_bounds__(kThreads)
    attention_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, float* __restrict__ o,
                             float2* __restrict__ stats, int n, int heads,
                             float scale, int block_size) {
  static_assert(D % 32 == 0, "head_dim must be a multiple of 32");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n_keys = round_up(n, kKTile);
  const int s_stride = n_keys + kPad;
  float* qs = smem;                      // [kQTile][D + kPad]
  float* kv = qs + kQTile * (D + kPad);  // [kKTile][D + kPad], K then V
  float* s = kv + kKTile * (D + kPad);   // [kQTile][s_stride] scores / probs

  const int q0 = blockIdx.x * kQTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const HeadRows rows = head_rows<kHeadMajor, D>(b, h, n, heads);
  const size_t base = rows.base;
  const int stride = rows.stride;
  const int t = threadIdx.x;
  const int r = t >> 3;    // this thread's query row in the tile
  const int sub = t & 7;   // its lane among the row's 8 threads
  const int i = q0 + r;    // global query index
  const Span span = key_span(i, n, block_size);

  load_tile_f32<D>(qs, q + base, q0, kQTile, n, stride);

  // Pass 1: scores. Thread (r, sub) owns columns sub + 8j of each key tile;
  // the 8 key rows a quarter-warp reads are 4 banks apart (no conflicts).
  const float* qrow = qs + r * (D + kPad);
  for (int k0 = 0; k0 < n_keys; k0 += kKTile) {
    __syncthreads();  // the Q tile is in; the previous K tile is consumed
    load_tile_f32<D>(kv, k + base, k0, kKTile, n, stride);
    __syncthreads();
    float acc[8];
    dot8_f32<D>(acc, qrow, kv, sub);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = k0 + sub + 8 * j;
      s[r * s_stride + col] = span.has(col) ? acc[j] * scale : -INFINITY;
    }
  }
  __syncthreads();

  // Pass 2: softmax, one warp per row, normalised in place. Padded query
  // rows (i >= n) get p = 0; their output is never stored.
  {
    const int warp = t >> 5, lane = t & 31;
    for (int row = warp; row < kQTile; row += kThreads / 32) {
      float* sr = s + row * s_stride;
      if (q0 + row >= n) {
        for (int c = lane; c < n_keys; c += 32) sr[c] = 0.f;
        continue;
      }
      float m = -INFINITY;
      for (int c = lane; c < n_keys; c += 32) m = fmaxf(m, sr[c]);
      m = warp_max(m);  // finite: column i is always kept
      float l = 0.f;
      for (int c = lane; c < n_keys; c += 32) {
        const float e = expf(sr[c] - m);
        sr[c] = e;
        l += e;
      }
      l = warp_sum(l);
      for (int c = lane; c < n_keys; c += 32) sr[c] /= l;
      if (stats != nullptr && lane == 0)
        stats[((size_t)b * heads + h) * n_keys + q0 + row] = make_float2(m, 1.f / l);
    }
  }

  // Pass 3: o = p . v. Thread (r, sub) owns output columns 4*(sub + 8jj)
  // .. +3; a quarter-warp reads 128 contiguous bytes of one V row.
  constexpr int kVec = D / 32;
  float4 acc[kVec];
#pragma unroll
  for (int jj = 0; jj < kVec; ++jj) acc[jj] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* prow = s + r * s_stride;
  for (int k0 = 0; k0 < n_keys; k0 += kKTile) {
    __syncthreads();  // softmax done; the previous V tile is consumed
    load_tile_f32<D>(kv, v + base, k0, kKTile, n, stride);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kKTile; ++c) {
      const float p = prow[k0 + c];
      const float4* vrow = reinterpret_cast<const float4*>(kv + c * (D + kPad));
#pragma unroll
      for (int jj = 0; jj < kVec; ++jj) {
        const float4 vv = vrow[sub + 8 * jj];
        acc[jj].x = fmaf(p, vv.x, acc[jj].x);
        acc[jj].y = fmaf(p, vv.y, acc[jj].y);
        acc[jj].z = fmaf(p, vv.z, acc[jj].z);
        acc[jj].w = fmaf(p, vv.w, acc[jj].w);
      }
    }
  }
  if (i < n) {
    float4* orow = reinterpret_cast<float4*>(o + base + (size_t)i * stride);
#pragma unroll
    for (int jj = 0; jj < kVec; ++jj) orow[sub + 8 * jj] = acc[jj];
  }
}

// ---------------------------------------------------------------------------
// launch

template <int D, bool kHeadMajor>
cudaError_t fwd_launch(const void* q, const void* k, const void* v, void* o,
                       void* stats, int batch, int n, int heads, int is_bf16,
                       float scale, int block_size, cudaStream_t stream) {
  float2* st = static_cast<float2*>(stats);
  if (is_bf16) {
    constexpr size_t smem = smem_bytes_bf16<D>();
    auto kernel = attention_fwd_bf16_kernel<D, kHeadMajor>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((n + kRows16 - 1) / kRows16, heads, batch);
    kernel<<<grid, 32 * kWarps16, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), st, n, heads, scale,
        block_size);
    return cudaGetLastError();
  }
  const size_t smem = smem_bytes_f32<D>(n);
  auto kernel = attention_fwd_f32_kernel<D, kHeadMajor>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kQTile - 1) / kQTile, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), st, n, heads, scale,
      block_size);
  return cudaGetLastError();
}

// Checks the sizes, then launches for the head dim; returns a cudaError_t.
template <bool kHeadMajor>
int fwd_dispatch(const void* q, const void* k, const void* v, void* o, void* stats,
                 int batch, int n, int heads, int head_dim, int is_bf16, float scale,
                 int block_size, void* stream) {
  if (n < 1 || n > kMaxSeq || batch < 1 || heads < 1 || block_size < 0 ||
      batch > 65535 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return (int)fwd_launch<32, kHeadMajor>(q, k, v, o, stats, batch, n, heads, is_bf16,
                                             scale, block_size, s);
    case 64:
      return (int)fwd_launch<64, kHeadMajor>(q, k, v, o, stats, batch, n, heads, is_bf16,
                                             scale, block_size, s);
    case 128:
      return (int)fwd_launch<128, kHeadMajor>(q, k, v, o, stats, batch, n, heads, is_bf16,
                                              scale, block_size, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
