// Blockwise flash attention backward on the head-major (B, H, N, D) layout,
// for Hopper (sm_90a): kernel B2's two backward kernels.
//
// Replaces the TPU kernels vit_ssl_tpu/ops/flash_blockwise.py::_dq_kernel
// (C entry blockwise_bwd_dq) and ::_dkv_kernel (C entry blockwise_bwd_dkv),
// both called by _flash_bwd. From the forward's o and lse (fp32 (B, H, N)),
// with JAX's rounding points:
//
//   delta = rowsum(do . o) - dlse            fp32 (dlse: the lse output's
//                                           cotangent, 0 when not given)
//   p     = exp(s - lse), s = q . k^T * scale   fp32, keys past n give 0
//   dv    = p.astype(do.dtype)^T . do        fp32 accumulation
//   dp    = do . v^T                         fp32
//   ds    = (p * (dp - delta) * scale).astype(q.dtype)
//   dq    = ds . k ; dk = ds^T . q           fp32 accumulation
//
// each result cast to the input dtype on store; do arrives already cast to
// the input dtype. The dq kernel runs first: it also computes delta for its
// rows (JAX computes it with a jnp reduction outside its kernels) and
// writes it for the dk/dv kernel. No gradient needs atomics, so the results
// repeat bit for bit.
//
// - dq kernel: one block per (b, h, 64-query tile), 4 warps of 16 rows, Q
//   and dO fragments in registers; one sweep over the key tiles (K and V
//   through two cp.async buffers) forms ds and accumulates dq += ds . k.
// - dk/dv kernel: one block per (b, h, 64-key tile), 4 warps of 16 keys, K
//   and V fragments in registers; one sweep over the query tiles (Q, dO,
//   lse and delta through two buffers) computes the transposed scores
//   S^T = K . Q^T and dP^T = V . dO^T, so that p^T and ds^T land in the
//   accumulator layout that mma.sync takes as its A operand: dv += p^T . do
//   and dk += ds^T . q in fp32 registers.
//
// bfloat16 runs on the tensor cores (mma.sync m16n8k16, ldmatrix), 16
// queries or keys at a time, and rebuilds p with one ex2.approx (log2 e
// folded into the scale): within a few fp32 ulps, below the bf16 rounding
// of p and ds that follows. float32 keeps full fp32 products on the CUDA
// cores and the accurate expf (TF32 would miss the fp32 tolerance), 32 rows
// a block of 8 warps, 8 threads a row. Tiles past n are skipped, the
// ragged edge masked; nothing is padded in memory (the TPU kernels pad N to
// their block and pad lse with +inf).
//
// What bounds it on an H100 SXM, at ViT-B/16's (64, 12, 1025, 64) bf16
// (100.8 MB a tensor, 103.3 GFLOP a product): q, k, v, o, do read and dq,
// dk, dv written, 806 MB plus 6.3 MB of lse and delta, 0.243 ms; the five
// products (the scores twice, dp twice, dv, dq, dk: seven in the two
// kernels, five in the function) 0.522 ms: operations bound it. The design
// recomputes the scores and dp in both kernels instead of writing p or ds
// to memory (2 bytes a score would be 1.6 GB, 0.48 ms each way).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (vit_ssl_tpu_torch/kernels.py); called through
// ctypes from vit_ssl_tpu_torch/ops/flash_blockwise.py.

#include "attention_nhd_common.cuh"

namespace {

// 4 bytes from global to shared memory; with pred false nothing is read and
// the 4 bytes are zero.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(addr), "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ float bf16_dot8(uint4 a, uint4 b) {  // 8 products, in order
  const uint32_t* x = reinterpret_cast<const uint32_t*>(&a);
  const uint32_t* y = reinterpret_cast<const uint32_t*>(&b);
  float d = 0.f;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    d = fmaf(bf16_lo(x[w]), bf16_lo(y[w]), d);
    d = fmaf(bf16_hi(x[w]), bf16_hi(y[w]), d);
  }
  return d;
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores

template <int D>
constexpr size_t dq_smem_bf16() {  // K and V, two buffers each; the block's delta
  return 4 * sizeof(bf16) * kKTile * (D + kBPad) + kRows16 * sizeof(float);
}

template <int D>
constexpr size_t dkv_smem_bf16() {  // Q and dO, two buffers each; lse and delta, two each
  return 4 * sizeof(bf16) * kKTile * (D + kBPad) + 4 * kKTile * sizeof(float);
}

// grid (ceil(n / kRows16), heads, batch), 32 * kWarps16 threads,
// dq_smem_bf16<D>() of dynamic shared memory. dlse may be null.
template <int D>
__global__ void __launch_bounds__(32 * kWarps16)
    blockwise_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ o,
                             const bf16* __restrict__ dout, const float* __restrict__ lse,
                             const float* __restrict__ dlse, bf16* __restrict__ dq,
                             float* __restrict__ delta, int n, float scale) {
  static_assert(D % 32 == 0, "head_dim must be a multiple of 32");
  constexpr int kTileElems = kKTile * (D + kBPad);
  extern __shared__ uint4 smem_bf16[];
  bf16* ks = reinterpret_cast<bf16*>(smem_bf16);                // [2][kKTile][D + kBPad]
  bf16* vs = ks + 2 * kTileElems;                               // [2][kKTile][D + kBPad]
  float* dls = reinterpret_cast<float*>(vs + 2 * kTileElems);  // [kRows16] delta

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const size_t base = bh * n * D;
  const int block0 = blockIdx.x * kRows16;
  const int row0 = block0 + 16 * warp;
  const int row_lo = row0 + g, row_hi = row_lo + 8;
  const bool active = row0 < n;
  const int tiles = (n + kKTile - 1) / kKTile;

  auto start_copies = [&](int tile) {
    const int buf = tile & 1, k0 = tile * kKTile;
    load_tile_bf16<D>(ks + buf * kTileElems, k + base, k0, n, D);
    load_tile_bf16<D>(vs + buf * kTileElems, v + base, k0, n, D);
    cp_async_commit();
  };
  start_copies(0);

  // delta of the block's 64 rows: two threads a row, half the head dim each
  {
    const int r = threadIdx.x >> 1, part = threadIdx.x & 1, row = block0 + r;
    float d = 0.f;
    if (row < n) {
      const size_t at = base + (size_t)row * D + part * (D / 2);
      const uint4* a = reinterpret_cast<const uint4*>(dout + at);
      const uint4* b = reinterpret_cast<const uint4*>(o + at);
#pragma unroll
      for (int c = 0; c < D / 16; ++c) d += bf16_dot8(a[c], b[c]);
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (row < n && dlse != nullptr) d -= dlse[bh * n + row];
    if (part == 0) {
      dls[r] = d;
      if (row < n) delta[bh * n + row] = d;
    }
  }

  uint32_t qa[D / 16][4], da[D / 16][4];  // this warp's Q and dO rows
  load_a_frags<D>(qa, q + base, row_lo, n, D);
  load_a_frags<D>(da, dout + base, row_lo, n, D);
  __syncthreads();  // dls is in
  // lse * log2 e of rows row_lo, row_hi (+inf past n: p = 0), and delta
  const float ll[2] = {row_lo < n ? lse[bh * n + row_lo] * kLog2e : INFINITY,
                       row_hi < n ? lse[bh * n + row_hi] * kLog2e : INFINITY};
  const float dl[2] = {dls[16 * warp + g], dls[16 * warp + g + 8]};
  const float sl = scale * kLog2e;

  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  for (int tile = 0; tile < tiles; ++tile) {
    if (tile + 1 < tiles) {
      start_copies(tile + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = tile * kKTile;
    if (active) {
      const bf16* kt = ks + (tile & 1) * kTileElems;
      const bf16* vt = vs + (tile & 1) * kTileElems;
      const bool whole = k0 + kKTile <= n;  // uniform
#pragma unroll
      for (int kk = 0; kk < kKTile / 16; ++kk) {  // 16 keys: score tiles 2kk, 2kk+1
        if (k0 + 16 * kk >= n) continue;  // uniform: p = 0
        float p[2][4], dp[2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * kk + jj;
          if (k0 + 8 * j >= n) {  // uniform: p = 0
            p[jj][0] = p[jj][1] = p[jj][2] = p[jj][3] = 0.f;
            dp[jj][0] = dp[jj][1] = dp[jj][2] = dp[jj][3] = 0.f;
            continue;
          }
          float s[4];
          mma_abt8<D>(s, qa, kt + 8 * j * (D + kBPad));
          mma_abt8<D>(dp[jj], da, vt + 8 * j * (D + kBPad));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + 8 * j + 2 * t + (e & 1);
            p[jj][e] = whole || col < n ? exp2_approx(fmaf(s[e], sl, -ll[e >> 1])) : 0.f;
          }
        }
        // ds rounded to bf16 as an A fragment: register r holds tile r >> 1,
        // row half r & 1
        uint32_t dsa[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int jj = r >> 1, half = r & 1;
          dsa[r] = pack_bf16(p[jj][2 * half] * (dp[jj][2 * half] - dl[half]) * scale,
                             p[jj][2 * half + 1] * (dp[jj][2 * half + 1] - dl[half]) * scale);
        }
        mma_ab16<D>(acc, dsa, kt + 16 * kk * (D + kBPad));
      }
    }
    __syncthreads();  // buffer tile & 1 is free for tile + 2
  }
  store_rows_bf16<D>(dq + base, acc, row_lo, n, D);
}

// grid (ceil(n / kRows16), heads, batch), 32 * kWarps16 threads,
// dkv_smem_bf16<D>() of dynamic shared memory. Block x owns keys
// 64x .. 64x + 63, warp w keys 16w .. 16w + 15 of them.
template <int D>
__global__ void __launch_bounds__(32 * kWarps16)
    blockwise_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              bf16* __restrict__ dk, bf16* __restrict__ dv, int n,
                              float scale) {
  static_assert(D % 32 == 0, "head_dim must be a multiple of 32");
  constexpr int kTileElems = kKTile * (D + kBPad);
  extern __shared__ uint4 smem_bf16[];
  bf16* qs = reinterpret_cast<bf16*>(smem_bf16);                // [2][kKTile][D + kBPad]
  bf16* dos = qs + 2 * kTileElems;                              // [2][kKTile][D + kBPad]
  float* lss = reinterpret_cast<float*>(dos + 2 * kTileElems);  // [2][kKTile] lse
  float* dls = lss + 2 * kKTile;                                // [2][kKTile] delta

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const size_t base = bh * n * D;
  const int key0 = blockIdx.x * kRows16 + 16 * warp;
  const int key_lo = key0 + g;  // and key_lo + 8
  const bool active = key0 < n;
  const int tiles = (n + kKTile - 1) / kKTile;

  auto start_copies = [&](int tile) {
    const int buf = tile & 1, q0 = tile * kKTile;
    load_tile_bf16<D>(qs + buf * kTileElems, q + base, q0, n, D);
    load_tile_bf16<D>(dos + buf * kTileElems, dout + base, q0, n, D);
    // the tile's 64 lse and 64 delta values, 4 bytes a thread; zero past n
    const int x = threadIdx.x & (kKTile - 1), row = q0 + x;
    const float* src = threadIdx.x < kKTile ? lse : delta;
    float* dst = (threadIdx.x < kKTile ? lss : dls) + buf * kKTile + x;
    cp_async4(dst, row < n ? src + bh * n + row : src, row < n);
    cp_async_commit();
  };
  start_copies(0);

  uint32_t ka[D / 16][4], va[D / 16][4];  // this warp's K and V rows
  load_a_frags<D>(ka, k + base, key_lo, n, D);
  load_a_frags<D>(va, v + base, key_lo, n, D);
  const float sl = scale * kLog2e;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    dk_acc[dn][0] = dk_acc[dn][1] = dk_acc[dn][2] = dk_acc[dn][3] = 0.f;
    dv_acc[dn][0] = dv_acc[dn][1] = dv_acc[dn][2] = dv_acc[dn][3] = 0.f;
  }

  for (int tile = 0; tile < tiles; ++tile) {
    if (tile + 1 < tiles) {
      start_copies(tile + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = tile * kKTile;
    if (active) {
      const bf16* qt = qs + (tile & 1) * kTileElems;
      const bf16* dot = dos + (tile & 1) * kTileElems;
      const float* lt = lss + (tile & 1) * kKTile;
      const float* dlt = dls + (tile & 1) * kKTile;
      const bool whole = q0 + kKTile <= n;  // uniform
#pragma unroll
      for (int kk = 0; kk < kKTile / 16; ++kk) {  // 16 queries: tiles 2kk, 2kk+1
        if (q0 + 16 * kk >= n) continue;  // uniform: p = 0
        float p[2][4], dp[2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * kk + jj;
          if (q0 + 8 * j >= n) {  // uniform: p = 0
            p[jj][0] = p[jj][1] = p[jj][2] = p[jj][3] = 0.f;
            dp[jj][0] = dp[jj][1] = dp[jj][2] = dp[jj][3] = 0.f;
            continue;
          }
          float s[4];
          mma_abt8<D>(s, ka, qt + 8 * j * (D + kBPad));        // S^T = K . Q^T
          mma_abt8<D>(dp[jj], va, dot + 8 * j * (D + kBPad));  // dP^T = V . dO^T
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int lc = 8 * j + 2 * t + (e & 1);
            p[jj][e] = whole || q0 + lc < n
                           ? exp2_approx(fmaf(s[e], sl, -(lt[lc] * kLog2e)))
                           : 0.f;
          }
        }
        // p^T rounded to bf16 (for dv) and ds^T, as A fragments
        uint32_t pa[4], dsa[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int jj = r >> 1, half = r & 1;
          const int lc = 8 * (2 * kk + jj) + 2 * t;
          pa[r] = pack_bf16(p[jj][2 * half], p[jj][2 * half + 1]);
          dsa[r] = pack_bf16(p[jj][2 * half] * (dp[jj][2 * half] - dlt[lc]) * scale,
                             p[jj][2 * half + 1] * (dp[jj][2 * half + 1] - dlt[lc + 1]) * scale);
        }
        mma_ab16<D>(dv_acc, pa, dot + 16 * kk * (D + kBPad));
        mma_ab16<D>(dk_acc, dsa, qt + 16 * kk * (D + kBPad));
      }
    }
    __syncthreads();  // buffer tile & 1 is free for tile + 2
  }
  store_rows_bf16<D>(dk + base, dk_acc, key_lo, n, D);
  store_rows_bf16<D>(dv + base, dv_acc, key_lo, n, D);
}

// ---------------------------------------------------------------------------
// float32: CUDA cores

constexpr int kRows32 = 32;  // query or key rows per block, 8 threads a row

static_assert(kThreads == kRows32 * 8, "8 threads per row");

template <int D>
constexpr size_t dq_smem_f32() {  // Q, dO; K, V; the ds tile
  return sizeof(float) * ((size_t)(2 * kRows32 + 2 * kKTile) * (D + kPad) +
                          (size_t)kRows32 * (kKTile + kPad));
}

template <int D>
constexpr size_t dkv_smem_f32() {  // K, V; Q, dO; p^T, ds^T; lse, delta
  return sizeof(float) * ((size_t)(2 * kRows32 + 2 * kKTile) * (D + kPad) +
                          (size_t)2 * kRows32 * (kKTile + kPad) + 2 * kKTile);
}

// grid (ceil(n / kRows32), heads, batch), kThreads threads. Thread (r, sub)
// owns query row r of the block, score columns sub + 8j of each key tile
// and dq columns 4 * (sub + 8jj) .. + 3. dlse may be null.
template <int D>
__global__ void __launch_bounds__(kThreads)
    blockwise_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ o,
                            const float* __restrict__ dout, const float* __restrict__ lse,
                            const float* __restrict__ dlse, float* __restrict__ dq,
                            float* __restrict__ delta, int n, float scale) {
  static_assert(D % 32 == 0, "head_dim must be a multiple of 32");
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kRows32][D + kPad]
  float* dos = qs + kRows32 * (D + kPad);       // [kRows32][D + kPad]
  float* ks = dos + kRows32 * (D + kPad);       // [kKTile][D + kPad]
  float* vs = ks + kKTile * (D + kPad);         // [kKTile][D + kPad]
  float* dss = vs + kKTile * (D + kPad);        // [kRows32][kKTile + kPad]

  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const size_t base = bh * n * D;
  const int q0 = blockIdx.x * kRows32;
  const int tid = threadIdx.x, r = tid >> 3, sub = tid & 7;
  const int i = q0 + r;

  load_tile_f32<D>(qs, q + base, q0, kRows32, n, D);
  load_tile_f32<D>(dos, dout + base, q0, kRows32, n, D);
  __syncthreads();
  const float* qrow = qs + r * (D + kPad);
  const float* drow = dos + r * (D + kPad);

  // delta over the row's 8 threads, columns sub + 8c
  float dl = 0.f;
  if (i < n) {
    const float* orow = o + base + (size_t)i * D;
#pragma unroll 4
    for (int c = 0; c < D / 8; ++c) dl = fmaf(drow[sub + 8 * c], orow[sub + 8 * c], dl);
  }
  dl += __shfl_xor_sync(0xffffffffu, dl, 1);
  dl += __shfl_xor_sync(0xffffffffu, dl, 2);
  dl += __shfl_xor_sync(0xffffffffu, dl, 4);
  if (i < n && dlse != nullptr) dl -= dlse[bh * n + i];
  if (i < n && sub == 0) delta[bh * n + i] = dl;
  const float li = i < n ? lse[bh * n + i] : INFINITY;  // +inf: p = 0

  constexpr int kVec = D / 32;
  float4 acc[kVec];
#pragma unroll
  for (int jj = 0; jj < kVec; ++jj) acc[jj] = make_float4(0.f, 0.f, 0.f, 0.f);
  float* dsrow = dss + r * (kKTile + kPad);
  for (int k0 = 0; k0 < n; k0 += kKTile) {
    __syncthreads();  // the previous tiles and ds are consumed
    load_tile_f32<D>(ks, k + base, k0, kKTile, n, D);
    load_tile_f32<D>(vs, v + base, k0, kKTile, n, D);
    __syncthreads();
    float s[8], dp[8];
    dot8_f32<D>(s, qrow, ks, sub);
    dot8_f32<D>(dp, drow, vs, sub);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p = k0 + sub + 8 * j < n ? expf(s[j] * scale - li) : 0.f;
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
    float4* out = reinterpret_cast<float4*>(dq + base + (size_t)i * D);
#pragma unroll
    for (int jj = 0; jj < kVec; ++jj) out[sub + 8 * jj] = acc[jj];
  }
}

// grid (ceil(n / kRows32), heads, batch), kThreads threads. Thread (r, sub)
// owns key row r of the block, transposed score columns sub + 8j of each
// query tile and dk/dv columns 4 * (sub + 8jj) .. + 3.
template <int D>
__global__ void __launch_bounds__(kThreads)
    blockwise_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv, int n,
                             float scale) {
  static_assert(D % 32 == 0, "head_dim must be a multiple of 32");
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [kRows32][D + kPad]
  float* vs = ks + kRows32 * (D + kPad);        // [kRows32][D + kPad]
  float* qs = vs + kRows32 * (D + kPad);        // [kKTile][D + kPad]
  float* dos = qs + kKTile * (D + kPad);        // [kKTile][D + kPad]
  float* ps = dos + kKTile * (D + kPad);        // [kRows32][kKTile + kPad] p^T
  float* dss = ps + kRows32 * (kKTile + kPad);  // [kRows32][kKTile + kPad] ds^T
  float* lss = dss + kRows32 * (kKTile + kPad);  // [kKTile] lse
  float* dls = lss + kKTile;                    // [kKTile] delta

  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const size_t base = bh * n * D;
  const int key0 = blockIdx.x * kRows32;
  const int tid = threadIdx.x, r = tid >> 3, sub = tid & 7;
  const int key = key0 + r;

  load_tile_f32<D>(ks, k + base, key0, kRows32, n, D);
  load_tile_f32<D>(vs, v + base, key0, kRows32, n, D);
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
  for (int q0 = 0; q0 < n; q0 += kKTile) {
    __syncthreads();  // K and V are in; the previous tiles are consumed
    load_tile_f32<D>(qs, q + base, q0, kKTile, n, D);
    load_tile_f32<D>(dos, dout + base, q0, kKTile, n, D);
    if (tid < kKTile) {
      const bool live = q0 + tid < n;
      lss[tid] = live ? lse[bh * n + q0 + tid] : INFINITY;  // +inf: p = 0
      dls[tid] = live ? delta[bh * n + q0 + tid] : 0.f;
    }
    __syncthreads();
    float s[8], dp[8];
    dot8_f32<D>(s, krow, qs, sub);    // S^T = K . Q^T
    dot8_f32<D>(dp, vrow, dos, sub);  // dP^T = V . dO^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int lc = sub + 8 * j;
      const float p = expf(s[j] * scale - lss[lc]);
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
        const float4 x = dorow[sub + 8 * jj], y = qrow[sub + 8 * jj];
        dv_acc[jj].x = fmaf(pv, x.x, dv_acc[jj].x);
        dv_acc[jj].y = fmaf(pv, x.y, dv_acc[jj].y);
        dv_acc[jj].z = fmaf(pv, x.z, dv_acc[jj].z);
        dv_acc[jj].w = fmaf(pv, x.w, dv_acc[jj].w);
        dk_acc[jj].x = fmaf(dsv, y.x, dk_acc[jj].x);
        dk_acc[jj].y = fmaf(dsv, y.y, dk_acc[jj].y);
        dk_acc[jj].z = fmaf(dsv, y.z, dk_acc[jj].z);
        dk_acc[jj].w = fmaf(dsv, y.w, dk_acc[jj].w);
      }
    }
  }
  if (key < n) {
    float4* dko = reinterpret_cast<float4*>(dk + base + (size_t)key * D);
    float4* dvo = reinterpret_cast<float4*>(dv + base + (size_t)key * D);
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

template <int D>
cudaError_t dq_launch(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const void* lse, const void* dlse, void* dq,
                      void* delta, int batch, int n, int heads, int is_bf16, float scale,
                      cudaStream_t stream) {
  const float *ls = static_cast<const float*>(lse), *dls = static_cast<const float*>(dlse);
  float* dl = static_cast<float*>(delta);
  cudaError_t err;
  if (is_bf16) {
    constexpr size_t smem = dq_smem_bf16<D>();
    auto kernel = blockwise_dq_bf16_kernel<D>;
    if ((err = set_smem(kernel, smem)) != cudaSuccess) return err;
    const dim3 grid((n + kRows16 - 1) / kRows16, heads, batch);
    kernel<<<grid, 32 * kWarps16, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(o),
        static_cast<const bf16*>(dout), ls, dls, static_cast<bf16*>(dq), dl, n, scale);
    return cudaGetLastError();
  }
  constexpr size_t smem = dq_smem_f32<D>();
  auto kernel = blockwise_dq_f32_kernel<D>;
  if ((err = set_smem(kernel, smem)) != cudaSuccess) return err;
  const dim3 grid((n + kRows32 - 1) / kRows32, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), ls, dls, static_cast<float*>(dq), dl, n, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t dkv_launch(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int batch,
                       int n, int heads, int is_bf16, float scale, cudaStream_t stream) {
  const float *ls = static_cast<const float*>(lse), *dl = static_cast<const float*>(delta);
  cudaError_t err;
  if (is_bf16) {
    constexpr size_t smem = dkv_smem_bf16<D>();
    auto kernel = blockwise_dkv_bf16_kernel<D>;
    if ((err = set_smem(kernel, smem)) != cudaSuccess) return err;
    const dim3 grid((n + kRows16 - 1) / kRows16, heads, batch);
    kernel<<<grid, 32 * kWarps16, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), ls, dl,
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, scale);
    return cudaGetLastError();
  }
  constexpr size_t smem = dkv_smem_f32<D>();
  auto kernel = blockwise_dkv_f32_kernel<D>;
  if ((err = set_smem(kernel, smem)) != cudaSuccess) return err;
  const dim3 grid((n + kRows32 - 1) / kRows32, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), ls, dl,
      static_cast<float*>(dk), static_cast<float*>(dv), n, scale);
  return cudaGetLastError();
}

bool bad_sizes(int batch, int n, int heads) {
  return n < 1 || batch < 1 || heads < 1 || batch > 65535 || heads > 65535;
}

}  // namespace

// q, k, v, o, dout (the upstream gradient, already in the input dtype), dq:
// contiguous (batch, heads, n, head_dim) of one dtype (is_bf16 = 1:
// bfloat16, 0: float32), 16-byte aligned; lse: the forward's fp32 (batch,
// heads, n); dlse: the lse output's fp32 cotangent of that shape, or null;
// delta: fp32 (batch, heads, n), written here for blockwise_bwd_dkv.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int blockwise_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                const void* dout, const void* lse, const void* dlse,
                                void* dq, void* delta, int batch, int n, int heads,
                                int head_dim, int is_bf16, float scale, void* stream) {
  if (bad_sizes(batch, n, heads) || lse == nullptr || delta == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return (int)dq_launch<32>(q, k, v, o, dout, lse, dlse, dq, delta, batch, n, heads,
                                is_bf16, scale, s);
    case 64:
      return (int)dq_launch<64>(q, k, v, o, dout, lse, dlse, dq, delta, batch, n, heads,
                                is_bf16, scale, s);
    case 128:
      return (int)dq_launch<128>(q, k, v, o, dout, lse, dlse, dq, delta, batch, n, heads,
                                 is_bf16, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dk, dv: like q; delta: from blockwise_bwd_dq on the same stream.
extern "C" int blockwise_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dk, void* dv, int batch, int n, int heads,
                                 int head_dim, int is_bf16, float scale, void* stream) {
  if (bad_sizes(batch, n, heads) || lse == nullptr || delta == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return (int)dkv_launch<32>(q, k, v, dout, lse, delta, dk, dv, batch, n, heads,
                                 is_bf16, scale, s);
    case 64:
      return (int)dkv_launch<64>(q, k, v, dout, lse, delta, dk, dv, batch, n, heads,
                                 is_bf16, scale, s);
    case 128:
      return (int)dkv_launch<128>(q, k, v, dout, lse, delta, dk, dv, batch, n, heads,
                                  is_bf16, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
