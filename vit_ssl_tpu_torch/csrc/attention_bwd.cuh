// The float32 attention backward of kernels B1 and B3, for Hopper (sm_90a)
// on the CUDA cores: the kernel bodies, templated on the layout
// (kHeadMajor, attention_nhd_common.cuh::head_rows). attention_nhd_bwd.cu
// instantiates them for B1's (B, N, H*D) layout, fused_attention.cu for
// B3's (B, H, N, D) layout; the C entry points live there. bfloat16 runs
// the Hopper backward of attention_bwd_sm90.cuh in both. Per head:
//
//   p     = the forward's normalised probabilities
//   dv    = p^T . do ; dp = do . v^T ; delta = sum_j p * dp    fp32
//   ds    = p * (dp - delta) * scale
//   dq    = ds . k ; dk = ds^T . q
//
// each in fp32; do arrives already cast to fp32. The TPU kernels read the
// (B, H, N, N) probabilities their training forwards saved; this one
// recomputes them from q, k and the softmax statistics (m, 1/l) that the
// training forward saved (fp32, (B, H, round_up(N, 64), 2)): the scores
// again with dot8_f32, the forward's very instructions, so p is the
// forward's bit for bit. Recomputing p means applying the block-diagonal
// mask again (the saved probabilities were zero off the blocks; recomputed
// ones would not be), and zeroing rows and keys past N.
//
// No (N, N) matrix is ever written (the TPU kernels read 4 bytes per score
// in fp32; this one 8 bytes per row). The work splits in two kernels, as
// the JAX package's own blockwise backward does (flash_blockwise.py: a dq
// pass and a dk/dv pass), so that no gradient needs atomics and the result
// is the same from run to run: full fp32 products on the CUDA cores (TF32
// would miss the fp32 tolerance), 32 rows a block of 8 warps, 8 threads a
// row, score tiles through shared memory. The dq kernel sweeps the key
// tiles twice (the first sums delta, the second accumulates dq) and writes
// delta ((B, H, round_up(N, 64)) fp32) for the dk/dv kernel, which sweeps
// the query tiles once.
//
// kernels.py rebuilds a library when this header is newer than it.

#pragma once

#include "attention_nhd_common.cuh"

namespace {

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
                       int batch, int n, int heads, float scale, int block_size,
                       cudaStream_t stream) {
  const float2* st = static_cast<const float2*>(stats);
  float* dl = static_cast<float*>(delta);
  cudaError_t err;
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

// Checks the sizes, then launches the float32 kernels for the head dim;
// returns the first non-zero cudaError_t (0 = both kernels launched).
template <bool kHeadMajor>
int bwd_dispatch(const void* q, const void* k, const void* v, const void* dout,
                 const void* stats, void* dq, void* dk, void* dv, void* delta,
                 int batch, int n, int heads, int head_dim, float scale, int block_size,
                 void* stream) {
  if (n < 1 || n > kMaxSeq || batch < 1 || heads < 1 || block_size < 0 ||
      batch > 65535 || heads > 65535 || stats == nullptr || delta == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return (int)bwd_launch<32, kHeadMajor>(q, k, v, dout, stats, dq, dk, dv, delta,
                                             batch, n, heads, scale, block_size, s);
    case 64:
      return (int)bwd_launch<64, kHeadMajor>(q, k, v, dout, stats, dq, dk, dv, delta,
                                             batch, n, heads, scale, block_size, s);
    case 128:
      return (int)bwd_launch<128, kHeadMajor>(q, k, v, dout, stats, dq, dk, dv, delta,
                                              batch, n, heads, scale, block_size, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
