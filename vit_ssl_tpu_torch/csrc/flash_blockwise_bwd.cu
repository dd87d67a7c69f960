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
// bfloat16 runs the Hopper backward of attention_bwd_sm90.cuh in its lse
// form (wgmma, TMA; B3's backward in B3's form): the dq kernel sums delta
// before one sweep over the key tiles (three products a tile), the dk/dv
// kernel sweeps the query tiles (four a tile); what bounds it and its design
// are written there. It reads the lse and delta in whole 64-row tiles, so
// both have round_up(n, 64) rows a head: the wrapper pads the lse with +inf
// (as _flash_bwd pads it), and the dq kernel writes delta 0 past n. It takes
// any n >= 1 and scale > 0 (folded into the exponent after the mask's -inf).
// float32 keeps full fp32 products on the CUDA cores and the accurate expf
// (TF32 would miss the fp32 tolerance), 32 rows a block of 8 warps, 8
// threads a row, on (B, H, n) lse and delta; tiles past n are masked, and
// nothing is padded in memory.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (vit_ssl_tpu_torch/kernels.py); called through
// ctypes from vit_ssl_tpu_torch/ops/flash_blockwise.py.

#include "attention_bwd_sm90.cuh"
#include "attention_nhd_common.cuh"

namespace {

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
  if (is_bf16)
    return sm90::launch_blockwise_dq<D>(q, k, v, o, dout, lse, dlse, dq, delta, batch, n,
                                        heads, scale, stream);
  const float *ls = static_cast<const float*>(lse), *dls = static_cast<const float*>(dlse);
  constexpr size_t smem = dq_smem_f32<D>();
  auto kernel = blockwise_dq_f32_kernel<D>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kRows32 - 1) / kRows32, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), ls, dls, static_cast<float*>(dq),
      static_cast<float*>(delta), n, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t dkv_launch(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int batch,
                       int n, int heads, int is_bf16, float scale, cudaStream_t stream) {
  if (is_bf16)
    return sm90::launch_blockwise_dkv<D>(q, k, v, dout, lse, delta, dk, dv, batch, n, heads,
                                         scale, stream);
  constexpr size_t smem = dkv_smem_f32<D>();
  auto kernel = blockwise_dkv_f32_kernel<D>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kRows32 - 1) / kRows32, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), n, scale);
  return cudaGetLastError();
}

// The grid's limits; bfloat16 also takes scale > 0 only
// (sm90::bad_bwd_sizes).
bool bad_sizes(int batch, int n, int heads, int is_bf16, float scale) {
  if (is_bf16) return sm90::bad_bwd_sizes(batch, n, heads, scale);
  return n < 1 || batch < 1 || heads < 1 || batch > 65535 || heads > 65535;
}

}  // namespace

// q, k, v, o, dout (the upstream gradient, already in the input dtype), dq:
// contiguous (batch, heads, n, head_dim) of one dtype (is_bf16 = 1:
// bfloat16, 0: float32), 16-byte aligned; lse: the forward's fp32 lse of
// `rows` rows a head, (batch, heads, rows); delta: fp32 (batch, heads,
// rows), written here for blockwise_bwd_dkv; rows: bfloat16
// round_up(n, 64), the lse padded with +inf and delta written 0 past n;
// float32 n. dlse: the lse output's fp32 cotangent, (batch, heads, n), or
// null. Returns the cudaError_t of the launch (0 = launched).
extern "C" int blockwise_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                const void* dout, const void* lse, const void* dlse,
                                void* dq, void* delta, int batch, int n, int heads,
                                int head_dim, int is_bf16, float scale, void* stream) {
  if (bad_sizes(batch, n, heads, is_bf16, scale) || lse == nullptr || delta == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return sm90::for_head_dim(head_dim, [&](auto d) {
    return dq_launch<decltype(d)::value>(q, k, v, o, dout, lse, dlse, dq, delta, batch, n,
                                         heads, is_bf16, scale, s);
  });
}

// dk, dv: like q; lse: as blockwise_bwd_dq takes it; delta: from
// blockwise_bwd_dq on the same stream.
extern "C" int blockwise_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dk, void* dv, int batch, int n, int heads,
                                 int head_dim, int is_bf16, float scale, void* stream) {
  if (bad_sizes(batch, n, heads, is_bf16, scale) || lse == nullptr || delta == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return sm90::for_head_dim(head_dim, [&](auto d) {
    return dkv_launch<decltype(d)::value>(q, k, v, dout, lse, delta, dk, dv, batch, n, heads,
                                          is_bf16, scale, s);
  });
}
