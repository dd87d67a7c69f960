// Blockwise flash attention forward on the head-major (B, H, N, D) layout,
// for Hopper (sm_90a): kernel B2's forward and its exp2 probe P1.
//
// Replaces the TPU kernels vit_ssl_tpu/ops/flash_blockwise.py::_fwd_kernel
// (called by _flash_fwd; C entry blockwise_fwd) and
// scripts/exp2_probe.py::_fwd_kernel_exp2 (called by fwd_exp2; C entry
// blockwise_fwd_exp2). Per (b, h) and query row i, over key tiles j:
//
//   s    = (q_i . k_j^T) * scale            fp32 products and sums
//   s    = -inf for keys at or past n        (the ragged last tile)
//   m'   = max(m, rowmax(s)) ; c = exp(m - m')
//   p    = exp(s - m')                       fp32, NOT normalised
//   l    = l * c + rowsum(p)
//   acc  = acc * c + p.astype(v.dtype) . v_j fp32 accumulation
//   o    = acc / l  (cast on store) ; lse = m + log(l)  fp32 (B, H, N)
//
// p is rounded to the input dtype relative to the running max before P.V,
// so in bf16 the output depends on the key tiling: the plain version
// (ops/flash_blockwise.py::blockwise_attention_reference) takes the
// kernel's tile, kKTile = 64 keys, to be held to it.
//
// The two forms (template kExp2):
// - exp (blockwise_fwd, the TPU kernel's form, the one the model path
//   launches): s is scaled by `scale`, and every exponential is expf, the
//   accurate one (no fast math), so p and lse follow the plain version's
//   torch.exp to an fp32 ulp or two.
// - exp2 (blockwise_fwd_exp2, P1): log2(e) is folded into the scale, so s
//   is in the log2 domain, each exponential is one ex2.approx on the
//   special-function unit, and lse = (m2 + log2(l)) / log2(e) is returned as
//   natural log. exp2(x log2 e) = exp(x), so it computes the same function.
//
// Which form the model path launches: exp. On an H100 SXM (700 W) the exp2
// form takes 0.85x the exp form's time at (8, 6, 2048, 64) and (4, 6, 4096,
// 64) bf16 (vit_ssl_tpu_torch/scripts/exp2_probe.py), and both meet the
// same tolerances. The path keeps the TPU kernel's form because P1 is by
// definition B2's forward in the other form, held beside it by the probe;
// moving the path to exp2 (one FFMA and one ex2 a score instead of expf's
// range reduction) belongs with the change that makes B2 fast.
//
// What bounds it on an H100 SXM, at ViT-B/16's (64, 12, 1025, 64) bf16
// (100.8 MB a tensor, 103.3 GFLOP a product; data sheet: 3.35 TB/s, 989
// TFLOP/s bf16): q, k, v read and o written, 403 MB, plus 3.1 MB of lse:
// 0.121 ms; the two products 0.209 ms: operations bound it, and 807 M
// exponentials (0.19 ms on the special-function units at 16 a clock per
// SM, with the exp2 form) come close. What the design does:
//
// - one pass with online rescaling: the scores are computed once (B1/B3's
//   body computes them twice, the first pass only for the row max and sum),
//   and the (N, N) scores never leave the chip;
// - bfloat16 on the tensor cores through mma.sync m16n8k16 with fp32
//   accumulation: one block of 4 warps owns 64 query rows of one (b, h), 16
//   rows a warp with its Q fragments in registers; K and V stream through
//   64-row shared tiles copied with cp.async into two buffers, the next
//   tile's copies in flight while this one computes; p goes from the score
//   accumulators to the P.V product's A operand in registers (no shared
//   memory round trip); the query tiles of one (b, h) run side by side, so
//   their re-reads of K and V come mostly from L2;
// - the ragged last key tile is masked in the kernel, and its 8-key column
//   groups at or past n skip their products: nothing is padded in memory
//   (the TPU kernel pads N to its block and computes the padding);
// - float32 keeps full fp32 products on the CUDA cores (TF32 would miss the
//   fp32 tolerance): one block of 8 warps owns 32 query rows, 8 threads a
//   row, and the p tile goes through shared memory to the P.V product.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (vit_ssl_tpu_torch/kernels.py); called through
// ctypes from vit_ssl_tpu_torch/ops/flash_blockwise.py.

#include "attention_nhd_common.cuh"

namespace {

template <bool kExp2>
__device__ __forceinline__ float softmax_exp(float x) {
  return kExp2 ? exp2_approx(x) : expf(x);
}

template <bool kExp2>
__device__ __forceinline__ float natural_lse(float m, float l) {
  return kExp2 ? (m + log2f(l)) / kLog2e : m + logf(l);
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores

template <int D>
constexpr size_t fwd_smem_bf16() {  // K and V, two buffers each
  return 4 * sizeof(bf16) * kKTile * (D + kBPad);
}

// grid (ceil(n / kRows16), heads, batch), 32 * kWarps16 threads,
// fwd_smem_bf16<D>() of dynamic shared memory.
template <int D, bool kExp2>
__global__ void __launch_bounds__(32 * kWarps16)
    blockwise_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, bf16* __restrict__ o,
                              float* __restrict__ lse, int n, float scale) {
  static_assert(D % 32 == 0, "head_dim must be a multiple of 32");
  constexpr int kTileElems = kKTile * (D + kBPad);
  extern __shared__ uint4 smem_bf16[];
  bf16* ks = reinterpret_cast<bf16*>(smem_bf16);  // [2][kKTile][D + kBPad]
  bf16* vs = ks + 2 * kTileElems;                 // [2][kKTile][D + kBPad]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const size_t base = bh * n * D;
  const int row0 = blockIdx.x * kRows16 + 16 * warp;
  const int row_lo = row0 + (lane >> 2), row_hi = row_lo + 8;
  const bool active = row0 < n;  // a warp whose rows all lie past n only loads
  const int tiles = (n + kKTile - 1) / kKTile;

  auto start_copies = [&](int tile) {  // K and V tile `tile` into buffer tile & 1
    const int buf = tile & 1, k0 = tile * kKTile;
    load_tile_bf16<D>(ks + buf * kTileElems, k + base, k0, n, D);
    load_tile_bf16<D>(vs + buf * kTileElems, v + base, k0, n, D);
    cp_async_commit();
  };
  start_copies(0);

  uint32_t qa[D / 16][4];  // this warp's Q rows; rows past n are 0
  load_a_frags<D>(qa, q + base, row_lo, n, D);

  const float sscale = kExp2 ? scale * kLog2e : scale;
  // running max (in the form's domain) and this lane's share of the row sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
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
      float s[kKTile / 8][4];
#pragma unroll
      for (int j = 0; j < kKTile / 8; ++j) {
        if (k0 + 8 * j >= n) {  // uniform: 8 keys past n, no product
          s[j][0] = s[j][1] = s[j][2] = s[j][3] = -INFINITY;
          continue;
        }
        mma_abt8<D>(s[j], qa, kt + 8 * j * (D + kBPad));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          s[j][e] = whole || col < n ? s[j][e] * sscale : -INFINITY;
        }
      }
      // the new row max (finite: key k0 < n is in the tile), the factor
      // that rescales the old sum and accumulator, then p in place of s
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float tile_max = -INFINITY;
#pragma unroll
        for (int j = 0; j < kKTile / 8; ++j)
          tile_max = fmaxf(tile_max, fmaxf(s[j][2 * half], s[j][2 * half + 1]));
        const float m_new = fmaxf(m[half], quad_max(tile_max));
        corr[half] = softmax_exp<kExp2>(m[half] - m_new);  // 0 on the first tile
        m[half] = m_new;
      }
#pragma unroll
      for (int j = 0; j < kKTile / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = softmax_exp<kExp2>(s[j][e] - m[e >> 1]);
          sum[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int half = 0; half < 2; ++half) l[half] = l[half] * corr[half] + sum[half];
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        acc[dn][0] *= corr[0];
        acc[dn][1] *= corr[0];
        acc[dn][2] *= corr[1];
        acc[dn][3] *= corr[1];
      }
      // acc += p . v, p rounded to bf16 as the A operand, 16 keys a step
#pragma unroll
      for (int kk = 0; kk < kKTile / 16; ++kk) {
        if (k0 + 16 * kk >= n) continue;  // uniform: p = 0
        uint32_t pa[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* sj = s[2 * kk + (e >> 1)];
          pa[e] = pack_bf16(sj[2 * (e & 1)], sj[2 * (e & 1) + 1]);
        }
        mma_ab16<D>(acc, pa, vt + 16 * kk * (D + kBPad));
      }
    }
    __syncthreads();  // buffer tile & 1 is free for tile + 2
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) l[half] = fmaxf(quad_sum(l[half]), 1e-30f);
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    acc[dn][0] /= l[0];
    acc[dn][1] /= l[0];
    acc[dn][2] /= l[1];
    acc[dn][3] /= l[1];
  }
  store_rows_bf16<D>(o + base, acc, row_lo, n, D);
  if (active && t == 0) {
    if (row_lo < n) lse[bh * n + row_lo] = natural_lse<kExp2>(m[0], l[0]);
    if (row_hi < n) lse[bh * n + row_hi] = natural_lse<kExp2>(m[1], l[1]);
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores

constexpr int kRows32 = 32;  // query rows per block, 8 threads a row

static_assert(kThreads == kRows32 * 8, "8 threads per query row");

template <int D>
constexpr size_t fwd_smem_f32() {  // Q; K then V; the p tile
  return sizeof(float) * ((size_t)(kRows32 + kKTile) * (D + kPad) +
                          (size_t)kRows32 * (kKTile + kPad));
}

// grid (ceil(n / kRows32), heads, batch), kThreads threads. Thread (r, sub)
// owns query row r of the block, score columns sub + 8j of each key tile and
// output columns 4 * (sub + 8jj) .. + 3.
template <int D>
__global__ void __launch_bounds__(kThreads)
    blockwise_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, float* __restrict__ o,
                             float* __restrict__ lse, int n, float scale) {
  static_assert(D % 32 == 0, "head_dim must be a multiple of 32");
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kRows32][D + kPad]
  float* kv = qs + kRows32 * (D + kPad);        // [kKTile][D + kPad], K then V
  float* ps = kv + kKTile * (D + kPad);         // [kRows32][kKTile + kPad]

  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const size_t base = bh * n * D;
  const int q0 = blockIdx.x * kRows32;
  const int tid = threadIdx.x, r = tid >> 3, sub = tid & 7;
  const int i = q0 + r;

  load_tile_f32<D>(qs, q + base, q0, kRows32, n, D);
  const float* qrow = qs + r * (D + kPad);
  float* prow = ps + r * (kKTile + kPad);

  constexpr int kVec = D / 32;
  float4 acc[kVec];
#pragma unroll
  for (int jj = 0; jj < kVec; ++jj) acc[jj] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m = -INFINITY, l = 0.f;  // l: this thread's share of the row sum
  for (int k0 = 0; k0 < n; k0 += kKTile) {
    __syncthreads();  // Q is in; the previous V tile is consumed
    load_tile_f32<D>(kv, k + base, k0, kKTile, n, D);
    __syncthreads();
    float s[8];
    dot8_f32<D>(s, qrow, kv, sub);
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j] = k0 + sub + 8 * j < n ? s[j] * scale : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    // over the row's 8 threads: neighbouring lanes of one warp
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 4));
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    m = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p = expf(s[j] - m);
      prow[sub + 8 * j] = p;
      sum += p;
    }
    l = l * corr + sum;
#pragma unroll
    for (int jj = 0; jj < kVec; ++jj) {
      acc[jj].x *= corr;
      acc[jj].y *= corr;
      acc[jj].z *= corr;
      acc[jj].w *= corr;
    }
    __syncthreads();  // the K tile is consumed; p is in
    load_tile_f32<D>(kv, v + base, k0, kKTile, n, D);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kKTile; ++c) {
      const float p = prow[c];
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
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  l += __shfl_xor_sync(0xffffffffu, l, 4);
  l = fmaxf(l, 1e-30f);
  if (i < n) {
    float4* orow = reinterpret_cast<float4*>(o + base + (size_t)i * D);
#pragma unroll
    for (int jj = 0; jj < kVec; ++jj)
      orow[sub + 8 * jj] = make_float4(acc[jj].x / l, acc[jj].y / l, acc[jj].z / l,
                                       acc[jj].w / l);
    if (sub == 0) lse[bh * n + i] = m + logf(l);
  }
}

// ---------------------------------------------------------------------------
// launch

template <int D, bool kExp2>
cudaError_t fwd_launch(const void* q, const void* k, const void* v, void* o, void* lse,
                       int batch, int n, int heads, int is_bf16, float scale,
                       cudaStream_t stream) {
  float* ls = static_cast<float*>(lse);
  if (is_bf16) {
    constexpr size_t smem = fwd_smem_bf16<D>();
    auto kernel = blockwise_fwd_bf16_kernel<D, kExp2>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((n + kRows16 - 1) / kRows16, heads, batch);
    kernel<<<grid, 32 * kWarps16, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), ls, n, scale);
    return cudaGetLastError();
  }
  constexpr size_t smem = fwd_smem_f32<D>();
  auto kernel = blockwise_fwd_f32_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kRows32 - 1) / kRows32, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), ls, n, scale);
  return cudaGetLastError();
}

template <bool kExp2>
int fwd_dispatch(const void* q, const void* k, const void* v, void* o, void* lse,
                 int batch, int n, int heads, int head_dim, int is_bf16, float scale,
                 void* stream) {
  if (o == nullptr || lse == nullptr || n < 1 || batch < 1 || heads < 1 ||
      batch > 65535 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return (int)fwd_launch<32, kExp2>(q, k, v, o, lse, batch, n, heads, is_bf16, scale, s);
    case 64:
      return (int)fwd_launch<64, kExp2>(q, k, v, o, lse, batch, n, heads, is_bf16, scale, s);
    case 128:
      return (int)fwd_launch<128, kExp2>(q, k, v, o, lse, batch, n, heads, is_bf16, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: contiguous (batch, heads, n, head_dim) of one dtype (is_bf16 =
// 1: bfloat16, 0: float32), 16-byte aligned; lse: fp32 (batch, heads, n).
// stream: a cudaStream_t. Returns the cudaError_t of the launch (0 =
// launched); the wrapper raises on non-zero.
extern "C" int blockwise_fwd(const void* q, const void* k, const void* v, void* o,
                             void* lse, int batch, int n, int heads, int head_dim,
                             int is_bf16, float scale, void* stream) {
  return fwd_dispatch<false>(q, k, v, o, lse, batch, n, heads, head_dim, is_bf16, scale,
                             stream);
}

// P1: the same function in the log2 domain (exp2 on the special-function
// unit); bfloat16 only, as the probe runs it.
extern "C" int blockwise_fwd_exp2(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int batch, int n, int heads, int head_dim,
                                  int is_bf16, float scale, void* stream) {
  if (!is_bf16) return (int)cudaErrorInvalidValue;
  return fwd_dispatch<true>(q, k, v, o, lse, batch, n, heads, head_dim, is_bf16, scale,
                            stream);
}
