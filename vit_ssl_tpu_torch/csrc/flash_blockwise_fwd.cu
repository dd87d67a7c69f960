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
// kernel's tile, KERNEL_BLOCK_K = flash_blockwise_fwd_sm90.cuh's kKeys, to
// be held to it.
//
// The two forms (template kExp2):
// - exp (blockwise_fwd, the TPU kernel's form, the one the model path
//   launches): every exponential is expf, the accurate one (no fast math),
//   so p and lse follow the plain version's torch.exp to an fp32 ulp or
//   two.
// - exp2 (blockwise_fwd_exp2, P1): log2(e) is folded into the scale, so s
//   is in the log2 domain, each exponential is one ex2.approx on the
//   special-function unit, and lse = (m2 + log2(l)) / log2(e) is returned as
//   natural log. exp2(x log2 e) = exp(x), so it computes the same function.
// The model path keeps the TPU kernel's form; the exp2 probe
// (vit_ssl_tpu_torch/scripts/exp2_probe.py) times P1 against it.
//
// bfloat16 runs the Hopper body of flash_blockwise_fwd_sm90.cuh (wgmma,
// TMA, one online-softmax pass; what bounds it and its design are written
// there) at every head dim, with scale > 0; there is no other bf16 body.
// float32 keeps full fp32 products on the CUDA cores (TF32 would miss the
// fp32 tolerance): one block of 8 warps owns 32 query rows, 8 threads a
// row, K and V tiles of kKTile keys go through shared memory, and the p
// tile goes through shared memory to the P.V product. What bounds it at
// (64, 12, 1025, 64) fp32: the two products' 206.6 GFLOP at the CUDA
// cores' 67 TFLOP/s, 3.1 ms.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (vit_ssl_tpu_torch/kernels.py); called through
// ctypes from vit_ssl_tpu_torch/ops/flash_blockwise.py.

#include "attention_nhd_common.cuh"
#include "flash_blockwise_fwd_sm90.cuh"

namespace {

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
  if (is_bf16) {
    if (!(scale > 0.f)) return cudaErrorInvalidValue;  // folded into the exponent
    return blockwise_sm90::launch<D, kExp2>(q, k, v, o, lse, batch, n, heads, scale,
                                            stream);
  }
  float* ls = static_cast<float*>(lse);
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
