// Dropout-masked second FFN product for Hopper (sm_90a): kernel P2,
// forward and backward.
//
// Replaces the TPU kernels of scripts/dropout_epilogue_probe.py:
// _masked_mm_kernel (the pallas_call of _masked_mm_fwd_impl) and
// _masked_mm_bwd_kernel (the pallas_call of _mm_bwd), at their rounding
// points:
//
//   forward:  hm  = h * mask / keep       fp32, rounded to h's dtype
//             o   = hm . W2^T + b2        fp32 sums plus b2, rounded
//   backward: dh  = (do . W2) * mask / keep        fp32, rounded
//             dW2 = do^T . hm ; db2 = sum_rows do  fp32 sums, rounded
//
// h is (T, d_ff), the mask (T, d_ff) bytes (0 = dropped), W2 (d_out, d_ff)
// in the nn.Linear layout, do (T, d_out), all in one dtype. The point of
// the kernel is that the masked activation hm never reaches device memory
// as a tensor of its own: each block scales its h tile in shared memory
// between the cp.async that lands it and the ldmatrix that feeds the
// tensor cores.
//
// - masked_mm_fwd: one tiled product. A block owns 128 rows x 128 output
//   columns; 8 warps of 64 x 32; 32-deep stages of h, its mask bytes and
//   W2 stream through a ring of three cp.async buffers. The epilogue adds
//   b2 and writes o once.
// - masked_mm_bwd: no atomics, as B4's backward. The same tiled product,
//   with do and W2 as stored, gives dh, scaled by the mask bytes in its
//   epilogue; the weight kernel of weight_grad.cuh (B4's, with B masked on
//   its way in) sums dW2 and db2 into fp32 partials over up to 8 slices of
//   the rows, and an ordered reduction adds the slices and rounds.
//
// Ragged T is masked in the kernels (rows past T load as zero and are not
// stored); nothing is padded in memory. float32 runs on the CUDA cores
// (full fp32 products).
//
// What bounds it on an H100 SXM: bytes. At the DINO student-globals FFN
// (T = 37120, d_ff 1536, d_out 384, bf16) the forward moves h, the mask,
// W2 and o, about 201 MB, 0.060 ms at 3.35 TB/s, against 43.8 GFLOP, 0.044
// ms at 989 TFLOP/s; the backward moves h, the mask, do, W2, dh and dW2,
// about 317 MB, 0.095 ms, against two products, 0.089 ms (data sheet).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (vit_ssl_tpu_torch/kernels.py); called through
// ctypes from vit_ssl_tpu_torch/ops/masked_matmul.py.

#include "weight_grad.cuh"

namespace {

// The tiled product c (rows, n) = a (rows, k) . B over k, B from W2:
// forward a = h (k = d_ff), B = W2^T (n = d_out), a masked on the way in,
// b2 added in the epilogue; backward a = do (k = d_out), B = W2 (n = d_ff),
// c masked in the epilogue.
template <typename T>
struct TileArgs {
  const T* a;
  const T* w2;           // (d_out, d_ff)
  const T* b2;           // (d_out), forward only
  const uint8_t* mask;   // (rows, d_ff)
  T* out;                // (rows, n): o or dh
  int rows, n, k;
  float keep_prob;
};

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kTileThreads = 256;  // 8 warps: 2 along the rows x 4 along n
constexpr int kStages = 3;
constexpr int kAStride = kBK + kBPad;    // a tiles [m][k]
constexpr int kBStrideNK = kBK + kBPad;  // forward B: W2 as stored, [n][k]
constexpr int kBStrideKN = kBN + kBPad;  // backward B: W2 as stored, [k][n]
constexpr size_t kABytes = sizeof(bf16) * kBM * kAStride;

template <bool kFwd>
__host__ __device__ constexpr size_t stage_bytes() {
  return kABytes + sizeof(bf16) * (kFwd ? kBN * kBStrideNK : kBK * kBStrideKN) +
         (kFwd ? kBM * kBK : 0);  // the forward's mask bytes
}

template <bool kFwd>
__global__ void __launch_bounds__(kTileThreads) masked_mm_bf16(TileArgs<bf16> p) {
  constexpr size_t kBBytes = stage_bytes<kFwd>() - kABytes - (kFwd ? kBM * kBK : 0);
  extern __shared__ uint4 smem_mm[];
  char* smem = reinterpret_cast<char*>(smem_mm);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = 64 * (warp & 1), wn = 32 * (warp >> 1);
  const int row0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int ktiles = p.k / kBK;
  const float inv_keep = 1.f / p.keep_prob;

  // k-tile kt's copies into slot kt % kStages (none past the end),
  // committed as one group
  auto copy_stage = [&](int kt) {
    if (kt < ktiles) {
      char* st = smem + (kt % kStages) * stage_bytes<kFwd>();
      bf16* as = reinterpret_cast<bf16*>(st);
      bf16* bs = reinterpret_cast<bf16*>(st + kABytes);
      const int k0 = kt * kBK;
      for (int idx = threadIdx.x; idx < kBM * kBK / 8; idx += kTileThreads) {
        const int r = idx / (kBK / 8), c = (idx % (kBK / 8)) * 8;
        const bool ok = row0 + r < p.rows;
        cp_async16(as + r * kAStride + c, ok ? p.a + (size_t)(row0 + r) * p.k + k0 + c : p.a,
                   ok);
      }
      if (kFwd) {
        for (int idx = threadIdx.x; idx < kBN * kBK / 8; idx += kTileThreads) {
          const int r = idx / (kBK / 8), c = (idx % (kBK / 8)) * 8;  // W2 row n0 + r
          cp_async16(bs + r * kBStrideNK + c, p.w2 + (size_t)(n0 + r) * p.k + k0 + c, true);
        }
        uint8_t* ms = reinterpret_cast<uint8_t*>(st + kABytes + kBBytes);
        for (int idx = threadIdx.x; idx < kBM * kBK / 16; idx += kTileThreads) {
          const int r = idx / (kBK / 16), c = (idx % (kBK / 16)) * 16;
          const bool ok = row0 + r < p.rows;
          cp_async16(ms + r * kBK + c,
                     ok ? p.mask + (size_t)(row0 + r) * p.k + k0 + c : p.mask, ok);
        }
      } else {
        for (int idx = threadIdx.x; idx < kBK * kBN / 8; idx += kTileThreads) {
          const int r = idx / (kBN / 8), c = (idx % (kBN / 8)) * 8;  // W2 row k0 + r
          cp_async16(bs + r * kBStrideKN + c, p.w2 + (size_t)(k0 + r) * p.n + n0 + c, true);
        }
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < kStages - 1; ++s) copy_stage(s);

  float acc[4][4][4] = {};
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this stage is in; every warp is done with the last one
    copy_stage(kt + kStages - 1);  // into the slot the last stage used
    char* st = smem + (kt % kStages) * stage_bytes<kFwd>();
    bf16* as = reinterpret_cast<bf16*>(st);
    const bf16* bs = reinterpret_cast<const bf16*>(st + kABytes);
    if (kFwd) {  // hm = round(h * mask / keep), in place
      const uint8_t* ms = reinterpret_cast<const uint8_t*>(st + kABytes + kBBytes);
      for (int idx = threadIdx.x; idx < kBM * kBK / 8; idx += kTileThreads) {
        const int r = idx / (kBK / 8), c = (idx % (kBK / 8)) * 8;
        uint4* hv = reinterpret_cast<uint4*>(as + r * kAStride + c);
        *hv = mask_bf16x8(*hv, *reinterpret_cast<const uint2*>(ms + r * kBK + c), inv_keep);
      }
      __syncthreads();
    }
#pragma unroll
    for (int k0 = 0; k0 < kBK; k0 += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load_a(a[i], as, kAStride, wm + 16 * i, k0);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t b[4];
        if (kFwd)
          load_b<false>(b, bs, kBStrideNK, k0, wn + 16 * jp);
        else
          load_b<true>(b, bs, kBStrideKN, k0, wn + 16 * jp);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mma_bf16(acc[i][2 * jp], a[i], b[0], b[1]);
          mma_bf16(acc[i][2 * jp + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();  // the empty groups past the end

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn + 8 * j + 2 * t;
    const float bias0 = kFwd ? to_float(p.b2[col]) : 0.f;
    const float bias1 = kFwd ? to_float(p.b2[col + 1]) : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = row0 + wm + 16 * i + g + 8 * hr;
        if (row >= p.rows) continue;
        float v0 = acc[i][j][2 * hr], v1 = acc[i][j][2 * hr + 1];
        if (kFwd) {
          v0 += bias0;
          v1 += bias1;
        } else {
          const uint8_t* m = p.mask + (size_t)row * p.n + col;
          v0 *= m[0] ? inv_keep : 0.f;
          v1 *= m[1] ? inv_keep : 0.f;
        }
        *reinterpret_cast<uint32_t*>(p.out + (size_t)row * p.n + col) = pack_bf16(v0, v1);
      }
  }
}

// ---------------------------------------------------------------------------
// float32, CUDA cores: a block of 256 threads owns 64 rows x 64 columns,
// 4 x 4 a thread; 16-deep stages of a (masked on the copy in the forward)
// and B sit in shared memory as [k][m] and [k][n].

constexpr int kF32Tile = 64, kF32K = 16;

template <bool kFwd>
__global__ void __launch_bounds__(kTileThreads) masked_mm_f32(TileArgs<float> p) {
  __shared__ float4 as[kF32K][kF32Tile / 4];
  __shared__ float4 bs[kF32K][kF32Tile / 4];
  float* af = reinterpret_cast<float*>(&as[0][0]);
  float* bf = reinterpret_cast<float*>(&bs[0][0]);
  const int tm = threadIdx.x >> 4, tn = threadIdx.x & 15;
  const int row0 = blockIdx.x * kF32Tile, n0 = blockIdx.y * kF32Tile;
  const float inv_keep = 1.f / p.keep_prob;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float acc[4][4] = {};

  for (int k0 = 0; k0 < p.k; k0 += kF32K) {
    __syncthreads();  // the previous stage is consumed
    {  // a: 64 rows x 16, a float4 a thread, stored transposed
      const int r = threadIdx.x >> 2, kq = (threadIdx.x & 3) * 4;
      const int row = row0 + r;
      float4 v = zero;
      if (row < p.rows) {
        v = *reinterpret_cast<const float4*>(p.a + (size_t)row * p.k + k0 + kq);
        if (kFwd) {
          const uint32_t m =
              *reinterpret_cast<const uint32_t*>(p.mask + (size_t)row * p.k + k0 + kq);
          v.x *= (m & 0xffu) ? inv_keep : 0.f;
          v.y *= (m & 0xff00u) ? inv_keep : 0.f;
          v.z *= (m & 0xff0000u) ? inv_keep : 0.f;
          v.w *= (m & 0xff000000u) ? inv_keep : 0.f;
        }
      }
      af[(kq + 0) * kF32Tile + r] = v.x;
      af[(kq + 1) * kF32Tile + r] = v.y;
      af[(kq + 2) * kF32Tile + r] = v.z;
      af[(kq + 3) * kF32Tile + r] = v.w;
    }
    if (kFwd) {  // W2 rows n0 .. (d_out) as [n][k]: stored transposed
      const int n = threadIdx.x >> 2, kq = (threadIdx.x & 3) * 4;
      const float4 v = *reinterpret_cast<const float4*>(p.w2 + (size_t)(n0 + n) * p.k + k0 + kq);
      bf[(kq + 0) * kF32Tile + n] = v.x;
      bf[(kq + 1) * kF32Tile + n] = v.y;
      bf[(kq + 2) * kF32Tile + n] = v.z;
      bf[(kq + 3) * kF32Tile + n] = v.w;
    } else {  // W2 rows k0 .. (d_out) as [k][n]: as stored
      const int kr = threadIdx.x >> 4, nq = threadIdx.x & 15;
      bs[kr][nq] = *reinterpret_cast<const float4*>(p.w2 + (size_t)(k0 + kr) * p.n + n0 + 4 * nq);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kF32K; ++k) {
      const float4 a = as[k][tm], b = bs[k][tn];
      const float av[4] = {a.x, a.y, a.z, a.w}, bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
  }

  const int col = n0 + 4 * tn;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * tm + i;
    if (row >= p.rows) continue;
    float v[4] = {acc[i][0], acc[i][1], acc[i][2], acc[i][3]};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (kFwd)
        v[j] += p.b2[col + j];
      else
        v[j] *= p.mask[(size_t)row * p.n + col + j] ? inv_keep : 0.f;
    }
    *reinterpret_cast<float4*>(p.out + (size_t)row * p.n + col) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <bool kFwd, typename T>
cudaError_t launch_tiles(const TileArgs<T>& p, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    constexpr size_t smem = kStages * stage_bytes<kFwd>();
    cudaError_t err = cudaFuncSetAttribute(
        masked_mm_bf16<kFwd>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.rows + kBM - 1) / kBM, p.n / kBN);
    masked_mm_bf16<kFwd><<<grid, kTileThreads, smem, stream>>>(p);
  } else {
    const dim3 grid((p.rows + kF32Tile - 1) / kF32Tile, p.n / kF32Tile);
    masked_mm_f32<kFwd><<<grid, kTileThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

bool shapes_ok(int rows, int d_ff, int d_out, float keep_prob) {
  return rows >= 1 && d_ff >= 128 && d_ff % 128 == 0 && d_out >= 128 && d_out % 128 == 0 &&
         keep_prob > 0.f;
}

template <typename T>
int fwd(const void* h, const void* mask, const void* w2, const void* b2, void* out,
        int rows, int d_ff, int d_out, float keep_prob, void* stream) {
  if (!shapes_ok(rows, d_ff, d_out, keep_prob)) return (int)cudaErrorInvalidValue;
  const TileArgs<T> p{static_cast<const T*>(h), static_cast<const T*>(w2),
                      static_cast<const T*>(b2), static_cast<const uint8_t*>(mask),
                      static_cast<T*>(out), rows, d_out, d_ff, keep_prob};
  return (int)launch_tiles<true>(p, static_cast<cudaStream_t>(stream));
}

template <typename T>
int bwd(const void* h, const void* mask, const void* dout, const void* w2, void* dh,
        void* dw2, void* db2, void* partial, int rows, int d_ff, int d_out,
        float keep_prob, void* stream) {
  if (!shapes_ok(rows, d_ff, d_out, keep_prob)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TileArgs<T> p{static_cast<const T*>(dout), static_cast<const T*>(w2), nullptr,
                      static_cast<const uint8_t*>(mask), static_cast<T*>(dh), rows, d_ff,
                      d_out, keep_prob};
  cudaError_t err = launch_tiles<false>(p, s);
  if (err != cudaSuccess) return (int)err;
  // one split's partials: [dW2 (d_out, d_ff) | db2 (d_out)]
  float* part = static_cast<float*>(partial);
  const size_t n_w = (size_t)d_out * d_ff;
  const WeightProblem<T> p_w2{static_cast<const T*>(dout), static_cast<const T*>(h),
                              static_cast<const uint8_t*>(mask), part, part + n_w, d_out,
                              d_ff};
  const WeightProblem<T> none{nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0};
  const SplitOutputs<T, 2> out{{static_cast<T*>(dw2), static_cast<T*>(db2)},
                               {n_w, n_w + d_out}};
  return (int)launch_weights<T, true, 2>(p_w2, none, rows, n_w + d_out, keep_prob, out, s);
}

}  // namespace

// h (rows, d_ff), mask (rows, d_ff) bytes (nonzero = keep), w2 (d_out,
// d_ff), b2 (d_out), out (rows, d_out): contiguous, one dtype (is_bf16 = 1:
// bfloat16, 0: float32) for the tensors, 16-byte aligned. d_ff and d_out
// must be multiples of 128, keep_prob in (0, 1]. stream: a cudaStream_t.
// Returns the cudaError_t of the launch (0 = launched); the wrapper raises
// on non-zero.
extern "C" int masked_mm_fwd(const void* h, const void* mask, const void* w2,
                             const void* b2, void* out, int rows, int d_ff, int d_out,
                             int is_bf16, float keep_prob, void* stream) {
  if (is_bf16) return fwd<bf16>(h, mask, w2, b2, out, rows, d_ff, d_out, keep_prob, stream);
  return fwd<float>(h, mask, w2, b2, out, rows, d_ff, d_out, keep_prob, stream);
}

// The backward for the upstream gradient dout (rows, d_out): dh (rows,
// d_ff), dw2 (d_out, d_ff) and db2 (d_out), in the tensors' dtype. partial:
// fp32 scratch of masked_mm_bwd_partial_floats(d_ff, d_out) elements. Three
// kernels on `stream`; returns the first launch's cudaError_t that is not
// 0, else 0.
extern "C" int masked_mm_bwd(const void* h, const void* mask, const void* dout,
                             const void* w2, void* dh, void* dw2, void* db2, void* partial,
                             int rows, int d_ff, int d_out, int is_bf16, float keep_prob,
                             void* stream) {
  if (is_bf16)
    return bwd<bf16>(h, mask, dout, w2, dh, dw2, db2, partial, rows, d_ff, d_out, keep_prob,
                     stream);
  return bwd<float>(h, mask, dout, w2, dh, dw2, db2, partial, rows, d_ff, d_out, keep_prob,
                    stream);
}

// The fp32 scratch masked_mm_bwd needs: its most splits' partial sums.
extern "C" long long masked_mm_bwd_partial_floats(int d_ff, int d_out) {
  return (long long)kMaxSplits * ((long long)d_out * d_ff + d_out);
}
