// Non-causal flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces: lifelong_nnunet_tpu/models/vit.py, `_flash_attention`, which
// calls jax's bundled Pallas TPU flash attention
// (jax.experimental.pallas.ops.tpu.flash_attention, forward and its custom
// VJP).  Same math: out = softmax(q k^T * scale) v over all N keys (no
// causal mask), scale = hd^-0.5, f32 logits, softmax and accumulation,
// the output in the input dtype; the [B, H, N, N] weights never reach
// device memory.  The forward keeps the row log-sum-exp (f32) for the
// backward, which is FlashAttention-2's recomputation:
//   D = rowsum(dO * O);  P = exp(q k^T * scale - lse);  dV = P^T dO;
//   dP = dO v^T;  dS = P * (dP - D);  dQ = dS k * scale;  dK = dS^T q * scale.
//
// Layout: q, k, v, o, dO, dq, dk, dv [B, H, N, hd] contiguous; lse and D
// [B, H, N] f32.  hd is 64 (ViT base, large) or 80 (huge); N is any
// length: the tail key tile is masked to -inf before the max (its P is 0)
// and the tail query rows are computed on zeros and never stored.
//
// What bounds it on the card: the products.  One forward does 4 B H N^2 hd
// flops on 4 B H N hd elements of traffic, ~N/2 flops a byte in bf16 (245
// at N = 490), at the card's balance point.  This first version runs them
// on the CUDA cores in f32 FMA, not on the tensor cores: mma/wgmma tiles
// are later work.  f32 FMA also keeps one code path for the f32 inputs of
// the gradient checks, which TF32 tensor-core products would not meet.
//
// What the design does about it:
//  * One block of 256 threads per (b, h, 64-row tile): the forward and dQ
//    tile the queries and loop over 64-key tiles; dK/dV tile the keys and
//    loop over 64-query tiles.  Each block stages its own tile and the
//    streamed tiles in shared memory as f32, rows padded to hd + 1 floats
//    so column reads across a warp hit distinct banks.
//  * Each thread owns 4 rows and every 16th column of a 64 x 64 score tile
//    (and of the 64 x hd accumulator): rows are reduced by shuffles inside
//    the 16 lanes that share them, a row's max and sum never leave the warp.
//  * Online softmax in f32 with a running max and sum per row; the weights
//    P stay f32 (unnormalized) for the PV product, and the output is scaled
//    by 1 / sum once at the end.
//  * No atomics: dK/dV and dQ are two kernels, each owning its output tile
//    and summing in a fixed order, so a run repeats bit for bit.

#include <math.h>

#include "lnn_common.cuh"

namespace {

constexpr int kTile = 64;      // query rows per block, keys per streamed tile
constexpr int kThreads = 256;  // 16 x 16: ty = t / 16 owns 4 rows, tx = t % 16 the columns tx + 16 j
constexpr int kRows = 4;
constexpr int kCols = kTile / 16;  // score columns per thread
constexpr int kPStride = kTile + 1;

static_assert(kThreads == (kTile / kRows) * 16, "one 4-row strip per 16 lanes");

// floats of shared memory of each kernel, for head dim HD
template <int HD>
struct Smem {
  static constexpr int kS = HD + 1;  // padded row of a staged tile
  static constexpr int kTileF = kTile * kS;
  static constexpr size_t fwd = sizeof(float) * (3 * kTileF + kTile * kPStride);
  static constexpr size_t dkdv = sizeof(float) * (4 * kTileF + 2 * kTile * kPStride + 2 * kTile);
  static constexpr size_t dq = sizeof(float) * (4 * kTileF + kTile * kPStride + 2 * kTile);
};

// rows [r0, r0 + 64) of a [N, HD] matrix into dst (f32, rows of HD + 1),
// zeros past row N
template <typename T, int HD>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int r0, int N,
                                          float* __restrict__ dst) {
  for (int i = threadIdx.x; i < kTile * HD; i += kThreads) {
    const int r = i / HD, c = i - r * HD;
    dst[r * (HD + 1) + c] = r0 + r < N ? lnn_to_f32(src[(long long)(r0 + r) * HD + c]) : 0.f;
  }
}

// 64 floats of a [N] f32 vector from r0, `fill` past N
__device__ __forceinline__ void load_vec(const float* __restrict__ src, int r0, int N,
                                         float* __restrict__ dst, float fill) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) dst[i] = r0 + i < N ? src[r0 + i] : fill;
}

// max / sum over the 16 lanes that share a row (lanes of one half-warp)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[r][c] = sum_d a[(ty*4 + r)][d] * b[(tx + 16 c)][d] over staged tiles
template <int HD>
__device__ __forceinline__ void tile_dot(const float* __restrict__ a, const float* __restrict__ b,
                                         int ty, int tx, float (&acc)[kRows][kCols]) {
  constexpr int S = HD + 1;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float av[kRows], bv[kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r) av[r] = a[(ty * kRows + r) * S + d];
#pragma unroll
    for (int c = 0; c < kCols; ++c) bv[c] = b[(tx + 16 * c) * S + d];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// acc[r][j] += sum_i p[(ty*4 + r)][i] * m[i][tx + 16 j]: a 64 x 64 weight
// tile (rows of kPStride) times a staged 64 x HD tile
template <int HD>
__device__ __forceinline__ void tile_accumulate(const float* __restrict__ p,
                                                const float* __restrict__ m, int ty, int tx,
                                                float (&acc)[kRows][HD / 16]) {
  constexpr int S = HD + 1;
  constexpr int NC = HD / 16;
#pragma unroll 4
  for (int i = 0; i < kTile; ++i) {
    float pv[kRows], mv[NC];
#pragma unroll
    for (int r = 0; r < kRows; ++r) pv[r] = p[(ty * kRows + r) * kPStride + i];
#pragma unroll
    for (int j = 0; j < NC; ++j) mv[j] = m[i * S + tx + 16 * j];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[r][j] = fmaf(pv[r], mv[j], acc[r][j]);
  }
}

// rows [r0 + ty*4, +4) of a [N, HD] output, columns tx + 16 j, times `mul`
template <typename T, int HD>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, int r0, int N, int ty, int tx,
                                           const float (&acc)[kRows][HD / 16],
                                           const float (&mul)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = r0 + ty * kRows + r;
    if (row >= N) continue;
#pragma unroll
    for (int j = 0; j < HD / 16; ++j)
      dst[(long long)row * HD + tx + 16 * j] = lnn_from_f32<T>(acc[r][j] * mul[r]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, float* __restrict__ lse, int N, float scale) {
  extern __shared__ float smem[];
  constexpr int NC = HD / 16;
  float* qs = smem;
  float* ks = qs + Smem<HD>::kTileF;
  float* vs = ks + Smem<HD>::kTileF;
  float* ps = vs + Smem<HD>::kTileF;
  const long long base = (long long)blockIdx.y * N * HD;
  const int q0 = blockIdx.x * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_tile<T, HD>(q + base, q0, N, qs);
  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[r][j] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += kTile) {
    __syncthreads();  // the previous tile's ks / vs / ps are no longer read
    load_tile<T, HD>(k + base, k0, N, ks);
    load_tile<T, HD>(v + base, k0, N, vs);
    __syncthreads();
    float s[kRows][kCols];
    tile_dot<HD>(qs, ks, ty, tx, s);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        s[r][c] = k0 + tx + 16 * c < N ? s[r][c] * scale : -INFINITY;
        mx = fmaxf(mx, s[r][c]);
      }
      // every tile holds at least one key, so the new max is finite
      const float mnew = fmaxf(m[r], row_max(mx));
      const float corr = expf(m[r] - mnew);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float p = expf(s[r][c] - mnew);
        ps[(ty * kRows + r) * kPStride + tx + 16 * c] = p;
        rs += p;
      }
      l[r] = l[r] * corr + row_sum(rs);
      m[r] = mnew;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[r][j] *= corr;
    }
    __syncthreads();
    tile_accumulate<HD>(ps, vs, ty, tx, acc);
  }

  float inv[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) inv[r] = 1.f / l[r];
  store_rows<T, HD>(o + base, q0, N, ty, tx, acc, inv);
  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = q0 + ty * kRows + r;
      if (row < N) lse[(long long)blockIdx.y * N + row] = m[r] + logf(l[r]);
    }
  }
}

// D[row] = sum_d dO[row][d] * O[row][d], one warp per row
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                           float* __restrict__ delta, long long rows) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int d = lane; d < HD; d += 32)
    s += lnn_to_f32(o[row * HD + d]) * lnn_to_f32(dout[row * HD + d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// dK, dV of one 64-key tile, looping over the query tiles
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int N, float scale) {
  extern __shared__ float smem[];
  constexpr int NC = HD / 16;
  float* ks = smem;
  float* vs = ks + Smem<HD>::kTileF;
  float* qs = vs + Smem<HD>::kTileF;
  float* dos = qs + Smem<HD>::kTileF;
  float* pt = dos + Smem<HD>::kTileF;  // P^T  [key][query]
  float* dst = pt + kTile * kPStride;  // dS^T [key][query]
  float* ls = dst + kTile * kPStride;  // lse of the query tile
  float* ds = ls + kTile;              // D of the query tile
  const long long base = (long long)blockIdx.y * N * HD;
  const float* lse_bh = lse + (long long)blockIdx.y * N;
  const float* delta_bh = delta + (long long)blockIdx.y * N;
  const int k0 = blockIdx.x * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_tile<T, HD>(k + base, k0, N, ks);
  load_tile<T, HD>(v + base, k0, N, vs);
  float dka[kRows][NC], dva[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) dka[r][j] = dva[r][j] = 0.f;

  for (int q0 = 0; q0 < N; q0 += kTile) {
    __syncthreads();  // the previous query tile is no longer read
    load_tile<T, HD>(q + base, q0, N, qs);
    load_tile<T, HD>(dout + base, q0, N, dos);
    load_vec(lse_bh, q0, N, ls, 0.f);
    load_vec(delta_bh, q0, N, ds, 0.f);
    __syncthreads();
    // rows: keys ty*4 + r; columns: queries tx + 16 c
    float s[kRows][kCols], dp[kRows][kCols];
    tile_dot<HD>(ks, qs, ty, tx, s);
    tile_dot<HD>(vs, dos, ty, tx, dp);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int i = tx + 16 * c;
        const float p = q0 + i < N ? expf(s[r][c] * scale - ls[i]) : 0.f;
        pt[(ty * kRows + r) * kPStride + i] = p;
        dst[(ty * kRows + r) * kPStride + i] = p * (dp[r][c] - ds[i]);
      }
    __syncthreads();
    tile_accumulate<HD>(pt, dos, ty, tx, dva);
    tile_accumulate<HD>(dst, qs, ty, tx, dka);
  }

  const float one[kRows] = {1.f, 1.f, 1.f, 1.f};
  const float sc[kRows] = {scale, scale, scale, scale};
  store_rows<T, HD>(dk + base, k0, N, ty, tx, dka, sc);
  store_rows<T, HD>(dv + base, k0, N, ty, tx, dva, one);
}

// dQ of one 64-query tile, looping over the key tiles
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dq, int N, float scale) {
  extern __shared__ float smem[];
  constexpr int NC = HD / 16;
  float* qs = smem;
  float* dos = qs + Smem<HD>::kTileF;
  float* ks = dos + Smem<HD>::kTileF;
  float* vs = ks + Smem<HD>::kTileF;
  float* dss = vs + Smem<HD>::kTileF;  // dS [query][key]
  float* ls = dss + kTile * kPStride;
  float* ds = ls + kTile;
  const long long base = (long long)blockIdx.y * N * HD;
  const int q0 = blockIdx.x * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_tile<T, HD>(q + base, q0, N, qs);
  load_tile<T, HD>(dout + base, q0, N, dos);
  load_vec(lse + (long long)blockIdx.y * N, q0, N, ls, 0.f);
  load_vec(delta + (long long)blockIdx.y * N, q0, N, ds, 0.f);
  float dqa[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) dqa[r][j] = 0.f;

  for (int k0 = 0; k0 < N; k0 += kTile) {
    __syncthreads();  // the previous key tile and dS are no longer read
    load_tile<T, HD>(k + base, k0, N, ks);
    load_tile<T, HD>(v + base, k0, N, vs);
    __syncthreads();
    // rows: queries ty*4 + r; columns: keys tx + 16 c
    float s[kRows][kCols], dp[kRows][kCols];
    tile_dot<HD>(qs, ks, ty, tx, s);
    tile_dot<HD>(dos, vs, ty, tx, dp);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = ty * kRows + r;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int j = tx + 16 * c;
        const float p = k0 + j < N ? expf(s[r][c] * scale - ls[i]) : 0.f;
        dss[i * kPStride + j] = p * (dp[r][c] - ds[i]);
      }
    }
    __syncthreads();
    tile_accumulate<HD>(dss, ks, ty, tx, dqa);
  }

  const float sc[kRows] = {scale, scale, scale, scale};
  store_rows<T, HD>(dq + base, q0, N, ty, tx, dqa, sc);
}

template <typename T, int HD>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                       int BH, int N, float scale, cudaStream_t st) {
  const size_t smem = Smem<HD>::fwd;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((N + kTile - 1) / kTile), (unsigned)BH);
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, N, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, int BH, int N, float scale, cudaStream_t st) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const long long rows = (long long)BH * N;
  flash_bwd_delta_kernel<T, HD><<<(unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32)),
                                  kThreads, 0, st>>>(static_cast<const T*>(o), dot, delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((N + kTile - 1) / kTile), (unsigned)BH);
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem<HD>::dkdv);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T, HD><<<grid, kThreads, Smem<HD>::dkdv, st>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), N, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem<HD>::dq);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, HD><<<grid, kThreads, Smem<HD>::dq, st>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), N, scale);
  return cudaGetLastError();
}

bool bad_shape(int BH, int N, int HD) {
  return BH <= 0 || BH > 65535 || N <= 0 || (HD != 64 && HD != 80);
}

}  // namespace

cudaError_t lnn_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                    float* lse, int BH, int N, int HD, float scale,
                                    LnnDtype dtype, cudaStream_t stream) {
  if (bad_shape(BH, N, HD)) return cudaErrorInvalidValue;
  if (dtype == LNN_F32)
    return HD == 64 ? launch_fwd<float, 64>(q, k, v, o, lse, BH, N, scale, stream)
                    : launch_fwd<float, 80>(q, k, v, o, lse, BH, N, scale, stream);
  if (dtype == LNN_BF16)
    return HD == 64 ? launch_fwd<__nv_bfloat16, 64>(q, k, v, o, lse, BH, N, scale, stream)
                    : launch_fwd<__nv_bfloat16, 80>(q, k, v, o, lse, BH, N, scale, stream);
  return cudaErrorInvalidValue;
}

cudaError_t lnn_flash_attention_bwd(const void* q, const void* k, const void* v,
                                    const void* o, const void* dout, const float* lse,
                                    float* delta, void* dq, void* dk, void* dv, int BH, int N,
                                    int HD, float scale, LnnDtype dtype, cudaStream_t stream) {
  if (bad_shape(BH, N, HD)) return cudaErrorInvalidValue;
  if (dtype == LNN_F32)
    return HD == 64 ? launch_bwd<float, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, BH, N,
                                            scale, stream)
                    : launch_bwd<float, 80>(q, k, v, o, dout, lse, delta, dq, dk, dv, BH, N,
                                            scale, stream);
  if (dtype == LNN_BF16)
    return HD == 64 ? launch_bwd<__nv_bfloat16, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                                    BH, N, scale, stream)
                    : launch_bwd<__nv_bfloat16, 80>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                                    BH, N, scale, stream);
  return cudaErrorInvalidValue;
}
