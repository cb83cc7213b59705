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
// at N = 490), near the card's balance point, so only the tensor cores
// (989 TFLOP/s in bf16, against 67 TFLOP/s of f32 FMA) come near the bound.
// Two sets of kernels, chosen by the input dtype:
//
//  * bf16 (the ViT's training and serving): the tensor-core kernels,
//    `flash_*_tc_kernel`.  A block is one warpgroup (128 threads) on one
//    (b, h) and one 64-row tile; every product is a `wgmma.mma_async`
//    (bf16 x bf16 -> f32).  Tiles of 64 rows x hd are staged by `cp.async`
//    (16 bytes a thread, zeros past N) as 8x8 core matrices, so one staged
//    tile is a K-major operand (its rows M or N, hd K: Q K^T, dO V^T) or,
//    through wgmma's transpose bit, an MN-major one (its rows K, hd N:
//    P V, P^T dO, dS^T Q, dS K) with no transposed copy.  The streamed
//    tiles are double-buffered: tile i + 1's loads are in flight during
//    tile i's products.  The logits' accumulator is in the layout of a
//    register A operand, so the weights P (and dS) go from the softmax in
//    registers, rounded to bf16, straight into the next product; they
//    never touch shared memory.  Row max and sum are shuffles among the 4
//    lanes that share a row.  The forward and dQ tile the queries and loop
//    over 64-key tiles; dK/dV tile the keys and loop over 64-query tiles,
//    computing the transposed products (S^T = K Q^T, dP^T = V dO^T) so the
//    key rows are the accumulator's rows.  64-row tiles keep the grid at
//    ceil(N / 64) B H blocks (96 at the ViT's train shape).
//  * f32 (the f32 step checks): `flash_*_kernel`, f32 FMA on the CUDA
//    cores, so an f32 attention is not rounded to bf16 or TF32.  One block
//    of 256 threads per (b, h, 64-row tile); its own tile and the streamed
//    tiles in shared memory as f32, rows padded to hd + 1 floats; each
//    thread owns 4 rows and every 16th column of a 64 x 64 score tile (and
//    of the 64 x hd accumulator), rows reduced by shuffles inside the 16
//    lanes that share them; the weights P stay f32 for the PV product.
//
// Both: online softmax in f32 with a running max and sum per row, the
// output scaled by 1 / sum once at the end; no atomics: dK/dV and dQ are
// two kernels, each owning its output tile and summing in a fixed order,
// so a run repeats bit for bit.

#include <math.h>

#include "lnn_common.cuh"
#include "lnn_sm90.cuh"

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

// ---------------------------------------------------------------------------
// The tensor-core kernels (bf16 input).

constexpr int kTcThreads = 128;  // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// bytes of a staged 64 x HD bf16 tile, of a 64-float vector, and of each
// tensor-core kernel's shared memory
template <int HD>
struct TcSmem {
  static constexpr int kTileB = kTile * HD * 2;
  static constexpr int kVecB = kTile * 4;
  static constexpr int kStageB = 2 * kTileB + 2 * kVecB;  // dK/dV: Q, dO, lse, D
  static constexpr size_t fwd = 5 * kTileB;                // Q; 2 stages of K, V
  static constexpr size_t dkdv = 2 * kTileB + 2 * kStageB;  // K, V; 2 stages
  static constexpr size_t dq = 6 * kTileB;                 // Q, dO; 2 stages of K, V
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// max / sum over the 4 lanes that share an accumulator row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows [r0, r0 + 64) of a [N, HD] bf16 matrix into shared memory at dst as
// core matrices: 16-byte chunk u = 8 (CH g + c) + r (CH = HD / 8 chunks a
// row) holds row 8 g + r, columns 8 c .. 8 c + 7, so core matrix (g, c) is
// the 128 contiguous bytes at dst + 128 (CH g + c).  Zeros past row N.  A
// warp reads 64 contiguous bytes of each of 8 rows and writes 4 whole core
// matrices.
template <int HD>
__device__ __forceinline__ void stage_tile(unsigned dst, const __nv_bfloat16* __restrict__ src,
                                           int r0, int N) {
  constexpr int CH = HD / 8;
  static_assert(kTile * CH % kTcThreads == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < kTile * CH / kTcThreads; ++i) {
    const int u = threadIdx.x + i * kTcThreads;
    const int gc = u >> 3, row = r0 + gc / CH * 8 + (u & 7);
    const bool ok = row < N;
    cp_async16_zfill(dst + 16 * u, src + (ok ? (long long)row * HD + gc % CH * 8 : 0), ok);
  }
}

// k16 step kk of a staged tile as a K-major operand (its 64 rows M or N,
// hd K): chunks 2 kk and 2 kk + 1 of every row
template <int HD>
__device__ __forceinline__ unsigned long long k_major(unsigned tile, int kk) {
  return desc(tile + 256 * kk, 128, 16 * HD);
}
// ... as an MN-major operand (its rows K, hd N; wgmma's transpose bit):
// rows 16 kk .. 16 kk + 15
template <int HD>
__device__ __forceinline__ unsigned long long mn_major(unsigned tile, int kk) {
  return desc(tile + 32 * HD * kk, 16 * HD, 128);
}

// D[64 x n] += A[64 x 16] B[16 x n], bf16 -> f32, A from registers (a
// fragment in the accumulator's layout, see to_a) and B an MN-major
// operand in shared memory
static __device__ __forceinline__ void wgmma_rs_n64_t(float (&d)[32], const unsigned (&a)[4],
                                                      unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
static __device__ __forceinline__ void wgmma_rs_n80_t(float (&d)[40], const unsigned (&a)[4],
                                                      unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// acc[64 x HD] += A[64 x 16] times rows 16 kk .. 16 kk + 15 of a staged tile
template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&acc)[HD / 2], const unsigned (&a)[4],
                                         unsigned tile, int kk) {
  if constexpr (HD == 64)
    wgmma_rs_n64_t(acc, a, mn_major<HD>(tile, kk));
  else
    wgmma_rs_n80_t(acc, a, mn_major<HD>(tile, kk));
}

// s[64 x 64] = the rows of staged tile a times the rows of staged tile b,
// summed over hd (a b^T, both K-major); the fence orders the zeroing
// before the products that accumulate on it
template <int HD>
__device__ __forceinline__ void wgmma_abt(float (&s)[32], unsigned a, unsigned b) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) wgmma_n64(s, k_major<HD>(a, kk), k_major<HD>(b, kk));
}

// A 64 x 64 accumulator as the register A operand of a product over its
// columns, rounded to bf16: the accumulator's element i of thread (warp w,
// lane l) is row 16 w + l / 4 + 8 ((i >> 1) & 1), column 8 (i >> 2) +
// 2 (l & 3) + (i & 1); A's k step kk takes columns 16 kk .. 16 kk + 15 in
// the same rows and lanes, so the layouts agree with no shuffles.
__device__ __forceinline__ void to_a(const float (&s)[32], unsigned (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// the accumulator column of element i for a lane with l & 3 == quad
__device__ __forceinline__ int acc_col(int i, int quad) {
  return 8 * (i >> 2) + 2 * quad + (i & 1);
}

// rows r0 + row and r0 + row + 8 (where < N) of a [N, HD] bf16 output from
// a 64 x HD accumulator, times mul[0] / mul[1]
template <int HD>
__device__ __forceinline__ void store_acc(__nv_bfloat16* __restrict__ dst, int r0, int row,
                                          int quad, int N, const float (&acc)[HD / 2],
                                          const float (&mul)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int at = r0 + row + 8 * r;
    if (at >= N) continue;
    __nv_bfloat16* out = dst + (long long)at * HD + 2 * quad;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * mul[r], acc[4 * j + 2 * r + 1] * mul[r]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
    flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                        float* __restrict__ lse, int N, float scale) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  constexpr int TB = TcSmem<HD>::kTileB;
  const unsigned qs = smem_addr(tc_smem);  // then stage s: K at qs + TB + 2 TB s, V after it
  const long long base = (long long)blockIdx.y * N * HD;
  const int q0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31, quad = lane & 3;
  const int row = 16 * (threadIdx.x >> 5) + (lane >> 2);  // this thread's rows: row, row + 8
  const int tiles = (N + kTile - 1) / kTile;
  const float sl2 = scale * kLog2e;  // the logits as base-2 exponents

  stage_tile<HD>(qs, q + base, q0, N);
  stage_tile<HD>(qs + TB, k + base, 0, N);
  stage_tile<HD>(qs + 2 * TB, v + base, 0, N);
  cp_async_commit();

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  for (int t = 0; t < tiles; ++t) {
    const unsigned ks = qs + TB + 2 * TB * (t & 1), vs = ks + TB;
    if (t + 1 < tiles) {  // the next K, V tile loads during this tile's products
      const unsigned next = qs + TB + 2 * TB * ((t + 1) & 1);
      stage_tile<HD>(next, k + base, (t + 1) * kTile, N);
      stage_tile<HD>(next + TB, v + base, (t + 1) * kTile, N);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();

    float s[32];
    wgmma_abt<HD>(s, qs, ks);
    wgmma_commit();
    wgmma_wait_all();

    // online softmax on the accumulator, keys past N at -inf
    const int keys = N - t * kTile;
    float mx[2] = {m[0], m[1]}, corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = acc_col(i, quad) < keys ? s[i] * sl2 : -INFINITY;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);  // finite: every tile holds a key
      corr[r] = ex2(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = ex2(s[i] - m[(i >> 1) & 1]);
      sum[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + quad_sum(sum[r]);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
    unsigned p[4][4];
    to_a(s, p);

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<HD>(acc, p[kk], vs, kk);
    wgmma_commit();
    wgmma_wait_all();
    __syncthreads();  // this stage is free for the tile after next
  }

  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  store_acc<HD>(o + base, q0, row, quad, N, acc, inv);
  if (quad == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (q0 + row + 8 * r < N)
        lse[(long long)blockIdx.y * N + q0 + row + 8 * r] = (m[r] + log2f(l[r])) * kLn2;
  }
}

// dK, dV of one 64-key tile, looping over the query tiles: the products
// transposed, so the key rows are the accumulator's rows
template <int HD>
__global__ void __launch_bounds__(kTcThreads)
    flash_bwd_dkdv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                             int N, float scale) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  constexpr int TB = TcSmem<HD>::kTileB, SB = TcSmem<HD>::kStageB;
  const unsigned ks = smem_addr(tc_smem), vs = ks + TB;  // then the stages: Q, dO, lse, D
  const long long base = (long long)blockIdx.y * N * HD;
  const float* lse_bh = lse + (long long)blockIdx.y * N;
  const float* delta_bh = delta + (long long)blockIdx.y * N;
  const int k0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31, quad = lane & 3;
  const int row = 16 * (threadIdx.x >> 5) + (lane >> 2);
  const int tiles = (N + kTile - 1) / kTile;
  const float sl2 = scale * kLog2e;

  // query tile t into stage t & 1: Q, dO, then lse (threads 0-63) and D
  // (64-127) of its rows, zeros past N
  auto load_queries = [&](int t) {
    const unsigned st = vs + TB + SB * (t & 1);
    const int q0 = t * kTile, i = q0 + (threadIdx.x & (kTile - 1));
    stage_tile<HD>(st, q + base, q0, N);
    stage_tile<HD>(st + TB, dout + base, q0, N);
    cp_async4_zfill(st + 2 * TB + 4 * threadIdx.x,
                    (threadIdx.x < kTile ? lse_bh : delta_bh) + (i < N ? i : 0), i < N);
    cp_async_commit();
  };
  stage_tile<HD>(ks, k + base, k0, N);
  stage_tile<HD>(vs, v + base, k0, N);
  load_queries(0);  // one group with K and V

  float dka[HD / 2], dva[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.f;
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      load_queries(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();
    const unsigned qs = vs + TB + SB * (t & 1), dos = qs + TB;
    const float* ls = reinterpret_cast<const float*>(tc_smem + 4 * TB + SB * (t & 1));
    const float* ds = ls + kTile;

    float st[32], dpt[32];  // S^T = K Q^T, dP^T = V dO^T
    wgmma_abt<HD>(st, ks, qs);
    wgmma_abt<HD>(dpt, vs, dos);
    wgmma_commit();
    wgmma_wait_all();

    // P^T = exp(S^T scale - lse), dS^T = P^T (dP^T - D); column c is query
    // t * 64 + c, 0 past N
    const int queries = N - t * kTile;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = acc_col(i, quad);
      const float p = c < queries ? ex2(fmaf(st[i], sl2, -ls[c] * kLog2e)) : 0.f;
      st[i] = p;
      dpt[i] = p * (dpt[i] - ds[c]);
    }
    unsigned pa[4][4], dsa[4][4];
    to_a(st, pa);
    to_a(dpt, dsa);

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<HD>(dva, pa[kk], dos, kk);  // dV += P^T dO
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<HD>(dka, dsa[kk], qs, kk);  // dK += dS^T Q
    wgmma_commit();
    wgmma_wait_all();
    __syncthreads();
  }

  const float sc[2] = {scale, scale}, one[2] = {1.f, 1.f};
  store_acc<HD>(dk + base, k0, row, quad, N, dka, sc);
  store_acc<HD>(dv + base, k0, row, quad, N, dva, one);
}

// dQ of one 64-query tile, looping over the key tiles
template <int HD>
__global__ void __launch_bounds__(kTcThreads)
    flash_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dq, int N, float scale) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  constexpr int TB = TcSmem<HD>::kTileB;
  const unsigned qs = smem_addr(tc_smem), dos = qs + TB;  // then stage s: K, V at qs + 2 TB (1 + s)
  const long long base = (long long)blockIdx.y * N * HD;
  const int q0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31, quad = lane & 3;
  const int row = 16 * (threadIdx.x >> 5) + (lane >> 2);
  const int tiles = (N + kTile - 1) / kTile;
  const float sl2 = scale * kLog2e;

  stage_tile<HD>(qs, q + base, q0, N);
  stage_tile<HD>(dos, dout + base, q0, N);
  stage_tile<HD>(qs + 2 * TB, k + base, 0, N);
  stage_tile<HD>(qs + 3 * TB, v + base, 0, N);
  cp_async_commit();
  // this thread's rows' lse (as a base-2 exponent) and D
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int at = q0 + row + 8 * r;
    const long long i = (long long)blockIdx.y * N + (at < N ? at : 0);
    lr[r] = at < N ? lse[i] * kLog2e : 0.f;
    dr[r] = at < N ? delta[i] : 0.f;
  }

  float dqa[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dqa[i] = 0.f;
  for (int t = 0; t < tiles; ++t) {
    const unsigned ks = qs + 2 * TB * (1 + (t & 1)), vs = ks + TB;
    if (t + 1 < tiles) {
      const unsigned next = qs + 2 * TB * (1 + ((t + 1) & 1));
      stage_tile<HD>(next, k + base, (t + 1) * kTile, N);
      stage_tile<HD>(next + TB, v + base, (t + 1) * kTile, N);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();

    float s[32], dp[32];  // S = Q K^T, dP = dO V^T
    wgmma_abt<HD>(s, qs, ks);
    wgmma_abt<HD>(dp, dos, vs);
    wgmma_commit();
    wgmma_wait_all();

    // dS = P (dP - D), P = exp(S scale - lse), 0 for keys past N
    const int keys = N - t * kTile;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const float p = acc_col(i, quad) < keys ? ex2(fmaf(s[i], sl2, -lr[r])) : 0.f;
      dp[i] = p * (dp[i] - dr[r]);
    }
    unsigned dsa[4][4];
    to_a(dp, dsa);

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<HD>(dqa, dsa[kk], ks, kk);  // dQ += dS K
    wgmma_commit();
    wgmma_wait_all();
    __syncthreads();
  }

  const float sc[2] = {scale, scale};
  store_acc<HD>(dq + base, q0, row, quad, N, dqa, sc);
}

dim3 tile_grid(int BH, int N) { return dim3((unsigned)((N + kTile - 1) / kTile), (unsigned)BH); }

template <typename T, int HD>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                       int BH, int N, float scale, cudaStream_t st) {
  const size_t smem = Smem<HD>::fwd;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<T, HD><<<tile_grid(BH, N), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, N, scale);
  return cudaGetLastError();
}

// D = rowsum(dO * O), the first kernel of either backward
template <typename T, int HD>
cudaError_t launch_delta(const void* o, const void* dout, float* delta, int BH, int N,
                         cudaStream_t st) {
  const long long rows = (long long)BH * N;
  flash_bwd_delta_kernel<T, HD><<<(unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32)),
                                  kThreads, 0, st>>>(static_cast<const T*>(o),
                                                     static_cast<const T*>(dout), delta, rows);
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
  cudaError_t err = launch_delta<T, HD>(o, dout, delta, BH, N, st);
  if (err != cudaSuccess) return err;
  const dim3 grid = tile_grid(BH, N);
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

template <int HD>
cudaError_t launch_tc_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                          int BH, int N, float scale, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  const size_t smem = TcSmem<HD>::fwd;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tc_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_fwd_tc_kernel<HD><<<tile_grid(BH, N), kTcThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, N, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_tc_bwd(const void* q, const void* k, const void* v, const void* o,
                          const void* dout, const float* lse, float* delta, void* dq, void* dk,
                          void* dv, int BH, int N, float scale, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  cudaError_t err = launch_delta<bf16, HD>(o, dout, delta, BH, N, st);
  if (err != cudaSuccess) return err;
  const dim3 grid = tile_grid(BH, N);
  err = cudaFuncSetAttribute(flash_bwd_dkdv_tc_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)TcSmem<HD>::dkdv);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_tc_kernel<HD><<<grid, kTcThreads, TcSmem<HD>::dkdv, st>>>(
      qt, kt, vt, dot, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), N, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TcSmem<HD>::dq);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_tc_kernel<HD><<<grid, kTcThreads, TcSmem<HD>::dq, st>>>(
      qt, kt, vt, dot, lse, delta, static_cast<bf16*>(dq), N, scale);
  return cudaGetLastError();
}

bool bad_shape(int BH, int N, int HD) {
  return BH <= 0 || BH > 65535 || N <= 0 || (HD != 64 && HD != 80);
}

}  // namespace

cudaError_t lnn_flash_attention_fwd(const float* q, const float* k, const float* v, float* o,
                                    float* lse, int BH, int N, int HD, float scale,
                                    cudaStream_t stream) {
  if (bad_shape(BH, N, HD)) return cudaErrorInvalidValue;
  return HD == 64 ? launch_fwd<float, 64>(q, k, v, o, lse, BH, N, scale, stream)
                  : launch_fwd<float, 80>(q, k, v, o, lse, BH, N, scale, stream);
}

cudaError_t lnn_flash_attention_bwd(const float* q, const float* k, const float* v,
                                    const float* o, const float* dout, const float* lse,
                                    float* delta, float* dq, float* dk, float* dv, int BH,
                                    int N, int HD, float scale, cudaStream_t stream) {
  if (bad_shape(BH, N, HD)) return cudaErrorInvalidValue;
  return HD == 64 ? launch_bwd<float, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, BH, N,
                                          scale, stream)
                  : launch_bwd<float, 80>(q, k, v, o, dout, lse, delta, dq, dk, dv, BH, N,
                                          scale, stream);
}

cudaError_t lnn_flash_attention_tc_fwd(const void* q, const void* k, const void* v, void* o,
                                       float* lse, int BH, int N, int HD, float scale,
                                       cudaStream_t stream) {
  if (bad_shape(BH, N, HD)) return cudaErrorInvalidValue;
  return HD == 64 ? launch_tc_fwd<64>(q, k, v, o, lse, BH, N, scale, stream)
                  : launch_tc_fwd<80>(q, k, v, o, lse, BH, N, scale, stream);
}

cudaError_t lnn_flash_attention_tc_bwd(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const float* lse,
                                       float* delta, void* dq, void* dk, void* dv, int BH,
                                       int N, int HD, float scale, cudaStream_t stream) {
  if (bad_shape(BH, N, HD)) return cudaErrorInvalidValue;
  return HD == 64 ? launch_tc_bwd<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, BH, N, scale,
                                      stream)
                  : launch_tc_bwd<80>(q, k, v, o, dout, lse, delta, dq, dk, dv, BH, N, scale,
                                      stream);
}
