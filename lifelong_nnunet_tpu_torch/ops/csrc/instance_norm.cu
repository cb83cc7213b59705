// Fused InstanceNorm + LeakyReLU, forward and backward, for Hopper (sm_90a).
//
// Replaces: lifelong_nnunet_tpu/ops/pallas/instance_norm.py, `_fwd_kernel`
// (reached through `_fwd_call` / `instance_norm_leaky`) and `_bwd_kernel`
// (reached through `_in_bwd`).  Forward, the same math: per (batch,
// channel) f32 statistics over all N spatial positions, a two-pass
// variance (each piece's mean first, then the mean of (x - mean)^2; never
// E[x^2] - mean^2), eps 1e-5, then LeakyReLU((x - mean) * rstd * scale +
// bias) written in x's dtype.  Backward, the math of `_bwd_kernel`: xhat =
// (x - mean) * rstd from the saved f32 statistics, the LeakyReLU mask from
// y = xhat * scale + bias (the output is not kept), then with dz = g or
// alpha * g and n = N,
//   dscale = sum dz * xhat,  dbias = sum dz,
//   dx = rstd * (scale * dz - mean(scale * dz) - xhat * mean(scale * dz * xhat)).
// The fused conv's backward (`_fused_bwd`, ops/pallas/conv3d.py:319-332) is
// the same math with x := the raw conv output and rstd := inv, so it calls
// this launcher too.
//
// Layout: channels-first rows, x [B, C, N] contiguous, so one (b, c) row is
// N contiguous elements.
//
// What bounds it on the card: memory bandwidth.  A row must be read once
// (x; x and g backward) and written once, for ~10 flops an element.
//
// What the design does about it.  The caller's launch plan (`launch_plan`
// in ops/kernels/instance_norm.py, passed in as LnnInPlan) picks one of two
// kernels per (B, C, N, dtype):
//  - the warp form, for rows of at most 512 elements (the deep stages,
//    7x10x7 and 7x5x7, thousands of rows at the serving batch): one warp
//    per row, the row in registers, both reductions by shuffles only;
//  - the cluster form, for longer rows: the row is split over a thread-block
//    cluster of `cluster` blocks (1 to 16) when rows are too few to give
//    the 132 SMs a block each, or to keep each block's slice on chip; each
//    block stages its slice in shared memory with 16-byte cp.async, reduces
//    it there and writes from there, so a row is read from device memory
//    once.  A slice longer than the block keeps (`keep` < `slice`: the CT
//    128^3 rows, 4 MB in bf16, keep a quarter in 64 KB a block) streams the
//    rest twice, in chunks of blockDim x kItems 16-byte items in flight a
//    thread, the second time last chunk first, while the L2 still holds it.
// The blocks of a cluster combine their pieces through distributed shared
// memory (map_shared_rank), every block in rank order, so every block
// computes the same bits: forward, each piece's (count, mean, M2) is taken
// two-pass and the pieces merge by Chan's formula (the kept part first,
// then the streamed chunks, then the ranks); backward, the two sums (in
// f64 from each thread's running sums to the row's) add in rank order.  No atomics: a second run repeats bit for bit.  16-byte
// vector access (8 bf16 or 4 f32) wherever the rows are aligned, scalar
// access elsewhere (245- and 490-element bf16 rows start off 16 bytes).
// Per-row dscale / dbias go to a [2, B, C] scratch that a second, tiny
// kernel sums over B in a fixed order.

#include <cooperative_groups.h>

#include <climits>
#include <cstdint>
#include <utility>

#include "lnn_common.cuh"
#include "lnn_sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarpRows = 4;         // rows of the warp form per block, a warp each
constexpr int kWarpElems = 16;       // elements a lane of the warp form holds
constexpr int kClusterThreads = 512; // the most threads of a cluster-form block
constexpr int kFwdItems = 4;         // items a thread has in flight per streamed chunk
constexpr int kBwdItems = 2;         // (x and g each, backward)
constexpr int kMaxCluster = 16;

// W elements of T, loaded and stored as one access (16 bytes for a vector)
template <typename T, int W>
struct alignas(sizeof(T) * W) Pack {
  T v[W];
};

template <typename T>
constexpr int vec_width() {
  return 16 / (int)sizeof(T);
}

template <typename T, int W>
static __device__ __forceinline__ Pack<T, W> load_pack(const T* p, long long i) {
  return reinterpret_cast<const Pack<T, W>*>(p)[i];
}

static __device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (n, mean, m2) <- the union of itself and (nb, mb, m2b): Chan's parallel
// formula, exact in exact arithmetic (m2 a sum of centred squares)
static __device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2, float nb,
                                                  float mb, float m2b) {
  const float tot = n + nb;
  const float d = mb - mean;
  mean += d * (nb / tot);
  m2 += m2b + d * d * (n * nb / tot);
  n = tot;
}

// the first item of the last streamed chunk of items [k_items, n_items),
// chunks of `chunk` items from k_items on; k_items - chunk when none
static __device__ __forceinline__ long long last_chunk(long long k_items, long long n_items,
                                                       long long chunk) {
  return k_items + (n_items - k_items - 1 + chunk) / chunk * chunk - chunk;
}

// `items` items of the block's slice from src into shared dst: 16-byte
// cp.async for a vector item, else plain loads and stores
template <typename T, int W>
static __device__ __forceinline__ void stage(T* dst, const T* src, long long items) {
  if constexpr (W > 1) {
    for (long long i = threadIdx.x; i < items; i += blockDim.x)
      cp_async16(smem_addr(dst + i * W), src + i * W);
  } else {
    for (long long i = threadIdx.x; i < items; i += blockDim.x) dst[i] = src[i];
  }
}

// ---- the warp form: one warp per row of N <= 32 * kWarpElems elements

template <typename T, int W>
__global__ void __launch_bounds__(32 * kWarpRows)
    in_fwd_warp_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                       const float* __restrict__ bias, T* __restrict__ out,
                       float* __restrict__ mean_out, float* __restrict__ rstd_out,
                       long long rows, int C, int N, float alpha, float eps) {
  constexpr int kSlots = kWarpElems / W;
  const long long row = (long long)blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int items = N / W;
  const T* xr = x + row * N;
  float v[kSlots][W];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int i = lane + 32 * j;
    if (i < items) {
      const Pack<T, W> p = load_pack<T, W>(xr, i);
#pragma unroll
      for (int k = 0; k < W; ++k) {
        v[j][k] = lnn_to_f32(p.v[k]);
        s += v[j][k];
      }
    } else {
#pragma unroll
      for (int k = 0; k < W; ++k) v[j][k] = 0.f;
    }
  }
  const float mean = warp_sum(s) / (float)N;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    if (lane + 32 * j < items) {
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const float d = v[j][k] - mean;
        q += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / (float)N + eps);
  const int c = (int)(row % C);
  const float sc = scale[c], b = bias[c];
  Pack<T, W>* orow = reinterpret_cast<Pack<T, W>*>(out + row * N);
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int i = lane + 32 * j;
    if (i < items) {
      Pack<T, W> o;
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const float y = (v[j][k] - mean) * rstd * sc + b;
        o.v[k] = lnn_from_f32<T>(y >= 0.f ? y : alpha * y);
      }
      orow[i] = o;
    }
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename T, typename Tdx, int W>
__global__ void __launch_bounds__(32 * kWarpRows)
    in_bwd_warp_kernel(const T* __restrict__ x, const T* __restrict__ g,
                       const float* __restrict__ scale, const float* __restrict__ bias,
                       const float* __restrict__ mean, const float* __restrict__ rstd,
                       Tdx* __restrict__ dx, float* __restrict__ partials, long long rows,
                       int C, int N, float alpha) {
  constexpr int kSlots = kWarpElems / W;
  const long long row = (long long)blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int items = N / W;
  const int c = (int)(row % C);
  const float m = mean[row], r = rstd[row], sc = scale[c], bi = bias[c];
  const T* xr = x + row * N;
  const T* gr = g + row * N;
  float xh[kSlots][W], dz[kSlots][W];
  float s_dz = 0.f, s_dzx = 0.f;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int i = lane + 32 * j;
    if (i < items) {
      const Pack<T, W> px = load_pack<T, W>(xr, i), pg = load_pack<T, W>(gr, i);
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const float xhat = (lnn_to_f32(px.v[k]) - m) * r;
        const float gi = lnn_to_f32(pg.v[k]);
        const float d = xhat * sc + bi >= 0.f ? gi : alpha * gi;
        xh[j][k] = xhat;
        dz[j][k] = d;
        s_dz += d;
        s_dzx += d * xhat;
      }
    } else {
#pragma unroll
      for (int k = 0; k < W; ++k) xh[j][k] = dz[j][k] = 0.f;
    }
  }
  s_dz = warp_sum(s_dz);
  s_dzx = warp_sum(s_dzx);
  const float n = (float)N;
  const float m1 = sc * s_dz / n;   // mean(dxhat)
  const float m2 = sc * s_dzx / n;  // mean(dxhat * xhat)
  Pack<Tdx, W>* dxr = reinterpret_cast<Pack<Tdx, W>*>(dx + row * N);
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int i = lane + 32 * j;
    if (i < items) {
      Pack<Tdx, W> o;
#pragma unroll
      for (int k = 0; k < W; ++k)
        o.v[k] = lnn_from_f32<Tdx>(r * (dz[j][k] * sc - m1 - xh[j][k] * m2));
      dxr[i] = o;
    }
  }
  if (lane == 0) {
    partials[row] = s_dzx;        // dscale of (b, c)
    partials[rows + row] = s_dz;  // dbias of (b, c)
  }
}

// ---- the cluster form: block `rank` of a row's cluster owns elements
// [rank * slice, min(N, (rank + 1) * slice)); the first `keep` of them lie
// in shared memory, the rest stream

template <typename T, int W>
__global__ void __launch_bounds__(kClusterThreads, 2)
    in_fwd_cluster_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                          const float* __restrict__ bias, T* __restrict__ out,
                          float* __restrict__ mean_out, float* __restrict__ rstd_out, int C,
                          long long N, long long slice, long long keep, int cs, float alpha,
                          float eps) {
  extern __shared__ __align__(16) unsigned char in_smem[];
  __shared__ float red[32];
  __shared__ float piece[3];   // this block's (n, mean, m2), read by its cluster
  __shared__ float merged[2];  // the row's (mean, m2), from thread 0
  using P = Pack<T, W>;
  T* sx = reinterpret_cast<T*>(in_smem);
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long row = blockIdx.x / cs;
  const int rank = (int)(blockIdx.x % cs);
  const long long s0 = rank * slice;
  const long long n_items = (min(N, s0 + slice) - s0) / W;
  const long long k_items = min(keep / W, n_items);
  const long long chunk = (long long)nt * kFwdItems;
  const T* xr = x + row * N + s0;

  stage<T, W>(sx, xr, k_items);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  float n = 0.f, mean = 0.f, m2 = 0.f;
  if (k_items > 0) {  // the kept part: one piece, two passes over shared memory
    float s = 0.f;
    for (long long i = tid; i < k_items; i += nt) {
      const P p = load_pack<T, W>(sx, i);
#pragma unroll
      for (int k = 0; k < W; ++k) s += lnn_to_f32(p.v[k]);
    }
    const float nk = (float)(k_items * W);
    const float mk = lnn_block_sum(s, red) / nk;
    float q = 0.f;
    for (long long i = tid; i < k_items; i += nt) {
      const P p = load_pack<T, W>(sx, i);
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const float d = lnn_to_f32(p.v[k]) - mk;
        q += d * d;
      }
    }
    chan_merge(n, mean, m2, nk, mk, lnn_block_sum(q, red));
  }
  for (long long c0 = k_items; c0 < n_items; c0 += chunk) {  // the streamed chunks
    const long long c1 = min(n_items, c0 + chunk);
    P p[kFwdItems];
    float s = 0.f;
#pragma unroll
    for (int u = 0; u < kFwdItems; ++u) {
      const long long i = c0 + tid + (long long)u * nt;
      if (i < c1) p[u] = load_pack<T, W>(xr, i);
    }
#pragma unroll
    for (int u = 0; u < kFwdItems; ++u) {
      if (c0 + tid + (long long)u * nt < c1) {
#pragma unroll
        for (int k = 0; k < W; ++k) s += lnn_to_f32(p[u].v[k]);
      }
    }
    const float nc = (float)((c1 - c0) * W);
    const float mc = lnn_block_sum(s, red) / nc;
    float q = 0.f;
#pragma unroll
    for (int u = 0; u < kFwdItems; ++u) {
      if (c0 + tid + (long long)u * nt < c1) {
#pragma unroll
        for (int k = 0; k < W; ++k) {
          const float d = lnn_to_f32(p[u].v[k]) - mc;
          q += d * d;
        }
      }
    }
    chan_merge(n, mean, m2, nc, mc, lnn_block_sum(q, red));
  }

  if (cs > 1) {  // the row's pieces, merged in rank order by every block
    cg::cluster_group cluster = cg::this_cluster();
    if (tid == 0) {
      piece[0] = n;
      piece[1] = mean;
      piece[2] = m2;
    }
    cluster.sync();
    if (tid == 0) {
      float tn = 0.f, tm = 0.f, tq = 0.f;
      for (int r = 0; r < cs; ++r) {
        const float* o = cluster.map_shared_rank(piece, r);
        chan_merge(tn, tm, tq, o[0], o[1], o[2]);
      }
      merged[0] = tm;
      merged[1] = tq;
    }
    cluster.sync();  // every block has read the others' pieces
    mean = merged[0];
    m2 = merged[1];
  }
  const float rstd = rsqrtf(m2 / (float)N + eps);

  const int c = (int)(row % C);
  const float sc = scale[c], b = bias[c];
  P* op = reinterpret_cast<P*>(out + row * N + s0);
  auto act = [&](const P& p) {
    P o;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const float y = (lnn_to_f32(p.v[k]) - mean) * rstd * sc + b;
      o.v[k] = lnn_from_f32<T>(y >= 0.f ? y : alpha * y);
    }
    return o;
  };
  // the streamed chunks again, last first: the L2 still holds the latest
  for (long long c0 = last_chunk(k_items, n_items, chunk); c0 >= k_items; c0 -= chunk) {
    P p[kFwdItems];
#pragma unroll
    for (int u = 0; u < kFwdItems; ++u) {
      const long long i = c0 + tid + (long long)u * nt;
      if (i < n_items) p[u] = load_pack<T, W>(xr, i);
    }
#pragma unroll
    for (int u = 0; u < kFwdItems; ++u) {
      const long long i = c0 + tid + (long long)u * nt;
      if (i < n_items) op[i] = act(p[u]);
    }
  }
  for (long long i = tid; i < k_items; i += nt) op[i] = act(load_pack<T, W>(sx, i));
  if (rank == 0 && tid == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename T, typename Tdx, int W>
__global__ void __launch_bounds__(kClusterThreads, 2)
    in_bwd_cluster_kernel(const T* __restrict__ x, const T* __restrict__ g,
                          const float* __restrict__ scale, const float* __restrict__ bias,
                          const float* __restrict__ mean, const float* __restrict__ rstd,
                          Tdx* __restrict__ dx, float* __restrict__ partials, long long rows,
                          int C, long long N, long long slice, long long keep, int cs,
                          float alpha) {
  extern __shared__ __align__(16) unsigned char in_smem[];
  __shared__ double red[32];
  __shared__ double piece[2];   // this block's (sum dz, sum dz xhat)
  __shared__ double merged[2];  // the row's, from thread 0
  using P = Pack<T, W>;
  using Q = Pack<Tdx, W>;
  T* sx = reinterpret_cast<T*>(in_smem);
  T* sg = sx + keep;
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long row = blockIdx.x / cs;
  const int rank = (int)(blockIdx.x % cs);
  const long long s0 = rank * slice;
  const long long n_items = (min(N, s0 + slice) - s0) / W;
  const long long k_items = min(keep / W, n_items);
  const long long chunk = (long long)nt * kBwdItems;
  const T* xr = x + row * N + s0;
  const T* gr = g + row * N + s0;

  stage<T, W>(sx, xr, k_items);
  stage<T, W>(sg, gr, k_items);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int c = (int)(row % C);
  const float m = mean[row], r = rstd[row], sc = scale[c], bi = bias[c];
  // the sums in f64 up to the row's: in f32 they carried ~1e-3 of
  // roundoff into dscale and dbias at rows of 3.3M elements (a 128x160x160
  // map), each thread adding hundreds of items; a pack's W terms add in f32
  double a_dz = 0.0, a_dzx = 0.0;
  auto acc = [&](const P& px, const P& pg) {
    float p_dz = 0.f, p_dzx = 0.f;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const float xhat = (lnn_to_f32(px.v[k]) - m) * r;
      const float gi = lnn_to_f32(pg.v[k]);
      const float d = xhat * sc + bi >= 0.f ? gi : alpha * gi;
      p_dz += d;
      p_dzx += d * xhat;
    }
    a_dz += p_dz;
    a_dzx += p_dzx;
  };
  for (long long i = tid; i < k_items; i += nt)
    acc(load_pack<T, W>(sx, i), load_pack<T, W>(sg, i));
  for (long long c0 = k_items; c0 < n_items; c0 += chunk) {
    P px[kBwdItems], pg[kBwdItems];
#pragma unroll
    for (int u = 0; u < kBwdItems; ++u) {
      const long long i = c0 + tid + (long long)u * nt;
      if (i < n_items) {
        px[u] = load_pack<T, W>(xr, i);
        pg[u] = load_pack<T, W>(gr, i);
      }
    }
#pragma unroll
    for (int u = 0; u < kBwdItems; ++u)
      if (c0 + tid + (long long)u * nt < n_items) acc(px[u], pg[u]);
  }
  double s_dz = lnn_block_sum(a_dz, red);
  double s_dzx = lnn_block_sum(a_dzx, red);

  if (cs > 1) {  // the row's sums, added in rank order by every block
    cg::cluster_group cluster = cg::this_cluster();
    if (tid == 0) {
      piece[0] = s_dz;
      piece[1] = s_dzx;
    }
    cluster.sync();
    if (tid == 0) {
      double t_dz = 0.0, t_dzx = 0.0;
      for (int q = 0; q < cs; ++q) {
        const double* o = cluster.map_shared_rank(piece, q);
        t_dz += o[0];
        t_dzx += o[1];
      }
      merged[0] = t_dz;
      merged[1] = t_dzx;
    }
    cluster.sync();  // every block has read the others' sums
    s_dz = merged[0];
    s_dzx = merged[1];
  }
  const float m1 = (float)(sc * s_dz / N);   // mean(dxhat)
  const float m2 = (float)(sc * s_dzx / N);  // mean(dxhat * xhat)

  Q* dp = reinterpret_cast<Q*>(dx + row * N + s0);
  auto grad = [&](const P& px, const P& pg) {
    Q o;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const float xhat = (lnn_to_f32(px.v[k]) - m) * r;
      const float gi = lnn_to_f32(pg.v[k]);
      const float d = xhat * sc + bi >= 0.f ? gi : alpha * gi;
      o.v[k] = lnn_from_f32<Tdx>(r * (d * sc - m1 - xhat * m2));
    }
    return o;
  };
  // the streamed chunks again, last first: the L2 still holds the latest
  for (long long c0 = last_chunk(k_items, n_items, chunk); c0 >= k_items; c0 -= chunk) {
    P px[kBwdItems], pg[kBwdItems];
#pragma unroll
    for (int u = 0; u < kBwdItems; ++u) {
      const long long i = c0 + tid + (long long)u * nt;
      if (i < n_items) {
        px[u] = load_pack<T, W>(xr, i);
        pg[u] = load_pack<T, W>(gr, i);
      }
    }
#pragma unroll
    for (int u = 0; u < kBwdItems; ++u) {
      const long long i = c0 + tid + (long long)u * nt;
      if (i < n_items) dp[i] = grad(px[u], pg[u]);
    }
  }
  for (long long i = tid; i < k_items; i += nt)
    dp[i] = grad(load_pack<T, W>(sx, i), load_pack<T, W>(sg, i));
  if (rank == 0 && tid == 0) {
    partials[row] = (float)s_dzx;        // dscale of (b, c)
    partials[rows + row] = (float)s_dz;  // dbias of (b, c)
  }
}

// dscale[c] = sum_b partials[0][b][c], dbias[c] = sum_b partials[1][b][c],
// b in order.
__global__ void sum_over_batch_kernel(const float* __restrict__ partials,
                                      float* __restrict__ dscale,
                                      float* __restrict__ dbias, int B, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const long long BC = (long long)B * C;
  float s = 0.f, t = 0.f;
  for (int b = 0; b < B; ++b) {
    s += partials[(long long)b * C + c];
    t += partials[BC + (long long)b * C + c];
  }
  dscale[c] = s;
  dbias[c] = t;
}

// ---- launching

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// what the kernels rely on: every element of a row in exactly one item of
// one block, every block of a cluster with at least one item
bool plan_ok(const LnnInPlan& p, long long rows, long long N, int W) {
  if (N % W != 0) return false;
  if (p.form == LNN_IN_WARP)
    return N <= 32LL * kWarpElems && (rows + kWarpRows - 1) / kWarpRows <= INT_MAX;
  if (p.form != LNN_IN_CLUSTER) return false;
  return p.cluster >= 1 && p.cluster <= kMaxCluster && p.threads >= 32 &&
         p.threads <= kClusterThreads && p.threads % 32 == 0 && p.slice > 0 &&
         p.slice % W == 0 && p.keep >= 0 && p.keep <= p.slice && p.keep % W == 0 &&
         (long long)p.cluster * p.slice >= N && (long long)(p.cluster - 1) * p.slice < N &&
         rows * p.cluster <= INT_MAX;
}

// the cluster kernel's attributes (`smem` bytes of dynamic shared memory,
// clusters of 16 where asked) and launch configuration
template <typename... Exp>
cudaError_t configure(void (*kernel)(Exp...), int cs, size_t smem, cudaLaunchConfig_t& cfg,
                      cudaLaunchAttribute& attr) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cs > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = cs > 1 ? 1 : 0;
  return err;
}

template <typename... Exp, typename... Act>
cudaError_t launch_cluster(void (*kernel)(Exp...), const LnnInPlan& p, long long rows,
                           size_t smem, cudaStream_t stream, Act&&... args) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cudaError_t err = configure(kernel, p.cluster, smem, cfg, attr);
  if (err != cudaSuccess) return err;
  cfg.gridDim = dim3((unsigned)(rows * p.cluster));
  cfg.blockDim = dim3((unsigned)p.threads);
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Act>(args)...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd(const void* x, const float* scale, const float* bias, void* out,
                       float* mean, float* rstd, long long rows, int C, long long N,
                       float alpha, float eps, const LnnInPlan& p, cudaStream_t stream) {
  constexpr int V = vec_width<T>();
  if (!plan_ok(p, rows, N, p.vec ? V : 1) || (p.vec && !(aligned(x, 16) && aligned(out, 16))))
    return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (p.form == LNN_IN_WARP) {
    const dim3 grid((unsigned)((rows + kWarpRows - 1) / kWarpRows));
    if (p.vec)
      in_fwd_warp_kernel<T, V><<<grid, 32 * kWarpRows, 0, stream>>>(
          xt, scale, bias, ot, mean, rstd, rows, C, (int)N, alpha, eps);
    else
      in_fwd_warp_kernel<T, 1><<<grid, 32 * kWarpRows, 0, stream>>>(
          xt, scale, bias, ot, mean, rstd, rows, C, (int)N, alpha, eps);
    return cudaGetLastError();
  }
  const size_t smem = (size_t)p.keep * sizeof(T);
  if (p.vec)
    return launch_cluster(in_fwd_cluster_kernel<T, V>, p, rows, smem, stream, xt, scale, bias,
                          ot, mean, rstd, C, N, p.slice, p.keep, p.cluster, alpha, eps);
  return launch_cluster(in_fwd_cluster_kernel<T, 1>, p, rows, smem, stream, xt, scale, bias,
                        ot, mean, rstd, C, N, p.slice, p.keep, p.cluster, alpha, eps);
}

template <typename T, typename Tdx>
cudaError_t launch_bwd(const void* x, const void* g, const float* scale, const float* bias,
                       const float* mean, const float* rstd, void* dx, float* dscale,
                       float* dbias, float* partials, int B, int C, long long N, float alpha,
                       const LnnInPlan& p, cudaStream_t stream) {
  constexpr int V = vec_width<T>();
  const long long rows = (long long)B * C;
  if (!plan_ok(p, rows, N, p.vec ? V : 1) ||
      (p.vec && !(aligned(x, 16) && aligned(g, 16) && aligned(dx, sizeof(Tdx) * V))))
    return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  Tdx* dt = static_cast<Tdx*>(dx);
  cudaError_t err;
  if (p.form == LNN_IN_WARP) {
    const dim3 grid((unsigned)((rows + kWarpRows - 1) / kWarpRows));
    if (p.vec)
      in_bwd_warp_kernel<T, Tdx, V><<<grid, 32 * kWarpRows, 0, stream>>>(
          xt, gt, scale, bias, mean, rstd, dt, partials, rows, C, (int)N, alpha);
    else
      in_bwd_warp_kernel<T, Tdx, 1><<<grid, 32 * kWarpRows, 0, stream>>>(
          xt, gt, scale, bias, mean, rstd, dt, partials, rows, C, (int)N, alpha);
    err = cudaGetLastError();
  } else {
    const size_t smem = (size_t)2 * p.keep * sizeof(T);
    err = p.vec ? launch_cluster(in_bwd_cluster_kernel<T, Tdx, V>, p, rows, smem, stream, xt,
                                 gt, scale, bias, mean, rstd, dt, partials, rows, C, N,
                                 p.slice, p.keep, p.cluster, alpha)
                : launch_cluster(in_bwd_cluster_kernel<T, Tdx, 1>, p, rows, smem, stream, xt,
                                 gt, scale, bias, mean, rstd, dt, partials, rows, C, N,
                                 p.slice, p.keep, p.cluster, alpha);
  }
  if (err != cudaSuccess) return err;
  sum_over_batch_kernel<<<(unsigned)((C + 255) / 256), 256, 0, stream>>>(partials, dscale,
                                                                         dbias, B, C);
  return cudaGetLastError();
}

// clusters of `cs` blocks of kClusterThreads threads with `smem` bytes each
// that the card can hold at once (0 where it cannot schedule one)
template <typename... Exp>
int max_clusters(void (*kernel)(Exp...), int cs, int smem) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  int n = 0;
  cudaError_t err = configure(kernel, cs, (size_t)smem, cfg, attr);
  cfg.gridDim = dim3((unsigned)cs);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.numAttrs = 1;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (err != cudaSuccess) {
    (void)cudaGetLastError();  // a refused size is an answer here, not a fault
    return 0;
  }
  return n;
}

}  // namespace

cudaError_t lnn_instance_norm_limits(int* sms, int* smem, int* cluster) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  auto* fwd = in_fwd_cluster_kernel<__nv_bfloat16, 8>;
  auto* bwd = in_bwd_cluster_kernel<__nv_bfloat16, __nv_bfloat16, 8>;
  cudaFuncAttributes fa, ba;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, fwd);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&ba, bwd);
  if (err != cudaSuccess) return err;
  const int stat = (int)(fa.sharedSizeBytes > ba.sharedSizeBytes ? fa.sharedSizeBytes
                                                                  : ba.sharedSizeBytes);
  *smem = (optin - stat) / 16 * 16;
  // the largest cluster the card schedules with the most shared memory a
  // block may take, for both kernels
  for (*cluster = kMaxCluster; *cluster >= 1; *cluster /= 2)
    if (max_clusters(fwd, *cluster, *smem) > 0 && max_clusters(bwd, *cluster, *smem) > 0)
      return cudaSuccess;
  return cudaErrorInvalidConfiguration;
}

cudaError_t lnn_instance_norm_leaky_bwd(const void* x, const void* g, const float* scale,
                                        const float* bias, const float* mean,
                                        const float* rstd, void* dx, float* dscale,
                                        float* dbias, float* partials, int B, int C,
                                        long long N, float alpha, LnnDtype dtype,
                                        LnnDtype dx_dtype, LnnInPlan plan,
                                        cudaStream_t stream) {
  if (B <= 0 || C <= 0 || N <= 0 || (long long)B * C > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (dtype == LNN_F32 && dx_dtype == LNN_F32)
    return launch_bwd<float, float>(x, g, scale, bias, mean, rstd, dx, dscale, dbias,
                                    partials, B, C, N, alpha, plan, stream);
  if (dtype == LNN_F32 && dx_dtype == LNN_BF16)
    return launch_bwd<float, __nv_bfloat16>(x, g, scale, bias, mean, rstd, dx, dscale,
                                            dbias, partials, B, C, N, alpha, plan, stream);
  if (dtype == LNN_BF16 && dx_dtype == LNN_F32)
    return launch_bwd<__nv_bfloat16, float>(x, g, scale, bias, mean, rstd, dx, dscale,
                                            dbias, partials, B, C, N, alpha, plan, stream);
  if (dtype == LNN_BF16 && dx_dtype == LNN_BF16)
    return launch_bwd<__nv_bfloat16, __nv_bfloat16>(x, g, scale, bias, mean, rstd, dx,
                                                    dscale, dbias, partials, B, C, N,
                                                    alpha, plan, stream);
  return cudaErrorInvalidValue;
}

cudaError_t lnn_instance_norm_leaky_fwd(const void* x, const float* scale,
                                        const float* bias, void* out, float* mean,
                                        float* rstd, int B, int C, long long N,
                                        float alpha, float eps, LnnDtype dtype,
                                        LnnInPlan plan, cudaStream_t stream) {
  if (B <= 0 || C <= 0 || N <= 0 || (long long)B * C > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const long long rows = (long long)B * C;
  if (dtype == LNN_F32)
    return launch_fwd<float>(x, scale, bias, out, mean, rstd, rows, C, N, alpha, eps, plan,
                             stream);
  if (dtype == LNN_BF16)
    return launch_fwd<__nv_bfloat16>(x, scale, bias, out, mean, rstd, rows, C, N, alpha, eps,
                                     plan, stream);
  return cudaErrorInvalidValue;
}
