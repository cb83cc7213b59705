// Fused 3x3x3 stride-1 SAME conv + InstanceNorm + LeakyReLU, forward, and
// the same conv alone for its data gradient, for Hopper (sm_90a).
//
// Replaces: lifelong_nnunet_tpu/ops/pallas/conv3d.py, `conv3d_direct_cf`
// (`_conv_kernel`) with the `_in_lrelu_epilogue` that `_fused_fwd_impl`
// applies after it (reached from `conv3d_in_lrelu`).  Same math: a direct
// conv with no bias (the InstanceNorm mean absorbs it), per-tile f32 sum and
// sum of squares of the f32 accumulator, then mean and inv from the ONE-pass
// variance clamped at 0, and out = LeakyReLU(y * mul - sub) with
// mul = inv * scale and sub = mean * inv * scale - offset rounded to the
// output dtype, as the TPU epilogue does.
//
// Layout: channels-first, x [B, Cin, D, H, W], y [B, Cout, D, H, W].
//
// What bounds it on the card: operations.  Each output costs 2 * 27 * Cin
// flops against a few bytes of traffic (Cin >= 32 on all but the first
// conv), so the conv is compute-bound, and only the tensor cores (989
// TFLOP/s in bf16, against 67 TFLOP/s of f32 FMA on the CUDA cores) come
// near its bound.  Two kernels, chosen by the input dtype:
//
//  * bf16 x (training and serving): `conv3d_tc_kernel`, an implicit GEMM
//    on the tensor cores, bf16 x bf16 -> f32 (`wgmma.mma_async`, both
//    operands read from shared memory), the arithmetic of the TPU
//    kernel's one `[Cout, 27 Cin] @ [27 Cin, M]` dot in the input dtype
//    with f32 accumulation (conv3d.py:185-189, 215).  A block owns a 4x8x8
//    box of output voxels of one batch item (M = 256 rows) and NT = 32 or
//    64 output channels (32 when Cout <= 32, two blocks an SM); its two
//    warpgroups own two d planes of the box each.  K runs over
//    (input-channel chunk of 16, tap, channel within the chunk).  Per chunk
//    the halo'd 6x10x10 input tile is staged once in shared memory,
//    channels-last in two k halves of 8 channels (16 bytes a voxel), so the
//    A operand of tap (kd, kh, kw) for a d plane is that tile read at a
//    shifted voxel: 8 core matrices (8 voxels x 16 bytes), one per h line,
//    160 bytes apart.  The im2col gather costs nothing, and every tap's
//    products go to the tensor cores in one burst per chunk.  The weights
//    come packed by the wrapper as [chunk, 27, Cout_pad, 16] bf16, zeros
//    past Cin and Cout, and are copied by `cp.async` (16 bytes a thread)
//    into core matrices.  The input is read through registers, not
//    `cp.async`: its channels-first rows (W = 4 to 128 bf16) start at no
//    16-byte boundary, and the registers also transpose it to
//    channels-last.  Two stages: the next chunk's loads are issued while
//    this chunk's products run and packed into shared memory after them.
//    With one input channel (the first conv) the (kh, kw) taps are folded
//    into the chunk's 16 channels (9 used), so it runs 3 taps, not 27 taps
//    of which 15 of 16 channels are zeros.
//    Where the shape gives fewer blocks than the card has SMs (the deep
//    stages at batch 2), the chunks are split over `splits` blocks (a pure
//    function of the shape, chosen by the wrapper): each writes its f32
//    partial tile to a workspace, and one reduce pass sums the splits in
//    order, writes y and the statistics.
//  * f32 x (the f32 checks): `conv3d_stats_kernel`, f32 FMA on the CUDA
//    cores (a 4x8x8 tile and 32 output channels per block, 8 input
//    channels a stage in shared memory, a 4 x 8 register tile per thread),
//    so an f32 conv is not rounded to bf16 or TF32.
//
// Statistics come from the f32 accumulators before y is rounded to its
// dtype: a warp-shuffle reduction and a fixed combine order give each
// block's partial sums with no atomics, so a run repeats bit for bit.  The
// finish is two kernels: a block per (b, channel) reduces that row's
// partials once to mean and inv, then a block per (b, channel) and slice
// of 8192 voxels normalizes y in place.
//
// Training (`_fused_fwd` / `_fused_bwd`, conv3d.py:302-362).  The backward
// needs the raw conv output ycf and the statistics, which the in-place
// finish destroys, so a training entry runs the same kernels with the
// finishing kernel writing `out` to its own buffer and mean / inv [B, Cout]
// f32 beside it.  The data gradient dx is the same 3x3x3 stride-1 conv of
// dy with the taps flipped and Cin / Cout swapped (`_fused_bwd`'s second
// call of `conv3d_direct_cf`, conv3d.py:335-344): the conv-only entries run
// the conv with no statistics and no finish, on weights the wrapper lays
// out with the taps reversed.

#include <type_traits>

#include "lnn_common.cuh"
#include "lnn_sm90.cuh"

namespace {

constexpr int kTD = 4, kTH = 8, kTW = 8;  // output tile per block
constexpr int kHH = kTH + 2, kHW = kTW + 2;
constexpr int kHalo = (kTD + 2) * kHH * kHW;  // halo'd input tile, per channel
constexpr int kCoT = 32;                       // output channels per block
constexpr int kCiT = 8;                        // input channels per smem stage
constexpr int kVox = 4;                        // voxels per thread, along W
constexpr int kCoThr = 8;                      // output channels per thread
constexpr int kThreads = 256;
constexpr int kFinThreads = 256;
static_assert(kTD * kTH * kTW / kVox * (kCoT / kCoThr) == kThreads,
              "one register tile per thread");
static_assert(kTW == 2 * kVox && kTH == 8 && kTD == 4, "thread layout below");

inline long long num_tiles(int D, int H, int W) {
  return (long long)((D + kTD - 1) / kTD) * ((H + kTH - 1) / kTH) *
         ((W + kTW - 1) / kTW);
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
    conv3d_stats_kernel(const Tin* __restrict__ x, const Tin* __restrict__ w,
                        Tout* __restrict__ y, float* __restrict__ partials, int Cin,
                        int Cout, int D, int H, int W, int nTh, int nTw) {
  __shared__ __align__(16) float xs[kCiT * kHalo];
  __shared__ __align__(16) float ws[kCiT * 27 * kCoT];
  __shared__ float red[kThreads / 32][2][kCoThr];

  const int tile = blockIdx.x;
  const int d0 = tile / (nTh * nTw) * kTD;
  const int h0 = (tile / nTw) % nTh * kTH;
  const int w0 = tile % nTw * kTW;
  const int co0 = blockIdx.y * kCoT;
  const int b = blockIdx.z;
  const int t = threadIdx.x;
  const int cg = t >> 6;  // channel group: two warps each
  const int vg = t & 63;  // voxel group inside the tile
  const int lw = (vg & 1) * kVox;
  const int lh = (vg >> 1) & 7;
  const int ld = vg >> 4;

  const long long HW = (long long)H * W;
  const long long DHW = D * HW;
  const Tin* xb = x + (long long)b * Cin * DHW;

  float acc[kVox][kCoThr];
#pragma unroll
  for (int j = 0; j < kVox; ++j)
#pragma unroll
    for (int o = 0; o < kCoThr; ++o) acc[j][o] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += kCiT) {
    __syncthreads();  // the previous stage is no longer read
    for (int i = t; i < kCiT * kHalo; i += kThreads) {
      const int ci = i / kHalo, r = i % kHalo;
      const int gd = d0 + r / (kHH * kHW) - 1;
      const int gh = h0 + (r / kHW) % kHH - 1;
      const int gw = w0 + r % kHW - 1;
      float v = 0.f;
      if (ci0 + ci < Cin && gd >= 0 && gd < D && gh >= 0 && gh < H && gw >= 0 &&
          gw < W)
        v = lnn_to_f32(xb[(ci0 + ci) * DHW + gd * HW + (long long)gh * W + gw]);
      xs[i] = v;
    }
    for (int i = t; i < kCiT * 27 * kCoT; i += kThreads) {
      const int ci = i / (27 * kCoT), r = i % (27 * kCoT);
      const int co = r % kCoT;
      float v = 0.f;
      if (ci0 + ci < Cin && co0 + co < Cout)
        v = lnn_to_f32(w[((long long)(ci0 + ci) * 27 + r / kCoT) * Cout + co0 + co]);
      ws[i] = v;
    }
    __syncthreads();
    const int nci = min(kCiT, Cin - ci0);
    for (int ci = 0; ci < nci; ++ci) {
#pragma unroll
      for (int kd = 0; kd < 3; ++kd) {
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
          const float* xrow =
              xs + ci * kHalo + (ld + kd) * (kHH * kHW) + (lh + kh) * kHW + lw;
          float xr[kVox + 2];
#pragma unroll
          for (int q = 0; q < kVox + 2; ++q) xr[q] = xrow[q];
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            const float4* wp = reinterpret_cast<const float4*>(
                ws + (ci * 27 + kd * 9 + kh * 3 + kw) * kCoT + cg * kCoThr);
            const float4 wa = wp[0], wb = wp[1];
            const float wv[kCoThr] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int j = 0; j < kVox; ++j)
#pragma unroll
              for (int o = 0; o < kCoThr; ++o)
                acc[j][o] = fmaf(xr[j + kw], wv[o], acc[j][o]);
          }
        }
      }
    }
  }

  // y in the output dtype, and this thread's share of the tile statistics
  // (none for the conv-only entry, which passes no partials)
  const int od = d0 + ld, oh = h0 + lh;
  if (partials == nullptr) {
    if (od < D && oh < H) {
#pragma unroll
      for (int j = 0; j < kVox; ++j) {
        const int ow = w0 + lw + j;
        if (ow >= W) continue;
#pragma unroll
        for (int o = 0; o < kCoThr; ++o) {
          const int co = co0 + cg * kCoThr + o;
          if (co < Cout)
            y[((long long)b * Cout + co) * DHW + od * HW + (long long)oh * W + ow] =
                lnn_from_f32<Tout>(acc[j][o]);
        }
      }
    }
    return;
  }
  float s[kCoThr], ss[kCoThr];
#pragma unroll
  for (int o = 0; o < kCoThr; ++o) s[o] = ss[o] = 0.f;
  if (od < D && oh < H) {
#pragma unroll
    for (int j = 0; j < kVox; ++j) {
      const int ow = w0 + lw + j;
      if (ow >= W) continue;
#pragma unroll
      for (int o = 0; o < kCoThr; ++o) {
        const int co = co0 + cg * kCoThr + o;
        if (co < Cout)
          y[((long long)b * Cout + co) * DHW + od * HW + (long long)oh * W + ow] =
              lnn_from_f32<Tout>(acc[j][o]);
        s[o] += acc[j][o];
        ss[o] += acc[j][o] * acc[j][o];
      }
    }
  }
#pragma unroll
  for (int o = 0; o < kCoThr; ++o) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s[o] += __shfl_xor_sync(0xffffffffu, s[o], off);
      ss[o] += __shfl_xor_sync(0xffffffffu, ss[o], off);
    }
  }
  const int warp = t >> 5;
  if ((t & 31) == 0) {
#pragma unroll
    for (int o = 0; o < kCoThr; ++o) {
      red[warp][0][o] = s[o];
      red[warp][1][o] = ss[o];
    }
  }
  __syncthreads();
  if (t < kCoT && co0 + t < Cout) {
    const int g = t / kCoThr, o = t % kCoThr;
    float* p = partials + (((long long)b * Cout + co0 + t) * gridDim.x + tile) * 2;
    p[0] = red[2 * g][0][o] + red[2 * g + 1][0][o];
    p[1] = red[2 * g][1][o] + red[2 * g + 1][1][o];
  }
}

// The finish, in two kernels.  First a block per (b, channel) row reduces
// the row's `nTiles` (sum, sum of squares) partials in one fixed order to
// mean and inv (one-pass variance clamped at 0), read once per row.
__global__ void __launch_bounds__(kFinThreads)
    in_stats_kernel(const float* __restrict__ partials, float* __restrict__ mean_out,
                    float* __restrict__ inv_out, int nTiles, long long N, float eps) {
  __shared__ float red[32];
  const long long row = blockIdx.x;
  const float* p = partials + row * nTiles * 2;
  float s = 0.f, ss = 0.f;
  for (int i = threadIdx.x; i < nTiles; i += kFinThreads) {
    s += p[2 * i];
    ss += p[2 * i + 1];
  }
  s = lnn_block_sum(s, red);
  ss = lnn_block_sum(ss, red);
  if (threadIdx.x == 0) {
    const float n = (float)N;
    const float mean = s / n;
    mean_out[row] = mean;
    inv_out[row] = rsqrtf(fmaxf(ss / n - mean * mean, 0.f) + eps);
  }
}

// Then a block per (row, kFinSlice-element slice), the row along
// blockIdx.x, normalizes and activates its slice of y into `out` (in place
// when out == y, the inference entry).
constexpr int kFinSlice = 8192;

template <typename T>
__global__ void __launch_bounds__(kFinThreads)
    in_lrelu_finalize_kernel(const T* y, T* out, const float* __restrict__ mean_in,
                             const float* __restrict__ inv_in,
                             const float* __restrict__ scale,
                             const float* __restrict__ offset, int Cout, long long N,
                             float slope) {
  const long long row = blockIdx.x;
  const int co = (int)(row % Cout);
  const float mean = mean_in[row], inv = inv_in[row];
  const float mul = lnn_round_to<T>(inv * scale[co]);
  const float sub = lnn_round_to<T>(mean * inv * scale[co] - offset[co]);
  const T* yr = y + row * N;
  T* orow = out + row * N;
  const long long end = min(N, (long long)(blockIdx.y + 1) * kFinSlice);
#pragma unroll 4
  for (long long i = (long long)blockIdx.y * kFinSlice + threadIdx.x; i < end;
       i += kFinThreads) {
    const float z = lnn_to_f32(yr[i]) * mul - sub;
    orow[i] = lnn_from_f32<T>(z >= 0.f ? z : slope * z);
  }
}

// Its grid: a block per (row, slice).
inline dim3 finalize_grid(long long rows, long long N) {
  return dim3((unsigned)rows, (unsigned)((N + kFinSlice - 1) / kFinSlice));
}

// The finish of `rows` (b, channel) rows of N voxels from their `nTiles`
// partials each: mean and inv go to `mean` / `inv` where given (the
// training entry), else to the partials' tail (its last 2 * rows floats).
template <typename T>
cudaError_t finish(const void* y, void* out, float* partials, int nTiles,
                   const float* scale, const float* offset, float* mean, float* inv,
                   long long rows, int Cout, long long N, float slope, float eps,
                   cudaStream_t st) {
  if (mean == nullptr) {
    mean = partials + rows * nTiles * 2;
    inv = mean + rows;
  }
  in_stats_kernel<<<(unsigned)rows, kFinThreads, 0, st>>>(partials, mean, inv, nTiles, N,
                                                          eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  in_lrelu_finalize_kernel<T><<<finalize_grid(rows, N), kFinThreads, 0, st>>>(
      static_cast<const T*>(y), static_cast<T*>(out), mean, inv, scale, offset, Cout, N,
      slope);
  return cudaGetLastError();
}

// The conv kernel alone (partials null: no statistics) or followed by the
// finish (scale non-null), which writes `out` (== y for in place) and,
// when mean is non-null, mean and inv.
template <typename Tin, typename Tout>
cudaError_t launch(const void* x, const void* w, const float* scale,
                   const float* offset, void* y, void* out, float* mean, float* inv,
                   float* partials, int B, int Cin, int Cout, int D, int H, int W,
                   float slope, float eps, cudaStream_t st) {
  const int nTh = (H + kTH - 1) / kTH, nTw = (W + kTW - 1) / kTW;
  const long long nTiles = num_tiles(D, H, W);
  const dim3 grid((unsigned)nTiles, (unsigned)((Cout + kCoT - 1) / kCoT),
                  (unsigned)B);
  conv3d_stats_kernel<Tin, Tout><<<grid, kThreads, 0, st>>>(
      static_cast<const Tin*>(x), static_cast<const Tin*>(w), static_cast<Tout*>(y),
      partials, Cin, Cout, D, H, W, nTh, nTw);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || scale == nullptr) return err;
  return finish<Tout>(y, out, partials, (int)nTiles, scale, offset, mean, inv,
                      (long long)B * Cout, Cout, (long long)D * H * W, slope, eps, st);
}

bool bad_shape(int B, int Cin, int Cout, int D, int H, int W) {
  return B <= 0 || B > 65535 || Cin <= 0 || Cout <= 0 || D <= 0 || H <= 0 || W <= 0 ||
         (Cout + kCoT - 1) / kCoT > 65535 || num_tiles(D, H, W) > 0x7fffffffLL ||
         (long long)B * Cout > 0x7fffffffLL ||
         finalize_grid(1, (long long)D * H * W).y > 65535;
}

cudaError_t dispatch(const void* x, const void* w, const float* scale,
                     const float* offset, void* y, void* out, float* mean, float* inv,
                     float* partials, int B, int Cin, int Cout, int D, int H, int W,
                     float slope, float eps, LnnDtype in_dtype, LnnDtype out_dtype,
                     cudaStream_t st) {
  // f32 input only: bf16 input goes to the tensor-core kernel
  if (bad_shape(B, Cin, Cout, D, H, W) || in_dtype != LNN_F32) return cudaErrorInvalidValue;
  if (out_dtype == LNN_F32)
    return launch<float, float>(x, w, scale, offset, y, out, mean, inv, partials, B, Cin,
                                Cout, D, H, W, slope, eps, st);
  if (out_dtype == LNN_BF16)
    return launch<float, __nv_bfloat16>(x, w, scale, offset, y, out, mean, inv, partials,
                                        B, Cin, Cout, D, H, W, slope, eps, st);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The tensor-core kernel (bf16 input).

namespace tc {

constexpr int kTD = 4, kTH = 8, kTW = 8;       // output box per block: M = 256 rows
constexpr int kM = kTD * kTH * kTW;
constexpr int kHD = kTD + 2, kHH = kTH + 2, kHW = kTW + 2;
constexpr int kHalo = kHD * kHH * kHW;          // 600 voxels of halo'd input tile
constexpr int kCK = 16;                         // input channels per chunk (one k16 step a tap)
constexpr int kThreads = 256;                   // two warpgroups
constexpr int kABytes = kHalo * kCK * 2;
// two warpgroups, each two m64 tiles: a d plane of 8 h lines of 8 voxels
static_assert(kM == 4 * 64 && kTW == 8 && kTH == 8 && kThreads == 256, "the box");
static_assert(kHD * kTH * kTW <= kHalo, "the folded tile fits the stage");

template <int NT>
constexpr int stage_bytes() {
  return kABytes + 27 * NT * kCK * 2;
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }
inline int n_tile(int Cout) { return Cout <= 32 ? 32 : 64; }
inline long long m_tiles(int D, int H, int W) {
  return (long long)ceil_div(D, kTD) * ceil_div(H, kTH) * ceil_div(W, kTW);
}

template <int NT>
__device__ __forceinline__ void wgmma(float (&d)[NT / 2], unsigned long long da,
                                      unsigned long long db) {
  if constexpr (NT == 64)
    wgmma_n64(d, da, db);
  else
    wgmma_n32(d, da, db);
}

// How the input tile is staged (see the kernel).
enum Staging { kVoxels = 0, kPairs = 1, kFold = 2 };

template <int NT, typename Tout, int STAGING>
__global__ void __launch_bounds__(kThreads, NT == 32 ? 2 : 1)
    conv3d_tc_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w, Tout* __restrict__ y,
                     float* __restrict__ partials, float* __restrict__ ws, int Cin,
                     int Cout, int D, int H, int W, int nTh, int nTw, int chunks,
                     int per_split, int splits) {
  constexpr int NJ = NT / 8;  // n8 column groups of the accumulator
  constexpr bool PAIRS = STAGING == kPairs, FOLD = STAGING == kFold;
  // the taps of the products: 27, or with the (kh, kw) taps folded into the
  // chunk's channels, the 3 kd; the staged tile's voxels, h line stride
  constexpr int kTaps = FOLD ? 3 : 27;
  constexpr int kPlane = FOLD ? kHD * kTH * kTW : kHalo;
  constexpr int kLine = FOLD ? kTW : kHW;
  extern __shared__ __align__(128) unsigned char smem[];

  const int tile = blockIdx.x;
  const int d0 = tile / (nTh * nTw) * kTD;
  const int h0 = (tile / nTw) % nTh * kTH;
  const int w0 = tile % nTw * kTW;
  const int n0 = blockIdx.y * NT;
  const int cout_pad = gridDim.y * NT;
  const int b = blockIdx.z / splits, split = blockIdx.z % splits;
  const int c_begin = split * per_split, c_end = min(chunks, c_begin + per_split);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // warpgroup wg owns rows 128 wg .. 128 wg + 127 (two m64 tiles: the d
  // planes 2 wg and 2 wg + 1 of the box); warp wq of it holds the
  // accumulator rows 16 wq .. 16 wq + 15 of each
  const int wg = warp >> 2, wq = warp & 3;

  const long long HW = (long long)H * W;
  const long long DHW = D * HW;
  const unsigned short* xb =
      reinterpret_cast<const unsigned short*>(x) + (long long)b * Cin * DHW;

  // the input tile through registers, zero outside the volume (offset -1)
  // and past Cin.  Where W is even (PAIRS), a unit of this thread is one
  // k half (8 channels) of two neighbouring voxels of a halo row, read with
  // 4-byte loads at an even w (the pair (w0 - 2 + 2 p, w0 - 1 + 2 p) lies
  // wholly inside the volume or wholly outside); else it is one k half of
  // one voxel, read with 2-byte loads.  With one input channel (FOLD) the
  // 16 channels of a voxel (d, h, w) of the (kTD + 2) x kTH x kTW tile are
  // the input at (d, h + kh - 1, w + kw - 1), k = 3 kh + kw < 9, zeros
  // above: one chunk of 3 taps in place of 27 taps on 1 channel of 16.  A
  // chunk's loads are issued while the previous chunk's products run and
  // are packed and stored after them, so their issue and latency hide
  // behind the products.
  constexpr int kUnits = PAIRS ? kHD * kHH * (kHW + 2) / 2 * 2 : 2 * kPlane;
  constexpr int kPer = (kUnits + kThreads - 1) / kThreads;
  constexpr int kRowUnits = PAIRS ? (kHW + 2) / 2 : kHW;  // units of a halo row
  constexpr int kHalfUnits = kUnits / 2;                   // units of a k half
  long long aoff[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int u = t + j * kThreads, r = u % kHalfUnits;
    if constexpr (FOLD) {  // the voxel's d plane, or -1 outside the volume
      const int gd = d0 + r / (kTH * kTW) - 1;
      aoff[j] = u < kUnits && gd >= 0 && gd < D ? gd * HW : -1;
      continue;
    }
    const int gd = d0 + r / (kHH * kRowUnits) - 1;
    const int gh = h0 + (r / kRowUnits) % kHH - 1;
    const int gw = w0 + (PAIRS ? 2 * (r % kRowUnits) - 2 : r % kRowUnits - 1);
    aoff[j] = u < kUnits && gd >= 0 && gd < D && gh >= 0 && gh < H && gw >= 0 && gw < W
                  ? gd * HW + (long long)gh * W + gw
                  : -1;
  }
  using Raw = typename std::conditional<PAIRS, unsigned, unsigned short>::type;
  Raw araw[kPer][8];
  auto load_a = [&](int c) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if constexpr (FOLD) {
        const int u = t + j * kThreads, half = u >= kHalfUnits, r = u - half * kHalfUnits;
        const int hh = h0 + (r / kTW) % kTH - 1, ww = w0 + r % kTW - 1;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int kk = half * 8 + k, gh = hh + kk / 3, gw = ww + kk % 3;
          araw[j][k] = aoff[j] >= 0 && kk < 9 && gh >= 0 && gh < H && gw >= 0 && gw < W
                           ? __ldg(xb + aoff[j] + (long long)gh * W + gw)
                           : Raw(0);
        }
        continue;
      }
      const int ci0 = c * kCK + ((t + j * kThreads) >= kHalfUnits) * 8;
      const unsigned short* src = xb + ci0 * DHW + aoff[j];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        araw[j][k] = aoff[j] >= 0 && ci0 + k < Cin
                         ? __ldg(reinterpret_cast<const Raw*>(src + k * DHW))
                         : Raw(0);
    }
  };
  auto store_a = [&](unsigned char* as) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int u = t + j * kThreads;
      if (u >= kUnits) continue;
      const int half = u >= kHalfUnits, r = u - half * kHalfUnits;
      unsigned char* plane = as + half * kPlane * 16;
      if constexpr (PAIRS) {
        // channels k, k + 1 of the pair's first voxel are the low halves of
        // araw[j][k], araw[j][k + 1]; of its second, the high halves
        const int row = r / kRowUnits, p = r % kRowUnits;
        const unsigned* q = araw[j];
        if (p > 0)
          *reinterpret_cast<uint4*>(plane + (row * kHW + 2 * p - 1) * 16) = make_uint4(
              __byte_perm(q[0], q[1], 0x5410), __byte_perm(q[2], q[3], 0x5410),
              __byte_perm(q[4], q[5], 0x5410), __byte_perm(q[6], q[7], 0x5410));
        if (p < kRowUnits - 1)
          *reinterpret_cast<uint4*>(plane + (row * kHW + 2 * p) * 16) = make_uint4(
              __byte_perm(q[0], q[1], 0x7632), __byte_perm(q[2], q[3], 0x7632),
              __byte_perm(q[4], q[5], 0x7632), __byte_perm(q[6], q[7], 0x7632));
      } else {
        *reinterpret_cast<uint4*>(plane + r * 16) = make_uint4(
            araw[j][0] | (araw[j][1] << 16), araw[j][2] | (araw[j][3] << 16),
            araw[j][4] | (araw[j][5] << 16), araw[j][6] | (araw[j][7] << 16));
      }
    }
  };
  // the chunk's weights for this block's NT channels: per tap NT x 16 in
  // core matrices (8 channels x 8 k, 128 bytes; the k halves 128 bytes
  // apart, the 8-channel groups 256)
  auto load_b = [&](int c, unsigned char* bs) {
    const __nv_bfloat16* src = w + ((long long)c * kTaps * cout_pad + n0) * kCK;
    for (int p = t; p < kTaps * NT * 2; p += kThreads) {
      const int n = p % NT, half = (p / NT) & 1, tap = p / (2 * NT);
      cp_async16(smem_addr(bs + tap * NT * 32 + ((n >> 3) * 2 + half) * 128 + (n & 7) * 16),
                 src + ((long long)tap * cout_pad + n) * kCK + half * 8);
    }
    cp_async_commit();
  };

  float acc[2][NT / 2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int r = 0; r < NT / 2; ++r) acc[i][r] = 0.f;

  unsigned char* stage[2] = {smem, smem + stage_bytes<NT>()};
  load_b(c_begin, stage[0] + kABytes);
  load_a(c_begin);
  store_a(stage[0]);
  cp_async_wait_all();
  fence_async_smem();
  __syncthreads();

  for (int c = c_begin; c < c_end; ++c) {
    unsigned char* cur = stage[(c - c_begin) & 1];
    unsigned char* nxt = stage[((c - c_begin) & 1) ^ 1];
    const bool more = c + 1 < c_end;
    // every tap's products in one burst, read from shared memory: A is the
    // input tile at the tap's shift (voxel offset v), B the tap's weights
    const unsigned as = smem_addr(cur), bs = smem_addr(cur + kABytes);
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap) {
      const unsigned long long db = desc(bs + tap * NT * 32, 128, 256);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int v = FOLD ? (wg * 2 + i + tap) * kTH * kTW
                           : ((wg * 2 + i + tap / 9) * kHH + (tap / 3) % 3) * kHW + tap % 3;
        wgmma<NT>(acc[i], desc(as + v * 16, kPlane * 16, kLine * 16), db);
      }
    }
    wgmma_commit();
    // the next chunk's loads go out while the tensor cores run (into the
    // other stage and registers, which the burst does not read)
    if (more) {
      load_b(c + 1, nxt + kABytes);
      load_a(c + 1);
    }
    wgmma_wait_all();
    if (more) {
      store_a(nxt);
      cp_async_wait_all();
      fence_async_smem();
    }
    __syncthreads();
  }

  // accumulator (i, 4 j + q): row 128 wg + 64 i + 16 wq + (lane >> 2) +
  // 8 (q >> 1) of the box, channel n0 + 8 j + 2 (lane & 3) + (q & 1)
  const int g = lane >> 2, tq = lane & 3;
  bool rv[2][2];
  long long roff[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = wg * 128 + i * 64 + wq * 16 + g + 8 * h;
      const int od = d0 + (m >> 6), oh = h0 + ((m >> 3) & 7), ow = w0 + (m & 7);
      rv[i][h] = od < D && oh < H && ow < W;
      roff[i][h] = od * HW + (long long)oh * W + ow;
    }
  const int B = gridDim.z / splits;
  if (splits > 1) {  // this split's f32 partial tile; the reduce pass does the rest
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int co = n0 + 8 * j + 2 * tq + e;
        if (co >= Cout) continue;
        float* dst = ws + (((long long)split * B + b) * Cout + co) * DHW;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (rv[i][h]) dst[roff[i][h]] = acc[i][4 * j + 2 * h + e];
      }
    return;
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = n0 + 8 * j + 2 * tq + e;
      if (co >= Cout) continue;
      Tout* dst = y + ((long long)b * Cout + co) * DHW;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (rv[i][h]) dst[roff[i][h]] = lnn_from_f32<Tout>(acc[i][4 * j + 2 * h + e]);
    }
  if (partials == nullptr) return;

  // per-channel sums over the tile's voxels: this thread's rows, then the
  // 8 lanes of one channel pair (xor 4, 8, 16), then the 8 warps in order
  float* red = reinterpret_cast<float*>(smem);  // [8][NT][2]
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = 0.f, ss = 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (rv[i][h]) {
            const float v = acc[i][4 * j + 2 * h + e];
            s += v;
            ss += v * v;
          }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        ss += __shfl_xor_sync(0xffffffffu, ss, off);
      }
      if (g == 0) {
        const int n = 8 * j + 2 * tq + e;
        red[(warp * NT + n) * 2] = s;
        red[(warp * NT + n) * 2 + 1] = ss;
      }
    }
  __syncthreads();
  if (t < NT && n0 + t < Cout) {
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int k = 0; k < kThreads / 32; ++k) {
      s += red[(k * NT + t) * 2];
      ss += red[(k * NT + t) * 2 + 1];
    }
    float* p = partials + (((long long)b * Cout + n0 + t) * gridDim.x + tile) * 2;
    p[0] = s;
    p[1] = ss;
  }
}

// Split K: one block per (b, channel) row sums the splits' partial rows in
// split order, writes y and, when asked, the row's sum and sum of squares
// (one partial per row).
template <typename Tout>
__global__ void __launch_bounds__(kFinThreads)
    conv3d_tc_reduce_kernel(const float* __restrict__ ws, Tout* __restrict__ y,
                            float* __restrict__ partials, int splits, long long rows,
                            long long N) {
  __shared__ float red[32];
  const long long row = blockIdx.x;
  float s = 0.f, ss = 0.f;
  for (long long i = threadIdx.x; i < N; i += kFinThreads) {
    float v = ws[row * N + i];
    for (int k = 1; k < splits; ++k) v += ws[((long long)k * rows + row) * N + i];
    y[row * N + i] = lnn_from_f32<Tout>(v);
    s += v;
    ss += v * v;
  }
  if (partials == nullptr) return;
  s = lnn_block_sum(s, red);
  ss = lnn_block_sum(ss, red);
  if (threadIdx.x == 0) {
    partials[row * 2] = s;
    partials[row * 2 + 1] = ss;
  }
}

// splits in [1, chunks], and none empty
bool bad_split(int Cin, int splits) {
  const int chunks = ceil_div(Cin, kCK);
  return splits < 1 || splits > chunks ||
         (long long)(splits - 1) * ceil_div(chunks, splits) >= chunks;
}

bool bad_shape(int B, int Cin, int Cout, int D, int H, int W, int splits) {
  return B <= 0 || Cin <= 0 || Cout <= 0 || D <= 0 || H <= 0 || W <= 0 ||
         bad_split(Cin, splits) || (long long)B * splits > 65535 ||
         ceil_div(Cout, n_tile(Cout)) > 65535 || m_tiles(D, H, W) > 0x7fffffffLL ||
         (long long)B * Cout > 0x7fffffffLL ||
         finalize_grid(1, (long long)D * H * W).y > 65535;
}

template <int NT, typename Tout>
cudaError_t launch(const void* x, const void* w, const float* scale, const float* offset,
                   void* y, void* out, float* mean, float* inv, float* partials,
                   float* workspace, int B, int Cin, int Cout, int D, int H, int W,
                   int splits, float slope, float eps, cudaStream_t st) {
  const int nTh = ceil_div(H, kTH), nTw = ceil_div(W, kTW);
  const long long nTiles = m_tiles(D, H, W);
  const int chunks = ceil_div(Cin, kCK);
  const dim3 grid((unsigned)nTiles, (unsigned)ceil_div(Cout, NT), (unsigned)(B * splits));
  auto kernel = Cin == 1       ? conv3d_tc_kernel<NT, Tout, kFold>
                : W % 2 == 0 ? conv3d_tc_kernel<NT, Tout, kPairs>
                             : conv3d_tc_kernel<NT, Tout, kVoxels>;
  constexpr int smem = 2 * stage_bytes<NT>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<Tout*>(y), splits == 1 ? partials : nullptr, workspace, Cin, Cout, D, H,
      W, nTh, nTw, chunks, ceil_div(chunks, splits), splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long rows = (long long)B * Cout, N = (long long)D * H * W;
  if (splits > 1) {
    conv3d_tc_reduce_kernel<Tout><<<(unsigned)rows, kFinThreads, 0, st>>>(
        workspace, static_cast<Tout*>(y), partials, splits, rows, N);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (scale == nullptr) return cudaSuccess;
  return finish<Tout>(y, out, partials, splits > 1 ? 1 : (int)nTiles, scale, offset, mean,
                      inv, rows, Cout, N, slope, eps, st);
}

}  // namespace tc

}  // namespace

// (sum, sum of squares) per (b, channel) and tile, then the finish's mean
// and inv per (b, channel)
long long lnn_conv3d_partials_len(int B, int Cout, int D, int H, int W) {
  return (long long)B * Cout * (num_tiles(D, H, W) + 1) * 2;
}

cudaError_t lnn_conv3d_in_lrelu_fwd(const void* x, const void* w, const float* scale,
                                    const float* offset, void* y, float* partials,
                                    int B, int Cin, int Cout, int D, int H, int W,
                                    float slope, float eps, LnnDtype in_dtype,
                                    LnnDtype out_dtype, cudaStream_t st) {
  return dispatch(x, w, scale, offset, y, y, nullptr, nullptr, partials, B, Cin, Cout, D,
                  H, W, slope, eps, in_dtype, out_dtype, st);
}

cudaError_t lnn_conv3d_in_lrelu_train_fwd(const void* x, const void* w,
                                          const float* scale, const float* offset,
                                          void* ycf, void* out, float* mean, float* inv,
                                          float* partials, int B, int Cin, int Cout,
                                          int D, int H, int W, float slope, float eps,
                                          LnnDtype in_dtype, LnnDtype out_dtype,
                                          cudaStream_t st) {
  return dispatch(x, w, scale, offset, ycf, out, mean, inv, partials, B, Cin, Cout, D, H,
                  W, slope, eps, in_dtype, out_dtype, st);
}

cudaError_t lnn_conv3d_fwd(const void* x, const void* w, void* y, int B, int Cin,
                           int Cout, int D, int H, int W, LnnDtype in_dtype,
                           LnnDtype out_dtype, cudaStream_t st) {
  return dispatch(x, w, nullptr, nullptr, y, nullptr, nullptr, nullptr, nullptr, B, Cin,
                  Cout, D, H, W, 0.f, 0.f, in_dtype, out_dtype, st);
}

long long lnn_conv3d_tc_weight_len(int Cin, int Cout) {
  const int nt = tc::n_tile(Cout);
  const int taps = Cin == 1 ? 3 : 27;  // one input channel: (kh, kw) folded
  return (long long)tc::ceil_div(Cin, tc::kCK) * taps * tc::ceil_div(Cout, nt) * nt * tc::kCK;
}

// one partial per (b, channel) and voxel box, or per (b, channel) after a
// split, then the finish's mean and inv
long long lnn_conv3d_tc_partials_len(int B, int Cout, int D, int H, int W, int splits) {
  return (long long)B * Cout * ((splits > 1 ? 1 : tc::m_tiles(D, H, W)) + 1) * 2;
}

long long lnn_conv3d_tc_workspace_len(int B, int Cout, int D, int H, int W, int splits) {
  return splits > 1 ? (long long)splits * B * Cout * D * H * W : 0;
}

cudaError_t lnn_conv3d_tc(const void* x, const void* w, const float* scale,
                          const float* offset, void* y, void* out, float* mean, float* inv,
                          float* partials, float* workspace, int B, int Cin, int Cout, int D,
                          int H, int W, int splits, float slope, float eps,
                          LnnDtype out_dtype, cudaStream_t st) {
  if (tc::bad_shape(B, Cin, Cout, D, H, W, splits) || (scale != nullptr) != (partials != nullptr) ||
      (splits > 1 && workspace == nullptr))
    return cudaErrorInvalidValue;
  const bool wide = tc::n_tile(Cout) == 64;
  if (out_dtype == LNN_BF16)
    return wide ? tc::launch<64, __nv_bfloat16>(x, w, scale, offset, y, out, mean, inv,
                                                 partials, workspace, B, Cin, Cout, D, H, W,
                                                 splits, slope, eps, st)
                : tc::launch<32, __nv_bfloat16>(x, w, scale, offset, y, out, mean, inv,
                                                 partials, workspace, B, Cin, Cout, D, H, W,
                                                 splits, slope, eps, st);
  if (out_dtype == LNN_F32)
    return wide ? tc::launch<64, float>(x, w, scale, offset, y, out, mean, inv, partials,
                                        workspace, B, Cin, Cout, D, H, W, splits, slope, eps,
                                        st)
                : tc::launch<32, float>(x, w, scale, offset, y, out, mean, inv, partials,
                                        workspace, B, Cin, Cout, D, H, W, splits, slope, eps,
                                        st);
  return cudaErrorInvalidValue;
}
