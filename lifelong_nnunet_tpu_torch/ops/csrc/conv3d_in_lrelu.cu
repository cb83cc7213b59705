// Fused 3x3x3 stride-1 SAME conv + InstanceNorm + LeakyReLU, forward, for
// Hopper (sm_90a).
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
// Layout: channels-first, x [B, Cin, D, H, W]; weights [Cin, 27, Cout]
// (tap-major inside one input channel); y [B, Cout, D, H, W].
//
// What bounds it on the card: arithmetic.  Each output costs 2 * 27 * Cin
// flops against a few bytes of traffic (Cin >= 32 on all but the first
// conv), so the conv is compute-bound.  This first version runs on the CUDA
// cores in f32 FMA, not on the tensor cores, whose bf16 rate is an order of
// magnitude higher: `wgmma`/TMA implicit GEMM is later work.
//
// What the design does about it:
//  * Each block owns a 4x8x8 output tile and 32 output channels.  Per stage
//    of 8 input channels it stages the halo'd input tile (6x10x10) and the
//    weights in shared memory as f32, so every input value is read
//    from device memory ~once per 32 output channels and the 27 taps reuse
//    it from shared memory.
//  * Each thread holds a 4 (along W) x 8 (channels) register tile: the six
//    input values of one (d, h) row serve all three W taps, and the eight
//    weights are one warp-wide broadcast, so the inner loop does 96 FMAs per
//    6 input and 24 weight values read from shared memory.
//  * Input channels are tiled in a loop, so any Cin fits (the slice needs 1
//    to 512); any Cout is masked in tiles of 32.
//  * Statistics come from the f32 accumulators in registers: a warp-shuffle
//    reduction and a fixed combine order give each block's partial sums with
//    no atomics, so a run repeats bit for bit.  A finishing kernel, one
//    block per (b, channel), reduces the partials and normalizes y in place.
//
// Training (`_fused_fwd` / `_fused_bwd`, conv3d.py:302-362).  The backward
// needs the raw conv output ycf and the statistics, which the in-place
// finish destroys, so a training entry runs the same two kernels with the
// finishing kernel writing `out` to its own buffer and mean / inv [B, Cout]
// f32 beside it.  The data gradient dx is the same 3x3x3 stride-1 conv of
// dy with the taps flipped and Cin / Cout swapped (`_fused_bwd`'s second
// call of `conv3d_direct_cf`, conv3d.py:335-344): a conv-only entry runs
// the conv kernel with no statistics and no finish, on weights the wrapper
// lays out as [Cout, 27, Cin] with the taps reversed.

#include "lnn_common.cuh"

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

// One block per (b, channel) row: reduce the tile partials, then normalize
// and activate the row of y into `out` (in place when out == y, the
// inference entry), and keep mean and inv when asked (the training entry).
template <typename T>
__global__ void __launch_bounds__(kFinThreads)
    in_lrelu_finalize_kernel(const T* y, T* out, const float* __restrict__ partials,
                             const float* __restrict__ scale,
                             const float* __restrict__ offset, float* mean_out,
                             float* inv_out, int Cout, int nTiles, long long N,
                             float slope, float eps) {
  __shared__ float red[32];
  const long long row = blockIdx.x;
  const int co = (int)(row % Cout);
  const float* p = partials + row * nTiles * 2;
  float s = 0.f, ss = 0.f;
  for (int i = threadIdx.x; i < nTiles; i += kFinThreads) {
    s += p[2 * i];
    ss += p[2 * i + 1];
  }
  s = lnn_block_sum(s, red);
  ss = lnn_block_sum(ss, red);
  const float n = (float)N;
  const float mean = s / n;
  const float var = fmaxf(ss / n - mean * mean, 0.f);
  const float inv = rsqrtf(var + eps);
  const float mul = lnn_round_to<T>(inv * scale[co]);
  const float sub = lnn_round_to<T>(mean * inv * scale[co] - offset[co]);
  const T* yr = y + row * N;
  T* orow = out + row * N;
  for (long long i = threadIdx.x; i < N; i += kFinThreads) {
    const float z = lnn_to_f32(yr[i]) * mul - sub;
    orow[i] = lnn_from_f32<T>(z >= 0.f ? z : slope * z);
  }
  if (mean_out != nullptr && threadIdx.x == 0) {
    mean_out[row] = mean;
    inv_out[row] = inv;
  }
}

// The conv kernel alone (partials null: no statistics) or followed by the
// finishing kernel (scale non-null), which writes `out` (== y for in place)
// and, when mean is non-null, mean and inv.
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
  in_lrelu_finalize_kernel<Tout><<<(unsigned)((long long)B * Cout), kFinThreads, 0, st>>>(
      static_cast<const Tout*>(y), static_cast<Tout*>(out), partials, scale, offset, mean,
      inv, Cout, (int)nTiles, (long long)D * H * W, slope, eps);
  return cudaGetLastError();
}

bool bad_shape(int B, int Cin, int Cout, int D, int H, int W) {
  return B <= 0 || B > 65535 || Cin <= 0 || Cout <= 0 || D <= 0 || H <= 0 || W <= 0 ||
         (Cout + kCoT - 1) / kCoT > 65535 || num_tiles(D, H, W) > 0x7fffffffLL ||
         (long long)B * Cout > 0x7fffffffLL;
}

cudaError_t dispatch(const void* x, const void* w, const float* scale,
                     const float* offset, void* y, void* out, float* mean, float* inv,
                     float* partials, int B, int Cin, int Cout, int D, int H, int W,
                     float slope, float eps, LnnDtype in_dtype, LnnDtype out_dtype,
                     cudaStream_t st) {
  if (bad_shape(B, Cin, Cout, D, H, W)) return cudaErrorInvalidValue;
  if (in_dtype == LNN_F32 && out_dtype == LNN_F32)
    return launch<float, float>(x, w, scale, offset, y, out, mean, inv, partials, B, Cin,
                                Cout, D, H, W, slope, eps, st);
  if (in_dtype == LNN_F32 && out_dtype == LNN_BF16)
    return launch<float, __nv_bfloat16>(x, w, scale, offset, y, out, mean, inv, partials,
                                        B, Cin, Cout, D, H, W, slope, eps, st);
  if (in_dtype == LNN_BF16 && out_dtype == LNN_F32)
    return launch<__nv_bfloat16, float>(x, w, scale, offset, y, out, mean, inv, partials,
                                        B, Cin, Cout, D, H, W, slope, eps, st);
  if (in_dtype == LNN_BF16 && out_dtype == LNN_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, scale, offset, y, out, mean, inv,
                                                partials, B, Cin, Cout, D, H, W, slope,
                                                eps, st);
  return cudaErrorInvalidValue;
}

}  // namespace

long long lnn_conv3d_partials_len(int B, int Cout, int D, int H, int W) {
  return (long long)B * Cout * num_tiles(D, H, W) * 2;
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
