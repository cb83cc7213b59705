// Fused InstanceNorm + LeakyReLU, forward and backward, for Hopper (sm_90a).
//
// Replaces: lifelong_nnunet_tpu/ops/pallas/instance_norm.py, `_fwd_kernel`
// (reached through `_fwd_call` / `instance_norm_leaky`) and `_bwd_kernel`
// (reached through `_in_bwd`).  Forward, the same math:
// per (batch, channel) f32 statistics over all N spatial positions, the
// TWO-pass variance of `_fwd_kernel` (mean first, then the mean of
// (x - mean)^2), eps 1e-5, then LeakyReLU((x - mean) * rstd * scale + bias)
// written in x's dtype.
//
// Layout: channels-first rows, x [B, C, N] contiguous, so one (b, c) row is
// N contiguous elements.  The port calls it after every strided conv
// (F.conv3d, channels-first) of the U-Net.
//
// What bounds it on the card: memory bandwidth.  It does 3 reads and 1
// write of the row for ~8 flops per element, far below the card's balance
// of arithmetic to memory traffic.
//
// What the design does about it: one thread block owns one (b, c) row, so
// both reductions stay inside the block (warp shuffles + 32 floats of
// shared memory) and no second kernel or atomic is needed; the second and
// third passes re-read the row while it is still in L2 (a row is one
// channel of one feature map).  The sums are taken in a fixed
// order, so a run repeats bit for bit.  Vectorized loads and keeping the
// row in shared memory are left to a later tuning pass.
//
// Backward, the math of `_bwd_kernel`: xhat = (x - mean) * rstd is
// recomputed from the saved f32 statistics, the LeakyReLU mask from
// y = xhat * scale + bias (the output is not kept), then with
// dz = g or alpha * g and n = N,
//   dscale = sum dz * xhat,  dbias = sum dz,
//   dx = rstd * (scale * dz - mean(scale * dz) - xhat * mean(scale * dz * xhat)).
// The fused conv's backward (`_fused_bwd`, ops/pallas/conv3d.py:319-332)
// is the same math with x := the raw conv output and rstd := inv, so it
// calls this launcher too.  One block per (b, c) row again: the first
// pass reduces the two sums in a fixed order (lnn_block_sum), the second
// writes dx; per-row dscale / dbias go to a [2, B, C] scratch that a second,
// tiny kernel sums over B in a fixed order.  Bound: memory (two reads of x
// and g, one write of dx).  Rows of the fused convs reach 250,880 elements
// (56x80x56) at only B * C = 64 rows, so the block is 1024 threads wide.

#include "lnn_common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    in_lrelu_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                        const float* __restrict__ bias, T* __restrict__ out,
                        float* __restrict__ mean_out, float* __restrict__ rstd_out,
                        int C, long long N, float alpha, float eps) {
  __shared__ float red[32];
  const long long row = blockIdx.x;  // b * C + c
  const int c = (int)(row % C);
  const T* xr = x + row * N;
  T* orow = out + row * N;

  float s = 0.f;
  for (long long i = threadIdx.x; i < N; i += kThreads) s += lnn_to_f32(xr[i]);
  const float mean = lnn_block_sum(s, red) / (float)N;

  float q = 0.f;
  for (long long i = threadIdx.x; i < N; i += kThreads) {
    const float d = lnn_to_f32(xr[i]) - mean;
    q += d * d;
  }
  const float var = lnn_block_sum(q, red) / (float)N;
  const float rstd = rsqrtf(var + eps);

  const float sc = scale[c];
  const float b = bias[c];
  for (long long i = threadIdx.x; i < N; i += kThreads) {
    const float y = (lnn_to_f32(xr[i]) - mean) * rstd * sc + b;
    orow[i] = lnn_from_f32<T>(y >= 0.f ? y : alpha * y);
  }
  if (threadIdx.x == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

constexpr int kBwdThreads = 1024;

template <typename T, typename Tdx>
__global__ void __launch_bounds__(kBwdThreads)
    in_lrelu_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                        const float* __restrict__ scale, const float* __restrict__ bias,
                        const float* __restrict__ mean, const float* __restrict__ rstd,
                        Tdx* __restrict__ dx, float* __restrict__ partials, int C,
                        long long N, float alpha) {
  __shared__ float red[32];
  const long long row = blockIdx.x;  // b * C + c
  const int c = (int)(row % C);
  const T* xr = x + row * N;
  const T* gr = g + row * N;
  Tdx* dxr = dx + row * N;
  const float m = mean[row], r = rstd[row], sc = scale[c], bi = bias[c];

  float s_dz = 0.f, s_dzx = 0.f;
  for (long long i = threadIdx.x; i < N; i += kBwdThreads) {
    const float xhat = (lnn_to_f32(xr[i]) - m) * r;
    const float gi = lnn_to_f32(gr[i]);
    const float dz = xhat * sc + bi >= 0.f ? gi : alpha * gi;
    s_dz += dz;
    s_dzx += dz * xhat;
  }
  s_dz = lnn_block_sum(s_dz, red);
  s_dzx = lnn_block_sum(s_dzx, red);
  const float n = (float)N;
  const float m1 = sc * s_dz / n;   // mean(dxhat)
  const float m2 = sc * s_dzx / n;  // mean(dxhat * xhat)
  for (long long i = threadIdx.x; i < N; i += kBwdThreads) {
    const float xhat = (lnn_to_f32(xr[i]) - m) * r;
    const float gi = lnn_to_f32(gr[i]);
    const float dz = xhat * sc + bi >= 0.f ? gi : alpha * gi;
    dxr[i] = lnn_from_f32<Tdx>(r * (dz * sc - m1 - xhat * m2));
  }
  if (threadIdx.x == 0) {
    partials[row] = s_dzx;                           // dscale of (b, c)
    partials[(long long)gridDim.x + row] = s_dz;     // dbias of (b, c)
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

template <typename T, typename Tdx>
cudaError_t launch_bwd(const void* x, const void* g, const float* scale,
                       const float* bias, const float* mean, const float* rstd, void* dx,
                       float* dscale, float* dbias, float* partials, int B, int C,
                       long long N, float alpha, cudaStream_t stream) {
  in_lrelu_bwd_kernel<T, Tdx><<<(unsigned)((long long)B * C), kBwdThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), scale, bias, mean, rstd,
      static_cast<Tdx*>(dx), partials, C, N, alpha);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_over_batch_kernel<<<(unsigned)((C + 255) / 256), 256, 0, stream>>>(
      partials, dscale, dbias, B, C);
  return cudaGetLastError();
}

}  // namespace

cudaError_t lnn_instance_norm_leaky_bwd(const void* x, const void* g, const float* scale,
                                        const float* bias, const float* mean,
                                        const float* rstd, void* dx, float* dscale,
                                        float* dbias, float* partials, int B, int C,
                                        long long N, float alpha, LnnDtype dtype,
                                        LnnDtype dx_dtype, cudaStream_t stream) {
  if (B <= 0 || C <= 0 || N <= 0 || (long long)B * C > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (dtype == LNN_F32 && dx_dtype == LNN_F32)
    return launch_bwd<float, float>(x, g, scale, bias, mean, rstd, dx, dscale, dbias,
                                    partials, B, C, N, alpha, stream);
  if (dtype == LNN_F32 && dx_dtype == LNN_BF16)
    return launch_bwd<float, __nv_bfloat16>(x, g, scale, bias, mean, rstd, dx, dscale,
                                            dbias, partials, B, C, N, alpha, stream);
  if (dtype == LNN_BF16 && dx_dtype == LNN_F32)
    return launch_bwd<__nv_bfloat16, float>(x, g, scale, bias, mean, rstd, dx, dscale,
                                            dbias, partials, B, C, N, alpha, stream);
  if (dtype == LNN_BF16 && dx_dtype == LNN_BF16)
    return launch_bwd<__nv_bfloat16, __nv_bfloat16>(x, g, scale, bias, mean, rstd, dx,
                                                    dscale, dbias, partials, B, C, N,
                                                    alpha, stream);
  return cudaErrorInvalidValue;
}

cudaError_t lnn_instance_norm_leaky_fwd(const void* x, const float* scale,
                                        const float* bias, void* out, float* mean,
                                        float* rstd, int B, int C, long long N,
                                        float alpha, float eps, LnnDtype dtype,
                                        cudaStream_t stream) {
  if (B <= 0 || C <= 0 || N <= 0 || (long long)B * C > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((long long)B * C));
  if (dtype == LNN_F32) {
    in_lrelu_fwd_kernel<float><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(x), scale, bias, static_cast<float*>(out), mean,
        rstd, C, N, alpha, eps);
  } else if (dtype == LNN_BF16) {
    in_lrelu_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), scale, bias,
        static_cast<__nv_bfloat16*>(out), mean, rstd, C, N, alpha, eps);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
