// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every launcher (lnn_kernels.h) returns the cudaError_t of its launches, so
// the binding (binding.cpp) raises on a launch that was refused.  The
// conversions go through the intrinsics: the build defines
// __CUDA_NO_BFLOAT16_CONVERSIONS__.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lnn_kernels.h"

static __device__ __forceinline__ float lnn_to_f32(float v) { return v; }
static __device__ __forceinline__ float lnn_to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
static __device__ __forceinline__ T lnn_from_f32(float v);
template <>
__device__ __forceinline__ float lnn_from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 lnn_from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Round a float to T and back: the value a T-typed intermediate holds.
template <typename T>
static __device__ __forceinline__ float lnn_round_to(float v) {
  return lnn_to_f32(lnn_from_f32<T>(v));
}

// Sum of one float per thread over the whole block, returned to every
// thread.  The xor-butterfly and the fixed warp order make the result
// repeat bit for bit from run to run (no atomics).  `red` is a shared
// buffer of 32 floats; blockDim.x must be a multiple of 32.
static __device__ __forceinline__ float lnn_block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const float total = red[0];
  __syncthreads();  // `red` may be reused by the next call
  return total;
}

// The same in f64, `red` a shared buffer of 32 doubles.
static __device__ __forceinline__ double lnn_block_sum(double v, double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const double total = red[0];
  __syncthreads();
  return total;
}
