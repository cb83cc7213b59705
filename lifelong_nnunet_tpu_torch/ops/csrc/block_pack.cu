// Halo'd block pack and its inverse scatter, for Hopper (sm_90a).
//
// Replaces: lifelong_nnunet_tpu/ops/pallas/block_pack.py, `pack_blocks`
// (its `pallas_call` at :137, kernel `_pack_kernel`) and `unpack_blocks`
// (:197, `_unpack_kernel`).  The same copies, channels-first:
//
//   pack:   x [B, C, D, H, W] -> out [nb, C, S, S, S], S = bs + 2,
//           out[n, c, z, y, x] = x[b, c, i*bs + z - 1, j*bs + y - 1, k*bs + x - 1]
//           (0 where that index leaves the volume), n = ((b*nd + i)*nh + j)*nw + k;
//   unpack: y [nb, C, s, s, s] -> out [B, C, nd*s, nh*s, nw*s],
//           out[b, c, i*s + z, j*s + y, k*s + x] = y[n, c, z, y, x].
//
// The TPU kernel pads the volume (+1 low, round8 high) and copies
// fixed-extent windows by DMA, with junk rows for Mosaic's lane rules; here
// a window that leaves the volume reads zeros in the kernel, and there are
// no junk rows: a window is exactly (bs + 2)^3.
//
// What bounds it on the card: memory bandwidth; it is a pure copy (no
// arithmetic), so each element is moved as raw bits (16 or 32 of them) and
// the result equals the plain version bit for bit.  The pack reads the
// volume about (S / bs)^3 times over (1.2x at bs 32), once from memory and
// the halo mostly from L2.
//
// What the design does about it: one thread block per (window, channel)
// walks that window's S^3 (or s^3) elements in order, so neighbouring
// threads read and write neighbouring addresses (W runs of S in the
// volume, the window contiguous in the blocks).  A thread steps its (z, y,
// x) position by the block's width with carries instead of dividing.
// Vector loads and TMA are left to a later tuning pass.

#include <cstdint>

#include "lnn_common.cuh"

namespace {

constexpr int kThreads = 256;

// (z, y, x) of element `e` of an n x n x n cube, and the step of `kThreads`
// elements, advanced with carries.
struct CubePos {
  int z, y, x;
  __device__ CubePos(int e, int n) {
    z = e / (n * n);
    const int r = e - z * n * n;
    y = r / n;
    x = r - y * n;
  }
  __device__ void advance(const CubePos& d, int n) {
    x += d.x;
    if (x >= n) { x -= n; ++y; }
    y += d.y;
    if (y >= n) { y -= n; ++z; }
    z += d.z;
  }
};

// blockIdx.x = window * C + c -> (b, i, j, k) of the window and c.
struct Window {
  long long b;
  int i, j, k, c;
  __device__ Window(long long wc, int C, int nd, int nh, int nw) {
    c = (int)(wc % C);
    long long n = wc / C;
    k = (int)(n % nw);
    n /= nw;
    j = (int)(n % nh);
    n /= nh;
    i = (int)(n % nd);
    b = n / nd;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pack_blocks_kernel(const T* __restrict__ x, T* __restrict__ out, int C, int D, int H,
                       int W, int bs, int nd, int nh, int nw) {
  const int S = bs + 2, S3 = S * S * S;
  const Window win(blockIdx.x, C, nd, nh, nw);
  const T* src = x + (win.b * C + win.c) * ((long long)D * H * W);
  T* dst = out + (long long)blockIdx.x * S3;
  const int z0 = win.i * bs - 1, y0 = win.j * bs - 1, x0 = win.k * bs - 1;
  const CubePos step(kThreads, S);
  CubePos p(threadIdx.x, S);
  for (int e = threadIdx.x; e < S3; e += kThreads, p.advance(step, S)) {
    const int gz = z0 + p.z, gy = y0 + p.y, gx = x0 + p.x;
    T v = 0;
    if ((unsigned)gz < (unsigned)D && (unsigned)gy < (unsigned)H && (unsigned)gx < (unsigned)W)
      v = src[((long long)gz * H + gy) * W + gx];
    dst[e] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    unpack_blocks_kernel(const T* __restrict__ y, T* __restrict__ out, int C, int s, int nd,
                         int nh, int nw) {
  const int s3 = s * s * s;
  const Window win(blockIdx.x, C, nd, nh, nw);
  const int D = nd * s, H = nh * s, W = nw * s;
  const T* src = y + (long long)blockIdx.x * s3;
  T* dst = out + (win.b * C + win.c) * ((long long)D * H * W);
  const int z0 = win.i * s, y0 = win.j * s, x0 = win.k * s;
  const CubePos step(kThreads, s);
  CubePos p(threadIdx.x, s);
  for (int e = threadIdx.x; e < s3; e += kThreads, p.advance(step, s))
    dst[((long long)(z0 + p.z) * H + y0 + p.y) * W + x0 + p.x] = src[e];
}

bool valid_grid(int B, int C, int nd, int nh, int nw) {
  return B > 0 && C > 0 && nd > 0 && nh > 0 && nw > 0 &&
         (long long)B * nd * nh * nw * C <= 0x7fffffffLL;
}

}  // namespace

cudaError_t lnn_pack_blocks(const void* x, void* out, int B, int C, int D, int H, int W,
                            int bs, LnnDtype dtype, cudaStream_t stream) {
  if (bs <= 0 || D % bs || H % bs || W % bs || !valid_grid(B, C, D / bs, H / bs, W / bs))
    return cudaErrorInvalidValue;
  const int nd = D / bs, nh = H / bs, nw = W / bs;
  const dim3 grid((unsigned)((long long)B * nd * nh * nw * C));
  if (dtype == LNN_F32) {
    pack_blocks_kernel<uint32_t><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), C, D, H, W, bs, nd,
        nh, nw);
  } else if (dtype == LNN_BF16) {
    pack_blocks_kernel<uint16_t><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint16_t*>(x), static_cast<uint16_t*>(out), C, D, H, W, bs, nd,
        nh, nw);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

cudaError_t lnn_unpack_blocks(const void* y, void* out, int B, int C, int s, int nd, int nh,
                              int nw, LnnDtype dtype, cudaStream_t stream) {
  if (s <= 0 || !valid_grid(B, C, nd, nh, nw)) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((long long)B * nd * nh * nw * C));
  if (dtype == LNN_F32) {
    unpack_blocks_kernel<uint32_t><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint32_t*>(y), static_cast<uint32_t*>(out), C, s, nd, nh, nw);
  } else if (dtype == LNN_BF16) {
    unpack_blocks_kernel<uint16_t><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint16_t*>(y), static_cast<uint16_t*>(out), C, s, nd, nh, nw);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
