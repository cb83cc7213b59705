// 2x up-interleave and its inverse, for Hopper (sm_90a).
//
// Replaces: lifelong_nnunet_tpu/ops/pallas/interleave.py, `_ileave_call`
// (:58, kernel `_ileave_kernel`) and `_dileave_call` (:73, kernel
// `_dileave_kernel`).  With P = 4 K sources (K = 1 or 2), each [N, R, H, Wm]
// (batch stride `sN` elements, the rest contiguous), and out [N, R, 2, 2H,
// K Wm] contiguous:
//
//   out[n, r, i, 2h + j, K w + k] = src[(2 i + j) K + k][n, r, h, w].
//
// K = 1 with N = 1 is the JAX contract, four (ND, H, M) arrays -> (ND, 2,
// 2H, M): the H and D interleave of the k=s=2 transposed conv.  K = 2 also
// interleaves W, which the port needs because it is channels-first: the
// eight octant products [N, Co D, H, W] of a transposed conv give its
// output [N, Co, 2D, 2H, 2W] directly (on the TPU the channels-last layout
// merges W into the row for free).  The de-interleave is the inverse
// gather, the backward of the interleave and the other way round.
//
// What bounds it on the card: memory bandwidth; a pure copy, moved as raw
// bits, so it equals the plain version bit for bit.
//
// What the design does about it: one thread per source position (n, r, h,
// w) moves all P of its elements; neighbouring threads touch neighbouring
// w, so every source row is read coalesced, and the K = 2 pair (2w, 2w + 1)
// of an output row is one 32-bit (bf16) or 64-bit (f32) store.

#include <cstdint>

#include "lnn_common.cuh"

namespace {

constexpr int kThreads = 256;

struct Ptrs {
  void* p[8];
};

// A K = 2 pair of elements as one store.
template <typename T>
struct Pair;
template <>
struct Pair<uint16_t> {
  using type = uint32_t;
  static __device__ type make(uint16_t a, uint16_t b) { return a | ((uint32_t)b << 16); }
  static __device__ uint16_t lo(type v) { return (uint16_t)(v & 0xffffu); }
  static __device__ uint16_t hi(type v) { return (uint16_t)(v >> 16); }
};
template <>
struct Pair<uint32_t> {
  using type = uint2;
  static __device__ type make(uint32_t a, uint32_t b) { return make_uint2(a, b); }
  static __device__ uint32_t lo(type v) { return v.x; }
  static __device__ uint32_t hi(type v) { return v.y; }
};

// Position of thread `t` among the N R H Wm source elements (fewer than
// 2^31, so the divisions are 32-bit): the output row group nr = n R + r, h,
// w, and the source offset n sN + (r H + h) Wm + w.
struct SrcPos {
  long long src;
  unsigned nr, h, w;
  __device__ SrcPos(unsigned t, unsigned R, unsigned H, unsigned Wm, long long sN) {
    w = t % Wm;
    const unsigned row = t / Wm;
    h = row % H;
    nr = row / H;
    src = (long long)(nr / R) * sN + ((long long)(nr % R) * H + h) * Wm + w;
  }
  // start of output row (nr, i, 2h + j), K Wm long
  __device__ long long out_row(int i, int j, unsigned H, unsigned KWm) const {
    return (((long long)nr * 2 + i) * 2 * H + 2 * h + j) * KWm;
  }
};

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    interleave_kernel(Ptrs srcs, long long sN, T* __restrict__ out, unsigned total,
                      unsigned R, unsigned H, unsigned Wm) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const SrcPos q(t, R, H, Wm, sN);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      T* orow = out + q.out_row(i, j, H, K * Wm);
      const int p = (2 * i + j) * K;
      if (K == 1) {
        orow[q.w] = static_cast<const T*>(srcs.p[p])[q.src];
      } else {
        reinterpret_cast<typename Pair<T>::type*>(orow)[q.w] =
            Pair<T>::make(static_cast<const T*>(srcs.p[p])[q.src],
                          static_cast<const T*>(srcs.p[p + 1])[q.src]);
      }
    }
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    deinterleave_kernel(const T* __restrict__ x, Ptrs dsts, long long sN, unsigned total,
                        unsigned R, unsigned H, unsigned Wm) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const SrcPos q(t, R, H, Wm, sN);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const T* xrow = x + q.out_row(i, j, H, K * Wm);
      const int p = (2 * i + j) * K;
      if (K == 1) {
        static_cast<T*>(dsts.p[p])[q.src] = xrow[q.w];
      } else {
        const typename Pair<T>::type v =
            reinterpret_cast<const typename Pair<T>::type*>(xrow)[q.w];
        static_cast<T*>(dsts.p[p])[q.src] = Pair<T>::lo(v);
        static_cast<T*>(dsts.p[p + 1])[q.src] = Pair<T>::hi(v);
      }
    }
  }
}

Ptrs to_ptrs(void* const* p, int n) {
  Ptrs out{};
  for (int i = 0; i < n; ++i) out.p[i] = p[i];
  return out;
}

// `dense` is the interleaved array (the output forward, the input backward),
// `arrays` the 4 K separate ones.
template <typename T>
cudaError_t launch(bool forward, void* dense, void* const* arrays, long long sN, int N,
                   long long R, int H, int Wm, int K, cudaStream_t stream) {
  const unsigned total = (unsigned)((long long)N * R * H * Wm);
  const unsigned blocks = (total + kThreads - 1) / kThreads;
  const Ptrs ptrs = to_ptrs(arrays, 4 * K);
  T* d = static_cast<T*>(dense);
  const unsigned r = (unsigned)R, h = (unsigned)H, w = (unsigned)Wm;
  if (forward && K == 1)
    interleave_kernel<T, 1><<<blocks, kThreads, 0, stream>>>(ptrs, sN, d, total, r, h, w);
  else if (forward)
    interleave_kernel<T, 2><<<blocks, kThreads, 0, stream>>>(ptrs, sN, d, total, r, h, w);
  else if (K == 1)
    deinterleave_kernel<T, 1><<<blocks, kThreads, 0, stream>>>(d, ptrs, sN, total, r, h, w);
  else
    deinterleave_kernel<T, 2><<<blocks, kThreads, 0, stream>>>(d, ptrs, sN, total, r, h, w);
  return cudaGetLastError();
}

cudaError_t dispatch(bool forward, void* dense, void* const* arrays, long long sN, int N,
                     long long R, int H, int Wm, int K, LnnDtype dtype, cudaStream_t stream) {
  if (N <= 0 || R <= 0 || H <= 0 || Wm <= 0 || (K != 1 && K != 2) ||
      sN < R * H * (long long)Wm || (long long)N * R * H * Wm > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (dtype == LNN_F32)
    return launch<uint32_t>(forward, dense, arrays, sN, N, R, H, Wm, K, stream);
  if (dtype == LNN_BF16)
    return launch<uint16_t>(forward, dense, arrays, sN, N, R, H, Wm, K, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

cudaError_t lnn_interleave_up2(const void* const* srcs, long long sN, void* out, int N,
                               long long R, int H, int Wm, int K, LnnDtype dtype,
                               cudaStream_t stream) {
  return dispatch(true, out, const_cast<void* const*>(srcs), sN, N, R, H, Wm, K, dtype,
                  stream);
}

cudaError_t lnn_deinterleave2(const void* x, void* const* dsts, long long sN, int N,
                              long long R, int H, int Wm, int K, LnnDtype dtype,
                              cudaStream_t stream) {
  return dispatch(false, const_cast<void*>(x), dsts, sN, N, R, H, Wm, K, dtype, stream);
}
