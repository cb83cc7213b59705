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
// fixed-extent windows by DMA, up to 8 in flight, with junk rows for
// Mosaic's lane rules; here there are no junk rows (a window is exactly
// (bs + 2)^3) and no padded copy of the volume.
//
// What bounds it on the card: memory bandwidth; it is a pure copy (no
// arithmetic), so each element is moved as raw bits (16 or 32 of them) and
// the result equals the plain version bit for bit.  The pack reads the
// volume about (S / bs)^3 times over (1.2x at bs 32), once from memory and
// the halo mostly from L2.
//
// What the design does about it.  The pack has two forms, chosen per
// launch by the wrapper's launch plan (`launch_plan` in
// ops/kernels/block_pack.py), never by a retry:
//
// * `tma` (every shape of the main paths): the TPU's one DMA per window
//   becomes the Tensor Memory Accelerator's tiled copy.  A tensor map over
//   x viewed as 4-D [W, H, D, B*C] (innermost first), encoded on the host
//   per launch, fetches boxes of [Wb, S, sz, 1] elements at (k0*bs - A,
//   j*bs - 1, i*bs - 1 + z0, b*C + c), A = 16 bytes of elements: the
//   hardware fills the halo before the volume and past its far edge with
//   zeros, so the kernel has no bounds test.  Two rules of the hardware
//   shape the box.  Its innermost start must lie on 16 bytes (a box at
//   k*bs - 1 faults with an illegal instruction on the H100; negative
//   starts of the other dimensions do not), so a box row begins A - 1
//   elements before the first window's.  And a box pays per row: with
//   boxes of one window (96-byte rows in bf16) no layout of the sweep
//   passed 0.68 of the bound at the main path's shapes (0.54 at B=64), so
//   a box spans the gw windows of a row along W (gw = 4 at W = 128:
//   288-byte rows, the windows' shared x-halos fetched once; 0.71-0.79),
//   Wb = A - 1 + gw*bs + 2 rounded up to A.  A window's S planes come in slabs of sz planes (the
//   last box starts at plane S - sz and writes only the planes not yet
//   written).  A persistent grid walks the (b*C + c, i, j, k0, slab) items
//   in that order, so the boxes that share a y- or z-halo run close in time
//   and read it from L2 (a walk in the order of out ran slower).  In each
//   block one producer thread keeps a ring of `stages` boxes in flight,
//   each completing on its `full` mbarrier; eight consumer warps turn each
//   box from row stride Wb to row stride S and write the gw windows' slabs
//   of out, each contiguous and 16-byte aligned for even bs, then release
//   the stage on its `empty` mbarrier.  Each 32-bit word of out is one f32
//   element of the box, or two bf16 elements that straddle two words of the
//   box (a window starts at an odd column), joined by a byte permute, and
//   each thread writes four such words by one 16-byte store.  (A compacted
//   slab written by one bulk copy from shared memory lost to these stores
//   at every shape of the main paths, by 4-45%: PERF.md.)  The launch's
//   layout in bytes (box row, shared memory) is `pack_tma_layout`'s, which
//   the binding exposes so that the wrapper's plan can be held to it.
// * `scalar` (shapes whose TMA rules fail: W * elem or bs * elem not a
//   multiple of 16 bytes, x not 16-byte aligned, odd bs): one thread block
//   per (window, channel) walks that window's S^3 elements in order with 2-
//   or 4-byte accesses and a bounds test per element.
//
// The unpack keeps the scalar walk of its blocks: one thread block per
// (window, channel), neighbouring threads on neighbouring addresses.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime

#include <algorithm>
#include <cstdint>

#include "lnn_common.cuh"
#include "lnn_sm90.cuh"

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

// ---- the TMA form

constexpr int kConsumerWarps = 8;
constexpr int kTmaThreads = 32 * (kConsumerWarps + 1);  // warp 0 produces
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr unsigned kAlign = 128;  // a TMA box's shared-memory alignment

__host__ __device__ constexpr unsigned round_up(unsigned v, unsigned a) {
  return (v + a - 1) / a * a;
}

// One launch's geometry.  Shared memory: `stages` boxes of box_bytes, each
// at a multiple of kAlign; then the full and empty mbarriers of each stage.
struct PackGeom {
  int C, nd, nh, nw, bs, S;
  int gw;         // windows of a box, along W
  int ng;         // boxes of a row of windows (nw / gw)
  int wb;         // elements of a box row
  int sz;         // planes of a box
  int ns;         // slabs of a window
  int stages;     // boxes in the ring
  long long items;
  unsigned box_bytes, stage_bytes;
};

// item t -> (b*C + c, i, j) of its row of windows, the first window kg*gw
// of its box and the slab, t running over (b*C + c, i, j, kg, slab)
struct Item {
  int bc, i, j, kg, slab;
  __device__ Item(long long t, const PackGeom& g) {
    slab = (int)(t % g.ns);
    t /= g.ns;
    kg = (int)(t % g.ng);
    t /= g.ng;
    j = (int)(t % g.nh);
    t /= g.nh;
    i = (int)(t % g.nd);
    bc = (int)(t / g.nd);
  }
};

// planes [p0, p1) of the window that slab `slab` writes, and the first
// plane of its box (the last box ends at the window's last plane)
struct Slab {
  int p0, p1, zbox;
  __device__ Slab(int slab, const PackGeom& g) {
    p0 = slab * g.sz;
    p1 = min(p0 + g.sz, g.S);
    zbox = min(p0, g.S - g.sz);
  }
};

// the 32-bit word of output elements [x, x + P) of row r (P = 4 / sizeof(T),
// x a multiple of P, counted from column A - 1 of the box, where the box's
// first window starts; window w starts at x = w bs) from `box`, rows of wb
// elements
template <typename T>
static __device__ __forceinline__ unsigned out_word(const unsigned* box, int r, int x, int wb) {
  constexpr int A = 16 / sizeof(T);
  const int o = r * wb + A - 1 + x;
  if constexpr (sizeof(T) == 4) {
    return box[o];
  } else {  // o is odd: the high half of word (o - 1) / 2, the low half of the next
    return __byte_perm(box[(o - 1) >> 1], box[(o + 1) >> 1], 0x5432);
  }
}

// (window w of the box, row r of its slab, element x of the row) of one
// consumer thread's next 16 bytes of output, stepped by kConsumers chunks
// with carries: rows of S elements, `rows` rows a window's slab
struct Walk {
  int w, r, x;
  __device__ Walk(int e, int S, int rows) {
    w = e / (rows * S);
    e -= w * rows * S;
    r = e / S;
    x = e - r * S;
  }
  __device__ void advance(int dr, int dx, int S, int rows) {
    x += dx;
    r += dr;
    if (x >= S) { x -= S; ++r; }
    while (r >= rows) { r -= rows; ++w; }
  }
};

template <typename T>
__global__ void __launch_bounds__(kTmaThreads)
    pack_tma_kernel(const __grid_constant__ CUtensorMap map, T* __restrict__ out,
                    const PackGeom g) {
  // elements of a 32-bit word and of a 16-byte chunk
  constexpr int P = 4 / sizeof(T), V = 16 / sizeof(T);
  extern __shared__ unsigned char smem_raw[];
  const unsigned a0 = smem_addr(smem_raw);
  unsigned char* smem = smem_raw + (round_up(a0, kAlign) - a0);
  // full[s] at bars + 8 s, empty[s] at bars + 8 (stages + s)
  const unsigned full0 = smem_addr(smem + (size_t)g.stages * g.stage_bytes),
                 empty0 = full0 + 8 * g.stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 32) {  // the producer warp: one thread issues every box
    if (threadIdx.x == 0) {
      int s = 0;
      unsigned round = 0;
      for (long long t = blockIdx.x; t < g.items; t += gridDim.x) {
        if (round > 0) mbar_wait(empty0 + 8 * s, (round - 1) & 1);
        const Item it(t, g);
        const Slab sl(it.slab, g);
        mbar_arrive_expect_tx(full0 + 8 * s, g.box_bytes);
        tma_load_4d(smem_addr(smem + (size_t)s * g.stage_bytes), &map, full0 + 8 * s,
                    it.kg * g.gw * g.bs - V, it.j * g.bs - 1, it.i * g.bs - 1 + sl.zbox, it.bc);
        if (++s == g.stages) { s = 0; ++round; }
      }
    }
    return;
  }

  const int ct = threadIdx.x - 32, lane = threadIdx.x & 31;
  const int S = g.S, wb = g.wb, bs = g.bs;
  const long long S3 = (long long)S * S * S;
  // 16 bytes a thread and step: 4 words of a row, or of two (S is even, so
  // no word straddles a row; a window's slab is a whole number of chunks)
  const int step = kConsumers * V, dr = step / S, dx = step - dr * S;
  int s = 0;
  unsigned round = 0;
  for (long long t = blockIdx.x; t < g.items; t += gridDim.x) {
    mbar_wait(full0 + 8 * s, round & 1);
    const Item it(t, g);
    const Slab sl(it.slab, g);
    const int b = it.bc / g.C, c = it.bc - b * g.C;
    // the box's first window; window w of the box is w C S^3 elements on
    const long long n = (((long long)b * g.nd + it.i) * g.nh + it.j) * g.nw + it.kg * g.gw;
    T* dst = out + (n * g.C + c) * S3 + (long long)sl.p0 * S * S;
    // the box from the slab's first plane on, in 32-bit words
    const unsigned* box = reinterpret_cast<const unsigned*>(smem + (size_t)s * g.stage_bytes) +
                          (sl.p0 - sl.zbox) * S * wb / P;
    const int rows = (sl.p1 - sl.p0) * S;  // of a window's slab
    const int chunks = g.gw * rows * S / V;
    Walk p(ct * V, S, rows);
    for (int q = ct; q < chunks; q += kConsumers, p.advance(dr, dx, S, rows)) {
      unsigned w[4];
      int rr = p.r, xx = p.x;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        w[u] = out_word<T>(box, rr, p.w * bs + xx, wb);
        xx += P;
        if (xx >= S) { xx -= S; ++rr; }
      }
      *reinterpret_cast<uint4*>(dst + p.w * g.C * S3 + p.r * S + p.x) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
    if (++s == g.stages) { s = 0; ++round; }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point (no -lcuda)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                               : nullptr;
  }();
  return fn;
}

template <typename T>
cudaError_t launch_tma(const CUtensorMap& map, void* out, const PackGeom& g, int blocks,
                       size_t smem, cudaStream_t stream) {
  auto kernel = pack_tma_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kTmaThreads, smem, stream>>>(map, static_cast<T*>(out), g);
  return cudaGetLastError();
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

namespace {

cudaError_t pack_scalar(const void* x, void* out, int B, int C, int D, int H, int W, int bs,
                        LnnDtype dtype, cudaStream_t stream) {
  const int nd = D / bs, nh = H / bs, nw = W / bs;
  const dim3 grid((unsigned)((long long)B * nd * nh * nw * C));
  if (dtype == LNN_F32) {
    pack_blocks_kernel<uint32_t><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), C, D, H, W, bs, nd,
        nh, nw);
  } else {
    pack_blocks_kernel<uint16_t><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint16_t*>(x), static_cast<uint16_t*>(out), C, D, H, W, bs, nd,
        nh, nw);
  }
  return cudaGetLastError();
}

// The TMA form; refuses (cudaErrorInvalidValue) a shape or plan that breaks
// a TMA rule or the 16-byte alignment of the slabs, and a refused encode.
cudaError_t pack_tma(const void* x, void* out, int B, int C, int D, int H, int W, int bs,
                     LnnDtype dtype, const LnnPackPlan& plan, cudaStream_t stream) {
  const int elem = dtype == LNN_F32 ? 4 : 2;
  const long long S = bs + 2, plane = S * S * elem;
  const int sz = plan.sz, gw = plan.gw;
  if (S % 2 || ((long long)W * elem) % 16 || (bs * elem) % 16 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(out) % 16 || S > 256 ||
      sz < 1 || sz > S || gw < 1 || (W / bs) % gw || plan.stages < 1 || plan.blocks < 1 ||
      (long long)B * C > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const LnnPackLayout layout = lnn_pack_tma_layout(bs, elem, sz, gw, plan.stages);
  PackGeom g;
  g.C = C;
  g.nd = D / bs;
  g.nh = H / bs;
  g.nw = W / bs;
  g.bs = bs;
  g.S = (int)S;
  g.gw = gw;
  g.ng = g.nw / gw;
  g.wb = layout.box_row;
  g.sz = sz;
  g.ns = (int)((S + sz - 1) / sz);
  g.stages = plan.stages;
  g.items = (long long)B * C * g.nd * g.nh * g.ng * g.ns;
  // every slab of out starts and ends on 16 bytes
  if ((plane * sz) % 16 || (plane * (S - (long long)(g.ns - 1) * sz)) % 16 || g.wb > 256)
    return cudaErrorInvalidValue;
  g.box_bytes = (unsigned)layout.box_bytes;
  g.stage_bytes = round_up(g.box_bytes, kAlign);

  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)D,
                              (cuuint64_t)B * C};
  const cuuint64_t strides[3] = {(cuuint64_t)W * elem, (cuuint64_t)H * W * elem,
                                 (cuuint64_t)D * H * W * elem};
  const cuuint32_t box[4] = {(cuuint32_t)g.wb, (cuuint32_t)S, (cuuint32_t)sz, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      &map, dtype == LNN_F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(x), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return cudaErrorInvalidValue;
  const int blocks = (int)std::min<long long>(plan.blocks, g.items);
  const size_t smem = (size_t)layout.smem;
  return dtype == LNN_F32 ? launch_tma<uint32_t>(map, out, g, blocks, smem, stream)
                          : launch_tma<uint16_t>(map, out, g, blocks, smem, stream);
}

}  // namespace

LnnPackLayout lnn_pack_tma_layout(int bs, int elem, int sz, int gw, int stages) {
  // a box row runs from A - 1 elements before its first window (A = 16
  // bytes of elements: a box's innermost start lies on 16 bytes) to its
  // last window's far halo column, rounded up to A
  const unsigned A = 16 / elem, S = bs + 2;
  LnnPackLayout l;
  l.box_row = (int)round_up(A - 1 + (unsigned)gw * bs + 2, A);
  l.box_bytes = (long long)l.box_row * S * sz * elem;
  l.smem = (long long)stages * round_up((unsigned)l.box_bytes, kAlign) + 16LL * stages + kAlign;
  return l;
}

cudaError_t lnn_pack_blocks(const void* x, void* out, int B, int C, int D, int H, int W,
                            int bs, LnnDtype dtype, LnnPackPlan plan, cudaStream_t stream) {
  if (bs <= 0 || D % bs || H % bs || W % bs || !valid_grid(B, C, D / bs, H / bs, W / bs) ||
      (dtype != LNN_F32 && dtype != LNN_BF16))
    return cudaErrorInvalidValue;
  if (plan.form == LNN_PACK_SCALAR)
    return pack_scalar(x, out, B, C, D, H, W, bs, dtype, stream);
  if (plan.form == LNN_PACK_TMA) return pack_tma(x, out, B, C, D, H, W, bs, dtype, plan, stream);
  return cudaErrorInvalidValue;
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
