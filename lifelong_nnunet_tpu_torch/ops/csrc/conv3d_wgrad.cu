// Weight gradient of the fused 3x3x3 stride-1 SAME conv on the tensor cores,
// for Hopper (sm_90a): dw[co, ci, kd, kh, kw] = sum over b and the output
// voxels o of dy[b, co, o] * x[b, ci, o + (kd, kh, kw) - 1], zero outside
// the volume, from bf16 x [B, Cin, D, H, W] and bf16 dy [B, Cout, D, H, W]
// as the fused op's backward holds them, into f32 dw [Cout, Cin, 3, 3, 3].
//
// Replaces no TPU kernel: the JAX package leaves this product to XLA
// (`_fused_bwd`'s weight gradient, lifelong_nnunet_tpu/ops/pallas/conv3d.py:
// 351-360).  The port called the library's weight gradient on f32 copies of
// x and dy (cuDNN's TF32 implicit GEMM, after two casts and two layout
// passes).  A bf16 value is a TF32 value, so this kernel computes the same
// products, bf16 x bf16 exact in f32, summed in f32; only the order of the
// sum differs.
//
// What bounds it on the card: operations, at 15 of the CT step's 17
// shapes and over the step (bytes at the first conv, whose one input
// channel gives 26 flops a byte against the card's 295, and at the 4^3
// bottleneck).  It is the GEMM
// dw[Cout, 27 Cin] = dy[Cout, V] im2col(x)[V, 27 Cin] over V = B D H W
// voxels, the forward's work (2 * 27 * Cin * Cout * V flops) with a huge
// reduction axis and a small output, so only the tensor cores come near
// its bound.  Design:
//
//  * The reduction over voxels is wgmma's K axis, 16 voxels (two W lines of
//    8) a k16 step.  A block walks a run of 4x8x8 voxel boxes (256 voxels,
//    16 k steps each) and keeps its dw tile in registers: the rows of one
//    input-channel chunk of 16 at all 27 taps (54 groups of 8 rows in eight
//    m64 tiles, two on each of four warpgroups) against NT = 32 or 64
//    output channels.
//  * Per box the halo'd 6x10x10 input tile of the chunk is staged once in
//    shared memory, channels-last in two planes of 8 channels (16 bytes a
//    voxel), read through registers as the forward kernel reads it
//    (conv3d_in_lrelu.cu), and dy's 4x8x8 box of NT channels in wgmma's
//    K-major core matrices (8 channels x one W line of 8 voxels).
//  * A is x: every 8-row group of an m64 tile is one (8-channel plane,
//    tap), so its k step is that plane read at the tap's shifted voxels.
//    `ldmatrix.trans` gathers it into registers from 16-byte voxel rows at
//    any shift: the im2col costs nothing, and A goes to `wgmma` from
//    registers (A from shared memory would need one stride along M, which
//    (plane, tap) groups do not have).  B is dy's tile, from shared memory.
//    Two A register sets alternate, so one k step's loads run under the
//    previous step's products.
//  * One input channel (the first conv): the (kh, kw) taps are folded into
//    the chunk's 16 channels (9 used) as the forward folds them, and the
//    rows are (channel half, kd): one m64 tile, not 27 taps of 1 channel,
//    each warpgroup taking a quarter of the k steps.
//  * The next box's loads are issued before this box's products and stored
//    after them (two stages).  On an H100 (PERF.md) these loads bound it at
//    the 128^3 blocks: 9.7 ms a CT train step, 18% of its bound; a ring of
//    three cp.async stages running two boxes ahead was slower (10.9 ms).
//  * The boxes are split into `splits` runs, chosen by the wrapper from the
//    shape alone (`wgrad_plan` in ops/kernels/conv3d.py) so the blocks fill
//    the SMs in one wave; each run's f32 partial tile goes to a workspace
//    and `wgrad_reduce_kernel` sums the runs in order.  No atomics: a run
//    repeats bit for bit.

#include <type_traits>

#include "lnn_common.cuh"
#include "lnn_sm90.cuh"

namespace {

namespace wg {

constexpr int kTD = 4, kTH = 8, kTW = 8;         // voxel box: 32 W lines of 8
constexpr int kBox = kTD * kTH * kTW;
constexpr int kSteps = kBox / 16;                // k16 steps a box
constexpr int kHD = kTD + 2, kHH = kTH + 2, kHW = kTW + 2;
constexpr int kHalo = kHD * kHH * kHW;           // 600 voxels of halo'd input tile
constexpr int kFoldTile = kHD * kTH * kTW;       // 384: the folded tile (kd halo only)
constexpr int kCK = 16;                          // input channels a chunk: two planes of 8
constexpr int kWGs = 4;                          // warpgroups a block
constexpr int kThreads = 128 * kWGs;
constexpr int kFinThreads = 256;
static_assert(kBox == 256 && kTW == 8 && kTH == 8, "two W lines a k16 step");

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }
inline long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }
inline int n_tile(int Cout) { return Cout <= 32 ? 32 : 64; }
inline long long boxes_per_item(int D, int H, int W) {
  return (long long)ceil_div(D, kTD) * ceil_div(H, kTH) * ceil_div(W, kTW);
}

// How the input tile is staged, as in the forward kernel.
enum Staging { kVoxels = 0, kPairs = 1, kFold = 2 };

template <int STAGING>
constexpr int x_bytes() {
  return 2 * (STAGING == kFold ? kFoldTile : kHalo) * 16;
}
template <int NT, int STAGING>
constexpr int stage_bytes() {
  return x_bytes<STAGING>() + kBox * NT * 2;
}

static __device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// D[64 x n] += A[64 x 16] B[16 x n], bf16 -> f32, A from registers (the
// m16n8k16 fragment of each warp's 16 rows), B K-major in shared memory
static __device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const unsigned (&a)[4],
                                                    unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
static __device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const unsigned (&a)[4],
                                                    unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <int NT>
__device__ __forceinline__ void wgmma_rs(float (&d)[NT / 2], const unsigned (&a)[4],
                                         unsigned long long db) {
  if constexpr (NT == 64)
    wgmma_rs_n64(d, a, db);
  else
    wgmma_rs_n32(d, a, db);
}

// The rows of the dw tile: 8-row groups q, each one (plane, tap) of the
// staged tile.  Unfolded: plane q / 27 (channels 8 p .. 8 p + 7 of the
// chunk), tap q % 27 = 9 kd + 3 kh + kw, 54 groups in 8 m64 tiles (the
// last 10 groups of the last tile read group 0 and are not written), two
// tiles a warpgroup over every k step.  Folded: plane (channel half) q / 3,
// kd = q % 3 (its rows the folded channels k = 3 kh + kw), 6 groups in one
// tile, which every warpgroup runs over a quarter of the k steps; their
// sums are added in warpgroup order at the end.  Every warpgroup issues
// the same products: no branch around a wgmma.
template <int STAGING>
struct Rows {
  static constexpr bool FOLD = STAGING == kFold;
  static constexpr int kGroups = FOLD ? 6 : 54;
  static constexpr int kMine = FOLD ? 1 : 2;          // m64 tiles a warpgroup
  static constexpr int kKSplit = FOLD ? kWGs : 1;     // warpgroups sharing a tile
  static_assert(kMine * kWGs / kKSplit * 8 >= kGroups, "every group in a tile");
  static_assert(kSteps % kKSplit == 0, "whole shares of the k steps");
  static constexpr int kPlane = FOLD ? kFoldTile : kHalo;   // voxels a plane
  static constexpr int kLine = FOLD ? kTW : kHW;            // voxels a staged h line
  static constexpr int kDPlane = FOLD ? kTH * kTW : kHH * kHW;
  // the group's first voxel in the staged tile, in 16-byte rows (a group
  // past the last reads group 0; its rows are not written)
  static __device__ __forceinline__ int offset(int q) {
    if (q >= kGroups) q = 0;
    if constexpr (FOLD) return q / 3 * kPlane + q % 3 * kDPlane;
    const int p = q / 27, tap = q % 27;
    return p * kPlane + (tap / 9) * kDPlane + (tap / 3) % 3 * kLine + tap % 3;
  }
};

template <int NT, int STAGING>
__global__ void __launch_bounds__(kThreads, 1)
    wgrad_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
                    float* __restrict__ out, int Cin, int Cout, int D, int H, int W, int nTh,
                    int nTw, long long per_item, long long boxes, long long per_split) {
  using R = Rows<STAGING>;
  constexpr bool PAIRS = STAGING == kPairs, FOLD = STAGING == kFold;
  constexpr int NG = NT / 8;                 // 8-channel groups of dy's tile
  constexpr int kMine = R::kMine, kKSplit = R::kKSplit;
  constexpr int kXBytes = x_bytes<STAGING>();
  extern __shared__ __align__(128) unsigned char smem[];

  const int split = blockIdx.x, n0 = blockIdx.y * NT, c0 = blockIdx.z * kCK;
  const long long box_begin = split * per_split;
  const long long box_end = box_begin + per_split < boxes ? box_begin + per_split : boxes;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int wgi = warp >> 2, wq = warp & 3;  // warpgroup, its warp
  const int tile0 = wgi / kKSplit * kMine;   // this warpgroup's first m64 tile
  const int kq = wgi % kKSplit;              // ... and its share of the k steps
  const long long HW = (long long)H * W;
  const long long DHW = D * HW;
  const bool dy_vec = W % 8 == 0;  // dy's W lines whole 16-byte rows

  // ---- the input tile (see the forward kernel's loader): units of one k
  // half (8 channels) of one voxel, or of two voxels where W is even
  // (4-byte loads at an even w), or with one input channel the folded
  // channels k = 3 kh + kw of a voxel of the kd-halo'd box
  constexpr int kUnits = PAIRS ? kHD * kHH * (kHW + 2) / 2 * 2 : 2 * R::kPlane;
  constexpr int kPer = (kUnits + kThreads - 1) / kThreads;
  constexpr int kRowUnits = PAIRS ? (kHW + 2) / 2 : kHW;
  constexpr int kHalfUnits = kUnits / 2;
  using Raw = typename std::conditional<PAIRS, unsigned, unsigned short>::type;
  Raw araw[kPer][8];
  auto load_x = [&](int b, int d0, int h0, int w0) {
    const unsigned short* xb =
        reinterpret_cast<const unsigned short*>(x) + ((long long)b * Cin + c0) * DHW;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int u = t + j * kThreads, half = u >= kHalfUnits, r = u - half * kHalfUnits;
      if constexpr (FOLD) {
        const int gd = d0 + r / (kTH * kTW) - 1;
        const int hh = h0 + (r / kTW) % kTH - 1, ww = w0 + r % kTW - 1;
        const bool dok = u < kUnits && gd >= 0 && gd < D;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int kk = half * 8 + k, gh = hh + kk / 3, gw = ww + kk % 3;
          araw[j][k] = dok && kk < 9 && gh >= 0 && gh < H && gw >= 0 && gw < W
                           ? __ldg(xb + gd * HW + (long long)gh * W + gw)
                           : Raw(0);
        }
        continue;
      }
      const int gd = d0 + r / (kHH * kRowUnits) - 1;
      const int gh = h0 + (r / kRowUnits) % kHH - 1;
      const int gw = w0 + (PAIRS ? 2 * (r % kRowUnits) - 2 : r % kRowUnits - 1);
      const bool ok = u < kUnits && gd >= 0 && gd < D && gh >= 0 && gh < H && gw >= 0 && gw < W;
      const int ci0 = half * 8;
      const unsigned short* src = xb + ci0 * DHW + (ok ? gd * HW + (long long)gh * W + gw : 0);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        araw[j][k] = ok && c0 + ci0 + k < Cin
                         ? __ldg(reinterpret_cast<const Raw*>(src + k * DHW))
                         : Raw(0);
    }
  };
  auto store_x = [&](unsigned char* xs) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int u = t + j * kThreads;
      if (u >= kUnits) continue;
      const int half = u >= kHalfUnits, r = u - half * kHalfUnits;
      unsigned char* plane = xs + half * R::kPlane * 16;
      if constexpr (PAIRS) {
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
  // ---- dy's box: row (channel n, W line l) is core-matrix row n & 7 of
  // core matrix (l, n >> 3) at byte (l * NG + (n >> 3)) * 128; zeros past
  // Cout and outside the volume.  Whole 16-byte lines by cp.async where W
  // is a multiple of 8, else element by element.
  auto load_dy = [&](int b, int d0, int h0, int w0, unsigned char* ds) {
    for (int u = t; u < NT * (kBox / 8); u += kThreads) {
      const int n = u % NT, l = u / NT, gd = d0 + l / kTH, gh = h0 + l % kTH;
      const bool ok = n0 + n < Cout && gd < D && gh < H;
      const __nv_bfloat16* src =
          dy + (((long long)b * Cout + n0 + n) * D + gd) * HW + (long long)gh * W + w0;
      unsigned char* dst = ds + (l * NG + (n >> 3)) * 128 + (n & 7) * 16;
      if (dy_vec) {
        cp_async16_zfill(smem_addr(dst), ok ? src : dy, ok);
      } else {
        const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
        unsigned v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = ok && w0 + k < W ? __ldg(s + k) : 0u;
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0] | (v[1] << 16), v[2] | (v[3] << 16),
                                                    v[4] | (v[5] << 16), v[6] | (v[7] << 16));
      }
    }
    cp_async_commit();
  };
  auto box_at = [&](long long box, int& b, int& d0, int& h0, int& w0) {
    b = (int)(box / per_item);
    const int tile = (int)(box % per_item);
    d0 = tile / (nTh * nTw) * kTD;
    h0 = (tile / nTw) % nTh * kTH;
    w0 = tile % nTw * kTW;
  };

  // ---- this lane's ldmatrix rows: lane L reads row L & 7 (W voxel) of
  // matrix L >> 3: group 2 wq + ((L >> 3) & 1) of the tile (rows 0-7 or
  // 8-15 of the warp's 16), k half L >> 4 (the first or second W line)
  int goff[kMine];
#pragma unroll
  for (int i = 0; i < kMine; ++i)
    goff[i] = R::offset(8 * (tile0 + i) + 2 * wq + ((lane >> 3) & 1));
  const int khalf = lane >> 4, vw = lane & 7;

  float acc[kMine][NT / 2];
#pragma unroll
  for (int i = 0; i < kMine; ++i)
#pragma unroll
    for (int r = 0; r < NT / 2; ++r) acc[i][r] = 0.f;

  unsigned char* stage[2] = {smem, smem + stage_bytes<NT, STAGING>()};
  {
    int b, d0, h0, w0;
    box_at(box_begin, b, d0, h0, w0);
    load_dy(b, d0, h0, w0, stage[0] + kXBytes);
    load_x(b, d0, h0, w0);
    store_x(stage[0]);
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();
  }

  for (long long box = box_begin; box < box_end; ++box) {
    const int s_cur = (int)((box - box_begin) & 1);
    unsigned char* cur = stage[s_cur];
    unsigned char* nxt = stage[s_cur ^ 1];
    const bool more = box + 1 < box_end;
    int nb = 0, nd0 = 0, nh0 = 0, nw0 = 0;
    if (more) {  // the next box's loads go out before this box's products
      box_at(box + 1, nb, nd0, nh0, nw0);
      if (dy_vec) load_dy(nb, nd0, nh0, nw0, nxt + kXBytes);
      load_x(nb, nd0, nh0, nw0);
    }
    const unsigned xs = smem_addr(cur), ds = smem_addr(cur + kXBytes);
    unsigned a[2][kMine][4];
#pragma unroll
    for (int ss = 0; ss < kSteps / kKSplit; ++ss) {
      // k step s: W lines 2 s and 2 s + 1 of the box
      const int s = ss * kKSplit + kq;
      const int l = 2 * s + khalf;
      const int vox = (l / kTH) * R::kDPlane + (l % kTH) * R::kLine + vw;
#pragma unroll
      for (int i = 0; i < kMine; ++i) ldmatrix_x4_trans(a[ss & 1][i], xs + (goff[i] + vox) * 16);
      wgmma_fence();
      const unsigned long long db = desc(ds + s * 2 * NG * 128, NG * 128, 128);
#pragma unroll
      for (int i = 0; i < kMine; ++i) wgmma_rs<NT>(acc[i], a[ss & 1][i], db);
      wgmma_commit();
      wgmma_wait<1>();
    }
    wgmma_wait<0>();
    if (more) {
      store_x(nxt);
      if (!dy_vec) load_dy(nb, nd0, nh0, nw0, nxt + kXBytes);
      cp_async_wait_all();
      fence_async_smem();
    }
    __syncthreads();
  }

  // warpgroups that share a tile: the later ones' sums added to the first's
  // in warpgroup order, through shared memory (the stages are free now)
  if constexpr (kKSplit > 1) {
    float* red = reinterpret_cast<float*>(smem);  // [kKSplit - 1][128][kMine * NT / 2]
    constexpr int kPerThread = kMine * NT / 2;
    static_assert((kKSplit - 1) * 128 * kPerThread * 4 <= 2 * stage_bytes<NT, STAGING>(),
                  "the sums fit the stages");
    const int tw = t & 127;
    if (kq > 0)
#pragma unroll
      for (int i = 0; i < kMine; ++i)
#pragma unroll
        for (int e = 0; e < NT / 2; ++e)
          red[((kq - 1) * 128 + tw) * kPerThread + i * NT / 2 + e] = acc[i][e];
    __syncthreads();
    if (kq > 0) return;
#pragma unroll
    for (int k = 1; k < kKSplit; ++k)
#pragma unroll
      for (int i = 0; i < kMine; ++i)
#pragma unroll
        for (int e = 0; e < NT / 2; ++e)
          acc[i][e] += red[((k - 1) * 128 + tw) * kPerThread + i * NT / 2 + e];
  }
  // accumulator (i, 4 j + 2 h + e): row 16 wq + (lane >> 2) + 8 h of tile
  // tile0 + i, i.e. row lane >> 2 of group 8 (tile0 + i) + 2 wq + h;
  // channel n0 + 8 j + 2 (lane & 3) + e.  dw (or this split's partial) is
  // [Cout, Cin, 27].
  float* dst = out + (long long)split * Cout * Cin * 27;
  const int r = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < kMine; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = 8 * (tile0 + i) + 2 * wq + h;
      if (q >= R::kGroups) continue;
      int ci, tap;
      if constexpr (FOLD) {
        const int k = (q / 3) * 8 + r;  // folded channel 3 kh + kw
        if (k >= 9) continue;
        ci = 0;
        tap = q % 3 * 9 + k;
      } else {
        ci = c0 + q / 27 * 8 + r;
        tap = q % 27;
        if (ci >= Cin) continue;
      }
#pragma unroll
      for (int j = 0; j < NT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = n0 + 8 * j + 2 * tq + e;
          if (co < Cout) dst[((long long)co * Cin + ci) * 27 + tap] = acc[i][4 * j + 2 * h + e];
        }
    }
  }
}

// The splits' partials summed in split order: dw[i] = sum_s ws[s n + i].
__global__ void __launch_bounds__(kFinThreads)
    wgrad_reduce_kernel(const float* __restrict__ ws, float* __restrict__ dw, int splits,
                        long long n) {
  const long long i = (long long)blockIdx.x * kFinThreads + threadIdx.x;
  if (i >= n) return;
  float v = ws[i];
  for (int s = 1; s < splits; ++s) v += ws[(long long)s * n + i];
  dw[i] = v;
}

// splits in [1, boxes], and none empty
bool bad_split(long long boxes, int splits) {
  return splits < 1 || splits > boxes ||
         (long long)(splits - 1) * ceil_div(boxes, (long long)splits) >= boxes;
}

template <int NT, int STAGING>
cudaError_t launch_one(const void* x, const void* dy, float* out, int B, int Cin, int Cout,
                       int D, int H, int W, int splits, cudaStream_t st) {
  auto kernel = wgrad_tc_kernel<NT, STAGING>;
  constexpr int smem = 2 * stage_bytes<NT, STAGING>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long per_item = boxes_per_item(D, H, W), boxes = B * per_item;
  const dim3 grid((unsigned)splits, (unsigned)ceil_div(Cout, NT),
                  (unsigned)(STAGING == kFold ? 1 : ceil_div(Cin, kCK)));
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy), out, Cin,
      Cout, D, H, W, ceil_div(H, kTH), ceil_div(W, kTW), per_item, boxes,
      ceil_div(boxes, (long long)splits));
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch(const void* x, const void* dy, float* out, int B, int Cin, int Cout, int D,
                   int H, int W, int splits, cudaStream_t st) {
  if (Cin == 1)
    return launch_one<NT, kFold>(x, dy, out, B, Cin, Cout, D, H, W, splits, st);
  if (W % 2 == 0)
    return launch_one<NT, kPairs>(x, dy, out, B, Cin, Cout, D, H, W, splits, st);
  return launch_one<NT, kVoxels>(x, dy, out, B, Cin, Cout, D, H, W, splits, st);
}

}  // namespace wg

}  // namespace

long long lnn_conv3d_wgrad_workspace_len(int B, int Cin, int Cout, int D, int H, int W,
                                         int splits) {
  return splits > 1 ? (long long)splits * Cout * Cin * 27 : 0;
}

cudaError_t lnn_conv3d_wgrad_tc(const void* x, const void* dy, float* dw, float* workspace,
                                int B, int Cin, int Cout, int D, int H, int W, int splits,
                                cudaStream_t st) {
  if (B <= 0 || Cin <= 0 || Cout <= 0 || D <= 0 || H <= 0 || W <= 0 ||
      wg::bad_split((long long)B * wg::boxes_per_item(D, H, W), splits) ||
      wg::ceil_div(Cout, wg::n_tile(Cout)) > 65535 || wg::ceil_div(Cin, wg::kCK) > 65535 ||
      (splits > 1 && workspace == nullptr))
    return cudaErrorInvalidValue;
  float* out = splits > 1 ? workspace : dw;
  const cudaError_t err = wg::n_tile(Cout) == 64
                              ? wg::launch<64>(x, dy, out, B, Cin, Cout, D, H, W, splits, st)
                              : wg::launch<32>(x, dy, out, B, Cin, Cout, D, H, W, splits, st);
  if (err != cudaSuccess || splits == 1) return err;
  const long long n = (long long)Cout * Cin * 27;
  wg::wgrad_reduce_kernel<<<(unsigned)wg::ceil_div(n, (long long)wg::kFinThreads),
                            wg::kFinThreads, 0, st>>>(workspace, dw, splits, n);
  return cudaGetLastError();
}
