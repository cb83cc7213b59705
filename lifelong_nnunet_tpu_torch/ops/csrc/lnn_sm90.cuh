// PTX helpers of the port's Hopper (sm_90a) kernels: asynchronous copies
// into shared memory (`cp.async`), the fence that hands shared memory
// written by threads to the async proxy, and warpgroup matrix products
// (`wgmma`) with their fence / commit / wait and shared-memory descriptors,
// shared by conv3d_in_lrelu.cu, conv3d_wgrad.cu and flash_attention.cu; the Tensor Memory
// Accelerator's tiled loads (`cp.async.bulk.tensor`) and the `mbarrier`s
// they complete on, used by block_pack.cu.
#pragma once

#include <cuda_runtime.h>

static __device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

static __device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
// 16 bytes from src, or 16 zero bytes where `valid` is false (src is then
// not read)
static __device__ __forceinline__ void cp_async16_zfill(unsigned dst, const void* src,
                                                        bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
// 4 bytes, or zeros where `valid` is false
static __device__ __forceinline__ void cp_async4_zfill(unsigned dst, const void* src,
                                                       bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}
static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
static __device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
static __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// this thread's shared-memory writes (st.shared, cp.async) made visible to
// the async proxy that wgmma reads them through
static __device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- mbarriers: a phase completes once `count` threads have arrived and
// the bytes announced by expect_tx have landed
static __device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// the barriers' initialization made visible to the async proxy (TMA)
static __device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
static __device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
                   bar)
               : "memory");
}
// arrive, and announce `bytes` that asynchronous copies will complete on bar
static __device__ __forceinline__ void mbar_arrive_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// spin until the phase of parity `parity` has completed
static __device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA: one box of a 4-D tiled tensor map (a __grid_constant__ kernel
// parameter) at signed coordinates (innermost first) into shared memory at
// dst (128-byte aligned), completing on bar; elements outside the tensor
// land as the map's out-of-bounds fill
static __device__ __forceinline__ void tma_load_4d(unsigned dst, const void* map, unsigned bar,
                                                   int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

static __device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
static __device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
static __device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// wait until at most N of the warpgroup's committed groups are in flight
template <int N>
static __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D[64 x n] += A[64 x 16] B[16 x n], bf16 -> f32, both operands in shared
// memory (descriptors da, db), for the warpgroup
static __device__ __forceinline__ void wgmma_n32(float (&d)[16], unsigned long long da,
                                                 unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}
static __device__ __forceinline__ void wgmma_n64(float (&d)[32], unsigned long long da,
                                                 unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// Shared-memory matrix descriptor, no swizzle: 8x8 core matrices of 128
// contiguous bytes (8 rows of 16 bytes), `lbo` bytes between core matrices
// adjacent in K, `sbo` bytes between core matrices adjacent in M or N.  For
// a K-major operand (K contiguous in a core matrix's 16-byte rows) that is
// the two k halves of a k16 step and consecutive 8-row groups; for an
// MN-major one (the transpose bit) the core matrices' rows run along K.
static __device__ __forceinline__ unsigned long long desc(unsigned addr, unsigned lbo,
                                                          unsigned sbo) {
  return (unsigned long long)((addr & 0x3FFFF) >> 4) |
         ((unsigned long long)(lbo >> 4) << 16) | ((unsigned long long)(sbo >> 4) << 32);
}
