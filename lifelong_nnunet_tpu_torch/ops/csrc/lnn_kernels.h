// The launchers of the port's hand-written Hopper kernels: raw device
// pointers, sizes and the stream in, the cudaError_t of their launches out.
//
// Included by the kernel sources (*.cu), which define them, and by
// binding.cpp, which calls them on tensors, so the compiler holds both sides
// to one signature.  Nothing here includes a PyTorch header: the .cu files
// compile with nvcc alone, and only binding.cpp pays for torch/extension.h.
#pragma once

#include <cuda_runtime.h>

// element types of the kernels' inputs and outputs
enum LnnDtype { LNN_F32 = 0, LNN_BF16 = 1 };

// The form of an InstanceNorm launch, chosen per (B, C, N, dtype) by the
// caller's launch plan (`launch_plan` in ops/kernels/instance_norm.py):
// LNN_IN_WARP, one warp per row of at most 512 elements, the row in
// registers; LNN_IN_CLUSTER, a row split over a cluster of `cluster` blocks
// of `threads` threads, block r owning elements [r slice, (r + 1) slice) of
// it, the first `keep` of those staged in shared memory and the rest
// streamed from device memory twice.  `vec`: 16-byte access (every row and
// pointer aligned to it), else scalar.  The launchers raise (return
// cudaErrorInvalidValue) on a plan that does not cover each row exactly.
enum { LNN_IN_WARP = 0, LNN_IN_CLUSTER = 1 };
struct LnnInPlan {
  int form;
  int cluster;
  long long slice;
  long long keep;
  int threads;
  int vec;
};

// The limits a plan is made within, on the current device: its SMs, the
// dynamic shared memory a cluster-form block may take, and the largest
// cluster (16, 8, ... 1) the card schedules with that much in each block.
cudaError_t lnn_instance_norm_limits(int* sms, int* smem, int* cluster);

// InstanceNorm + LeakyReLU forward.  x, out: [B, C, N] of `dtype`,
// contiguous.  scale, bias: [C] f32.  mean, rstd: [B, C] f32 (kept for the
// backward).
cudaError_t lnn_instance_norm_leaky_fwd(const void* x, const float* scale,
                                        const float* bias, void* out, float* mean,
                                        float* rstd, int B, int C, long long N,
                                        float alpha, float eps, LnnDtype dtype,
                                        LnnInPlan plan, cudaStream_t stream);

// InstanceNorm + LeakyReLU backward.  x, g: [B, C, N] of `dtype` (the
// forward's input and the gradient of its output); scale, bias: [C] f32;
// mean, rstd: [B, C] f32 from the forward; dx: [B, C, N] of `dx_dtype`;
// dscale, dbias: [C] f32, summed over B; partials: 2 * B * C floats of
// scratch.
cudaError_t lnn_instance_norm_leaky_bwd(const void* x, const void* g, const float* scale,
                                        const float* bias, const float* mean,
                                        const float* rstd, void* dx, float* dscale,
                                        float* dbias, float* partials, int B, int C,
                                        long long N, float alpha, LnnDtype dtype,
                                        LnnDtype dx_dtype, LnnInPlan plan,
                                        cudaStream_t stream);

// Length in floats of the partial-statistics scratch of one f32-input conv
// call (the FMA entries below).
long long lnn_conv3d_partials_len(int B, int Cout, int D, int H, int W);

// Fused 3x3x3 stride-1 SAME conv + InstanceNorm + LeakyReLU forward, f32
// FMA on the CUDA cores: the entry of f32 input (`in_dtype` LNN_F32).
// x: [B, Cin, D, H, W] of `in_dtype`; w: [Cin, 27, Cout] of `in_dtype`;
// scale, offset: [Cout] f32; y: [B, Cout, D, H, W] of `out_dtype`, written
// with the activated result; partials: lnn_conv3d_partials_len floats of
// scratch.  All contiguous, on the device of `stream`.
cudaError_t lnn_conv3d_in_lrelu_fwd(const void* x, const void* w, const float* scale,
                                    const float* offset, void* y, float* partials,
                                    int B, int Cin, int Cout, int D, int H, int W,
                                    float slope, float eps, LnnDtype in_dtype,
                                    LnnDtype out_dtype, cudaStream_t stream);

// The same fused forward for training: ycf receives the raw conv output
// (of `out_dtype`), out the activated result, mean and inv ([B, Cout] f32)
// the statistics the backward reuses.
cudaError_t lnn_conv3d_in_lrelu_train_fwd(const void* x, const void* w,
                                          const float* scale, const float* offset,
                                          void* ycf, void* out, float* mean, float* inv,
                                          float* partials, int B, int Cin, int Cout,
                                          int D, int H, int W, float slope, float eps,
                                          LnnDtype in_dtype, LnnDtype out_dtype,
                                          cudaStream_t stream);

// The 3x3x3 stride-1 SAME conv alone (no statistics, no normalization):
// x [B, Cin, D, H, W] and w [Cin, 27, Cout] of `in_dtype`, y [B, Cout, D, H, W]
// of `out_dtype`.  The fused op's data gradient runs through it.
cudaError_t lnn_conv3d_fwd(const void* x, const void* w, void* y, int B, int Cin,
                           int Cout, int D, int H, int W, LnnDtype in_dtype,
                           LnnDtype out_dtype, cudaStream_t stream);

// The tensor-core entry (bf16 x): elements of the packed weights, floats of
// the partial statistics and of the split-K workspace, for a call with
// `splits` splits of the input-channel chunks.
long long lnn_conv3d_tc_weight_len(int Cin, int Cout);
long long lnn_conv3d_tc_partials_len(int B, int Cout, int D, int H, int W, int splits);
long long lnn_conv3d_tc_workspace_len(int B, int Cout, int D, int H, int W, int splits);

// The same conv on the tensor cores (bf16 x bf16 -> f32): x [B, Cin, D, H,
// W] bf16; w packed [ceil(Cin / 16), 27, Cout_pad, 16] bf16 (Cout_pad =
// Cout rounded up to 32 when Cout <= 32, else to 64; zeros past Cin and
// Cout; with Cin 1, [1, 3, Cout_pad, 16]: tap kd, channel 3 kh + kw); y
// [B, Cout, D, H, W] of `out_dtype`.  With scale (and offset,
// partials) y is normalized: in place when out == y, else into out, with
// mean and inv kept when they are non-null; without, y is the raw conv.
// workspace: lnn_conv3d_tc_workspace_len floats (null when splits == 1).
cudaError_t lnn_conv3d_tc(const void* x, const void* w, const float* scale,
                          const float* offset, void* y, void* out, float* mean, float* inv,
                          float* partials, float* workspace, int B, int Cin, int Cout, int D,
                          int H, int W, int splits, float slope, float eps,
                          LnnDtype out_dtype, cudaStream_t stream);

// Non-causal flash attention forward, f32 FMA on the CUDA cores: the entry
// of f32 input.  q, k, v, o [BH, N, HD] f32, contiguous, HD 64 or 80;
// o = softmax(q k^T * scale) v; lse [BH, N] f32, the row log-sum-exp of the
// scaled logits, kept for the backward.
cudaError_t lnn_flash_attention_fwd(const float* q, const float* k, const float* v, float* o,
                                    float* lse, int BH, int N, int HD, float scale,
                                    cudaStream_t stream);

// Its backward from the forward's o and lse and the output gradient dout
// (all [BH, N, HD] f32): dq, dk, dv f32; delta: BH * N floats of scratch
// (rowsum(dout * o)).
cudaError_t lnn_flash_attention_bwd(const float* q, const float* k, const float* v,
                                    const float* o, const float* dout, const float* lse,
                                    float* delta, float* dq, float* dk, float* dv, int BH,
                                    int N, int HD, float scale, cudaStream_t stream);

// The same forward and backward on the tensor cores (bf16 x bf16 -> f32):
// every [BH, N, HD] array bf16 and 16-byte aligned, lse and delta as above.
cudaError_t lnn_flash_attention_tc_fwd(const void* q, const void* k, const void* v, void* o,
                                       float* lse, int BH, int N, int HD, float scale,
                                       cudaStream_t stream);
cudaError_t lnn_flash_attention_tc_bwd(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const float* lse,
                                       float* delta, void* dq, void* dk, void* dv, int BH,
                                       int N, int HD, float scale, cudaStream_t stream);

// Halo'd block pack: x [B, C, D, H, W] of `dtype` -> out [nb, C, bs+2, bs+2,
// bs+2], nb = B (D/bs) (H/bs) (W/bs) in row-major (b, d, h, w) block order,
// zeros where a window leaves the volume.  bs divides D, H and W.
cudaError_t lnn_pack_blocks(const void* x, void* out, int B, int C, int D, int H, int W,
                            int bs, LnnDtype dtype, cudaStream_t stream);

// Its inverse scatter: y [nb, C, s, s, s] -> out [B, C, nd s, nh s, nw s],
// nb = B nd nh nw in the same block order.
cudaError_t lnn_unpack_blocks(const void* y, void* out, int B, int C, int s, int nd, int nh,
                              int nw, LnnDtype dtype, cudaStream_t stream);

// 2x up-interleave of 4 K sources (K = 1 or 2), each [N, R, H, Wm] with
// batch stride sN elements and the rest contiguous, into out [N, R, 2, 2H,
// K Wm] contiguous: out[n, r, i, 2h + j, K w + k] = srcs[(2i + j) K + k][n,
// r, h, w].  N R H Wm < 2^31.
cudaError_t lnn_interleave_up2(const void* const* srcs, long long sN, void* out, int N,
                               long long R, int H, int Wm, int K, LnnDtype dtype,
                               cudaStream_t stream);

// Its inverse gather: x [N, R, 2, 2H, K Wm] -> the 4 K arrays dsts, laid out
// as the sources above.
cudaError_t lnn_deinterleave2(const void* x, void* const* dsts, long long sN, int N,
                              long long R, int H, int Wm, int K, LnnDtype dtype,
                              cudaStream_t stream);
