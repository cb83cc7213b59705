// PyTorch binding of the port's kernels: the one source that includes
// torch/extension.h.  Each function takes tensors that the Python wrapper
// (ops/kernels/*.py) allocated and checked, checks again what the launcher
// relies on, launches on PyTorch's current stream and raises on a refused
// launch.  It never synchronizes and never allocates.
#include <torch/extension.h>

#include <array>
#include <cstdint>
#include <vector>

#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

#include "lnn_kernels.h"

namespace {

LnnDtype dtype_of(const torch::Tensor& t) {
  if (t.scalar_type() == torch::kFloat32) return LNN_F32;
  TORCH_CHECK(t.scalar_type() == torch::kBFloat16,
              "the kernels take float32 or bfloat16, got ", t.scalar_type());
  return LNN_BF16;
}

void check(const torch::Tensor& t, const torch::Tensor& like, const char* what) {
  TORCH_CHECK(t.is_cuda() && t.device() == like.device(), what,
              " must lie on the CUDA device of x");
  TORCH_CHECK(t.is_contiguous(), what, " must be contiguous");
}

void check_f32(const torch::Tensor& t, const torch::Tensor& like, int64_t n,
               const char* what) {
  check(t, like, what);
  TORCH_CHECK(t.scalar_type() == torch::kFloat32 && t.numel() == n, what,
              " must be float32 with ", n, " elements");
}

int as_int(int64_t v, const char* what) {
  TORCH_CHECK(v > 0 && v <= INT32_MAX, what, " out of range: ", v);
  return static_cast<int>(v);
}

// an InstanceNorm launch plan from the wrapper's ``LaunchPlan.args()``:
// (form, cluster, slice, keep, threads, vec); the launcher checks that it
// covers every row and raises through C10_CUDA_CHECK where it does not
LnnInPlan in_plan(int64_t form, int64_t cluster, int64_t slice, int64_t keep,
                  int64_t threads, int64_t vec) {
  TORCH_CHECK(form == LNN_IN_WARP || form == LNN_IN_CLUSTER, "unknown plan form ", form);
  return LnnInPlan{static_cast<int>(form), as_int(cluster, "cluster"), slice, keep,
                   as_int(threads, "threads"), static_cast<int>(vec != 0)};
}

// (SMs, dynamic shared memory a cluster-form block may take, largest
// cluster the card schedules with it) of the current device
std::vector<int64_t> instance_norm_limits() {
  int sms = 0, smem = 0, cluster = 0;
  C10_CUDA_CHECK(lnn_instance_norm_limits(&sms, &smem, &cluster));
  return {sms, smem, cluster};
}

// x, out: [B, C, *spatial]; scale, bias: [C] f32; mean, rstd: [B, C] f32.
void instance_norm_leaky_fwd(const torch::Tensor& x, const torch::Tensor& scale,
                             const torch::Tensor& bias, const torch::Tensor& out,
                             const torch::Tensor& mean, const torch::Tensor& rstd,
                             double alpha, double eps, int64_t form, int64_t cluster,
                             int64_t slice, int64_t keep, int64_t threads, int64_t vec) {
  check(x, x, "x");
  TORCH_CHECK(x.dim() >= 3, "x must be [B, C, *spatial]");
  const int B = as_int(x.size(0), "B"), C = as_int(x.size(1), "C");
  check(out, x, "out");
  TORCH_CHECK(out.sizes() == x.sizes() && out.scalar_type() == x.scalar_type(),
              "out must match x");
  check_f32(scale, x, C, "scale");
  check_f32(bias, x, C, "bias");
  check_f32(mean, x, int64_t(B) * C, "mean");
  check_f32(rstd, x, int64_t(B) * C, "rstd");
  const c10::cuda::CUDAGuard guard(x.device());
  C10_CUDA_CHECK(lnn_instance_norm_leaky_fwd(
      x.data_ptr(), scale.data_ptr<float>(), bias.data_ptr<float>(), out.data_ptr(),
      mean.data_ptr<float>(), rstd.data_ptr<float>(), B, C, x.numel() / (int64_t(B) * C),
      static_cast<float>(alpha), static_cast<float>(eps), dtype_of(x),
      in_plan(form, cluster, slice, keep, threads, vec),
      c10::cuda::getCurrentCUDAStream().stream()));
}

// x, g: [B, C, *spatial]; dx: same shape; scale, bias: [C] f32; mean, rstd:
// [B, C] f32; dscale, dbias: [C] f32; partials: 2 * B * C floats.
void instance_norm_leaky_bwd(const torch::Tensor& x, const torch::Tensor& g,
                             const torch::Tensor& scale, const torch::Tensor& bias,
                             const torch::Tensor& mean, const torch::Tensor& rstd,
                             const torch::Tensor& dx, const torch::Tensor& dscale,
                             const torch::Tensor& dbias, const torch::Tensor& partials,
                             double alpha, int64_t form, int64_t cluster, int64_t slice,
                             int64_t keep, int64_t threads, int64_t vec) {
  check(x, x, "x");
  TORCH_CHECK(x.dim() >= 3, "x must be [B, C, *spatial]");
  const int B = as_int(x.size(0), "B"), C = as_int(x.size(1), "C");
  check(g, x, "g");
  TORCH_CHECK(g.sizes() == x.sizes() && g.scalar_type() == x.scalar_type(),
              "g must match x");
  check(dx, x, "dx");
  TORCH_CHECK(dx.sizes() == x.sizes(), "dx must have x's shape");
  check_f32(scale, x, C, "scale");
  check_f32(bias, x, C, "bias");
  check_f32(mean, x, int64_t(B) * C, "mean");
  check_f32(rstd, x, int64_t(B) * C, "rstd");
  check_f32(dscale, x, C, "dscale");
  check_f32(dbias, x, C, "dbias");
  check_f32(partials, x, int64_t(2) * B * C, "partials");
  const c10::cuda::CUDAGuard guard(x.device());
  C10_CUDA_CHECK(lnn_instance_norm_leaky_bwd(
      x.data_ptr(), g.data_ptr(), scale.data_ptr<float>(), bias.data_ptr<float>(),
      mean.data_ptr<float>(), rstd.data_ptr<float>(), dx.data_ptr(),
      dscale.data_ptr<float>(), dbias.data_ptr<float>(), partials.data_ptr<float>(), B, C,
      x.numel() / (int64_t(B) * C), static_cast<float>(alpha), dtype_of(x), dtype_of(dx),
      in_plan(form, cluster, slice, keep, threads, vec),
      c10::cuda::getCurrentCUDAStream().stream()));
}

int64_t conv3d_partials_len(int64_t B, int64_t cout, int64_t D, int64_t H, int64_t W) {
  return lnn_conv3d_partials_len(as_int(B, "B"), as_int(cout, "Cout"), as_int(D, "D"),
                                 as_int(H, "H"), as_int(W, "W"));
}

// The dims of an FMA conv call: x [B, Cin, D, H, W] f32, w [Cin, 27, Cout]
// in x's dtype, y [B, Cout, D, H, W] (any of the two dtypes).
struct ConvDims {
  int B, cin, cout, D, H, W;
};

ConvDims check_conv(const torch::Tensor& x, const torch::Tensor& w,
                    const torch::Tensor& y) {
  check(x, x, "x");
  TORCH_CHECK(x.dim() == 5 && x.scalar_type() == torch::kFloat32,
              "x must be [B, Cin, D, H, W] float32 (bfloat16 takes conv3d_tc_fwd)");
  ConvDims d{as_int(x.size(0), "B"), as_int(x.size(1), "Cin"), 0,
             as_int(x.size(2), "D"), as_int(x.size(3), "H"), as_int(x.size(4), "W")};
  check(w, x, "w");
  TORCH_CHECK(w.dim() == 3 && w.size(0) == d.cin && w.size(1) == 27 &&
                  w.scalar_type() == x.scalar_type(),
              "w must be [Cin, 27, Cout] in x's dtype");
  d.cout = as_int(w.size(2), "Cout");
  check(y, x, "y");
  TORCH_CHECK(y.dim() == 5 && y.size(0) == d.B && y.size(1) == d.cout &&
                  y.size(2) == d.D && y.size(3) == d.H && y.size(4) == d.W,
              "y must be [B, Cout, D, H, W]");
  return d;
}

// scale, offset: [Cout] f32; y: [B, Cout, D, H, W]; partials:
// conv3d_partials_len floats.
void conv3d_in_lrelu_fwd(const torch::Tensor& x, const torch::Tensor& w,
                         const torch::Tensor& scale, const torch::Tensor& offset,
                         const torch::Tensor& y, const torch::Tensor& partials,
                         double slope, double eps) {
  const ConvDims d = check_conv(x, w, y);
  check_f32(scale, x, d.cout, "scale");
  check_f32(offset, x, d.cout, "offset");
  check_f32(partials, x, lnn_conv3d_partials_len(d.B, d.cout, d.D, d.H, d.W), "partials");
  const c10::cuda::CUDAGuard guard(x.device());
  C10_CUDA_CHECK(lnn_conv3d_in_lrelu_fwd(
      x.data_ptr(), w.data_ptr(), scale.data_ptr<float>(), offset.data_ptr<float>(),
      y.data_ptr(), partials.data_ptr<float>(), d.B, d.cin, d.cout, d.D, d.H, d.W,
      static_cast<float>(slope), static_cast<float>(eps), dtype_of(x), dtype_of(y),
      c10::cuda::getCurrentCUDAStream().stream()));
}

// As conv3d_in_lrelu_fwd, plus ycf (the raw conv output, out's shape and
// dtype) and mean, inv: [B, Cout] f32.
void conv3d_in_lrelu_train_fwd(const torch::Tensor& x, const torch::Tensor& w,
                               const torch::Tensor& scale, const torch::Tensor& offset,
                               const torch::Tensor& ycf, const torch::Tensor& out,
                               const torch::Tensor& mean, const torch::Tensor& inv,
                               const torch::Tensor& partials, double slope, double eps) {
  const ConvDims d = check_conv(x, w, ycf);
  check(out, x, "out");
  TORCH_CHECK(out.sizes() == ycf.sizes() && out.scalar_type() == ycf.scalar_type(),
              "out must match ycf");
  check_f32(scale, x, d.cout, "scale");
  check_f32(offset, x, d.cout, "offset");
  check_f32(mean, x, int64_t(d.B) * d.cout, "mean");
  check_f32(inv, x, int64_t(d.B) * d.cout, "inv");
  check_f32(partials, x, lnn_conv3d_partials_len(d.B, d.cout, d.D, d.H, d.W), "partials");
  const c10::cuda::CUDAGuard guard(x.device());
  C10_CUDA_CHECK(lnn_conv3d_in_lrelu_train_fwd(
      x.data_ptr(), w.data_ptr(), scale.data_ptr<float>(), offset.data_ptr<float>(),
      ycf.data_ptr(), out.data_ptr(), mean.data_ptr<float>(), inv.data_ptr<float>(),
      partials.data_ptr<float>(), d.B, d.cin, d.cout, d.D, d.H, d.W,
      static_cast<float>(slope), static_cast<float>(eps), dtype_of(x), dtype_of(ycf),
      c10::cuda::getCurrentCUDAStream().stream()));
}

// The conv alone: y = conv3d(x, w), 3x3x3, stride 1, SAME.
void conv3d_fwd(const torch::Tensor& x, const torch::Tensor& w, const torch::Tensor& y) {
  const ConvDims d = check_conv(x, w, y);
  const c10::cuda::CUDAGuard guard(x.device());
  C10_CUDA_CHECK(lnn_conv3d_fwd(x.data_ptr(), w.data_ptr(), y.data_ptr(), d.B, d.cin,
                                d.cout, d.D, d.H, d.W, dtype_of(x), dtype_of(y),
                                c10::cuda::getCurrentCUDAStream().stream()));
}

// The tensor-core conv: x [B, Cin, D, H, W] bf16, w the packed [chunks,
// 27, Cout_pad, 16] bf16, y [B, Cout, D, H, W] (either dtype), workspace
// conv3d_tc_workspace_len floats (any tensor when splits == 1).
ConvDims check_conv_tc(const torch::Tensor& x, const torch::Tensor& w, const torch::Tensor& y,
                       const torch::Tensor& workspace, int64_t splits) {
  check(x, x, "x");
  TORCH_CHECK(x.dim() == 5 && x.scalar_type() == torch::kBFloat16,
              "x must be [B, Cin, D, H, W] bfloat16 (float32 takes conv3d_fwd)");
  check(y, x, "y");
  TORCH_CHECK(y.dim() == 5 && y.size(0) == x.size(0) && y.size(2) == x.size(2) &&
                  y.size(3) == x.size(3) && y.size(4) == x.size(4),
              "y must be [B, Cout, D, H, W]");
  const ConvDims d{as_int(x.size(0), "B"), as_int(x.size(1), "Cin"), as_int(y.size(1), "Cout"),
                   as_int(x.size(2), "D"), as_int(x.size(3), "H"), as_int(x.size(4), "W")};
  check(w, x, "w");
  TORCH_CHECK(w.scalar_type() == torch::kBFloat16 &&
                  w.numel() == lnn_conv3d_tc_weight_len(d.cin, d.cout),
              "w must be the packed bfloat16 weights of ", d.cin, " -> ", d.cout, " channels");
  if (splits > 1)
    check_f32(workspace, x,
              lnn_conv3d_tc_workspace_len(d.B, d.cout, d.D, d.H, d.W, as_int(splits, "splits")),
              "workspace");
  return d;
}

float* ws_ptr(const torch::Tensor& workspace, int64_t splits) {
  return splits > 1 ? workspace.data_ptr<float>() : nullptr;
}

int64_t conv3d_tc_partials_len(int64_t B, int64_t cout, int64_t D, int64_t H, int64_t W,
                               int64_t splits) {
  return lnn_conv3d_tc_partials_len(as_int(B, "B"), as_int(cout, "Cout"), as_int(D, "D"),
                                    as_int(H, "H"), as_int(W, "W"), as_int(splits, "splits"));
}

int64_t conv3d_tc_workspace_len(int64_t B, int64_t cout, int64_t D, int64_t H, int64_t W,
                                int64_t splits) {
  return lnn_conv3d_tc_workspace_len(as_int(B, "B"), as_int(cout, "Cout"), as_int(D, "D"),
                                     as_int(H, "H"), as_int(W, "W"), as_int(splits, "splits"));
}

// The fused forward on the tensor cores, normalized in place into y.
void conv3d_tc_in_lrelu_fwd(const torch::Tensor& x, const torch::Tensor& w,
                            const torch::Tensor& scale, const torch::Tensor& offset,
                            const torch::Tensor& y, const torch::Tensor& partials,
                            const torch::Tensor& workspace, int64_t splits, double slope,
                            double eps) {
  const ConvDims d = check_conv_tc(x, w, y, workspace, splits);
  check_f32(scale, x, d.cout, "scale");
  check_f32(offset, x, d.cout, "offset");
  check_f32(partials, x, conv3d_tc_partials_len(d.B, d.cout, d.D, d.H, d.W, splits),
            "partials");
  const c10::cuda::CUDAGuard guard(x.device());
  C10_CUDA_CHECK(lnn_conv3d_tc(
      x.data_ptr(), w.data_ptr(), scale.data_ptr<float>(), offset.data_ptr<float>(),
      y.data_ptr(), y.data_ptr(), nullptr, nullptr, partials.data_ptr<float>(),
      ws_ptr(workspace, splits), d.B, d.cin, d.cout, d.D, d.H, d.W, static_cast<int>(splits),
      static_cast<float>(slope), static_cast<float>(eps), dtype_of(y),
      c10::cuda::getCurrentCUDAStream().stream()));
}

// The training forward on the tensor cores: ycf raw, out normalized, mean
// and inv [B, Cout] f32.
void conv3d_tc_in_lrelu_train_fwd(const torch::Tensor& x, const torch::Tensor& w,
                                  const torch::Tensor& scale, const torch::Tensor& offset,
                                  const torch::Tensor& ycf, const torch::Tensor& out,
                                  const torch::Tensor& mean, const torch::Tensor& inv,
                                  const torch::Tensor& partials,
                                  const torch::Tensor& workspace, int64_t splits,
                                  double slope, double eps) {
  const ConvDims d = check_conv_tc(x, w, ycf, workspace, splits);
  check(out, x, "out");
  TORCH_CHECK(out.sizes() == ycf.sizes() && out.scalar_type() == ycf.scalar_type(),
              "out must match ycf");
  check_f32(scale, x, d.cout, "scale");
  check_f32(offset, x, d.cout, "offset");
  check_f32(mean, x, int64_t(d.B) * d.cout, "mean");
  check_f32(inv, x, int64_t(d.B) * d.cout, "inv");
  check_f32(partials, x, conv3d_tc_partials_len(d.B, d.cout, d.D, d.H, d.W, splits),
            "partials");
  const c10::cuda::CUDAGuard guard(x.device());
  C10_CUDA_CHECK(lnn_conv3d_tc(
      x.data_ptr(), w.data_ptr(), scale.data_ptr<float>(), offset.data_ptr<float>(),
      ycf.data_ptr(), out.data_ptr(), mean.data_ptr<float>(), inv.data_ptr<float>(),
      partials.data_ptr<float>(), ws_ptr(workspace, splits), d.B, d.cin, d.cout, d.D, d.H,
      d.W, static_cast<int>(splits), static_cast<float>(slope), static_cast<float>(eps),
      dtype_of(ycf), c10::cuda::getCurrentCUDAStream().stream()));
}

// The conv alone on the tensor cores (the data gradient's).
void conv3d_tc_fwd(const torch::Tensor& x, const torch::Tensor& w, const torch::Tensor& y,
                   const torch::Tensor& workspace, int64_t splits) {
  const ConvDims d = check_conv_tc(x, w, y, workspace, splits);
  const c10::cuda::CUDAGuard guard(x.device());
  C10_CUDA_CHECK(lnn_conv3d_tc(x.data_ptr(), w.data_ptr(), nullptr, nullptr, y.data_ptr(),
                               nullptr, nullptr, nullptr, nullptr, ws_ptr(workspace, splits),
                               d.B, d.cin, d.cout, d.D, d.H, d.W, static_cast<int>(splits),
                               0.f, 0.f, dtype_of(y),
                               c10::cuda::getCurrentCUDAStream().stream()));
}

// t: on q's device, contiguous, q's shape and dtype; 16-byte aligned for
// the tensor-core kernels, which copy it 16 bytes at a time
void check_like(const torch::Tensor& t, const torch::Tensor& q, const char* what, bool tc) {
  check(t, q, what);
  TORCH_CHECK(t.sizes() == q.sizes() && t.scalar_type() == q.scalar_type(), what,
              " must have q's shape and dtype");
  TORCH_CHECK(!tc || reinterpret_cast<uintptr_t>(t.data_ptr()) % 16 == 0, what,
              " must be 16-byte aligned");
}

// The dims of an attention call: q [B, H, N, hd] of the entry's dtype
// (bf16 for the tensor-core kernels, f32 for the FMA kernels); returns
// {B * H, N, hd}.
std::array<int, 3> check_attention(const torch::Tensor& q, const torch::Tensor& lse, bool tc) {
  check_like(q, q, "q", tc);
  TORCH_CHECK(q.dim() == 4, "q must be [B, H, N, hd]");
  const auto want = tc ? torch::kBFloat16 : torch::kFloat32;
  TORCH_CHECK(q.scalar_type() == want, "this flash-attention entry takes ", want, ", got ",
              q.scalar_type());
  const int BH = as_int(q.size(0) * q.size(1), "B * H");
  const int N = as_int(q.size(2), "N"), hd = as_int(q.size(3), "hd");
  TORCH_CHECK(hd == 64 || hd == 80, "the flash-attention kernel takes head dim 64 or 80, got ",
              hd);
  check_f32(lse, q, int64_t(BH) * N, "lse");
  return {BH, N, hd};
}

// q, k, v, o: [B, H, N, hd] of one dtype; lse: [B, H, N] f32.
void flash_attention_fwd_entry(const torch::Tensor& q, const torch::Tensor& k,
                               const torch::Tensor& v, const torch::Tensor& o,
                               const torch::Tensor& lse, double scale, bool tc) {
  const auto d = check_attention(q, lse, tc);
  check_like(k, q, "k", tc);
  check_like(v, q, "v", tc);
  check_like(o, q, "o", tc);
  const c10::cuda::CUDAGuard guard(q.device());
  const auto stream = c10::cuda::getCurrentCUDAStream().stream();
  C10_CUDA_CHECK(tc ? lnn_flash_attention_tc_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                                 o.data_ptr(), lse.data_ptr<float>(), d[0],
                                                 d[1], d[2], static_cast<float>(scale), stream)
                    : lnn_flash_attention_fwd(q.data_ptr<float>(), k.data_ptr<float>(),
                                              v.data_ptr<float>(), o.data_ptr<float>(),
                                              lse.data_ptr<float>(), d[0], d[1], d[2],
                                              static_cast<float>(scale), stream));
}

// As the forward, plus dout, dq, dk, dv ([B, H, N, hd], q's dtype) and
// delta ([B, H, N] f32 scratch).
void flash_attention_bwd_entry(const torch::Tensor& q, const torch::Tensor& k,
                               const torch::Tensor& v, const torch::Tensor& o,
                               const torch::Tensor& dout, const torch::Tensor& lse,
                               const torch::Tensor& delta, const torch::Tensor& dq,
                               const torch::Tensor& dk, const torch::Tensor& dv, double scale,
                               bool tc) {
  const auto d = check_attention(q, lse, tc);
  check_like(k, q, "k", tc);
  check_like(v, q, "v", tc);
  check_like(o, q, "o", tc);
  check_like(dout, q, "dout", tc);
  check_like(dq, q, "dq", tc);
  check_like(dk, q, "dk", tc);
  check_like(dv, q, "dv", tc);
  check_f32(delta, q, int64_t(d[0]) * d[1], "delta");
  const c10::cuda::CUDAGuard guard(q.device());
  const auto stream = c10::cuda::getCurrentCUDAStream().stream();
  C10_CUDA_CHECK(
      tc ? lnn_flash_attention_tc_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                      dout.data_ptr(), lse.data_ptr<float>(),
                                      delta.data_ptr<float>(), dq.data_ptr(), dk.data_ptr(),
                                      dv.data_ptr(), d[0], d[1], d[2],
                                      static_cast<float>(scale), stream)
         : lnn_flash_attention_bwd(q.data_ptr<float>(), k.data_ptr<float>(),
                                   v.data_ptr<float>(), o.data_ptr<float>(),
                                   dout.data_ptr<float>(), lse.data_ptr<float>(),
                                   delta.data_ptr<float>(), dq.data_ptr<float>(),
                                   dk.data_ptr<float>(), dv.data_ptr<float>(), d[0], d[1], d[2],
                                   static_cast<float>(scale), stream));
}

void flash_attention_fwd(const torch::Tensor& q, const torch::Tensor& k,
                         const torch::Tensor& v, const torch::Tensor& o,
                         const torch::Tensor& lse, double scale) {
  flash_attention_fwd_entry(q, k, v, o, lse, scale, false);
}

void flash_attention_tc_fwd(const torch::Tensor& q, const torch::Tensor& k,
                            const torch::Tensor& v, const torch::Tensor& o,
                            const torch::Tensor& lse, double scale) {
  flash_attention_fwd_entry(q, k, v, o, lse, scale, true);
}

void flash_attention_bwd(const torch::Tensor& q, const torch::Tensor& k,
                         const torch::Tensor& v, const torch::Tensor& o,
                         const torch::Tensor& dout, const torch::Tensor& lse,
                         const torch::Tensor& delta, const torch::Tensor& dq,
                         const torch::Tensor& dk, const torch::Tensor& dv, double scale) {
  flash_attention_bwd_entry(q, k, v, o, dout, lse, delta, dq, dk, dv, scale, false);
}

void flash_attention_tc_bwd(const torch::Tensor& q, const torch::Tensor& k,
                            const torch::Tensor& v, const torch::Tensor& o,
                            const torch::Tensor& dout, const torch::Tensor& lse,
                            const torch::Tensor& delta, const torch::Tensor& dq,
                            const torch::Tensor& dk, const torch::Tensor& dv, double scale) {
  flash_attention_bwd_entry(q, k, v, o, dout, lse, delta, dq, dk, dv, scale, true);
}

// x: [B, C, D, H, W]; out: [nb, C, bs + 2, bs + 2, bs + 2] in x's dtype.
void pack_blocks(const torch::Tensor& x, const torch::Tensor& out, int64_t bs) {
  check(x, x, "x");
  TORCH_CHECK(x.dim() == 5, "x must be [B, C, D, H, W]");
  const int B = as_int(x.size(0), "B"), C = as_int(x.size(1), "C");
  const int D = as_int(x.size(2), "D"), H = as_int(x.size(3), "H"), W = as_int(x.size(4), "W");
  const int b = as_int(bs, "bs");
  TORCH_CHECK(D % b == 0 && H % b == 0 && W % b == 0, "bs ", b, " must divide D, H and W");
  check(out, x, "out");
  TORCH_CHECK(out.scalar_type() == x.scalar_type() && out.dim() == 5 &&
                  out.size(0) == int64_t(B) * (D / b) * (H / b) * (W / b) &&
                  out.size(1) == C && out.size(2) == b + 2 && out.size(3) == b + 2 &&
                  out.size(4) == b + 2,
              "out must be [nb, C, bs + 2, bs + 2, bs + 2] in x's dtype");
  const c10::cuda::CUDAGuard guard(x.device());
  C10_CUDA_CHECK(lnn_pack_blocks(x.data_ptr(), out.data_ptr(), B, C, D, H, W, b, dtype_of(x),
                                 c10::cuda::getCurrentCUDAStream().stream()));
}

// y: [nb, C, s, s, s]; out: [B, C, nd s, nh s, nw s] in y's dtype, nb = B nd nh nw.
void unpack_blocks(const torch::Tensor& y, const torch::Tensor& out) {
  check(y, y, "y");
  TORCH_CHECK(y.dim() == 5 && y.size(2) == y.size(3) && y.size(2) == y.size(4),
              "y must be [nb, C, s, s, s]");
  const int C = as_int(y.size(1), "C"), s = as_int(y.size(2), "s");
  check(out, y, "out");
  TORCH_CHECK(out.scalar_type() == y.scalar_type() && out.dim() == 5 && out.size(1) == C &&
                  out.size(2) % s == 0 && out.size(3) % s == 0 && out.size(4) % s == 0,
              "out must be [B, C, nd s, nh s, nw s] in y's dtype");
  const int B = as_int(out.size(0), "B"), nd = as_int(out.size(2) / s, "nd"),
            nh = as_int(out.size(3) / s, "nh"), nw = as_int(out.size(4) / s, "nw");
  TORCH_CHECK(y.size(0) == int64_t(B) * nd * nh * nw, "y holds ", y.size(0),
              " blocks, out's grid ", int64_t(B) * nd * nh * nw);
  const c10::cuda::CUDAGuard guard(y.device());
  C10_CUDA_CHECK(lnn_unpack_blocks(y.data_ptr(), out.data_ptr(), B, C, s, nd, nh, nw,
                                   dtype_of(y), c10::cuda::getCurrentCUDAStream().stream()));
}

// The 4 K separate arrays of an interleave, each [N, R, H, Wm] with the same
// strides (the batch stride free, the rest contiguous), and the interleaved
// one, [N, R, 2, 2H, K Wm] contiguous.  Returns {N, R, H, Wm, K, sN} and
// fills ptrs.
std::array<int64_t, 6> check_interleave(const std::vector<torch::Tensor>& parts,
                                        const torch::Tensor& dense, void** ptrs) {
  const int64_t K = int64_t(parts.size()) / 4;
  TORCH_CHECK(parts.size() == 4 || parts.size() == 8, "4 or 8 arrays, got ", parts.size());
  const torch::Tensor& a = parts[0];
  TORCH_CHECK(a.dim() == 4, "the arrays must be [N, R, H, Wm]");
  const int64_t N = a.size(0), R = a.size(1), H = a.size(2), Wm = a.size(3);
  for (size_t p = 0; p < parts.size(); ++p) {
    const torch::Tensor& t = parts[p];
    TORCH_CHECK(t.is_cuda() && t.device() == dense.device() &&
                    t.scalar_type() == dense.scalar_type() && t.sizes() == a.sizes() &&
                    t.strides() == a.strides(),
                "the arrays must share one shape, strides, dtype and the device");
    ptrs[p] = t.data_ptr();
  }
  TORCH_CHECK(a.stride(3) == 1 && a.stride(2) == Wm && a.stride(1) == H * Wm,
              "each array must be contiguous after its batch dim");
  check(dense, dense, "the interleaved array");
  TORCH_CHECK(dense.dim() == 5 && dense.size(0) == N && dense.size(1) == R &&
                  dense.size(2) == 2 && dense.size(3) == 2 * H && dense.size(4) == K * Wm,
              "the interleaved array must be [N, R, 2, 2H, K Wm]");
  TORCH_CHECK(K == 1 || reinterpret_cast<uintptr_t>(dense.data_ptr()) %
                                (2 * dense.element_size()) == 0,
              "the interleaved array must be aligned to an element pair");
  return {N, R, H, Wm, K, a.stride(0)};
}

void interleave_up2(const std::vector<torch::Tensor>& srcs, const torch::Tensor& out) {
  void* ptrs[8] = {};
  const auto d = check_interleave(srcs, out, ptrs);
  const c10::cuda::CUDAGuard guard(out.device());
  C10_CUDA_CHECK(lnn_interleave_up2(ptrs, d[5], out.data_ptr(), as_int(d[0], "N"), d[1],
                                    as_int(d[2], "H"), as_int(d[3], "Wm"), int(d[4]),
                                    dtype_of(out), c10::cuda::getCurrentCUDAStream().stream()));
}

void deinterleave2(const torch::Tensor& x, const std::vector<torch::Tensor>& dsts) {
  void* ptrs[8] = {};
  const auto d = check_interleave(dsts, x, ptrs);
  const c10::cuda::CUDAGuard guard(x.device());
  C10_CUDA_CHECK(lnn_deinterleave2(x.data_ptr(), ptrs, d[5], as_int(d[0], "N"), d[1],
                                   as_int(d[2], "H"), as_int(d[3], "Wm"), int(d[4]),
                                   dtype_of(x), c10::cuda::getCurrentCUDAStream().stream()));
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("flash_attention_fwd", &flash_attention_fwd,
        "non-causal flash attention forward, keeping the row log-sum-exp, f32 input "
        "(flash_attention.cu)");
  m.def("flash_attention_bwd", &flash_attention_bwd,
        "its backward: FlashAttention-2's recomputation from the log-sum-exp, f32 input");
  m.def("flash_attention_tc_fwd", &flash_attention_tc_fwd,
        "the flash-attention forward on the tensor cores, bf16 input (flash_attention.cu)");
  m.def("flash_attention_tc_bwd", &flash_attention_tc_bwd,
        "its backward on the tensor cores, bf16 input");
  m.def("instance_norm_leaky_fwd", &instance_norm_leaky_fwd,
        "InstanceNorm + LeakyReLU forward (instance_norm.cu)");
  m.def("instance_norm_leaky_bwd", &instance_norm_leaky_bwd,
        "InstanceNorm + LeakyReLU backward (instance_norm.cu)");
  m.def("instance_norm_limits", &instance_norm_limits,
        "(SMs, shared memory a block may take, largest cluster) for the InstanceNorm "
        "launch plan (instance_norm.cu)");
  m.def("conv3d_partials_len", &conv3d_partials_len,
        "floats of partial-statistics scratch for one conv3d_in_lrelu_fwd call");
  m.def("conv3d_in_lrelu_fwd", &conv3d_in_lrelu_fwd,
        "fused 3x3x3 conv + InstanceNorm + LeakyReLU forward (conv3d_in_lrelu.cu)");
  m.def("conv3d_in_lrelu_train_fwd", &conv3d_in_lrelu_train_fwd,
        "the fused forward keeping ycf, mean and inv for the backward");
  m.def("conv3d_fwd", &conv3d_fwd,
        "3x3x3 stride-1 SAME conv alone, the fused op's data gradient");
  m.def("conv3d_tc_partials_len", &conv3d_tc_partials_len,
        "floats of partial-statistics scratch for one tensor-core fused call");
  m.def("conv3d_tc_workspace_len", &conv3d_tc_workspace_len,
        "floats of split-K workspace for one tensor-core call (0 without a split)");
  m.def("conv3d_tc_in_lrelu_fwd", &conv3d_tc_in_lrelu_fwd,
        "the fused forward on the tensor cores, bf16 input (conv3d_in_lrelu.cu)");
  m.def("conv3d_tc_in_lrelu_train_fwd", &conv3d_tc_in_lrelu_train_fwd,
        "the tensor-core fused forward keeping ycf, mean and inv for the backward");
  m.def("conv3d_tc_fwd", &conv3d_tc_fwd,
        "the conv alone on the tensor cores, the data gradient of bf16 input");
  m.def("pack_blocks", &pack_blocks, "halo'd block pack (block_pack.cu)");
  m.def("unpack_blocks", &unpack_blocks, "its inverse scatter (block_pack.cu)");
  m.def("interleave_up2", &interleave_up2, "2x up-interleave (interleave.cu)");
  m.def("deinterleave2", &deinterleave2, "its inverse gather (interleave.cu)");
}
