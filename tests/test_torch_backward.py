"""The port's backward of the two fused ops against the JAX package's VJPs:
``instance_norm_leaky`` (its Pallas ``_in_bwd``, run in interpret mode as
tests/test_pallas_instance_norm.py runs it, and its pure-jnp reference)
and ``conv3d_in_lrelu`` (its custom VJP ``_fused_bwd`` with the Pallas conv
in interpret mode at the lane-aligned shape of tests/test_pallas_conv3d.py,
and the XLA composition's autodiff at a shape the TPU kernel refuses).  On
the CPU the port's ``autograd.Function``s run the plain backward versions;
the CUDA kernels are compared with those on the card (marked ``cuda``,
skipped without one, and run by chip_smoke.py).  Inputs are f32; each
tolerance is stated where it is used."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import lifelong_nnunet_tpu.ops.pallas.conv3d as c3
from lifelong_nnunet_tpu.ops.pallas.instance_norm import (
    instance_norm_leaky as jax_instance_norm_leaky, reference_instance_norm_leaky)
from lifelong_nnunet_tpu_torch.models.unet import ConvNormAct
from lifelong_nnunet_tpu_torch.ops.kernels.conv3d import (
    TC_CHUNK, _dx_weight, conv3d_dx_cf, conv3d_in_lrelu, conv3d_in_lrelu_cf, plain_conv3d_dx,
    plain_conv3d_in_lrelu_bwd, plain_conv3d_in_lrelu_train, tc_n_tile, tc_weight)
from lifelong_nnunet_tpu_torch.ops.kernels import build
from lifelong_nnunet_tpu_torch.ops.kernels import instance_norm as inorm
from lifelong_nnunet_tpu_torch.ops.kernels.instance_norm import (
    H100, instance_norm_leaky, instance_norm_leaky_bwd_cf, instance_norm_leaky_cf,
    launch_plan, plain_instance_norm_leaky_bwd)

torch.set_num_threads(2)


@pytest.fixture()
def interpret_pallas(monkeypatch):
    real = c3.pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return real(*a, **k)

    monkeypatch.setattr(c3.pl, "pallas_call", patched)
    c3.conv3d_direct_cf._clear_cache()
    yield
    c3.conv3d_direct_cf._clear_cache()


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _t(a, grad=True):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


def _close(port, ref, rtol):
    """|port - ref| <= rtol * max|ref| (+ a floor of 1e-6): a gradient's
    error relative to its own scale."""
    ref = np.asarray(ref, np.float64)
    err = np.abs(np.asarray(port, np.float64) - ref).max()
    assert err <= rtol * np.abs(ref).max() + 1e-6, (err, np.abs(ref).max())


def _in_inputs(shape, seed):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    return ((rng.normal(size=shape) * 2 + 0.5).astype(np.float32),
            (rng.rand(c) + 0.5).astype(np.float32),
            rng.normal(size=c).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _port_in_grads(x, scale, bias, g):
    xs, ss, bs = _t(x), _t(scale), _t(bias)
    instance_norm_leaky(xs, ss, bs).backward(torch.from_numpy(g))
    return [t.grad.numpy() for t in (xs, ss, bs)]


@pytest.mark.parametrize("shape", [(2, 64, 16), (1, 300, 8)])
def test_instance_norm_bwd_matches_pallas_vjp(shape):
    """f32, 1e-5 of each gradient's scale: the same math in another
    summation order."""
    x, scale, bias, g = _in_inputs(shape, 0)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(jax_instance_norm_leaky, jnp.asarray(x), jnp.asarray(scale),
                         jnp.asarray(bias))
        ref = vjp(jnp.asarray(g))
    for port, r in zip(_port_in_grads(x, scale, bias, g), ref):
        _close(port, r, 1e-5)


@pytest.mark.parametrize("shape", [(2, 37, 5), (3, 9, 3)])
def test_instance_norm_bwd_matches_xla_grads_unaligned(shape):
    """Widths the TPU kernel does not tile: the pure-jnp reference's
    autodiff, 1e-5 of each gradient's scale."""
    x, scale, bias, g = _in_inputs(shape, 1)
    _, vjp = jax.vjp(reference_instance_norm_leaky, jnp.asarray(x), jnp.asarray(scale),
                     jnp.asarray(bias))
    for port, r in zip(_port_in_grads(x, scale, bias, g), vjp(jnp.asarray(g))):
        _close(port, r, 1e-5)


def test_plain_instance_norm_bwd_is_the_functions_cpu_route():
    """The Function's CPU backward is ``plain_instance_norm_leaky_bwd`` on
    the saved statistics; bit for bit."""
    x, scale, bias, g = _in_inputs((2, 4, 6, 5, 7), 2)
    x, g = np.moveaxis(x, -1, 1).copy(), np.moveaxis(g, -1, 1).copy()
    xs, ss, bs = _t(x), _t(scale), _t(bias)
    instance_norm_leaky_cf(xs, ss, bs).backward(torch.from_numpy(g))
    xf = torch.from_numpy(x)
    mean = xf.mean(dim=(2, 3, 4))
    rstd = torch.rsqrt(((xf - mean[..., None, None, None]) ** 2).mean(dim=(2, 3, 4)) + 1e-5)
    dx, dscale, dbias = plain_instance_norm_leaky_bwd(xf, ss.detach(), bs.detach(), mean,
                                                      rstd, torch.from_numpy(g))
    for got, want in ((xs.grad, dx), (ss.grad, dscale), (bs.grad, dbias)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)


def _conv_inputs(shape, cout, seed):
    rng = np.random.RandomState(seed)
    return ((rng.randn(*shape)).astype(np.float32),
            (rng.randn(3, 3, 3, shape[-1], cout) * 0.1).astype(np.float32),
            (rng.rand(cout) + 0.5).astype(np.float32),
            (rng.randn(cout) * 0.1).astype(np.float32),
            rng.randn(*shape[:-1], cout).astype(np.float32))


def _port_conv_grads(x, w, scale, off, g):
    ts = [_t(a) for a in (x, w, scale, off)]
    conv3d_in_lrelu(*ts).backward(torch.from_numpy(g))
    return [t.grad.numpy() for t in ts]


def test_conv_bwd_matches_pallas_vjp(interpret_pallas):
    """``_fused_bwd`` with dx through the Pallas conv (interpret mode) at
    the lane-aligned shape; f32, 1e-4 of each gradient's scale (the plain
    route's conv and the TPU kernel's sum in different orders)."""
    x, w, scale, off, g = _conv_inputs((1, 4, 8, 128, 8), 8, 1)
    assert c3.supported(x.shape, (3, 3, 3), (1, 1, 1))
    _, vjp = jax.vjp(lambda *a: c3.conv3d_in_lrelu(*a, out_dtype=jnp.float32),
                     *(jnp.asarray(a) for a in (x, w, scale, off)))
    for port, r in zip(_port_conv_grads(x, w, scale, off, g), vjp(jnp.asarray(g))):
        _close(port, r, 1e-4)


@pytest.mark.parametrize("shape,cout", [((2, 6, 10, 12, 3), 5), ((1, 5, 7, 9, 1), 4)])
def test_conv_bwd_matches_xla_grads_unaligned(shape, cout):
    """Widths the TPU kernel refuses: the JAX wrapper's XLA composition and
    its autodiff; f32, 1e-4 of each gradient's scale."""
    x, w, scale, off, g = _conv_inputs(shape, cout, 2)
    _, vjp = jax.vjp(c3.conv3d_in_lrelu, *(jnp.asarray(a) for a in (x, w, scale, off)))
    for port, r in zip(_port_conv_grads(x, w, scale, off, g), vjp(jnp.asarray(g))):
        _close(port, r, 1e-4)


def test_plain_conv_bwd_is_the_functions_cpu_route():
    """The Function's CPU backward is ``plain_conv3d_in_lrelu_bwd`` on the
    saved (ycf, mean, inv), bit for bit: the InstanceNorm backward's dy
    through ``plain_conv3d_dx``, its dscale / doffset as they are."""
    x, w, scale, off, g = _conv_inputs((2, 5, 6, 7, 3), 4, 3)
    xc = torch.from_numpy(np.moveaxis(x, -1, 1).copy())
    wc = torch.from_numpy(np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2)))
    gc = torch.from_numpy(np.moveaxis(g, -1, 1).copy())
    s, o = torch.from_numpy(scale), torch.from_numpy(off)
    ts = [t.clone().requires_grad_() for t in (xc, wc, s, o)]
    conv3d_in_lrelu_cf(*ts).backward(gc)
    _, ycf, mean, inv = plain_conv3d_in_lrelu_train(xc, wc, s, o)
    want = plain_conv3d_in_lrelu_bwd(xc, wc, s, o, ycf, mean, inv, gc)
    for t, ref in zip(ts, want):
        torch.testing.assert_close(t.grad, ref, atol=0, rtol=0)
    dy, dscale, doff = plain_instance_norm_leaky_bwd(ycf, s, o, mean, inv, gc)
    torch.testing.assert_close(plain_conv3d_dx(dy, wc), want[0], atol=0, rtol=0)
    torch.testing.assert_close(dscale, want[2], atol=0, rtol=0)
    torch.testing.assert_close(doff, want[3], atol=0, rtol=0)


def test_fused_block_gives_the_bias_a_zero_grad_and_skips_dx_for_the_data():
    """The conv bias, unused by the fused math, gets a zero gradient (not
    None, so the optimizer decays it as optax does); an input that needs no
    gradient (the data, at the first block) gets none computed."""
    block = ConvNormAct(2, 4, (3, 3, 3), (1, 1, 1))
    assert block.fused
    x = torch.randn(2, 2, 5, 6, 7)
    block(x).square().sum().backward()
    assert x.grad is None
    assert torch.equal(block.conv.bias.grad, torch.zeros(4))
    assert block.conv.weight.grad.abs().sum() > 0


def test_need_dx_false_returns_no_data_gradient():
    gen = torch.Generator().manual_seed(4)
    x, g = torch.randn(1, 2, 4, 5, 6, generator=gen), torch.randn(1, 3, 4, 5, 6, generator=gen)
    w = torch.randn(3, 2, 3, 3, 3, generator=gen) * 0.1
    s, o = torch.rand(3, generator=gen) + 0.5, torch.randn(3, generator=gen) * 0.1
    _, ycf, mean, inv = plain_conv3d_in_lrelu_train(x, w, s, o)
    dx, dw, _, _ = plain_conv3d_in_lrelu_bwd(x, w, s, o, ycf, mean, inv, g, need_dx=False)
    assert dx is None and dw.shape == w.shape


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-3), (torch.bfloat16, 5e-2)])
def test_backward_kernels_match_plain_on_cuda(cuda_device, dtype, atol):
    """The two backward kernels against their plain versions on the card:
    the InstanceNorm backward (atol 1e-3 f32 / 5e-2 bf16, rtol 1e-2) and
    the data-gradient conv (the same)."""
    torch.backends.cudnn.allow_tf32 = False
    before = (conv3d_dx_cf.launches, instance_norm_leaky_bwd_cf.launches)
    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device)

    for b, cin, cout, sp in [(2, 32, 32, (56, 80, 56)), (2, 512, 256, (7, 10, 7)),
                             (1, 7, 40, (5, 9, 13))]:
        w = r(cout, cin, 3, 3, 3) * (2.0 / (27 * cin)) ** 0.5
        dy = r(b, cout, *sp).to(dtype)
        torch.testing.assert_close(conv3d_dx_cf(dy, w).float(),
                                   plain_conv3d_dx(dy, w).float(), atol=atol, rtol=1e-2)
        x = (r(b, cout, *sp) * 2 + 0.5).to(dtype)
        s, o = r(cout) * 0.1 + 1, r(cout) * 0.1
        mean = x.float().mean(dim=(2, 3, 4))
        rstd = torch.rsqrt(x.float().var(dim=(2, 3, 4), unbiased=False) + 1e-5)
        out = instance_norm_leaky_bwd_cf(x, s, o, mean, rstd, dy)
        ref = plain_instance_norm_leaky_bwd(x, s, o, mean, rstd, dy)
        for a, e in zip(out, ref):
            torch.testing.assert_close(a.float(), e.float(), atol=atol, rtol=1e-2)
    assert (conv3d_dx_cf.launches, instance_norm_leaky_bwd_cf.launches) == (
        before[0] + 3, before[1] + 3)


@pytest.mark.parametrize("cin,cout", [(1, 32), (3, 5), (32, 64), (320, 320)])
def test_dx_tc_weight_flips_the_taps_and_swaps_the_channels(cin, cout):
    """The data gradient's packed weights: the conv of dy [B, Cout, ...]
    into Cin channels, tap t holding the forward's tap 26 - t; they unpack
    to the flipped, transposed bf16 weights."""
    w = torch.from_numpy(np.random.RandomState(cin).randn(cout, cin, 3, 3, 3)
                         .astype(np.float32))
    wp = tc_weight(_dx_weight(w))
    chunks, nt = -(-cout // TC_CHUNK), tc_n_tile(cin)
    assert wp.shape == (chunks, 27, -(-cin // nt) * nt, TC_CHUNK)
    wb = w.to(torch.bfloat16)
    for co, ci, tap in [(0, 0, 0), (cout - 1, cin - 1, 5), (cout // 2, cin // 2, 26)]:
        kd, kh, kw = tap // 9, tap // 3 % 3, tap % 3
        assert wp[co // TC_CHUNK, 26 - tap, ci, co % TC_CHUNK] == wb[co, ci, kd, kh, kw]
    unpacked = wp.permute(2, 0, 3, 1).reshape(wp.shape[2], chunks * TC_CHUNK, 3, 3, 3)
    assert torch.equal(unpacked[:cin, :cout], _dx_weight(wb))


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,cin,cout,sp", [
    (1, 7, 40, (5, 9, 13)),       # ragged: 40 -> 7 channels
    (2, 1, 32, (56, 80, 56)),     # into Cin 1
    (2, 3, 5, (6, 10, 12)),       # into Cin 3 from 5
    (2, 512, 256, (7, 10, 7)),    # 256 -> 512: Cout 512 of the dx conv
    (2, 320, 320, (7, 5, 7)),     # split K
    (2, 32, 64, (56, 80, 56))])   # 64 -> 32, no split
def test_dx_tc_kernel_matches_plain_on_cuda(cuda_device, b, cin, cout, sp, out_dtype):
    """bf16 dy on the tensor cores, bf16 or f32 dx, against the plain data
    gradient (atol 5e-2 + rtol 1e-2, as chip_smoke.py), counted on the
    tensor-core kernel; two launches equal bit for bit."""
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    w = torch.randn((cout, cin, 3, 3, 3), generator=gen, device=cuda_device) \
        * (2.0 / (27 * cin)) ** 0.5
    dy = torch.randn((b, cout) + sp, generator=gen, device=cuda_device).to(torch.bfloat16)
    before = (conv3d_dx_cf.launches, conv3d_dx_cf.tc_launches)
    dx = conv3d_dx_cf(dy, w, out_dtype)
    assert dx.dtype == out_dtype and dx.shape == (b, cin) + sp
    torch.testing.assert_close(dx.float(), plain_conv3d_dx(dy, w, out_dtype).float(),
                               atol=5e-2, rtol=1e-2)
    assert torch.equal(dx, conv3d_dx_cf(dy, w, out_dtype))
    assert (conv3d_dx_cf.launches, conv3d_dx_cf.tc_launches) == (before[0] + 2, before[1] + 2)


@pytest.mark.parametrize("shape,form", [((2, 320, 7, 5, 7), "warp"),
                                        ((2, 128, 14, 20, 14), "cluster"),
                                        ((2, 32, 128, 128, 128), "stream")])
@pytest.mark.parametrize("dx_dtype", [None, torch.float32])
def test_backward_wrapper_hands_the_plan_to_the_kernel(monkeypatch, shape, form, dx_dtype):
    """On a device tensor the backward wrapper launches once with the
    backward plan of its shape (x and g staged: half the forward's keep),
    dx in the asked dtype and dscale, dbias and the partials carved from one
    f32 buffer (meta tensors and a stand-in extension here), and counts the
    launch under its form."""
    calls = []
    ext = type("Ext", (), {"instance_norm_leaky_bwd": staticmethod(
        lambda *args: calls.append(args))})()
    monkeypatch.setattr(build, "require_cuda", lambda *ts: ts[0].device)
    monkeypatch.setattr(build, "load_extension", lambda: ext)
    monkeypatch.setattr(inorm, "card_limits", lambda device: H100)
    B, C = shape[:2]
    x = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    stats = torch.empty((B, C), device="meta")
    before = dict(instance_norm_leaky_bwd_cf.forms)
    dx, dscale, dbias = instance_norm_leaky_bwd_cf(
        x, torch.ones(C, device="meta"), torch.zeros(C, device="meta"), stats, stats, x,
        dx_dtype=dx_dtype)
    assert dx.shape == shape and dx.dtype == (dx_dtype or torch.bfloat16)
    assert dscale.shape == dbias.shape == (C,)
    plan = launch_plan(B, C, math.prod(shape[2:]), torch.bfloat16, backward=True)
    assert plan.form == form
    ((*tensors, alpha, form_id, cluster, slice_, keep, threads, vec),) = calls
    assert (form_id, cluster, slice_, keep, threads, vec) == plan.args() and alpha == 0.01
    work = tensors[-3:]                       # dscale, dbias, partials
    assert [t.numel() for t in work] == [C, C, 2 * B * C]
    assert instance_norm_leaky_bwd_cf.forms == {f: n + (f == form) for f, n in before.items()}


BWD_ROWS = [((3, 5, 7, 5, 7), "warp"), ((2, 7, 7, 10, 7), "warp"), ((2, 4, 8, 8, 8), "warp"),
            ((2, 3, 5, 9, 13), "cluster"), ((2, 3, 56, 80, 56), "cluster"),
            ((2, 64, 28, 40, 28), "stream"), ((1, 2, 128, 128, 128), "stream")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,dx_dtype", [(torch.float32, torch.float32),
                                            (torch.float32, torch.bfloat16),
                                            (torch.bfloat16, torch.float32),
                                            (torch.bfloat16, torch.bfloat16)],
                         ids=["f32-f32", "f32-bf16", "bf16-f32", "bf16-bf16"])
@pytest.mark.parametrize("shape,form", BWD_ROWS, ids=[f for _, f in BWD_ROWS])
def test_backward_forms_match_plain_on_cuda(cuda_device, shape, form, dtype, dx_dtype):
    """Each form of the backward kernel, in all four (x, dx) dtype pairs,
    against the plain version (dx in f32 atol 1e-4 + rtol 1e-4, in bf16
    atol 2e-2 + rtol 1e-2; dscale / dbias atol 1e-3 + rtol 1e-4), counted under the
    form its plan gives, and a second run equal bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = (torch.randn(shape, generator=gen, device=cuda_device) * 2 + 0.5).to(dtype)
    g = torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
    C = shape[1]
    s = torch.randn(C, generator=gen, device=cuda_device) * 0.1 + 1
    o = torch.randn(C, generator=gen, device=cuda_device) * 0.1
    axes = tuple(range(2, x.dim()))
    mean = x.float().mean(dim=axes)
    rstd = torch.rsqrt(x.float().var(dim=axes, unbiased=False) + 1e-5)
    args = (x, s, o, mean, rstd, g, 0.01, dx_dtype)
    plan = launch_plan(shape[0], shape[1], math.prod(shape[2:]), dtype, True,
                       limits=inorm.card_limits(x.device))
    assert plan.form == form or dtype == torch.float32   # the rows are picked in bf16
    before = instance_norm_leaky_bwd_cf.forms[plan.form]
    out = instance_norm_leaky_bwd_cf(*args)
    ref = plain_instance_norm_leaky_bwd(*args)
    assert out[0].dtype == dx_dtype
    atol, rtol = (1e-4, 1e-4) if dx_dtype == torch.float32 else (2e-2, 1e-2)
    torch.testing.assert_close(out[0].float(), ref[0].float(), atol=atol, rtol=rtol)
    for a, e in zip(out[1:], ref[1:]):
        torch.testing.assert_close(a, e, atol=1e-3, rtol=1e-4)
    again = instance_norm_leaky_bwd_cf(*args)
    assert all(torch.equal(a, b) for a, b in zip(again, out))
    assert instance_norm_leaky_bwd_cf.forms[plan.form] == before + 2
