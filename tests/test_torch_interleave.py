"""The port's 2x up-interleave, de-interleave, phase split and k=s=2
transposed conv (lifelong_nnunet_tpu_torch/ops/kernels/interleave.py)
against the JAX package's ``ops/pallas/interleave.py`` with
``interpret=True`` (as tests/test_pallas_interleave.py runs it), and the
upsample gate against ``ops/conv25d.upsample_eligible``.  The interleaves
are copies, so they are held equal bit for bit, gradients included; the
transposed conv to 1e-5 (the products' summation order).  The JAX arrays
are channels-last, the port's model tensors channels-first; the
interleave contract itself has no channel axis.  On the CPU the port's
wrappers take their plain versions; the CUDA kernels are compared with those
bit for bit on the card (marked ``cuda``, skipped without one, and run by
chip_smoke.py)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from lifelong_nnunet_tpu.ops.conv25d import upsample_eligible as jax_upsample_eligible
from lifelong_nnunet_tpu.ops.pallas import interleave as jil
from lifelong_nnunet_tpu_torch.ops.kernels import interleave as til

torch.set_num_threads(2)

SHAPES = [(3, 4, 16), (2, 8, 128), (5, 1, 7)]       # (ND, H, M)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _arrays(shape, n, seed):
    rng = np.random.RandomState(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("shape", SHAPES)
def test_interleave_up2_matches_jax(shape):
    a = _arrays(shape, 4, 0)
    ref = np.asarray(jil.interleave_up2(*map(jnp.asarray, a), True))
    got = til.interleave_up2(*map(torch.from_numpy, a))
    assert got.shape == (shape[0], 2, 2 * shape[1], shape[2])
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("shape", SHAPES)
def test_deinterleave2_matches_jax(shape):
    (x,) = _arrays((shape[0], 2, 2 * shape[1], shape[2]), 1, 1)
    ref = jil.deinterleave2(jnp.asarray(x), True)
    got = til.deinterleave2(torch.from_numpy(x))
    assert len(got) == 4
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert torch.equal(til.interleave_up2(*got), torch.from_numpy(x))


@pytest.mark.parametrize("shape", SHAPES)
def test_interleave_gradients_match_jax(shape):
    """Each kernel's backward is the other: the VJPs equal the JAX custom
    VJPs bit for bit."""
    a = _arrays(shape, 4, 2)
    (g,) = _arrays((shape[0], 2, 2 * shape[1], shape[2]), 1, 3)
    _, vjp = jax.vjp(lambda *t: jil.interleave_up2(*t, True), *map(jnp.asarray, a))
    ref = vjp(jnp.asarray(g))
    at = [torch.from_numpy(t).requires_grad_() for t in a]
    (til.interleave_up2(*at) * torch.from_numpy(g)).sum().backward()
    for t, r in zip(at, ref):
        np.testing.assert_array_equal(t.grad.numpy(), np.asarray(r))

    gs = _arrays(shape, 4, 4)
    _, vjp = jax.vjp(lambda x: jil.deinterleave2(x, True), jnp.asarray(g))
    (ref,) = vjp(tuple(map(jnp.asarray, gs)))
    xt = torch.from_numpy(g).requires_grad_()
    sum((p * torch.from_numpy(q)).sum() for p, q in zip(til.deinterleave2(xt), gs)).backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(ref))


def test_phase_split_dh_matches_jax():
    (x,) = _arrays((2, 4, 6, 3, 5), 1, 5)
    ref = jil.phase_split_dh(jnp.asarray(x), True)
    got = til.phase_split_dh(torch.from_numpy(x))
    for g, r in zip(got, ref):
        assert g.shape == (2, 2, 3, 3, 5)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    with pytest.raises(ValueError, match="even"):
        til.phase_split_dh(torch.zeros(1, 3, 4, 2, 2))


def _torch_weight(w):
    """The JAX transposed-conv kernel [2, 2, 2, Ci, Co] -> nn.ConvTranspose3d's
    [Ci, Co, 2, 2, 2] (taps flipped, as models/convert.py maps it)."""
    return torch.from_numpy(np.ascontiguousarray(w[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2)))


@pytest.mark.parametrize("shape,cout", [((2, 4, 8, 8, 6), 8), ((1, 3, 4, 16, 16), 8),
                                        ((2, 2, 3, 5, 4), 3)])
def test_conv_transpose3d_interleave_matches_jax(shape, cout):
    """Forward and gradients (x, w, bias) of the octant route against the
    JAX ``conv_transpose3d_matmul_pallas`` and ``F.conv_transpose3d``, f32,
    atol 1e-5 + rtol 1e-5 (the forward) and 1e-4 (the gradients)."""
    rng = np.random.RandomState(7)
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(size=(2, 2, 2, shape[-1], cout)).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)

    def jax_loss(x_, w_):
        return jnp.sum(jnp.square(jil.conv_transpose3d_matmul_pallas(x_, w_, True)))

    ref = np.asarray(jil.conv_transpose3d_matmul_pallas(jnp.asarray(x), jnp.asarray(w), True))
    rgx, rgw = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))

    xt = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))).requires_grad_()
    wt = _torch_weight(w).requires_grad_()
    out = til.conv_transpose3d_interleave(xt, wt)
    np.testing.assert_allclose(out.detach().numpy(), np.moveaxis(ref, -1, 1),
                               atol=1e-5, rtol=1e-5)
    out.square().sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.moveaxis(np.asarray(rgx), -1, 1),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(wt.grad.numpy(), _torch_weight(np.asarray(rgw)).numpy(),
                               atol=1e-4, rtol=1e-4)

    # with the bias, against the library's transposed conv
    bt = torch.from_numpy(b).requires_grad_()
    args = [t.detach().clone().requires_grad_() for t in (xt, wt, bt)]
    got = til.conv_transpose3d_interleave(xt, wt, bt)
    want = F.conv_transpose3d(*args, stride=2)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    g = torch.from_numpy(rng.normal(size=tuple(want.shape)).astype(np.float32))
    grads = torch.autograd.grad((got * g).sum(), (xt, wt, bt))
    for a, r in zip(grads, torch.autograd.grad((want * g).sum(), args)):
        torch.testing.assert_close(a, r, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("x_shape", [(2, 64, 64, 64, 64), (2, 128, 32, 32, 32),
                                     (2, 256, 16, 16, 16), (1, 128, 32, 32, 32),
                                     (1, 64, 64, 40, 64), (8, 320, 8, 8, 8),
                                     (64, 64, 64, 64, 64), (2, 32, 28, 40, 28)])
@pytest.mark.parametrize("kernel", [(2, 2, 2), (1, 2, 2)])
def test_upsample_eligible_matches_jax(x_shape, kernel):
    """The gate on a channels-first shape as the JAX gate on its
    channels-last transpose."""
    cl = (x_shape[0],) + tuple(x_shape[2:]) + (x_shape[1],)
    assert til.upsample_eligible(x_shape, kernel, kernel) == \
        jax_upsample_eligible(cl, kernel, kernel)
    assert not til.upsample_eligible(x_shape, kernel, (2, 2, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_equal_plain_on_cuda(cuda_device, dtype):
    """The K = 1 (JAX contract) and K = 2 (octant) forms of both kernels
    equal their plain versions bit for bit, and the octant route equals the
    library's transposed conv within its summation order."""
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)

    a = [randn(6, 5, 40) for _ in range(4)]
    x = til.interleave_up2(*a)
    assert torch.equal(x, til.plain_interleave([t[None] for t in a])[0])
    assert all(torch.equal(p, q) for p, q in zip(til.deinterleave2(x), a))
    y = randn(2, 8, 12, 6, 10)
    out = til._interleave(y.unbind(1))
    assert torch.equal(out, til.plain_interleave(y.unbind(1)))
    assert torch.equal(til._deinterleave(out, 2), y)
    xt, wt = randn(2, 16, 6, 6, 6), randn(16, 8, 2, 2, 2)
    torch.testing.assert_close(til.conv_transpose3d_interleave(xt, wt),
                               F.conv_transpose3d(xt, wt, stride=2), atol=2e-2, rtol=1e-2)
