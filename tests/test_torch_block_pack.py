"""The port's halo'd block pack / unpack and blocked conv
(lifelong_nnunet_tpu_torch/ops/kernels/block_pack.py) against the JAX
package's ``ops/pallas/block_pack.py``, its Pallas kernels run in interpret
mode (the fixture of tests/test_block_pack.py), on (2, 16, 16, 16) volumes
at block size 8, so every axis holds two blocks.  The JAX pack keeps
round8 junk rows for the TPU's lanes and is channels-last; the port's is
channels-first without them, so the JAX side is trimmed and transposed
before the comparison.  On the CPU the port's wrappers take their plain
versions; the CUDA kernels are compared with those bit for bit on the card
(marked ``cuda``, skipped without one, and run by chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lifelong_nnunet_tpu.ops.pallas.block_pack as bp
from lifelong_nnunet_tpu_torch.ops.kernels import block_pack as tbp

torch.set_num_threads(2)

BS = 8
SHAPE = (2, 16, 16, 16)          # B, D, H, W
GRID = (2, 2, 2)


@pytest.fixture()
def interpret_pallas(monkeypatch):
    real = bp.pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return real(*a, **k)

    monkeypatch.setattr(bp.pl, "pallas_call", patched)
    bp.pack_blocks._clear_cache()
    bp.unpack_blocks._clear_cache()
    yield
    bp.pack_blocks._clear_cache()
    bp.unpack_blocks._clear_cache()


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _cf(a) -> torch.Tensor:
    """channels-last numpy/jax array -> channels-first torch tensor"""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def _w_torch(w) -> torch.Tensor:
    """DHWIO -> [Cout, Cin, 3, 3, 3]"""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(w).transpose(4, 3, 0, 1, 2)))


def _inputs(cin, cout, seed=7):
    rng = np.random.RandomState(seed)
    x = rng.normal(size=SHAPE + (cin,)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, cin, cout)) * 0.2).astype(np.float32)
    scale = (rng.rand(cout) + 0.5).astype(np.float32)
    off = (rng.randn(cout) * 0.1).astype(np.float32)
    return x, w, scale, off


def test_pack_matches_jax(interpret_pallas):
    """Equal bit for bit once the JAX junk rows are trimmed: halos hold the
    neighbour's voxels inside the volume and zeros at its edge."""
    x, _, _, _ = _inputs(5, 6)
    ref = np.asarray(bp.pack_blocks(jnp.asarray(x), bs=BS))
    assert ref.shape == (16, BS + 2, 16, 16, 5)
    ref = np.moveaxis(ref[:, :, :BS + 2, :BS + 2], -1, 1)
    got = tbp.pack_blocks(_cf(x), BS)
    assert got.shape == (16, 5, BS + 2, BS + 2, BS + 2)
    np.testing.assert_array_equal(got.numpy(), ref)
    # the low face of the first window and the high face of the last are zero
    assert not got[0, :, 0].any() and not got[-1, :, :, :, -1].any()


@pytest.mark.parametrize("s", [BS, BS // 2], ids=["stride1", "stride2"])
def test_unpack_matches_jax(interpret_pallas, s):
    rng = np.random.RandomState(3)
    y = rng.normal(size=(16, s, s, s, 4)).astype(np.float32)
    ref = np.asarray(bp.unpack_blocks(jnp.asarray(y), SHAPE[0], GRID))
    got = tbp.unpack_blocks(_cf(y), SHAPE[0], GRID)
    assert got.shape == (SHAPE[0], 4) + tuple(n * s for n in GRID)
    np.testing.assert_array_equal(got.numpy(), np.moveaxis(ref, -1, 1))


def test_unpack_inverts_pack():
    """The windows' interiors scattered back give the volume again."""
    x = _cf(_inputs(3, 3)[0])
    packed = tbp.pack_blocks(x, BS)
    back = tbp.unpack_blocks(packed[:, :, 1:-1, 1:-1, 1:-1].contiguous(), SHAPE[0], GRID)
    assert torch.equal(back, x)


@pytest.mark.parametrize("stride", [1, 2])
def test_pack_conv_unpack_matches_jax(interpret_pallas, stride):
    """pack -> VALID conv -> unpack against the JAX ``_conv_blocked`` and the
    direct SAME conv; f32, atol 1e-5 (summation order)."""
    x, w, _, _ = _inputs(5, 6)
    ref = np.asarray(bp._conv_blocked(jnp.asarray(x), jnp.asarray(w), (stride,) * 3, BS))
    got = tbp._conv_blocked(_cf(x), _w_torch(w), stride, BS)
    np.testing.assert_allclose(got.numpy(), np.moveaxis(ref, -1, 1), atol=1e-5, rtol=1e-5)
    direct = torch.nn.functional.conv3d(_cf(x), _w_torch(w), stride=stride, padding=1)
    torch.testing.assert_close(got, direct, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("stride", [1, 2])
def test_packed_conv_in_lrelu_forward_and_vjp_match_jax(interpret_pallas, stride):
    """The output and the VJP of sum(out * g) (dx, dw, dscale, doffset)
    against the JAX custom VJP, f32: the output to atol 1e-4 + rtol 1e-4
    (two-pass against one-pass InstanceNorm statistics), each gradient to
    1e-4 of its scale; the unused conv bias gets a zero gradient."""
    x, w, scale, off = _inputs(5, 6)
    strides = (stride,) * 3
    g = np.random.RandomState(11).normal(
        size=(SHAPE[0],) + tuple(s // stride for s in SHAPE[1:]) + (6,)).astype(np.float32)

    def f(x_, w_, s_, o_):
        return bp.packed_conv_in_lrelu(x_, w_, s_, o_, bs=BS, strides=strides)

    ref, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (x, w, scale, off)))
    ref_grads = vjp(jnp.asarray(g))

    xt, wt = _cf(x).requires_grad_(), _w_torch(w).requires_grad_()
    st, ot = torch.from_numpy(scale).requires_grad_(), torch.from_numpy(off).requires_grad_()
    bias = torch.zeros(6, requires_grad=True)
    out = tbp.packed_conv_in_lrelu(xt, wt, st, ot, bs=BS, strides=strides, bias=bias)
    np.testing.assert_allclose(out.detach().numpy(), np.moveaxis(np.asarray(ref), -1, 1),
                               atol=1e-4, rtol=1e-4)
    (out * _cf(g)).sum().backward()
    want = (np.moveaxis(np.asarray(ref_grads[0]), -1, 1),
            np.asarray(ref_grads[1]).transpose(4, 3, 0, 1, 2),
            np.asarray(ref_grads[2]), np.asarray(ref_grads[3]))
    for name, t, r in zip(("dx", "dw", "dscale", "doffset"), (xt, wt, st, ot), want):
        err = np.abs(t.grad.numpy() - r).max()
        assert err <= 1e-4 * np.abs(r).max() + 1e-6, (name, err)
    assert not bias.grad.any()


@pytest.mark.parametrize("spatial", [(128, 128, 128), (64, 64, 64), (32, 32, 32),
                                     (56, 80, 56), (16, 24, 16), (8, 8, 8), (96, 64, 32)])
@pytest.mark.parametrize("batch,min_blocks,prefer", [
    (1, 1, (32, 16, 8)), (2, 16, (32, 16)), (1, 16, (32, 16)), (8, 16, (32, 16))])
def test_pick_bs_and_plan_match_jax(spatial, batch, min_blocks, prefer):
    """``plan`` and ``pick_bs`` as the JAX package's without its TPU lane
    rule (``channels=None``), at the gate's arguments and the defaults."""
    for bs in (32, 16, 8):
        assert tbp.plan(spatial, bs) == bp.plan(spatial, bs), bs
    assert tbp.pick_bs(spatial, prefer, batch, min_blocks) == bp.pick_bs(
        spatial, prefer, batch, min_blocks)


def test_wrappers_refuse_bad_shapes():
    with pytest.raises(ValueError, match="dividing"):
        tbp.pack_blocks(torch.zeros(1, 2, 12, 16, 16), 8)
    with pytest.raises(ValueError, match="unpack_blocks"):
        tbp.unpack_blocks(torch.zeros(7, 2, 8, 8, 8), 1, (2, 2, 2))
    with pytest.raises(ValueError, match="strides"):
        tbp.packed_conv_in_lrelu(torch.zeros(1, 2, 16, 16, 16), torch.zeros(3, 2, 3, 3, 3),
                                 torch.ones(3), torch.zeros(3), bs=8, strides=(1, 2, 2))
    x = torch.empty((1, 2, 16, 16, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tbp.pack_blocks(x, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_equal_plain_on_cuda(cuda_device, dtype):
    """Pack and unpack (after a stride-1 and a stride-2 conv) equal their
    plain versions bit for bit at block sizes 32, 16 and 8."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    before = (tbp.pack_blocks.launches, tbp.unpack_blocks.launches)
    cases = [(2, 32, (64, 64, 64), 32), (1, 3, (32, 48, 16), 16), (2, 5, (16, 16, 16), 8)]
    for b, c, sp, bs in cases:
        x = torch.randn((b, c) + sp, generator=g, device=cuda_device).to(dtype)
        packed = tbp.pack_blocks(x, bs)
        assert torch.equal(packed, tbp.plain_pack_blocks(x, bs))
        grid = tuple(s // bs for s in sp)
        for s in (bs, bs // 2):
            y = torch.randn((packed.shape[0], c, s, s, s), generator=g,
                            device=cuda_device).to(dtype)
            assert torch.equal(tbp.unpack_blocks(y, b, grid), tbp.plain_unpack_blocks(y, b, grid))
    assert (tbp.pack_blocks.launches, tbp.unpack_blocks.launches) == (
        before[0] + len(cases), before[1] + 2 * len(cases))
