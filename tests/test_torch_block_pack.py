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

import itertools
import math

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


# (C, edge) of the CT routes' pack inputs at bs 32 (the CT U-Net's blocked
# convs and their data gradients), at the train batch 2 and the serving 64
MAIN_PACKS = [(1, 128), (32, 128), (64, 64), (64, 128)]
SMEM_227K = 227 * 1024


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [2, 64])
@pytest.mark.parametrize("C,edge", MAIN_PACKS)
def test_launch_plan_takes_tma_at_every_main_path_shape(C, edge, batch, dtype):
    """Every pack of the six main paths takes the TMA form, with a box the
    hardware takes (rows of 16-byte multiples from 16 bytes before the
    first of its windows along W, covering the last; no dimension past
    256), a
    block within 227 KB of shared memory keeping at least IN_FLIGHT bytes
    of loads in flight, slabs that cover the window on 16-byte boundaries
    of the output, and a persistent grid no larger than the items."""
    x_shape = (batch, C) + (edge,) * 3
    size = dtype.itemsize
    plan = tbp.launch_plan(x_shape, 32, dtype, 0)
    wb, S, sz, one = plan.box
    assert plan.form == "tma" and plan.args()[0] == 1 and (S, one) == (34, 1)
    a, nw = 16 // size, edge // 32
    assert nw % plan.gw == 0 and wb % a == 0
    assert a + 1 + 32 * plan.gw <= wb < 2 * a + 1 + 32 * plan.gw
    assert max(plan.box) <= 256 and plan.box_bytes == wb * S * sz * size
    assert plan.smem <= SMEM_227K
    assert plan.stages * plan.box_bytes >= tbp.IN_FLIGHT
    assert (plan.slabs - 1) * sz < S <= plan.slabs * sz
    for p0 in range(0, S, sz):
        assert p0 * S * S * size % 16 == 0 and (min(p0 + sz, S) - p0) * S * S * size % 16 == 0
    assert plan.items == batch * C * nw ** 2 * (nw // plan.gw) * plan.slabs
    assert 1 <= plan.blocks <= min(plan.items, 132 * (2048 // tbp.THREADS))


@pytest.mark.parametrize("x_shape,bs,dtype,offset", [
    ((1, 2, 15, 15, 15), 5, torch.float32, 0),      # rows of 60 bytes, odd bs
    ((1, 2, 36, 36, 36), 9, torch.float32, 0),      # odd bs: slabs off 16 bytes
    ((1, 2, 16, 16, 16), 8, torch.bfloat16, 1),     # x 2 bytes past 16
    ((2, 3, 32, 32, 32), 16, torch.float32, 3),     # x 12 bytes past 16
])
def test_launch_plan_takes_scalar_where_tma_rules_fail(x_shape, bs, dtype, offset):
    """The scalar form for a shape or an address the TMA form cannot take:
    rows not a multiple of 16 bytes, an odd window edge, an input at an odd
    storage offset; the same shape at an aligned address takes TMA where
    only the address failed."""
    x = torch.zeros(math.prod(x_shape) + offset, dtype=dtype)[offset:].view(x_shape)
    assert x.is_contiguous() and x.storage_offset() == offset
    plan = tbp.launch_plan(x.shape, bs, dtype, x.data_ptr())
    assert plan.form == "scalar" and plan.args()[0] == 0
    if offset:
        assert tbp.launch_plan(x.shape, bs, dtype, 0).form == "tma"


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [8, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_forms_equal_plain_on_cuda(cuda_device, dtype, bs):
    """Both forms of the pack equal the plain version bit for bit: C = 1 at
    B = 3 on a 3x3x3 grid of windows (every face, edge and corner, and one
    inside), a non-cubic grid (64 x 32 x 96 at bs 32, scaled with bs), an
    input made contiguous from a transposed view; the TMA form as planned
    (counted under ``forms``), with one-window boxes and with two-plane
    boxes (several slabs a window, the last box overlapping its
    neighbour), and the scalar form for an input off 16 bytes."""
    from lifelong_nnunet_tpu_torch.ops.kernels import build
    ext = build.load_extension()
    g = torch.Generator(device=cuda_device).manual_seed(0)
    sms = tbp.card_sms(cuda_device)

    def randn(shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)

    xs = [randn((3, 1) + (3 * bs,) * 3),
          randn((2, 4) + tuple(e * bs // 32 for e in (64, 32, 96))),
          randn((2, 3) + tuple(e * bs // 32 for e in (96, 64, 32))).transpose(2, 4)]
    for x in xs:
        ref = tbp.plain_pack_blocks(x, bs)
        before = dict(tbp.pack_blocks.forms)
        assert torch.equal(tbp.pack_blocks(x, bs), ref)
        assert tbp.pack_blocks.forms == {**before, "tma": before["tma"] + 1}
        xc = x.contiguous()
        plan = tbp.launch_plan(xc.shape, bs, dtype, xc.data_ptr(), sms)
        for gw, sz in ((1, plan.sz), (1, 2), (plan.gw, 2)):
            p = tbp.tma_plan(xc.shape, bs, dtype, sz, 2, 2, sms, gw)
            out = torch.full_like(ref, float("nan"))
            ext.pack_blocks(xc, out, bs, *p.args())
            torch.cuda.synchronize()
            assert torch.equal(out, ref), (tuple(x.shape), gw, sz)
        off = torch.empty(xc.numel() + 1, dtype=dtype, device=cuda_device)[1:].view(xc.shape)
        off.copy_(xc)
        assert tbp.launch_plan(off.shape, bs, dtype, off.data_ptr(), sms).form == "scalar"
        before = dict(tbp.pack_blocks.forms)
        assert torch.equal(tbp.pack_blocks(off, bs), ref)
        assert tbp.pack_blocks.forms == {**before, "scalar": before["scalar"] + 1}


@pytest.mark.cuda
def test_tma_layout_equals_the_kernels(cuda_device):
    """The wrapper's TMA layout (box row, box bytes, shared memory), from
    which the launch plan picks its ring, is the kernel's own
    (``lnn_pack_tma_layout``): at both element sizes, bs 8 / 16 / 32, one
    to eight windows a box, 1-34 planes and 1-16 stages."""
    from lifelong_nnunet_tpu_torch.ops.kernels import build
    ext = build.load_extension()
    for size, bs, gw, sz, stages in itertools.product((2, 4), (8, 16, 32), (1, 2, 4, 8),
                                                      (1, 2, 17, 34), (1, 4, 16)):
        want = tuple(ext.pack_tma_layout(bs, size, min(sz, bs + 2), gw, stages))
        assert tbp.tma_layout(bs, size, min(sz, bs + 2), gw, stages) == want, \
            (size, bs, gw, sz, stages)


@pytest.mark.parametrize("size,bs,gw,want_row", [
    (2, 32, 4, 144), (2, 32, 1, 48), (4, 32, 1, 40), (4, 16, 2, 40), (2, 8, 8, 80)])
def test_tma_layout_box_row(size, bs, gw, want_row):
    """A box row runs from 16 bytes before its first window's block column
    to its last window's far halo column, in whole 16 bytes; the ring's
    boxes sit on ALIGN bytes, with two 8-byte mbarriers a stage and ALIGN
    bytes of slack."""
    row, box, smem = tbp.tma_layout(bs, size, 2, gw, 3)
    a = 16 // size
    assert row == want_row and row % a == 0
    assert a - 1 + gw * bs + 2 <= row < 2 * a - 1 + gw * bs + 2
    assert box == row * (bs + 2) * 2 * size
    assert smem == 3 * (-(-box // tbp.ALIGN) * tbp.ALIGN) + 3 * 16 + tbp.ALIGN
