"""The fused conv's weight gradient (``conv3d_weight_grad`` in
ops/kernels/conv3d.py; the tensor-core kernel in ops/csrc/conv3d_wgrad.cu).

On the CPU: the kernel's launch plan (``wgrad_plan``) at every fused-block
shape of the CT and hippocampus 3d_fullres plans and the lowres patch, at
batch 1, 2 and 64; the plan's split of the voxel boxes, emulated here in f32
(each split's boxes summed in order, the splits in split order), against
the plain weight gradient; the wrapper's route by input, on meta tensors
with a stand-in extension; a CPU tensor on the plain version.  On the card
(marked ``cuda``, skipped without one; the file imports no JAX): the kernel
against the plain version in f32, a second run bit for bit, the launch
counters and the kernel's own workspace sizes."""

import math

import numpy as np
import pytest
import torch

from lifelong_nnunet_tpu_torch.ops.kernels import build
from lifelong_nnunet_tpu_torch.ops.kernels.conv3d import (
    TC_SMS, WG_BOX, WG_CHUNK, conv3d_dx_cf, conv3d_in_lrelu_cf, conv3d_weight_grad,
    plain_conv3d_weight_grad, tc_n_tile, wgrad_plan)
from lifelong_nnunet_tpu_torch.tools.wgrad_probe import CT, unet_fused_shapes

torch.set_num_threads(2)

HIPPOCAMPUS = unet_fused_shapes((56, 80, 56), [(2, 2, 2)] * 3 + [(1, 2, 1)])
LOWRES = unet_fused_shapes((128, 160, 160), [(2, 2, 2)] * 5)
PLANS = {"CT": CT, "hippocampus": HIPPOCAMPUS, "lowres": LOWRES}


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _ceil(a, b):
    return -(-a // b)


def test_shape_lists_hold_the_plans_blocks():
    """17 fused blocks in the CT plan, 14 in the hippocampus plan, 17 on
    the lowres patch (its deep maps 8x10x10 and 4x5x5)."""
    assert (len(CT), len(HIPPOCAMPUS), len(LOWRES)) == (17, 14, 17)
    assert (1, 32, (128, 128, 128)) in CT and (640, 320, (8, 8, 8)) in CT
    assert (320, 320, (4, 5, 5)) in LOWRES and (640, 320, (8, 10, 10)) in LOWRES


@pytest.mark.parametrize("batch", [1, 2, 64])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_wgrad_plan_covers_every_box_once(name, batch):
    """At every fused shape: the boxes are the 4x8x8 boxes of every batch
    item; the splits' runs are consecutive, none empty, and cover each box
    exactly once, in split order (the order the reduce sums them); the
    blocks fit one wave of TC_SMS unless the channel tiles alone fill it;
    the workspace holds one [Cout, Cin, 27] partial a split; and a second
    call gives the same plan."""
    for cin, cout, sp in PLANS[name]:
        plan = wgrad_plan(batch, cin, cout, sp)
        assert plan == wgrad_plan(batch, cin, cout, sp)
        per_item = math.prod(_ceil(s, t) for s, t in zip(sp, WG_BOX))
        assert (plan.per_item, plan.boxes) == (per_item, batch * per_item)
        assert (plan.n_tile, plan.n_tiles, plan.chunks) == (
            tc_n_tile(cout), _ceil(cout, tc_n_tile(cout)), _ceil(cin, WG_CHUNK))
        runs = [plan.split_boxes(s) for s in range(plan.splits)]
        assert all(len(r) > 0 for r in runs)
        assert [b for r in runs for b in r] == list(range(plan.boxes))
        assert all(r.start == s * plan.per_split for s, r in enumerate(runs))
        base = plan.n_tiles * plan.chunks
        if base >= TC_SMS:
            assert plan.splits == 1
        else:   # one wave, each run as short as one wave allows
            assert plan.splits * base <= TC_SMS
            assert plan.per_split == _ceil(plan.boxes, min(plan.boxes, TC_SMS // base))
        assert plan.workspace_len(cin, cout) == (
            plan.splits * cout * cin * 27 if plan.splits > 1 else 0)


def test_wgrad_plan_at_the_ct_steps_largest_blocks():
    """The 128^3 blocks at batch 2: 16384 boxes, one wave of 132 blocks
    (the folded first conv: 132 runs of 125 boxes; 32 -> 32: two chunks,
    66 runs of 249); the 8^3 concat has 200 channel tiles and one run."""
    assert wgrad_plan(2, 1, 32, (128,) * 3)[-2:] == (132, 125)
    assert wgrad_plan(2, 32, 32, (128,) * 3)[-2:] == (66, 249)
    assert wgrad_plan(2, 640, 320, (8,) * 3).splits == 1


def _box_voxels(plan, box, sp):
    """(b, slices) of the output voxels of box ``box``."""
    b, tile = divmod(box, plan.per_item)
    nh, nw = (_ceil(s, t) for s, t in zip(sp[1:], WG_BOX[1:]))
    starts = (tile // (nh * nw) * WG_BOX[0], tile // nw % nh * WG_BOX[1], tile % nw * WG_BOX[2])
    return b, tuple(slice(s, s + t) for s, t in zip(starts, WG_BOX))


def wgrad_emulate(x, w, dy):
    """The kernel's order of summation on the CPU, in f32 on the bf16
    inputs: per split, its boxes' weight gradients (dy zero outside the
    box) summed in box order; the splits summed in split order."""
    B, cin, *sp = x.shape
    plan = wgrad_plan(B, cin, w.shape[0], sp)
    xf, dyf = x.float(), dy.float()
    total = None
    for s in range(plan.splits):
        part = None
        for box in plan.split_boxes(s):
            b, box_sl = _box_voxels(plan, box, sp)
            masked = torch.zeros_like(dyf[b:b + 1])
            masked[(slice(None), slice(None)) + box_sl] = dyf[(slice(b, b + 1), slice(None))
                                                             + box_sl]
            g = plain_conv3d_weight_grad(xf[b:b + 1], w, masked)
            part = g if part is None else part + g
        total = part if total is None else total + part
    return total


@pytest.mark.parametrize("b,cin,cout,sp", [
    (2, 3, 5, (6, 10, 12)),      # 16 boxes, 16 runs of one; ragged on every axis
    (1, 1, 32, (5, 9, 13)),      # one input channel (the fold), odd W
    (2, 2, 3, (12, 16, 96)),     # 144 boxes: 72 runs of two
])
def test_wgrad_split_sums_equal_the_plain_weight_gradient(b, cin, cout, sp):
    """The boxes of the plan's splits cover every output voxel once: their
    weight gradients, summed as the kernel sums them, equal the plain
    weight gradient in f32 (atol 1e-4 + rtol 1e-4: the sums run in another
    order), and the same order repeats bit for bit."""
    rng = np.random.RandomState(b * cin + cout)
    x = torch.from_numpy(rng.randn(b, cin, *sp).astype(np.float32)).to(torch.bfloat16)
    dy = torch.from_numpy(rng.randn(b, cout, *sp).astype(np.float32)).to(torch.bfloat16)
    w = torch.zeros(cout, cin, 3, 3, 3)
    got = wgrad_emulate(x, w, dy)
    torch.testing.assert_close(got, plain_conv3d_weight_grad(x.float(), w, dy.float()),
                               atol=1e-4, rtol=1e-4)
    assert torch.equal(got, wgrad_emulate(x, w, dy))


class _Entries:
    """A stand-in for the built extension: records the weight-gradient
    launches and their arguments."""

    def __init__(self):
        self.called = []

    def conv3d_wgrad_tc(self, x, dy, dw, ws, splits):
        self.called.append((tuple(x.shape), tuple(dy.shape), tuple(dw.shape), ws.numel(),
                            splits))


@pytest.fixture()
def entries(monkeypatch):
    ext = _Entries()
    monkeypatch.setattr(build, "require_cuda", lambda *ts: ts[0].device)
    monkeypatch.setattr(build, "load_extension", lambda: ext)
    return ext


@pytest.mark.parametrize("route", ["bf16", "f32", "stride2"])
def test_wrapper_routes_by_input(entries, route):
    """Off the CPU, bf16 at stride 1 launches the kernel with the plan's
    splits and workspace, counted in ``launches``; f32 input and stride 2
    take the library call, which counts nothing; neither moves the fused
    conv's or its data gradient's counters."""
    dtype = torch.float32 if route == "f32" else torch.bfloat16
    stride = 2 if route == "stride2" else 1
    x = torch.zeros(2, 40, 6, 10, 12, dtype=dtype, device="meta")
    dy = torch.zeros((2, 33) + tuple(_ceil(s, stride) for s in (6, 10, 12)), dtype=dtype,
                     device="meta")
    w = torch.zeros(33, 40, 3, 3, 3, device="meta")
    before = (conv3d_weight_grad.launches, conv3d_in_lrelu_cf.launches,
              conv3d_dx_cf.launches)
    dw = conv3d_weight_grad(x, w, dy, (stride,) * 3)
    assert dw.shape == w.shape and dw.dtype == w.dtype
    tc = route == "bf16"
    assert (conv3d_weight_grad.launches, conv3d_in_lrelu_cf.launches,
            conv3d_dx_cf.launches) == (before[0] + tc, before[1], before[2])
    if tc:
        plan = wgrad_plan(2, 40, 33, (6, 10, 12))
        assert entries.called == [(tuple(x.shape), tuple(dy.shape), (33, 40, 3, 3, 3),
                                   plan.workspace_len(40, 33), plan.splits)]
    else:
        assert entries.called == []


def test_wrapper_refuses_what_the_kernel_does_not_take(entries):
    """bf16 x with f32 dy, or dy of another shape, raises before a launch."""
    x = torch.zeros(2, 4, 6, 10, 12, dtype=torch.bfloat16, device="meta")
    w = torch.zeros(8, 4, 3, 3, 3, device="meta")
    for dy in (torch.zeros(2, 8, 6, 10, 12, device="meta"),
               torch.zeros(2, 8, 6, 10, 11, dtype=torch.bfloat16, device="meta")):
        with pytest.raises(ValueError):
            conv3d_weight_grad(x, w, dy)
    assert entries.called == []


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("stride", [1, 2])
def test_cpu_tensor_takes_the_plain_version(dtype, stride):
    """On the CPU the wrapper is the plain version, the library's weight
    gradient on f32 copies, returned in w's dtype, and counts nothing."""
    rng = np.random.RandomState(stride)
    x = torch.from_numpy(rng.randn(2, 3, 7, 8, 9).astype(np.float32)).to(dtype)
    out_sp = tuple(_ceil(s, stride) for s in (7, 8, 9))
    dy = torch.from_numpy(rng.randn(2, 4, *out_sp).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.randn(4, 3, 3, 3, 3).astype(np.float32))
    before = conv3d_weight_grad.launches
    dw = conv3d_weight_grad(x, w, dy, (stride,) * 3)
    want = torch.ops.aten.convolution_backward(
        dy.float(), x.float(), w, None, (stride,) * 3, (1, 1, 1), (1, 1, 1), False,
        (0, 0, 0), 1, (False, True, False))[1]
    assert dw.dtype == torch.float32 and torch.equal(dw, want)
    assert torch.equal(dw, plain_conv3d_weight_grad(x, w, dy, (stride,) * 3))
    assert conv3d_weight_grad.launches == before


# ---- on the card

def _inputs(dev, b, cin, cout, sp, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, cin) + tuple(sp), generator=g, device=dev).to(torch.bfloat16)
    dy = (torch.randn((b, cout) + tuple(sp), generator=g, device=dev) * 0.1).to(torch.bfloat16)
    w = torch.randn((cout, cin, 3, 3, 3), generator=g, device=dev)
    return x, w, dy


# (batch, Cin, Cout, spatial) beside the CT step's 17 at batch 2: ragged
# boxes on every axis with an odd W, the fold on a ragged volume, the lowres
# patch's anisotropic deep maps, Couts short of a tile, batch 64
EXTRA = [(1, 7, 40, (5, 9, 13)), (2, 1, 32, (6, 10, 12)), (2, 3, 5, (6, 10, 12)),
         (2, 320, 320, (4, 5, 5)), (2, 256, 256, (8, 10, 10)), (2, 40, 33, (9, 8, 17)),
         (64, 64, 64, (7, 10, 7)), (64, 1, 32, (28, 40, 28))]
CARD_CASES = [(2, cin, cout, sp) for cin, cout, sp in CT] + EXTRA
WGRAD_RTOL = 5e-4   # of max |plain|; see the test below


@pytest.mark.cuda
@pytest.mark.parametrize("b,cin,cout,sp", CARD_CASES)
def test_wgrad_kernel_matches_plain_on_cuda(cuda_device, b, cin, cout, sp):
    """bf16 x and dy on the kernel against the plain version in f32 (TF32
    off) on the same bf16 inputs: every product is exact in f32 on both
    sides, so they differ by the f32 sums alone.  The kernel adds each k16
    product into its accumulator on the tensor cores, up to ~8000 times a
    partial here (7952 at 64 -> 32 on 128^3), and those additions are not
    rounded to nearest, so the gap grows with that count: 1.45e-4 of max
    |plain| measured there on an H100, under 8000 x 2^-24 = 4.8e-4; held
    to 5e-4 max |plain|.  Each launch counted on the kernel, the fused
    conv's counters unmoved."""
    torch.backends.cudnn.allow_tf32 = False
    x, w, dy = _inputs(cuda_device, b, cin, cout, sp)
    before = (conv3d_weight_grad.launches, conv3d_in_lrelu_cf.launches,
              conv3d_dx_cf.launches)
    got = conv3d_weight_grad(x, w, dy)
    ref = plain_conv3d_weight_grad(x, w, dy)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    assert (got - ref).abs().max().item() <= WGRAD_RTOL * ref.abs().max().item()
    assert (conv3d_weight_grad.launches, conv3d_in_lrelu_cf.launches,
            conv3d_dx_cf.launches) == (before[0] + 1, before[1], before[2])


@pytest.mark.cuda
@pytest.mark.parametrize("b,cin,cout,sp", [(2, 32, 32, (128, 128, 128)),
                                           (2, 640, 320, (8, 8, 8)), (2, 1, 32, (5, 9, 13))])
def test_wgrad_kernel_repeats_bit_for_bit_on_cuda(cuda_device, b, cin, cout, sp):
    """Two launches on the same inputs are equal bit for bit, split or
    not: fixed-order sums, no atomics."""
    x, w, dy = _inputs(cuda_device, b, cin, cout, sp, seed=1)
    assert torch.equal(conv3d_weight_grad(x, w, dy), conv3d_weight_grad(x, w, dy))


@pytest.mark.cuda
def test_f32_and_stride2_take_the_library_on_cuda(cuda_device):
    """f32 input and stride 2 run the library's weight gradient, equal to
    the plain version, and count no launch."""
    x, w, dy = _inputs(cuda_device, 2, 16, 32, (8, 12, 16))
    before = conv3d_weight_grad.launches
    assert torch.equal(conv3d_weight_grad(x.float(), w, dy.float()),
                       plain_conv3d_weight_grad(x.float(), w, dy.float()))
    dy2 = dy[:, :, ::2, ::2, ::2].contiguous()
    assert torch.equal(conv3d_weight_grad(x, w, dy2, (2, 2, 2)),
                       plain_conv3d_weight_grad(x, w, dy2, (2, 2, 2)))
    assert conv3d_weight_grad.launches == before


@pytest.mark.cuda
def test_wgrad_workspace_matches_the_plan_on_cuda(cuda_device):
    """The kernel's own workspace size (``conv3d_wgrad_workspace_len``,
    which the wrapper allocates by the plan) at every shape of the three
    plans, at batch 1, 2 and 64."""
    ext = build.load_extension()
    for batch in (1, 2, 64):
        for cin, cout, sp in CT + HIPPOCAMPUS + LOWRES:
            plan = wgrad_plan(batch, cin, cout, sp)
            assert ext.conv3d_wgrad_workspace_len(batch, cin, cout, *sp, plan.splits) == \
                plan.workspace_len(cin, cout), (batch, cin, cout, sp)
