"""The port's fused conv3d + InstanceNorm + LeakyReLU
(ops/kernels/conv3d.py) against the JAX package's ``conv3d_in_lrelu``:
through its Pallas kernel in interpret mode at a lane-aligned shape (the
fixture of tests/test_pallas_conv3d.py), and through its XLA composition at
a shape the TPU kernel does not take.  On the CPU the port's wrapper takes
its plain PyTorch version; the CUDA kernel is compared with that plain
version on the card (marked ``cuda``, skipped without one, and run by
chip_smoke.py).  The tensor-core kernel's Python side (its packed weights,
its tile plan at every fused shape of the hippocampus and CT plans, and its
tile / split-K decomposition, emulated here) is checked on the CPU."""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import lifelong_nnunet_tpu.ops.pallas.conv3d as c3
from lifelong_nnunet_tpu_torch.ops.kernels import build
from lifelong_nnunet_tpu_torch.ops.kernels.conv3d import (
    TC_BOX, TC_CHUNK, TC_SMS, _dx_weight, _kernel_forward, conv3d_dx_cf, conv3d_in_lrelu,
    conv3d_in_lrelu_cf, plain_conv3d_dx, plain_conv3d_in_lrelu, plain_conv3d_in_lrelu_train,
    tc_n_tile, tc_splits, tc_weight)
from lifelong_nnunet_tpu_torch.tools.wgrad_probe import CT, unet_fused_shapes

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


def _inputs(shape, cout, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(3, 3, 3, shape[-1], cout) * 0.1).astype(np.float32)
    scale = (rng.rand(cout) + 0.5).astype(np.float32)
    off = (rng.randn(cout) * 0.1).astype(np.float32)
    return x, w, scale, off


def _xla_two_pass(x, w, scale, off, slope=0.01):
    y = jax.lax.conv_general_dilated(
        x, w, (1, 1, 1), "SAME", dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))
    mean = y.mean(axis=(1, 2, 3), keepdims=True)
    var = y.var(axis=(1, 2, 3), keepdims=True)
    z = (y - mean) * jax.lax.rsqrt(var + 1e-5) * scale + off
    return jnp.where(z >= 0, z, slope * z)


def _port(x, w, scale, off):
    return conv3d_in_lrelu(*(torch.from_numpy(a) for a in (x, w, scale, off))).numpy()


@pytest.mark.parametrize("cout", [8, 16])
def test_matches_pallas_kernel(interpret_pallas, cout):
    x, w, scale, off = _inputs((1, 4, 8, 128, 8), cout, 1)
    assert c3.supported(x.shape, (3, 3, 3), (1, 1, 1))
    ref = c3.conv3d_in_lrelu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
                             jnp.asarray(off), out_dtype=jnp.float32)
    out = _port(x, w, scale, off)
    assert out.shape == (1, 4, 8, 128, cout)
    np.testing.assert_allclose(out, np.asarray(ref), atol=2e-4)


@pytest.mark.parametrize("shape,cout", [((2, 6, 10, 12, 3), 5),
                                        ((1, 5, 7, 9, 1), 4)])
def test_matches_xla_composition_unaligned(shape, cout):
    """Widths the TPU kernel refuses: the JAX wrapper runs its XLA
    composition (one-pass variance), held here beside the two-pass form."""
    x, w, scale, off = _inputs(shape, cout, 2)
    args = [jnp.asarray(a) for a in (x, w, scale, off)]
    out = _port(x, w, scale, off)
    np.testing.assert_allclose(out, np.asarray(c3.conv3d_in_lrelu(*args)),
                               atol=2e-4)
    np.testing.assert_allclose(out, np.asarray(_xla_two_pass(*args)), atol=2e-4)


def test_channels_first_entry_matches_channels_last():
    x, w, scale, off = _inputs((2, 4, 6, 5, 3), 6, 3)
    t = [torch.from_numpy(a) for a in (x, w, scale, off)]
    cf = conv3d_in_lrelu_cf(t[0].permute(0, 4, 1, 2, 3), t[1].permute(4, 3, 0, 1, 2),
                            t[2], t[3])
    np.testing.assert_array_equal(cf.permute(0, 2, 3, 4, 1).numpy(),
                                  conv3d_in_lrelu(*t).numpy())


def test_non_cuda_device_raises():
    x = torch.empty((1, 2, 4, 4, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        conv3d_in_lrelu_cf(x, torch.empty((3, 2, 3, 3, 3), device="meta"),
                           torch.ones(3, device="meta"),
                           torch.zeros(3, device="meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-3),
                                        (torch.bfloat16, 5e-2)])
def test_kernel_matches_plain_on_cuda(cuda_device, dtype, atol):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    before = conv3d_in_lrelu_cf.launches
    g = torch.Generator(device=cuda_device).manual_seed(0)
    cases = [(2, 3, 5, (6, 10, 12)), (2, 1, 32, (56, 80, 56)),
             (2, 512, 256, (7, 10, 7)), (1, 7, 40, (5, 9, 13))]
    for b, cin, cout, sp in cases:
        x = torch.randn((b, cin) + sp, generator=g, device=cuda_device).to(dtype)
        w = torch.randn((cout, cin, 3, 3, 3), generator=g,
                        device=cuda_device) * (2.0 / (27 * cin)) ** 0.5
        s = torch.rand(cout, generator=g, device=cuda_device) + 0.5
        o = torch.randn(cout, generator=g, device=cuda_device) * 0.1
        out = conv3d_in_lrelu_cf(x, w, s, o)
        ref = plain_conv3d_in_lrelu(x, w, s, o)
        torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=1e-2)
    assert conv3d_in_lrelu_cf.launches == before + len(cases)


# ---- the tensor-core kernel (bf16 input)

HIPPOCAMPUS = unet_fused_shapes((56, 80, 56), [(2, 2, 2)] * 3 + [(1, 2, 1)])


def test_fused_shape_lists_match_the_plans():
    """14 fused convs at hippocampus scale (chip_smoke.py counts 14 per
    forward), 17 on the ordinary CT route; the decoder's first block
    takes the 512-channel concat at 7x10x7."""
    assert len(HIPPOCAMPUS) == 14 and len(CT) == 17
    assert (512, 256, (7, 10, 7)) in HIPPOCAMPUS and (320, 320, (7, 5, 7)) in HIPPOCAMPUS
    assert (640, 320, (8, 8, 8)) in CT and (320, 320, (4, 4, 4)) in CT


def _ceil(a, b):
    return -(-a // b)


class TcPlan:
    """What the tensor-core kernel launches for one conv with the wrapper's
    split (conv3d_in_lrelu.cu, ``tc::launch`` and the ``*_len`` functions):
    ``n_tile`` output channels a block, ``m_tiles`` voxel boxes per batch
    item, ``n_tiles`` channel tiles, ``chunks`` input-channel chunks,
    ``splits`` blocks over those chunks (``per_split`` each), the grid, and
    the floats of its partials (one (sum, sum of squares) per (b, channel,
    box), or per (b, channel) after a split, then mean and inv per (b,
    channel)) and of its split-K workspace."""

    def __init__(self, batch, cin, cout, sp):
        self.n_tile = tc_n_tile(cout)
        self.m_tiles = math.prod(_ceil(s, t) for s, t in zip(sp, TC_BOX))
        self.n_tiles = _ceil(cout, self.n_tile)
        self.chunks = _ceil(cin, TC_CHUNK)
        self.splits = tc_splits(batch, cin, cout, sp)
        self.per_split = _ceil(self.chunks, self.splits)
        self.grid = (self.m_tiles, self.n_tiles, batch * self.splits)
        self.partials_per_row = 1 if self.splits > 1 else self.m_tiles
        self.partials_len = batch * cout * (self.partials_per_row + 1) * 2
        self.workspace_len = (self.splits * batch * cout * math.prod(sp)
                              if self.splits > 1 else 0)


def tc_unpack_weight(wp, cin, cout):
    """The inverse of :func:`tc_weight`: ``[Cout, Cin, 3, 3, 3]`` bf16."""
    chunks, taps, cout_pad, _ = wp.shape
    if taps == 3:
        return wp[0, :, :cout, :9].permute(1, 0, 2).reshape(cout, 1, 3, 3, 3)
    return wp.permute(2, 0, 3, 1).reshape(cout_pad, chunks * TC_CHUNK, 3, 3, 3)[:cout, :cin]


@pytest.mark.parametrize("batch", [1, 2, 64])
@pytest.mark.parametrize("entry", ["fused", "dx"])
@pytest.mark.parametrize("name,shapes", [("hippocampus", HIPPOCAMPUS), ("CT", CT)])
def test_tc_plan_gives_the_grid_and_partials_the_kernel_expects(name, shapes, entry, batch):
    """At every fused shape (and its data gradient, Cin / Cout swapped):
    the split is a pure function of the shape, the splits fill the SMs
    without an empty one and only where the grid would not, the grid covers
    every voxel box and channel tile, and the partials hold one (sum, sum of
    squares) per (b, channel, box), or per (b, channel) after a split, plus
    the finish's mean and inv."""
    for cin, cout, sp in shapes:
        if entry == "dx":
            cin, cout = cout, cin
        plan = TcPlan(batch, cin, cout, sp)
        assert plan.splits == tc_splits(batch, cin, cout, sp)
        m_tiles = _ceil(sp[0], 4) * _ceil(sp[1], 8) * _ceil(sp[2], 8)
        n_tile = 32 if cout <= 32 else 64
        chunks = _ceil(cin, TC_CHUNK)
        assert (plan.m_tiles, plan.n_tile, plan.n_tiles, plan.chunks) == (
            m_tiles, n_tile, _ceil(cout, n_tile), chunks)
        assert plan.grid == (m_tiles, plan.n_tiles, batch * plan.splits)
        blocks = batch * m_tiles * plan.n_tiles
        assert 1 <= plan.splits <= chunks
        assert (plan.splits - 1) * plan.per_split < chunks <= plan.splits * plan.per_split
        if blocks >= TC_SMS:
            assert plan.splits == 1
        elif chunks > 1:
            assert plan.splits > 1
        per_row = 1 if plan.splits > 1 else m_tiles
        assert plan.partials_len == batch * cout * (per_row + 1) * 2
        assert plan.workspace_len == (
            plan.splits * batch * cout * math.prod(sp) if plan.splits > 1 else 0)


def test_tc_plan_splits_the_deep_stages_at_the_train_batch():
    """At batch 2 the 7x5x7 bottleneck (20 blocks), the 512-channel concat
    at 7x10x7 (32 blocks) and the CT plan's 4x4x4 bottleneck (10 blocks)
    split; the 56x80x56 stage does not."""
    assert tc_splits(2, 320, 320, (7, 5, 7)) == 7
    assert tc_splits(2, 512, 256, (7, 10, 7)) == 5
    assert tc_splits(2, 32, 32, (56, 80, 56)) == 1
    assert tc_splits(64, 320, 320, (7, 5, 7)) == 1
    assert tc_splits(2, 320, 320, (4, 4, 4)) == 10


@pytest.mark.parametrize("cin,cout", [(1, 32), (3, 5), (32, 64), (40, 33), (512, 256)])
def test_tc_weight_packs_and_round_trips(cin, cout):
    """[Cout, Cin, 3, 3, 3] -> [chunks, 27, Cout_pad, 16] bf16, tap 9 kd +
    3 kh + kw, zeros past Cin and Cout; with one input channel [1, 3,
    Cout_pad, 16], tap kd, channel 3 kh + kw, zeros past 9; unpacking gives
    the bf16 weights back."""
    w = torch.from_numpy(np.random.RandomState(cin + cout).randn(cout, cin, 3, 3, 3)
                         .astype(np.float32))
    wp = tc_weight(w)
    plan = TcPlan(1, cin, cout, (1, 1, 1))
    taps = 3 if cin == 1 else 27
    assert wp.dtype == torch.bfloat16 and wp.is_contiguous()
    assert wp.shape == (plan.chunks, taps, plan.n_tiles * plan.n_tile, TC_CHUNK)
    wb = w.to(torch.bfloat16)
    for co, ci, kd, kh, kw in [(0, 0, 0, 0, 0), (cout - 1, cin - 1, 2, 1, 0),
                               (cout // 2, cin // 3, 1, 2, 2)]:
        packed = wp[0, kd, co, 3 * kh + kw] if cin == 1 else \
            wp[ci // TC_CHUNK, 9 * kd + 3 * kh + kw, co, ci % TC_CHUNK]
        assert packed == wb[co, ci, kd, kh, kw]
    if cin == 1:
        assert not wp[:, :, cout:].any() and not wp[..., 9:].any()
    else:
        full = wp.permute(2, 0, 3, 1).reshape(wp.shape[2], -1, 27)
        assert not full[cout:].any() and not full[:, cin:].any()
    assert torch.equal(tc_unpack_weight(wp, cin, cout), wb)


def tc_emulate(x, w, scale=None, offset=None, slope=0.01, eps=1e-5):
    """The tensor-core kernel's decomposition on the CPU, in f32 on the
    bf16 inputs: per split, its chunks' convs (on the packed weights,
    unpacked) summed in chunk order; the splits summed in split order;
    (sum, sum of squares) partials per voxel box (zeros past the volume,
    as the kernel masks those rows) or per row after a split; then the
    finish.  Returns y, or (out, y, mean, inv) with scale and offset."""
    B, cin, D, H, W = x.shape
    cout = w.shape[0]
    plan = TcPlan(B, cin, cout, (D, H, W))
    pad = plan.chunks * TC_CHUNK - cin
    xp = F.pad(x.to(torch.bfloat16).float(), (0, 0, 0, 0, 0, 0, 0, pad))
    wu = F.pad(tc_unpack_weight(tc_weight(w), cin, cout).float(),
               (0, 0, 0, 0, 0, 0, 0, pad))
    y = None
    for s in range(plan.splits):
        part = 0
        for c in range(s * plan.per_split, min(plan.chunks, (s + 1) * plan.per_split)):
            ks = slice(c * TC_CHUNK, (c + 1) * TC_CHUNK)
            part = part + F.conv3d(xp[:, ks], wu[:, ks], padding=1)
        y = part if y is None else y + part
    if scale is None:
        return y
    if plan.splits > 1:
        rows = y.reshape(B, cout, 1, -1)
    else:
        nb = [_ceil(n, t) for n, t in zip((D, H, W), TC_BOX)]
        yp = F.pad(y, (0, nb[2] * TC_BOX[2] - W, 0, nb[1] * TC_BOX[1] - H,
                       0, nb[0] * TC_BOX[0] - D))
        rows = yp.reshape(B, cout, nb[0], TC_BOX[0], nb[1], TC_BOX[1], nb[2], TC_BOX[2]) \
            .permute(0, 1, 2, 4, 6, 3, 5, 7).reshape(B, cout, plan.m_tiles, -1)
    partials = torch.stack([rows.sum(-1), rows.square().sum(-1)], -1)
    assert partials.shape == (B, cout, plan.partials_per_row, 2)
    assert partials.numel() + 2 * B * cout == plan.partials_len
    total = partials.sum(2)
    n = float(D * H * W)
    mean = total[..., 0] / n
    inv = torch.rsqrt(torch.clamp(total[..., 1] / n - mean.square(), min=0.0) + eps)
    mul, sub = inv * scale, mean * inv * scale - offset
    z = y * mul[..., None, None, None] - sub[..., None, None, None]
    return torch.where(z >= 0, z, slope * z), y, mean, inv


@pytest.mark.parametrize("b,cin,cout,sp", [
    (2, 1, 32, (6, 10, 12)),       # one input channel: the folded taps
    (2, 3, 5, (6, 10, 12)),        # one chunk, ragged boxes
    (1, 40, 33, (5, 9, 13)),       # 3 chunks over 3 splits, Cout 33 in a tile of 64
    (2, 20, 70, (9, 8, 17)),       # 2 chunks over 2 splits, Cout 70 in tiles of 64
    (2, 24, 8, (16, 24, 48)),      # 144 blocks: 2 chunks, no split
])
def test_tc_decomposition_equals_the_plain_conv_and_statistics(b, cin, cout, sp):
    """The emulated tile / split-K decomposition on the CPU equals
    F.conv3d and the plain statistics on the same bf16 inputs (f32, atol
    1e-4 + rtol 1e-4: the sums run in another order); the conv-only
    decomposition (the data gradient's, on flipped taps) equals the plain
    data gradient."""
    rng = np.random.RandomState(b * cin + cout)
    x = torch.from_numpy(rng.randn(b, cin, *sp).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.randn(cout, cin, 3, 3, 3) * 0.2).astype(np.float32))
    scale = torch.from_numpy((rng.rand(cout) + 0.5).astype(np.float32))
    off = torch.from_numpy((rng.randn(cout) * 0.1).astype(np.float32))
    plan = TcPlan(b, cin, cout, sp)
    assert plan.splits == (1 if math.prod(plan.grid) >= TC_SMS else plan.chunks)
    got = tc_emulate(x, w, scale, off)
    want = plain_conv3d_in_lrelu_train(x.float(), w.to(torch.bfloat16).float(), scale, off)
    for g, e in zip(got, want):
        torch.testing.assert_close(g, e, atol=1e-4, rtol=1e-4)
    dy = torch.from_numpy(rng.randn(b, cout, *sp).astype(np.float32)).to(torch.bfloat16)
    torch.testing.assert_close(tc_emulate(dy, _dx_weight(w)),
                               plain_conv3d_dx(dy.float(), w.to(torch.bfloat16).float()),
                               atol=1e-4, rtol=1e-4)


TC_CASES = [(1, 7, 40, (5, 9, 13)),      # ragged on every axis, Cout 40 of a tile of 64
            (2, 1, 32, (56, 80, 56)),    # Cin 1: the first conv
            (2, 3, 5, (6, 10, 12)),      # Cin 3, Cout 5
            (2, 512, 256, (7, 10, 7)),   # Cin 512, split K (5 splits)
            (2, 320, 320, (7, 5, 7)),    # the bottleneck, split K (7 splits)
            (2, 320, 320, (4, 4, 4)),    # the CT bottleneck, split K (10 splits)
            (2, 64, 64, (28, 40, 28))]   # no split, several chunks


def _tc_inputs(dev, b, cin, cout, sp, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, cin) + sp, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn((cout, cin, 3, 3, 3), generator=g, device=dev) * (2.0 / (27 * cin)) ** 0.5
    s = torch.rand(cout, generator=g, device=dev) + 0.5
    o = torch.randn(cout, generator=g, device=dev) * 0.1
    return x, w, s, o


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,cin,cout,sp", TC_CASES)
def test_tc_kernel_matches_plain_on_cuda(cuda_device, b, cin, cout, sp, out_dtype):
    """bf16 input on the tensor cores, bf16 or f32 out: the inference and
    the training forward (out, ycf) against the plain version (atol 5e-2 +
    rtol 1e-2, as chip_smoke.py); mean / inv, which the kernel takes from
    its f32 accumulators before y is rounded, against the plain version's
    f32 conv of the same bf16 inputs (atol 1e-5 + rtol 1e-4: the sums run
    in another order); each launch counted on the tensor-core kernel."""
    torch.backends.cudnn.allow_tf32 = False
    before = (conv3d_in_lrelu_cf.launches, conv3d_in_lrelu_cf.tc_launches)
    x, w, s, o = _tc_inputs(cuda_device, b, cin, cout, sp)
    out = conv3d_in_lrelu_cf(x, w, s, o, out_dtype=out_dtype)
    ref = plain_conv3d_in_lrelu_train(x, w, s, o, out_dtype=out_dtype)
    torch.testing.assert_close(out.float(), ref[0].float(), atol=5e-2, rtol=1e-2)
    train = _kernel_forward(x, w, s, o, 0.01, 1e-5, out_dtype, train=True)
    torch.cuda.synchronize()
    for got, want in zip(train[:2], ref[:2]):
        assert got.dtype == want.dtype == out_dtype
        torch.testing.assert_close(got.float(), want.float(), atol=5e-2, rtol=1e-2)
    ref32 = plain_conv3d_in_lrelu_train(x.float(), w.to(torch.bfloat16).float(), s, o)
    for got, want in zip(train[2:], ref32[2:]):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
    assert (conv3d_in_lrelu_cf.launches, conv3d_in_lrelu_cf.tc_launches) == (
        before[0] + 2, before[1] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,cin,cout,sp", [(2, 64, 64, (28, 40, 28)), (2, 320, 320, (7, 5, 7)),
                                         (2, 320, 320, (4, 4, 4))])
def test_tc_kernel_repeats_bit_for_bit_on_cuda(cuda_device, b, cin, cout, sp):
    """Two launches on the same inputs are equal bit for bit, with and
    without a split: fixed-order sums, no atomics."""
    x, w, s, o = _tc_inputs(cuda_device, b, cin, cout, sp, seed=1)
    first = _kernel_forward(x, w, s, o, 0.01, 1e-5, None, train=True)
    second = _kernel_forward(x, w, s, o, 0.01, 1e-5, None, train=True)
    for a, e in zip(first, second):
        assert torch.equal(a, e)
    assert torch.equal(conv3d_dx_cf(first[0], w), conv3d_dx_cf(first[0], w))


@pytest.mark.cuda
def test_f32_input_takes_the_fma_kernel_on_cuda(cuda_device):
    """f32 input runs the f32 FMA kernel: counted in ``launches``, not in
    ``tc_launches``, and held to atol 1e-3 (no bf16 or TF32 rounding)."""
    torch.backends.cudnn.allow_tf32 = False
    x, w, s, o = _tc_inputs(cuda_device, 2, 64, 64, (28, 40, 28))
    x = x.float()
    before = (conv3d_in_lrelu_cf.launches, conv3d_in_lrelu_cf.tc_launches)
    torch.testing.assert_close(conv3d_in_lrelu_cf(x, w, s, o),
                               plain_conv3d_in_lrelu(x, w, s, o), atol=1e-3, rtol=0)
    assert (conv3d_in_lrelu_cf.launches, conv3d_in_lrelu_cf.tc_launches) == (
        before[0] + 1, before[1])


@pytest.mark.cuda
def test_tc_scratch_lengths_match_the_plan_on_cuda(cuda_device):
    """The kernel's own sizes of its partials and split-K workspace (the
    extension's ``conv3d_tc_partials_len`` / ``conv3d_tc_workspace_len``,
    which the wrappers allocate) are the plan's, at every fused and dx
    shape of the hippocampus and CT plans, at batch 1, 2 and 64."""
    ext = build.load_extension()
    for batch in (1, 2, 64):
        for cin, cout, sp in HIPPOCAMPUS + CT:
            for ci, co in ((cin, cout), (cout, cin)):
                plan = TcPlan(batch, ci, co, sp)
                assert (ext.conv3d_tc_partials_len(batch, co, *sp, plan.splits),
                        ext.conv3d_tc_workspace_len(batch, co, *sp, plan.splits)) == (
                    plan.partials_len, plan.workspace_len), (batch, ci, co, sp)
