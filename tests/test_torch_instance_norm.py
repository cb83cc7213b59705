"""The port's InstanceNorm + LeakyReLU (ops/kernels/instance_norm.py)
against the JAX package's Pallas kernel, run in interpret mode on the CPU
as tests/test_pallas_instance_norm.py runs it, and against its pure-jnp
reference.  On the CPU the port's wrapper takes its plain PyTorch version;
the CUDA kernel is compared with that plain version on the card (marked
``cuda``, skipped without one, and run by chip_smoke.py).  The launch plan
that lays each launch on the card is checked here at every shape of the
main paths, with the card's limits as parameters, and the Chan merge of
the kernel's statistics in its own order against the Pallas kernel."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from lifelong_nnunet_tpu.ops.pallas.instance_norm import (
    instance_norm_leaky as jax_instance_norm_leaky, instance_norm_leaky_nd,
    reference_instance_norm_leaky)
from lifelong_nnunet_tpu_torch.ops.kernels import build
from lifelong_nnunet_tpu_torch.ops.kernels import instance_norm as inorm
from lifelong_nnunet_tpu_torch.ops.kernels.instance_norm import (
    FORMS, H100, WARP_ELEMS, Limits, instance_norm_leaky, instance_norm_leaky_cf,
    launch_plan, plain_chan_stats, plain_instance_norm_leaky)
from lifelong_nnunet_tpu_torch.tools.in_probe import CT_BWD, CT_FWD, HIPPO_BWD, HIPPO_FWD

torch.set_num_threads(2)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = (rng.normal(size=shape) * 2.0 + 0.5).astype(np.float32)
    scale = (rng.rand(c) + 0.5).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("shape", [(2, 64, 16), (1, 300, 8), (3, 27, 32)])
def test_f32_matches_pallas_kernel(shape):
    x, scale, bias = _inputs(shape, 0)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_instance_norm_leaky(
            jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))
    jnp_ref = np.asarray(reference_instance_norm_leaky(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))
    out = instance_norm_leaky(torch.from_numpy(x), torch.from_numpy(scale),
                              torch.from_numpy(bias)).numpy()
    assert out.shape == shape and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-5)
    np.testing.assert_allclose(out, jnp_ref, atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 64, 8), (2, 128, 16)])
def test_bf16_matches_pallas_kernel(shape):
    x, scale, bias = _inputs(shape, 3)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_instance_norm_leaky(xb, jnp.asarray(scale), jnp.asarray(bias))
    assert ref.dtype == jnp.bfloat16
    out = instance_norm_leaky(torch.from_numpy(x).to(torch.bfloat16),
                              torch.from_numpy(scale), torch.from_numpy(bias))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=3e-2)


def test_channels_first_entry_matches_nd_wrapper():
    """The model's channels-first entry on a [B, C, D, H, W] map equals the
    JAX channels-last ``instance_norm_leaky_nd`` on the same values."""
    x, scale, bias = _inputs((2, 4, 5, 6, 8), 1)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(instance_norm_leaky_nd(
            jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))
    out = instance_norm_leaky_cf(
        torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))),
        torch.from_numpy(scale), torch.from_numpy(bias))
    np.testing.assert_allclose(np.moveaxis(out.numpy(), 1, -1), ref, atol=1e-5)


def test_non_cuda_device_raises():
    """Off the CPU the wrapper launches the kernel or raises; it never takes
    the plain path for a tensor that is not on the CPU."""
    x = torch.empty((1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        instance_norm_leaky_cf(x, torch.ones(4, device="meta"),
                               torch.zeros(4, device="meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 3e-2)])
def test_kernel_matches_plain_on_cuda(cuda_device, dtype, atol):
    before = instance_norm_leaky_cf.launches
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for shape in [(8, 64, 28, 40, 28), (8, 320, 7, 5, 7), (3, 5, 6, 10, 12)]:
        x = (torch.randn(shape, generator=g, device=cuda_device) * 3 + 1).to(dtype)
        s = torch.rand(shape[1], generator=g, device=cuda_device) + 0.5
        b = torch.randn(shape[1], generator=g, device=cuda_device)
        out = instance_norm_leaky_cf(x, s, b)
        ref = plain_instance_norm_leaky(x, s, b)
        torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=1e-2)
    assert instance_norm_leaky_cf.launches == before + 3


# (direction, batch, (C, N, launches)...) of every InstanceNorm launch of the
# six main paths: the hippocampus U-Net's train step (B=2) and serving
# batches (1 and 8 windows x 8 mirrors), the ViT-U-Net's step (B=1, the
# U-Net's first three post-stride shapes, four backward) and serving, the
# CT U-Net's step (B=2) and serving batch (64)
MAIN_PATHS = [("fwd", 2, HIPPO_FWD), ("fwd", 8, HIPPO_FWD), ("fwd", 64, HIPPO_FWD),
              ("bwd", 2, HIPPO_BWD), ("fwd", 1, HIPPO_FWD[:3]), ("fwd", 8, HIPPO_FWD[:3]),
              ("bwd", 1, HIPPO_BWD[:4]), ("fwd", 2, CT_FWD), ("fwd", 64, CT_FWD),
              ("bwd", 2, CT_BWD)]
MAIN_SHAPES = sorted({(d, b, c, n) for d, b, shapes in MAIN_PATHS for c, n, _ in shapes})
SMEM_PER_BLOCK = 232448   # an H100 block's opt-in shared memory, bytes


def _pieces(plan, N):
    """[(start, end)] of the elements one row is read in: per block in rank
    order, its kept part, then its streamed chunks."""
    out = []
    for r in range(plan.cluster):
        s0, s1 = r * plan.slice, min(N, (r + 1) * plan.slice)
        assert s1 > s0, (r, plan)           # no block of a cluster is idle
        kept = min(s1, s0 + plan.keep)
        out += [(s0, kept)] + [(a, min(s1, a + plan.chunk)) for a in range(kept, s1, plan.chunk)]
    return [(a, b) for a, b in out if b > a]


def check_plan(plan, B, C, N, dtype, backward, aligned=True, limits=H100):
    """The invariants the kernels rely on."""
    size = dtype.itemsize
    assert plan.form in FORMS
    assert 1 <= plan.cluster <= min(16, limits.cluster) and plan.cluster & (plan.cluster - 1) == 0
    assert plan.smem <= limits.smem and plan.smem + 1024 <= SMEM_PER_BLOCK
    # 16-byte vectors only where every row and pointer is aligned to them
    assert plan.vec == (aligned and N * size % 16 == 0)
    assert plan.item == (16 // size if plan.vec else 1)
    assert plan.slice % plan.item == plan.keep % plan.item == plan.chunk % plan.item == 0
    # every element of a row covered exactly once
    pieces = _pieces(plan, N)
    assert [a for a, _ in pieces] == [0] + [b for _, b in pieces[:-1]] and pieces[-1][1] == N
    if plan.form == "warp":
        assert N <= 32 * WARP_ELEMS and plan.cluster == 1 and pieces == [(0, N)]
        assert plan.blocks == math.ceil(B * C / inorm.WARP_ROWS) and plan.smem == 0
    else:
        assert N > 32 * WARP_ELEMS and plan.threads % 32 == 0 and plan.threads <= 512
        assert (plan.form == "stream") == (plan.keep < plan.slice)
        assert plan.smem == plan.keep * size * (2 if backward else 1)
        assert plan.blocks == B * C * plan.cluster <= 2 ** 31 - 1
        assert plan.warps_per_row == plan.cluster * plan.threads // 32


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("direction,B,C,N", MAIN_SHAPES,
                         ids=[f"{d}-B{b}-C{c}-N{n}" for d, b, c, n in MAIN_SHAPES])
def test_launch_plan_at_every_main_path_shape(direction, B, C, N, dtype):
    backward = direction == "bwd"
    check_plan(launch_plan(B, C, N, dtype, backward), B, C, N, dtype, backward)
    check_plan(launch_plan(B, C, N, dtype, backward, aligned=False), B, C, N, dtype,
               backward, aligned=False)


@pytest.mark.parametrize("direction,B,C,N,form,cluster", [
    ("fwd", 2, 320, 245, "warp", 1),          # 7x5x7: a warp per row, scalar access
    ("fwd", 64, 64, 31360, "cluster", 1),     # 28x40x28 at the serving batch: a block a row
    ("fwd", 2, 64, 31360, "cluster", 1),      # 128 rows fill the card, the launch fits L2
    ("bwd", 2, 128, 32768, "stream", 1),      # half of x and g kept, the rest read from L2
    ("bwd", 2, 32, 250880, "stream", 8),      # 56x80x56: 64 rows over clusters of 8
    ("fwd", 2, 64, 262144, "cluster", 8),     # CT 64^3: read once, 64 KB a block
    ("bwd", 2, 64, 262144, "stream", 8),
    ("fwd", 2, 32, 2097152, "stream", 16),    # CT 128^3: 4 MB a row, 16 blocks keep a quarter
    ("bwd", 2, 32, 2097152, "stream", 16)])
def test_launch_plan_forms(direction, B, C, N, form, cluster):
    """The form and cluster size the plan gives the main paths' kinds of
    rows on an H100 (bf16), and that every launch gives at least half the
    SMs a block."""
    plan = launch_plan(B, C, N, torch.bfloat16, direction == "bwd")
    assert (plan.form, plan.cluster) == (form, cluster)
    assert 2 * plan.blocks >= H100.sms


@pytest.mark.parametrize("limits", [Limits(cluster=8), Limits(smem=48 * 1024, cluster=4),
                                    Limits(sms=16, smem=16 * 1024, cluster=1)],
                         ids=["cluster8", "smem48k", "no-cluster"])
def test_launch_plan_keeps_within_the_cards_limits(limits):
    """A card that schedules smaller clusters, or gives a block less shared
    memory, gets plans within those limits at every main-path shape."""
    for direction, B, C, N in MAIN_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            plan = launch_plan(B, C, N, dtype, direction == "bwd", limits=limits)
            check_plan(plan, B, C, N, dtype, direction == "bwd", limits=limits)


def _leaky(x, mean, rstd, scale, bias):
    y = ((x - mean[..., None]) * rstd[..., None] * torch.from_numpy(scale)[:, None]
         + torch.from_numpy(bias)[:, None])
    return torch.where(y >= 0, y, 0.01 * y)


@pytest.mark.parametrize("limits", [H100, Limits(smem=16 * 1024)], ids=["cluster", "stream"])
def test_chan_merge_in_kernel_order_matches_pallas_kernel(limits):
    """The forward kernel's statistics in its own order (each piece's mean
    and centred sum of squares two-pass, merged by Chan's formula; the
    kept parts and streamed chunks of 16 slices) against the Pallas kernel
    (interpret mode) and the jnp reference, on f32 rows of N = 2^17 with
    mean 0.5 (atol 1e-5) and with mean 1e3 and std 1.  At 1e3 an f32 mean
    is exact only to its spacing there (6.1e-5), and every f32 route lands
    within a few spacings of the f64 mean (the Pallas kernel's lands 6.9e-5
    off), so that row is held to 4 spacings times the largest scale; and
    the variance as E[x^2] - mean^2 misses that row by far more."""
    N, C = 2 ** 17, 8
    for loc in (0.5, 1e3):
        rng = np.random.RandomState(5)
        x = (rng.normal(size=(1, N, C)) + loc).astype(np.float32)
        scale = (rng.rand(C) + 0.5).astype(np.float32)
        bias = rng.normal(size=C).astype(np.float32)
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(jax_instance_norm_leaky(
                jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))
        jnp_ref = np.asarray(reference_instance_norm_leaky(
            jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))
        xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))   # [1, C, N]
        plan = launch_plan(1, C, N, torch.float32, limits=limits)
        assert plan.form == ("cluster" if limits is H100 else "stream") and plan.cluster == 16
        assert len(_pieces(plan, N)) == (16 if limits is H100 else 32)
        mean, rstd = plain_chan_stats(xt, plan)
        out = _leaky(xt, mean, rstd, scale, bias).numpy().transpose(0, 2, 1)
        atol = 1e-5 if loc < 1 else 4 * float(np.spacing(np.float32(loc))) * scale.max()
        np.testing.assert_allclose(out, ref, atol=atol, rtol=0)
        np.testing.assert_allclose(out, jnp_ref, atol=atol, rtol=0)
        x64 = x.astype(np.float64)
        np.testing.assert_allclose(mean.numpy()[0], x64.mean(axis=1)[0],
                                   atol=4 * float(np.spacing(np.float32(loc))), rtol=0)
        np.testing.assert_allclose((1 / rstd ** 2).numpy()[0] - 1e-5, x64.var(axis=1)[0],
                                   rtol=1e-5)
        if loc > 1:
            naive = (xt * xt).mean(dim=-1) - xt.mean(dim=-1) ** 2
            bad = _leaky(xt, xt.mean(dim=-1), torch.rsqrt(naive + 1e-5), scale, bias)
            assert np.abs(bad.numpy().transpose(0, 2, 1) - ref).max() > 100 * atol


def test_chan_stats_of_the_warp_form_are_the_two_pass_statistics():
    """A warp-form row is one piece: the plain Chan statistics equal the
    plain version's two-pass mean and rstd."""
    x = torch.from_numpy(_inputs((3, 245, 6), 2)[0]).transpose(1, 2).contiguous()
    plan = launch_plan(3, 6, 245, torch.float32)
    assert plan.form == "warp"
    mean, rstd = plain_chan_stats(x, plan)
    _, ref_mean, ref_rstd = inorm._plain_forward(x, torch.ones(6), torch.zeros(6), 0.01, 1e-5)
    torch.testing.assert_close(mean, ref_mean, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(rstd, ref_rstd, atol=1e-6, rtol=1e-6)


class _Entries:
    """A stand-in for the built extension: records the InstanceNorm entries'
    calls."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("instance_norm_leaky"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args))


@pytest.fixture()
def entries(monkeypatch):
    ext = _Entries()
    monkeypatch.setattr(build, "require_cuda", lambda *ts: ts[0].device)
    monkeypatch.setattr(build, "load_extension", lambda: ext)
    monkeypatch.setattr(inorm, "card_limits", lambda device: H100)
    return ext


@pytest.mark.parametrize("shape,form", [((64, 320, 7, 5, 7), "warp"),
                                        ((2, 64, 28, 40, 28), "cluster"),
                                        ((2, 32, 128, 128, 128), "stream")])
def test_wrapper_hands_the_plan_to_the_kernel(entries, shape, form):
    """On a device tensor the forward wrapper launches once with the plan
    of its shape (meta tensors and a stand-in extension here) and counts
    the launch under its form."""
    x = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    c = shape[1]
    before = dict(instance_norm_leaky_cf.forms), instance_norm_leaky_cf.launches
    out = instance_norm_leaky_cf(x, torch.ones(c, device="meta"), torch.zeros(c, device="meta"))
    assert out.shape == shape and out.dtype == torch.bfloat16
    plan = launch_plan(shape[0], c, math.prod(shape[2:]), torch.bfloat16)
    assert plan.form == form
    ((name, args),) = entries.calls
    assert name == "instance_norm_leaky_fwd" and args[-6:] == plan.args()
    assert instance_norm_leaky_cf.launches == before[1] + 1
    assert instance_norm_leaky_cf.forms == {f: n + (f == form) for f, n in before[0].items()}


# rows the kernels' forms meet on the main paths, and some they do not
CUDA_ROWS = [((3, 5, 7, 5, 7), "warp"),         # 245: unaligned, scalar
             ((2, 7, 7, 10, 7), "warp"),        # 490: unaligned, scalar
             ((2, 4, 8, 8, 8), "warp"),         # 512: 16-byte vectors
             ((2, 3, 5, 9, 13), "cluster"),     # 585: a block a row, scalar
             ((2, 3, 56, 80, 56), "cluster"),   # split over a cluster
             ((1, 2, 128, 128, 128), "stream")]  # longer than a cluster holds


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-4, 0.0),
                                             (torch.bfloat16, 3e-2, 1e-2)], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,form", CUDA_ROWS, ids=[f for _, f in CUDA_ROWS])
def test_kernel_forms_match_plain_on_cuda(cuda_device, shape, form, dtype, atol, rtol):
    """Each form against the plain version (f32 atol 1e-4; bf16 atol 3e-2 +
    rtol 1e-2), counted under the form its plan gives, and a second run
    equal bit for bit."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = (torch.randn(shape, generator=g, device=cuda_device) * 2 + 0.5).to(dtype)
    s = torch.rand(shape[1], generator=g, device=cuda_device) + 0.5
    b = torch.randn(shape[1], generator=g, device=cuda_device)
    plan = launch_plan(shape[0], shape[1], math.prod(shape[2:]), dtype, False,
                       limits=inorm.card_limits(x.device))
    assert plan.form == form or dtype == torch.float32   # the rows are picked in bf16
    before = instance_norm_leaky_cf.forms[plan.form]
    out = instance_norm_leaky_cf(x, s, b)
    torch.testing.assert_close(out.float(), plain_instance_norm_leaky(x, s, b).float(),
                               atol=atol, rtol=rtol)
    assert torch.equal(instance_norm_leaky_cf(x, s, b), out)
    assert instance_norm_leaky_cf.forms[plan.form] == before + 2
