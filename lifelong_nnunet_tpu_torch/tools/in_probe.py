"""Time the InstanceNorm + LeakyReLU kernels (``instance_norm_leaky_cf`` and
``instance_norm_leaky_bwd_cf``, bf16) by device time per launch
(torch.profiler), at the shapes the main paths give them, each beside its
bytes bound and a yardstick; with ``--step``, time the CT-scale U-Net's
train step and split its device time by kernel.

    python3 lifelong_nnunet_tpu_torch/tools/in_probe.py [--root DIR] [--groups G ...] [--step]

``--root`` imports the package from another checkout (an earlier commit
unpacked by ``git archive``, say), so that two versions can be timed in
turns on one card, each in its own process; chip_smoke.py runs it in a
process of its own for the same reason as the conv's finish probe (a
profiler started late in a long process loses device events).  The
plain version's device time is given beside, and the yardstick is
``F.instance_norm`` alone (forward) and its autograd backward: it is not
the same function (no LeakyReLU, no saved statistics) and the port never
calls it.  The bound counts each input read once and each output written
once, at 3.35 TB/s.  Prints a JSON line per group, with the card's name
and power limit, and with ``--step`` one of the step's kernels.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

PEAK_BYTES = 3.35e12    # H100 SXM HBM3 (NVIDIA data sheet)
# the plain version is timed where x in f32 takes at most this many bytes
# (its temporaries are several such copies)
PLAIN_BYTES = 4e9
# (C, N, launches) at the post-stride convs of the hippocampus U-Net
# (patch 56x80x56, 32 -> 320 features; the ViT-U-Net's are the first three),
# one launch each per forward; its backward at every conv output, per train
# step; the CT U-Net (patch 128^3, five pools) likewise, its forward at the
# blocked convs' and strided convs' outputs
HIPPO_FWD = ((64, 31360, 1), (128, 3920, 1), (256, 490, 1), (320, 245, 1))
HIPPO_BWD = ((32, 250880, 4), (64, 31360, 4), (128, 3920, 4), (256, 490, 4), (320, 245, 2))
CT_FWD = ((32, 2097152, 4), (64, 262144, 3), (128, 32768, 1), (256, 4096, 1), (320, 512, 1),
          (320, 64, 1))
CT_BWD = ((32, 2097152, 4), (64, 262144, 4), (128, 32768, 4), (256, 4096, 4), (320, 512, 4),
          (320, 64, 2))
# name: (direction, batch, shapes): the train batch (2) and the serving
# batch of 8 windows x 8 mirrors (64)
GROUPS = {"hippo_fwd_b2": ("fwd", 2, HIPPO_FWD), "hippo_fwd_b64": ("fwd", 64, HIPPO_FWD),
          "hippo_bwd_b2": ("bwd", 2, HIPPO_BWD), "ct_fwd_b2": ("fwd", 2, CT_FWD),
          "ct_fwd_b64": ("fwd", 64, CT_FWD), "ct_bwd_b2": ("bwd", 2, CT_BWD)}

# the InstanceNorm kernels' names in a profile, this tree's and earlier ones'
# (the fused conv's finish, `in_stats_kernel` / `in_lrelu_finalize_kernel`,
# is the conv's)
KERNELS = re.compile(r"\bin_(lrelu_(fwd|bwd)|fwd_(warp|cluster)|bwd_(warp|cluster))_kernel"
                     r"|\bsum_over_batch_kernel")


def nbytes(direction: str, B: int, C: int, N: int, size: int = 2) -> int:
    """Bytes one launch must move: x read and out written, with mean and
    rstd written (forward); x and g read with mean and rstd, dx written,
    the per-row dscale / dbias written (backward)."""
    if direction == "fwd":
        return 2 * size * B * C * N + 8 * B * C
    return 3 * size * B * C * N + 16 * B * C


def inputs(direction: str, B: int, C: int, N: int, gen, dtype=torch.bfloat16):
    """x (and for the backward g, mean, rstd), scale and bias on the card."""
    dev = gen.device
    x = (torch.randn((B, C, N), generator=gen, device=dev) * 2 + 0.5).to(dtype)
    scale = torch.randn(C, generator=gen, device=dev) * 0.1 + 1
    bias = torch.randn(C, generator=gen, device=dev) * 0.1
    if direction == "fwd":
        return x, scale, bias
    g = torch.randn((B, C, N), generator=gen, device=dev).to(dtype)
    mean = torch.stack([x[b].float().mean(dim=1) for b in range(B)])
    rstd = torch.rsqrt(torch.stack([x[b].float().var(dim=1, unbiased=False)
                                    for b in range(B)]) + 1e-5)
    return x, scale, bias, mean, rstd, g


def closures(direction: str, args):
    """(kernel, yardstick, plain): one launch of the port's kernel on
    ``args``; F.instance_norm alone (forward) or its autograd backward on
    the same input and gradient (its forward run once here); the kernel's
    plain version."""
    from lifelong_nnunet_tpu_torch.ops.kernels.instance_norm import (
        instance_norm_leaky_bwd_cf, instance_norm_leaky_cf, plain_instance_norm_leaky,
        plain_instance_norm_leaky_bwd)
    x, scale, bias = args[:3]
    w, b = scale.to(x.dtype), bias.to(x.dtype)
    if direction == "fwd":
        return (lambda: instance_norm_leaky_cf(x, scale, bias),
                lambda: F.instance_norm(x, weight=w, bias=b, eps=1e-5),
                lambda: plain_instance_norm_leaky(x, scale, bias))
    xs, ws, bs = (t.detach().requires_grad_() for t in (x, w, b))
    out = F.instance_norm(xs, weight=ws, bias=bs, eps=1e-5)
    g = args[5]
    return (lambda: instance_norm_leaky_bwd_cf(*args),
            lambda: torch.autograd.grad(out, (xs, ws, bs), g, retain_graph=True),
            lambda: plain_instance_norm_leaky_bwd(*args))


def reps_for(direction: str, B: int, C: int, N: int) -> int:
    """Profiled calls per window: 50 for launches of a few microseconds (the
    profiler may drop an event at a window's edge), 10 past 100 MB."""
    return 10 if nbytes(direction, B, C, N) > 100e6 else 50


def time_group(name: str, gen) -> dict:
    """Device ms per launch of the kernel and the yardstick at every shape
    of group ``name``, in turns (kernel, yardstick, yardstick, kernel), the
    plain version's where its f32 copy of x fits PLAIN_BYTES, and their
    sums weighted by the launches per forward or step (``plain_ms`` None
    where a shape has none)."""
    from lifelong_nnunet_tpu_torch.tools.flash_probe import device_kernels
    direction, B, shapes = GROUPS[name]
    rows, tot = [], {"ms": 0.0, "yard_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for C, N, count in shapes:
        args = inputs(direction, B, C, N, gen)
        kernel, yard, plain = closures(direction, args)
        reps = reps_for(direction, B, C, N)
        turns = [sum(device_kernels(fn, reps).values()) for fn in (kernel, yard, yard, kernel)]
        rows.append({"C": C, "N": N, "count": count, "ms": (turns[0] + turns[3]) / 2,
                     "yard_ms": (turns[1] + turns[2]) / 2,
                     "plain_ms": sum(device_kernels(plain, 5).values())
                     if 4 * B * C * N <= PLAIN_BYTES else None,
                     "bound_ms": nbytes(direction, B, C, N) / PEAK_BYTES * 1e3,
                     "turns": [round(t, 5) for t in turns]})
        for k in tot:
            tot[k] = None if tot[k] is None or rows[-1][k] is None else \
                tot[k] + count * rows[-1][k]
        del args, kernel, yard, plain
        torch.cuda.empty_cache()
    return {"group": name, "direction": direction, "batch": B, **tot,
            "share": tot["bound_ms"] / tot["ms"], "shapes": rows}


def sweep(name: str, gen) -> list:
    """This tree's cluster-form kernels at every shape of group ``name``
    under other layouts than the plan's: cluster sizes 1-16 x 128, 256 or
    512 threads (and, for a row longer than a cluster holds, less shared
    memory kept a block), device ms per launch of each."""
    from lifelong_nnunet_tpu_torch.ops.kernels import build
    from lifelong_nnunet_tpu_torch.ops.kernels.instance_norm import (
        card_limits, cluster_plan, launch_plan)
    from lifelong_nnunet_tpu_torch.tools.flash_probe import device_kernels
    direction, B, shapes = GROUPS[name]
    ext, limits = build.load_extension(), card_limits(gen.device)
    out = []
    for C, N, _ in shapes:
        bwd = direction == "bwd"
        plan = launch_plan(B, C, N, torch.bfloat16, bwd, True, limits)
        if plan.form == "warp":
            continue
        args = inputs(direction, B, C, N, gen)
        x = args[0]
        res = torch.empty_like(x)
        if bwd:
            work = torch.empty(2 * C + 2 * B * C, device=x.device)
            tail = (work[:C], work[C:2 * C], work[2 * C:], 0.01)
            entry = lambda p: ext.instance_norm_leaky_bwd(  # noqa: E731
                x, args[5], *args[1:5], res, *tail, *p.args())
        else:
            stats = torch.empty((2, B, C), device=x.device)
            entry = lambda p: ext.instance_norm_leaky_fwd(  # noqa: E731
                x, *args[1:3], res, stats[0], stats[1], 0.01, 1e-5, *p.args())
        times = {}
        for cs in (1, 2, 4, 8, 16):
            for threads in (128, 256, 512):
                for smem in sorted({limits.smem, 96 * 1024, 64 * 1024}, reverse=True):
                    p = cluster_plan(B, C, N, torch.bfloat16, bwd, True, cs, threads, smem)
                    if (cs - 1) * p.slice >= N or cs > limits.cluster or \
                            (smem < limits.smem and p.keep == p.slice):
                        continue
                    ms = sum(device_kernels(lambda: entry(p), reps_for(direction, B, C, N))
                             .values())
                    times[f"{cs}x{threads}/{p.smem // 1024}K"] = round(ms, 5)
        best = min(times, key=times.get)
        out.append({"group": name, "C": C, "N": N, "plan": f"{plan.cluster}x{plan.threads}/"
                    f"{plan.smem // 1024}K", "plan_ms": times.get(
                        f"{plan.cluster}x{plan.threads}/{plan.smem // 1024}K"),
                    "best": best, "best_ms": times[best], "times": times})
        del args, x, res
        torch.cuda.empty_cache()
    return out


def ct_step_profile(dev, steps: int = 5) -> dict:
    """Warm seconds per train step (host clock, ending in a synchronize)
    and device ms per step by kernel (torch.profiler) of the CT-scale U-Net
    (patch 128^3, batch 2, five pools, 32 -> 320 features, bf16, moreDA) on
    the CT routes (blocked conv, interleave upsample), random weights and a
    random batch, each over ``steps`` warm steps."""
    from lifelong_nnunet_tpu_torch.data.augment import AugmentConfig
    from lifelong_nnunet_tpu_torch.models.unet import GenericUNet, ds_scale_factors
    from lifelong_nnunet_tpu_torch.training.optimizer import PolySGD
    from lifelong_nnunet_tpu_torch.training.train_step import StepConfig, make_train_step
    pools = [[2, 2, 2]] * 5
    torch.backends.cudnn.allow_tf32 = True
    model = GenericUNet(in_channels=1, num_classes=3, pool_op_kernel_sizes=pools,
                        conv_kernel_sizes=[[3, 3, 3]] * 6, base_num_features=32,
                        max_num_features=320, dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(0), blocked_conv=True,
                        upsample="interleave").to(dev)
    opt = PolySGD(model.parameters(), max_epochs=1, iters_per_epoch=100)
    cfg = StepConfig(ds_factors=tuple(ds_scale_factors(pools)), batch_dice=True,
                     num_classes=3, augment=AugmentConfig())
    step = make_train_step(model, opt, cfg, generator=torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {"data": torch.randn((2, 1) + (128,) * 3, generator=gen, device=dev),
             "seg": torch.randint(0, 3, (2,) + (128,) * 3, generator=gen, device=dev,
                                  dtype=torch.int8)}
    for _ in range(3):
        step({}, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step({}, batch)
    torch.cuda.synchronize()
    s_per_step = (time.perf_counter() - t0) / steps
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step({}, batch)
        torch.cuda.synchronize()
    by = sorted(((e.self_device_time_total / steps / 1e3, e.key) for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.self_device_time_total > 0), reverse=True)
    ms = sum(t for t, _ in by)
    norm = sum(t for t, k in by if KERNELS.search(k))
    return {"step": "ct_train", "s_per_step": s_per_step, "ms": ms, "instance_norm_ms": norm,
            "instance_norm_share": norm / ms, "top": [[k[:70], round(t, 4)] for t, k in by[:16]],
            "instance_norm": [[k[:70], round(t, 4)] for t, k in by if KERNELS.search(k)]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), help="checkout whose package is timed")
    ap.add_argument("--groups", nargs="*", default=list(GROUPS), choices=list(GROUPS))
    ap.add_argument("--step", action="store_true", help="profile one CT train step too")
    ap.add_argument("--sweep", action="store_true",
                    help="time this tree's kernels under other layouts instead")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    if not torch.cuda.is_available():
        raise SystemExit("in_probe needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    root = os.path.abspath(args.root)
    for name in args.groups:
        if args.sweep:
            for row in sweep(name, gen):
                print(json.dumps({"card": card, **row}), flush=True)
        else:
            print(json.dumps({"root": root, "card": card, **time_group(name, gen)}), flush=True)
    if args.step:
        print(json.dumps({"root": root, "card": card, **ct_step_profile(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
