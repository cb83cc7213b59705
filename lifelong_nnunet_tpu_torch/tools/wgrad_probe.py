"""Time the fused conv's weight gradient on the tensor cores
(``conv3d_weight_grad`` on bf16 input, ``ops/csrc/conv3d_wgrad.cu``) at the
CT 3d_fullres train step's 17 fused-block shapes (batch 2), by device time.

    python3 lifelong_nnunet_tpu_torch/tools/wgrad_probe.py [--reps N]

Per shape, the device time of the kernel, of the library's TF32 weight
gradient on f32 copies (the route the kernel replaced, casts included), of
the library's weight gradient on the bf16 tensors alone, and of the plain
version (f32, TF32 off), with the bound: the larger of the operations at
989 TFLOP/s and the bytes at 3.35 TB/s (x and dy read once, the f32 dw
written once).  Prints a JSON line per shape, then one with the card's
name and power limit and the sums over the step's 17 launches.  The kernel is compared
with the plain version by tests/test_torch_conv3d_wgrad.py and
chip_smoke.py.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

import torch

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def unet_fused_shapes(patch, pools, cin=1, base=32, top=320):
    """(Cin, Cout, spatial) of every stride-1 fused conv of nnU-Net's 3D
    U-Net on ``patch`` with ``pools`` (features doubling from ``base`` to
    ``top``): the first block and every second encoder block, the
    bottleneck's second, and both blocks of every decoder stage (the first
    on the skip concatenated with the upsampled map)."""
    sizes, feats = [tuple(patch)], [base]
    for p in pools:
        sizes.append(tuple(s // k for s, k in zip(sizes[-1], p)))
        feats.append(min(2 * feats[-1], top))
    shapes = [(cin, base, sizes[0]), (base, base, sizes[0])]
    shapes += [(f, f, sp) for f, sp in zip(feats[1:], sizes[1:])]
    for f, sp in zip(feats[-2::-1], sizes[-2::-1]):
        shapes += [(2 * f, f, sp), (f, f, sp)]
    return shapes


CT = unet_fused_shapes((128, 128, 128), [(2, 2, 2)] * 5)
TRAIN_BATCH = 2


def flops(batch, cin, cout, sp) -> float:
    return 2.0 * 27 * cin * cout * batch * math.prod(sp)


def bound(batch, cin, cout, sp) -> tuple:
    """(ms, "operations" or "bytes"): the least time the card could take,
    by operations or by memory traffic (bf16 x and dy read once, the f32
    dw written once), whichever is the larger."""
    nbytes = 2 * batch * math.prod(sp) * (cin + cout) + 4 * 27 * cin * cout
    t_ops = flops(batch, cin, cout, sp) / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def library_tf32(x, w, dy):
    """The route the kernel replaced: cuDNN's weight gradient on f32
    copies, TF32 allowed (PyTorch's default)."""
    return torch.ops.aten.convolution_backward(
        dy.float(), x.float(), w.float(), None, (1, 1, 1), (1, 1, 1), (1, 1, 1), False,
        (0, 0, 0), 1, (False, True, False))[1]


def library_bf16(x, w, dy):
    """cuDNN's weight gradient on the bf16 tensors as they are."""
    return torch.ops.aten.convolution_backward(
        dy, x, w.to(x.dtype), None, (1, 1, 1), (1, 1, 1), (1, 1, 1), False, (0, 0, 0), 1,
        (False, True, False))[1]


def inputs(dev, gen, batch, cin, cout, sp):
    x = torch.randn((batch, cin) + tuple(sp), generator=gen, device=dev).to(torch.bfloat16)
    dy = (torch.randn((batch, cout) + tuple(sp), generator=gen, device=dev) * 0.1).to(
        torch.bfloat16)
    w = torch.randn((cout, cin, 3, 3, 3), generator=gen, device=dev)
    return x, w, dy


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    from lifelong_nnunet_tpu_torch.ops.kernels.conv3d import (
        conv3d_weight_grad, plain_conv3d_weight_grad)
    from lifelong_nnunet_tpu_torch.tools.flash_probe import device_kernels

    if not torch.cuda.is_available():
        raise SystemExit("wgrad_probe needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sums = dict.fromkeys(("kernel_ms", "library_tf32_ms", "library_bf16_ms", "plain_ms",
                          "bound_ms"), 0.0)
    bound_by = dict.fromkeys(("operations", "bytes"), 0)
    for cin, cout, sp in CT:
        x, w, dy = inputs(dev, gen, TRAIN_BATCH, cin, cout, sp)
        ms, by = bound(TRAIN_BATCH, cin, cout, sp)
        row = {"shape": [TRAIN_BATCH, cin, cout, list(sp)], "bound_ms": ms, "bound_by": by}
        bound_by[by] += 1
        torch.backends.cudnn.allow_tf32 = True
        for key, fn in (("kernel_ms", lambda: conv3d_weight_grad(x, w, dy)),
                        ("library_tf32_ms", lambda: library_tf32(x, w, dy)),
                        ("library_bf16_ms", lambda: library_bf16(x, w, dy))):
            by = device_kernels(fn, args.reps)
            row[key] = sum(by.values())
            if key == "kernel_ms":
                row["by_kernel"] = {k[:60]: round(v, 5) for k, v in by.items()}
        torch.backends.cudnn.allow_tf32 = False
        row["plain_ms"] = sum(device_kernels(
            lambda: plain_conv3d_weight_grad(x.float(), w, dy.float()), args.reps).values())
        torch.backends.cudnn.allow_tf32 = True
        row["share"] = row["bound_ms"] / row["kernel_ms"]
        for k in sums:
            sums[k] += row[k]
        print(json.dumps(row), flush=True)
        del x, w, dy
    sums["share"] = sums["bound_ms"] / sums["kernel_ms"]
    sums["bound_by"] = ", ".join(f"{k} at {n} shapes" for k, n in bound_by.items())
    print(json.dumps({"card": card, "launches": len(CT), "batch": TRAIN_BATCH,
                      "per_step": sums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
