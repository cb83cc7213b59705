"""Time the fused conv (``conv3d_in_lrelu_cf``, bf16 input: the tensor-core
kernel) at the CT serving batch and split its device time by kernel with
torch.profiler: the conv, the split-K reduce and the finish (the
statistics and the normalizing kernel).

    python3 lifelong_nnunet_tpu_torch/tools/conv_finish_probe.py [--root DIR]

``--root`` imports the package from another checkout (an earlier commit
unpacked by ``git archive``, say), so that two versions can be timed in
turns on one card, each in its own process.  The shapes are the stride-1
convs of the CT U-Net (patch 128^3, 32 -> 320 features) at 128^3 and 64^3,
with their counts per forward on the ordinary kernel route.  Prints a JSON
line per shape and one of the per-forward sums, with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

# (Cin, Cout, spatial): count per forward
SHAPES = {(1, 32, (128,) * 3): 1, (32, 32, (128,) * 3): 2, (64, 32, (128,) * 3): 1,
          (64, 64, (64,) * 3): 2, (128, 64, (64,) * 3): 1}
REPS = 3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), help="checkout whose package is timed")
    ap.add_argument("--batch", type=int, default=64)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    from lifelong_nnunet_tpu_torch.ops.kernels.conv3d import conv3d_in_lrelu_cf

    if not torch.cuda.is_available():
        raise SystemExit("conv_finish_probe needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    total = {"ms": 0.0, "conv": 0.0, "reduce": 0.0, "finish": 0.0}
    for (cin, cout, sp), count in SHAPES.items():
        x = torch.randn((args.batch, cin) + sp, generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn((cout, cin, 3, 3, 3), generator=gen, device=dev) * (2 / (27 * cin)) ** 0.5
        scale = torch.ones(cout, device=dev)
        off = torch.zeros(cout, device=dev)
        conv3d_in_lrelu_cf(x, w, scale, off)
        times = []
        for _ in range(REPS):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            conv3d_in_lrelu_cf(x, w, scale, off)
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                conv3d_in_lrelu_cf(x, w, scale, off)
            torch.cuda.synchronize()
        by = {"conv": 0.0, "reduce": 0.0, "finish": 0.0, "other": 0.0}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                part = ("finish" if "in_stats_kernel" in e.key or "finalize" in e.key else
                        "reduce" if "reduce_kernel" in e.key else
                        "conv" if "conv3d" in e.key else "other")
                by[part] += e.self_device_time_total / 1e3 / REPS
        ms = statistics.median(times)
        print(json.dumps({"shape": [args.batch, cin, cout, list(sp)], "count": count,
                          "ms": ms, **{k: round(v, 4) for k, v in by.items()}}), flush=True)
        total["ms"] += count * ms
        for k in ("conv", "reduce", "finish"):
            total[k] += count * by[k]
        del x
        torch.cuda.empty_cache()
    print(json.dumps({"root": os.path.abspath(args.root), "card": card,
                      "batch": args.batch, "per_forward": total}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
