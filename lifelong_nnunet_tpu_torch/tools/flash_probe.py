"""Time the flash-attention kernels (``flash_attention_fwd`` and
``flash_attention_bwd``, bf16 input) by device time per launch, split by
kernel with torch.profiler, at the ViT-U-Net's train shape (1, 12, 490, 64)
and its serving shape (8, 12, 490, 64).

    python3 lifelong_nnunet_tpu_torch/tools/flash_probe.py [--root DIR]

``--root`` imports the package from another checkout (an earlier commit
unpacked by ``git archive``, say), so that two versions can be timed in
turns on one card, each in its own process.  A CUDA-event time of one such
launch would mostly measure the host's enqueue, hence the profiler.
Prints a JSON line per shape and direction, then one with the card's name
and power limit and the train shape's times per ViT-U-Net step (12
blocks).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

SHAPES = {"train": (1, 12, 490, 64), "serve": (8, 12, 490, 64)}
BLOCKS = 12   # ViT-base: one forward and one backward launch per block and step


# a call of at least LONG_MS is timed by CUDA events, under the one key
# EVENTS (see device_kernels)
LONG_MS = 1.0
EVENTS = "all kernels (CUDA events)"


def event_ms(fn, reps: int) -> float:
    """Median CUDA-event ms of one call of ``fn`` over ``reps`` calls."""
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return sorted(times)[reps // 2]


def device_kernels(fn, reps: int = 20, tries: int = 3) -> dict:
    """{kernel name: device ms per call} of the kernels one call of ``fn``
    launches.  After a warm-up call, one call is timed by CUDA events; a
    call of LONG_MS or more is then timed so (:func:`event_ms` over ``reps``
    calls), as {EVENTS: ms}: the host's enqueue is a few microseconds of
    it, and the profiler drops events of such launches (3 of 10 of 20 ms
    once) and after them (2-4 of 10 of a 0.2 ms kernel, in the windows
    that followed a profiled 36 ms call of many launches).  A shorter
    call is read by torch.profiler over ``reps`` calls: each kernel's mean
    time per event seen, times its launches per call.  The
    profiler can drop an event at a window's edge (a kernel seen 19 times
    in 20 calls), which the mean absorbs; a window in which a kernel missed
    more than one event or a tenth of its launches lost more (once a
    backward read 0.01 ms in place of 0.13) and is taken again, ``tries``
    times at most.  The probes take this function from the running tree,
    also where they time another checkout's package, so that both are read
    alike."""
    fn()
    if event_ms(fn, 1) >= LONG_MS:
        return {EVENTS: event_ms(fn, reps)}
    for _ in range(tries):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        per_call = {e.key: round(e.count / reps) for e in kernels}
        if kernels and all(n >= 1 and abs(e.count - n * reps) <= max(1, n * reps // 10)
                           for e, n in zip(kernels, per_call.values())):
            return {e.key: e.self_device_time_total / e.count * per_call[e.key] / 1e3
                    for e in kernels}
    raise RuntimeError(f"the profiler lost kernel events in {tries} windows: "
                       f"{[(e.key[:40], e.count) for e in kernels]}")


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn``: its kernels' times, summed."""
    return sum(device_kernels(fn, reps).values())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), help="checkout whose package is timed")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    from lifelong_nnunet_tpu_torch.ops.kernels.attention import (
        flash_attention_bwd, flash_attention_fwd)

    if not torch.cuda.is_available():
        raise SystemExit("flash_probe needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    per_step = {}
    for name, shape in SHAPES.items():
        q, k, v, g = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                      for _ in range(4))
        out, lse = flash_attention_fwd(q, k, v)
        for direction, fn in (("fwd", lambda: flash_attention_fwd(q, k, v)),
                              ("bwd", lambda: flash_attention_bwd(q, k, v, out, lse, g))):
            by = device_kernels(fn)
            ms = sum(by.values())
            print(json.dumps({"shape": list(shape), "direction": direction, "ms": ms,
                              "by_kernel": {key[:80]: round(t, 5) for key, t in by.items()}}),
                  flush=True)
            if name == "train":
                per_step[direction] = BLOCKS * ms
        del q, k, v, g, out, lse
    print(json.dumps({"root": os.path.abspath(args.root), "card": card,
                      "train_per_step_ms": per_step}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
