"""The yardstick's arithmetic: the card's peaks, the least time a launch
could take, the work of the functions whose rooflines are read, the model
FLOPs of a step, and the reduction of a profiler trace to busy time, idle
gaps and device time by kernel.

The work is counted from the configuration's layer shapes
(``topology.py``) and the function's definition, never from a kernel's
launch plan: each input byte read once, each output byte written once.
"""

from __future__ import annotations

import math

from .topology import unet_layers

# NVIDIA H100 SXM, dense (the data sheet), at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
ACT_BYTES = 2      # bf16 activations
PARAM_BYTES = 4    # f32 parameters


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take for ``flops`` operations at the
    bf16 peak and ``nbytes`` of memory traffic."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def layers_of(config: dict, deep_supervision: bool) -> list:
    plans = config["plans"]
    cfg = plans["configurations"][config["config_name"]]
    return unet_layers(cfg, plans["num_modalities"], plans["num_classes"] + 1,
                       cfg["patch_size"], deep_supervision)


def model_flops(config: dict, batch: int, train: bool) -> float:
    """The model FLOPs of one train step (three times the forward, with
    every deep-supervision head) or of one serving forward of ``batch``
    windows (the last head only): convs, transposed convs and 1x1 heads.
    Recomputation and augmentation are not counted."""
    fwd = sum(layer.conv_flops(batch) for layer in layers_of(config, train))
    return 3.0 * fwd if train else float(fwd)


def conv3d_fused_launches(config: dict, batch: int, train: bool) -> list:
    """[(flops, bytes)] of every launch of the fused stride-1 3x3x3 conv +
    InstanceNorm + LeakyReLU in one step (forward, then the data gradient of
    every such block whose input needs one: all but the network's first
    layer) or one serving forward."""
    out = []
    blocks = [la for la in layers_of(config, train) if la.fused]
    for la in blocks:
        n = math.prod(la.out_spatial)
        out.append((la.conv_flops(batch), ACT_BYTES * batch * (la.cin + la.cout) * n
                    + PARAM_BYTES * la.cin * la.cout * 27 + PARAM_BYTES * 2 * la.cout))
    if train:
        first = layers_of(config, train)[0].name
        for la in blocks:
            if la.name == first:
                continue
            n = math.prod(la.out_spatial)
            out.append((la.conv_flops(batch), ACT_BYTES * batch * (la.cin + la.cout) * n
                        + PARAM_BYTES * la.cin * la.cout * 27))
    return out


def instance_norm_launches(config: dict, batch: int, train: bool) -> list:
    """[(flops, bytes)] of every InstanceNorm + LeakyReLU launch in one step
    or serving forward: the forward of every block outside the fused
    function, and (training) the backward of every block, the fused
    blocks' included.  A forward reads x and writes y; a backward reads x
    and dy and writes dx, dscale and dbias.  About 8 operations an element
    forward and 12 backward: the launches are bytes-bound."""
    out = []
    blocks = [la for la in layers_of(config, train) if la.kind == "block"]
    for la in blocks:
        if la.fused:
            continue
        e = batch * la.cout * math.prod(la.out_spatial)
        out.append((8 * e, ACT_BYTES * 2 * e + PARAM_BYTES * 2 * la.cout))
    if train:
        for la in blocks:
            e = batch * la.cout * math.prod(la.out_spatial)
            out.append((12 * e, ACT_BYTES * 3 * e + PARAM_BYTES * 4 * la.cout))
    return out


def work_bound_s(launches: list) -> float:
    return sum(bound_s(f, b) for f, b in launches)


# ------------------------------------------------------------------ traces
def union_s(intervals: list) -> float:
    """Seconds covered by the union of ``[(start_us, end_us)]``."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total / 1e6


def idle_gaps(intervals: list, lo: float, hi: float) -> list:
    """[(start_us, end_us)] of the stretches of [lo, hi] that no interval
    covers, longest first."""
    gaps, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            gaps.append((end, min(a, hi)))
        end = max(end, b)
    if end < hi:
        gaps.append((end, hi))
    return sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])


def reduce_trace(device_events: list, window_s: float, top: int = 10) -> dict:
    """A traced window of ``window_s`` seconds and its ``device_events``
    ([(name, start_us, end_us)]): busy seconds, device seconds by kernel
    name, and the device operations that took most time."""
    by_name: dict = {}
    for name, a, b in device_events:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": union_s([(a, b) for _, a, b in device_events]), "window_s": window_s,
            "by_name": by_name, "device_ops": [[n, s] for n, s in ops]}


def named_gaps(device_events: list, host_events: list, lo: float, hi: float,
               top: int = 10) -> list:
    """The longest idle gaps of the window [lo, hi] (us), [[name, seconds]]:
    each named by the innermost of ``host_events`` ([(name, start_us,
    end_us)]) that covers its middle, or, where none does, by the device
    operation that ends it."""
    spans = sorted((a, b, n) for n, a, b in device_events)
    out = []
    for a, b in idle_gaps([(x, y) for x, y, _ in spans], lo, hi)[:top]:
        mid = (a + b) / 2
        cover = [(e - s, n) for n, s, e in host_events if s <= mid <= e]
        if cover:
            name = min(cover)[1]
        else:
            after = [n for x, _, n in spans if x >= b]
            name = f"before {after[0]}" if after else "after the last device operation"
        out.append([name, (b - a) / 1e6])
    return out


def kernel_seconds(by_name: dict, patterns) -> float:
    """Device seconds of the kernels whose names hold any of ``patterns``."""
    return sum(s for n, s in by_name.items() if any(p in n for p in patterns))
