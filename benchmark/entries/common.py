"""What the entries share: loading the benchmark's weights into the
program's model, the traced window, and the launch counters' check."""

from __future__ import annotations

import gc
import time

import torch

from .. import arithmetic


def load_params(net: torch.nn.Module, params: dict) -> None:
    """Copy the benchmark's weights into ``net``: the same names and shapes,
    none missing on either side."""
    own = dict(net.named_parameters())
    if set(own) != set(params):
        raise ValueError(f"parameter names differ: program only {sorted(set(own) - set(params))}"
                         f", benchmark only {sorted(set(params) - set(own))}")
    with torch.no_grad():
        for name, p in own.items():
            if tuple(p.shape) != tuple(params[name].shape):
                raise ValueError(f"{name}: program {tuple(p.shape)}, "
                                 f"benchmark {tuple(params[name].shape)}")
            p.copy_(params[name])


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def launches(counters: dict) -> dict:
    """{function: launches so far} of the program's wrappers."""
    return {name: sum(fn.launches for fn in fns) for name, fns in counters.items()}


def require_launches(got: dict, want: dict, device: torch.device) -> None:
    """The wrappers count launches of the card's kernels only (on the CPU
    they run their plain versions)."""
    if device.type == "cuda" and got != want:
        raise RuntimeError(f"the traced window launched {got}, the work arithmetic "
                           f"assumes {want}")


def _trace(fn, device: torch.device, host: bool) -> tuple:
    """Run ``fn`` under torch.profiler, recording the device's operations and,
    with ``host`` (or on a CPU), the host's spans too.  Returns (device
    operations, host spans, [(name, start_us, end_us)] each; the window
    (lo, hi) in the trace's microseconds; the window's seconds by the host
    clock, from a synchronized start to the device's end)."""
    cuda = device.type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CUDA] if cuda else []
    if host or not cuda:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    if cuda:
        torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=acts) as prof:
        # recorded only with the host's activity
        with torch.profiler.record_function("bench.window"):
            t0 = time.perf_counter()
            fn()
            if cuda:
                torch.cuda.synchronize(device)
            secs = time.perf_counter() - t0
    dev, spans, lo, hi = [], [], None, None
    annotations = {e.name for e in prof.events() if getattr(e, "is_user_annotation", False)}
    for e in prof.events():
        rng = (e.time_range.start, e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # a span's range on the device timeline (an annotation) is no operation
            if not getattr(e, "is_user_annotation", False) and e.name not in annotations:
                dev.append((e.name,) + rng)
        elif e.name == "bench.window":
            lo, hi = rng
        else:
            spans.append((e.name,) + rng)
    if lo is None:
        lo = min((a for _, a, _ in dev), default=0.0)
        hi = max((b for _, _, b in dev), default=lo)
    dev = [(n, max(a, lo), min(b, hi)) for n, a, b in dev if b > lo and a < hi]
    return dev, spans, (lo, hi), secs


def profile(fn, device: torch.device, gaps_fn=None) -> dict:
    """Trace ``fn`` with the device's operations alone (tracing the host's
    every operation slows the host, and with it the idle share) and reduce
    it (``arithmetic.reduce_trace``).  The breakdown's idle gaps are named
    from a second, host and device, trace of ``gaps_fn`` where one is
    given, else by the device operation that ends each gap."""
    dev, spans, (lo, hi), secs = _trace(fn, device, host=False)
    out = arithmetic.reduce_trace(dev, secs)
    if gaps_fn is not None:
        dev, spans, (lo, hi), _ = _trace(gaps_fn, device, host=True)
        gaps = arithmetic.named_gaps(dev, spans, lo, hi)
    else:
        gaps = arithmetic.named_gaps(dev, [], lo, hi)
        edges = secs - (hi - lo) / 1e6
        if edges > 0:
            gaps = sorted(gaps + [["before the first and after the last device operation",
                                   edges]], key=lambda g: -g[1])[:10]
    out["breakdown"] = {"device_ops": out.pop("device_ops"), "idle_gaps": gaps}
    return out
