"""The device-time reading of lifelong_nnunet_tpu_torch/tools/flash_probe.py
(which chip_smoke.py's phase 7 uses), checked on the CPU with a stand-in
profiler: a kernel's time per call is its mean time per event seen times
its launches per call, so an event the profiler drops at a window's edge
does not bias it, and a window that lost more is taken again or refused;
a call of LONG_MS or more is timed by CUDA events instead (the rule the
pack and InstanceNorm probes share)."""

import types

import pytest
import torch

from lifelong_nnunet_tpu_torch.tools import flash_probe


def _profiler(windows):
    """A stand-in for torch.profiler.profile whose successive windows report
    ``windows``: lists of (kernel, events seen, total device µs)."""
    seen = iter(windows)

    class Profile:
        def __init__(self, activities):
            self.events = [types.SimpleNamespace(
                key=key, count=count, self_device_time_total=us,
                device_type=torch.autograd.DeviceType.CUDA)
                for key, count, us in next(seen)]

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return self.events + [types.SimpleNamespace(
                key="aten::empty", count=40, self_device_time_total=0.0,
                device_type=torch.autograd.DeviceType.CPU)]

    return Profile


def _events(monkeypatch, elapsed):
    """A stand-in for torch.cuda.Event whose successive timings (start,
    end pairs) read ``elapsed`` ms."""
    seen = iter(elapsed)

    class Event:
        def __init__(self, enable_timing):
            assert enable_timing

        def record(self):
            pass

        def elapsed_time(self, end):
            return next(seen)

    monkeypatch.setattr(torch.cuda, "Event", Event)


@pytest.mark.parametrize("windows,want", [
    ([[("fwd", 20, 200.0)]], {"fwd": 0.010}),
    ([[("fwd", 19, 190.0)]], {"fwd": 0.010}),
    ([[("dkdv", 40, 400.0), ("dq", 20, 300.0)]], {"dkdv": 0.020, "dq": 0.015}),
    ([[("bwd", 1, 10.0)], [("bwd", 20, 2600.0)]], {"bwd": 0.130}),
], ids=["whole", "edge-event-lost", "two-kernels", "lossy-window-retaken"])
def test_device_kernels_per_call(monkeypatch, windows, want):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    _events(monkeypatch, [0.02])          # the call timed by CUDA events: short
    monkeypatch.setattr(torch.profiler, "profile", _profiler(windows))
    got = flash_probe.device_kernels(lambda: calls.append(1), reps=20)
    assert got == pytest.approx(want)
    # a warm-up call, the call timed by CUDA events, then each window
    assert len(calls) == 2 + 20 * len(windows)


def test_device_kernels_refuses_a_profiler_that_keeps_losing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    _events(monkeypatch, [0.02])
    monkeypatch.setattr(torch.profiler, "profile", _profiler([[("bwd", 3, 30.0)]] * 3))
    with pytest.raises(RuntimeError, match="lost kernel events"):
        flash_probe.device_kernels(lambda: None, reps=20)


@pytest.mark.parametrize("first", [1.0, 20.7])
def test_device_kernels_times_long_calls_by_cuda_events(monkeypatch, first):
    """A call of LONG_MS or more by CUDA events is timed so, over ``reps``
    calls, and never profiled."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.profiler, "profile", _profiler([]))
    _events(monkeypatch, [first, 21.0, 20.0, 19.5, 20.5, 20.2, 20.1, 19.9, 20.3, 20.4, 40.0])
    got = flash_probe.device_kernels(lambda: calls.append(1), reps=10)
    assert got == {flash_probe.EVENTS: pytest.approx(20.3)}   # the median of 10
    assert len(calls) == 1 + 1 + 10   # a warm-up call, the classifying call, the timed calls
