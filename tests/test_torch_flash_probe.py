"""The device-time reading of lifelong_nnunet_tpu_torch/tools/flash_probe.py
(which chip_smoke.py's phase 7 uses), checked on the CPU with a stand-in
profiler: a kernel's time per call is its mean time per event seen times
its launches per call, so an event the profiler drops at a window's edge
does not bias it, and a window that lost more is taken again or refused."""

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


@pytest.mark.parametrize("windows,want", [
    ([[("fwd", 20, 200.0)]], {"fwd": 0.010}),
    ([[("fwd", 19, 190.0)]], {"fwd": 0.010}),
    ([[("dkdv", 40, 400.0), ("dq", 20, 300.0)]], {"dkdv": 0.020, "dq": 0.015}),
    ([[("bwd", 1, 10.0)], [("bwd", 20, 2600.0)]], {"bwd": 0.130}),
], ids=["whole", "edge-event-lost", "two-kernels", "lossy-window-retaken"])
def test_device_kernels_per_call(monkeypatch, windows, want):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.profiler, "profile", _profiler(windows))
    got = flash_probe.device_kernels(lambda: calls.append(1), reps=20)
    assert got == pytest.approx(want)
    assert len(calls) == 1 + 20 * len(windows)   # a warm-up call, then each window


def test_device_kernels_refuses_a_profiler_that_keeps_losing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.profiler, "profile", _profiler([[("bwd", 3, 30.0)]] * 3))
    with pytest.raises(RuntimeError, match="lost kernel events"):
        flash_probe.device_kernels(lambda: None, reps=20)
