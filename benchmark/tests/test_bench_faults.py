"""Whole runs of tiny cells on the CPU: a sound run comes out correct, and
each fault the cell can have, planted under the timed path, turns
``correct`` false.  (A cell of one chip has no exchange between chips to
leave out.)"""

import pytest
import torch

from lifelong_nnunet_tpu_torch.inference import predict, sliding_window
from lifelong_nnunet_tpu_torch.training import optimizer, train_step

from benchmark import harness

from benchmark.tests.cells import run_cell


@pytest.mark.parametrize("name", ["tiny3d_train", "tiny2d_train", "tiny3d_serve"])
def test_sound_run_is_correct(name):
    run, _ = run_cell(name)
    assert run.correct, run.checks
    assert run.attempted > 0 and run.failed == 0
    line = harness.result(run, {"end_to_end": [], "per_layer": []})
    assert list(line)[-1] == "checks"


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(optimizer.PolySGD, "step", lambda self: None)


def _half_batch_train(monkeypatch):
    real = train_step.augment_batch

    def half(data, seg, *a, **k):
        data, seg = real(data, seg, *a, **k)
        n = max(1, data.shape[0] // 2)
        return data[:n], seg[:n]
    monkeypatch.setattr(train_step, "augment_batch", half)


def _half_batch_serve(monkeypatch):
    real = sliding_window.tta_softmax

    def half(model, x, mirror_axes):
        n = max(1, x.shape[0] // 2)
        out = real(model, x[:n], mirror_axes)
        return torch.cat([out, out.mean(0, keepdim=True).expand(x.shape[0] - n, *out.shape[1:])])
    monkeypatch.setattr(sliding_window, "tta_softmax", half)


def _answer_altered(monkeypatch):
    real = predict.finalize_case

    def altered(probs, props, post=None):
        seg, full, props = real(probs, props, post)
        seg = seg.copy()
        seg[: seg.shape[0] // 2] = (seg[: seg.shape[0] // 2] + 1) % 3
        return seg, full, props
    monkeypatch.setattr(predict, "finalize_case", altered)


@pytest.mark.parametrize("name,fault", [
    ("tiny3d_train", _state_unchanged), ("tiny3d_train", _half_batch_train),
    ("tiny2d_train", _state_unchanged), ("tiny2d_train", _half_batch_train),
    ("tiny3d_serve", _half_batch_serve), ("tiny3d_serve", _answer_altered)])
def test_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    run, _ = run_cell(name)
    assert not run.correct, run.checks


@pytest.mark.parametrize("name", ["tiny3d_train", "tiny2d_train", "tiny3d_serve"])
def test_control_fails_a_limit(name):
    """The reference in float8 in the program's place fails at least one of
    the tiny cell's numbers."""
    run, state = run_cell(name)
    readings = harness.entry(run).control(run, state)["control_fp8"]
    limits = run.cell["limits"]
    assert any(v > limits[n] for n, v in readings.items()), readings
