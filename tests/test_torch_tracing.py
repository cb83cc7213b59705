"""The port's spans and counters (``lifelong_nnunet_tpu_torch/tracing.py``):
off by default and free of records, parents and request identifiers,
one recording at a time, counters only while recording; the spans of a
CPU train step and of ``predict_from_folder`` on a tiny folder; and, on
the card, the recording's clock against a device-only profiler trace."""

import os
import threading

import numpy as np
import pytest
import torch

from lifelong_nnunet_tpu_torch import tracing
from lifelong_nnunet_tpu_torch.data.pipeline import Prefetcher
from lifelong_nnunet_tpu_torch.data.sampler import PatchSampler
from lifelong_nnunet_tpu_torch.inference.predict import predict_from_folder
from lifelong_nnunet_tpu_torch.models.unet import GenericUNet, ds_scale_factors, unet_from_plans
from lifelong_nnunet_tpu_torch.planning.plans import Configuration, Plans
from lifelong_nnunet_tpu_torch.training.optimizer import PolySGD
from lifelong_nnunet_tpu_torch.training.train_step import StepConfig, make_train_step
from lifelong_nnunet_tpu_torch.utilities.imageio import write_image
from lifelong_nnunet_tpu_torch.utilities.nifti import NiftiImage

torch.set_num_threads(2)


def _named(rec, name):
    return [s for s in rec.spans if s.name == name]


def test_off_returns_one_shared_object_and_records_nothing():
    a = tracing.span("a")
    b = tracing.span("b", device=True, case="x")
    assert a is b is tracing.OFF
    with a:
        tracing.count("c", 5)
    with tracing.recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == {}


def test_nested_spans_name_their_parent_and_inherit_ids():
    with tracing.recording() as rec:
        with tracing.span("outer", step=3):
            with tracing.span("middle", case="c0"):
                with tracing.span("inner"):
                    pass
            with tracing.span("sibling", step=4):
                pass
    by = {s.name: s for s in rec.spans}
    assert by["outer"].parent is None
    assert by["middle"].parent == by["outer"].id
    assert by["inner"].parent == by["middle"].id
    assert by["sibling"].parent == by["outer"].id
    assert by["inner"].ids == {"step": 3, "case": "c0"}
    assert by["sibling"].ids == {"step": 4}
    outer = by["outer"]
    for s in rec.spans:
        assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns


def test_a_second_recording_raises():
    with tracing.recording():
        with pytest.raises(RuntimeError):
            with tracing.recording():
                pass
        errors = []

        def other():
            try:
                with tracing.recording():
                    pass
            except RuntimeError as e:
                errors.append(e)
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive() and len(errors) == 1
    with tracing.recording():            # closed again: a new one opens
        pass


def test_counters_count_only_while_recording():
    tracing.count("n", 2)
    with tracing.recording() as rec:
        tracing.count("n", 2)
        tracing.count("n")
        tracing.count("m", 0)
    tracing.count("n", 7)
    assert rec.counters == {"n": 3, "m": 0}


def test_spans_on_other_threads_carry_their_request_id():
    """Each thread has its own stack of open spans: a span on a worker has
    no parent on the caller's thread; counters from many threads add up."""
    with tracing.recording() as rec:
        with tracing.span("caller"):
            threads = [threading.Thread(target=_work, args=(f"case{i}",)) for i in range(6)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    work = [s for s in rec.spans if s.name == "work"]
    part = {s.parent: s for s in rec.spans if s.name == "part"}
    assert sorted(s.ids["case"] for s in work) == [f"case{i}" for i in range(6)]
    for s in work:
        assert s.parent is None and s.thread != threading.get_ident()
        assert part[s.id].ids == s.ids and part[s.id].thread == s.thread
    assert rec.counters == {"parts": 600}


def _work(case):
    with tracing.span("work", case=case):
        with tracing.span("part"):
            for _ in range(100):
                tracing.count("parts")


def test_device_ms_is_none_on_the_cpu():
    with tracing.recording() as rec:
        with tracing.span("d", device=True):
            torch.ones(4).sum()
    assert rec.spans[0].device_ms is None


def test_on_trace_maps_the_spans_onto_a_profiler_trace():
    """On the host's clock, as ``torch.profiler`` reports it: a span around
    a ``record_function`` covers it to within a few milliseconds."""
    with tracing.recording() as rec:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for i in range(3):
                with torch.profiler.record_function(f"mark{i}"):
                    with tracing.span(f"mark{i}"):
                        torch.ones(64).sum()
    start = prof.profiler.kineto_results.trace_start_ns()
    mapped = {s["name"]: s for s in rec.on_trace(start)}
    for e in prof.events():
        if e.name in mapped:
            s = mapped[e.name]
            assert abs(s["start_us"] - e.time_range.start) < 5000
            assert abs(s["end_us"] - e.time_range.end) < 5000


POOLS = ((2, 2, 2), (2, 2, 2))
CONVS = ((3, 3, 3),) * 3


def test_train_step_records_its_four_phases_in_order():
    torch.manual_seed(0)
    model = GenericUNet(1, 3, POOLS, CONVS, 4, 16)
    opt = PolySGD(model.parameters(), 4, 2)
    step = make_train_step(model, opt, StepConfig(ds_factors=tuple(ds_scale_factors(POOLS)),
                                                  batch_dice=True, num_classes=3))
    rng = np.random.RandomState(0)
    batch = {"data": torch.from_numpy(rng.randn(2, 1, 16, 16, 16).astype(np.float32)),
             "seg": torch.from_numpy(rng.randint(0, 3, (2, 16, 16, 16)).astype(np.int8))}
    step({}, batch)                                  # not recorded
    with tracing.recording() as rec:
        for _ in range(2):
            step({}, batch)
    steps = sorted(_named(rec, "train.step"), key=lambda s: s.start_ns)
    assert [s.ids for s in steps] == [{"step": 1}, {"step": 2}]
    for st in steps:
        kids = sorted((s for s in rec.spans if s.parent == st.id), key=lambda s: s.start_ns)
        assert [s.name for s in kids] == ["step.augment", "step.forward", "step.backward",
                                          "step.optimizer"]
        assert all(s.ids == st.ids and s.device_ms is None for s in kids)
        assert st.start_ns <= kids[0].start_ns and kids[-1].end_ns <= st.end_ns
        for a, b in zip(kids, kids[1:]):
            assert a.end_ns <= b.start_ns


class _Cases:
    """A dataset of one case, as ``PatchSampler`` reads it."""

    def load(self, case):
        return np.zeros((2, 6, 6, 6), np.float32)


def test_prefetcher_numbers_its_batches_on_both_threads():
    """The sampler's and the copy's spans on the thread and the consumer's
    wait carry one batch number; ``prefetch.next`` counts the calls of
    ``next()``."""
    sampler = PatchSampler(None, [(_Cases(), "c")], (4, 4, 4), 2, 0.0, native=False)
    with tracing.recording() as rec:
        pf = Prefetcher(sampler, torch.device("cpu"))
        try:
            for _ in range(5):
                pf.next()
        finally:
            pf.stop()
    waits = sorted(s.ids["batch"] for s in _named(rec, "prefetch.wait"))
    assert waits == list(range(5))
    h2d = {s.ids["batch"]: s for s in _named(rec, "prefetch.h2d")}
    drawn = {s.ids["batch"]: s for s in _named(rec, "sampler.next_batch")}
    for b in waits:
        assert drawn[b].end_ns <= h2d[b].start_ns and drawn[b].thread == h2d[b].thread
    assert rec.counters["prefetch.next"] == 5
    assert 0 <= rec.counters["prefetch.empty"] <= 5


def _plans(patch) -> Plans:
    cfg = Configuration(name="3d_fullres", batch_size=2, patch_size=list(patch),
                        spacing=[1.0, 1.0, 1.0], pool_op_kernel_sizes=[[2, 2, 2]],
                        conv_kernel_sizes=[[3, 3, 3]] * 2, base_num_features=4,
                        max_num_features=8)
    return Plans(plans_name="nnUNetPlansv2.1", task="Task001_Trace", num_modalities=1,
                 num_classes=2, all_classes=[1, 2], modalities={0: "MRI"},
                 labels={0: "background", 1: "a", 2: "b"},
                 normalization_schemes={0: "zscore"}, use_mask_for_norm={0: False},
                 intensity_properties={}, original_median_spacing=[1.0, 1.0, 1.0],
                 original_median_shape=[12, 14, 10], configurations={"3d_fullres": cfg})


def test_predict_from_folder_records_each_case(tmp_path):
    rng = np.random.RandomState(1)
    folder = tmp_path / "in"
    os.makedirs(folder)
    for i, shape in enumerate([(12, 14, 10), (10, 12, 14)]):
        write_image(str(folder / f"case{i}_0000.nii.gz"),
                    NiftiImage(rng.randn(*shape).astype(np.float32), spacing=(1.0, 1.0, 1.0)))
    plans = _plans((8, 8, 8))
    torch.manual_seed(0)
    model = unet_from_plans(plans, "3d_fullres", deep_supervision=False).eval()
    with tracing.recording() as rec:
        written = predict_from_folder([model], plans, "3d_fullres", str(folder),
                                      str(tmp_path / "out"), device=torch.device("cpu"),
                                      window_batch=4)
    assert all(os.path.isfile(f) for f in written) and len(written) == 2
    for name in ("serve.preprocess", "serve.finish"):
        assert sorted(s.ids["case"] for s in _named(rec, name)) == ["case0", "case1"]
    for name in ("serve.prep_wait", "serve.tail_wait", "serve.call"):
        assert len(_named(rec, name)) == 1
    assert rec.counters == {"serve.cases": 2}
    children = {"serve.preprocess": ["serve.read", "serve.crop", "serve.resample",
                                     "serve.normalize"],
                "serve.finish": ["serve.restore", "serve.argmax", "serve.export"]}
    for parent, names in children.items():
        for p in _named(rec, parent):
            kids = sorted((s for s in rec.spans if s.parent == p.id), key=lambda s: s.start_ns)
            assert [s.name for s in kids] == names
            assert all(s.ids == p.ids for s in kids)
    call = _named(rec, "serve.call")[0]
    waits = [_named(rec, n)[0] for n in ("serve.prep_wait", "serve.tail_wait")]
    assert all(w.parent == call.id for w in waits)
    assert {s.name for s in rec.spans if s.name.startswith("sw.")} == {
        "sw.pad_stack", "sw.upload", "sw.overlap_add", "sw.download"}


@pytest.mark.cuda
def test_shared_clock_against_the_device_trace():
    """A span around a ``torch.cuda._sleep`` kernel and a synchronize,
    mapped onto a device-only profiler trace by the recording's clock pair,
    covers the kernel with each edge within 200 us; its ``device_ms`` is
    the kernel's traced duration to 5%."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    torch.cuda.init()
    cycles = 50_000_000                              # some tens of ms
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with tracing.recording() as rec:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):                       # the trace's first launches
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            with tracing.span("sleep", device=True):
                torch.cuda._sleep(cycles)
                torch.cuda.synchronize()
    span = rec.on_trace(prof.profiler.kineto_results.trace_start_ns())[0]
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and "spin" in e.name]
    k = max(kernels, key=lambda e: e.time_range.end - e.time_range.start)
    k0, k1 = k.time_range.start, k.time_range.end
    print(f"span {span['start_us']:.1f}-{span['end_us']:.1f} us, kernel {k0:.1f}-{k1:.1f} "
          f"us, device_ms {span['device_ms']:.4f}")
    assert 0 <= k0 - span["start_us"] <= 200
    assert 0 <= span["end_us"] - k1 <= 200
    assert span["device_ms"] == pytest.approx((k1 - k0) / 1e3, rel=0.05)
