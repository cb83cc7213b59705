"""The train cells: the port's ``MultiHeadTrainer`` (the trainer of
``nnUNet_torch_train_multihead``) on a synthetic task written from the
seed, stepped as the body of its ``train_task`` steps it: the
``Prefetcher``'s next batch (the ``PatchSampler``'s, on its thread), then
the trainer's train step (moreDA on the device, forward, deep-supervision
Dice + CE, backward, ``PolySGD``), on the default kernel route in bf16.

Set-up runs the first ``CHECK_STEPS`` steps through that call and feed and
keeps what the check needs (the sampled batches, the losses, the first
momentum buffers, the parameters after the last of them), then
``WARM_STEPS`` more; the window then steps the same trainer for
``--seconds``.  No validation or checkpoint falls in it.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from lifelong_nnunet_tpu_torch.data.pipeline import Prefetcher
from lifelong_nnunet_tpu_torch.ops.kernels.conv3d import conv3d_dx_cf, conv3d_in_lrelu_cf
from lifelong_nnunet_tpu_torch.ops.kernels.instance_norm import (
    instance_norm_leaky_bwd_cf, instance_norm_leaky_cf)
from lifelong_nnunet_tpu_torch.planning.plans import Plans
from lifelong_nnunet_tpu_torch.training.trainer import MultiHeadTrainer, TrainerOptions

from .. import arithmetic, data
from ..reference import inputs, model, train
from ..topology import ds_factors
from . import common

TASK = "Task900_BenchKiTS"
CHECK_STEPS, WARM_STEPS = 3, 5
# the traced window; then a short trace with the host's spans, which only
# names the idle gaps (tracing the host slows it)
TRACE_STEPS, GAP_STEPS = 40, 10
# an epoch longer than any window: no validation or checkpoint in it
ITERS_PER_EPOCH = 10 ** 6
# the trainer's seeds (``training/trainer.py``: ``SEED`` 0 seeds the
# augmentation's generator; ``_make_sampler`` seeds the first task's
# training sampler with ``SEED + 1``), which the reference draws again
AUGMENT_SEED, SAMPLER_SEED = 0, 1


def _plans(run) -> Plans:
    path = os.path.join(run.tmp, "plans.json")
    with open(path, "w") as f:
        json.dump(run.config["plans"], f)
    return Plans.load(path)


def setup(run):
    cname = run.config["config_name"]
    t = run.traffic
    stage = os.path.join(run.tmp, TASK, f"nnUNetData_plans_v2.1_{cname}")
    names = data.write_stage(stage, run.config, t["case_shapes"], run.seed, run.device)
    opts = TrainerOptions(num_epochs=1000, iters_per_epoch=ITERS_PER_EPOCH, fold=-1,
                          device=str(run.device))
    trainer = MultiHeadTrainer(_plans(run), cname, os.path.join(run.tmp, "out"), opts)
    layers = model.layers_for(run.config, True)
    params0 = model.init_params(layers, run.seed, run.device)
    common.load_params(trainer.model, params0)
    trainer.register_task_data(TASK, stage)
    trainer._ensure_initialized(TASK)
    trainer.mh = trainer.mh.add_new_task(TASK, use_init=not trainer.TRANSFER_HEADS)
    trainer.before_task(TASK)
    trainer._build_step()
    prefetch = Prefetcher(trainer._make_sampler(TASK, True, len(trainer.mh.tasks)),
                          trainer.device)
    s = {"trainer": trainer, "prefetch": prefetch, "stage": stage, "names": names,
         "layers": layers, "params0": params0, "batches": [], "losses": []}
    opt = trainer.optimizer
    for k in range(CHECK_STEPS):
        batch, _ = prefetch.next()
        s["batches"].append({n: v.clone() for n, v in batch.items()})
        trainer.cl_state, m = trainer._train_step(trainer.cl_state, batch)
        s["losses"].append(m["loss"])
        if k == 0:
            # a step that left the optimizer without state holds no update
            s["first"] = {n: opt.opt.state.get(p, {}).get("momentum_buffer",
                                                           torch.zeros_like(p)).clone()
                          for n, p in zip(opt.names, opt.params)}
    s["after"] = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    return s


def warm(run, s):
    for _ in range(WARM_STEPS):
        step(s)


def step(s):
    trainer = s["trainer"]
    batch, _ = s["prefetch"].next()
    trainer.cl_state, m = trainer._train_step(trainer.cl_state, batch)
    return m["loss"]


def window(run, s):
    cuda = run.device.type == "cuda"
    events, losses, wait = [], [], 0.0
    if cuda:
        events.append(torch.cuda.Event(enable_timing=True))
        events[0].record()
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        batch, _ = s["prefetch"].next()
        wait += time.perf_counter() - a
        trainer = s["trainer"]
        trainer.cl_state, m = trainer._train_step(trainer.cl_state, batch)
        losses.append(m["loss"])
        if cuda:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        if time.perf_counter() - t0 >= run.seconds:
            break
    if cuda:
        torch.cuda.synchronize(run.device)
    elapsed = time.perf_counter() - t0
    n = len(losses)
    run.attempted = n
    run.failed = int((~torch.isfinite(torch.stack(losses).float())).sum())
    run.e2e["train_step_ms"] = 1e3 * elapsed / n
    if cuda:
        gaps = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        run.e2e["train_step_p95_ms"] = float(np.percentile(gaps, 95))
    run.stats.update(steps=n, window_s=elapsed, step_s=elapsed / n, input_wait_s=wait,
                     batch=run.batch, train=True)


COUNTERS = {"conv3d_fused": (conv3d_in_lrelu_cf, conv3d_dx_cf),
            "instance_norm": (instance_norm_leaky_cf, instance_norm_leaky_bwd_cf)}


def traced(run, s):
    before = common.launches(COUNTERS)
    run.stats["trace"] = common.profile(lambda: [step(s) for _ in range(TRACE_STEPS)],
                                        run.device,
                                        lambda: [step(s) for _ in range(GAP_STEPS)])
    run.stats["trace"]["steps"] = TRACE_STEPS
    got = {n: v - before[n] for n, v in common.launches(COUNTERS).items()}
    k = TRACE_STEPS + GAP_STEPS
    want = {"conv3d_fused": k * len(arithmetic.conv3d_fused_launches(run.config, run.batch, True)),
            "instance_norm": k * len(arithmetic.instance_norm_launches(run.config, run.batch,
                                                                       True))}
    common.require_launches(got, want, run.device)


def check(run, s):
    s["prefetch"].stop()
    losses = [float(v) for v in s["losses"]]
    first = s["first"]
    del s["trainer"], s["prefetch"]
    common.free(run.device)
    t = run.traffic
    cfg = run.config["plans"]["configurations"][run.config["config_name"]]
    arrays = [np.load(os.path.join(s["stage"], f"{n}.npy"), mmap_mode="r") for n in s["names"]]
    locs = []
    for n in s["names"]:
        with np.load(os.path.join(s["stage"], f"{n}.classlocs.npz")) as z:
            locs.append({int(c): z[c] for c in z.files})
    sampler = inputs.Sampler(arrays, locs, cfg["patch_size"], run.batch,
                             t["oversample_foreground"], SAMPLER_SEED)
    s["ref_batches"] = [sampler.next_batch() for _ in s["batches"]]
    mismatch = 0
    for prog, (d, g) in zip(s["batches"], s["ref_batches"]):
        mismatch += int((prog["data"].cpu().numpy() != d).sum())
        mismatch += int((prog["seg"].cpu().numpy() != g).sum())
    run.check("batch_mismatch", mismatch)
    s["factors"] = ds_factors(cfg)
    s["ref"] = reference_steps(run, s)
    s["keep"] = train.moving_leaves(s["ref"]["first_update"], s["params0"])
    p0 = s["params0"]
    prog = {"losses": losses, "first_update": first,
            "change": {n: s["after"][n] - p0[n] for n in p0}}
    found = gaps(s, prog)
    for name in run.cell["limits"]:
        if name in found:
            run.check(name, found[name])
    run.stats["check"] = dict(found, ref_losses=s["ref"]["losses"], losses=losses,
                              leaves_kept=len(s["keep"]), leaves=len(p0))


def reference_steps(run, s, **kw) -> dict:
    """``train.run_steps`` on the sampled batches, float32 with TF32 off,
    augmented by a generator seeded as the trainer seeds its own."""
    gen = torch.Generator(device=run.device).manual_seed(AUGMENT_SEED)
    with model.no_tf32():
        return train.run_steps(s["params0"], s["ref_batches"], s["layers"], s["factors"], gen,
                               ITERS_PER_EPOCH, **kw)


def gaps(s, other: dict) -> dict:
    """The compared numbers of a run (the program's, or the reference's in
    its place) against the float32 reference, with what a look at them
    needs: the worst leaf and the median leaf's gap."""
    ref, keep, p0, wd = s["ref"], s["keep"], s["params0"], train.WEIGHT_DECAY
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(other["losses"], ref["losses"])),
           "loss1_gap": abs(other["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])}
    for name, prog, want in (
            ("grad", {n: other["first_update"][n] - wd * p0[n] for n in keep},
             {n: ref["first_update"][n] - wd * p0[n] for n in keep}),
            ("update", other["change"], ref["change"])):
        per = train.leaf_gaps(prog, want, keep)
        worst = max(per, key=per.get)
        out[f"{name}_gap"] = per[worst]
        out[f"{name}_median_gap"] = float(np.median(list(per.values())))
        out[f"{name}_worst"] = f"{worst} ({p0[worst].numel()})"
    return out


def control(run, s) -> dict:
    """The readings that set the upper ends of the limits: the control (the
    reference in float8) and the fault that leaves half of each batch out
    (the loss the mean over the rest), both in the program's place."""
    half = slice(0, max(1, run.batch // 2))
    return {"control_fp8": gaps(s, reference_steps(run, s, quant=True)),
            "half_batch": gaps(s, reference_steps(run, s, rows=half))}
