"""The port's task-sequence layer against the JAX package's on the CPU, at
the widths of ``test_torch_training_e2e.py`` (4 -> 16 features, patch 16^3,
f32, no augmentation): two tasks (the synthetic A and B) trained in one
trainer by Sequential, Rehearsal and MultiHead from the same initial
parameters (the JAX trainer's ``before_training``), one module-scoped run
per trainer and package.  Per-epoch train and validation losses agree to
1e-4 relative and every head and the body to 1e-4; the rehearsal pool is
JAX's case for case; a MultiHead head B starts at ``state_init`` and
training it leaves head A as it was; ``_perform_validation`` gives the same
subjects and Dice/IoU in both modes on the same parameters; a task
interrupted mid-way and resumed from ``model_latest`` gives JAX's losses,
with the poly LR following the optimizer's own step count; the multi-head
registry's helpers match JAX's on mapped keys; checkpoints keep the
registry and still read the single-model format."""

import os
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lifelong_nnunet_tpu.models import multihead as jmh
from lifelong_nnunet_tpu.models.unet import GenericUNet as JaxUNet
from lifelong_nnunet_tpu.planning.plans import Plans as JaxPlans, plans_path
from lifelong_nnunet_tpu.training import checkpoints as jax_checkpoints
from lifelong_nnunet_tpu.training.restore import restore_trainer as jax_restore_trainer
from lifelong_nnunet_tpu.training.trainer import MultiHeadTrainer as JaxMultiHead
from lifelong_nnunet_tpu.training.trainer import TrainerOptions as JaxOptions
from lifelong_nnunet_tpu.training.trainers.rehearsal import RehearsalTrainer as JaxRehearsal
from lifelong_nnunet_tpu.training.trainers.sequential import SequentialTrainer as JaxSequential
from lifelong_nnunet_tpu_torch.models import multihead as pmh
from lifelong_nnunet_tpu_torch.models.convert import jax_params_to_state_dict
from lifelong_nnunet_tpu_torch.models.unet import GenericUNet
from lifelong_nnunet_tpu_torch.planning.plans import Plans
from lifelong_nnunet_tpu_torch.run.plan_and_preprocess import plan_and_preprocess
from lifelong_nnunet_tpu_torch.training import checkpoints
from lifelong_nnunet_tpu_torch.training.optimizer import PolySGD
from lifelong_nnunet_tpu_torch.training.restore import restore_model, restore_trainer
from lifelong_nnunet_tpu_torch.training.trainer import MultiHeadTrainer, TrainerOptions
from lifelong_nnunet_tpu_torch.training.trainers.rehearsal import RehearsalTrainer
from lifelong_nnunet_tpu_torch.training.trainers.sequential import SequentialTrainer

torch.set_num_threads(4)

A, B = "Task097_SynthA", "Task098_SynthB"
KW = dict(num_epochs=2, iters_per_epoch=2, val_iters=1, save_every=1, augment=False,
          patch_size=(16, 16, 16), base_num_features=4, max_num_features=16)
PAIRS = {"sequential": (JaxSequential, SequentialTrainer),
         "rehearsal": (JaxRehearsal, RehearsalTrainer),
         "multihead": (JaxMultiHead, MultiHeadTrainer)}
TOL = 1e-4


@pytest.fixture(scope="module")
def env(synthetic_task, synthetic_task_b, tmp_path_factory):
    root = tmp_path_factory.mktemp("cl_seq")
    pre = root / "pre"
    plan_and_preprocess([synthetic_task, synthetic_task_b], str(pre),
                        configs=("3d_fullres",), verbose=False)
    jplans = JaxPlans.load(plans_path(str(pre / A)))
    plans = Plans.load(plans_path(str(pre / A)))
    assert asdict(plans) == asdict(jplans)
    return {"root": root, "jplans": jplans, "plans": plans,
            "stage": {t: str(pre / t / "nnUNetData_plans_v2.1_3d_fullres") for t in (A, B)}}


def _train(trainer, env, folder, tasks=(A, B)):
    for t in tasks:
        trainer.set_output_folder(str(folder / t))
        trainer.train_task(t, env["stage"][t])
    return trainer


def _jax_init(folder):
    """The JAX run's initial parameters (its first ``before_training``)."""
    mh, _, _ = jax_checkpoints.load_checkpoint(str(folder / A / "before_training"))
    return mh.assemble()


def _port(cls, env, folder, init, **kw):
    trainer = cls(env["plans"], "3d_fullres", str(folder / A),
                  TrainerOptions(device="cpu", **dict(KW, **kw)))
    trainer.model.load_state_dict(jax_params_to_state_dict(init, trainer.model))
    return trainer


@pytest.fixture(scope="module")
def runs(env):
    """{extension: (JAX trainer, port trainer)} after training A then B."""
    out = {}
    for ext, (jcls, pcls) in PAIRS.items():
        jfolder, pfolder = env["root"] / ext / "jax", env["root"] / ext / "port"
        jtr = _train(jcls(env["jplans"], "3d_fullres", str(jfolder / A), JaxOptions(**KW)),
                     env, jfolder)
        ptr = _train(_port(pcls, env, pfolder, _jax_init(jfolder)), env, pfolder)
        out[ext] = (jtr, ptr)
    return out


def _assert_same_params(jtr, ptr):
    for t in jtr.mh.tasks:
        want = jax_params_to_state_dict(jtr.mh.assemble(t), ptr.model)
        for name, value in ptr.mh.assemble(t).items():
            assert (value - want[name]).abs().max().item() <= TOL, (t, name)


@pytest.mark.parametrize("ext", sorted(PAIRS))
def test_two_task_runs_give_the_jax_trainers_losses_and_parameters(runs, ext):
    jtr, ptr = runs[ext]
    assert ptr.mh.tasks == jtr.mh.tasks == [A, B]
    assert [(e["task"], e["epoch"]) for e in ptr._epoch_log] == \
        [(e["task"], e["epoch"]) for e in jtr._epoch_log] == [(A, 0), (A, 1), (B, 0), (B, 1)]
    for a, b in zip(ptr._epoch_log, jtr._epoch_log):
        np.testing.assert_allclose([a["tr_loss"], a["val_loss"]],
                                   [b["tr_loss"], b["val_loss"]], rtol=TOL)
    # the epoch restarts per task, the global step runs on, best_val is
    # the lowest over both tasks
    assert ptr.global_step == jtr.global_step == 8 and ptr.epoch == jtr.epoch == 1
    assert ptr.best_val == pytest.approx(float(jtr.best_val), rel=TOL)
    assert ptr.optimizer.step_count == 4
    _assert_same_params(jtr, ptr)


def test_rehearsal_pool_is_the_jax_pool_case_for_case(runs):
    jtr, ptr = runs["rehearsal"]

    def pool(trainer):
        by_ds = {id(ds): t for t, (ds, _, _) in trainer._datasets.items()}
        return [(by_ds[id(ds)], case) for ds, case in
                trainer._make_sampler(B, True, len(trainer.mh.tasks)).items]

    got = pool(ptr)
    assert got == pool(jtr)
    n_a = len(ptr._datasets[A][1])
    assert got[: len(ptr._datasets[B][1])] == [(B, c) for c in ptr._datasets[B][1]]
    assert len(got) == len(ptr._datasets[B][1]) + max(1, round(0.25 * n_a))
    # validation stays on the current task
    assert ptr._make_sampler(B, False).items == [(ptr._datasets[B][0], c)
                                                 for c in ptr._datasets[B][2]]


def test_multihead_new_head_starts_at_state_init_and_leaves_head_a(runs, env):
    jtr, ptr = runs["multihead"]
    folder = env["root"] / "multihead" / "port"
    before_b, _, _ = checkpoints.load_registry(str(folder / B / "before_training"),
                                               torch.device("cpu"), ptr.model.module_order())
    final_a, _, _ = checkpoints.load_registry(str(folder / A / "model_final_checkpoint"),
                                              torch.device("cpu"), ptr.model.module_order())
    for key, value in before_b.heads[B].items():
        assert torch.equal(value, ptr.mh.state_init[key]), key
        assert torch.equal(value, before_b.state_init[key]), key
    for key, value in ptr.mh.heads[A].items():
        assert torch.equal(value, final_a.heads[A][key]), key
    # the head did train on B
    assert any(not torch.equal(v, ptr.mh.state_init[k]) for k, v in ptr.mh.heads[B].items())


def test_sequential_new_head_starts_at_the_trained_head(runs, env):
    _, ptr = runs["sequential"]
    folder = env["root"] / "sequential" / "port"
    before_b, blob, _ = checkpoints.load_registry(
        str(folder / B / "before_training"), torch.device("cpu"), ptr.model.module_order())
    final_a, _, _ = checkpoints.load_registry(str(folder / A / "model_final_checkpoint"),
                                              torch.device("cpu"), ptr.model.module_order())
    for key, value in before_b.heads[B].items():
        assert torch.equal(value, final_a.heads[A][key]), key
    # a head-transferring trainer's checkpoint leaves state_init out
    assert blob["state_init"] == {}


@pytest.mark.parametrize("mode,kw", [
    ("sliding_window", {}), ("patches", {}),
    ("patches", {"always_use_last_head": True, "call_for_eval": True})],
    ids=["sliding_window", "patches", "eval_with_the_last_head"])
def test_perform_validation_gives_the_jax_metrics(runs, mode, kw):
    """On the same parameters; a call for evaluation windows the whole
    volume with mirroring in either mode."""
    jtr, ptr = runs["sequential"]
    jtr.opts.val_mode = ptr.opts.val_mode = mode
    try:
        got = ptr._perform_validation(tag="check", **kw)
        want = jtr._perform_validation(tag="check", **kw)
    finally:
        jtr.opts.val_mode = ptr.opts.val_mode = "sliding_window"
    assert list(got) == list(want) == [A, B]
    for t in (A, B):
        assert got[t]["head"] == want[t]["head"] == (B if kw else t)
        assert sorted(got[t]["subjects"]) == sorted(want[t]["subjects"])
        for case, metrics in want[t]["subjects"].items():
            assert sorted(got[t]["subjects"][case]) == sorted(metrics)
            for name, values in metrics.items():
                np.testing.assert_allclose(got[t]["subjects"][case][name], values,
                                           atol=1e-5, err_msg=f"{t} {case} {name}")
    # the trained parameters are back in the model
    for name, value in ptr.model.state_dict().items():
        assert torch.equal(value, ptr.mh.assemble()[name]), name
    name = "val_metrics_eval.csv" if kw else "val_metrics.csv"
    assert os.path.isfile(os.path.join(ptr.output_folder, name))


def test_mid_task_resume_gives_the_jax_losses(env, tmp_path):
    """A and one epoch of B, then B resumed from its ``model_latest`` with
    the optimizer: the next epoch's losses as JAX's, and the LR follows the
    optimizer's own count (4 steps into B), not the global step (8)."""
    def interrupted(jtr_or_ptr, folder):
        _train(jtr_or_ptr, env, folder, (A,))
        jtr_or_ptr.set_output_folder(str(folder / B))
        jtr_or_ptr.train_task(B, env["stage"][B], num_epochs=1)

    jfolder, pfolder = tmp_path / "jax", tmp_path / "port"
    interrupted(JaxSequential(env["jplans"], "3d_fullres", str(jfolder / A), JaxOptions(**KW)),
                jfolder)
    interrupted(_port(SequentialTrainer, env, pfolder, _jax_init(jfolder)), pfolder)

    jtr = jax_restore_trainer(str(jfolder / B / "model_latest"), JaxOptions(**KW),
                              restore_opt=True)
    ptr = restore_trainer(str(pfolder / B / "model_latest"),
                          TrainerOptions(device="cpu", **KW), restore_opt=True)
    assert type(ptr) is SequentialTrainer and ptr.mh.tasks == [A, B]
    assert (ptr.epoch, ptr.global_step, ptr.optimizer.step_count) == (0, 6, 2)
    ptr.train_task(B, env["stage"][B], start_epoch=1)
    jtr.train_task(B, env["stage"][B], start_epoch=1)
    assert [e["epoch"] for e in ptr._epoch_log] == [e["epoch"] for e in jtr._epoch_log] == [1]
    np.testing.assert_allclose([ptr._epoch_log[0]["tr_loss"], ptr._epoch_log[0]["val_loss"]],
                               [jtr._epoch_log[0]["tr_loss"], jtr._epoch_log[0]["val_loss"]],
                               rtol=TOL)
    assert ptr.global_step == jtr.global_step == 8 and ptr.optimizer.step_count == 4
    _assert_same_params(jtr, ptr)


def test_poly_sgd_state_round_trips():
    w = torch.nn.Parameter(torch.ones(3))
    opt = PolySGD([w], max_epochs=4, iters_per_epoch=2)
    for _ in range(3):
        w.grad = torch.full((3,), 0.5)
        opt.step()
    state = opt.state_dict()
    w2 = torch.nn.Parameter(w.detach().clone())
    opt2 = PolySGD([w2], max_epochs=4, iters_per_epoch=2)
    opt2.load_state_dict(state)
    assert opt2.step_count == 3 and opt2.lr() == opt.lr()
    for o, p in ((opt, w), (opt2, w2)):
        p.grad = torch.full((3,), 0.25)
        o.step()
    assert torch.equal(w, w2)


def test_a_single_model_checkpoint_still_loads(env, tmp_path):
    """The format a model saved by hand keeps (one full state_dict per
    task) loads for serving and as a registry."""
    model = GenericUNet(1, 3, ((2, 2, 2), (2, 2, 2)), ((3, 3, 3),) * 3, 4, 16)
    sd = model.state_dict()
    base = str(tmp_path / "model_final_checkpoint")
    checkpoints.save_checkpoint(base, {A: sd}, {"split_at": None})
    heads, manifest = checkpoints.load_checkpoint(base, torch.device("cpu"))
    assert list(heads) == [A] and all(torch.equal(heads[A][k], v) for k, v in sd.items())
    mh, blob, _ = checkpoints.load_registry(base, torch.device("cpu"), model.module_order())
    assert mh.tasks == [A] and mh.state_init == {} and "body" not in blob
    body, head = pmh.split_params(sd, "seg_outputs", model.module_order())
    assert sorted(mh.body) == sorted(body) and sorted(mh.heads[A]) == sorted(head)


# ---------------------------------------------------------------- registry
POOLS = ((2, 2, 2), (2, 2, 2))
CONVS = ((3, 3, 3),) * 3
LEAF = {"conv.weight": "Conv_0/kernel", "conv.bias": "Conv_0/bias",
        "norm.weight": "InstanceNorm_0/scale", "norm.bias": "InstanceNorm_0/bias",
        "weight": "kernel", "bias": "bias"}


def _jax_path(key: str) -> str:
    for tail, jtail in LEAF.items():
        if key.endswith("." + tail):
            return key[: -len(tail) - 1].replace(".", "/") + "/" + jtail
    raise KeyError(key)


@pytest.fixture(scope="module")
def registries():
    jmodel = JaxUNet(num_classes=3, pool_op_kernel_sizes=POOLS, conv_kernel_sizes=CONVS,
                     base_num_features=4, max_num_features=16)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 8, 1)))["params"])
    port = GenericUNet(1, 3, POOLS, CONVS, 4, 16)
    sd = jax_params_to_state_dict(params, port)
    return (jmh.MultiHeadParams.create(params, "seg_outputs", jmodel.module_order(), A),
            pmh.MultiHeadParams.create(sd, "seg_outputs", port.module_order(), A), params, sd)


def test_add_n_tasks_and_activate_matches_jax(registries):
    jm, pm, _, _ = registries
    jm = jm.add_n_tasks_and_activate([A, B, "Task099_C"], B)
    pm = pm.add_n_tasks_and_activate([A, B, "Task099_C"], B)
    assert pm.tasks == jm.tasks == [A, B, "Task099_C"] and pm.active_task == jm.active_task == B
    for t in pm.tasks:
        assert sorted(map(_jax_path, pm.heads[t])) == sorted(jm.heads[t])


@pytest.mark.parametrize("freeze_body", [False, True])
def test_trainable_mask_matches_jax(registries, freeze_body):
    jm, pm, _, _ = registries
    got = pm.trainable_mask(freeze_body)
    want = jmh.flatten(jm.trainable_mask(freeze_body))
    assert {_jax_path(k): v for k, v in got.items()} == want
    assert any(got.values()) and (not all(got.values())) == freeze_body


@pytest.mark.parametrize("substrings", [["norm"], ["conv"], ["enc1", "block0"], ["seg"]])
@pytest.mark.parametrize("include", [True, False])
def test_name_filter_mask_matches_jax(registries, substrings, include):
    _, _, params, sd = registries
    got = pmh.name_filter_mask(sd, substrings, include)
    want = jmh.flatten(jmh.name_filter_mask(params, substrings, include))
    assert {_jax_path(k): v for k, v in got.items()} == want
    assert any(got.values()) and not all(got.values())


def test_replace_params_matches_jax(registries):
    _, _, params, sd = registries
    port = GenericUNet(1, 3, POOLS, CONVS, 4, 16)
    got = pmh.replace_params(sd, lambda k: k.startswith("seg"), lambda v: v * 2)
    want = jax_params_to_state_dict(
        jmh.replace_params(params, lambda p: p.startswith("seg"), lambda v: v * 2), port)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
        assert torch.equal(v, sd[k] * 2 if k.startswith("seg") else sd[k]), k


def test_served_heads_are_the_registry_heads(runs, env):
    """``restore_model(head=...)`` loads each head of a sequence's final
    checkpoint; an unknown head raises."""
    _, ptr = runs["sequential"]
    base = str(env["root"] / "sequential" / "port" / B / "model_final_checkpoint")
    for t in (A, B):
        model, _, _ = restore_model(base, torch.device("cpu"), head=t)
        want = ptr.mh.assemble(t)
        for name, value in model.state_dict().items():
            assert torch.equal(value, want[name]), (t, name)
    with pytest.raises(KeyError):
        restore_model(base, torch.device("cpu"), head="Task099_C")
