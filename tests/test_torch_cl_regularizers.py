"""The port's regularizing and freezing trainers against the JAX package's on
the CPU, at the widths of ``test_torch_cl_sequence.py`` (4 -> 16 features,
patch 16^3, f32, no augmentation), each run module-scoped and shared:

  * EWC over three tasks (A, B and a third synthetic task C made here) and
    RW over two (``fisher_update_after=2``), from the JAX run's initial
    parameters: per-epoch losses to 1e-4 relative, parameters to 1e-4, the
    fisher and the anchors (bf16) within one bf16 ulp of JAX's, RW's
    running state to 1e-4 and its update on the iterations its gate
    predicts (0, 2, 4, 6);
  * the penalty on task C sums the anchors of A and B; a new task's seg
    head carries the old head's keys, so the penalty reaches it;
  * every checkpoint keeps ``cl_state`` (``has_cl_state`` and the anchor
    dtype in the manifest), and a checkpoint without one still loads;
  * a task interrupted after its first epoch and resumed from
    ``model_latest`` restores the anchors bit for bit and gives JAX's
    losses (EWC and RW).  The JAX package's own ``restore_trainer`` drops
    EWC's anchors and returns RW's score sets as a dict (ROADMAP Queue 3):
    its side is given the checkpoint's state as its trainer keeps it;
  * the freezing masks (``frozen_body_seq``, ``froz_ewc --adaptive``, and
    on a depth-1 ViT-U-Net ``frozen_vit`` / ``frozen_nonln`` /
    ``frozen_unet`` / ``froz_ewc`` and the regularized keys of ``ewc_vit``
    / ``ewc_unet`` / ``ewc_ln``) are JAX's on mapped keys; a frozen body
    trains bit for bit unchanged."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lifelong_nnunet_tpu.models import multihead as jmh
from lifelong_nnunet_tpu.ops import cl_losses as jcl
from lifelong_nnunet_tpu.planning.plans import Plans as JaxPlans, plans_path
from lifelong_nnunet_tpu.training import checkpoints as jax_checkpoints
from lifelong_nnunet_tpu.training import trainers as jtrainers
from lifelong_nnunet_tpu.training.restore import restore_trainer as jax_restore_trainer
from lifelong_nnunet_tpu.training.trainer import TrainerOptions as JaxOptions
from lifelong_nnunet_tpu_torch.models.convert import (jax_cl_state_to_torch, jax_key_map,
                                                      jax_params_to_state_dict)
from lifelong_nnunet_tpu_torch.ops import cl_losses as pcl
from lifelong_nnunet_tpu_torch.planning.plans import Plans
from lifelong_nnunet_tpu_torch.run.plan_and_preprocess import plan_and_preprocess
from lifelong_nnunet_tpu_torch.training import checkpoints
from lifelong_nnunet_tpu_torch.training import trainers as ptrainers
from lifelong_nnunet_tpu_torch.training.restore import restore_trainer
from lifelong_nnunet_tpu_torch.training.trainer import TrainerOptions
from lifelong_nnunet_tpu_torch.training.trainers.ewc import EWCTrainer
from lifelong_nnunet_tpu_torch.training.trainers.rw import RWTrainer
from lifelong_nnunet_tpu_torch.utilities.synthetic import make_synthetic_task

torch.set_num_threads(4)

A, B, C = "Task097_SynthA", "Task098_SynthB", "Task099_SynthC"
KW = dict(num_epochs=2, iters_per_epoch=2, val_iters=1, save_every=1, augment=False,
          patch_size=(16, 16, 16), base_num_features=4, max_num_features=16)
TOL = 1e-4
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def env(synthetic_task, synthetic_task_b, tmp_path_factory):
    root = tmp_path_factory.mktemp("cl_reg")
    task_c = make_synthetic_task(str(root / "rawc"), task_name=C, num_cases=6, seed=11,
                                 intensity_shift=-0.6)
    pre = root / "pre"
    plan_and_preprocess([synthetic_task, synthetic_task_b, task_c], str(pre),
                        configs=("3d_fullres",), verbose=False)
    return {"root": root, "jplans": JaxPlans.load(plans_path(str(pre / A))),
            "plans": Plans.load(plans_path(str(pre / A))),
            "stage": {t: str(pre / t / "nnUNetData_plans_v2.1_3d_fullres") for t in (A, B, C)}}


def _train(trainer, env, folder, tasks):
    for t in tasks:
        trainer.set_output_folder(str(folder / t))
        trainer.train_task(t, env["stage"][t])
    return trainer


def _port(cls, env, folder, init, **hyper):
    trainer = cls(env["plans"], "3d_fullres", str(folder / A),
                  TrainerOptions(device="cpu", **KW), **hyper)
    trainer.model.load_state_dict(jax_params_to_state_dict(init, trainer.model))
    return trainer


class GateRecordingRW(RWTrainer):
    """RW recording, per train step, the iteration counter and whether the
    running state was updated."""

    def cl_state_update(self):
        inner = super().cl_state_update()
        self.updates = getattr(self, "updates", [])

        def update(cl_state, model, loss):
            out = inner(cl_state, model, loss)
            self.updates.append((cl_state["running"]["iter"],
                                 out["running"]["fisher"] is not cl_state["running"]["fisher"]))
            return out
        return update


PAIRS = {"ewc": (jtrainers.EWCTrainer, EWCTrainer, (A, B, C), {}),
         "rw": (jtrainers.RWTrainer, GateRecordingRW, (A, B), {"fisher_update_after": 2})}


@pytest.fixture(scope="module")
def runs(env):
    """{method: (JAX trainer, port trainer, port folder)}: EWC over A, B, C
    and RW over A, B, the port from the JAX run's initial parameters."""
    out = {}
    for ext, (jcls, pcls, tasks, hyper) in PAIRS.items():
        jfolder, pfolder = env["root"] / ext / "jax", env["root"] / ext / "port"
        jtr = _train(jcls(env["jplans"], "3d_fullres", str(jfolder / A), JaxOptions(**KW),
                          **hyper), env, jfolder, tasks)
        mh, _, _ = jax_checkpoints.load_checkpoint(str(jfolder / A / "before_training"))
        ptr = _train(_port(pcls, env, pfolder, mh.assemble(), **hyper), env, pfolder, tasks)
        out[ext] = (jtr, ptr, pfolder)
    return out


def _assert_same_params(jtr, ptr):
    for t in jtr.mh.tasks:
        want = jax_params_to_state_dict(jtr.mh.assemble(t), ptr.model)
        for name, value in ptr.mh.assemble(t).items():
            assert (value - want[name]).abs().max().item() <= TOL, (t, name)


def _assert_same_losses(plog, jlog):
    assert [(e["task"], e["epoch"]) for e in plog] == [(e["task"], e["epoch"]) for e in jlog]
    for a, b in zip(plog, jlog):
        np.testing.assert_allclose([a["tr_loss"], a["val_loss"]],
                                   [b["tr_loss"], b["val_loss"]], rtol=TOL)


def _within_one_bf16_ulp(got: torch.Tensor, want: torch.Tensor, what, floor: float = 0.0):
    """Both bf16: |got - want| at most one bf16 ulp of the larger of the two,
    plus ``floor`` times the tensor's largest value."""
    assert got.dtype == want.dtype == torch.bfloat16, what
    g, w = got.float(), want.float()
    big = torch.maximum(g.abs(), w.abs())
    ulp = torch.where(big > 0, torch.exp2(torch.floor(torch.log2(big)) - 7),
                      torch.zeros_like(big))
    excess = (g - w).abs() - ulp - floor * big.max()
    worst = excess.max().item()
    assert worst <= 0, (f"{what}: {worst:.3e} beyond one bf16 ulp, "
                        f"{worst / big.max().item():.3e} of the tensor's largest, "
                        f"{int((excess > 0).sum())} of {excess.numel()}")


def _assert_ewc_anchors_match(got: dict, want: dict):
    """{task: {"fisher", "params"}} of both packages within one bf16 ulp.
    A fisher entry near 0 is the square of a gradient that cancels in its
    sums, so its f32 value carries roundoff of the tensor's scale: the
    fisher may differ by 1e-6 of its tensor's largest entry beyond the
    ulp."""
    for t in got:
        for part in ("fisher", "params"):
            for k, v in got[t][part].items():
                if k.endswith("conv.bias"):
                    # a conv bias under InstanceNorm has no gradient in exact
                    # arithmetic: it stays at its initial 0, and both fishers
                    # and both anchors are roundoff residue
                    limit = 1e-12 if part == "fisher" else 1e-6
                    assert max(v.abs().max(), want[t][part][k].abs().max()) < limit, k
                    continue
                _within_one_bf16_ulp(v, want[t][part][k], (t, part, k),
                                     floor=1e-6 if part == "fisher" else 0.0)


@pytest.mark.parametrize("ext", sorted(PAIRS))
def test_runs_give_the_jax_trainers_losses_and_parameters(runs, ext):
    jtr, ptr, _ = runs[ext]
    tasks = PAIRS[ext][2]
    assert ptr.mh.tasks == jtr.mh.tasks == list(tasks)
    _assert_same_losses(ptr._epoch_log, jtr._epoch_log)
    assert ptr.global_step == jtr.global_step == 4 * len(tasks)
    _assert_same_params(jtr, ptr)


def test_ewc_fisher_and_anchors_are_jax_within_one_bf16_ulp(runs):
    jtr, ptr, _ = runs["ewc"]
    want = jax_cl_state_to_torch(jtr.cl_state, jtr.mh.assemble(A), ptr.model)["ewc_tasks"]
    got = ptr.cl_state["ewc_tasks"]
    assert list(got) == list(want) == [A, B, C]
    for t in got:
        for part in ("fisher", "params"):
            assert sorted(got[t][part]) == sorted(ptr.model.state_dict()), (t, part)
    _assert_ewc_anchors_match(got, want)
    # the fisher is 0 only where the base loss has no gradient: the conv
    # biases under InstanceNorm and the coarsest seg head (loss weight 0)
    zero = {k for k, v in got[A]["fisher"].items() if v.float().abs().max() == 0}
    assert {k for k in zero if not k.endswith("conv.bias")} <= {"seg0.weight", "seg0.bias"}


def test_rw_state_is_jax_and_updates_on_its_gate(runs):
    jtr, ptr, _ = runs["rw"]
    want = jax_cl_state_to_torch(jtr.cl_state, jtr.mh.assemble(A), ptr.model)
    got = ptr.cl_state
    assert got["running"]["iter"] == want["running"]["iter"] == 8
    assert got["num_tasks_done"] == want["num_tasks_done"] == 2
    torch.testing.assert_close(got["running"]["prev_loss"], want["running"]["prev_loss"],
                               rtol=TOL, atol=0)
    for part in ("fisher", "scores", "prev_params"):
        for k, v in got["running"][part].items():
            torch.testing.assert_close(v, want["running"][part][k], rtol=TOL, atol=1e-7,
                                       msg=f"running {part} {k}")
    for part in ("fisher", "scores", "params"):
        for k, v in got["anchor"][part].items():
            assert v.dtype == torch.float32, (part, k)
            torch.testing.assert_close(v, want["anchor"][part][k], rtol=TOL, atol=1e-6,
                                       msg=f"anchor {part} {k}")
    assert len(got["score_sets"]) == len(want["score_sets"]) == 2
    for i, s in enumerate(got["score_sets"]):
        for k, v in s.items():
            _within_one_bf16_ulp(v, want["score_sets"][i][k], ("score_sets", i, k))
    # updated on iterations 0, 2, 4, 6 of the 8, never on the others; the
    # first update's dloss (0 - loss) is negative, so it adds no score
    assert ptr.updates == [(i, i % 2 == 0) for i in range(8)]
    first = ptr.cl_state["score_sets"][0]
    assert all(torch.isfinite(v.float()).all() for v in first.values())


def _ewc_state_of(base):
    """A port checkpoint's registry and cl_state."""
    mh, blob, manifest = checkpoints.load_registry(str(base), CPU, [])
    return mh, blob.get("cl_state"), manifest


def test_every_checkpoint_keeps_the_ewc_state(runs):
    _, ptr, folder = runs["ewc"]
    tasks = {A: [], B: [A], C: [A, B]}
    for t, before in tasks.items():
        for name, anchored in (("before_training", before), ("model_latest", before),
                               ("model_final_checkpoint", before + [t])):
            _, cl, manifest = _ewc_state_of(folder / t / name)
            assert manifest["has_cl_state"] and manifest["anchor_dtype"] == "bfloat16"
            assert list(cl["ewc_tasks"]) == anchored, (t, name)
            for a in anchored:
                for part in ("fisher", "params"):
                    for k, v in cl["ewc_tasks"][a][part].items():
                        assert v.dtype == torch.bfloat16
                        assert torch.equal(v, ptr.cl_state["ewc_tasks"][a][part][k]), (t, name)


def test_the_penalty_on_c_sums_the_anchors_of_a_and_b(runs):
    """At task C's first parameters: lam/2 (F_A d_A^2 + F_B d_B^2), as the
    JAX package computes it from its own checkpoint of that moment."""
    jtr, ptr, folder = runs["ewc"]
    mh, cl, _ = _ewc_state_of(folder / C / "before_training")
    params = mh.assemble(C)
    parts = [pcl.ewc_penalty(params, {t: cl["ewc_tasks"][t]}, 0.4).item() for t in (A, B)]
    named = {k: torch.nn.Parameter(v) for k, v in params.items()}
    both, _ = pcl.QuadraticPenalty(named, [{"weight": s["fisher"], "params": s["params"]}
                                           for s in cl["ewc_tasks"].values()], 0.4)()
    assert min(parts) > 0
    assert both.item() == pytest.approx(sum(parts), rel=1e-6)
    jmh_c, blob, _ = jax_checkpoints.load_checkpoint(
        str(folder.parent / "jax" / C / "before_training"))
    want = jcl.ewc_penalty(jmh.flatten(jmh_c.assemble(C)), blob["cl_state"]["ewc_tasks"], 0.4)
    assert sorted(blob["cl_state"]["ewc_tasks"]) == [A, B]
    assert both.item() == pytest.approx(float(want), rel=TOL)


def test_a_new_head_is_held_by_the_old_heads_anchors(runs):
    """EWC starts head B at ``state_init``; A's anchors are keyed by the
    assembled model's keys, so head B's seg keys carry head A's anchors and
    the penalty's gradient reaches them (as in the JAX package)."""
    jtr, ptr, folder = runs["ewc"]
    mh, cl, _ = _ewc_state_of(folder / B / "before_training")
    seg = sorted(mh.heads[B])
    assert seg and all(k.startswith("seg") for k in seg)
    assert set(seg) <= set(cl["ewc_tasks"][A]["fisher"])
    jseg = {jax_key_map(jtr.mh.assemble(A), ptr.model)[k] for k in seg}
    assert jseg <= set(jtr.cl_state["ewc_tasks"][A]["fisher"])
    named = {k: torch.nn.Parameter(v.clone()) for k, v in mh.assemble(B).items()}
    pen = pcl.QuadraticPenalty(named, [{"weight": cl["ewc_tasks"][A]["fisher"],
                                        "params": cl["ewc_tasks"][A]["params"]}], 0.4)
    pen()
    pen.add_grad()
    assert any(named[k].grad.abs().max() > 0 for k in seg)


def _jax_cl_state(base):
    """A JAX checkpoint's cl_state as its trainer keeps it in memory."""
    _, blob, _ = jax_checkpoints.load_checkpoint(str(base))
    cl = jax.tree_util.tree_map(jnp.asarray, blob["cl_state"])
    if "ewc_tasks" in cl:
        return {"ewc_tasks": dict(cl["ewc_tasks"])}
    sets = cl["score_sets"]
    sets = [sets[k] for k in sorted(sets, key=int)] if isinstance(sets, dict) else list(sets)
    return {**cl, "score_sets": sets, "num_tasks_done": int(cl["num_tasks_done"])}


@pytest.mark.parametrize("ext", sorted(PAIRS))
def test_mid_task_resume_restores_the_state_and_gives_the_jax_losses(runs, env, ext):
    """From A's final checkpoint, one epoch of B, then B resumed from its
    ``model_latest`` at epoch 1 with the optimizer.  The resumed trainer
    holds A's state bit for bit as the checkpoint after A had it; its next
    epoch's losses, its parameters and its state after B are JAX's."""
    _, _, pfolder = runs[ext]
    jfolder = pfolder.parent / "jax"
    hyper = {"fisher_update_after": 2} if ext == "rw" else {}

    def interrupted(restore, folder, fix=None):
        tr = restore(str(folder / A / "model_final_checkpoint"))
        if fix is not None:
            tr.cl_state = fix(folder / A / "model_final_checkpoint")
            for k, v in hyper.items():     # the JAX manifest keeps rw_lambda only
                setattr(tr, k, v)
        tr.set_output_folder(str(folder / "resume" / B))
        tr.train_task(B, env["stage"][B], num_epochs=1)
        return str(folder / "resume" / B / "model_latest")

    port_latest = interrupted(lambda b: restore_trainer(b, TrainerOptions(device="cpu", **KW)),
                              pfolder)
    jax_latest = interrupted(lambda b: jax_restore_trainer(b, JaxOptions(**KW)), jfolder,
                             fix=_jax_cl_state)
    ptr = restore_trainer(port_latest, TrainerOptions(device="cpu", **KW), restore_opt=True)
    jtr = jax_restore_trainer(jax_latest, JaxOptions(**KW), restore_opt=True)
    jtr.cl_state = _jax_cl_state(jax_latest)
    for k, v in hyper.items():       # the JAX manifest keeps rw_lambda only
        assert getattr(ptr, k) == v
        setattr(jtr, k, v)
    assert type(ptr) is ptrainers.get_trainer(ext)
    assert (ptr.epoch, ptr.global_step, ptr.optimizer.step_count) == (0, 6, 2)
    # A's state, as the final checkpoint of A holds it
    _, after_a, _ = _ewc_state_of(pfolder / A / "model_final_checkpoint")
    if ext == "ewc":
        assert list(ptr.cl_state["ewc_tasks"]) == [A]
        held = [(after_a["ewc_tasks"][A], ptr.cl_state["ewc_tasks"][A])]
    else:
        assert ptr.cl_state["num_tasks_done"] == 1 and ptr.cl_state["running"]["iter"] == 6
        held = [(after_a["anchor"], ptr.cl_state["anchor"])]
    for was, now in held:
        for part, tensors in was.items():
            for k, v in tensors.items():
                assert torch.equal(now[part][k], v), (part, k)
    ptr.train_task(B, env["stage"][B], start_epoch=1)
    jtr.train_task(B, env["stage"][B], start_epoch=1)
    _assert_same_losses(ptr._epoch_log, jtr._epoch_log)
    assert [e["epoch"] for e in ptr._epoch_log] == [1]
    assert ptr.global_step == jtr.global_step == 8 and ptr.optimizer.step_count == 4
    _assert_same_params(jtr, ptr)
    want = jax_cl_state_to_torch(jtr.cl_state, jtr.mh.assemble(A), ptr.model)
    if ext == "ewc":
        assert list(ptr.cl_state["ewc_tasks"]) == [A, B]
        _assert_ewc_anchors_match(ptr.cl_state["ewc_tasks"], want["ewc_tasks"])
    else:
        for part in ("fisher", "scores"):
            for k, v in ptr.cl_state["anchor"][part].items():
                torch.testing.assert_close(v, want["anchor"][part][k], rtol=TOL, atol=1e-6,
                                           msg=f"anchor {part} {k}")


def test_a_checkpoint_without_cl_state_still_loads(env, runs, tmp_path):
    """A Sequential checkpoint written without ``cl_state`` (as before the
    regularizing trainers) restores with the trainer's fresh state."""
    _, ptr, folder = runs["ewc"]
    base = tmp_path / "model_final_checkpoint"
    checkpoints.save_registry(str(base), ptr.mh, ptr.manifest())
    mh, blob, manifest = checkpoints.load_registry(str(base), CPU, [])
    assert "cl_state" not in blob and not manifest["has_cl_state"]
    tr = restore_trainer(str(base), TrainerOptions(device="cpu"))
    assert type(tr) is EWCTrainer and tr.cl_state == {"ewc_tasks": {}}
    assert tr.mh.tasks == [A, B, C]


# ---------------------------------------------------------------- masks
def _pair_at_second_task(env, ext, tmp_path, vit, **hyper):
    """The JAX and port trainers of ``ext`` with A initialized and B added,
    as ``train_task(B)`` has them before ``before_task``."""
    opts = dict(KW, use_vit=vit, vit_depth_override=1 if vit else None)
    jtr = jtrainers.get_trainer(ext)(env["jplans"], "3d_fullres", str(tmp_path / "j"),
                                     JaxOptions(**opts), **hyper)
    ptr = ptrainers.get_trainer(ext)(env["plans"], "3d_fullres", str(tmp_path / "p"),
                                     TrainerOptions(device="cpu", **opts), **hyper)
    for tr in (jtr, ptr):
        tr._ensure_initialized(A)
        assert tr.trainable_mask() is None          # nothing frozen on the first task
        tr.mh = tr.mh.add_new_task(B, use_init=not tr.TRANSFER_HEADS)
    return jtr, ptr, jax_key_map(jtr.mh.assemble(), ptr.model)


def _mapped(mask, key_map):
    return {key_map[k]: v for k, v in mask.items()}


@pytest.mark.parametrize("ext,vit,frozen", [
    ("frozen_body_seq", False, "body"), ("froz_ewc", False, "none"),
    ("frozen_vit", False, "none"), ("frozen_unet", False, "all"),
    ("frozen_nonln", False, "all"), ("frozen_vit", True, "vit"),
    ("frozen_unet", True, "not_vit"), ("frozen_nonln", True, "not_vit_norm"),
    ("froz_ewc", True, "vit")])
def test_freezing_masks_are_jax_on_mapped_keys(env, tmp_path, ext, vit, frozen):
    jtr, ptr, key_map = _pair_at_second_task(env, ext, tmp_path, vit)
    got = ptr.trainable_mask()
    assert _mapped(got, key_map) == jmh.flatten(jtr.trainable_mask())
    want_frozen = {"body": lambda k: k in ptr.mh.body, "none": lambda k: False,
                   "all": lambda k: True, "vit": lambda k: k.startswith("vit."),
                   "not_vit": lambda k: not k.startswith("vit."),
                   "not_vit_norm": lambda k: not (k.startswith("vit.") and "norm" in k)}
    assert {k: not v for k, v in got.items()} == \
        {k: want_frozen[frozen](k) for k in ptr.model.state_dict()}


@pytest.mark.parametrize("ext,subset", [("ewc_vit", "vit"), ("ewc_unet", "not_vit"),
                                        ("ewc_ln", "vit_norm"), ("ewc", "all")])
def test_ewc_variants_regularize_jax_keys(env, tmp_path, ext, subset):
    jtr, ptr, key_map = _pair_at_second_task(env, ext, tmp_path, True)
    got = ptr._mask()
    want = jtr._mask(jtr.mh.assemble())
    if subset == "all":
        assert got is None and want is None
        return
    assert _mapped(got, key_map) == jmh.flatten(want)
    pick = {"vit": lambda k: k.startswith("vit."), "not_vit": lambda k: not k.startswith("vit."),
            "vit_norm": lambda k: k.startswith("vit.") and "norm" in k}[subset]
    assert got == {k: pick(k) for k in ptr.model.state_dict()} and any(got.values())


@pytest.mark.parametrize("adaptive", [False, True])
def test_froz_ewc_lambda_on_the_frozen_task(env, tmp_path, adaptive):
    jtr, ptr, _ = _pair_at_second_task(env, "froz_ewc", tmp_path, False, adaptive=adaptive,
                                       ewc_lambda=0.4)
    for tr in (jtr, ptr):
        tr.before_task(B)
    want = 0.4 * math.exp(-1.0 / 3.0) if adaptive else 0.4
    assert ptr.ewc_lambda == pytest.approx(want, rel=1e-12)
    assert jtr.ewc_lambda == pytest.approx(want, rel=1e-12)
    assert ptr.hyperparams == {"adaptive": adaptive, "ewc_lambda": 0.4}


def test_a_frozen_body_trains_unchanged(env, tmp_path):
    """``frozen_body_seq`` over A and B: B's body is A's bit for bit, its
    head moved, and a task-B checkpoint resumes with the mask."""
    tr = ptrainers.get_trainer("frozen_body_seq")(
        env["plans"], "3d_fullres", str(tmp_path / A), TrainerOptions(device="cpu", **KW))
    _train(tr, env, tmp_path, (A,))
    body_a = {k: v.clone() for k, v in tr.mh.body.items()}
    head_a = {k: v.clone() for k, v in tr.mh.heads[A].items()}
    _train(tr, env, tmp_path, (B,))
    for k, v in tr.mh.body.items():
        assert torch.equal(v, body_a[k]), k
    assert any(not torch.equal(v, head_a[k]) for k, v in tr.mh.heads[B].items())
    again = restore_trainer(str(tmp_path / B / "model_latest"),
                            TrainerOptions(device="cpu", **KW), restore_opt=True)
    assert len(again.optimizer.params) == len(tr.mh.heads[B])
