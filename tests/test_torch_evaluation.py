"""The port's evaluation against the JAX package's on the CPU, on the same
converted checkpoints: the JAX CLI trains LwF over tasks A and B at tiny
widths (4 -> 16 features, patch 16^3, no augmentation, 10 steps an epoch
so the model is not near-uniform, see ``MIN_AGREEMENT``) into its results
tree, and every checkpoint of that tree is converted to the port's format
at the same relative path of a second tree.  Then:

  * ``Evaluator.evaluate_on``: per-subject Dice / IoU to 1e-4, the same
    summary rows (``summarized_val_metrics.csv``) and model summary;
  * ``accuracy_matrix`` over the two stage checkpoints and ``cl_report``'s
    BWT and FWT to 1e-6; ``write_cl_report`` writes them;
  * evaluator2 (``run_evaluation2``): the per-case segmentations (on
    >= 99.9% of voxels, see ``MIN_AGREEMENT``), their scores and the
    reference-layout files, per task and ``legacy_structure``: the same
    files and keys;
  * ``determine_postprocessing``: the same decision (its Dice values to
    1e-3: both round each window's probabilities to bf16), and
    ``nnUNet_torch_inference --postprocess`` applies it;
  * ``nnUNet_torch_evaluate`` and ``nnUNet_torch_evaluate2`` with
    ``--device cpu`` write the JAX CLIs' evaluation trees (the Evaluator's
    values to 1e-4, evaluator2's as above), look for
    ``--task_specific_ln`` models in the ``task_specific`` folder, and
    refuse trainers not ported yet."""

import csv
import json
import os
from collections import OrderedDict

import numpy as np
import pytest
import torch

from lifelong_nnunet_tpu.evaluation import cl_metrics as jcm
from lifelong_nnunet_tpu.evaluation.evaluator import Evaluator as JaxEvaluator
from lifelong_nnunet_tpu.evaluation.evaluator2 import run_evaluation2 as jax_run_evaluation2
from lifelong_nnunet_tpu.inference.postprocessing import (
    determine_postprocessing as jax_determine_postprocessing)
from lifelong_nnunet_tpu.run.run_evaluation import (run_evaluation as jax_cli_evaluate,
                                                    run_evaluation2_cli as jax_cli_evaluate2)
from lifelong_nnunet_tpu.run.run_training import run_training as jax_run_training
from lifelong_nnunet_tpu.training import checkpoints as jax_checkpoints
from lifelong_nnunet_tpu.training.trainer import TrainerOptions as JaxOptions
from lifelong_nnunet_tpu_torch.evaluation import cl_metrics as pcm
from lifelong_nnunet_tpu_torch.evaluation.evaluator import Evaluator
from lifelong_nnunet_tpu_torch.evaluation.evaluator2 import run_evaluation2
from lifelong_nnunet_tpu_torch.evaluation.metrics import subject_metrics
from lifelong_nnunet_tpu_torch.inference.postprocessing import (determine_postprocessing,
                                                                load_postprocessing)
from lifelong_nnunet_tpu_torch.inference.predict import remove_all_but_largest_component
from lifelong_nnunet_tpu_torch.models.convert import jax_params_to_state_dict
from lifelong_nnunet_tpu_torch.models.multihead import MultiHeadParams, split_params
from lifelong_nnunet_tpu_torch.run.plan_and_preprocess import plan_and_preprocess
from lifelong_nnunet_tpu_torch.run.run_evaluation import (run_evaluation,
                                                          run_evaluation2_cli)
from lifelong_nnunet_tpu_torch.run.run_inference import run_inference
from lifelong_nnunet_tpu_torch.training import checkpoints
from lifelong_nnunet_tpu_torch.training.restore import model_from_manifest, plans_from_manifest
from lifelong_nnunet_tpu_torch.training.trainer import TrainerOptions
from lifelong_nnunet_tpu_torch.utilities.imageio import read_image

torch.set_num_threads(4)

A, B = "Task097_SynthA", "Task098_SynthB"
SEQ = f"{A}_{B}"
TINY = ["-num_iters", "10", "-val_iters", "1", "-patch_size", "16", "16", "16",
        "-base_features", "4", "-max_features", "16", "--no_augment"]
TOL = 1e-4
CPU = torch.device("cpu")
# the trees' common root under each results folder
FOLD = os.path.join("nnUNet_ext", "3d_fullres", SEQ, "{stage}", "nnUNetTrainerLWF__nnUNetPlansv2.1",
                    "Generic_UNet", "MH", "fold_0")


def _port_checkpoint(jax_base: str, port_base: str) -> None:
    """A JAX trainer checkpoint as the port's: every head converted, the
    registry split as the port's model splits it, the JAX manifest's keys
    (no ``state_init``, optimizer or ``cl_state``: evaluation reads none)."""
    mh, _, manifest = jax_checkpoints.load_checkpoint(jax_base)
    model = model_from_manifest(manifest, plans_from_manifest(manifest))
    split, order = manifest["split_at"], model.module_order()
    parts = {t: split_params(jax_params_to_state_dict(mh.assemble(t), model), split, order)
             for t in mh.tasks}
    pmh = MultiHeadParams(body=parts[mh.active_task][0],
                          heads=OrderedDict((t, parts[t][1]) for t in mh.tasks),
                          split_at=split, module_order=order, active_task=mh.active_task)
    kept = {k: v for k, v in manifest.items()
            if k not in ("meta", "step", "epoch", "has_opt_state", "has_cl_state")}
    checkpoints.save_registry(port_base, pmh, kept, step=manifest["step"],
                              epoch=manifest["epoch"], include_state_init=False)


@pytest.fixture(scope="module")
def env(synthetic_task, synthetic_task_b, tmp_path_factory):
    """The JAX CLI's LwF run over A and B, and its checkpoints converted."""
    root = tmp_path_factory.mktemp("evaluation")
    pre = root / "pre"
    plan_and_preprocess([synthetic_task, synthetic_task_b], str(pre), configs=("3d_fullres",),
                        verbose=False)
    raw_dirs = {A: synthetic_task, B: synthetic_task_b}
    # the raw root the CLIs resolve task ids against
    os.makedirs(root / "raw" / "nnUNet_raw_data")
    for t, d in raw_dirs.items():
        os.symlink(d, root / "raw" / "nnUNet_raw_data" / t)
    mp = pytest.MonkeyPatch()
    mp.setenv("nnUNet_raw_data_base", str(root / "raw"))
    mp.setenv("nnUNet_preprocessed", str(pre))
    mp.setenv("RESULTS_FOLDER", str(root / "jax_results"))
    assert jax_run_training("lwf", ["3d_fullres", "-t", "97", "98", "-num_epochs", "1"]
                            + TINY) == 0
    converted = 0
    for d, _, files in os.walk(root / "jax_results"):
        for f in files:
            if f.endswith(".ckpt"):
                rel = os.path.relpath(os.path.join(d, f[:-5]), root / "jax_results")
                _port_checkpoint(os.path.join(d, f[:-5]), str(root / "port_results" / rel))
                converted += 1
    assert converted >= 6
    yield {"root": root, "raw": raw_dirs,
           "stage": {t: str(pre / t / "nnUNetData_plans_v2.1_3d_fullres") for t in (A, B)}}
    mp.undo()


def _ckpt(env, which: str, stage: str, name: str = "model_final_checkpoint") -> str:
    return str(env["root"] / f"{which}_results" / FOLD.format(stage=stage) / name)


def _assert_same_results(got: dict, want: dict):
    assert list(got) == list(want)
    for t in want:
        assert got[t]["head"] == want[t]["head"]
        assert sorted(got[t]["subjects"]) == sorted(want[t]["subjects"])
        for case, metrics in want[t]["subjects"].items():
            for name, values in metrics.items():
                np.testing.assert_allclose(got[t]["subjects"][case][name], values, atol=TOL,
                                           err_msg=f"{t} {case} {name}")


def _csv_rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _assert_same_rows(got_path, want_path, numeric):
    got, want = _csv_rows(got_path), _csv_rows(want_path)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k not in numeric} == \
            {k: v for k, v in w.items() if k not in numeric}
        for k in numeric:
            np.testing.assert_allclose(float(g[k]), float(w[k]), atol=TOL, err_msg=k)


@pytest.fixture(scope="module")
def evaluated(env):
    """Both Evaluators on the final checkpoint, every task, own heads."""
    out = {}
    for which, ev in (("jax", JaxEvaluator(_ckpt(env, "jax", SEQ), JaxOptions())),
                      ("port", Evaluator(_ckpt(env, "port", SEQ),
                                         TrainerOptions(device="cpu")))):
        folder = env["root"] / "eval" / which
        out[which] = (ev, ev.evaluate_on(env["stage"], str(folder)), folder)
    return out


def test_evaluator_gives_the_jax_metrics_and_summaries(evaluated):
    _, got, pfolder = evaluated["port"]
    _, want, jfolder = evaluated["jax"]
    _assert_same_results(got, want)
    assert {t: r["head"] for t, r in got.items()} == {A: A, B: B}
    assert sorted(os.listdir(pfolder)) == sorted(os.listdir(jfolder)) == [
        "model_summary.csv", "summarized_val_metrics.csv", "summarized_val_metrics.txt",
        "val_metrics_eval.csv", "val_metrics_eval.json"]
    _assert_same_rows(pfolder / "summarized_val_metrics.csv",
                      jfolder / "summarized_val_metrics.csv", ("mean", "std"))
    _assert_same_rows(pfolder / "val_metrics_eval.csv", jfolder / "val_metrics_eval.csv",
                      ("value",))
    assert _csv_rows(pfolder / "model_summary.csv") == _csv_rows(jfolder / "model_summary.csv")


@pytest.mark.parametrize("kw", [{"use_head": A}, {"always_use_last_head": True}],
                         ids=["use_head", "last_head"])
def test_evaluator_heads_are_the_jax_heads(evaluated, env, kw, tmp_path):
    jev, pev = evaluated["jax"][0], evaluated["port"][0]
    got = pev.evaluate_on(env["stage"], str(tmp_path / "port"), mirror_axes=(), **kw)
    want = jev.evaluate_on(env["stage"], str(tmp_path / "jax"), mirror_axes=(), **kw)
    _assert_same_results(got, want)
    assert {r["head"] for r in got.values()} == {A if "use_head" in kw else B}


def test_accuracy_matrix_and_cl_report_are_jax(env, tmp_path):
    stages = [A, SEQ]
    got = pcm.accuracy_matrix([_ckpt(env, "port", s) for s in stages], env["stage"],
                              TrainerOptions(device="cpu"))
    want = jcm.accuracy_matrix([_ckpt(env, "jax", s) for s in stages], env["stage"],
                               JaxOptions())
    assert got.shape == (2, 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-6)
    baseline = np.array([0.1, 0.2])
    for base in (None, baseline):
        report, jreport = pcm.cl_report(got, [A, B], base), jcm.cl_report(want, [A, B], base)
        assert sorted(report) == sorted(jreport)
        for k in ("BWT", "FWT", "final_mean_dice"):
            assert report[k] == pytest.approx(jreport[k], abs=1e-6), k
        assert report["BWT"] == pytest.approx(got[1, 0] - got[0, 0], abs=1e-12)
        assert report["FWT"] == pytest.approx(
            got[0, 1] - (0 if base is None else base[1]), abs=1e-12)
    pcm.write_cl_report(report, str(tmp_path))
    assert json.loads((tmp_path / "cl_metrics.json").read_text()) == report


def _files(root) -> dict:
    return {os.path.relpath(os.path.join(d, f), root): os.path.join(d, f)
            for d, _, fs in os.walk(root) for f in fs}


# evaluator2 rounds the probabilities to bf16 in both packages (the JAX
# package's device-to-host transfer), so two classes can tie after rounding;
# an f32 roundoff difference between XLA's and PyTorch's convs then flips
# the voxel, and on this barely trained model (near-uniform softmax) one
# voxel moves a small class's Dice by 1e-4 to 1e-2.  So evaluator2's scores
# are held through its segmentations: each case's agrees with JAX's on
# MIN_AGREEMENT of its voxels, the port scores its own exactly, and a case
# whose segmentations are equal has JAX's scores exactly.  The limit is
# tests/test_torch_inference_e2e.py's for the same pipeline.
MIN_AGREEMENT = 0.999


def _assert_same_json(got, want, path="", tol=TOL):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_same_json(got[k], want[k], f"{path}/{k}", tol)
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_json(g, w, f"{path}[{i}]", tol)
    elif isinstance(want, float):
        if tol is not None:
            np.testing.assert_allclose(got, want, atol=tol, err_msg=path)
    else:
        assert got == want, path


def _assert_same_tree(got_root, want_root, tol=TOL):
    """The same files; json files with the same keys and values; csv files
    with the same rows (their last column numeric); floats within ``tol``,
    not compared where it is None."""
    got, want = _files(got_root), _files(want_root)
    assert sorted(got) == sorted(want)
    for rel, path in want.items():
        if rel.endswith(".json"):
            with open(got[rel]) as g, open(path) as w:
                _assert_same_json(json.load(g), json.load(w), rel, tol)
        elif rel.endswith(".csv"):
            with open(got[rel], newline="") as g, open(path, newline="") as w:
                grows, wrows = list(csv.reader(g)), list(csv.reader(w))
            assert len(grows) == len(wrows), rel
            for gr, wr in zip(grows[1:], wrows[1:]):
                assert gr[:-1] == wr[:-1], rel
                if tol is not None:
                    np.testing.assert_allclose(float(gr[-1]), float(wr[-1]), atol=tol,
                                               err_msg=rel)
    return got


def _assert_same_segmentations(got: dict, want: dict, port_dir, jax_dir, raw: dict):
    """evaluator2's results of both packages, their predictions kept: see
    MIN_AGREEMENT."""
    assert {t: r["head"] for t, r in got.items()} == {t: r["head"] for t, r in want.items()}
    for t, r in got.items():
        assert sorted(r["cases"]) == sorted(want[t]["cases"]) and r["cases"]
        for case, scores in r["cases"].items():
            seg, jseg = (np.asarray(read_image(os.path.join(
                d, f"predictions_{t}", f"{case}.nii.gz")).data) for d in (port_dir, jax_dir))
            assert (seg == jseg).mean() >= MIN_AGREEMENT, (t, case)
            label = np.asarray(read_image(os.path.join(raw[t], "labelsTr",
                                                       f"{case}.nii.gz")).data)
            assert scores == subject_metrics(seg.astype(np.int32), label.astype(np.int32), 3)
            if np.array_equal(seg, jseg):
                assert scores == want[t]["cases"][case], (t, case)


@pytest.mark.parametrize("legacy", [False, True], ids=["per_task", "legacy_structure"])
def test_evaluator2_gives_the_jax_scores_and_files(env, tmp_path, legacy):
    pbase, jbase = _ckpt(env, "port", SEQ), _ckpt(env, "jax", SEQ)
    got = run_evaluation2(pbase, env["raw"], str(tmp_path / "port"), device=CPU,
                          legacy_structure=legacy, no_delete=True)
    want = jax_run_evaluation2(jbase, env["raw"], str(tmp_path / "jax"),
                               legacy_structure=legacy, no_delete=True)
    assert {t: r["head"] for t, r in got.items()} == {A: A, B: B}
    _assert_same_json(got, want, tol=None)
    _assert_same_segmentations(got, want, tmp_path / "port", tmp_path / "jax", env["raw"])
    files = _assert_same_tree(tmp_path / "port", tmp_path / "jax", None)
    layout = {"val_metrics_all.json", "val_metrics_eval.json", "summarized_metrics_all.txt"} \
        if legacy else {f"{A}/val_metrics_all.json", f"{B}/val_metrics_eval.csv"}
    assert layout <= set(files) and "eval2_metrics.json" in files


def test_determine_postprocessing_is_jax_and_inference_applies_it(evaluated, env, tmp_path,
                                                                  monkeypatch):
    jev, pev = evaluated["jax"][0], evaluated["port"][0]
    got = determine_postprocessing(pev.trainer, B, str(tmp_path / "port"))
    want = jax_determine_postprocessing(jev.trainer, B, str(tmp_path / "jax"))
    assert got["for_which_classes"] == want["for_which_classes"]
    # both packages keep each window's probabilities in bf16 before the f32
    # sum (``output="seg"``); the f32 probabilities under that rounding
    # differ by roundoff between the packages
    for kind in ("dice_raw", "dice_pp"):
        assert list(got[kind]) == list(want[kind])
        np.testing.assert_allclose(list(got[kind].values()), list(want[kind].values()),
                                   atol=1e-3)
    written = json.loads((tmp_path / "port" / "postprocessing.json").read_text())
    assert written["for_which_classes"] == got["for_which_classes"]
    assert load_postprocessing(str(tmp_path)) is None
    # nnUNet_torch_inference --postprocess reads the decision beside the
    # checkpoint: the served segmentation is the unfiltered one filtered
    # with those classes; a decision that keeps none filters none (the JAX
    # CLI would filter every class), and with no decision every class is
    folder = os.path.dirname(_ckpt(env, "port", SEQ))
    monkeypatch.setenv("RESULTS_FOLDER", str(env["root"] / "port_results"))
    argv = ["3d_fullres", "lwf", "-i", os.path.join(env["raw"][B], "imagesTr"),
            "-trained_on", "97", "98", "--device", "cpu"]
    assert run_inference(argv + ["-o", str(tmp_path / "plain")]) == 0
    decision = os.path.join(folder, "postprocessing.json")
    for kept in ([1], [], None):
        if kept is not None:
            with open(decision, "w") as f:
                json.dump({"for_which_classes": kept, "dice_raw": {}, "dice_pp": {}}, f)
        assert load_postprocessing(folder) == kept
        out = tmp_path / f"pp_{kept}"
        try:
            assert run_inference(argv + ["-o", str(out), "--postprocess"]) == 0
        finally:
            if kept is not None:
                os.remove(decision)
        for f in sorted(os.listdir(tmp_path / "plain")):
            plain = np.asarray(read_image(str(tmp_path / "plain" / f)).data)
            pp = np.asarray(read_image(str(out / f)).data)
            np.testing.assert_array_equal(
                pp, remove_all_but_largest_component(plain, [1, 2] if kept is None else kept))


def _cli_roots(monkeypatch, env, which, tag):
    monkeypatch.setenv("RESULTS_FOLDER", str(env["root"] / f"{which}_results"))
    out = env["root"] / "cli" / tag / which
    monkeypatch.setenv("EVALUATION_FOLDER", str(out))
    return out


@pytest.mark.parametrize("tag,extra", [
    ("evaluate", []), ("evaluate_stage_a", ["-use_model", "97", "-use_head", "97"]),
    ("evaluate2", []), ("evaluate2_legacy", ["--legacy_structure", "--disable_tta",
                                             "--no_delete"]),
    ("evaluate2_init", ["--evaluate_initialization", "--no_delete"])])
def test_evaluation_clis_write_the_jax_trees(env, monkeypatch, tag, extra):
    """The Evaluator's values to 1e-4; evaluator2's through its
    segmentations where they are kept (see MIN_AGREEMENT)."""
    two = tag.startswith("evaluate2")
    argv = ["3d_fullres", "lwf", "-trained_on", "97", "98", "-evaluate_on", "97", "98"] + extra
    port_cli, jax_cli = (run_evaluation2_cli, jax_cli_evaluate2) if two else \
        (run_evaluation, jax_cli_evaluate)
    jout = _cli_roots(monkeypatch, env, "jax", tag)
    assert jax_cli(argv) == 0
    pout = _cli_roots(monkeypatch, env, "port", tag)
    assert port_cli(argv + ["--device", "cpu"]) == 0
    files = _assert_same_tree(pout, jout, None if two else TOL)
    stage = A if "-use_model" in extra else SEQ
    where = os.path.join(FOLD.format(stage=stage), "eval2" if two else "")
    assert any(rel.startswith(where) for rel in files), (where, sorted(files))
    kept = any("predictions_" in rel for rel in files)
    assert kept == ("--no_delete" in extra)
    if kept:
        out = [os.path.join(root, FOLD.format(stage=stage), "eval2") for root in (pout, jout)]
        got, want = (json.loads(open(os.path.join(d, "eval2_metrics.json")).read())
                     for d in out)
        _assert_same_segmentations(got, want, *out, env["raw"])


def test_evaluation_clis_refuse_what_the_port_lacks(env, monkeypatch):
    _cli_roots(monkeypatch, env, "port", "refused")
    argv = ["3d_fullres", "lwf", "-trained_on", "97", "98", "-evaluate_on", "97",
            "--device", "cpu"]
    for cli in (run_evaluation, run_evaluation2_cli):
        # task-specific LayerNorms are ported: the option names the
        # task_specific folder, which holds no model here
        with pytest.raises(FileNotFoundError, match="task_specific"):
            cli(argv + ["--use_vit", "--task_specific_ln"])
        # the cascade trainer is ported: its folder holds no model here
        with pytest.raises(FileNotFoundError, match="no checkpoint"):
            cli(["3d_fullres", "cascade_fullres"] + argv[2:])
