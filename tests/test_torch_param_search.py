"""The port's experiment and parameter-search harness
(``lifelong_nnunet_tpu_torch/experiment/``, ``run/run_param_search.py``)
against the JAX package's, on the cases of ``tests/test_param_search.py``:

* ``cast_settings``: equal typed settings, the same refusal of an
  undeclared key;
* the experiments a grid (with a duplicate), a seeded random draw (3
  decimals) and a fixed parameter give: equal ids and settings;
* one experiment over tasks A and B in both packages (tiny U-Net, CPU):
  ``experiment_results.csv``, ``settings.json``, the summary CSV and
  ``best_setting.json`` with JAX's columns and keys, the parameter
  search's 80:20 split of the train cases;
* a grid of two through ``nnUNet_torch_parameter_search``: both
  experiments in ``backup.json``, and the same command again trains
  nothing;
* two spawned workers on ``device_backend="cpu"`` (task A alone): both
  experiments finish, each on the CPU, with its slot recorded;
* a partition this host cannot give (cards it lacks, or more than one card
  per experiment) is refused before any worker starts."""

import csv
import json
import os

import numpy as np
import pytest

from lifelong_nnunet_tpu.experiment import experiment as jexp
from lifelong_nnunet_tpu.experiment.param_search import ParamSearcher as JaxSearcher
from lifelong_nnunet_tpu.planning.plans import Plans as JaxPlans
from lifelong_nnunet_tpu.training import trainers as jtrainers
from lifelong_nnunet_tpu.training.trainer import TrainerOptions as JaxOptions
from lifelong_nnunet_tpu_torch.data.dataset import (PreprocessedDataset, final_splits,
                                                     param_search_split)
from lifelong_nnunet_tpu_torch.experiment import experiment as pexp
from lifelong_nnunet_tpu_torch.experiment.param_search import (ParamSearcher,
                                                               device_partition_env)
from lifelong_nnunet_tpu_torch.planning.plans import Plans, plans_path
from lifelong_nnunet_tpu_torch.run.plan_and_preprocess import plan_and_preprocess
from lifelong_nnunet_tpu_torch.run.run_param_search import run_param_search
from lifelong_nnunet_tpu_torch.training import trainers as ptrainers
from lifelong_nnunet_tpu_torch.training.trainer import TrainerOptions

A, B = "Task097_SynthA", "Task098_SynthB"
TINY = dict(num_epochs=1, iters_per_epoch=2, val_iters=1, save_every=5, batch_size=2,
            patch_size=(16, 16, 16), augment=False, dtype="float32", base_num_features=4,
            max_num_features=8)


@pytest.fixture(scope="module")
def env(synthetic_task, synthetic_task_b, tmp_path_factory):
    root = tmp_path_factory.mktemp("psearch")
    pre = root / "pre"
    plan_and_preprocess([synthetic_task, synthetic_task_b], str(pre),
                        configs=("3d_fullres",), verbose=False)
    return {"root": root, "pre": pre, "plans": Plans.load(plans_path(str(pre / A))),
            "jplans": JaxPlans.load(plans_path(str(pre / A))),
            "stages": {t: str(pre / t / "nnUNetData_plans_v2.1_3d_fullres") for t in (A, B)}}


@pytest.mark.parametrize("ext,settings", [
    ("ewc", {"ewc_lambda": "0.5"}),
    ("rw", {"rw_lambda": 1, "rw_alpha": "0.8", "fisher_update_after": "7"}),
    ("froz_ewc", {"ewc_lambda": 0.2, "adaptive": "True"}),
    ("mib", {"mib_alpha": "0.5", "mib_lkd": 3})])
def test_cast_settings_matches_jax(ext, settings):
    got = pexp.cast_settings(ptrainers.get_trainer(ext), settings)
    want = jexp.cast_settings(jtrainers.get_trainer(ext), settings)
    assert got == want and [type(v) for v in got.values()] == [type(v) for v in want.values()]
    for mod, trainers in ((pexp, ptrainers), (jexp, jtrainers)):
        with pytest.raises(ValueError, match="nope"):
            mod.cast_settings(trainers.get_trainer(ext), {**settings, "nope": 1})


SEARCHES = {
    "grid_dedup": dict(search_mode="grid", grid={"ewc_lambda": [0.1, 0.1, 0.4]}),
    "grid_fixate": dict(search_mode="grid", grid={"rw_lambda": [0.1, 0.2],
                                                  "rw_alpha": [0.5, 0.9]},
                        fixate={"fisher_update_after": 5}),
    "random_seeded": dict(search_mode="random", rand_ranges={"ewc_lambda": (0.1, 1.0)},
                          num_random=4, seed=7),
    "random_fixate_dedup": dict(search_mode="random",
                                rand_ranges={"rw_lambda": (0.1, 0.1001)}, num_random=3,
                                fixate={"rw_alpha": 0.9})}


@pytest.mark.parametrize("case", list(SEARCHES))
def test_experiments_match_jax(case, tmp_path):
    """The same experiment ids and settings (the grid's keys sorted, draws
    rounded to 3 decimals, fixed values merged, duplicates dropped)."""
    kw = SEARCHES[case]
    ext = "ewc" if "ewc_lambda" in str(kw) else "rw"
    got = ParamSearcher(ext, None, "3d_fullres", {}, str(tmp_path / "p"), **kw).experiments
    want = JaxSearcher(ext, None, "3d_fullres", {}, str(tmp_path / "j"), **kw).experiments
    assert got == want and got
    if case == "grid_dedup":
        assert len(got) == 2
    if case.startswith("random"):
        vals = [v for c in got.values() for k, v in c.items() if k in kw["rand_ranges"]]
        assert all(round(v, 3) == v for v in vals)
    if case == "random_fixate_dedup":
        assert len(got) == 1


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def searched(env):
    """One EWC experiment over A and B in both packages, the port on the CPU."""
    out = {}
    for name, cls, opts, plans in (
            ("jax", JaxSearcher, JaxOptions(**TINY), env["jplans"]),
            ("port", ParamSearcher, TrainerOptions(device="cpu", **TINY), env["plans"])):
        base = env["root"] / "one" / name
        s = cls("ewc", plans, "3d_fullres", env["stages"], str(base), search_mode="grid",
                grid={"ewc_lambda": [0.1]}, options=opts)
        out[name] = (s.start_searching(), base)
    return out


def test_experiment_files_match_jax(env, searched):
    (jres, jbase), (pres, pbase) = searched["jax"], searched["port"]
    assert list(pres) == list(jres) == ["exp_0"]
    r = pres["exp_0"]
    assert np.isfinite(r["final_mean_dice"]) and r["settings"] == {"ewc_lambda": 0.1}
    for rel in ("exp_0/experiment_results.csv", "parameter_search_val_summary.csv"):
        prow, jrow = _rows(pbase / rel), _rows(jbase / rel)
        assert [list(x) for x in prow] == [list(x) for x in jrow], rel
        assert [(x["after_task"], x["eval_task"], x["head"], x["ewc_lambda"]) for x in prow] \
            == [(x["after_task"], x["eval_task"], x["head"], x["ewc_lambda"]) for x in jrow]
    for rel in ("exp_0/settings.json", "best_setting.json", "backup.json"):
        pj, jj = (json.loads((b / rel).read_text()) for b in (pbase, jbase))
        assert sorted(pj) == sorted(jj), rel
        if rel != "best_setting.json":
            assert pj == jj, rel
    # the experiment trained on the 80:20 re-split of fold 0's train cases
    tr = final_splits(str(env["pre"] / A), PreprocessedDataset(env["stages"][A]).cases)[0]
    _, val = param_search_split(tr["train"])
    evals = json.loads((pbase / "exp_0" / f"task_0_{A}" / "val_metrics_eval.json").read_text())
    assert sorted(evals[0]["results"][A]["subjects"]) == sorted(val)


def test_cli_search_and_resume(env, monkeypatch):
    """``nnUNet_torch_parameter_search 3d_fullres ewc -t A B -g
    ewc_lambda:0.1,0.4 --device cpu``, then the same command again: the
    second trains nothing."""
    monkeypatch.setenv("nnUNet_preprocessed", str(env["pre"]))
    monkeypatch.setenv("PARAM_SEARCH_FOLDER", str(env["root"] / "cli"))
    argv = ["3d_fullres", "ewc", "-t", A, B, "-g", "ewc_lambda:0.1,0.4", "-num_epochs", "1",
            "-num_iters", "1", "--device", "cpu"]
    first = run_param_search(argv)
    assert sorted(first) == ["exp_0", "exp_1"]
    assert sorted(r["settings"]["ewc_lambda"] for r in first.values()) == [0.1, 0.4]
    out = env["root"] / "cli" / "3d_fullres" / f"{A}_{B}" / "ewc" / "fold_0"
    backup = json.loads((out / "backup.json").read_text())
    assert backup == {"finished": ["exp_0", "exp_1"], "started": ["exp_0", "exp_1"]}
    best = json.loads((out / "best_setting.json").read_text())
    assert best["exp_id"] in first
    assert run_param_search(argv) == {}


def test_two_spawned_workers_on_the_cpu(env):
    """Task A only, one step: the workers' start-up dominates."""
    s = ParamSearcher("ewc", env["plans"], "3d_fullres", {A: env["stages"][A]},
                      str(env["root"] / "workers"), search_mode="grid",
                      grid={"ewc_lambda": [0.1, 0.4]},
                      options=TrainerOptions(**dict(TINY, iters_per_epoch=1)))
    results = s.start_searching(n_workers=2, device_backend="cpu")
    assert sorted(results) == ["exp_0", "exp_1"]
    for r in results.values():
        assert np.isfinite(r["final_mean_dice"]) and r["device"] == "cpu"
        assert r["device_slot"] in ("0", "1") and r["n_devices"] == 0
    assert json.loads((env["root"] / "workers" / "backup.json").read_text())["finished"] \
        == ["exp_0", "exp_1"]


@pytest.mark.parametrize("n_workers,dpe,err", [(2, 1, RuntimeError), (2, 0, RuntimeError),
                                               (2, 2, RuntimeError)])
def test_an_impossible_partition_is_refused_before_any_worker(env, tmp_path, n_workers, dpe,
                                                              err):
    """This host has no card: two workers on ``cuda`` (one card each, or
    sharing one) are refused, as are two experiments over two cards each;
    nothing is written."""
    s = ParamSearcher("ewc", env["plans"], "3d_fullres", env["stages"], str(tmp_path / "x"),
                      grid={"ewc_lambda": [0.1, 0.4]}, options=TrainerOptions(**TINY))
    with pytest.raises(err):
        s.start_searching(n_workers=n_workers, devices_per_exp=dpe, device_backend="cuda")
    assert os.listdir(tmp_path / "x") == []


@pytest.mark.parametrize("backend,slot,dpe,visible", [
    ("cuda", 0, 1, "0"), ("cuda", 1, 2, "2,3"), ("cuda", 1, 0, None), ("cpu", 1, 1, None)])
def test_device_partition_env(backend, slot, dpe, visible):
    """Worker ``slot`` owns cards ``[slot * dpe, (slot + 1) * dpe)`` as the
    reference partitions GPUs (``CUDA_VISIBLE_DEVICES``); sharing the card
    (dpe 0) or the CPU sets no partition."""
    env = device_partition_env(backend, slot, dpe)
    assert env.get("CUDA_VISIBLE_DEVICES") == visible and env["LNN_DEVICE_SLOT"] == str(slot)
