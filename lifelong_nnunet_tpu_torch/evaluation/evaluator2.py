"""evaluator2: evaluation through the whole inference pipeline, the port of
``lifelong_nnunet_tpu/evaluation/evaluator2.py``.

For each evaluated task, ``predict_from_folder`` segments the raw
``imagesTr`` (preprocessing, sliding window with mirror TTA on the device
through the volume stream, its default, resampling back, export) with the
model of the checkpoint and the task's head (or ``use_head``, or the last
head), then each case is scored against ``labelsTr``: per-class Dice and
IoU (:func:`compute_scores_and_build_dict`).
The model is restored as ``nnUNet_torch_inference`` restores it
(``training/restore.py:restore_model``), so both give the same
segmentations.

Written: ``eval2_metrics.{json,csv}`` and the reference's layout,
``val_metrics_all`` (every case) and ``val_metrics_eval`` (this fold's
validation cases), per task in subfolders or, with ``legacy_structure``,
merged at the root with ``summarized_metrics_{all,val}.txt``.
"""

from __future__ import annotations

import csv
import json
import os
import shutil

import numpy as np
import torch

from .. import paths
from ..data.dataset import kfold_split
from ..inference.predict import predict_from_folder
from ..training.restore import restore_model
from ..utilities.imageio import READABLE_SUFFIXES, image_suffix, read_image
from .metrics import subject_metrics


def compute_scores_and_build_dict(pred_folder: str, labels_folder: str,
                                  num_classes: int) -> dict:
    """{case: {"Dice": [...], "IoU": [...]}} per foreground class, for
    every segmentation in ``pred_folder`` with a label of any readable
    format in ``labels_folder``."""
    out = {}
    for f in sorted(os.listdir(pred_folder)):
        suf = image_suffix(f)
        if suf is None:
            continue
        case = f[: -len(suf)]
        gt = next((os.path.join(labels_folder, case + ext) for ext in READABLE_SUFFIXES
                   if os.path.isfile(os.path.join(labels_folder, case + ext))), None)
        if gt is None:
            continue
        pred = np.asarray(read_image(os.path.join(pred_folder, f)).data).astype(np.int32)
        label = np.asarray(read_image(gt).data).astype(np.int32)
        out[case] = subject_metrics(pred, label, num_classes)
    return out


def run_evaluation2(checkpoint_base: str, task_raw_dirs: dict, output_folder: str, *,
                    device: torch.device, use_head: str | None = None, do_tta: bool = True,
                    no_delete: bool = False, window_batch: int = 8, fold: int = 0,
                    legacy_structure: bool = False) -> dict:
    """``task_raw_dirs``: {task: raw Decathlon task dir}.  Returns {task:
    {"head", "cases": {case: {"Dice", "IoU"}}}} and writes the files of the
    module docstring; the predictions are removed unless ``no_delete``."""
    with open(checkpoint_base + ".json") as f:
        heads = json.load(f)["meta"]["task_order"]
    os.makedirs(output_folder, exist_ok=True)
    models, all_results = {}, {}
    for task, raw_dir in task_raw_dirs.items():
        head = use_head or (task if task in heads else heads[-1])
        if head not in models:
            models[head] = restore_model(checkpoint_base, device, head=head)
        model, plans, config_name = models[head]
        pred_dir = os.path.join(output_folder, f"predictions_{task}")
        predict_from_folder([model], plans, config_name, os.path.join(raw_dir, "imagesTr"),
                            pred_dir, device=device, do_tta=do_tta, window_batch=window_batch)
        scores = compute_scores_and_build_dict(pred_dir, os.path.join(raw_dir, "labelsTr"),
                                               plans.num_classes + 1)
        all_results[task] = {"head": head, "cases": scores}
        if not no_delete:
            shutil.rmtree(pred_dir, ignore_errors=True)
    with open(os.path.join(output_folder, "eval2_metrics.json"), "w") as f:
        json.dump(all_results, f, indent=2)
    _write_csv(all_results, os.path.join(output_folder, "eval2_metrics.csv"))
    write_reference_outputs(all_results, output_folder, fold, legacy_structure,
                            checkpoint_base=checkpoint_base, use_head=use_head)
    return all_results


# ---------------------------------------------------------------------------
# the reference's layout
# ---------------------------------------------------------------------------

def _val_split_cases(task: str, fold: int, cases) -> set:
    """This fold's validation cases: from ``splits_final.json`` under the
    preprocessed root when it is there, else the trainer's ``kfold_split``
    over the scored cases."""
    pre = paths.preprocessed_dir(create=False)
    if pre:
        p = os.path.join(pre, task, "splits_final.json")
        if os.path.isfile(p):
            with open(p) as f:
                splits = json.load(f)
            if splits:
                return set(splits[fold % len(splits)].get("val", []))
    return set(kfold_split(sorted(cases), fold)[1])


def _reference_nested(all_results: dict, case_filters: dict) -> dict:
    """{task: {case: {"mask_<c>": {"IoU": x, "Dice": y}}}}."""
    tasks = {}
    for task, r in all_results.items():
        keep = case_filters.get(task)
        tasks[task] = {
            case: {f"mask_{ci + 1}": {"IoU": m["IoU"][ci], "Dice": m["Dice"][ci]}
                   for ci in range(len(m["Dice"]))}
            for case, m in r["cases"].items() if keep is None or case in keep}
    return tasks


def _flat_rows(nested: dict) -> list:
    return [[epoch, task, case, mask, metric, value]
            for epoch, tasks in nested.items() for task, cases in tasks.items()
            for case, masks in cases.items() for mask, metrics in masks.items()
            for metric, value in metrics.items()]


def _dump_reference_files(nested: dict, folder: str, file_name: str) -> None:
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, file_name + ".json"), "w") as f:
        json.dump(nested, f, indent=2)
    with open(os.path.join(folder, file_name + ".csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Epoch", "Task", "subject_id", "seg_mask", "metric", "value"])
        w.writerows(_flat_rows(nested))


def _write_summary_txt(nested: dict, path: str, fold: int, checkpoint_base: str,
                       use_head) -> None:
    rows = _flat_rows(nested)
    with open(path, "w") as f:
        f.write(f"Evaluation performed after Epoch XXX, trained on fold {fold}.\n\n")
        f.write(f"The used checkpoint can be found at {checkpoint_base} "
                f"(head: {use_head or 'per-task'}).\n\n")
        for task in sorted({r[1] for r in rows}):
            for mask in sorted({r[3] for r in rows if r[1] == task}):
                for metric in ("IoU", "Dice"):
                    vals = np.array([r[5] for r in rows if r[1] == task and r[3] == mask
                                     and r[4] == metric], dtype=np.float64)
                    f.write(f"Evaluation performed for fold {fold}, task {task} using "
                            f"segmentation mask {mask} and {metric} as metric:\n")
                    f.write(f"mean (+/- std):\t {np.nanmean(vals)} +/- "
                            f"{np.nanstd(vals)}\n\n")


def write_reference_outputs(all_results: dict, output_folder: str, fold: int,
                            legacy_structure: bool, checkpoint_base: str = "",
                            use_head=None) -> None:
    """``val_metrics_{all,eval}.{json,csv}``: one merged pair and the
    summaries at the root (legacy), else a pair per task subfolder."""
    val_filters = {t: _val_split_cases(t, fold, all_results[t]["cases"])
                   for t in all_results}
    for include_all, file_name in ((True, "val_metrics_all"), (False, "val_metrics_eval")):
        filters = dict.fromkeys(all_results) if include_all else val_filters
        nested = {"epoch_XXX": _reference_nested(all_results, filters)}
        if legacy_structure:
            _dump_reference_files(nested, output_folder, file_name)
            _write_summary_txt(nested, os.path.join(
                output_folder, "summarized_metrics_all.txt" if include_all
                else "summarized_metrics_val.txt"), fold, checkpoint_base, use_head)
        else:
            for task in all_results:
                _dump_reference_files({"epoch_XXX": {task: nested["epoch_XXX"][task]}},
                                      os.path.join(output_folder, task), file_name)


def _write_csv(results: dict, path: str) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["task", "head", "case", "metric", "class", "value"])
        for task, r in results.items():
            for case, m in r["cases"].items():
                for metric, vals in m.items():
                    for ci, v in enumerate(vals):
                        w.writerow([task, r["head"], case, metric, ci + 1, v])
