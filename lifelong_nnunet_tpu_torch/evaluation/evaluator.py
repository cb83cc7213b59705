"""Evaluator: cross-task per-subject evaluation of a trained model on the
validation splits, the port of ``lifelong_nnunet_tpu/evaluation/evaluator.py``.

It restores the trainer of a checkpoint (``training/restore.py:
restore_trainer``, on the options' device), picks the head per evaluated
task (its own, a fixed ``use_head``, or the last), runs the trainer's
``_perform_validation(call_for_eval=True)`` (sliding window, window batch
4, full mirror TTA unless ``mirror_axes`` says otherwise) and writes
``val_metrics_eval.{json,csv}``, ``summarized_val_metrics.{csv,txt}`` (mean
and std per task, metric and class) and ``model_summary.csv`` (parameter
counts and f32 size of the body and of each head).  A single-task base
model needs no multi-head wrap: a task without a head of its own is
evaluated with the last (only) head.
"""

from __future__ import annotations

import csv
import os

import numpy as np

from ..training.restore import restore_trainer
from ..training.trainer import MultiHeadTrainer, TrainerOptions


class Evaluator:
    def __init__(self, checkpoint_base: str, options: TrainerOptions | None = None):
        self.trainer: MultiHeadTrainer = restore_trainer(checkpoint_base, options)

    def evaluate_on(self, task_stage_dirs: dict, output_folder: str,
                    use_head: str | None = None, always_use_last_head: bool = False,
                    mirror_axes: tuple | None = None) -> dict:
        """``task_stage_dirs``: {task: preprocessed stage dir}; each task's
        validation split is that of the trainer's fold.  Returns {task:
        {"head", "subjects": {case: {"Dice": [...], "IoU": [...]}}}}."""
        os.makedirs(output_folder, exist_ok=True)
        tr = self.trainer
        for task, stage in task_stage_dirs.items():
            tr.register_task_data(task, stage)
        tr.output_folder = output_folder
        results = tr._perform_validation(list(task_stage_dirs), use_head=use_head,
                                         always_use_last_head=always_use_last_head,
                                         call_for_eval=True, mirror_axes=mirror_axes)
        self._write_summary(results, output_folder)
        self._write_model_summary(output_folder)
        return results

    # ---------------------------------------------------------------- output
    @staticmethod
    def _write_summary(results: dict, output_folder: str) -> None:
        """Mean and std over subjects per (task, metric, class)."""
        rows = []
        for task, r in results.items():
            metrics: dict = {}
            for m in r["subjects"].values():
                for metric, vals in m.items():
                    for ci, v in enumerate(vals):
                        metrics.setdefault((metric, ci + 1), []).append(v)
            for (metric, cls), vals in sorted(metrics.items()):
                arr = np.array(vals, dtype=np.float64)
                rows.append({"task": task, "head": r["head"], "metric": metric,
                             "class": cls, "mean": float(np.nanmean(arr)),
                             "std": float(np.nanstd(arr)),
                             "n_subjects": int(np.sum(~np.isnan(arr)))})
        with open(os.path.join(output_folder, "summarized_val_metrics.csv"), "w",
                  newline="") as f:
            w = csv.DictWriter(f, fieldnames=["task", "head", "metric", "class", "mean",
                                              "std", "n_subjects"])
            w.writeheader()
            w.writerows(rows)
        with open(os.path.join(output_folder, "summarized_val_metrics.txt"), "w") as f:
            for row in rows:
                f.write(f"{row['task']} (head {row['head']}) {row['metric']} "
                        f"class {row['class']}: {row['mean']:.4f} ± {row['std']:.4f} "
                        f"(n={row['n_subjects']})\n")

    def _write_model_summary(self, output_folder: str) -> None:
        mh = self.trainer.mh

        def row(part, tensors):
            n = sum(int(v.numel()) for v in tensors.values())
            return {"part": part, "num_params": n, "size_mb": round(n * 4 / 2 ** 20, 3)}

        rows = [row("body", mh.body)] + [row(f"head:{t}", h) for t, h in mh.heads.items()]
        total = sum(r["num_params"] for r in rows)
        rows.append({"part": "total", "num_params": total,
                     "size_mb": round(total * 4 / 2 ** 20, 3)})
        with open(os.path.join(output_folder, "model_summary.csv"), "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["part", "num_params", "size_mb"])
            w.writeheader()
            w.writerows(rows)
