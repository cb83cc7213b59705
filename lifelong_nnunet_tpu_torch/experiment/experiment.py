"""Experiment: one hyperparameter setting trained over the task sequence,
the port of ``lifelong_nnunet_tpu/experiment/experiment.py`` (reference
``nnunet_ext/experiment/experiment.py:120-425``).

:func:`cast_settings` types the settings by the trainer's ``HYPERPARAMS``
and rejects keys it does not declare.  :meth:`Experiment.run` trains each
task with ``use_param_split`` (the 80:20 re-split of the train cases, so
the real validation cases never leak), runs the evaluation-mode
``_perform_validation(call_for_eval=True)`` after every task, and writes
``experiment_results.csv`` and ``settings.json`` in the experiment's
folder.
"""

from __future__ import annotations

import copy
import csv
import json
import os

import numpy as np

from ..training.trainer import TrainerOptions
from ..training.trainers import get_trainer


def cast_settings(trainer_cls, settings: dict) -> dict:
    out = {}
    for k, v in settings.items():
        if k not in trainer_cls.HYPERPARAMS:
            raise ValueError(
                f"{trainer_cls.__name__} does not declare hyperparameter {k!r}; "
                f"known: {sorted(trainer_cls.HYPERPARAMS)}")
        typ = trainer_cls.HYPERPARAMS[k]
        out[k] = (str(v).lower() in ("true", "1")) if typ is bool else typ(v)
    return out


class Experiment:
    def __init__(self, extension: str, plans, config_name: str,
                 task_stage_dirs: dict, output_base: str,
                 settings: dict, options: TrainerOptions | None = None):
        self.extension = extension
        self.trainer_cls = get_trainer(extension)
        self.settings = cast_settings(self.trainer_cls, settings)
        self.plans = plans
        self.config_name = config_name
        self.tasks = dict(task_stage_dirs)
        self.output_base = output_base
        self.options = copy.copy(options) if options else TrainerOptions()
        self.options.use_param_split = True

    def run(self, exp_id: str) -> dict:
        exp_dir = os.path.join(self.output_base, exp_id)
        os.makedirs(exp_dir, exist_ok=True)
        trainer = self.trainer_cls(self.plans, self.config_name, exp_dir,
                                   self.options, **self.settings)
        rows, summary = [], {}
        for idx, (task, stage) in enumerate(self.tasks.items()):
            trainer.set_output_folder(os.path.join(exp_dir, f"task_{idx}_{task}"))
            trainer.metadata_folder = exp_dir
            trainer.train_task(task, stage)
            results = trainer._perform_validation(call_for_eval=True)
            for t, r in results.items():
                vals = [float(np.nanmean(m["Dice"])) for m in r["subjects"].values()]
                mean_dice = float(np.nanmean(vals)) if vals else float("nan")
                rows.append({"exp": exp_id, "after_task": task, "eval_task": t,
                             "head": r["head"], "mean_dice": mean_dice,
                             **{k: str(v) for k, v in self.settings.items()}})
                summary[(task, t)] = mean_dice
        csv_path = os.path.join(exp_dir, "experiment_results.csv")
        if trainer.is_main:
            with open(csv_path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
                w.writeheader()
                w.writerows(rows)
            with open(os.path.join(exp_dir, "settings.json"), "w") as f:
                json.dump({k: str(v) for k, v in self.settings.items()}, f, indent=2)
        final = float(np.nanmean([v for (a, t), v in summary.items()
                                  if a == list(self.tasks)[-1]]))
        return {"exp_id": exp_id, "settings": self.settings,
                "final_mean_dice": final, "rows": rows, "csv": csv_path}
