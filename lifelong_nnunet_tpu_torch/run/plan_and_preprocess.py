"""CLI: dataset fingerprinting + experiment planning + preprocessing.

Equivalent of upstream ``nnUNet_plan_and_preprocess`` (a hard dependency of
the reference, invoked e.g. from ``dataset_label_mapping.py:225``): for each
task in ``$nnUNet_raw_data_base/nnUNet_raw_data``, analyze, plan, and write
preprocessed stages into ``$nnUNet_preprocessed``.
"""

from __future__ import annotations

import argparse
import os

from .. import paths
from ..planning.fingerprint import analyze_dataset
from ..planning.plans import Plans, plan_experiment, plans_path
from ..planning.preprocess import preprocess_task


def resolve_task(task: str, root: str) -> str:
    """Accept 'Task097_SynthA', a bare id '97', or a full path."""
    if os.path.isdir(task):
        return task
    if os.path.isdir(os.path.join(root, task)):
        return os.path.join(root, task)
    try:
        tid = int(task)
    except ValueError:
        raise FileNotFoundError(f"task {task!r} not found under {root}")
    for d in sorted(os.listdir(root)):
        if d.startswith(f"Task{tid:03d}_"):
            return os.path.join(root, d)
    raise FileNotFoundError(f"no Task{tid:03d}_* under {root}")


def plan_and_preprocess(task_dirs: list, preprocessed_root: str,
                        configs=("3d_fullres", "2d"),
                        plans_identifier: str = paths.default_plans_identifier,
                        shared_plans: Plans | None = None, verbose: bool = True):
    """Returns {task_name: {config: stage_dir}}. If ``shared_plans`` is given
    (continual-learning sequences), every task is preprocessed with those
    plans — the first-task-geometry invariant (SURVEY.md §7.4)."""
    out = {}
    for td in task_dirs:
        fp = analyze_dataset(td)
        plans = shared_plans or plan_experiment(fp, plans_identifier)
        task_pre = os.path.join(preprocessed_root, fp["task"])
        os.makedirs(task_pre, exist_ok=True)
        plans.save(plans_path(task_pre, plans_identifier))
        use_configs = [c for c in configs if c in plans.configurations]
        stages = preprocess_task(td, plans, preprocessed_root, configs=use_configs)
        out[fp["task"]] = stages
        if verbose:
            print(f"{fp['task']}: planned {list(plans.configurations)}, "
                  f"preprocessed {list(stages)}")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-t", "--task_ids", nargs="+", required=True,
                   help="task ids or names (e.g. 4 or Task004_Hippocampus)")
    p.add_argument("-pl", "--planner_configs", nargs="+",
                   default=["3d_fullres", "2d"])
    p.add_argument("-p", "--plans_identifier", default=paths.default_plans_identifier)
    args = p.parse_args(argv)
    raw = paths.require(paths.raw_data_dir(), "raw data")
    pre = paths.require(paths.preprocessed_dir(), "preprocessed data")
    tasks = [resolve_task(t, raw) for t in args.task_ids]
    plan_and_preprocess(tasks, pre, tuple(args.planner_configs), args.plans_identifier)


if __name__ == "__main__":
    main()
