"""CLI: remove a task from the raw/preprocessed trees —
``nnUNet_torch_delete_tasks``, the port's copy of
``lifelong_nnunet_tpu/scripts/delete_tasks.py`` (reference
``nnunet_ext/scripts/delete_specified_task.py``)."""

from __future__ import annotations

import argparse
import os
import shutil

from .. import paths


def delete_task(task_name: str, include_results: bool = False) -> list:
    removed = []
    roots = [paths.raw_data_dir(create=False), paths.preprocessed_dir(create=False)]
    if include_results:
        roots.append(paths.results_dir(create=False))
    for root in roots:
        if root is None:
            continue
        p = os.path.join(root, task_name)
        if os.path.isdir(p):
            shutil.rmtree(p)
            removed.append(p)
    return removed


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-t", "--task_ids", nargs="+", required=True)
    p.add_argument("--include_results", action="store_true")
    args = p.parse_args(argv)
    raw = paths.raw_data_dir(create=False) or paths.preprocessed_dir(create=False)
    from ..run.plan_and_preprocess import resolve_task
    for t in args.task_ids:
        try:
            name = os.path.basename(resolve_task(t, raw))
        except FileNotFoundError:
            name = t
        removed = delete_task(name, args.include_results)
        print(f"{name}: removed {removed or 'nothing'}")


if __name__ == "__main__":
    main()
