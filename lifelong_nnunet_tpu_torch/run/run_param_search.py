"""CLI: hyperparameter search with the PyTorch port —
``nnUNet_torch_parameter_search``.

The port of ``lifelong_nnunet_tpu/run/run_param_search.py`` (reference
``nnunet_ext/run/run_param_search.py``): grid or random search over a
trainer's declared ``HYPERPARAMS`` (``experiment/param_search.py``), with
fixed parameters, resume from ``backup.json`` and a joined summary CSV,
under ``$PARAM_SEARCH_FOLDER/<network>/<tasks>/<trainer>/fold_X``.

Grid values: ``-g param:v1,v2,...``; random ranges: ``-r param:lo:hi``;
fixed: ``--fixate param:value``.  ``-n_workers`` runs the experiments in
spawned workers, ``-devices_per_exp`` gives each its own cards
(``CUDA_VISIBLE_DEVICES``; 0 shares the card; above 1 an experiment
trains over that many, ``n_devices``), ``-device_backend
{cuda,cpu}`` in place of the JAX CLI's ``{tpu,cpu}``; ``--device``
(default ``cuda``, never falling back to the CPU) is the device of a search
run in this process.
"""

from __future__ import annotations

import argparse
import os

from .. import paths
from ..experiment.param_search import BACKENDS, ParamSearcher
from ..planning.plans import Plans, plans_path
from ..training.trainer import TrainerOptions
from .plan_and_preprocess import resolve_task
from .run_training import stage_dir_for


def _is_num(v) -> bool:
    try:
        float(v)
        return True
    except ValueError:
        return False


def _value(v):
    return float(v) if _is_num(v) else v


def _parse_grid(specs) -> dict:
    out = {}
    for s in specs or []:
        name, vals = s.split(":", 1)
        out[name] = [_value(v) for v in vals.split(",")]
    return out


def _parse_ranges(specs) -> dict:
    out = {}
    for s in specs or []:
        name, lo, hi = s.split(":")
        out[name] = (float(lo), float(hi))
    return out


def _parse_fixate(specs) -> dict:
    out = {}
    for s in specs or []:
        name, v = s.split(":", 1)
        out[name] = _value(v)
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("network", choices=["2d", "3d_lowres", "3d_fullres"])
    p.add_argument("trainer", help="extension name (e.g. ewc, rw, mib)")
    p.add_argument("-t", "--task_ids", nargs="+", required=True)
    p.add_argument("-f", "--fold", type=int, default=0)
    p.add_argument("-s", "--search_mode", choices=["grid", "random"], default="grid")
    p.add_argument("-g", "--grid", nargs="+", default=None,
                   help="param:v1,v2,... (grid mode)")
    p.add_argument("-r", "--ranges", nargs="+", default=None,
                   help="param:lo:hi (random mode)")
    p.add_argument("--fixate", nargs="+", default=None, help="param:value")
    p.add_argument("-num_exp", type=int, default=10)
    p.add_argument("-num_epochs", type=int, default=25)
    p.add_argument("-num_iters", type=int, default=250)
    p.add_argument("-seed", type=int, default=3299)
    p.add_argument("-n_workers", type=int, default=1,
                   help="experiments run in parallel spawned workers")
    p.add_argument("-devices_per_exp", type=int, default=0,
                   help="worker i owns cards [i*dpe, (i+1)*dpe) (CUDA_VISIBLE_DEVICES); "
                        "0: the workers share the card")
    p.add_argument("-device_backend", choices=list(BACKENDS), default="cuda")
    p.add_argument("-p", "--plans_identifier", default=paths.default_plans_identifier)
    p.add_argument("--device", default="cuda",
                   help="torch device of a search in this process ('cuda', 'cuda:N' "
                        "or 'cpu')")
    return p


def run_param_search(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    pre = paths.require(paths.preprocessed_dir(create=False), "preprocessed data")
    ps_root = paths.require(paths.param_search_dir(), "param search")
    task_names = [os.path.basename(resolve_task(t, pre)) for t in args.task_ids]
    stages = {t: stage_dir_for(pre, t, args.network) for t in task_names}
    plans = Plans.load(plans_path(os.path.join(pre, task_names[0]), args.plans_identifier))
    opts = TrainerOptions(num_epochs=args.num_epochs, iters_per_epoch=args.num_iters,
                          val_iters=max(10, args.num_iters // 5),
                          save_every=args.num_epochs, fold=args.fold, device=args.device)
    out = os.path.join(ps_root, args.network, "_".join(task_names), args.trainer,
                       f"fold_{args.fold}")
    searcher = ParamSearcher(
        args.trainer, plans, args.network, stages, out,
        search_mode=args.search_mode, grid=_parse_grid(args.grid),
        rand_ranges=_parse_ranges(args.ranges), num_random=args.num_exp,
        fixate=_parse_fixate(args.fixate), seed=args.seed, options=opts)
    results = searcher.start_searching(n_workers=args.n_workers,
                                       devices_per_exp=args.devices_per_exp,
                                       device_backend=args.device_backend)
    print(f"{len(results)} experiment(s) done -> {out}")
    return results


def main():
    run_param_search()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
