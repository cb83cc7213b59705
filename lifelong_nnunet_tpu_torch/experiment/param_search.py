"""ParamSearcher: grid / random hyperparameter search over the CL
trainers, the port of ``lifelong_nnunet_tpu/experiment/param_search.py``
(reference ``nnunet_ext/parameter_search/param_searcher.py``):

  * grid = ``itertools.product`` over the declared value lists, keys sorted;
  * random = seeded uniform draws rounded to 3 decimals;
  * fixed ("fixate") parameters merged into every setting, duplicate
    settings dropped;
  * ``backup.json`` of the started and finished experiments: a search run
    again skips the finished ones;
  * the joined ``parameter_search_val_summary.csv`` and
    ``best_setting.json`` (the highest final mean Dice).

``start_searching(n_workers=N)`` runs the experiments in N spawned worker
processes (the reference runs one process per experiment).  With
``devices_per_exp`` > 0 worker ``i`` owns the devices ``[i * dpe, (i + 1) *
dpe)``, as the reference partitions GPUs: :func:`device_partition_env`
sets ``CUDA_VISIBLE_DEVICES`` in the worker before CUDA initializes there
(the spawn start method: a fork after CUDA is initialized breaks).  A
search that asks for more devices than ``torch.cuda.device_count()`` is
refused before any worker starts, so no worker finds no card and trains on
the CPU.  With ``devices_per_exp = 0`` the workers share the card.  With
``devices_per_exp = d`` above 1 each experiment trains with ``n_devices =
d``: its worker (a pool worker is not daemonic, so it may start processes)
spawns ``d`` ranks (``parallel/launch.py``) over the devices its partition
gives it, ``cuda:0`` ... ``cuda:d-1`` of its ``CUDA_VISIBLE_DEVICES``, or
``d`` on the CPU.  ``device_backend="cpu"`` trains every worker on the CPU
(``TrainerOptions.device``).  Two workers that
build the kernels at once are serialized by the build's file lock
(``ops/kernels/build.py``).
"""

from __future__ import annotations

import csv
import itertools
import json
import multiprocessing as mp
import os
from concurrent.futures import ProcessPoolExecutor
from dataclasses import asdict, replace

import numpy as np
import torch

from ..parallel.launch import spawn
from ..training.trainer import TrainerOptions
from .experiment import Experiment

BACKENDS = ("cuda", "cpu")


def device_partition_env(backend: str, slot: int, devices_per_exp: int) -> dict:
    """The environment of worker ``slot``: with ``cuda`` and
    ``devices_per_exp`` > 0 the devices it owns, ``[slot * dpe, (slot + 1)
    * dpe)``, as ``CUDA_VISIBLE_DEVICES``; else its slot only (the workers
    share the card, or train on the CPU)."""
    env = {"LNN_DEVICE_SLOT": str(slot)}
    if backend == "cuda" and devices_per_exp:
        env["CUDA_VISIBLE_DEVICES"] = ",".join(
            str(slot * devices_per_exp + j) for j in range(devices_per_exp))
    return env


def _worker_init(slot_queue, device_envs):
    """ProcessPoolExecutor initializer: claim a device slot before anything
    in this process initializes CUDA."""
    os.environ.update(device_envs[slot_queue.get()])


def _run_experiment(device: str, spec: dict) -> dict:
    """One experiment of ``spec`` on ``device`` (in a rank process when it
    trains over several devices)."""
    from ..training.restore import plans_from_manifest
    plans = plans_from_manifest({"plans": spec["plans"]})
    opts = replace(TrainerOptions(**spec["options"]), device=device)
    exp = Experiment(spec["extension"], plans, spec["config_name"], spec["tasks"],
                     spec["output_base"], spec["settings"], opts)
    return exp.run(spec["exp_id"])


def _experiment_worker(spec: dict) -> dict:
    """Worker entry (spawn-safe, module level): rebuild the Experiment from
    its spec and run it, over ``spec["world"]`` ranks when that is above 1;
    the result records which slot and devices ran it."""
    for k, v in spec.get("env", {}).items():
        os.environ[k] = str(v)
    opts = TrainerOptions(**spec["options"])
    world = int(spec.get("world", 1))
    if world > 1:
        if mp.current_process().daemon:
            raise RuntimeError("a daemonic worker cannot start the ranks of an experiment")
        cuda = opts.device.startswith("cuda")
        devices = [f"cuda:{i}" for i in range(world)] if cuda else ["cpu"] * world
        spec = {**spec, "options": {**spec["options"], "n_devices": world,
                                    "model_parallel": 1, "devices": None}}
        res = spawn(_run_experiment, (spec,), devices, rdzv_dir=spec["output_base"])
    else:
        res = _run_experiment(opts.device, spec)
    res["world"] = world
    res["device_slot"] = os.environ.get("LNN_DEVICE_SLOT")
    res["visible_devices"] = os.environ.get("CUDA_VISIBLE_DEVICES")
    res["device"] = opts.device
    # the devices this worker sees (in place of the JAX worker's
    # n_jax_devices); device_count() does not initialize CUDA
    res["n_devices"] = torch.cuda.device_count() if opts.device.startswith("cuda") else 0
    res["device_name"] = torch.cuda.get_device_name(0) if res["n_devices"] else "cpu"
    return res


class ParamSearcher:
    def __init__(self, extension: str, plans, config_name: str,
                 task_stage_dirs: dict, output_base: str,
                 search_mode: str = "grid", grid: dict | None = None,
                 rand_ranges: dict | None = None, num_random: int = 10,
                 fixate: dict | None = None, seed: int = 3299,
                 options: TrainerOptions | None = None):
        if search_mode not in ("grid", "random"):
            raise ValueError(f"search_mode must be 'grid' or 'random', got {search_mode!r}")
        self.extension = extension
        self.plans = plans
        self.config_name = config_name
        self.tasks = task_stage_dirs
        self.output_base = output_base
        self.options = options
        self.fixate = fixate or {}
        os.makedirs(output_base, exist_ok=True)
        if search_mode == "grid":
            if not grid:
                raise ValueError("grid mode needs {param: [values...]}")
            keys = sorted(grid)
            combos = [dict(zip(keys, vals))
                      for vals in itertools.product(*(grid[k] for k in keys))]
        else:
            if not rand_ranges:
                raise ValueError("random mode needs {param: (lo, hi)}")
            rng = np.random.RandomState(seed)
            keys = sorted(rand_ranges)
            combos = [{k: round(float(rng.uniform(*rand_ranges[k])), 3) for k in keys}
                      for _ in range(num_random)]
        merged, seen = [], set()
        for c in combos:
            c = {**c, **self.fixate}
            key = tuple(sorted((k, str(v)) for k, v in c.items()))
            if key not in seen:
                seen.add(key)
                merged.append(c)
        self.experiments = {f"exp_{i}": c for i, c in enumerate(merged)}
        self._backup_path = os.path.join(output_base, "backup.json")

    def _load_backup(self) -> dict:
        if os.path.isfile(self._backup_path):
            with open(self._backup_path) as f:
                return json.load(f)
        return {"finished": [], "started": []}

    def _save_backup(self, b: dict):
        with open(self._backup_path, "w") as f:
            json.dump(b, f, indent=2)

    def _check_devices(self, n_workers: int, devices_per_exp: int, backend: str):
        """Refuse, before any worker starts, a partition this host cannot
        give."""
        if backend not in BACKENDS:
            raise ValueError(f"device_backend must be one of {BACKENDS}, got {backend!r}")
        if backend == "cuda":
            want = max(1, n_workers * devices_per_exp)
            have = torch.cuda.device_count()
            if want > have:
                raise RuntimeError(
                    f"{n_workers} worker(s) x {devices_per_exp} device(s) per experiment "
                    f"ask for {want} CUDA device(s); this host has {have}")

    def start_searching(self, n_workers: int = 1, worker_env: dict | None = None,
                        devices_per_exp: int = 0, device_backend: str = "cuda") -> dict:
        """Run every experiment not finished in ``backup.json``: in this
        process with ``n_workers`` <= 1 (on the options' device), else in
        ``n_workers`` spawned workers (module docstring); ``worker_env`` is
        set in each worker."""
        if n_workers > 1:
            self._check_devices(n_workers, devices_per_exp, device_backend)
        backup = self._load_backup()
        todo = {e: s for e, s in self.experiments.items() if e not in backup["finished"]}
        results = {}
        if n_workers <= 1:
            for exp_id, settings in todo.items():
                backup["started"] = sorted(set(backup["started"]) | {exp_id})
                self._save_backup(backup)
                exp = Experiment(self.extension, self.plans, self.config_name,
                                 self.tasks, self.output_base, settings, self.options)
                results[exp_id] = exp.run(exp_id)
                backup["finished"] = sorted(set(backup["finished"]) | {exp_id})
                self._save_backup(backup)
        elif todo:
            opts = self.options or TrainerOptions()
            if device_backend == "cpu":
                opts = replace(opts, device="cpu")
            specs = {exp_id: {"extension": self.extension, "plans": asdict(self.plans),
                              "config_name": self.config_name, "tasks": self.tasks,
                              "output_base": self.output_base, "settings": settings,
                              "options": asdict(opts), "env": dict(worker_env or {}),
                              "exp_id": exp_id, "world": max(1, devices_per_exp)}
                     for exp_id, settings in todo.items()}
            backup["started"] = sorted(set(backup["started"]) | set(todo))
            self._save_backup(backup)
            ctx = mp.get_context("spawn")
            slot_q = ctx.Queue()
            for slot in range(n_workers):
                slot_q.put(slot)
            envs = {slot: device_partition_env(device_backend, slot, devices_per_exp)
                    for slot in range(n_workers)}
            with ProcessPoolExecutor(max_workers=n_workers, mp_context=ctx,
                                     initializer=_worker_init,
                                     initargs=(slot_q, envs)) as pool:
                futures = {pool.submit(_experiment_worker, s): e for e, s in specs.items()}
                for fut, exp_id in futures.items():
                    results[exp_id] = fut.result()
                    backup["finished"] = sorted(set(backup["finished"]) | {exp_id})
                    self._save_backup(backup)
        self._write_summary(results)
        return results

    def _write_summary(self, results: dict):
        rows = [row for r in results.values() for row in r["rows"]]
        if not rows:
            return
        path = os.path.join(self.output_base, "parameter_search_val_summary.csv")
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=sorted({k for r in rows for k in r}))
            w.writeheader()
            w.writerows(rows)
        best = max(results.values(), key=lambda r: r["final_mean_dice"])
        with open(os.path.join(self.output_base, "best_setting.json"), "w") as f:
            json.dump({"exp_id": best["exp_id"],
                       "settings": {k: str(v) for k, v in best["settings"].items()},
                       "final_mean_dice": best["final_mean_dice"]}, f, indent=2)
