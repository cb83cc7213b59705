"""The benchmark's harness: finds a cell's files by its name, runs its entry
(set-up, the measured window, the traced window, the check), reads the
metrics and prints the result line.

Everything particular to a cell lives in files of its own, found by name:

* ``workloads/<cell>.json``: the configuration, the traffic and the limits
  of the numbers that decide ``correct``;
* ``configs/<config>.json``: the plans the program runs (``plans``), with
  the source, ``reduced`` and ``assumed``;
* ``traffic/<traffic>.json``: the parameters of the traffic, with ``entry``
  naming the module in ``entries/`` that runs it (``train`` or ``serve``);
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(run)``,
  which returns a number or None when it finds nothing to read.

``BENCHMARK.json`` at the root of the checkout says which end-to-end and
per-layer metrics a cell reports: a per-layer metric names its cells under
``workloads``.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that no run may load (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "lifelong_nnunet_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_cell(name: str) -> tuple:
    """(workload, config, traffic) of the cell ``name``."""
    cell = load_json("workloads", f"{name}.json")
    return cell, load_json("configs", f"{cell['config']}.json"), \
        load_json("traffic", f"{cell['traffic']}.json")


def load_metric(name: str):
    """The reader module ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(spec: dict, cell: str) -> tuple:
    """(end-to-end, per-layer) metric entries of ``cell``."""
    e2e = [m for m in spec["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    return e2e, [m for m in spec["per_layer"] if cell in m["workloads"]]


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


class Run:
    """One run of one cell: its arguments and files, and what its entry
    measured (``e2e``, ``stats``, ``checks``)."""

    def __init__(self, workload: str, seed: int, seconds: float, trace: bool,
                 device: torch.device, t_start: float, files=None):
        self.workload, self.seed, self.seconds, self.trace = workload, seed, seconds, trace
        self.device, self.t_start = device, t_start
        self.cell, self.config, self.traffic = files or load_cell(workload)
        self.tmp = tempfile.mkdtemp(prefix=f"bench_{workload}_")
        self.e2e: dict = {}
        self.stats: dict = {}
        self.checks: list = []          # (name, value, limit)
        self.attempted = self.failed = 0
        self.memory_peak = 0

    @property
    def batch(self) -> int:
        c = self.config["plans"]["configurations"][self.config["config_name"]]
        return int(c["batch_size"])

    def limit(self, name: str) -> float:
        return float(self.cell["limits"][name])

    def check(self, name: str, value: float) -> None:
        self.checks.append((name, float(value), self.limit(name)))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(v <= lim for _, v, lim in self.checks)

    def close(self) -> None:
        shutil.rmtree(self.tmp, ignore_errors=True)


def entry(run: Run):
    return importlib.import_module(f"benchmark.entries.{run.traffic['entry']}")


def execute(run: Run, warm: bool = True) -> dict:
    """Set-up (with its warm-up), window, (traced window), check: the
    entry's stages.  Returns the entry's state after its check."""
    ent = entry(run)
    state = ent.setup(run)
    if warm:
        ent.warm(run, state)
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    run.e2e["setup_s"] = time.perf_counter() - run.t_start
    ent.window(run, state)
    if run.device.type == "cuda":
        run.memory_peak = torch.cuda.max_memory_allocated(run.device)
    if run.trace:
        ent.traced(run, state)
    ent.check(run, state)
    return state


def result(run: Run, spec: dict) -> dict:
    e2e, per_layer = cell_metrics(spec, run.workload)
    metrics = {}
    if run.trace:
        for m in per_layer:
            value = load_metric(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": float(run.e2e[m["name"]]), "unit": m["unit"]}
    dev = run.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": 1, "memory_peak_bytes": int(run.memory_peak)}
    out = {"correct": run.correct, "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": metrics, "device": device}
    tr = run.stats.get("trace")
    if run.trace and tr:
        device["busy_s"], device["window_s"] = tr["busy_s"], tr["window_s"]
        out["breakdown"] = tr["breakdown"]
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in run.checks}
    return out


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Run one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    chips = {w["name"]: w["chips"] for w in spec["workloads"]}
    if args.workload not in chips:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips[args.workload]:
        print(f"the cell needs {chips[args.workload]} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 3
    run = Run(args.workload, args.seed, args.seconds, bool(args.trace),
              torch.device("cuda", 0), t_start)
    try:
        execute(run)
    finally:
        run.close()
    found = forbidden_modules()
    if found:
        print(f"the run loaded forbidden modules: {found}", file=sys.stderr)
        return 4
    line = result(run, spec)
    print(f"card: {card()}", file=sys.stderr)
    for name, value, lim in run.checks:
        print(f"check {name} = {value!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
