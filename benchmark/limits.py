"""Read the numbers that set a cell's limits, on the card, at the cell's
own size (not part of a benchmark run):

    python3 benchmark/limits.py --workload NAME --seeds S1 S2 ... \
        [--control-seeds N] [--seconds S] [--out FILE]

For every seed, one run of the cell in this process (no warm-up, a short window)
gives the program's sound readings; for the first ``--control-seeds`` of
them the entry's ``control`` also reads the control (the reference in
float8 in the program's place) and, for a train cell, the fault that
leaves half of each batch out.  Prints one JSON line per seed and writes
them all to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

T0 = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402


def readings(workload: str, seed: int, seconds: float, control: bool, device) -> dict:
    run = harness.Run(workload, seed, seconds, False, device, time.perf_counter())
    try:
        # no warm-up: it changes nothing that is compared
        state = harness.execute(run, warm=False)
        extra = {k: v for k, v in run.stats.get("check", {}).items() if not isinstance(v, list)}
        out = {"seed": seed, "program": dict({n: v for n, v, _ in run.checks}, **extra),
               "correct": run.correct, "e2e": run.e2e,
               "run_s": time.perf_counter() - run.t_start}
        if control:
            t = time.perf_counter()
            out.update(harness.entry(run).control(run, state))
            out["control_s"] = time.perf_counter() - t
        del state
        return out
    finally:
        run.close()
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("limits.py reads the card's numbers: no CUDA device")
    rows = []
    for i, seed in enumerate(args.seeds):
        row = readings(args.workload, seed, args.seconds, i < args.control_seeds,
                       torch.device("cuda", 0))
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
