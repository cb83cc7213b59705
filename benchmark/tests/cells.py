"""Tiny cells for the CPU tests (``files/``: a 3D and a 2D configuration
of the benchmark's topology at a few voxels and features), run through the
harness's stages on the CPU."""

from __future__ import annotations

import json
import os
import time

import pytest
import torch

from benchmark import harness

FILES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "files")


def files(name: str) -> tuple:
    def load(*p):
        with open(os.path.join(FILES, *p)) as f:
            return json.load(f)
    cell = load("workloads", f"{name}.json")
    return cell, load("configs", f"{cell['config']}.json"), \
        load("traffic", f"{cell['traffic']}.json")


def run_cell(name: str, seed: int = 2 ** 31 + 17, trace: bool = False,
             seconds: float = 0.5) -> tuple:
    """(run, state) of one whole run of the tiny cell ``name`` on the CPU."""
    run = harness.Run(name, seed, seconds, trace, torch.device("cpu"), time.perf_counter(),
                      files=files(name))
    try:
        return run, harness.execute(run)
    finally:
        run.close()


def require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
