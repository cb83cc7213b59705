"""Timestamped run logging (reference ``print_to_log_file`` and the
standalone writer at ``utilities/helpful_functions.py:329-356``)."""

from __future__ import annotations

import os
import sys
from datetime import datetime


class RunLogger:
    def __init__(self, log_dir: str, name: str = "training", also_print: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        stamp = datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
        self.path = os.path.join(log_dir, f"{name}_log_{stamp}.txt")
        self.also_print = also_print

    def log(self, *args):
        msg = " ".join(str(a) for a in args)
        line = f"{datetime.now().isoformat(timespec='seconds')}: {msg}"
        with open(self.path, "a") as f:
            f.write(line + "\n")
        if self.also_print:
            print(line, file=sys.stdout, flush=True)

    def __call__(self, *args):
        self.log(*args)
