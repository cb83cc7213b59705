"""General utilities: the port of
``lifelong_nnunet_tpu/utilities/helpful_functions.py`` (the reference's
``nnunet_ext/utilities/helpful_functions.py``), under the same names.

:func:`get_nr_parameters` / :func:`get_model_size` count an ``nn.Module``'s
parameters or a ``state_dict``'s tensors.  :func:`nested_dict_to_dataframe`
and :func:`dumpDataFrameToCsv` import pandas inside the function, as the
JAX module does: pandas is no dependency of the port, and nothing on a
training or serving path calls them.
"""

from __future__ import annotations

import contextlib
import io
import math
import os
import shutil
import sys

import torch


# -- directory operations (reference :15-58) --------------------------------

def delete_dir_con(path: str) -> None:
    """Delete a directory including content."""
    if os.path.isdir(path):
        shutil.rmtree(path)


def copy_dir(src: str, dst: str) -> None:
    shutil.copytree(src, dst, dirs_exist_ok=True)


def move_dir(src: str, dst: str) -> None:
    os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
    shutil.move(src, dst)


# -- strings (reference :60-68) ----------------------------------------------

def join_texts_with_char(texts, char: str = "_") -> str:
    return char.join(str(t) for t in texts)


# -- nested dict -> DataFrame -> csv (reference :129-205) ---------------------

def flatten_nested_dict(d: dict, parent: tuple = ()) -> dict:
    """{(k1, k2, ...): leaf} from arbitrarily nested dicts."""
    out = {}
    for k, v in d.items():
        key = parent + (k,)
        if isinstance(v, dict):
            out.update(flatten_nested_dict(v, key))
        else:
            out[key] = v
    return out


def nested_dict_to_dataframe(d: dict, level_names=None):
    import pandas as pd
    flat = flatten_nested_dict(d)
    idx = pd.MultiIndex.from_tuples(list(flat.keys()), names=level_names)
    return pd.DataFrame({"value": list(flat.values())}, index=idx)


def dumpDataFrameToCsv(df, path: str, name: str | None = None) -> str:
    if not path.endswith(".csv"):
        os.makedirs(path, exist_ok=True)
    full = os.path.join(path, name) if name else path
    df.to_csv(full)
    return full


# -- common divisors (reference :268-286) -------------------------------------

def commDiv(a: int, b: int) -> list:
    """All common divisors of a and b (used for the ViT patch-size rule)."""
    g = math.gcd(int(a), int(b))
    return [d for d in range(1, g + 1) if g % d == 0]


# -- model introspection (reference :302-326) ---------------------------------

def get_nr_parameters(params) -> int:
    """Total parameter count of an ``nn.Module`` or a ``state_dict``."""
    tensors = params.parameters() if isinstance(params, torch.nn.Module) else params.values()
    return int(sum(t.numel() for t in tensors))


def get_model_size(params, bits: int = 32) -> float:
    """Model size in MB."""
    return get_nr_parameters(params) * (bits / 8) / 2 ** 20


# -- stdout suppression (reference :359-370) ----------------------------------

@contextlib.contextmanager
def suppress_stdout():
    old = sys.stdout
    sys.stdout = io.StringIO()
    try:
        yield
    finally:
        sys.stdout = old


# -- log writer (reference :329-356): see utilities/logging_utils.RunLogger ---
from .logging_utils import RunLogger  # noqa: E402,F401  (re-export)
