"""Filesystem roots and default identifiers, driven by environment variables.

Mirrors the behavior of the reference's ``nnunet_ext/paths.py:20-74``: five
environment variables define the raw / preprocessed / results / evaluation /
param-search roots; directories are created on demand.  Unlike the reference
(which hard-fails on import if env vars are missing) we resolve lazily so the
library is importable in hermetic test environments.
"""

from __future__ import annotations

import os

# Default identifiers (reference: nnunet_ext/paths.py:9-12).
default_plans_identifier = "nnUNetPlansv2.1"
default_trainer = "nnUNetTrainerSequential"
default_data_identifier = "nnUNetData_plans_v2.1"

_ENV_VARS = {
    "raw": "nnUNet_raw_data_base",
    "preprocessed": "nnUNet_preprocessed",
    "results": "RESULTS_FOLDER",
    "evaluation": "EVALUATION_FOLDER",
    "param_search": "PARAM_SEARCH_FOLDER",
}


def _root(kind: str, create: bool = True) -> str | None:
    env = os.environ.get(_ENV_VARS[kind])
    if env is None:
        return None
    if create:
        os.makedirs(env, exist_ok=True)
    return env


def raw_data_base(create: bool = True) -> str | None:
    return _root("raw", create)


def raw_data_dir(create: bool = True) -> str | None:
    base = _root("raw", create)
    if base is None:
        return None
    p = os.path.join(base, "nnUNet_raw_data")
    if create:
        os.makedirs(p, exist_ok=True)
    return p


def preprocessed_dir(create: bool = True) -> str | None:
    return _root("preprocessed", create)


def results_dir(create: bool = True) -> str | None:
    base = _root("results", create)
    if base is None:
        return None
    # Reference stores extension models under RESULTS_FOLDER/nnUNet_ext.
    p = os.path.join(base, "nnUNet_ext")
    if create:
        os.makedirs(p, exist_ok=True)
    return p


def evaluation_dir(create: bool = True) -> str | None:
    base = _root("evaluation", create)
    if base is None:
        return None
    p = os.path.join(base, "nnUNet_ext")
    if create:
        os.makedirs(p, exist_ok=True)
    return p


def param_search_dir(create: bool = True) -> str | None:
    return _root("param_search", create)


def require(path: str | None, what: str) -> str:
    if path is None:
        raise RuntimeError(
            f"Environment variable for {what} is not set. Set "
            f"{', '.join(_ENV_VARS.values())} to use the CLI (see README)."
        )
    return path
