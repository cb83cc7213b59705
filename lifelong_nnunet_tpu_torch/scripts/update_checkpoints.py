"""CLI: rewrite paths recorded in a results tree after relocating it —
``nnUNet_torch_update_checkpoints`` (one model tree) and
``nnUNet_torch_update_checkpoints_all`` (everything under
``RESULTS_FOLDER``), the port's copy of
``lifelong_nnunet_tpu/scripts/update_checkpoints.py`` (reference
``nnunet_ext/scripts/update_checkpoints.py:212-254``).

The port's ``.pt`` checkpoints hold no path (``training/checkpoints.py``),
so only the JSON files (manifests, ``*_trained_on.json``, metrics) are
searched: every string holding ``-old`` is rewritten with ``-new``.
"""

from __future__ import annotations

import argparse
import json
import os


def _replace(obj, old: str, new: str):
    if isinstance(obj, str):
        return obj.replace(old, new)
    if isinstance(obj, list):
        return [_replace(v, old, new) for v in obj]
    if isinstance(obj, dict):
        return {k: _replace(v, old, new) for k, v in obj.items()}
    return obj


def update_tree(root: str, old: str, new: str, verbose: bool = True) -> int:
    n = 0
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            if not f.endswith(".json"):
                continue
            p = os.path.join(dirpath, f)
            with open(p) as fh:
                try:
                    data = json.load(fh)
                except json.JSONDecodeError:
                    continue
            new_data = _replace(data, old, new)
            if new_data != data:
                with open(p, "w") as fh:
                    json.dump(new_data, fh, indent=2)
                n += 1
                if verbose:
                    print(f"updated {p}")
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-path", required=True, help="folder of one model tree")
    p.add_argument("-old", required=True, help="old path prefix")
    p.add_argument("-new", required=True, help="new path prefix")
    args = p.parse_args(argv)
    n = update_tree(args.path, args.old, args.new)
    print(f"{n} manifest(s) updated")


def main_all(argv=None):
    from .. import paths
    p = argparse.ArgumentParser(description="update every model under RESULTS_FOLDER")
    p.add_argument("-old", required=True)
    p.add_argument("-new", required=True)
    args = p.parse_args(argv)
    root = paths.require(paths.results_dir(create=False), "results")
    n = update_tree(root, args.old, args.new)
    print(f"{n} manifest(s) updated")


if __name__ == "__main__":
    main()
