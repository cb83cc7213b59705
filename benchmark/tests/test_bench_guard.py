"""Nothing the benchmark runs loads JAX or the JAX package: top-level module
names compared whole (the port's name begins with the JAX package's)."""

import ast
import os
import subprocess
import sys

from benchmark import harness

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_forbidden_names_are_compared_whole(monkeypatch):
    fake = object()
    for name in ("jaxtyping", "lifelong_nnunet_tpu_torch_extra", "flaxen"):
        monkeypatch.setitem(sys.modules, name, fake)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "lifelong_nnunet_tpu.ops", fake)
    monkeypatch.setitem(sys.modules, "jaxlib", fake)
    assert harness.forbidden_modules() == ["jaxlib", "lifelong_nnunet_tpu"]


def test_a_run_loads_no_forbidden_module():
    """Import everything a run imports (the harness, both entries, the
    references, every metric's reader) in a fresh interpreter."""
    code = (
        "import os, sys\n"
        "from benchmark import harness, limits\n"
        "from benchmark.entries import train, serve\n"
        "for f in os.listdir(os.path.join(harness.HERE, 'metrics')):\n"
        "    harness.load_metric(f[:-3])\n"
        "import lifelong_nnunet_tpu_torch.inference.predict\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.dirname(HERE), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_sources_import_no_forbidden_name():
    for root, _, names in os.walk(HERE):
        for name in names:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(root, name)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                mods = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                    [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level \
                    else []
                for m in mods:
                    assert m.split(".")[0] not in harness.FORBIDDEN, (name, m)
