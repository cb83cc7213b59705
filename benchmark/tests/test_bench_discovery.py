"""``BENCHMARK.json`` keeps to the benchmark's contract, every name in it
resolves to a file of its own, and a new cell or metric needs new files
and entries only: no file that is there changes."""

import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_and_entry_keys():
    spec = _spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51 and isinstance(spec["run_seconds"], int)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_budget():
    spec = _spec()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in spec[k]]
    for w in spec["workloads"]:
        names += [w["config"], w["traffic"]]
    assert all(NAME.match(n) for n in names), names
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in spec[k]}) == len(spec[k])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    # a full check of 24 cells fits in 43200 s
    n = 24
    assert (2 + 14 * n) * (spec["run_seconds"] + 60) + n * 2 * 90 + 1200 <= 43200


def test_every_cell_reports_what_it_must():
    spec = _spec()
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in spec["workloads"]:
        mine, layers = harness.cell_metrics(spec, w["name"])
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert layers
        for m in layers:
            assert m["moves"] in {x["name"] for x in mine}
        assert len({(w["config"], w["traffic"]) for w in spec["workloads"]}) \
            == len(spec["workloads"])


def test_names_resolve_to_files():
    spec = _spec()
    for c in spec["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"] and conf["assumed"]
        assert all(k in conf for k in c["reduced"])
    for w in spec["workloads"]:
        cell, conf, traffic = harness.load_cell(w["name"])
        assert (cell["config"], cell["traffic"]) == (w["config"], w["traffic"])
        assert os.path.isfile(os.path.join(harness.HERE, "entries", f"{traffic['entry']}.py"))
        assert cell["limits"]
    for m in spec["per_layer"]:
        assert hasattr(harness.load_metric(m["name"]), "read")
    layers = {m["layer"] for m in spec["per_layer"]}
    assert all("\n" not in x and len(x) <= 200 for x in layers)


def _digest(root):
    out = {}
    for base, _, names in os.walk(root):
        for n in names:
            p = os.path.join(base, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = hashlib.sha256(f.read()).hexdigest()
    return out


def test_new_cell_and_metric_take_new_files_only(tmp_path):
    """Copy the benchmark beside a link to the program, add a cell (the
    tiny 3D training cell's files under new names) and a metric by new
    files and new entries, and run the new cell on the CPU there."""
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    os.symlink(os.path.join(ROOT, "lifelong_nnunet_tpu_torch"),
               tmp_path / "lifelong_nnunet_tpu_torch")
    before = _digest(tmp_path / "benchmark")
    files = tmp_path / "benchmark" / "tests" / "files"
    b = tmp_path / "benchmark"
    shutil.copy(files / "configs" / "tiny3d.json", b / "configs" / "newconf.json")
    shutil.copy(files / "traffic" / "tiny3d_train.json", b / "traffic" / "newtraffic.json")
    with open(files / "workloads" / "tiny3d_train.json") as f:
        cell = json.load(f)
    cell.update(config="newconf", traffic="newtraffic")
    with open(b / "workloads" / "newcell.json", "w") as f:
        json.dump(cell, f)
    with open(b / "metrics" / "steps_seen.train.py", "w") as f:
        f.write("def read(run):\n    return run.stats.get('steps')\n")
    spec = _spec()
    spec["workloads"].append({"name": "newcell", "config": "newconf", "traffic": "newtraffic",
                              "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "steps_seen.train", "unit": "steps", "better": "higher",
                              "source": "program_counter", "layer": "host input",
                              "moves": "train_step_ms", "workloads": ["newcell"]})
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(spec, f)
    code = (
        "import json, time, torch\n"
        "from benchmark import harness\n"
        "spec = json.load(open('BENCHMARK.json'))\n"
        "run = harness.Run('newcell', 3, 0.3, True, torch.device('cpu'), time.perf_counter())\n"
        "harness.execute(run); run.close()\n"
        "print(json.dumps(harness.result(run, spec)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["metrics"]["steps_seen.train"]["value"] > 0
    after = _digest(tmp_path / "benchmark")
    assert all(after[k] == v for k, v in before.items())


def test_a_folder_without_the_program_gives_no_result(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "ct3d_train",
                          "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()


@pytest.mark.parametrize("name", ["ct3d_train", "ct3d_serve"])
def test_cell_sizes_fit_a_check(name):
    """Each traffic's work per run is fixed: shapes are listed, not drawn;
    a train traffic holds the configuration's number of training cases."""
    _, conf, traffic = harness.load_cell(name)
    patch = conf["plans"]["configurations"][conf["config_name"]]["patch_size"]
    for shape in traffic["case_shapes"]:
        assert len(shape) == 3 and all(s > 0 for s in shape)
        assert math.prod(shape) >= math.prod(patch)
    if traffic["entry"] == "train":
        assert len(traffic["case_shapes"]) == conf["training_cases"]
