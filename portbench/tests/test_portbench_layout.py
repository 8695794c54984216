"""The benchmark's files against BENCHMARK.json: names resolve, the
contract's characters and units hold, a new cell is data only, and no
module reaches JAX or the JAX package."""

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import spec

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "portbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_resolves_to_its_files():
    bench = spec.Bench(ROOT)
    for cell in BENCH["workloads"]:
        cfg = bench.config(cell["config"])
        assert cfg["name"] == cell["config"]
        traffic = bench.traffic(cell["traffic"])
        assert hasattr(spec.mix(traffic["kind"]), "Session")
        assert bench.limits(cell["name"])
        assert bench.end_to_end(cell["name"]) and bench.per_layer(cell["name"])
    for entry in BENCH["configs"]:
        assert (ROOT / entry["file"]).is_file()
        assert entry["file"].startswith(BENCH["paths"][0] + "/")
        assert json.loads((ROOT / entry["file"]).read_text())["reduced"] == entry["reduced"]
    for m in BENCH["per_layer"]:
        read, path = spec.reader(m["name"])
        assert callable(read) and path in ("serve", "train")


def test_names_and_units_use_the_allowed_characters():
    names = [c["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for c in BENCH[key]]
    names += [c[k] for c in BENCH["workloads"] for k in ("config", "traffic")]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({c["name"] for c in BENCH[key]}) == len(BENCH[key])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for c in BENCH["workloads"]:
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"] and c["chips"] in (1, 4)


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    for m in BENCH["per_layer"]:
        for cell in m["workloads"]:
            reported = {e["name"] for e in spec.Bench(ROOT).end_to_end(cell)}
            assert m["moves"] in reported, (m["name"], cell)
            assert "setup_s" in reported


def test_a_cell_added_as_data_is_picked_up(tmp_path):
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    data = dict(BENCH)
    data["workloads"] = BENCH["workloads"] + [
        {"name": "mn10_as.serve.b32", "config": "mn10_as", "traffic": "serve.b32",
         "chips": 1, "why": "a new cell"}]
    for key in ("end_to_end", "per_layer"):
        data[key] = [dict(m, workloads=m["workloads"] + ["mn10_as.serve.b32"])
                     if "mn10_as.serve.b64" in m.get("workloads", []) else m
                     for m in BENCH[key]]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    traffic = json.loads((HERE / "traffic" / "serve.b64.json").read_text())
    (tmp_path / "portbench" / "traffic" / "serve.b32.json").write_text(
        json.dumps(dict(traffic, batch=32)))
    (tmp_path / "portbench" / "cells" / "mn10_as.serve.b32.json").write_text(
        (HERE / "cells" / "mn10_as.serve.b64.json").read_text())
    bench = spec.Bench(tmp_path)
    assert bench.traffic(bench.cell("mn10_as.serve.b32")["traffic"])["batch"] == 32
    assert bench.limits("mn10_as.serve.b32") == bench.limits("mn10_as.serve.b64")
    assert {m["name"] for m in bench.per_layer("mn10_as.serve.b32")} == {
        m["name"] for m in bench.per_layer("mn10_as.serve.b64")}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    banned = {"jax", "jaxlib", "flax", "efficientat_tpu"}
    for path in HERE.rglob("*.py"):
        tops = {name.partition(".")[0] for name in _imports(path)}
        assert not tops & banned, (path, tops & banned)
    for path in (HERE / "reference").rglob("*.py"):
        tops = {name.partition(".")[0] for name in _imports(path)}
        assert "efficientat_tpu_torch" not in tops, path


def test_run_without_a_card_fails_and_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "mn10_as.serve.b64",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    if proc.returncode == 0:
        pytest.fail("a run without a card exited 0")
    assert proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr
