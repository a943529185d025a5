"""The harness's own rules, on the CPU: what it imports, the manifest's
names and files, and that it never runs a cell without a card."""

from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "stif_tpu"}
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def imports(path: Path) -> set:
    """Top-level names of every module ``path`` imports, whole."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_imports(path):
    assert not imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "stif_tpu_torch" not in imports(path)


def test_manifest_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    names = []
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        names += [c["name"], *c["reduced"]]
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        names += [w["name"], w["config"], w["traffic"]]
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in MANIFEST["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                          "device_trace")
    assert all(NAME.match(n) for n in names), names
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in MANIFEST[group]]
        assert len(got) == len(set(got)), group


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    w = next(x for x in MANIFEST["workloads"] if x["name"] == cell)
    config = next(c for c in MANIFEST["configs"] if c["name"] == w["config"])
    assert (ROOT / config["file"]) == BENCH / "configs" / f"{w['config']}.json"
    spec = json.loads((BENCH / "cells" / f"{cell}.json").read_text())
    assert (BENCH / "entries" / f"{spec['entry']}.py").is_file()
    assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    for m in MANIFEST["per_layer"]:
        if cell in m.get("workloads", [cell]):
            assert harness.reader_path(m["name"]).is_file(), m["name"]


def test_a_reader_serves_the_names_it_prefixes():
    assert harness.reader_path("mfu.train") == BENCH / "metrics" / "mfu.py"
    assert (harness.reader_path("dcn_fwd_roofline.train.b18")
            == BENCH / "metrics" / "dcn_fwd_roofline.py")
    assert not harness.reader_path("no_such_metric.serve").is_file()


@pytest.mark.parametrize("metric", MANIFEST["per_layer"],
                         ids=lambda m: m["name"])
def test_every_cell_of_a_layer_metric_reports_what_it_moves(metric):
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    moved = e2e[metric["moves"]]
    for cell in metric["workloads"]:
        assert cell in CELLS
        assert cell in moved.get("workloads", CELLS)


def test_every_cell_reports_setup_and_a_metric():
    for cell in CELLS:
        got = [m["name"] for m in MANIFEST["end_to_end"]
               if cell in m.get("workloads", CELLS)]
        assert "setup_s" in got and len(got) >= 2, cell
        assert any(cell in m.get("workloads", CELLS)
                   for m in MANIFEST["per_layer"]), cell


def _run(cwd: Path):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_without_a_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the CPU's refusal")
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
