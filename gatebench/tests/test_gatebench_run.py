"""The harness runs a cell end to end at a tiny size on the CPU (the port's
plain kernels) and prints the result line; ``run.py`` itself refuses
to run without a card."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from gatebench import bench

from ._tiny import run_tiny, tiny_cell

ROOT = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("name", ["sift128-250k.batch10k",
                                  "laion512-ood-100k.batch10k",
                                  "sift128-250k.batch10k-q8"])
def test_a_tiny_run_prints_the_result_line(name):
    cell = tiny_cell(name)
    out = run_tiny(cell)
    line = json.loads(bench.result_line(out))
    assert list(line) == KEYS
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    want = {m["name"] for m, _ in cell.end_to_end}
    assert set(line["metrics"]) == want
    for m, _ in cell.end_to_end:
        assert line["metrics"][m["name"]]["unit"] == m["unit"]
        assert line["metrics"][m["name"]]["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["checks"]) == set(cell.limits)
    for c in line["checks"].values():
        if isinstance(c["limit"], dict):
            assert c["value"] >= c["limit"]["at_least"]
        else:
            assert c["value"] <= c["limit"]
    assert line["checks"]["id_mismatch"]["value"] == 0.0


def test_run_py_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "gatebench/run.py", "--workload",
         "sift128-250k.batch10k", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def test_run_py_fails_beside_nothing_but_the_benchmark(tmp_path):
    """In a folder that holds only the manifest and the benchmark's files
    (no program), a run fails and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gatebench", tmp_path / "gatebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "gatebench/run.py", "--workload",
         "sift128-250k.batch10k", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """What a run imports, in a process of its own: a tiny CPU run, then the
    top-level names of ``sys.modules``."""
    code = (
        "import sys; sys.path[:0] = ['.', 'src']\n"
        "from gatebench.tests._tiny import tiny_cell, run_tiny\n"
        "from gatebench import bench\n"
        "run_tiny(tiny_cell('laion512-ood-100k.batch10k'))\n"
        "print(bench.forbidden_modules())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
