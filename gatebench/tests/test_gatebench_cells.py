"""Every cell, configuration, mix and metric is found by name, and one is
added by adding files alone."""
import json
import shutil
from pathlib import Path

import pytest

from gatebench import cells

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in MANIFEST["workloads"]]
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


@pytest.mark.parametrize("name", WORKLOADS)
def test_each_cell_is_found_with_its_files(name):
    cell = cells.find_cell(name)
    w = next(w for w in MANIFEST["workloads"] if w["name"] == name)
    assert cell.config["name"] == w["config"]
    assert cell.mix["name"] == w["traffic"]
    assert cell.chips == w["chips"] == 1
    assert {"id_mismatch", "hops_mismatch", "dist_gap", "sample_recall",
            "bad_edges", "unreachable", "bad_hubs",
            "prune_violations"} <= set(cell.limits)
    e2e = {m["name"] for m, _ in cell.end_to_end}
    assert {"setup_s", "recall_at_10"} <= e2e and len(e2e) >= 3
    assert cell.per_layer
    for m, mod in cell.per_layer:
        assert mod.MOVES == m["moves"] and m["moves"] in e2e


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_each_metric_has_its_reader(metric):
    path = ROOT / "gatebench" / "metrics" / f"{metric}.py"
    mod = cells.load_reader(path)
    entry = next(m for m in METRICS if m["name"] == metric)
    assert mod.MOVES == entry.get("moves")


@pytest.mark.parametrize("config", MANIFEST["configs"], ids=lambda c: c["name"])
def test_each_configuration_states_its_cut(config):
    cfg = json.loads((ROOT / config["file"]).read_text())
    assert cfg["name"] == config["name"] and cfg["source"] == config["source"]
    assert cfg["reduced"] == config["reduced"]
    assert set(cfg["reduced"]) <= set(cfg["published"]) and cfg["assumed"]
    from gatebench.data import PROFILES

    assert PROFILES[cfg["profile"]].dim == cfg["dim"]


def test_an_added_cell_needs_no_edit(tmp_path):
    """A throwaway configuration, mix and metric, in a copy of the
    benchmark's folder, are found by the names a new manifest gives them,
    and no file that was there changes."""
    bench = tmp_path / "gatebench"
    shutil.copytree(ROOT / "gatebench", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    cfg = json.loads((bench / "configs" / "sift128-250k.json").read_text())
    (bench / "configs" / "gist960-50k.json").write_text(json.dumps(
        dict(cfg, name="gist960-50k", profile="gist1m-like", dim=960,
             rows=50_000)))
    (bench / "traffic" / "batch1k.json").write_text(json.dumps(
        {"name": "batch1k", "batch": 1024, "pool": 4, "check_sample": 512}))
    (bench / "metrics" / "search.merge_ms.py").write_text(
        'MOVES = "qps"\n\ndef read(run):\n    return 1.0\n')
    (bench / "limits" / "gist960-50k.batch1k.json").write_text(
        json.dumps({"id_mismatch": 0.0}))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "gist960-50k", "source": "x",
                                "file": "gatebench/configs/gist960-50k.json",
                                "reduced": ["rows"], "why": "x"})
    manifest["workloads"].append({"name": "gist960-50k.batch1k",
                                  "config": "gist960-50k",
                                  "traffic": "batch1k", "chips": 1,
                                  "why": "x"})
    for m in manifest["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("gist960-50k.batch1k")
    manifest["per_layer"].append({"name": "search.merge_ms", "unit": "ms",
                                  "better": "lower", "source": "device_trace",
                                  "layer": "search", "moves": "qps"})
    cell = cells.find_cell("gist960-50k.batch1k", manifest, bench)
    assert cell.config["dim"] == 960 and cell.mix["batch"] == 1024
    assert {m["name"] for m, _ in cell.end_to_end} == {
        "qps", "recall_at_10", "setup_s"}
    names = {m["name"] for m, _ in cell.per_layer}
    assert {"search.merge_ms", "search.lockstep_pct", "build.nsg_s"} <= names
    assert "k1_roofline" not in names and "k2_roofline" not in names
    added = {"gist960-50k.json", "batch1k.json", "search.merge_ms.py",
             "gist960-50k.batch1k.json"}
    after = {p: p.read_bytes() for p in bench.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert {p.name for p in set(after) - set(before)} == added
    assert all(after[p] == b for p, b in before.items())


def test_an_unknown_cell_is_an_error():
    with pytest.raises(KeyError):
        cells.find_cell("no-such-config.batch10k")
