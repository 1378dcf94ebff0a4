"""A cell of ``BENCHMARK.json`` and the files it is made of, found by name.

- the configuration: the file its ``configs`` entry names
  (``configs/<config>.json``);
- the traffic mix: ``traffic/<traffic>.json``;
- the limits of the numbers that decide ``correct``: ``limits/<cell>.json``;
- each metric the cell reports: ``metrics/<metric>.py``, a module with
  ``read(run)`` that returns the metric's value or ``None`` where it finds
  nothing to read (optionally ``REPLAY``: the hop kernels whose bounds the
  harness sums over the window's calls for it).

An end-to-end metric belongs to the cells its ``workloads`` list, or to
every cell without one; a per-layer metric to the cells its ``workloads``
list, or without one to every cell that reports the end-to-end metric it
``moves``.  So a cell, a configuration, a mix or a metric is added by
adding files and entries, and no file that is there changes.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

BENCH_DIR = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    chips: int
    end_to_end: List[Tuple[dict, object]]   # (manifest entry, reader module)
    per_layer: List[Tuple[dict, object]]
    limits: dict


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_reader(path: Path):
    """A metric's reader module, loaded from its file (names hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "gatebench_metric_" + path.stem.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not callable(getattr(mod, "read", None)):
        raise TypeError(f"{path}: a metric's file defines read(run)")
    return mod


def find_cell(name: str, manifest: Optional[dict] = None,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``manifest`` (default: ``BENCHMARK.json`` beside
    ``bench_dir``), its files read from ``bench_dir``."""
    bench_dir = Path(bench_dir)
    root = bench_dir.parent
    if manifest is None:
        manifest = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in the manifest: "
                       f"{sorted(cells)}")
    w = cells[name]
    cfg_entry = next(c for c in manifest["configs"] if c["name"] == w["config"])
    e2e = [m for m in manifest["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    moved = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]

    def readers(entries):
        return [(m, load_reader(bench_dir / "metrics" / f"{m['name']}.py"))
                for m in entries]

    return Cell(
        name=name,
        config=load_json(root / cfg_entry["file"]),
        mix=load_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        chips=int(w["chips"]),
        end_to_end=readers(e2e),
        per_layer=readers(layer),
        limits=load_json(bench_dir / "limits" / f"{name}.json"),
    )
