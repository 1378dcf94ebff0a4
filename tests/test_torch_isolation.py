"""The port stands alone: nothing under ``src/repro_torch/`` and nothing in
``chip_smoke.py`` imports ``jax`` or ``repro``, and the entry points run on
the card unless the caller asks for the CPU."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import GateConfig, GateIndex, SearchParams, batched_search
from repro_torch.kernels import ops
from repro_torch.serve.daemon import ServeDaemon

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


def test_port_and_chip_smoke_import_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = [
        f"{f.relative_to(ROOT)}:{line}: {mod}"
        for f in files for line, mod in _imported_modules(f)
        if mod.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad


def test_entry_points_default_to_the_card():
    rng = np.random.default_rng(0)
    db = rng.standard_normal((64, 8)).astype(np.float32)
    nbrs = rng.integers(0, 64, (64, 4)).astype(np.int32)
    q = db[:3]
    entries = np.zeros((3, 1), np.int32)
    tq = torch.from_numpy(q)
    if torch.cuda.is_available():
        res = batched_search(db, nbrs, q, entries, SearchParams(k=2))
        assert res.ids.is_cuda
        assert ops.l2dist(tq.cuda(), tq.cuda(), mode="cuda").is_cuda
        return
    # no card here: the default device must fail, never fall back to the CPU
    with pytest.raises((AssertionError, RuntimeError)):
        batched_search(db, nbrs, q, entries, SearchParams(k=2))
    with pytest.raises((AssertionError, RuntimeError)):
        GateIndex.build(db, q, GateConfig(n_hubs=2, epochs=1), R=4, knn_k=4,
                        search_l=8, pool_size=8)
    # the serving daemon searches on the card: warm-up must fail here
    idx = GateIndex.build(db, q, GateConfig(n_hubs=2, epochs=1, batch_hubs=2),
                          R=4, knn_k=4, search_l=8, pool_size=8, device="cpu")
    daemon = ServeDaemon(idx, batch_size=3)
    assert daemon.device == "cuda"
    try:
        with pytest.raises((AssertionError, RuntimeError)):
            daemon.start()
    finally:
        daemon.stop()
    # the kernel API's cuda mode never runs the plain version on the CPU
    for call in (lambda: ops.l2dist(tq, tq, mode="cuda"),
                 lambda: ops.topk_min(tq, 2, mode="cuda"),
                 lambda: ops.twotower_score(tq, tq, mode="cuda"),
                 lambda: ops.gather_dist(tq[:, None, :], tq,
                                         torch.zeros((3, 1), dtype=torch.int32),
                                         mode="cuda")):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
