"""The port stands alone: nothing under ``src/repro_torch/`` and nothing in
``chip_smoke.py`` imports ``jax`` or ``repro``, and the entry points run on
the card unless the caller asks for the CPU."""
import ast
import os
import subprocess
import sys
import tempfile
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
    # the feedback fit, index load and a checkpoint restore onto a device
    # go to the card by default too
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.feedback.fit import fit_from_records

    recs = [{"kind": "batch", "seq": 0, "batch": 2,
             "signals": {"features": [[0.0, 1.0, 2.0], [1.0, 0.0, 2.0]],
                         "hardness": [0.0, 1.0]},
             "route": {"easy_idx": [0], "hard_idx": [1]},
             "needed_wide": [False, True]}]
    with pytest.raises((AssertionError, RuntimeError)):
        fit_from_records(recs, epochs=2)
    with tempfile.TemporaryDirectory() as d:
        idx.save(os.path.join(d, "idx"))
        with pytest.raises((AssertionError, RuntimeError)):
            GateIndex.load(os.path.join(d, "idx"))
        mgr = CheckpointManager(os.path.join(d, "ckpt"))
        mgr.save(1, {"w": np.zeros(3, np.float32)}, blocking=True)
        assert isinstance(mgr.restore()[0]["w"], np.ndarray)  # host by default
        with pytest.raises((AssertionError, RuntimeError)):
            mgr.restore(device="cuda")
    # the kernel API's cuda mode never runs the plain version on the CPU
    for call in (lambda: ops.l2dist(tq, tq, mode="cuda"),
                 lambda: ops.topk_min(tq, 2, mode="cuda"),
                 lambda: ops.twotower_score(tq, tq, mode="cuda"),
                 lambda: ops.gather_dist(tq[:, None, :], tq,
                                         torch.zeros((3, 1), dtype=torch.int32),
                                         mode="cuda")):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()


def test_public_surface_resolves_without_jax():
    """Every name of ``repro_torch.__all__`` (``repro``'s export table, plus
    ``exact_knn`` and ``recall_at_k``) and of ``repro_torch.core`` /
    ``repro_torch.graphs`` / ``repro_torch.models`` / ``repro_torch.serve``
    resolves, and the LM configs, models (the MoE, SSM, hybrid, RWKV and
    enc-dec modules among them), the training modules and both launchers
    import, in a fresh interpreter that has loaded neither
    ``jax`` nor ``repro`` afterwards."""
    code = (
        "import sys, repro_torch, repro_torch.core as c, repro_torch.graphs as g\n"
        "import repro_torch.models as mo, repro_torch.serve as sv\n"
        "import repro_torch.configs as cf, repro_torch.launch.serve\n"
        "import repro_torch.core.baselines, repro_torch.train.optim\n"
        "import repro_torch.models.moe as moe, repro_torch.models.encdec as ed\n"
        "import repro_torch.models.ssm as ssm, repro_torch.models.hybrid as hy\n"
        "import repro_torch.models.rwkv as rw, repro_torch.launch.train\n"
        "import repro_torch.train.loop, repro_torch.train.compress\n"
        "import repro_torch.data.pipeline, repro_torch.distributed.fault\n"
        "assert mo.EncDecLM is ed.EncDecLM\n"
        "assert callable(moe.moe_ffn) and callable(moe.moe_param_table)\n"
        "assert callable(ssm.ssd_chunked) and callable(rw.wkv6_chunked)\n"
        "assert mo.HybridLM is hy.HybridLM and mo.RWKVLM is rw.RWKVLM\n"
        "for m in (repro_torch, c, g, mo, sv, cf):\n"
        "    for n in m.__all__:\n"
        "        assert getattr(m, n) is not None, n\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
        "assert not bad, bad\n"
        "print(len(repro_torch.__all__))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    import repro_torch

    want = {
        "AdaptiveController", "DEFAULT_LADDER", "LadderRung", "VotePolicy",
        "HardnessRouter", "RouteReport", "route_buckets", "RollingWindow",
        "MetricsExporter", "MetricsRegistry", "get_registry", "registry_sink",
        "SearchRequest", "ServeDaemon", "QueryLog", "ShadowOversearch",
        "NSG", "QuantizedDb", "quantize_db", "resolve_search_params",
        "search_jit_cache_size", "HardnessPredictor", "load_predictor",
        "GateConfig", "GateIndex", "SearchParams", "SearchResult",
        "SearchTelemetry", "batched_search", "build_nsg", "summarize",
        "exact_knn", "recall_at_k", "RagPipeline",
    }
    assert set(repro_torch.__all__) == want and len(want) == 34
    assert int(out.stdout.strip()) == len(want)
    from repro_torch.core import (  # noqa: F401
        cluster_size_variance, hbkm, hop_counts, kmeans_hubs)
    from repro_torch.graphs import search_jit_cache_size  # noqa: F401
    from repro_torch.serve.retrieval import RagPipeline

    assert repro_torch.RagPipeline is RagPipeline


def test_new_subpackages_are_scanned():
    """The scan of the first test covers the LM stack's subpackages."""
    files = {f.relative_to(ROOT / "src" / "repro_torch").parts[0]
             for f in (ROOT / "src" / "repro_torch").rglob("*.py")}
    assert {"configs", "models", "launch", "serve", "train", "core"} <= files


def test_lm_entry_points_default_to_the_card():
    from repro_torch.configs import get_reduced
    from repro_torch.models.model import build_model, make_cache, make_inputs
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.retrieval import RagPipeline

    cfg = get_reduced("gemma-2b")
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    if torch.cuda.is_available():
        assert ServeEngine(cfg, params).device.type == "cuda"
        return
    with pytest.raises((AssertionError, RuntimeError)):
        ServeEngine(cfg, params)
    with pytest.raises((AssertionError, RuntimeError)):
        make_cache(cfg, 1, 8)
    from repro_torch.configs.base import ShapeSpec

    with pytest.raises((AssertionError, RuntimeError)):
        make_inputs(cfg, ShapeSpec("s", "decode", 8, 1))
    assert RagPipeline(None, None, np.zeros((2, 2), np.int32)).device == "cuda"
