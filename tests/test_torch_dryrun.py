"""The dry-run tooling (``repro_torch.launch.trace_analysis``, ``dryrun``,
``roofline``, ``fill_experiments``) and the SWA prefill's rotation.

The pricing rules are held to hand counts on small programs run on a
"fake" process group of 4 ranks (each in a subprocess of its own: a
process holds one default group); the roofline row to ``repro``'s on a
fixed record with ``repro``'s constants; the trip-count extrapolation to a
run of every trip.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests._subproc import SRC

ROOT = os.path.dirname(SRC)


def run_port(code: str, timeout: int = 300) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=timeout, env=env)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return r.stdout


def last_json(out: str):
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith("JSON ")][-1][5:])


# ---------------------------------------------------------- pricing rules
PRICING = """
import json, torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.launch.dryrun import init_fake_world
from repro_torch.launch.mesh import make_host_mesh
from torch.distributed.tensor import Shard
from repro_torch.launch.cells import FakeLocal, ReplicateFallback
from repro_torch.launch.trace_analysis import OpTrace, analyze, mute_propagation
init_fake_world(4)
mesh = make_host_mesh((2, 2), device="cpu")
fake = FakeTensorMode(allow_non_fake_inputs=True)
with fake:
    a, b = torch.empty(64, 32), torch.empty(32, 16)
    x, y = torch.empty(3, 8, 5), torch.empty(3, 5, 7)
    p = torch.empty(4, 8)
    g = torch.empty(3, 4)
    r = torch.empty(2, 8)
    u = torch.empty(2, 3)
part = DTensor.from_local(p, mesh, (Partial(), Replicate()), run_check=False)
rows = DTensor.from_local(r, mesh, (Shard(0), Replicate()), run_check=False)
both = DTensor.from_local(u, mesh, (Shard(0), Shard(1)), run_check=False)
progs = {
    "mm": lambda: a @ b,
    "bmm": lambda: torch.bmm(x, y),
    "view": lambda: a.view(32, 64).t(),
    "partial_to_replicate": lambda: part.redistribute(
        mesh, (Replicate(), Replicate())),
    "all_gather": lambda: dist.all_gather(
        [torch.empty_like(g) for _ in range(4)], g),
    # no DTensor strategy: on the whole tensors, after a gather of the rows
    "no_strategy": lambda: torch.searchsorted(rows, rows),
    # 3 columns a rank cannot unflatten into 3 x 2 over "model"
    "uneven_view": lambda: both.view(4, 3, 2),
}
out = {}
for name, prog in progs.items():
    tr, fallbacks = OpTrace(), []
    with mute_propagation(tr), implicit_replication(), FakeLocal(fake), tr, \
            ReplicateFallback(fallbacks):
        res = prog()
    out[name] = analyze(tr.records)
    out[name]["fallbacks"] = fallbacks
    if isinstance(res, DTensor):
        out[name]["placements"] = [type(p).__name__ for p in res.placements]
        out[name]["shape"] = list(res.shape)
print("JSON", json.dumps(out))
"""


@pytest.fixture(scope="module")
def priced():
    return last_json(run_port(PRICING))


def test_a_matmul_is_priced_by_its_contracting_dim(priced):
    a = priced["mm"]
    assert a["dot_flops"] == 2 * 64 * 16 * 32
    assert a["dot_count"] == 1
    assert a["hbm_bytes"] == a["hbm_bytes_fused"] == 2 * 64 * 16 * 4
    assert a["collective_bytes"] == 0


def test_a_batched_matmul_counts_every_batch(priced):
    a = priced["bmm"]
    assert a["dot_flops"] == 2 * 3 * 8 * 7 * 5
    assert a["dot_count"] == 1
    assert a["hbm_bytes_fused"] == 2 * 3 * 8 * 7 * 4


def test_a_view_costs_nothing(priced):
    a = priced["view"]
    assert a["dot_flops"] == a["hbm_bytes"] == a["collective_bytes"] == 0
    assert a["num_ops"] == 0


def test_partial_to_replicate_is_one_all_reduce_at_twice_its_bytes(priced):
    """A sum pending over the "data" axis (size 2) of a (4, 8) float32
    local: one all-reduce of 128 bytes, priced 2 · 128 (ring)."""
    a = priced["partial_to_replicate"]
    assert a["collectives"] == {"all-reduce": {"count": 1.0, "bytes": 256.0}}
    assert a["collective_bytes"] == 256


def test_dist_all_gather_is_priced_on_what_it_gathers(priced):
    """``dist.all_gather`` of a (3, 4) float32 over 4 ranks: the 4 outputs,
    192 bytes."""
    a = priced["all_gather"]
    assert a["collectives"] == {"all-gather": {"count": 1.0, "bytes": 192.0}}


def test_an_op_without_a_strategy_runs_replicated_and_is_recorded(priced):
    """``searchsorted`` has no DTensor strategy: its row-sharded (4, 8)
    input (a (2, 8) float32 local) is gathered over "data" (64 bytes out)
    and the op runs on the whole tensor, its output replicated; the cell's
    fallbacks name it."""
    a = priced["no_strategy"]
    assert a["placements"] == ["Replicate", "Replicate"]
    assert a["shape"] == [4, 8]
    assert a["collectives"]["all-gather"]["bytes"] >= 4 * 8 * 4
    assert len(a["fallbacks"]) == 1
    assert "searchsorted" in a["fallbacks"][0]
    assert a["fallbacks"][0].endswith("; replicated")


def test_a_view_of_an_uneven_shard_keeps_the_batch_shard(priced):
    """A (4, 6) tensor sharded over both axes viewed as (4, 3, 2): DTensor
    cannot unflatten the model axis's 3-column shards, so the columns are
    gathered over "model" (a (2, 6) float32 output, 48 bytes) and the rows
    stay sharded over "data"."""
    a = priced["uneven_view"]
    assert a["placements"] == ["Shard", "Replicate"]
    assert a["shape"] == [4, 3, 2]
    assert a["collectives"] == {"all-gather": {"count": 1.0, "bytes": 48.0}}
    assert len(a["fallbacks"]) == 1
    assert a["fallbacks"][0].endswith("; replicated but dim 0")


# ------------------------------------------------ trip-count extrapolation
EXTRAPOLATE = """
import dataclasses, json
from repro_torch.launch.dryrun import init_fake_world
init_fake_world(4)
from repro_torch.configs import get_reduced
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.cells import build_cell, lower_cell
from repro_torch.launch.mesh import make_host_mesh
mesh = make_host_mesh((2, 2), device="cpu")
out = {}
for arch, kind, L in (("llama3-8b", "decode", 4),
                      ("seamless-m4t-medium", "decode", 4),
                      ("llama3-8b", "train", 4)):
    cfg = get_reduced(arch).with_(num_layers=L)
    if cfg.family == "audio":
        cfg = cfg.with_(encoder_layers=L + 1)
    cell = build_cell(cfg, ShapeSpec("s", kind, 64, 16), mesh,
                      num_microbatches=4)
    ex = lower_cell(cell)
    full = lower_cell(dataclasses.replace(cell, loops=None))
    out[f"{arch}:{kind}"] = [ex.cost_analysis(), full.cost_analysis(),
                             dataclasses.asdict(ex.memory_analysis()),
                             dataclasses.asdict(full.memory_analysis())]
print("JSON", json.dumps(out))
"""


@pytest.fixture(scope="module")
def extrapolated():
    return last_json(run_port(EXTRAPOLATE, timeout=600))


@pytest.mark.parametrize("cell", ["llama3-8b:decode",
                                  "seamless-m4t-medium:decode"])
def test_decode_loops_extrapolate_exactly(extrapolated, cell):
    """Decode at 4 layers (and 5 encoder layers) from runs at 2–3: every
    count, and every byte of memory but the temporaries' peak, equals the
    run of every layer."""
    ex, full, mex, mfull = extrapolated[cell]
    assert ex["while_loops"] and not full["while_loops"]
    for k in ("dot_flops", "collective_bytes", "hbm_bytes",
              "hbm_bytes_fused", "dot_count", "num_ops"):
        assert ex[k] == full[k], k
    assert ex["collectives"] == full["collectives"]
    for k in ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes"):
        assert mex[k] == mfull[k], k


def test_train_loops_extrapolate_flops_exactly(extrapolated):
    """Train at 4 layers and 4 microbatches from runs at 2–3 of each: the
    FLOPs exactly; bytes within 5%, since DTensor shards a stacked-layer
    gradient unevenly at odd depths (a pad and a concatenation more)."""
    ex, full, mex, mfull = extrapolated["llama3-8b:train"]
    assert ex["dot_flops"] == full["dot_flops"]
    assert ex["dot_count"] == full["dot_count"]
    for k in ("collective_bytes", "hbm_bytes", "hbm_bytes_fused"):
        assert abs(ex[k] - full[k]) <= 0.05 * full[k], k
    assert mex["argument_size_in_bytes"] == mfull["argument_size_in_bytes"]
    assert mex["alias_size_in_bytes"] == mfull["alias_size_in_bytes"]


# ------------------------------------------------------------- roofline
RECORD = {
    "arch": "llama3-8b", "shape": "train_4k", "mesh": "16x16",
    "n_devices": 256, "model_flops": 3.2e17,
    "argument_size_in_bytes": 6 * 2**30, "output_size_in_bytes": 5 * 2**30,
    "temp_size_in_bytes": 9 * 2**30, "alias_size_in_bytes": 5 * 2**30,
    "hlo": {"dot_flops": 1.7e15, "collective_bytes": 3.1e10,
            "hbm_bytes": 9.0e12, "hbm_bytes_fused": 2.5e12,
            "collectives": {"all-gather": {"count": 10.0, "bytes": 2.0e10},
                            "all-reduce": {"count": 4.0, "bytes": 1.1e10}}},
    "fallbacks": ["a", "b"],
}


def test_roofline_row_is_repros_under_repros_constants(monkeypatch):
    from repro.launch import roofline as ref
    from repro_torch.launch import roofline

    monkeypatch.setattr(roofline, "PEAK_FLOPS", ref.PEAK_FLOPS)
    monkeypatch.setattr(roofline, "HBM_BW", ref.HBM_BW)
    monkeypatch.setattr(roofline, "LINK_BW", ref.ICI_BW)
    monkeypatch.setattr(roofline, "HBM_GIB", 16.0)
    assert roofline.roofline_row(RECORD) == ref.roofline_row(RECORD)
    row = roofline.roofline_row(RECORD)
    assert roofline.suggest(row) == ref.suggest(row)
    assert roofline.render_markdown([row]).splitlines()[:2] == \
        ref.render_markdown([row]).splitlines()[:2]


def test_roofline_row_prices_the_h100():
    from repro_torch.launch import roofline

    row = roofline.roofline_row(RECORD)
    assert row["compute_s"] == 1.7e15 / 989e12
    assert row["memory_s"] == 2.5e12 / 3.35e12
    assert row["collective_s"] == 3.1e10 / 50e9
    assert row["dominant"] == "compute"
    assert row["mem_gib_per_dev"] == 15.0 and row["fits_hbm"]
    assert row["useful_ratio"] == 3.2e17 / 256 / 1.7e15


def test_fill_experiments_inlines_the_table(tmp_path):
    from repro_torch.launch import fill_experiments

    d = tmp_path / "dryrun"
    d.mkdir()
    (d / "llama3-8b__train_4k__16x16.json").write_text(
        json.dumps({**RECORD, "ok": True}))
    doc = tmp_path / "EXPERIMENTS.md"
    doc.write_text("# x\n\n<!-- ROOFLINE_TABLE -->\nold table\n\n---\nrest\n")
    fill_experiments.main(["--dir", str(d), "--doc", str(doc)])
    text = doc.read_text()
    assert "old table" not in text and text.endswith("---\nrest\n")
    assert "| llama3-8b | train_4k |" in text
    assert "1/1 fit 80 GiB" in text
    rows = json.loads((d / "roofline_16x16.json").read_text())
    assert rows[0]["fits_hbm"]


# ------------------------------------------------- the SWA prefill's ring
def _rolled(ks, vs, pos, C):
    """The rotation as it was computed before: a host read of each row's
    shift and a ``torch.roll`` a row."""
    ks, vs = ks[:, :, -C:], vs[:, :, -C:]
    pos_tail = pos[:, -C:]
    shift = (pos_tail[:, 0] % C).tolist()
    ks = torch.stack([torch.roll(ks[:, b], s, dims=1)
                      for b, s in enumerate(shift)], dim=1)
    vs = torch.stack([torch.roll(vs[:, b], s, dims=1)
                      for b, s in enumerate(shift)], dim=1)
    cp = torch.stack([torch.roll(pos_tail[b], s, dims=0)
                      for b, s in enumerate(shift)])
    return ks, vs, cp


@pytest.mark.parametrize("S", [96, 128, 157])
def test_swa_prefill_rotation_gathers_the_rolled_ring(S):
    """The windowed reduced mixtral (window 64): the ring from a gather on
    the device equals the per-row ``torch.roll`` it replaces, bit for bit,
    and ``repro``'s ``_cache_from_prefill`` on the same inputs; rows start
    at different positions, so each has its own shift."""
    import jax.numpy as jnp

    from repro.configs import get_reduced as repro_reduced
    from repro.models.model import build_model as repro_build
    from repro_torch.configs import get_reduced
    from repro_torch.models.model import build_model

    cfg = get_reduced("mixtral-8x22b")
    assert cfg.window == 64
    rng = np.random.default_rng(S)
    L, B, H, hd = 2, 3, 2, 4
    ks = rng.standard_normal((L, B, 64, H, hd)).astype(np.float32)
    vs = rng.standard_normal((L, B, 64, H, hd)).astype(np.float32)
    pos = (np.arange(S)[None] + np.array([[0], [5], [11]])).astype(np.int32)
    model = build_model(cfg)
    got = model._cache_from_prefill(torch.from_numpy(ks),
                                    torch.from_numpy(vs),
                                    torch.from_numpy(pos), S)
    rk, rv, rp = _rolled(torch.from_numpy(ks), torch.from_numpy(vs),
                         torch.from_numpy(pos), 64)
    assert torch.equal(got["k"], rk) and torch.equal(got["v"], rv)
    assert torch.equal(got["pos"], rp.to(torch.int32))
    ref = repro_build(repro_reduced("mixtral-8x22b"))._cache_from_prefill(
        jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(pos), S)
    for k in ("k", "v", "pos"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


def test_windowed_prefill_cell_dry_runs():
    """The reduced mixtral's prefill cell, 128 tokens through a window of
    64, dry-runs on a (2, 2) fake mesh: the ring's rotation reads nothing
    back to the host (a ``.tolist()`` on a fake tensor raises)."""
    out = run_port("""
from repro_torch.launch.dryrun import init_fake_world
init_fake_world(4)
from repro_torch.configs import get_reduced
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.cells import build_cell, lower_cell
from repro_torch.launch.mesh import make_host_mesh
mesh = make_host_mesh((2, 2), device="cpu")
cfg = get_reduced("mixtral-8x22b")
cell = build_cell(cfg, ShapeSpec("prefill_32k", "prefill", 128, 8), mesh)
tr = lower_cell(cell)
print("ok", tr.memory_analysis().output_size_in_bytes,
      tr.cost_analysis()["dot_flops"])
""")
    ok = [ln for ln in out.splitlines() if ln.startswith("ok")][-1].split()
    assert int(ok[1]) > 0 and float(ok[2]) > 0


# ---------------------------------------------- phase 16, rehearsed
def test_dryrun_phase_rehearsal(monkeypatch):
    """Phase 16 of ``chip_smoke.py`` on the CPU (fake tensors on the CPU,
    where DTensor gathers in place of all-to-all): ``python -m
    repro_torch.launch.dryrun`` for the gate's RAG shape and gemma-2b's
    decode_32k on the 16×16 fake mesh, every gate as on the card (the
    hand-counted argument and collective bytes, useful ratio, 80 GiB),
    and phase 15's step priced at its own shapes against a stand-in
    measured step of 0.37 s; the rates at a cut size with a host clock
    standing in for CUDA events."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    out = chip_smoke.dryrun_phase(
        torch, np, torch.device("cpu"), 0.37,
        cells=(("gate-anns", "search_rag"), ("gemma-2b", "decode_32k")))
    assert set(out["cells"]) == {"gate-anns:search_rag", "gemma-2b:decode_32k"}
    assert len(out["roofline"]) == 2
    assert all(r["fits_hbm"] and 0 < r["useful_ratio"] <= 1
               for r in out["roofline"])
    p15 = out["phase15"]
    assert 0 < p15["per_rank_bound_s"] and p15["bound_x4_s"] <= 0.37
    assert p15["row"]["collectives"] == {
        "all-gather": 2 * (2 + 4) * 10_000 * 10 * 4}
    assert out["rates"] is None  # no card, no rates

    import time as _time

    def host_ms(torch_, fn, reps=30):
        t0 = _time.perf_counter()
        for i in range(reps):
            fn(i)
        return (_time.perf_counter() - t0) / reps * 1e3

    monkeypatch.setattr(chip_smoke, "cuda_ms", host_ms)
    r = chip_smoke.matmul_and_copy_rates(
        torch, "cpu", shapes=dict(matmul=64, copy_bytes=1 << 16))
    assert r["matmul_flops_per_s"] > 0 and r["copy_bytes_per_s"] > 0


# ------------------------------------------------ the dry run's device
def test_dryrun_defaults_to_the_card_and_never_falls_back(tmp_path,
                                                          monkeypatch):
    """``--device`` and ``run_cell``'s ``device`` default to ``cuda``; with
    no card and the CPU not asked for, the run raises with a message that
    names ``--device cpu`` and writes nothing (no fallback to the CPU)."""
    import inspect

    from repro_torch.launch import dryrun

    assert inspect.signature(dryrun.run_cell).parameters["device"].default \
        == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "dr"
    for argv in (["--arch", "gemma-2b", "--shape", "decode_32k"],
                 ["--all", "--jobs", "2"]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            dryrun.main(argv + ["--out", str(out)])
    with pytest.raises(RuntimeError, match="no card"):
        dryrun.run_cell("gemma-2b", "decode_32k", False, str(out))
    assert not out.exists()
    assert dryrun.check_device("cpu") == "cpu"
