"""The kernel and kernel-API phases of ``chip_smoke.py``, rehearsed on the CPU.

``kernel_phase`` holds K3 at the search's and a serve request's shapes,
``api_phase`` K5 and K4 at bench_kernels.py's shapes and alone at the
composed top-10's, and ``kernels_line`` reports both shapes of each.  Here
they run at small shapes on CPU tensors (the wrappers run their plain
versions), with the CUDA-event timer stubbed, each module's ``cuda_plan``
replaced by its ``plan`` (the card holds the two against each other), and
stand-in baseline libraries that a CPU tensor never reaches.
"""
import importlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

TT = importlib.import_module("repro_torch.kernels.twotower_score")
TK = importlib.import_module("repro_torch.kernels.topk")
L2 = importlib.import_module("repro_torch.kernels.l2dist")


@pytest.fixture
def rehearsal(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "cuda_times",
                        lambda torch, fn, reps: [fn(i) is None or 0.0
                                                 for i in range(reps)])
    monkeypatch.setattr(TT, "cuda_plan", lambda q, h: TT.plan(
        q.shape[0], h.shape[0], q.shape[1], n_sm=132))
    monkeypatch.setattr(L2, "cuda_plan", lambda q, c: L2.plan(
        q.shape[0], c.shape[0], q.shape[1], bf16=q.dtype == torch.bfloat16))
    monkeypatch.setattr(TK, "cuda_plan", lambda d, k: TK.plan(
        d.shape[0], d.shape[1], k))
    for name, shape in (("SERVE_BATCH", 48), ("L2_SHAPE", (40, 300, 128)),
                        ("TOPK_SHAPE", (16, 128, 8)),
                        ("GATHER_SHAPE", (24, 8, 128)),
                        ("COMPOSED_SHAPE", (32, 1500, 10))):
        monkeypatch.setattr(chip_smoke, name, shape)
    rng = np.random.default_rng(4)
    db = rng.standard_normal((2000, 128)).astype(np.float32)
    queries = rng.standard_normal((90, 128)).astype(np.float32)
    return db, queries


@pytest.mark.parametrize("with_baseline", [False, True])
def test_kernel_and_api_phases_rehearsal(rehearsal, with_baseline):
    db, queries = rehearsal
    base = (dict.fromkeys(("twotower_score", "topk", "l2dist", "gather_dist"),
                          object()) if with_baseline else None)
    kres = chip_smoke.kernel_phase(torch, np, db, queries, "cpu", n_sm=132,
                                   baseline=base)
    api = chip_smoke.api_phase(torch, np, db, queries, "cpu", reps=2,
                               baseline=base)
    k3 = kres["twotower_score"]
    assert k3["search"]["shape"] == [90, 64, 128]
    assert k3["serve"]["shape"] == [48, 64, 128]
    for rec in k3.values():
        assert rec["plan"]["path"] == "resident" and rec["plan"]["tb"] == 16
        assert rec["bound_by"] in ("bytes", "operations")
        assert ("baseline_ms" in rec) == with_baseline
    comp = api["composed_top10"]
    assert api["l2dist"]["shape"] == [40, 300, 128]
    assert comp["l2dist"]["shape"] == [32, 1500, 128]
    assert comp["l2dist"]["plan"]["path"] == "sgemm"
    assert comp["topk_min"]["bytes"] == 32 * 1500 * 4 + 32 * 10 * 8
    assert comp["topk_min"]["shape"] == [32, 1500, 10]
    assert api["topk_min"]["shape"] == [16, 128, 8]
    assert api["topk_min"]["plan"] == {"path": "select", "threads": 32,
                                       "smem": 2304, "grid": 16}
    assert comp["topk_min"]["plan"] == {"path": "select", "threads": 128,
                                        "smem": 9216, "grid": 32}
    for rec in (api["l2dist"], comp["l2dist"], api["topk_min"],
                comp["topk_min"], api["gather_dist"]):
        assert rec["max_abs_err"] == 0.0  # plain against plain
        assert rec.get("baseline_max_abs_err", 0.0) == 0.0
        assert ("baseline_ms" in rec) == with_baseline
    for rec in (api["topk_min"], comp["topk_min"], api["gather_dist"]):
        chip_smoke.net_of_floor(rec, 0.25)
        assert rec["ms_net"] == rec["ms"] - 0.25
        assert ("baseline_ms_net" in rec) == with_baseline
    # the path was driven with the counts at 0 (CPU tensors: no launch)
    assert set(api["launches"]) == set(chip_smoke.SOURCES)

    hop = {label: {"kernel": {"ms_median": 1.0, "max_abs_err": 0.0,
                              "ms_sum": 9.0},
                   "plain_ms_median": 2.0, "bound_ms_median": 0.5,
                   "bound_by": "bytes", "B": 90, "R": 247}
           for label in ("fused_l2", "fused_q8_l2")}
    counts = dict.fromkeys(chip_smoke.SOURCES, 3)
    single = {"shape": [1, 247], "ms": 1.0, "plain_ms": 2.0, "bound_ms": 0.1,
              "bound_by": "bytes", "max_abs_err": 0.0}
    greedy = {lbl: {"shape": [n, 8], "ms": 1.0, "plain_ms": 9.0,
                    "library_ms": None, "bound_ms": 0.01, "bound_by": "bytes",
                    "max_abs_err": 0.0}
              for lbl, n in (("slice", 300), ("root_split", 900))}
    line = chip_smoke.kernels_line(kres, api, hop, counts, counts, counts,
                                   single, greedy, counts, counts)
    json.dumps({"kernels": line})
    by = {e["name"]: e for e in line}
    assert list(by) == list(chip_smoke.SOURCES)
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for e in line:
        assert keys <= set(e)
    assert by["twotower_score"]["shape"] == [90, 64, 128]
    assert by["twotower_score"]["serve_shape"]["shape"] == [48, 64, 128]
    # search, serve, feedback, ablations, rag
    assert by["twotower_score"]["launches"] == 15
    assert by["twotower_score"]["launches_by_path"]["feedback"] == 3
    assert by["twotower_score"]["launches_by_path"]["rag"] == 3
    assert by["greedy_assign"]["launches_by_path"] == {"ablations": 3}
    assert by["greedy_assign"]["shape"] == [300, 8]
    assert by["greedy_assign"]["root_split_shape"]["shape"] == [900, 8]
    assert by["greedy_assign"]["library_ms"] is None
    assert by["greedy_assign"]["replaces"].startswith("none (port-only")
    assert set(by["topk_min"]["launches_by_path"]) == {"api"}
    assert by["l2dist"]["composed_shape"]["shape"] == [32, 1500, 128]
    assert by["topk_min"]["composed_shape"]["shape"] == [32, 1500, 10]
    assert by["topk_min"]["composed_shape"]["library_ms"] is not None
    for e in (by["topk_min"], by["topk_min"]["composed_shape"],
              by["gather_dist"]):
        assert "ms_net" in e and ("baseline_ms_net" in e) == with_baseline
        assert e["read_ms"] is not None
    assert by["gather_rows_dist"]["shape"] == [90, 247]
    assert by["gather_rows_dist"]["single_query_shape"]["shape"] == [1, 247]
    assert "single_query_shape" not in by["gather_rows_dist_q8"]


def test_pair_ms_times_in_turns(monkeypatch):
    order = []
    monkeypatch.setattr(chip_smoke, "cuda_ms",
                        lambda torch, fn, reps=30: fn(0))
    a, b = chip_smoke.pair_ms(torch, lambda i: order.append("a") or 1.0,
                              lambda i: order.append("b") or 3.0)
    assert order == ["a", "b", "b", "a"] and (a, b) == (1.0, 3.0)


def test_kernel_library_swaps_and_restores():
    own = TT._lib
    lib = object()
    with pytest.raises(RuntimeError, match="boom"):
        with chip_smoke.kernel_library(TT, lib):
            assert TT._lib() is lib
            raise RuntimeError("boom")
    assert TT._lib is own
    # a CPU tensor never reaches the library: the plain version runs
    q = torch.ones((3, 8))
    run = chip_smoke.baseline_kernel(lib, TT, "twotower_score")
    assert torch.equal(run(q, q), TT.twotower_score(q, q))
    assert TT._lib is own


def test_hold_baseline_wants_the_same_bits(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    x = torch.tensor([1.0, 2.0])
    assert chip_smoke.hold_baseline(torch, "k", x, x.clone()) == 0.0
    with pytest.raises(RuntimeError, match="bit-equal"):
        chip_smoke.hold_baseline(torch, "k", x, x + 2.0 ** -22)


def test_load_baselines_builds_each_source_once(monkeypatch, tmp_path):
    """--kernel-baseline and --hop-baseline may name one gather_dist.cu:
    it is built and bound once, and both get that library."""
    built = []
    monkeypatch.setattr(chip_smoke, "load_baseline",
                        lambda p: built.append(p) or (f"lib {p.name}", ""))
    csrc = tmp_path / "parent" / "csrc"
    csrc.mkdir(parents=True)
    srcs = [csrc / f"{stem}.cu" for stem in ("topk", "gather_dist")]
    libs = chip_smoke.load_baselines(
        [*srcs, tmp_path / "parent" / ".." / "parent" / "csrc" / "gather_dist.cu"])
    assert built == [p.resolve() for p in srcs]
    assert libs == {p.resolve(): f"lib {p.name}" for p in srcs}
    assert chip_smoke.load_baselines([]) == {}


def test_load_baseline_names_the_library_by_its_bytes(monkeypatch, tmp_path):
    """Two sources of one stem (another commit's gather_dist.cu beside a
    third one) build into two libraries; one source into one."""
    from repro_torch.kernels import _build

    outs = []

    def nvcc(cmd, **kw):
        outs.append(Path(cmd[cmd.index("-o") + 1]).name)
        return type("Done", (), {"returncode": 0, "stdout": "", "stderr": ""})()

    monkeypatch.setattr(chip_smoke.subprocess, "run", nvcc)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "bind", lambda path, functions: (path, functions))
    for name, text in (("a", "// one"), ("b", "// two"), ("c", "// one")):
        (tmp_path / name).mkdir()
        (tmp_path / name / "gather_dist.cu").write_text(text)
        lib, _ = chip_smoke.load_baseline(tmp_path / name / "gather_dist.cu")
        assert set(lib[1]) == {"gather_rows_dist_f32", "gather_rows_dist_q8",
                               "gather_dist_f32"}
    assert outs[0] != outs[1] and outs[0] == outs[2]
    assert all(o.startswith("baseline-gather_dist-") for o in outs)


def test_log_ptxas_names_each_kernel(capsys):
    text = (
        "ptxas info    : Compiling entry function '_ZN39_GLOBAL__N__5471_7_"
        "topk_cu_f6d7c84313select_kernelEPKfPfPiii' for 'sm_90a'\n"
        "ptxas info    : Function properties for x\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 56 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__ab_14_"
        "gather_dist_cu_f6d7c84311gathered_l2ILb1ELb0EEEvPKfS2_PKiPfii' for "
        "'sm_90a'\n"
        "ptxas info    : Used 59 registers, used 1 barriers\n")
    chip_smoke.log_ptxas("k", text)
    out = capsys.readouterr().out.splitlines()
    assert out == [
        "  ptxas k select_kernel: 0 bytes stack frame, 0 bytes spill stores, "
        "0 bytes spill loads",
        "  ptxas k select_kernel: ptxas info    : Used 56 registers, used 1 "
        "barriers",
        "  ptxas k gathered_l2<Lb1ELb0>: ptxas info    : Used 59 registers, "
        "used 1 barriers"]
    assert chip_smoke.kernel_name("not_mangled") == "not_mangled"
