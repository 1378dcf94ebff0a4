"""The hop phase of ``chip_smoke.py``, rehearsed on the CPU.

The phase records every call of the hop kernels (K1 ``gather_rows_dist``,
K2 ``gather_rows_dist_q8``) that a search makes, by wrapping the names
``repro_torch.graphs.search`` looks up at call time, and counts each call's
bound from its own ids.  Here it runs on ``repro``'s 400-row serving fixture
carried across with ``repro_torch.convert.index_from_numpy``, with
``dev="cpu"`` (the wrappers run their plain versions) and the CUDA-event
timer stubbed out.  The recorded calls are also held against ``repro``'s
Pallas kernels in interpret mode, row by row: equal ids, the same 3.4e38 on
invalid slots, and values within 1e-5 (fp32 sums in another order), as
tests/test_torch_kernels.py holds them.
"""
import dataclasses
import importlib
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.kernels.gather_dist import gather_rows_dist as j_rows
from repro.kernels.gather_dist import gather_rows_dist_q8 as j_rows_q8
from repro.serve.daemon import _build_tiny_index

from repro_torch.convert import index_from_numpy
from repro_torch.graphs import search as S
from repro_torch.graphs.params import SearchParams

from test_torch_search import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

INF32 = np.float32(3.4e38)
SP = SearchParams(k=5, beam_width=16, max_hops=32)


@pytest.fixture(scope="module")
def index():
    jidx = _build_tiny_index(400, "sift10m-like", seed=0)
    state = {
        "db": jidx.db, "neighbors": jidx.neighbors, "enter_id": jidx.enter_id,
        "hubs": (jidx.hubs.ids, jidx.hubs.assign, jidx.hubs.centroids),
        "tower_params": jax.tree.map(np.asarray, jidx.tower_params),
        "tower_cfg": dataclasses.asdict(jidx.tower_cfg),
        "gcfg": dataclasses.asdict(jidx.gcfg),
        "nav": (jidx.nav.neighbors, jidx.nav.reps, jidx.nav.start),
        "build_report": jidx.build_report,
        "quant": None,
    }
    return index_from_numpy(state, device="cpu")


def _queries(idx, n, seed=3):
    rng = np.random.default_rng(seed)
    return (idx.db[rng.integers(0, len(idx.db), n)]
            + 0.05 * rng.standard_normal((n, idx.db.shape[1]))
            ).astype(np.float32)


@pytest.mark.parametrize("kernel,name", [("fused", "gather_rows_dist"),
                                         ("fused_q8", "gather_rows_dist_q8")])
@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_recorder_leaves_the_search_unchanged(index, kernel, name, metric):
    q = _queries(index, 24)
    sp = SP.replace(kernel=kernel, metric=metric)
    want = index.search(q, params=sp, telemetry_sink=None, device="cpu")
    orig = getattr(S, name)
    with chip_smoke.record_calls(S, name) as calls:
        got = index.search(q, params=sp, telemetry_sink=None, device="cpu")
    assert getattr(S, name) is orig
    for f in ("ids", "dists", "hops", "dist_evals"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    R = index.neighbors.shape[1]
    widths = [ids.shape[1] for ids, _ in calls]
    # one entry-scoring call (B, probe_width), then one (B, R) call per
    # iteration of the lockstep loop: the most hops of any query
    assert widths[0] == index.gcfg.probe_width
    assert widths[1:] == [R] * int(want.hops.max())
    assert all(ids.shape[0] == len(q) for ids, _ in calls)
    # the clones keep each call's ids: frozen queries' rows are -1 throughout
    last = calls[-1][0]
    assert bool((last < 0).all(dim=1).any())


def test_recorder_restores_the_function_after_an_error(index):
    orig = S.gather_rows_dist
    with pytest.raises(RuntimeError, match="boom"):
        with chip_smoke.record_calls(S, "gather_rows_dist"):
            assert S.gather_rows_dist is not orig
            raise RuntimeError("boom")
    assert S.gather_rows_dist is orig


@pytest.mark.parametrize("row_bytes,q_bytes,width", [(512, 512, 128),
                                                     (140, 512, 128)])
def test_hop_bound_counts_bytes_by_hand(row_bytes, q_bytes, width):
    ids = torch.tensor([[3, -1, 7, 3, -1],
                        [-1, -1, -1, -1, -1],
                        [7, 2, -1, -1, 9]], dtype=torch.int32)
    b = chip_smoke.hop_bound(torch, ids, row_bytes, q_bytes, width)
    # 15 slots of ids read and out written, 4 distinct rows {2, 3, 7, 9},
    # 2 queries with a valid id, 6 valid slots
    want_bytes = 15 * 4 + 15 * 4 + 4 * row_bytes + 2 * q_bytes
    assert b["bytes"] == want_bytes
    assert b["ops"] == 6 * width * 3
    assert (b["valid_slots"], b["distinct_rows"], b["active_queries"]) == (6, 4, 2)
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(want_bytes / 3.35e12 * 1e3, rel=1e-12)


def test_hop_phase_rehearsal(index, monkeypatch):
    """The whole phase on the CPU, the timer stubbed: every recorded call of
    the three searches is (B, R) after the entry call, the checks run on
    every 10th, and the counts add up."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "cuda_times",
                        lambda torch, fn, reps: [fn(i) is None or 0.0
                                                 for i in range(reps)])
    eval_q = _queries(index, 40)
    # a baseline library is never reached on CPU tensors: its wrapper runs
    # the plain version too, so the rehearsal covers its bookkeeping
    out = chip_smoke.hop_phase(torch, np, index, eval_q, "cpu", object(),
                               check_every=3, n_plain=2)
    R = index.neighbors.shape[1]
    assert set(out) == {"fused_l2", "fused_q8_l2", "fused_l2_serve"}
    for label, rec in out.items():
        assert rec["R"] == R and rec["B"] == 40
        assert rec["calls"] == rec["hop_calls"] + 1
        assert rec["checked_calls"] == len(range(0, rec["hop_calls"], 3))
        assert len(rec["valid_slots"]) == rec["hop_calls"]
        for v in ("kernel", "baseline"):  # plain against plain
            assert rec[v]["max_abs_err"] == 0.0
            assert len(rec[v]["ms"]) == rec["hop_calls"]
        v = rec["valid_slots_per_call"]
        assert 0 <= v["min"] <= v["median"] <= v["max"] <= 40 * R
        assert rec["bound_ms_sum"] >= rec["bound_ms_median"] > 0
    assert out["fused_l2"]["width"] == index.db.shape[1]
    assert out["fused_q8_l2"]["width"] == index.quant.codes.shape[1]


@pytest.mark.parametrize("kernel,name", [("fused", "gather_rows_dist"),
                                         ("fused_q8", "gather_rows_dist_q8")])
def test_recorded_calls_match_pallas_row_by_row(index, kernel, name):
    """A recorded hop call, row by row through ``repro``'s Pallas kernel
    (interpret mode): the port's wrapper on the same ids agrees."""
    q = _queries(index, 12, seed=5)
    with chip_smoke.record_calls(S, name) as calls:
        index.search(q, params=SP.replace(kernel=kernel), telemetry_sink=None,
                     device="cpu")
    ids, args = calls[2]  # the second hop: some slots valid, many -1
    got = getattr(S, name)(ids, *args).numpy()
    arrs = [None if a is None else a.numpy() for a in args]
    for b in range(2):
        row_ids = ids[b].numpy()
        if kernel == "fused":
            db, qq, inv = arrs
            want = j_rows(row_ids, db, qq[b], inv, interpret=True)
        else:
            codes, scale, zero, qq, inv = arrs
            want = j_rows_q8(row_ids, codes, scale, zero, qq[b], inv,
                             interpret=True)
        want = np.asarray(want)
        bad = row_ids < 0
        assert np.all(got[b][bad] == INF32) and np.all(want[bad] == INF32)
        np.testing.assert_allclose(got[b][~bad], want[~bad], rtol=1e-5, atol=1e-5)


def test_search_on_baseline_k3_rehearsal(index):
    """``chip_smoke.search_on_baseline_k3`` runs the fused search twice, the
    second time with K3's library swapped for a baseline one (never reached
    on CPU tensors), and holds the ids equal; the swap is undone after."""
    TT = importlib.import_module("repro_torch.kernels.twotower_score")
    own = TT._lib
    out = chip_smoke.search_on_baseline_k3(torch, index, _queries(index, 20),
                                           "cpu", object())
    assert out == {"fused_l2_ids_equal": True, "queries": 20}
    assert TT._lib is own
