"""``correct`` comes out false when the timed path is broken underneath, and
when the reference computed one precision lower (the control) stands in
for the program, at a tiny size on the CPU."""
import numpy as np
import pytest
import torch

from repro_torch.core.gate_index import GateIndex
from repro_torch.graphs.search import SearchResult

from gatebench import check, control

from ._tiny import run_tiny, tiny_cell


def _unchanged(idx, res, queries):
    """The search returns its state as the entry left it."""
    e = idx.select_entries(queries, device=res.ids.device)[:, 0]
    ids = torch.full_like(res.ids, -1)
    ids[:, 0] = e
    d = torch.full_like(res.dists, 3.4e38)
    q = torch.as_tensor(queries, device=res.ids.device)
    d[:, 0] = ((torch.as_tensor(idx.db)[e.long()] - q) ** 2).sum(dim=1)
    return SearchResult(ids, d, torch.zeros_like(res.hops),
                        torch.ones_like(res.dist_evals))


def _half(idx, res, queries):
    """Half of the batch left out: its answers never written."""
    ids, d, h = res.ids.clone(), res.dists.clone(), res.hops.clone()
    half = len(ids) // 2
    ids[half:], d[half:], h[half:] = -1, 3.4e38, 0
    return SearchResult(ids, d, h, res.dist_evals)


def _altered(idx, res, queries):
    """Each answer's last id altered where it is produced."""
    ids = res.ids.clone()
    ids[:, -1] = (ids[:, -1] + 1) % len(idx.db)
    return SearchResult(ids, res.dists, res.hops, res.dist_evals)


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered],
                         ids=["state_unchanged", "half_left_out",
                              "answer_altered"])
@pytest.mark.parametrize("name", ["sift128-250k.batch10k",
                                  "laion512-ood-100k.batch10k",
                                  "sift128-250k.batch10k-q8"])
def test_a_broken_search_is_not_correct(monkeypatch, fault, name):
    orig = GateIndex.search

    def broken(self, queries, *a, **kw):
        out = orig(self, queries, *a, **kw)
        if isinstance(out, SearchResult):
            return fault(self, out, queries)
        return (fault(self, out[0], queries),) + tuple(out[1:])

    monkeypatch.setattr(GateIndex, "search", broken)
    out = run_tiny(tiny_cell(name))
    assert out["correct"] is False
    assert not all(check.within(c["value"], c["limit"])
                   for c in out["checks"].values())


@pytest.mark.parametrize("name", ["sift128-250k.batch10k",
                                  "sift128-250k.batch10k-q8"])
def test_the_control_and_the_faults_fail_their_limits(name):
    """The control script's readings on a tiny cell: the program's sample
    within every limit, the bfloat16 reference and each planted fault
    outside one at least."""
    cell = tiny_cell(name)
    out = run_tiny(cell, extra=control.readings)
    assert out["correct"] is True
    assert set(out["extra"]) == set(control.FAULTS)
    for fault, numbers in out["extra"].items():
        assert set(numbers) <= set(cell.limits), fault
        outside = [k for k, v in numbers.items()
                   if not check.within(v, cell.limits[k])]
        assert outside, (fault, numbers)
    bf16 = out["extra"]["control_bf16"]
    assert bf16["dist_gap"] > 10 * cell.limits["dist_gap"]
    assert np.isfinite(bf16["id_mismatch"])
    assert out["extra"]["graph_random"]["prune_violations"] > 0.5
