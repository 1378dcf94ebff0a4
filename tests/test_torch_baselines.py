"""The paper's entry baselines (``core/baselines.py``) against ``repro``'s,
on the same database, hubs and queries, on the CPU: the k-means tree
(``HVS-like``) and the hash probe over the hubs (``LSH-APG-like``), built as
``benchmarks/common.py::entry_strategies`` builds them.

Tolerances: tree levels within 1e-5 (fp32 centroid sums in another order);
children, leaf entries, hash planes and codes, and every entry id equal.
"""
import numpy as np
import pytest

from repro.core import baselines as jb
from repro.data.synthetic import make_database, make_queries_in_dist

from repro_torch.core import baselines as tb
from repro_torch.graphs.search import batched_search
from repro_torch.graphs.params import SearchParams

from test_torch_search import one_torch_thread  # noqa: F401  (autouse)

CPU = "cpu"


@pytest.fixture(scope="module")
def data():
    db, _ = make_database("sift10m-like", 1200, seed=2)
    q = make_queries_in_dist(db, 64, seed=3)
    return db, q


@pytest.mark.parametrize("branch,depth", [(4, 2), (8, 1), (3, 3)])
def test_kmeans_tree_equal(data, branch, depth):
    db, q = data
    got = tb.build_kmeans_tree(db, branch=branch, depth=depth, device=CPU)
    want = jb.build_kmeans_tree(db, branch=branch, depth=depth)
    assert len(got.levels) == len(want.levels) == depth
    for a, b in zip(got.levels, want.levels):
        assert a.shape == b.shape and a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    for a, b in zip(got.children, want.children):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.leaf_entry, want.leaf_entry)
    e = tb.kmtree_entries(got, q, device=CPU)
    assert e.shape == (len(q), 1) and e.dtype == np.int32
    np.testing.assert_array_equal(e, jb.kmtree_entries(want, q))


@pytest.mark.parametrize("n_bits", [16, 8])
def test_hash_probe_equal(data, n_bits):
    db, q = data
    hubs = np.arange(5, 1200, 37)
    got = tb.build_hash_probe(db, hubs, n_bits=n_bits)
    want = jb.build_hash_probe(db, hubs, n_bits=n_bits)
    np.testing.assert_array_equal(got.planes, want.planes)
    np.testing.assert_array_equal(got.hub_codes, want.hub_codes)
    np.testing.assert_array_equal(tb._codes(q, got.planes),
                                  jb._codes(q, want.planes))
    e = tb.hash_entries(got, q)
    assert e.shape == (len(q), 1) and e.dtype == np.int32
    np.testing.assert_array_equal(e, jb.hash_entries(want, q))
    assert np.isin(e, hubs).all()


def test_baseline_entries_drive_a_search(data):
    """Each rule's (B, 1) entries go straight into ``batched_search``."""
    db, q = data
    rng = np.random.default_rng(0)
    nbrs = rng.integers(0, len(db), (len(db), 8)).astype(np.int32)
    tree = tb.build_kmeans_tree(db, branch=4, depth=2, device=CPU)
    probe = tb.build_hash_probe(db, np.arange(0, 1200, 50))
    for entries in (tb.kmtree_entries(tree, q, device=CPU),
                    tb.hash_entries(probe, q)):
        res = batched_search(db, nbrs, q, entries,
                             SearchParams(k=5, beam_width=16, max_hops=32),
                             device=CPU)
        assert tuple(res.ids.shape) == (len(q), 5)
