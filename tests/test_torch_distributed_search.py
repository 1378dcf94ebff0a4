"""Partitioned GATE search: ``repro_torch.core.distributed`` on 4 gloo
ranks (a (2, 2) ("data", "model") CPU mesh) against
``repro.core.distributed`` on 4 fake JAX devices, at
``tests/test_distributed.py``'s cut: 2048 sift10m-like rows, 64 hubs,
local ``knn_graph(R=16)`` graphs, beam 32, 64 hops, k = 10, 32 queries.

``repro`` draws the tower's weights and the hubs and writes every input to
an ``.npz``; the port reads them.  Tolerances: ids equal; distances within
the float32 bound of ``beam_search_fixed``'s dot form ‖v‖² − 2v·q + ‖q‖²
over d = 128 terms, 2·d·eps·max(‖v‖², ‖q‖²) absolute (its terms are ~178
here before they cancel).  The merge is checked on its own too:
every rank returns the same result, and it equals a single-process
composition of the four shards' searches, globalized and merged by a
stable top-k, bit for bit.

Also ``batched_search``'s ``repro`` keywords (``db_lane=`` and the legacy
per-knob ones, counted into ``api.deprecated_kwargs``): ids equal to
``repro``'s, distances within rtol 1e-5, atol 1e-6 (the search tests'
tolerance).
"""
import warnings

import numpy as np
import pytest
import torch

from tests._subproc import run_with_devices
from tests._torch_ranks import run_ranks, sharded_search_rank

from repro_torch.core.distributed import (
    ShardedGate, build_sharded_gate, gate_shardings, merge_top_k,
    sharded_gate_specs,
)
from repro_torch.core.twotower import TwoTowerConfig
from repro_torch.graphs.knn import exact_knn, knn_graph, recall_at_k
from repro_torch.graphs.params import SearchParams

REPRO_SIDE = """
import sys, jax, jax.numpy as jnp, numpy as np
from repro.launch.mesh import make_host_mesh
from repro.core.twotower import TwoTowerConfig, init_params, query_tower
from repro.core.distributed import make_search_step, build_sharded_gate
from repro.graphs.knn import knn_graph
from repro.data.synthetic import make_database, make_queries_in_dist

mesh = make_host_mesh((2, 2), ("data", "model"))
db, _ = make_database("sift10m-like", 2048, seed=0)
tcfg = TwoTowerConfig(d_p=128)
params = init_params(tcfg, jax.random.PRNGKey(0))
rng = np.random.default_rng(0)
hub_ids = rng.choice(2048, 64, replace=False)
hub_reps = np.asarray(query_tower(params, tcfg,
                                  jnp.asarray(db[hub_ids], jnp.float32)))
sg = build_sharded_gate(mesh, db, (tcfg, params), hub_reps, hub_ids,
                        lambda x, R: knn_graph(x, R), R=16)
step = make_search_step(mesh, tcfg, beam_width=32, max_hops=64, k=10)
queries = make_queries_in_dist(db, 32, seed=5)
with mesh:
    ids, dists, hops = jax.jit(step)(sg, jnp.asarray(queries))
# a skewed hub set: shard 0 holds 2, shard 1 holds 3, shards 2-3 none
skew_ids = np.array([600, 1, 601, 5, 602])
skew_reps = np.arange(5 * 4, dtype=np.float32).reshape(5, 4) + 1
skew = build_sharded_gate(mesh, db, (tcfg, params), skew_reps, skew_ids,
                          lambda x, R: np.zeros((len(x), R), np.int32), R=16)
np.savez(sys.argv[1], db=db, hub_ids=hub_ids, hub_reps=hub_reps,
         skew_local=np.asarray(skew.hub_local_ids),
         skew_reps=np.asarray(skew.hub_reps),
         queries=queries, ids=np.asarray(ids), dists=np.asarray(dists),
         hops=np.asarray(hops),
         **{"p_" + k: np.asarray(v) for k, v in params.items()})
print("ok")
"""


@pytest.fixture(scope="module")
def repro_side(tmp_path_factory):
    """``repro``'s inputs and results, run once for the module."""
    path = tmp_path_factory.mktemp("repro") / "repro_side.npz"
    run_with_devices(
        f"import sys; sys.argv = ['x', {str(path)!r}]\n" + REPRO_SIDE,
        n_devices=4)
    return dict(np.load(path))


def _params(z):
    return {k[2:]: z[k] for k in z if k.startswith("p_")}


def test_sharded_gate_search_matches_repro(repro_side, tmp_path):
    z = repro_side
    outs = run_ranks(sharded_search_rank, 4, tmp_path, z["db"], _params(z),
                     z["hub_reps"], z["hub_ids"], z["queries"],
                     dict(beam_width=32, max_hops=64, k=10))
    ids, dists = outs[0][0], outs[0][1]
    for o in outs[1:]:  # the merged result is the same on every rank
        np.testing.assert_array_equal(o[0], ids)
        np.testing.assert_array_equal(o[1], dists)
    np.testing.assert_array_equal(ids, z["ids"])
    scale = max((z["db"].astype(np.float32) ** 2).sum(1).max(),
                (z["queries"].astype(np.float32) ** 2).sum(1).max())
    atol = 2 * z["db"].shape[1] * np.finfo(np.float32).eps * scale
    np.testing.assert_allclose(dists, z["dists"], rtol=0, atol=atol)
    # repro's hops are sharded over the shards, (P·B,) in shard order
    np.testing.assert_array_equal(
        np.concatenate([o[5] for o in sorted(outs, key=lambda o: o[4])]),
        z["hops"])

    # the merge against a single-process composition of the four shards
    by_shard = sorted(outs, key=lambda o: o[4])
    assert [o[4] for o in by_shard] == [0, 1, 2, 3]
    want_ids, want_d = merge_top_k(
        torch.from_numpy(np.stack([o[2] for o in by_shard])),
        torch.from_numpy(np.stack([o[3] for o in by_shard])), 10)
    np.testing.assert_array_equal(ids, want_ids.numpy())
    np.testing.assert_array_equal(dists, want_d.numpy())

    # repro's own checks: recall, ascending distances, unique global ids
    true_ids, _ = exact_knn(z["queries"], z["db"], 10, device="cpu")
    assert recall_at_k(ids, true_ids, 10) > 0.5
    assert (np.diff(dists, axis=1) >= -1e-5).all()
    assert all(len(set(row.tolist())) == len(row) for row in ids)
    assert ids.min() >= 0 and ids.max() < 2048


class _Mesh:
    """The ``DeviceMesh`` facts the spec and build helpers read: shape,
    rank count, device type and this rank's coordinate."""

    def __init__(self, shape, coord=None):
        self.shape, self.ndim, self.coord = shape, len(shape), coord
        self.device_type = "cpu"

    def size(self):
        return int(np.prod(self.shape))

    def get_coordinate(self):
        return self.coord


def test_hub_count_per_shard_is_shard_zeros(repro_side):
    """Every shard keeps shard 0's hub count: shard 1's third hub is cut,
    the empty shards 2 and 3 get zero representations at local id 0
    (``repro``'s global arrays, shard by shard)."""
    z = repro_side
    ids = np.array([600, 1, 601, 5, 602])
    reps = np.arange(5 * 4, dtype=np.float32).reshape(5, 4) + 1
    got_ids, got_reps = [], []
    for coord in ((0, 0), (0, 1), (1, 0), (1, 1)):
        sg = build_sharded_gate(
            _Mesh((2, 2), coord), z["db"], (None, _params(z)), reps, ids,
            lambda x, R: np.zeros((len(x), R), np.int32), R=16)
        got_ids.append(sg.hub_local_ids.numpy())
        got_reps.append(sg.hub_reps.numpy())
    np.testing.assert_array_equal(np.concatenate(got_ids), z["skew_local"])
    np.testing.assert_array_equal(np.concatenate(got_reps), z["skew_reps"])
    assert np.concatenate(got_ids).tolist() == [1, 5, 88, 89, 0, 0, 0, 0]


def test_merge_ties_go_to_the_lowest_shard_slot():
    """Equal distances across shards keep shard-major order (lax.top_k's
    rule); a -1 id (an unfilled slot, distance 3.4e38) sorts last."""
    ids = torch.tensor([[[5, 9]], [[105, -1]]], dtype=torch.int32)
    d = torch.tensor([[[1.0, 2.0]], [[1.0, 3.4e38]]])
    got_ids, got_d = merge_top_k(ids, d, 3)
    assert got_ids.tolist() == [[5, 105, 9]]
    assert got_d.tolist() == [[1.0, 1.0, 2.0]]


def test_specs_and_shardings_have_repro_shapes():
    mesh = _Mesh((2, 2))
    tcfg = TwoTowerConfig(d_p=128)
    spec = sharded_gate_specs(mesh, tcfg, n_total=4096, d=128, R=16,
                              hubs_per_shard=8)
    assert isinstance(spec, ShardedGate)
    assert spec.db.shape == (4096, 128) and spec.db.dtype == torch.bfloat16
    assert spec.db.device.type == "meta"
    assert spec.neighbors.shape == (4096, 16)
    assert spec.neighbors.dtype == torch.int32
    assert spec.hub_reps.shape == (32, tcfg.d_out)
    assert spec.offsets.shape == (4,)
    assert spec.tower_params["q1"].shape == (128, tcfg.d_hidden)
    sh = gate_shardings(mesh)
    assert [repr(p) for p in sh.db[1]] == ["Shard(dim=0)", "Shard(dim=0)"]
    assert [repr(p) for p in sh.tower_params[1]] == ["Replicate()"] * 2


# ----------------------------------------------------- batched_search's kwargs
# ``repro.graphs.search.batched_search`` takes ``db_lane=`` and the legacy
# per-knob keywords; the port's did not (it raised TypeError).

@pytest.fixture()
def fresh_deprecation(monkeypatch):
    """Isolated warn-once state and registry (``tests/test_search_params.py``'s
    fixture, for the port's modules)."""
    import repro_torch.obs.registry as registry_mod
    from repro_torch.graphs.params import reset_deprecation_state
    from repro_torch.obs.registry import MetricsRegistry

    reset_deprecation_state()
    reg = MetricsRegistry()
    monkeypatch.setattr(registry_mod, "_REGISTRY", reg)
    yield reg
    reset_deprecation_state()


@pytest.fixture(scope="module")
def legacy_case():
    """rng seed 0, db (500, 16), ``knn_graph(k=8)``, 4 queries from entry 0."""
    rng = np.random.default_rng(0)
    db = rng.standard_normal((500, 16)).astype(np.float32)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    nbrs = knn_graph(db, 8, device="cpu")
    return db, nbrs, q, np.zeros((4, 1), np.int32)


def test_batched_search_takes_repros_legacy_kwargs(fresh_deprecation,
                                                   legacy_case):
    import jax.numpy as jnp
    from repro.graphs.search import batched_search as j_search

    from repro_torch.graphs.search import batched_search

    db, nbrs, q, entries = legacy_case
    kw = dict(k=5, beam_width=16, max_hops=32)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        want = j_search(*map(jnp.asarray, (db, nbrs, q, entries)), **kw)
        got = batched_search(db, nbrs, q, entries, db_lane=None,
                             device="cpu", **kw)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                               rtol=1e-5, atol=1e-6)
    # and the same as the SearchParams spelling
    sp = batched_search(db, nbrs, q, entries,
                        SearchParams(k=5, beam_width=16, max_hops=32),
                        device="cpu")
    np.testing.assert_array_equal(got.ids.numpy(), sp.ids.numpy())
    np.testing.assert_array_equal(got.dists.numpy(), sp.dists.numpy())
    port_dep = [w for w in caught if issubclass(w.category, DeprecationWarning)
                and "test_torch_distributed_search.py" in str(w.message)]
    assert port_dep, [str(w.message) for w in caught]


def test_legacy_kwargs_warn_once_and_count(fresh_deprecation, legacy_case):
    """``tests/test_search_params.py``'s counting: one warning per keyword
    name, naming the caller's file and line; the counter sees every use."""
    from repro_torch.graphs.search import batched_search

    db, nbrs, q, entries = legacy_case
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        r1 = batched_search(db, nbrs, q, entries, beam_width=8, max_hops=16,
                            device="cpu")
        r2 = batched_search(db, nbrs, q, entries, beam_width=8, max_hops=16,
                            device="cpu")
    dep = [w for w in caught if issubclass(w.category, DeprecationWarning)]
    assert len(dep) == 2
    assert all("SearchParams" in str(w.message) for w in dep)
    msg = str(dep[0].message)
    assert f"test_torch_distributed_search.py:{dep[0].lineno}" in msg
    assert dep[0].filename.endswith("test_torch_distributed_search.py")
    assert fresh_deprecation.get("api.deprecated_kwargs").value == 4
    np.testing.assert_array_equal(r1.ids.numpy(), r2.ids.numpy())
    with pytest.raises(TypeError, match="record_wrongly"):
        batched_search(db, nbrs, q, entries, record_wrongly=1, device="cpu")
