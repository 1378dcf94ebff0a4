"""Index persistence: ``repro_torch``'s ``GateIndex.save`` / ``load`` on the
CPU.

* A ``repro`` index saved with ``repro``'s ``GateIndex.save`` (a pickle)
  loads through the port's ``GateIndex.load`` without importing ``repro``'s
  classes, and searches as ``repro`` does: ids, hops and dist_evals equal,
  distances within rtol = atol = 1e-5 (fp32 sums in another order; as
  ``tests/test_torch_serve.py`` holds them).
* The port's own save → load round trip is bit-equal: every array, the
  configs, ``build_report``, and the search results of ``xla``, ``fused``
  and ``fused_q8``.
* A pickle naming any other class is refused; a crash mid-save leaves
  neither a half index nor a temporary directory.

Inputs: ``repro``'s 400-row serving fixture (``pair`` of
``tests/test_torch_serve.py``) and 24 queries near its rows (seed 31).
"""
import dataclasses
import io
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from repro.graphs.params import SearchParams as JParams

from repro_torch import GateIndex, SearchParams
from repro_torch.core.gate_index import INDEX_FORMAT

from test_torch_search import one_torch_thread  # noqa: F401  (autouse)
from test_torch_serve import _queries, pair  # noqa: F401  (fixture)

KERNELS = ("xla", "fused", "fused_q8")


@pytest.fixture(scope="module")
def ref_pickle(pair, tmp_path_factory):  # noqa: F811
    jidx, _ = pair
    jidx.ensure_quantized()
    path = tmp_path_factory.mktemp("persist") / "ref.pkl"
    jidx.save(str(path))
    return str(path)


def _search(idx, q, kernel):
    return idx.search(q, params=SearchParams(k=10, kernel=kernel),
                      telemetry_sink=None, device="cpu")


def _arrays(idx):
    out = {"db": idx.db, "neighbors": idx.neighbors, "hub_ids": idx.hubs.ids,
           "assign": idx.hubs.assign, "centroids": idx.hubs.centroids,
           "nav_nbrs": idx.nav.neighbors, "nav_reps": idx.nav.reps}
    out.update({f"tower/{k}": v.detach().numpy()
                for k, v in idx.tower_params.as_dict().items()})
    if idx.quant is not None:
        out.update({f"quant/{f}": np.asarray(getattr(idx.quant, f))
                    for f in idx.quant._fields})
    return out


def _assert_bit_equal(a, b):
    xa, xb = _arrays(a), _arrays(b)
    assert xa.keys() == xb.keys()
    for k in xa:
        u, v = np.asarray(xa[k]), np.asarray(xb[k])
        assert u.dtype == v.dtype and u.shape == v.shape, k
        assert np.array_equal(u.view(np.uint8), v.view(np.uint8)), k
    assert (a.enter_id, a.nav.start) == (b.enter_id, b.nav.start)
    assert a.gcfg == b.gcfg and a.tower_cfg == b.tower_cfg
    assert a.build_report == b.build_report


@pytest.mark.parametrize("kernel", KERNELS)
def test_reference_pickle_loads_and_searches_as_reference(pair, ref_pickle,  # noqa: F811
                                                          kernel):
    jidx, tidx = pair
    mods = set(sys.modules)
    idx = GateIndex.load(ref_pickle, device="cpu")
    assert not {m for m in set(sys.modules) - mods
                if m.split(".")[0] in ("repro", "jax")}
    assert type(idx.gcfg).__module__ == "repro_torch.core.gate_index"
    assert type(idx.tower_cfg).__module__ == "repro_torch.core.twotower"
    assert dataclasses.asdict(idx.gcfg) == dataclasses.asdict(jidx.gcfg)
    assert idx.quant is not None
    q = _queries(tidx, 24, seed=31)
    got = _search(idx, q, kernel)
    want = jidx.search(q, params=JParams(k=10, kernel=kernel,
                                         kernel_interpret=True))
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.hops.numpy(), np.asarray(want.hops))
    np.testing.assert_array_equal(got.dist_evals.numpy(),
                                  np.asarray(want.dist_evals))
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                               rtol=1e-5, atol=1e-5)


def test_port_round_trip_is_bit_equal(pair, tmp_path):  # noqa: F811
    _, tidx = pair
    tidx.ensure_quantized()
    path = tmp_path / "idx"
    tidx.save(str(path))
    assert sorted(os.listdir(path)) == ["arrays.npz", "manifest.json"]
    assert os.listdir(tmp_path) == ["idx"]  # no temporary sibling left
    m = json.loads((path / "manifest.json").read_text())
    assert m["format"] == INDEX_FORMAT and m["version"] == 1
    assert m["arrays"]["neighbors"] == {
        "shape": list(tidx.neighbors.shape), "dtype": "int32"}
    back = GateIndex.load(str(path), device="cpu")
    _assert_bit_equal(back, tidx)
    q = _queries(tidx, 24, seed=32)
    for kernel in KERNELS:
        a, b = _search(tidx, q, kernel), _search(back, q, kernel)
        for f in ("ids", "dists", "hops", "dist_evals"):
            assert torch.equal(getattr(a, f), getattr(b, f)), (kernel, f)
    # saving over an existing index replaces it
    tidx.save(str(path))
    _assert_bit_equal(GateIndex.load(str(path), device="cpu"), tidx)


def test_reference_pickle_at_protocol_5_loads(ref_pickle, tmp_path):
    """Protocol 5 (Python 3.14's default) pickles arrays through
    ``_frombuffer``; the same state loads to the same index."""
    with open(ref_pickle, "rb") as f:
        state = pickle.load(f)  # the test may import repro's classes
    path = tmp_path / "p5.pkl"
    path.write_bytes(pickle.dumps(state, protocol=5))
    assert b"_frombuffer" in path.read_bytes()
    _assert_bit_equal(GateIndex.load(str(path), device="cpu"),
                      GateIndex.load(ref_pickle, device="cpu"))


def test_loaded_reference_index_saves_in_the_port_format(ref_pickle, tmp_path):
    a = GateIndex.load(ref_pickle, device="cpu")
    a.save(str(tmp_path / "idx"))
    _assert_bit_equal(GateIndex.load(str(tmp_path / "idx"), device="cpu"), a)


class _Evil:
    def __reduce__(self):
        return (os.system, ("true",))


@pytest.mark.parametrize("payload", [
    pickle.dumps({"gcfg": _Evil()}),
    pickle.dumps({"x": __import__("collections").OrderedDict()}),
    # repro's own index class: only its two configs are mapped
    b"\x80\x04crepro.core.gate_index\nGateIndex\n.",
    b"\x80\x04cnumpy\nload\n.",
], ids=["os.system", "OrderedDict", "GateIndex", "numpy.load"])
def test_other_classes_in_a_pickle_are_refused(tmp_path, payload):
    path = tmp_path / "bad.pkl"
    path.write_bytes(payload)
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        GateIndex.load(str(path), device="cpu")


def test_bad_directory_and_interrupted_save(pair, tmp_path, monkeypatch):  # noqa: F811
    _, tidx = pair
    path = tmp_path / "idx"
    tidx.save(str(path))
    man = json.loads((path / "manifest.json").read_text())
    man["version"] = 99
    (path / "manifest.json").write_text(json.dumps(man))
    with pytest.raises(ValueError, match="not a"):
        GateIndex.load(str(path), device="cpu")

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", boom)
    with pytest.raises(OSError, match="disk full"):
        tidx.save(str(tmp_path / "new"))
    assert sorted(os.listdir(tmp_path)) == ["idx"]
    buf = io.BytesIO()
    pickle.dump({"a": 1}, buf)  # plain containers alone are allowed
    (tmp_path / "ok.pkl").write_bytes(buf.getvalue())
    with pytest.raises(KeyError):  # ...but are no index
        GateIndex.load(str(tmp_path / "ok.pkl"), device="cpu")
