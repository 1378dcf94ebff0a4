"""Build-path parity, stage by stage, on identical numpy inputs (CPU).

Exact where the stage is deterministic host code (subgraphs, WL tokens,
samples, nav graph) or sees identical floats (MRNG pruning, HBKM here).

Tolerances where fp32 products are summed in another order:
- KNN ids are equal except where two candidates' distances tie to within
  the rounding of the dot form ‖q‖² − 2q·c + ‖c‖²: ~d·eps·(‖q‖² + ‖c‖²),
  bounded here by 1e-5·(‖q‖² + ‖c‖²).
- towers and InfoNCE within 1e-5 (fp32 matmul order); one AdamW step within
  1e-5 of the parameters (its update is ~lr·sign(g)).
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

j_hbkm = importlib.import_module("repro.core.hbkm")
j_nav = importlib.import_module("repro.core.navgraph")
j_samples = importlib.import_module("repro.core.samples")
j_tt = importlib.import_module("repro.core.twotower")
from repro.core.subgraph import sample_all_subgraphs as j_subgraphs
from repro.core.topo_embed import embed_all as j_embed
from repro.graphs import knn as j_knn
from repro.graphs import nsg as j_nsg
from repro.train.optim import adamw as j_adamw

# the package exports the function hbkm, which shadows its module
t_hbkm = importlib.import_module("repro_torch.core.hbkm")

from repro_torch.core import navgraph as t_nav
from repro_torch.core import samples as t_samples
from repro_torch.core import twotower as t_tt
from repro_torch.core.subgraph import sample_all_subgraphs as t_subgraphs
from repro_torch.core.topo_embed import embed_all as t_embed
from repro_torch.graphs import knn as t_knn
from repro_torch.graphs import nsg as t_nsg
from repro_torch.train.optim import adamw as t_adamw

from test_torch_search import one_torch_thread  # noqa: F401  (autouse)

CPU = "cpu"


def _assert_knn_equal_up_to_ties(q, db, ids_ref, ids_port):
    """Equal ids, or a swap of two ids whose distances tie within the
    rounding of the dot form."""
    q64, db64 = q.astype(np.float64), db.astype(np.float64)
    d_ref = ((q64[:, None, :] - db64[ids_ref]) ** 2).sum(-1)
    d_port = ((q64[:, None, :] - db64[ids_port]) ** 2).sum(-1)
    scale = (q64 ** 2).sum(1)[:, None] + (db64[ids_ref] ** 2).sum(-1)
    assert np.all(np.abs(d_ref - d_port) <= 1e-5 * scale)
    assert np.mean(ids_ref == ids_port) > 0.99


@pytest.mark.parametrize("exclude_self", [False, True])
def test_exact_knn_and_knn_graph(small_db, exclude_self):
    db = small_db[0][:600]
    q = db[:200] if exclude_self else db[:200] + 0.01
    a, ad = j_knn.exact_knn(q, db, 12, exclude_self=exclude_self)
    b, bd = t_knn.exact_knn(q, db, 12, exclude_self=exclude_self, device=CPU)
    _assert_knn_equal_up_to_ties(q, db, a, b)
    np.testing.assert_allclose(bd, ad, rtol=1e-5, atol=1e-3)
    if exclude_self:
        assert not np.any(b == np.arange(200)[:, None])
        _assert_knn_equal_up_to_ties(
            db, db, j_knn.knn_graph(db, 8), t_knn.knn_graph(db, 8, device=CPU))
    assert t_knn.medoid(db, device=CPU) == j_knn.medoid(db)


def test_recall_at_k_matches_reference():
    rng = np.random.default_rng(0)
    pred = rng.integers(0, 30, (50, 10))
    true = rng.integers(0, 30, (50, 10))
    assert t_knn.recall_at_k(pred, true, 10) == j_knn.recall_at_k(pred, true, 10)


def test_mrng_prune_batch_equal():
    rng = np.random.default_rng(1)
    B, P, d, R = 16, 24, 20, 8
    vecs = rng.standard_normal((300, d)).astype(np.float32)
    node = vecs[:B]
    # distinct non-self candidates sorted by distance, -1 padded, as
    # build_nsg hands them over
    cand = np.full((B, P), -1, np.int32)
    for i in range(B):
        c = rng.choice(np.arange(B, 300), P - 5 - (i % 4), replace=False)
        c = c[np.argsort(((vecs[c] - node[i]) ** 2).sum(1), kind="stable")]
        cand[i, :len(c)] = c
    cv = vecs[np.maximum(cand, 0)]
    a = j_nsg._mrng_prune_batch(jnp.asarray(node), jnp.asarray(cand),
                                jnp.asarray(cv), R)
    b = t_nsg._mrng_prune_batch(torch.from_numpy(node), torch.from_numpy(cand),
                                torch.from_numpy(cv), R)
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_reverse_edges_match_sequential_reference():
    rng = np.random.default_rng(2)
    n, R = 300, 6
    nb = np.full((n, R), -1, np.int32)
    for i in range(n):  # front-packed rows of distinct ids, no self loops
        deg = rng.integers(1, R + 1)
        nb[i, :deg] = rng.choice(np.delete(np.arange(n), i), deg, replace=False)
    want = j_nsg._add_reverse_edges(nb.copy(), R)
    got = t_nsg._add_reverse_edges(torch.from_numpy(nb.copy()), R)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("layout", ["scattered", "far_cluster"])
def test_repair_connectivity_matches_reference(layout):
    """Nodes >= 120 are unreachable; ``far_cluster`` puts them in one tight
    cluster far away, so they all pick the same anchors and the repair runs
    many capped waves."""
    rng = np.random.default_rng(3)
    db = rng.standard_normal((200, 16)).astype(np.float32)
    if layout == "far_cluster":
        db[120:] = 20.0 + 0.1 * db[120:]
    nb = np.full((200, 4), -1, np.int32)
    for i in range(0, 120):
        nb[i, :3] = rng.choice(120, 3, replace=False)
    want = j_nsg._repair_connectivity(db, nb.copy(), 0)
    stats = {}
    got = t_nsg._repair_connectivity(torch.from_numpy(db),
                                     torch.from_numpy(nb.copy()), 0, stats)
    np.testing.assert_array_equal(got, want)
    assert stats["repair_nodes"] >= 80
    if layout == "far_cluster":
        assert stats["repair_waves"] > 3


def test_build_nsg_matches(small_db, small_nsg):
    """Equal adjacency expected.  Measured on this fixture: every edge equal
    as a set; the order of a few rows (3 of 2000) follows KNN near-ties (see
    above), so rows are compared as sets, with ≥ 99% of rows equal in order."""
    db = small_db[0]
    ours = t_nsg.build_nsg(db, R=32, knn_k=32, search_l=64, pool_size=96,
                           device=CPU)
    assert ours.enter_id == small_nsg.enter_id
    assert ours.neighbors.shape == small_nsg.neighbors.shape
    same_sets = [set(a) == set(b)
                 for a, b in zip(ours.neighbors, small_nsg.neighbors)]
    assert np.mean(same_sets) >= 0.99
    assert np.mean((ours.neighbors == small_nsg.neighbors).all(1)) >= 0.99


def test_hbkm_assignment_equal(small_db):
    db = small_db[0]
    ja, jc = j_hbkm.hbkm(db, 24)
    ta, tc = t_hbkm.hbkm(db, 24, device=CPU)
    assert np.mean(ja == ta) >= 0.99
    np.testing.assert_allclose(tc, jc, rtol=1e-4, atol=1e-4)
    # greedy is ported (tests/test_torch_build_ablations.py); an unknown
    # mode raises as in repro
    with pytest.raises(ValueError, match="bogus"):
        t_hbkm.balanced_kmeans(db, 4, mode="bogus", device=CPU)


def test_subgraphs_topo_samples_exact(small_db, small_nsg):
    db = small_db[0]
    hub_ids = np.arange(0, 2000, 97)
    a = j_subgraphs(db, small_nsg.neighbors, hub_ids, h=4, max_nodes=48)
    b = t_subgraphs(db, small_nsg.neighbors, hub_ids, h=4, max_nodes=48)
    for x, y in zip(a, b):
        for f in ("nodes", "edges", "hops"):
            np.testing.assert_array_equal(getattr(y, f), getattr(x, f))
    np.testing.assert_array_equal(t_embed(b, 32, wl_iters=3),
                                  j_embed(a, 32, wl_iters=3))

    rng = np.random.default_rng(4)
    q = (db[rng.integers(0, 2000, 40)]
         + 0.05 * rng.standard_normal((40, db.shape[1]))).astype(np.float32)
    tgt = t_samples.top1_targets(db, q, device=CPU)
    np.testing.assert_array_equal(tgt, j_samples.top1_targets(db, q))
    hj = j_samples.greedy_hops(db, small_nsg.neighbors, q, hub_ids, tgt,
                               beam_width=8, max_hops=24)
    ht = t_samples.greedy_hops(db, small_nsg.neighbors, q, hub_ids, tgt,
                               beam_width=8, max_hops=24, chunk=300,
                               device=CPU)
    np.testing.assert_array_equal(ht, hj)
    sa = j_samples.make_samples(hj, t_pos=2, t_neg=6)
    sb = t_samples.make_samples(ht, t_pos=2, t_neg=6)
    for x, y in zip(sa.pos + sa.neg, sb.pos + sb.neg):
        np.testing.assert_array_equal(y, x)
    assert sa.stats() == sb.stats()


def _tower_setup():
    cfg_j = j_tt.TwoTowerConfig(d_p=24, d_u=16, d_k=8, n_heads=2, d_fusion=32,
                                d_hidden=48, d_out=16, lr=1e-3)
    cfg_t = t_tt.TwoTowerConfig(**cfg_j.__dict__)
    pj = j_tt.init_params(cfg_j, jax.random.PRNGKey(0))
    pt = t_tt.init_params(cfg_t, params={k: np.asarray(v) for k, v in pj.items()},
                          device=CPU)
    rng = np.random.default_rng(5)
    batch = {
        "p_hub": rng.standard_normal((6, 24)), "u_toks": rng.standard_normal((6, 4, 16)),
        "q_pos": rng.standard_normal((6, 3, 24)), "q_neg": rng.standard_normal((6, 5, 24)),
        "pos_mask": (rng.random((6, 3)) < 0.7), "neg_mask": (rng.random((6, 5)) < 0.8),
    }
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    batch["pos_mask"][0] = 0.0  # a hub with no positive
    return cfg_j, cfg_t, pj, pt, batch


def test_towers_infonce_and_adamw_step():
    cfg_j, cfg_t, pj, pt, batch = _tower_setup()
    bj = {k: jnp.asarray(v) for k, v in batch.items()}
    bt = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        np.testing.assert_allclose(
            t_tt.hub_tower(pt, cfg_t, bt["p_hub"], bt["u_toks"]).numpy(),
            np.asarray(j_tt.hub_tower(pj, cfg_j, bj["p_hub"], bj["u_toks"])),
            atol=1e-5)
        np.testing.assert_allclose(
            t_tt.query_tower(pt, cfg_t, bt["p_hub"]).numpy(),
            np.asarray(j_tt.query_tower(pj, cfg_j, bj["p_hub"])), atol=1e-5)
    lj, gj = jax.jit(jax.value_and_grad(j_tt.info_nce), static_argnums=1)(
        pj, cfg_j, bj)
    lt = t_tt.info_nce(pt, cfg_t, bt)
    np.testing.assert_allclose(float(lt.detach()), float(lj), atol=1e-5)
    names = list(pt.as_dict())
    gt = dict(zip(names, torch.autograd.grad(lt, list(pt.as_dict().values()))))
    for k in names:
        np.testing.assert_allclose(gt[k].numpy(), np.asarray(gj[k]), atol=1e-5,
                                   err_msg=k)
    # one AdamW step from the same gradients
    oj = j_adamw(lr=1e-3, b1=0.9, b2=0.999, grad_clip=None)
    ot = t_adamw(lr=1e-3, b1=0.9, b2=0.999, grad_clip=None)
    new_j, _, _ = jax.jit(oj.apply)(pj, gj, oj.init(pj))
    p0 = {k: v.detach() for k, v in pt.as_dict().items()}
    g0 = {k: torch.tensor(np.asarray(gj[k])) for k in names}
    new_t, state, _ = ot.apply(p0, g0, ot.init(p0))
    assert int(state["step"]) == 1
    for k in names:
        np.testing.assert_allclose(new_t[k].numpy(), np.asarray(new_j[k]),
                                   atol=1e-5, err_msg=k)


def test_nav_graph_exact_and_descend_equal():
    rng = np.random.default_rng(6)
    reps = rng.standard_normal((40, 16)).astype(np.float32)
    reps /= np.linalg.norm(reps, axis=1, keepdims=True)
    a = j_nav.build_nav_graph(reps, s=5)
    b = t_nav.build_nav_graph(reps, s=5)
    np.testing.assert_array_equal(b.neighbors, a.neighbors)
    np.testing.assert_array_equal(b.reps, a.reps)
    assert b.start == a.start
    zq = rng.standard_normal((30, 16)).astype(np.float32)
    zq /= np.linalg.norm(zq, axis=1, keepdims=True)
    for w in (1, 3):
        ja, jh = j_nav.descend(j_nav.NavGraphDevice.from_host(a), jnp.asarray(zq),
                               probe_width=w, instrument=True)
        ta, th = t_nav.descend(t_nav.NavGraphDevice.from_host(b, CPU),
                               torch.from_numpy(zq), probe_width=w,
                               instrument=True)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))


def test_medoid_takes_the_reference_signature(small_db):
    """``sample`` and ``seed`` are accepted and ignored, as in ``repro``;
    ``device`` is keyword-only, so a positional 4096 is ``sample``."""
    db = small_db[0][:600]
    want = j_knn.medoid(db)
    assert t_knn.medoid(db, seed=0, device=CPU) == want
    assert t_knn.medoid(db, 4096, device=CPU) == want
    assert t_knn.medoid(db, 17, 3, device=CPU) == want
    with pytest.raises(TypeError):
        t_knn.medoid(db, 4096, 0, CPU)


@pytest.mark.parametrize("n_c", [1, 7, 64])
def test_cluster_size_variance_equals_reference(small_db, n_c):
    from repro.core.hbkm import cluster_size_variance as j_var

    rng = np.random.default_rng(n_c)
    for assign in (rng.integers(0, n_c, 1000).astype(np.int32),
                   np.zeros(10, np.int32),
                   t_hbkm.hbkm(small_db[0][:500], n_c, device=CPU)[0]):
        assert t_hbkm.cluster_size_variance(assign, n_c) == j_var(assign, n_c)
