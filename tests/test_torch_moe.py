"""MoE parity: ``repro_torch.models.moe`` against ``repro.models.moe`` on
the same weights and inputs, on the CPU, at the reduced qwen2-moe (4
experts top-2, one shared expert) and the reduced mixtral (4 experts
top-2, none shared), float32.

``repro`` draws the weights (``jax.random``); they carry across as numpy.
Tolerances: the router's weights and aux within 1e-6, its ids equal;
dense ``moe_ffn`` within 1e-5; the dropping dispatch at capacity factors
0.5, 1.25 and E/K keeps the same slots and agrees within 1e-5, and at E/K
(nothing dropped) equals the dense dispatch within 1e-5; two dropping runs
give the same bits.  The tie case (``chip_smoke.router_tie_case``, which
the smoke also runs on the card) needs ties to the lowest expert id.
"""
import sys
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.distributed.sharding import NULL_CTX
from repro.models import moe as jmoe
from repro.models.common import init_params as j_init_params

from repro_torch.configs import get_reduced
from repro_torch.models import moe as tmoe

from test_torch_search import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

ARCHS = ["qwen2-moe-a2.7b", "mixtral-8x22b"]


def _with_moe(cfg, **kw):
    return cfg.with_(moe=replace(cfg.moe, **kw))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    jcfg, tcfg = j_get_reduced(request.param), get_reduced(request.param)
    jp = j_init_params(jmoe.moe_param_table(jcfg, "", 0),
                       jax.random.PRNGKey(2), "float32")
    tp = {n: torch.from_numpy(np.array(a)) for n, a in jp.items()}
    x = np.random.default_rng(7).standard_normal(
        (2, 24, tcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def _ffn(jcfg, tcfg, jp, tp, x):
    want, jaux = jmoe.moe_ffn(jnp.asarray(x), jp, "", jcfg, NULL_CTX)
    with torch.no_grad():
        got, taux = tmoe.moe_ffn(torch.from_numpy(x), tp, "", tcfg)
    return got, taux, np.asarray(want), np.asarray(jaux)


def test_param_table_is_the_references(case):
    jcfg, tcfg, jp, tp, _ = case
    jt = jmoe.moe_param_table(jcfg, "p/", 3)
    tt = tmoe.moe_param_table(tcfg, "p/", 3)
    assert list(jt) == list(tt)
    for n in jt:
        assert (jt[n].shape, jt[n].axes, jt[n].init, jt[n].scale) == \
            (tt[n].shape, tt[n].axes, tt[n].init, tt[n].scale), n
    assert ("ws_gate" in tp) == bool(tcfg.moe.shared_experts)


def test_router_matches(case):
    jcfg, tcfg, jp, tp, x = case
    jw, jids, jaux = jmoe._router(jnp.asarray(x), jp["router"], jcfg.moe)
    tw, tids, taux = tmoe._router(torch.from_numpy(x), tp["router"], tcfg.moe)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    _close(tw, jw, 1e-6)
    _close(taux, jaux, 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_router_ties_go_to_the_lowest_id(case, dtype):
    jcfg, tcfg, *_ = case
    moe = tcfg.moe
    x, w, want = chip_smoke.router_tie_case(
        np, moe.num_experts, moe.experts_per_token, tcfg.d_model, 24)
    jx, jw = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    _, jids, _ = jmoe._router(jx, jw, jcfg.moe)
    tdt = getattr(torch, dtype)
    _, tids, _ = tmoe._router(torch.from_numpy(x).to(tdt),
                              torch.from_numpy(w).to(tdt), moe)
    jids = np.asarray(jids)
    # the case is a tie: the last pick's logit equals expert E-1's
    logits = (torch.from_numpy(x).to(tdt) @ torch.from_numpy(w).to(tdt))
    assert torch.equal(logits[..., moe.experts_per_token - 1],
                       logits[..., moe.num_experts - 1])
    assert (jids == want).all()
    np.testing.assert_array_equal(tids.numpy(), jids)


def test_dense_moe_ffn_matches(case):
    jcfg, tcfg, jp, tp, x = case
    assert tcfg.moe.impl == "dense"
    got, taux, want, jaux = _ffn(jcfg, tcfg, jp, tp, x)
    assert got.dtype == torch.float32 and taux.dtype == torch.float32
    _close(got, want, 1e-5)
    _close(taux, jaux, 1e-6)


@pytest.mark.parametrize("cf", [0.5, 1.25, "E/K"])
def test_dropping_dispatch_matches(case, cf):
    jcfg, tcfg, jp, tp, x = case
    moe = tcfg.moe
    if cf == "E/K":
        cf = moe.num_experts / moe.experts_per_token
    jc = _with_moe(jcfg, impl="dropping", capacity_factor=cf)
    tc = _with_moe(tcfg, impl="dropping", capacity_factor=cf)
    E, K = moe.num_experts, moe.experts_per_token
    T = x.shape[0] * x.shape[1]
    cap = tmoe.capacity(T, tc.moe)
    assert cap == max(int(np.ceil(T * K / E * cf)), 1)
    # the same slots kept, and the same buffers
    _, ids, _ = jmoe._router(jnp.asarray(x), jp["router"], jcfg.moe)
    xf = x.reshape(T, -1)
    jbuf, jkeep, jsrc, jtok, jslot = jmoe._scatter_group(
        jnp.asarray(xf), ids.reshape(T, K), E, K, cap, jnp.float32)
    tbuf, tkeep, tsrc, order = tmoe._scatter_group(
        torch.from_numpy(xf), torch.from_numpy(np.array(ids)).reshape(T, K),
        E, K, cap, torch.float32)
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(tsrc.numpy(), np.asarray(jsrc))
    np.testing.assert_array_equal((order // K).numpy(), np.asarray(jtok))
    np.testing.assert_array_equal((order % K).numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    if cf == 0.5:
        assert not bool(tkeep.all())  # slots really are dropped here
    else:
        assert bool(tkeep.all())
    got, taux, want, jaux = _ffn(jc, tc, jp, tp, x)
    _close(got, want, 1e-5)
    _close(taux, jaux, 1e-6)
    if cf == E / K:  # nothing dropped: the dense dispatch's output
        dense, _, _, _ = _ffn(jcfg, tcfg, jp, tp, x)
        _close(got, dense, 1e-5)


def test_dropping_dispatch_is_deterministic(case):
    _, tcfg, _, tp, x = case
    tc = _with_moe(tcfg, impl="dropping")
    with torch.no_grad():
        a, _ = tmoe.moe_ffn(torch.from_numpy(x), tp, "", tc)
        b, _ = tmoe.moe_ffn(torch.from_numpy(x), tp, "", tc)
    assert torch.equal(a, b)


def test_top_k_keeps_the_order_of_ties():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3]])
    vals, ids = tmoe.top_k_lowest_first(probs, 3)
    assert ids.tolist() == [[1, 2, 4]]
    jv, jids = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert np.asarray(jids).tolist() == ids.tolist()
