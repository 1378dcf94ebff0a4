"""zamba2 hybrid parity: ``repro_torch.models.hybrid.HybridLM`` against
``repro.models.hybrid.HybridLM`` on the same weights and tokens, on the
CPU, float32.

The model is the reduced zamba2-1.2b: 4 Mamba2 layers with the shared
block after every 2 (two applications, each with its own K / V), d 128,
state 16, SSD chunk 32, with ``repro``'s weights and its zero- and
one-initialised parameters (``A_log``, ``dt_bias``, ``D_skip``, the
norms) moved off their init by a numpy draw (``test_torch_rwkv.lm_pair``),
and the shared block's ``s_wq`` and ``s_wk`` scaled to a standard
deviation of 1/sqrt(d).  ``repro``'s init gives them 1/sqrt(H) (fan-in
``shape[-2]``, 0.5 here), which makes the shared attention almost one-hot:
then each package's float32 decode reads about 1e-4 from a float64 run
(``test_hybrid_reference_init_amplifies_float32_rounding``), the size of
the tolerance, as gemma-2b's random init does (ROADMAP C).
Prompts of S ∈ {20, 32, 45} tokens: below, equal to, and not a multiple
of the chunk.  ``repro``'s prefill takes the last k − 1 = 3 positions as
the conv state, so it needs S ≥ 3 (ROADMAP C); no prompt here is shorter.

Tolerances: prefill logits and every cache entry, then 4 decode steps,
within 1e-4 of the largest value (fp32 products and sums in another order
through 4 layers); ``loss`` within 1e-5; cache positions equal;
``cache_specs`` shapes and dtypes equal, in float32 and bfloat16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.model import build_model as j_build_model

from repro_torch.configs import get_reduced
from repro_torch.models.model import build_model

from test_torch_rwkv import _rel, _t, lm_pair
from test_torch_search import one_torch_thread  # noqa: F401  (autouse)

B = 2


def _attn_scale(cfg):
    """s_wq and s_wk from std 1/sqrt(H) to 1/sqrt(d)."""
    f = float(np.sqrt(cfg.num_heads / cfg.d_model))
    return {"s_wq": f, "s_wk": f}


@pytest.fixture(scope="module")
def hybrid_pair():
    jm, tm, jp, tp = lm_pair("zamba2-1.2b", seed=2,
                             scale=_attn_scale(get_reduced("zamba2-1.2b")))
    assert (tm.cfg.num_layers, tm.cfg.attn_every, tm.n_shared_apps) == (4, 2, 2)
    return jm, tm, jp, tp


def _chain_rel(jm, tm, jp, tp, S: int, steps: int = 4):
    """Prefill of S tokens then ``steps`` decodes in ``repro`` (float32)
    and in the port in float64 on the same weights: the largest relative
    difference of the logits over the chain."""
    m64 = build_model(tm.cfg.with_(compute_dtype="float64"))
    p64 = m64.compute_params({n: p.double() for n, p in tp.items()})
    toks = np.random.default_rng(S).integers(
        2, tm.cfg.vocab_size, (B, S + steps)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S])},
                        capacity=S + steps)
    with torch.no_grad():
        tl, tc = m64.prefill(p64, {"tokens": _t(toks[:, :S])},
                             capacity=S + steps)
    worst = _rel(jl, tl)
    for i in range(steps):
        t = np.full((B,), S + i, np.int32)
        tok = toks[:, S + i:S + i + 1]
        jl, jc = jm.decode(jp, jnp.asarray(tok), jc, jnp.asarray(t))
        with torch.no_grad():
            tl, tc = m64.decode(p64, _t(tok), tc, _t(t))
        worst = max(worst, _rel(jl, tl))
    return worst


def test_hybrid_reference_init_amplifies_float32_rounding(hybrid_pair):
    """``repro``'s float32 chain against the port's float64 one: at
    ``repro``'s own init (attention weights std 0.5) it strays past 5e-5,
    at the test's scaled ones it stays within 2e-5."""
    jm, tm, jp, tp = hybrid_pair
    assert _chain_rel(jm, tm, jp, tp, 32) <= 2e-5
    jm, tm, jp, tp = lm_pair("zamba2-1.2b", seed=2)
    assert _chain_rel(jm, tm, jp, tp, 32) > 5e-5


@pytest.mark.parametrize("S", [20, 32, 45])
def test_hybrid_prefill_then_decode_match(hybrid_pair, S):
    jm, tm, jp, tp = hybrid_pair
    steps = 4
    toks = np.random.default_rng(S).integers(
        2, tm.cfg.vocab_size, (B, S + steps)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S])},
                        capacity=S + steps)
    with torch.no_grad():
        tl, tc = tm.prefill(tp, {"tokens": _t(toks[:, :S])},
                            capacity=S + steps)
    assert set(tc) == set(jc) == {"k", "v", "pos", "ssm", "conv"}
    assert _rel(tl, jl) <= 1e-4
    for f in ("k", "v", "ssm", "conv"):
        assert tc[f].shape == jc[f].shape and _rel(tc[f], jc[f]) <= 1e-4, f
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for i in range(steps):
        t = np.full((B,), S + i, np.int32)
        tok = toks[:, S + i:S + i + 1]
        jl, jc = jm.decode(jp, jnp.asarray(tok), jc, jnp.asarray(t))
        with torch.no_grad():
            tl, tc = tm.decode(tp, _t(tok), tc, _t(t))
        assert _rel(tl, jl) <= 1e-4, i
        for f in ("k", "v", "ssm", "conv"):
            assert _rel(tc[f], jc[f]) <= 1e-4, (i, f)
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_hybrid_loss_and_cache_specs_match(hybrid_pair):
    jm, tm, jp, tp = hybrid_pair
    rng = np.random.default_rng(4)
    toks = rng.integers(0, tm.cfg.vocab_size, (B, 24)).astype(np.int32)
    labels = toks.copy()
    labels[:, :3] = -1
    jl, jmet = jm.loss(jp, {"tokens": jnp.asarray(toks),
                            "labels": jnp.asarray(labels)})
    with torch.no_grad():
        tl, tmet = tm.loss(tp, {"tokens": _t(toks), "labels": _t(labels)})
    assert abs(float(tl) - float(jl)) <= 1e-5 * max(1.0, abs(float(jl)))
    assert float(tmet["aux"]) == 0.0
    for dt in ("float32", "bfloat16"):
        want = j_build_model(jm.cfg.with_(compute_dtype=dt)).cache_specs(3, 40)
        got = build_model(tm.cfg.with_(compute_dtype=dt)).cache_specs(3, 40)
        assert list(got) == list(want)
        for k in want:
            assert got[k].shape == want[k].shape, k
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
