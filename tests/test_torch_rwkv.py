"""RWKV-6 parity: ``repro_torch.models.rwkv`` against ``repro.models.rwkv``
on the same numpy inputs and weights, on the CPU, float32 unless stated.

The recurrence's inputs are drawn over a wide range: log-decays from −8
to −1e-3 a step (log-uniform per channel), a random bonus ``u`` and a
non-zero initial state, at S ∈ {5, 16, 37} with chunk 16 (below, equal
to, and not a multiple of the chunk).  The model is the reduced
rwkv6-1.6b (2 layers, d 128, 4 heads of 32, chunk 16) with ``repro``'s
weights, its zero- and one-initialised parameters (the mixes, the decay
base, ``u``, the norms) moved off their init by a numpy draw, so that
every weight matters.

Tolerances: ``_group_norm_heads``, ``wkv6_chunked`` and ``wkv6_step``
within 1e-5 of the largest value; in the port alone, in float64,
``wkv6_chunked`` against a loop of ``wkv6_step`` within 1e-12; the
model's prefill logits and state, then 4 decode steps, within 1e-4
(fp32 products and sums in another order through 2 layers); ``loss``
within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.models import rwkv as jrwkv
from repro.models.model import build_model as j_build_model

from repro_torch.configs import get_reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import rwkv as trwkv
from repro_torch.models.model import build_model

from test_torch_search import one_torch_thread  # noqa: F401  (autouse)

B, H, HD, CHUNK = 2, 4, 16, 16


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.asarray(a).dtype))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def wkv_inputs(S: int, seed: int, dtype=np.float32):
    """(r, k, v, logw, u, S0), logw log-uniform in [−8, −1e-3]."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, HD)) for _ in range(3))
    logw = -np.exp(rng.uniform(np.log(1e-3), np.log(8.0), (B, S, H, HD)))
    u = rng.standard_normal((H, HD))
    S0 = rng.standard_normal((B, H, HD, HD))
    return tuple(a.astype(dtype) for a in (r, k, v, logw, u, S0))


def test_group_norm_heads_is_the_population_variance():
    rng = np.random.default_rng(0)
    y = (rng.standard_normal((B, 5, H, HD)) * 3 + 1).astype(np.float32)
    scale, bias = (rng.standard_normal(H * HD).astype(np.float32)
                   for _ in range(2))
    want = jrwkv._group_norm_heads(*map(jnp.asarray, (y, scale, bias)), 1e-5, H)
    got = trwkv._group_norm_heads(*map(_t, (y, scale, bias)), 1e-5, H)
    assert _rel(got, want) <= 1e-5
    # torch.var's default (correction=1) would be off by far more
    yf = torch.from_numpy(y)
    wrong = (yf - yf.mean(-1, keepdim=True)) * torch.rsqrt(
        yf.var(-1, keepdim=True) + 1e-5)
    wrong = wrong.reshape(B, 5, H * HD) * _t(scale) + _t(bias)
    assert _rel(wrong, want) > 1e-2


@pytest.mark.parametrize("with_S0", [False, True])
@pytest.mark.parametrize("S", [5, 16, 37])
def test_wkv6_chunked_matches(S, with_S0):
    r, k, v, logw, u, S0 = wkv_inputs(S, seed=S)
    S0 = S0 if with_S0 else None
    jy, jS = jrwkv.wkv6_chunked(*map(jnp.asarray, (r, k, v, logw, u)), CHUNK,
                                None if S0 is None else jnp.asarray(S0))
    ty, tS = trwkv.wkv6_chunked(*map(_t, (r, k, v, logw, u)), CHUNK,
                                None if S0 is None else _t(S0))
    assert ty.shape == (B, S, H, HD) and tS.dtype == torch.float32
    assert _rel(ty, jy) <= 1e-5
    assert _rel(tS, jS) <= 1e-5


def test_wkv6_step_matches():
    r, k, v, logw, u, S0 = wkv_inputs(1, seed=4)
    args = (r[:, 0], k[:, 0], v[:, 0], logw[:, 0], u, S0)
    jy, jS = jrwkv.wkv6_step(*map(jnp.asarray, args))
    ty, tS = trwkv.wkv6_step(*map(_t, args))
    assert _rel(ty, jy) <= 1e-5 and _rel(tS, jS) <= 1e-5


@pytest.mark.parametrize("S", [5, 16, 37])
def test_wkv6_chunked_is_its_step_loop_in_float64(S):
    """The chunked form, its padded tail and the state it hands on against
    the recurrence one token at a time, from a non-zero state."""
    r, k, v, logw, u, S0 = map(_t, wkv_inputs(S, seed=20 + S,
                                              dtype=np.float64))
    y, Sf = trwkv.wkv6_chunked(r, k, v, logw, u, CHUNK, S0)
    assert y.dtype == Sf.dtype == torch.float64
    St, ys = S0, []
    for s in range(S):
        y_s, St = trwkv.wkv6_step(r[:, s], k[:, s], v[:, s], logw[:, s], u,
                                  St)
        ys.append(y_s)
    assert _rel(y, torch.stack(ys, 1)) <= 1e-12
    assert _rel(Sf, St) <= 1e-12


def lm_pair(arch: str, seed: int = 1, scale=None):
    """``repro``'s and the port's reduced model with ``repro``'s weights,
    the zero- and one-initialised ones moved by a numpy draw (std 0.3),
    and each weight named in ``scale`` multiplied by its factor."""
    jcfg = j_get_reduced(arch).with_(remat=False)
    tcfg = get_reduced(arch)
    jm, tm = j_build_model(jcfg), build_model(tcfg)
    table = tm.param_table()
    rng = np.random.default_rng(seed)
    jp = {n: np.array(a) for n, a in jm.init(jax.random.PRNGKey(seed)).items()}
    for n, spec in table.items():
        if spec.init != "normal":
            jp[n] = (jp[n] + 0.3 * rng.standard_normal(spec.shape)).astype(
                np.float32)
    for n, f in (scale or {}).items():
        jp[n] = (jp[n] * f).astype(np.float32)
    tp = lm_params_from_numpy(tcfg, jp, device="cpu")
    return jm, tm, {n: jnp.asarray(a) for n, a in jp.items()}, tp


@pytest.fixture(scope="module")
def rwkv_pair():
    return lm_pair("rwkv6-1.6b")


@pytest.mark.parametrize("S", [10, 16, 37])
def test_rwkv_prefill_then_decode_match(rwkv_pair, S):
    jm, tm, jp, tp = rwkv_pair
    steps = 4
    toks = np.random.default_rng(S).integers(
        2, tm.cfg.vocab_size, (B, S + steps)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S])})
    with torch.no_grad():
        tl, tc = tm.prefill(tp, {"tokens": _t(toks[:, :S])}, capacity=S + 4)
    assert set(tc) == set(jc) == {"wkv", "shift_t", "shift_c"}
    assert _rel(tl, jl) <= 1e-4
    for f in tc:
        assert tc[f].shape == jc[f].shape and _rel(tc[f], jc[f]) <= 1e-4, f
    for i in range(steps):
        t = np.full((B,), S + i, np.int32)
        tok = toks[:, S + i:S + i + 1]
        jl, jc = jm.decode(jp, jnp.asarray(tok), jc, jnp.asarray(t))
        with torch.no_grad():
            tl, tc = tm.decode(tp, _t(tok), tc, _t(t))
        assert _rel(tl, jl) <= 1e-4, i
        for f in tc:
            assert _rel(tc[f], jc[f]) <= 1e-4, (i, f)


def test_rwkv_loss_and_cache_specs_match(rwkv_pair):
    jm, tm, jp, tp = rwkv_pair
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
    for bf16 in (False, True):
        jcfg, tcfg = jm.cfg, tm.cfg
        if bf16:
            jcfg = jcfg.with_(compute_dtype="bfloat16")
            tcfg = tcfg.with_(compute_dtype="bfloat16")
        want = j_build_model(jcfg).cache_specs(3, 40)
        got = build_model(tcfg).cache_specs(3, 40)
        assert list(got) == list(want)
        for k in want:
            assert got[k].shape == want[k].shape, k
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
