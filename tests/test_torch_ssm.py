"""Mamba2 / SSD parity: ``repro_torch.models.ssm`` against
``repro.models.ssm`` on the same numpy inputs, on the CPU, float32 unless
stated.

The scan inputs are drawn over a wide range: log-decays ``dt * A`` from
−8 to −1e-3 a step (log-uniform), and a non-zero initial state, at
S ∈ {5, 32, 45, 77} with chunk 32 (below, equal to, and not a multiple of
the chunk, and a padded tail after two whole chunks).  The block's
weights are numpy draws for every parameter, the zero-initialised ones
(``A_log``, ``dt_bias``, ``m_norm``) too.

Tolerances: ``causal_depthwise_conv`` within 1e-6; ``ssd_chunked``,
``ssd_decode_step``, ``mamba_block_full`` and ``mamba_block_decode``
within 1e-5 of the largest value (fp32 products and sums in another
order); in the port alone, in float64, ``ssd_chunked`` against a loop of
``ssd_decode_step`` over the same tokens within 1e-12.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.distributed.sharding import NULL_CTX
from repro.models import ssm as jssm

from repro_torch.configs import get_reduced
from repro_torch.models import ssm as tssm

from test_torch_search import one_torch_thread  # noqa: F401  (autouse)

B, NH, HP, N, CHUNK = 2, 4, 16, 8, 32


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.asarray(a).dtype))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def scan_inputs(S: int, seed: int, dtype=np.float32):
    """(x, dt, A, Bm, Cm, h0) with log-decays dt·A log-uniform in
    [−8, −1e-3]."""
    rng = np.random.default_rng(seed)
    A = -np.exp(rng.uniform(-1.0, 1.0, NH))
    logdecay = -np.exp(rng.uniform(np.log(1e-3), np.log(8.0), (B, S, NH)))
    dt = logdecay / A
    x = rng.standard_normal((B, S, NH, HP))
    Bm, Cm = (rng.standard_normal((B, S, N)) for _ in range(2))
    h0 = rng.standard_normal((B, NH, HP, N))
    return tuple(a.astype(dtype) for a in (x, dt, A, Bm, Cm, h0))


@pytest.mark.parametrize("S", [5, 32, 45])
def test_causal_depthwise_conv_matches(S):
    rng = np.random.default_rng(S)
    x = rng.standard_normal((B, S, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    want = jssm.causal_depthwise_conv(jnp.asarray(x), jnp.asarray(w))
    got = tssm.causal_depthwise_conv(_t(x), _t(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("S", [5, 32, 45, 77])
def test_ssd_chunked_matches(S, with_h0):
    x, dt, A, Bm, Cm, h0 = scan_inputs(S, seed=S)
    h0 = h0 if with_h0 else None
    jy, jh = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), CHUNK,
                              None if h0 is None else jnp.asarray(h0))
    ty, th = tssm.ssd_chunked(*map(_t, (x, dt, A, Bm, Cm)), CHUNK,
                              None if h0 is None else _t(h0))
    assert ty.shape == (B, S, NH, HP) and th.dtype == torch.float32
    assert _rel(ty, jy) <= 1e-5
    assert _rel(th, jh) <= 1e-5


def test_ssd_decode_step_matches():
    x, dt, A, Bm, Cm, h0 = scan_inputs(1, seed=3)
    args = (x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], h0)
    jy, jh = jssm.ssd_decode_step(*map(jnp.asarray, args))
    ty, th = tssm.ssd_decode_step(*map(_t, args))
    assert _rel(ty, jy) <= 1e-5 and _rel(th, jh) <= 1e-5


@pytest.mark.parametrize("S", [5, 32, 45, 77])
def test_ssd_chunked_is_its_step_loop_in_float64(S):
    """The chunked form, its padded tail and the state it hands on against
    the recurrence one token at a time, from a non-zero state."""
    x, dt, A, Bm, Cm, h0 = map(_t, scan_inputs(S, seed=10 + S,
                                               dtype=np.float64))
    y, h = tssm.ssd_chunked(x, dt, A, Bm, Cm, CHUNK, h0)
    assert y.dtype == h.dtype == torch.float64
    hs, ys = h0, []
    for s in range(S):
        y_s, hs = tssm.ssd_decode_step(x[:, s], dt[:, s], A, Bm[:, s],
                                       Cm[:, s], hs)
        ys.append(y_s)
    assert _rel(y, torch.stack(ys, 1)) <= 1e-12
    assert _rel(h, hs) <= 1e-12


def _block_params(cfg, seed):
    """One layer's Mamba parameters, every one a numpy draw (the
    zero-initialised ones too), float32."""
    rng = np.random.default_rng(seed)
    out = {}
    for n, spec in jssm.mamba_param_table(cfg, (), ()).items():
        a = rng.standard_normal(spec.shape) * (
            0.5 if spec.init != "normal" else 1 / np.sqrt(spec.shape[0]))
        out[n] = a.astype(np.float32)
    return out


def test_mamba_param_table_is_the_references():
    cfg, jcfg = get_reduced("zamba2-1.2b"), j_get_reduced("zamba2-1.2b")
    want = jssm.mamba_param_table(jcfg, (3,), ("layers",))
    got = tssm.mamba_param_table(cfg, (3,), ("layers",))
    assert list(got) == list(want)
    for n in want:
        assert (got[n].shape, got[n].axes, got[n].init, got[n].scale) == \
            (want[n].shape, want[n].axes, want[n].init, want[n].scale), n


@pytest.mark.parametrize("S", [5, 45])
def test_mamba_block_full_and_decode_match(S):
    cfg, jcfg = get_reduced("zamba2-1.2b"), j_get_reduced("zamba2-1.2b")
    p = _block_params(cfg, seed=S)
    jp, tp = ({n: f(a) for n, a in p.items()} for f in (jnp.asarray, _t))
    rng = np.random.default_rng(100 + S)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    jo, jh = jssm.mamba_block_full(jp, jnp.asarray(x), jcfg, NULL_CTX)
    to, th = tssm.mamba_block_full(tp, _t(x), cfg)
    assert _rel(to, jo) <= 1e-5 and _rel(th, jh) <= 1e-5

    dI = cfg.mamba_expand * cfg.d_model
    nh = dI // cfg.mamba_headdim
    conv = rng.standard_normal((B, cfg.conv_kernel - 1, dI)).astype(np.float32)
    ssm = rng.standard_normal((B, nh, cfg.mamba_headdim,
                               cfg.ssm_state)).astype(np.float32)
    want = jssm.mamba_block_decode(jp, jnp.asarray(x[:, :1]), jcfg,
                                   jnp.asarray(conv), jnp.asarray(ssm),
                                   NULL_CTX)
    got = tssm.mamba_block_decode(tp, _t(x[:, :1]), cfg, _t(conv), _t(ssm))
    for g, w in zip(got, want):
        assert g.shape == w.shape and _rel(g, w) <= 1e-5


def test_softplus_is_logaddexp():
    """``jax.nn.softplus``'s formula, where ``F.softplus`` (x above 20)
    differs in float64."""
    import jax

    x = np.concatenate([np.linspace(-40, 40, 161), [19.5, 20.5, 30.0]])
    got = tssm.softplus(_t(x.astype(np.float32)))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax.nn.softplus(jnp.asarray(x, jnp.float32))),
        rtol=1e-6, atol=0)
    x64 = torch.tensor([20.5, 25.0, 30.0], dtype=torch.float64)
    want = torch.log1p(torch.exp(x64))
    assert float((tssm.softplus(x64) - want).abs().max()) < 1e-15
    assert float((torch.nn.functional.softplus(x64) - want).abs().max()) > 1e-10
