"""Enc-dec parity: ``repro_torch.models.encdec.EncDecLM`` against
``repro.models.encdec.EncDecLM`` on the same weights, frames and tokens,
on the CPU, float32.

The model is the reduced seamless-m4t-medium: 2 encoder and 2 decoder
layers, d 128, 4 heads of 32, KV chunk 64, with ``repro``'s weights, its
zero-initialised norms moved off their init by a numpy draw, and every
attention's ``wq`` / ``wk`` (encoder, decoder self- and cross-attention)
scaled to a standard deviation of 1/sqrt(d).  ``repro``'s init gives them
1/sqrt(H) (fan-in ``shape[-2]``, 0.5 here), which makes each attention
almost one-hot: each package's float32 logits then read about 1e-4 from
a float64 run (``test_encdec_reference_init_amplifies_float32_rounding``),
as gemma-2b's and zamba2's random inits do (ROADMAP C).
Frames of 24 and 100 positions (one KV chunk; two with a ragged tail) and
prompts of 20 and 45 tokens.

Tolerances: prefill logits and every cache entry, then 4 decode steps,
within 1e-5 of the largest value (fp32 products and sums in another order
through 4 layers); ``loss`` within 1e-5; positions, input batches, zero
caches and ``cache_specs`` equal; in float64, prefill(S+1) against
prefill(S) + decode within 1e-12; the cross-attention's ``pos_q = int32
max`` against a plain softmax over the valid slots within 1e-6.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.models import model as jmodel
from repro.models.model import build_model as j_build_model

from repro_torch.configs import get_reduced
from repro_torch.configs.base import ShapeSpec
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import model as tmodel
from repro_torch.models.common import decode_attention
from repro_torch.models.encdec import INT32_MAX
from repro_torch.models.model import build_model

from test_torch_rwkv import _rel, _t
from test_torch_search import one_torch_thread  # noqa: F401  (autouse)

ARCH = "seamless-m4t-medium"
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
B = 2
ATTN = ("enc/wq", "enc/wk", "dec/wq", "dec/wk", "dec/xwq", "dec/xwk")


def encdec_pair(seed: int = 1, scaled: bool = True):
    """``repro``'s and the port's reduced model on ``repro``'s weights (the
    zero-initialised ones moved by a numpy draw, std 0.3), the attention
    weights scaled from std 1/sqrt(H) to 1/sqrt(d) when ``scaled``."""
    jcfg = j_get_reduced(ARCH).with_(remat=False)
    tcfg = get_reduced(ARCH)
    jm, tm = j_build_model(jcfg), build_model(tcfg)
    rng = np.random.default_rng(seed)
    jp = {n: np.array(a) for n, a in jm.init(jax.random.PRNGKey(seed)).items()}
    for n, spec in tm.param_table().items():
        if spec.init != "normal":
            jp[n] = (jp[n] + 0.3 * rng.standard_normal(spec.shape)).astype(
                np.float32)
    if scaled:
        f = float(np.sqrt(tcfg.num_heads / tcfg.d_model))
        for n in ATTN:
            jp[n] = (jp[n] * f).astype(np.float32)
    tp = lm_params_from_numpy(tcfg, jp, device="cpu")
    return jm, tm, {n: jnp.asarray(a) for n, a in jp.items()}, tp


@pytest.fixture(scope="module")
def pair():
    jm, tm, jp, tp = encdec_pair()
    assert (tm.cfg.encoder_layers, tm.cfg.num_layers) == (2, 2)
    return jm, tm, jp, tp


def _inputs(cfg, Se: int, S: int, seed: int):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, Se, cfg.d_model)).astype(np.float32)
    toks = rng.integers(2, cfg.vocab_size, (B, S)).astype(np.int32)
    return frames, toks


@pytest.mark.parametrize("Se,S", [(24, 20), (100, 45)])
def test_encdec_prefill_then_decode_match(pair, Se, S):
    jm, tm, jp, tp = pair
    steps = 4
    frames, toks = _inputs(tm.cfg, Se, S + steps, Se + S)
    jl, jc = jm.prefill(jp, {"frames": jnp.asarray(frames),
                             "tokens": jnp.asarray(toks[:, :S])},
                        capacity=S + steps)
    with torch.no_grad():
        tl, tc = tm.prefill(tp, {"frames": _t(frames),
                                 "tokens": _t(toks[:, :S])},
                            capacity=S + steps)
    assert set(tc) == set(jc) == {"k", "v", "pos", "xk", "xv", "enc_pos"}
    assert _rel(tl, jl) <= 1e-5
    for f in ("k", "v", "xk", "xv"):
        assert tc[f].shape == jc[f].shape and _rel(tc[f], jc[f]) <= 1e-5, f
    for f in ("pos", "enc_pos"):
        assert tc[f].dtype == torch.int32
        np.testing.assert_array_equal(tc[f].numpy(), np.asarray(jc[f]))
    for i in range(steps):
        t = np.full((B,), S + i, np.int32)
        tok = toks[:, S + i:S + i + 1]
        jl, jc = jm.decode(jp, jnp.asarray(tok), jc, jnp.asarray(t))
        with torch.no_grad():
            tl, tc = tm.decode(tp, _t(tok), tc, _t(t))
        assert _rel(tl, jl) <= 1e-5, i
        for f in ("k", "v"):
            assert _rel(tc[f], jc[f]) <= 1e-5, (i, f)
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_encdec_loss_matches(pair):
    jm, tm, jp, tp = pair
    frames, toks = _inputs(tm.cfg, 40, 24, 4)
    labels = toks.copy()
    labels[0, 5:9] = -1  # ignored positions
    jl, jmet = jm.loss(jp, {"frames": jnp.asarray(frames),
                            "tokens": jnp.asarray(toks),
                            "labels": jnp.asarray(labels)})
    tl, tmet = tm.loss(tp, {"frames": _t(frames), "tokens": _t(toks),
                            "labels": _t(labels)})
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert float(tmet["aux"]) == float(jmet["aux"]) == 0.0


def test_encdec_float64_prefill_then_decode_is_prefill():
    """Prefill of S + 1 tokens against prefill of S then one decode, in
    float64 at ``repro``'s own init (no scaling): 1e-12."""
    _, tm, _, tp = encdec_pair(seed=3, scaled=False)
    m64 = build_model(tm.cfg.with_(compute_dtype="float64"))
    p64 = m64.compute_params({n: p.double() for n, p in tp.items()})
    frames, toks = _inputs(tm.cfg, 70, 33, 5)
    S = 32
    with torch.no_grad():
        full, _ = m64.prefill(p64, {"frames": _t(frames), "tokens": _t(toks)})
        _, cache = m64.prefill(p64, {"frames": _t(frames),
                                     "tokens": _t(toks[:, :S])}, capacity=S + 1)
        step, _ = m64.decode(p64, _t(toks[:, S:]), cache,
                             torch.full((B,), S, dtype=torch.int32))
    assert full.dtype == torch.float64
    assert _rel(step, full) <= 1e-12


def _chain_rel(jm, tm, jp, tp):
    """``repro``'s float32 prefill + 4 decodes against the port's float64
    ones on the same weights: the largest relative logit difference."""
    m64 = build_model(tm.cfg.with_(compute_dtype="float64"))
    p64 = m64.compute_params({n: p.double() for n, p in tp.items()})
    frames, toks = _inputs(tm.cfg, 48, 24, 6)
    S = 20
    jl, jc = jm.prefill(jp, {"frames": jnp.asarray(frames),
                             "tokens": jnp.asarray(toks[:, :S])}, capacity=24)
    with torch.no_grad():
        tl, tc = m64.prefill(p64, {"frames": _t(frames),
                                   "tokens": _t(toks[:, :S])}, capacity=24)
    worst = _rel(jl, tl)
    for i in range(4):
        t = np.full((B,), S + i, np.int32)
        tok = toks[:, S + i:S + i + 1]
        jl, jc = jm.decode(jp, jnp.asarray(tok), jc, jnp.asarray(t))
        with torch.no_grad():
            tl, tc = m64.decode(p64, _t(tok), tc, _t(t))
        worst = max(worst, _rel(jl, tl))
    return worst


def test_encdec_reference_init_amplifies_float32_rounding(pair):
    """``repro``'s float32 chain against the port's float64 one: within
    5e-6 at the test's scaled attention weights, past 2e-5 at ``repro``'s
    own init (std 0.5)."""
    assert _chain_rel(*pair) <= 5e-6
    assert _chain_rel(*encdec_pair(scaled=False)) > 2e-5


def test_cross_attention_at_the_int32_boundary():
    """``decode``'s cross-attention passes ``pos_q = int32 max``: every
    encoder slot with ``pos_k >= 0`` is attended, slots at -1 are not, and
    nothing overflows."""
    rng = np.random.default_rng(7)
    Se, H, D = 9, 2, 8
    q = torch.from_numpy(rng.standard_normal((B, 1, H, D)))
    k = torch.from_numpy(rng.standard_normal((B, Se, H, D)))
    v = torch.from_numpy(rng.standard_normal((B, Se, H, D)))
    pos_k = torch.arange(Se, dtype=torch.int32).expand(B, Se).clone()
    pos_k[1, -3:] = -1
    big = torch.full((B, 1), INT32_MAX, dtype=torch.int32)
    got = decode_attention(q, k, v, big, pos_k)
    for b in range(B):
        n = int((pos_k[b] >= 0).sum())
        s = torch.einsum("hd,khd->hk", q[b, 0], k[b, :n]) / np.sqrt(D)
        want = torch.einsum("hk,khd->hd", torch.softmax(s, -1), v[b, :n])
        assert float((got[b, 0] - want).abs().max()) <= 1e-6


def test_encdec_specs_inputs_and_cache_are_the_references():
    cfg, jcfg = get_reduced(ARCH), j_get_reduced(ARCH)
    for kind, S in (("train", 24), ("prefill", 24), ("prefill", 200),
                    ("decode", 24)):
        shape, jshape = ShapeSpec("t", kind, S, 3), JShapeSpec("t", kind, S, 3)
        specs = tmodel.batch_specs(cfg, shape)
        jspecs = jmodel.batch_specs(jcfg, jshape)
        assert list(specs) == list(jspecs)
        for k in specs:
            assert specs[k].shape == jspecs[k].shape, (kind, k)
            assert str(specs[k].dtype).split(".")[-1] == str(jspecs[k].dtype)
        got = tmodel.make_inputs(cfg, shape, seed=2, device="cpu")
        want = jmodel.make_inputs(jcfg, jshape, seed=2)
        assert list(got) == list(want)
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    tspecs = build_model(cfg).cache_specs(3, 16)
    jspecs = j_build_model(jcfg).cache_specs(3, 16)
    assert {k: (v.shape, str(v.dtype).split(".")[-1])
            for k, v in tspecs.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in jspecs.items()}
    got = tmodel.make_cache(cfg, 3, 16, filled=5, device="cpu")
    want = jmodel.make_cache(jcfg, 3, 16, filled=5)
    assert list(got) == list(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_drawn_init_amplifies_float64_rounding():
    """At seamless-m4t-medium's attention width (d 1024, 16 heads of 64;
    d_ff 256 and vocab 512 to keep it small) and 4 + 4 layers, the drawn
    init (wq / wk std 1/sqrt(H) = 0.25) makes the attentions almost
    one-hot, and the float64 gap between prefill(S+1) and prefill(S) +
    decode reads thousands of times one pass's rounding (12 + 12 layers at
    full width read 1.25e-6 on the card); with every attention's wq / wk
    scaled to std 1/sqrt(d) it stays at that rounding."""
    import chip_smoke

    from repro_torch.configs import get_config

    cfg = get_config(ARCH).with_(vocab_size=512, d_ff=256, num_layers=4,
                                 encoder_layers=4, compute_dtype="float64")
    m = build_model(cfg)
    drawn = {n: w.double()
             for n, w in m.init(torch.Generator().manual_seed(0)).items()}
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.standard_normal((1, 32, cfg.d_model)))
    toks = torch.from_numpy(rng.integers(2, 512, (1, 17)).astype(np.int32))

    def gap(scale):
        p = {n: w * scale if n in ATTN else w for n, w in drawn.items()}
        return chip_smoke.chained_decode_rel(torch, m, p, toks, frames=frames)

    at_init, scaled = gap(1.0), gap(0.125)
    assert scaled < 1e-14 and at_init > 300 * scaled, (at_init, scaled)
