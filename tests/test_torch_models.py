"""LM stack parity: ``repro_torch.models`` against ``repro.models`` on the
same weights and tokens, on the CPU.

``repro`` draws the weights (``jax.random``, which the port cannot
reproduce); ``repro_torch.convert.lm_params_from_numpy`` carries them
across.  Reduced configs compute in float32.

Tolerances: parameter names and shapes equal; prefill logits and caches,
then 4 decode steps, within 1e-4 (fp32 products and sums in another
order through 2 layers); ``blockwise_attention`` within 1e-5; ``rms_norm``
and ``apply_rope`` within 1e-6; cache positions equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.models import common as jc
from repro.models.model import build_model as j_build_model
from repro.models.model import make_cache as j_make_cache
from repro.models.model import make_inputs as j_make_inputs

from repro_torch.configs import ARCH_NAMES, get_config, get_reduced
from repro_torch.configs.base import ShapeSpec
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import common as tc
from repro_torch.models.model import build_model, make_cache, make_inputs

from test_torch_search import one_torch_thread  # noqa: F401  (autouse)

CASES = {
    "gemma-2b": lambda c: c,
    "llama3-8b": lambda c: c,
    "llama3-8b-swa16": lambda c: c.with_(window=16),
}


def _cfgs(name):
    arch = name.split("-swa")[0]
    return (CASES[name](j_get_reduced(arch).with_(remat=False)),
            CASES[name](get_reduced(arch)))


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.asarray(a).dtype))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    jcfg, tcfg = _cfgs(request.param)
    jm, tm = j_build_model(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    tp = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return request.param, jcfg, tcfg, jm, tm, jp, tp


def test_configs_are_the_references():
    from repro.configs import ARCH_NAMES as J_NAMES
    from repro.configs import get_config as j_get_config

    assert ARCH_NAMES == J_NAMES
    for arch in ARCH_NAMES:
        assert get_config(arch).__dict__.keys() == j_get_config(arch).__dict__.keys()
        for cfg, jcfg in ((get_config(arch), j_get_config(arch)),
                          (get_reduced(arch), j_get_reduced(arch))):
            for f, v in cfg.__dict__.items():
                jv = getattr(jcfg, f)
                assert (v.__dict__ if hasattr(v, "__dict__") else v) == \
                    (jv.__dict__ if hasattr(jv, "__dict__") else jv), (arch, f)


def test_other_families_raise_naming_the_roadmap():
    for arch in ("mixtral-8x22b", "zamba2-1.2b", "rwkv6-1.6b",
                 "seamless-m4t-medium", "internvl2-26b"):
        with pytest.raises(NotImplementedError, match="ROADMAP A6"):
            build_model(get_reduced(arch))


def test_param_table_names_and_shapes(pair):
    _, jcfg, tcfg, jm, tm, jp, tp = pair
    jt, tt = jm.param_table(), tm.param_table()
    assert list(jt) == list(tt)
    for n in jt:
        assert jt[n].shape == tt[n].shape and jt[n].init == tt[n].init, n
        assert jt[n].scale == tt[n].scale, n
    assert {n: tuple(p.shape) for n, p in tp.items()} == \
        {n: tuple(np.shape(p)) for n, p in jp.items()}
    # the port's own init follows the table: zeros stay zero, and a normal
    # draw has the table's std (fan-in shape[-2]: H for wq)
    own = tm.init(torch.Generator().manual_seed(0))
    assert set(own) == set(tt)
    assert all(float(own[n].abs().max()) == 0.0 for n in tt
               if tt[n].init == "zeros")
    wq = own["wq"]
    assert abs(float(wq.std()) - 1 / np.sqrt(tcfg.num_heads)) < 0.05 / np.sqrt(
        tcfg.num_heads)


def test_make_inputs_and_cache_are_the_references():
    cfg = get_reduced("llama3-8b")
    for kind, S in (("train", 16), ("prefill", 16), ("decode", 16)):
        shape = ShapeSpec("t", kind, S, 3)
        got = make_inputs(cfg, shape, seed=5, device="cpu")
        want = j_make_inputs(j_get_reduced("llama3-8b"),
                             JShapeSpec("t", kind, S, 3), seed=5)
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    got = make_cache(cfg, 2, 24, filled=5, device="cpu")
    want = j_make_cache(j_get_reduced("llama3-8b"), 2, 24, filled=5)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_prefill_then_decode_match(pair):
    name, jcfg, tcfg, jm, tm, jp, tp = pair
    B, S, steps = 2, 40, 4
    rng = np.random.default_rng(3)
    toks = rng.integers(2, tcfg.vocab_size, (B, S + steps)).astype(np.int32)
    cap = S + steps
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S])},
                            capacity=cap)
    with torch.no_grad():
        tl, tcache = tm.prefill(tp, {"tokens": _t(toks[:, :S])}, capacity=cap)
    _close(tl, jl, 1e-4)
    assert tcache["k"].shape == jcache["k"].shape
    for f in ("k", "v"):
        _close(tcache[f], jcache[f], 1e-4)
    np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))
    if "swa" in name:
        assert tcache["k"].shape[2] == 16  # the rolling buffer
    for i in range(steps):
        t = np.full((B,), S + i, np.int32)
        tok = toks[:, S + i:S + i + 1]
        jl, jcache = jm.decode(jp, jnp.asarray(tok), jcache, jnp.asarray(t))
        with torch.no_grad():
            tl, tcache = tm.decode(tp, _t(tok), tcache, _t(t))
        _close(tl, jl, 1e-4)
        for f in ("k", "v"):
            _close(tcache[f], jcache[f], 1e-4)
        np.testing.assert_array_equal(tcache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))


def test_loss_matches(pair):
    _, jcfg, tcfg, jm, tm, jp, tp = pair
    rng = np.random.default_rng(4)
    toks = rng.integers(0, tcfg.vocab_size, (2, 24)).astype(np.int32)
    labels = toks.copy()
    labels[:, :3] = -1
    jl, _ = jm.loss(jp, {"tokens": jnp.asarray(toks),
                         "labels": jnp.asarray(labels)})
    with torch.no_grad():
        tl, _ = tm.loss(tp, {"tokens": _t(toks), "labels": _t(labels)})
    _close(tl, jl, 1e-5)


@pytest.mark.parametrize("Sq,Sk,chunk,q_chunk,window,Hq,Hkv", [
    (40, 40, 16, 16, None, 4, 1),    # query chunks with a padded tail
    (37, 37, 16, None, None, 4, 2),  # ragged KV tail
    (50, 50, 64, 20, 12, 4, 4),      # window, KV in one chunk
])
def test_blockwise_attention_matches(Sq, Sk, chunk, q_chunk, window, Hq, Hkv):
    rng = np.random.default_rng(Sq)
    B, D = 2, 16
    q = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    pos_q = np.broadcast_to(np.arange(Sq, dtype=np.int32), (B, Sq)).copy()
    pos_k = np.broadcast_to(np.arange(Sk, dtype=np.int32), (B, Sk)).copy()
    pos_k[1, -5:] = -1  # empty cache slots
    kw = dict(causal=True, window=window, chunk=chunk, q_chunk=q_chunk)
    want = jc.blockwise_attention(*map(jnp.asarray, (q, k, v, pos_q, pos_k)),
                                  **kw)
    got = tc.blockwise_attention(*map(_t, (q, k, v, pos_q, pos_k)), **kw)
    _close(got, want, 1e-5)
    # and the decode form on the last position against the full softmax
    want = jc.decode_attention(*map(jnp.asarray, (q[:, -1:], k, v,
                                                  pos_q[:, -1:], pos_k)),
                               window=window)
    got = tc.decode_attention(*map(_t, (q[:, -1:], k, v, pos_q[:, -1:], pos_k)),
                              window=window)
    _close(got, want, 1e-5)


def test_rms_norm_and_rope_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32) * 3
    w = rng.standard_normal((32,)).astype(np.float32)
    _close(tc.rms_norm(_t(x), _t(w), 1e-5), jc.rms_norm(jnp.asarray(x),
                                                        jnp.asarray(w), 1e-5),
           1e-6)
    pos = np.arange(14, dtype=np.int32).reshape(2, 7) * 37
    for theta in (10000.0, 500000.0):
        _close(tc.apply_rope(_t(x), _t(pos), theta),
               jc.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta), 1e-6)


def test_cross_entropy_and_glu_match():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.3).astype(np.float32)
    _close(tc.cross_entropy(_t(logits), _t(labels), _t(mask)),
           jc.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                            jnp.asarray(mask)), 1e-6)
    x = rng.standard_normal((2, 3, 8)).astype(np.float32)
    wg, wu = (rng.standard_normal((8, 16)).astype(np.float32) for _ in range(2))
    wd = rng.standard_normal((16, 8)).astype(np.float32)
    for act in ("swiglu", "geglu"):
        want = jc.glu_mlp(*map(jnp.asarray, (x, wg, wu, wd)), act,
                          jc.NULL_CTX)
        _close(tc.glu_mlp(*map(_t, (x, wg, wu, wd)), act), want, 1e-5)
