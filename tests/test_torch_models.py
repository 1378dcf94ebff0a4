"""LM stack parity: ``repro_torch.models`` against ``repro.models`` on the
same weights and tokens, on the CPU.

``repro`` draws the weights (``jax.random``, which the port cannot
reproduce); ``repro_torch.convert.lm_params_from_numpy`` carries them
across.  Reduced configs compute in float32.

The cases cover the dense family (gemma-2b, llama3-8b, and llama3-8b
with a 16-position window), the MoE family (qwen2-moe-a2.7b with shared
experts; mixtral-8x22b, also with a 16-position window) and the VLM
(internvl2-26b, whose prefill and loss take patch embeddings); the hybrid
and RWKV families have their own files (``test_torch_hybrid.py``,
``test_torch_rwkv.py``), and here their tables, counts, serve state and
``init_compute``.

Tolerances: parameter names and shapes equal; prefill logits and caches,
then 4 decode steps, within 1e-4 (fp32 products and sums in another
order through 2 layers); the loss and the MoE aux within 1e-5;
``blockwise_attention`` within 1e-5; ``rms_norm`` and ``apply_rope``
within 1e-6; cache positions, input batches, specs and the analytic
counts equal; ``init_compute`` bit-equal to ``compute_params(init(g))``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.models import common as jc
from repro.models import model as jmodel
from repro.models.model import build_model as j_build_model
from repro.models.model import make_cache as j_make_cache
from repro.models.model import make_inputs as j_make_inputs

from repro_torch.configs import ARCH_NAMES, LM_SHAPES, get_config, get_reduced
from repro_torch.configs.base import ShapeSpec
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import common as tc
from repro_torch.models import model as tmodel
from repro_torch.models.model import build_model, make_cache, make_inputs

from test_torch_search import one_torch_thread  # noqa: F401  (autouse)

CASES = {
    "gemma-2b": lambda c: c,
    "llama3-8b": lambda c: c,
    "llama3-8b-swa16": lambda c: c.with_(window=16),
    "qwen2-moe-a2.7b": lambda c: c,
    "mixtral-8x22b": lambda c: c,
    "mixtral-8x22b-swa16": lambda c: c.with_(window=16),
    "internvl2-26b": lambda c: c,
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


def _patches(cfg, B, seed):
    """The VLM's patch embeddings for a batch of B (none for the others)."""
    if cfg.family != "vlm":
        return {}
    rng = np.random.default_rng(seed)
    return {"patches": rng.standard_normal(
        (B, cfg.num_patches, cfg.patch_dim)).astype(np.float32)}


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
    """Every family is ported: ``build_model`` builds each configuration's
    model, of ``repro``'s class name, and raises only for a family that
    no configuration has."""
    for arch in ARCH_NAMES:
        cfg = get_reduced(arch)
        assert type(build_model(cfg)).__name__ == \
            type(j_build_model(j_get_reduced(arch))).__name__, arch
    with pytest.raises(ValueError, match="nosuch"):
        build_model(get_reduced("gemma-2b").with_(family="nosuch"))


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
    for arch in ("llama3-8b", "zamba2-1.2b", "rwkv6-1.6b"):
        got = make_cache(get_reduced(arch), 2, 24, filled=5, device="cpu")
        want = j_make_cache(j_get_reduced(arch), 2, 24, filled=5)
        assert list(got) == list(want), arch
        for k in got:
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_prefill_then_decode_match(pair):
    name, jcfg, tcfg, jm, tm, jp, tp = pair
    B, S, steps = 2, 40, 4
    rng = np.random.default_rng(3)
    toks = rng.integers(2, tcfg.vocab_size, (B, S + steps)).astype(np.int32)
    extra = _patches(tcfg, B, 9)
    P = tcfg.num_patches if extra else 0
    cap = P + S + steps
    jl, jcache = jm.prefill(
        jp, {"tokens": jnp.asarray(toks[:, :S]),
             **{k: jnp.asarray(v) for k, v in extra.items()}}, capacity=cap)
    with torch.no_grad():
        tl, tcache = tm.prefill(
            tp, {"tokens": _t(toks[:, :S]),
                 **{k: _t(v) for k, v in extra.items()}}, capacity=cap)
    _close(tl, jl, 1e-4)
    assert tcache["k"].shape == jcache["k"].shape
    for f in ("k", "v"):
        _close(tcache[f], jcache[f], 1e-4)
    np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))
    if "swa" in name:
        assert tcache["k"].shape[2] == 16  # the rolling buffer
    for i in range(steps):
        t = np.full((B,), P + S + i, np.int32)
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
    batch = {"tokens": toks, "labels": labels, **_patches(tcfg, 2, 10)}
    jl, jmet = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        tl, tmet = tm.loss(tp, {k: _t(v) for k, v in batch.items()})
    _close(tl, jl, 1e-5)
    _close(tmet["ce"], jmet["ce"], 1e-5)
    _close(tmet["aux"], jmet["aux"], 1e-5)
    if tcfg.moe is not None:  # the aux term is real and in the total
        assert float(tmet["aux"]) > 0
        _close(tl, tmet["ce"] + tcfg.moe.router_aux_coef * tmet["aux"], 1e-6)
    else:
        assert float(tmet["aux"]) == 0.0 and float(tl) == float(tmet["ce"])


# arch -> (a weight left in float32, a weight cast to the compute dtype)
KEPT_AND_CAST = {"qwen2-moe-a2.7b": ("mlp_norm", "wq"),
                 "internvl2-26b": ("patch_norm", "wq"),
                 "zamba2-1.2b": ("m/A_log", "s_wq"),
                 "rwkv6-1.6b": ("dec_w2", "wr")}


@pytest.mark.parametrize("arch", list(KEPT_AND_CAST))
def test_init_compute_is_compute_params_of_init(arch):
    """Drawn straight into the compute dtype, the weights are the bits
    that ``init`` then ``compute_params`` give, the family's float32
    weights (norms; the recurrent families' decay and step parameters)
    left in float32."""
    cfg = get_reduced(arch).with_(compute_dtype="bfloat16")
    model = build_model(cfg)
    want = model.compute_params(model.init(torch.Generator().manual_seed(3)))
    got = model.init_compute(torch.Generator().manual_seed(3))
    assert list(got) == list(want)
    for n in want:
        assert got[n].dtype == want[n].dtype and torch.equal(got[n], want[n]), n
    kept, cast = KEPT_AND_CAST[arch]
    assert got[kept].dtype == torch.float32
    assert got[cast].dtype == torch.bfloat16


def test_vlm_batch_specs_and_inputs_are_the_references():
    for arch in ("internvl2-26b", "qwen2-moe-a2.7b"):
        cfg, jcfg = get_reduced(arch), j_get_reduced(arch)
        for kind in ("train", "prefill", "decode"):
            shape = ShapeSpec("t", kind, 24, 3)
            jshape = JShapeSpec("t", kind, 24, 3)
            specs = tmodel.batch_specs(cfg, shape)
            jspecs = jmodel.batch_specs(jcfg, jshape)
            assert list(specs) == list(jspecs)
            for k in specs:
                assert specs[k].shape == jspecs[k].shape, (arch, kind, k)
                assert str(specs[k].dtype).split(".")[-1] == \
                    str(jspecs[k].dtype), (arch, kind, k)
            got = make_inputs(cfg, shape, seed=6, device="cpu")
            want = j_make_inputs(jcfg, jshape, seed=6)
            assert list(got) == list(want)
            for k in got:
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]))
    specs = tmodel.batch_specs(get_reduced("internvl2-26b"),
                               ShapeSpec("t", "train", 24, 3))
    assert specs["patches"].shape == (3, 8, 64) and specs["tokens"].shape == (3, 16)


def test_active_params_flops_and_serve_state_are_the_references():
    """``repro``'s formulas over all ten configurations and every shape;
    the serve state of the families the port runs."""
    from repro.configs import get_config as j_get_config
    from repro.configs.base import LM_SHAPES as J_SHAPES

    for arch in ARCH_NAMES:
        cfg, jcfg = get_config(arch), j_get_config(arch)
        assert tmodel.active_param_count(cfg) == \
            jmodel.active_param_count(jcfg), arch
        for shape, jshape in zip(LM_SHAPES, J_SHAPES):
            assert tmodel.model_flops_per_step(cfg, shape) == \
                jmodel.model_flops_per_step(jcfg, jshape), (arch, shape.name)
            if shape.kind == "decode":
                cache, t = tmodel.serve_state_specs(cfg, shape)
                jcache, jt = jmodel.serve_state_specs(jcfg, jshape)
                assert {k: (v.shape, str(v.dtype).split(".")[-1])
                        for k, v in cache.items()} == \
                    {k: (v.shape, str(v.dtype)) for k, v in jcache.items()}
                assert t.shape == jt.shape and t.dtype == torch.int32
    cfg = get_config("qwen2-moe-a2.7b")
    assert tc.count_params(build_model(cfg).param_table()) == 16_807_200_768
    assert tmodel.active_param_count(cfg) == 5_180_590_080
    # the recurrent families at full width and depth fit one card whole
    for arch, n in (("zamba2-1.2b", 1_170_138_240),
                    ("rwkv6-1.6b", 1_599_770_624)):
        table = build_model(get_config(arch)).param_table()
        assert tc.count_params(table) == tmodel.active_param_count(
            get_config(arch)) == n, arch


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
