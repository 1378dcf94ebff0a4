"""LM stack precision: the port's bf16 compute against ``repro``'s (the
dense, MoE, hybrid and RWKV families), the weights each family keeps in
float32, the one-time bf16 weight copy against a cast at every use, and
the float32 prefill/decode gap of a random gemma-2b, on the CPU.

``repro`` draws the weights (``jax.random``); ``convert.lm_params_from_numpy``
carries them across.  Tolerances are stated in each test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.models import moe as jmoe
from repro.models.model import build_model as j_build_model

from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import moe as tmoe
from repro_torch.models.model import build_model

from test_torch_search import one_torch_thread  # noqa: F401  (autouse)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.asarray(a).dtype))


def _decode_chain(prefill, decode, toks, S, steps):
    """Prefill logits and cache of ``toks[:, :S]``, then ``steps`` decodes:
    the list of logits and the last cache."""
    B = toks.shape[0]
    logits, cache = prefill(toks[:, :S], S + steps)
    out = [logits]
    for i in range(steps):
        logits, cache = decode(toks[:, S + i:S + i + 1],
                               np.full((B,), S + i, np.int32), cache)
        out.append(logits)
    return out, cache


def _mean_rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).mean() / np.abs(want).mean())


def _record_router_picks(monkeypatch):
    """Record each router call's expert ids, in both packages, and in
    ``repro`` the margin between the k-th and the (k+1)-th probability
    relative to the k-th (from inside its scanned, fused layers, through
    an ordered debug callback).  Returns (repro's [(ids, margin)], the
    port's [ids])."""
    jrec, trec = [], []
    j_router, t_router = jmoe._router, tmoe._router

    def j_wrapped(x, w, moe):
        top_w, ids, aux = j_router(x, w, moe)
        logits = jnp.einsum("bsd,de->bse", x, w.astype(x.dtype))
        probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
        v, _ = jax.lax.top_k(probs, moe.experts_per_token + 1)
        margin = (v[..., -2] - v[..., -1]) / v[..., -2]
        jax.debug.callback(
            lambda i, m: jrec.append((np.asarray(i), np.asarray(m))),
            ids, margin, ordered=True)
        return top_w, ids, aux

    def t_wrapped(x, w, moe):
        out = t_router(x, w, moe)
        trec.append(out[1].numpy())
        return out

    monkeypatch.setattr(jmoe, "_router", j_wrapped)
    monkeypatch.setattr(tmoe, "_router", t_wrapped)
    return jrec, trec


@pytest.mark.parametrize("arch", ["gemma-2b", "llama3-8b", "qwen2-moe-a2.7b"])
def test_prefill_then_decode_match_bfloat16(arch, monkeypatch):
    """bf16 compute (what the engine serves) against ``repro``'s on the
    same weights: prefill logits and cache, then 4 decode steps.  The two
    round bf16 in different places (XLA keeps excess precision inside its
    fusions), so each step is held to a mean relative error of 3e-2; it
    reads up to 2.1e-2 here.  A decode attention whose scores round to
    bf16, or an unrounded gemma embedding scale, reads 5e-2 or more on
    some step.

    For the MoE model the same rounding can flip a router pick where the
    top-k margin is below bf16's: here 1 of the 80 second-layer prefill
    picks differs, at a relative margin (k-th minus (k+1)-th probability,
    over the k-th) of 7.78e-3, just under 2^-7 = 7.81e-3, and its steps
    read a mean relative error of at most 1.8e-2.  So every pick
    whose margin in ``repro`` exceeds 2^-7 must be the same set of
    experts, and the logits are held to the same 3e-2."""
    B, S, steps = 2, 40, 4
    picks = (_record_router_picks(monkeypatch)
             if get_reduced(arch).moe is not None else None)
    jcfg = j_get_reduced(arch).with_(remat=False, compute_dtype="bfloat16")
    tcfg = get_reduced(arch).with_(compute_dtype="bfloat16")
    jm, tm = j_build_model(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    tp = tm.compute_params(lm_params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jp), device="cpu"))
    toks = np.random.default_rng(3).integers(
        2, tcfg.vocab_size, (B, S + steps)).astype(np.int32)
    want, jcache = _decode_chain(
        lambda t, cap: jm.prefill(jp, {"tokens": jnp.asarray(t)},
                                  capacity=cap),
        lambda t, pos, c: jm.decode(jp, jnp.asarray(t), c, jnp.asarray(pos)),
        toks, S, steps)
    with torch.no_grad():
        got, tcache = _decode_chain(
            lambda t, cap: tm.prefill(tp, {"tokens": _t(t)}, capacity=cap),
            lambda t, pos, c: tm.decode(tp, _t(t), c, _t(pos)),
            toks, S, steps)
    assert got[0].dtype == torch.bfloat16
    for i, (g, w) in enumerate(zip(got, want)):
        assert _mean_rel(g.float(), w) <= 3e-2, (arch, i)
    for f in ("k", "v"):
        assert tcache[f].dtype == torch.bfloat16
        assert _mean_rel(tcache[f].float(), jcache[f]) <= 3e-2, (arch, f)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    if picks is not None:
        jax.effects_barrier()
        jrec, trec = picks
        # prefill: one call a layer; then each decode step's
        assert len(jrec) == len(trec) == tcfg.num_layers * (1 + steps)
        for (jids, margin), tids in zip(jrec, trec):
            same = (np.sort(jids, -1) == np.sort(tids, -1)).all(-1)
            assert same[margin > 2.0 ** -7].all(), (arch, margin[~same])


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-1.6b"])
def test_recurrent_prefill_then_decode_match_bfloat16(arch):
    """bf16 compute of the recurrent families against ``repro``'s on the
    same weights: prefill logits and state, then 4 decode steps, each held
    to a mean relative error of 4e-2 against ``repro`` (rwkv6 reads up to
    1.0e-2, zamba2 2.8e-2), with every state entry in ``repro``'s dtype;
    and the port's logits no further from a float64 run of the same
    weights than 1.2 times ``repro``'s (zamba2: 4.2e-2 against 5.0e-2 at
    the worst step).  zamba2's shared ``s_wq`` / ``s_wk`` are scaled to std
    1/sqrt(d), as in ``test_torch_hybrid.py``: at ``repro``'s init (std
    0.5) its attention is almost one-hot and the two bf16 chains part by
    up to 0.5."""
    B, S, steps = 2, 40, 4
    jcfg = j_get_reduced(arch).with_(remat=False, compute_dtype="bfloat16")
    tcfg = get_reduced(arch).with_(compute_dtype="bfloat16")
    jm, tm = j_build_model(jcfg), build_model(tcfg)
    jp = dict(jm.init(jax.random.PRNGKey(1)))
    if tcfg.family == "hybrid":
        f = float(np.sqrt(tcfg.num_heads / tcfg.d_model))
        jp["s_wq"], jp["s_wk"] = jp["s_wq"] * f, jp["s_wk"] * f
    raw = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    m64 = build_model(tcfg.with_(compute_dtype="float64"))
    toks = np.random.default_rng(3).integers(
        2, tcfg.vocab_size, (B, S + steps)).astype(np.int32)
    want, jcache = _decode_chain(
        lambda t, cap: jm.prefill(jp, {"tokens": jnp.asarray(t)},
                                  capacity=cap),
        lambda t, pos, c: jm.decode(jp, jnp.asarray(t), c, jnp.asarray(pos)),
        toks, S, steps)
    with torch.no_grad():
        chains = [_decode_chain(
            lambda t, cap: m.prefill(p, {"tokens": _t(t)}, capacity=cap),
            lambda t, pos, c: m.decode(p, _t(t), c, _t(pos)),
            toks, S, steps) for m, p in ((tm, tm.compute_params(raw)),
                                         (m64, m64.compute_params(raw)))]
    (got, tcache), (exact, _) = chains
    assert got[0].dtype == torch.bfloat16
    for i, (g, w) in enumerate(zip(got, want)):
        assert _mean_rel(g.float(), w) <= 4e-2, (arch, i)
    assert set(tcache) == set(jcache)
    for f in tcache:
        assert str(tcache[f].dtype).split(".")[-1] == str(jcache[f].dtype), f
        if f != "pos":
            assert _mean_rel(tcache[f].float(), jcache[f]) <= 4e-2, (arch, f)
    port = max(_mean_rel(g.float(), e.float()) for g, e in zip(got, exact))
    ref = max(_mean_rel(np.asarray(w, np.float32), e.float())
              for w, e in zip(want, exact))
    assert port <= 1.2 * ref, (arch, port, ref)


@pytest.mark.parametrize("arch, keep", [
    ("gemma-2b", {"final_norm", "attn_norm", "mlp_norm"}),
    ("zamba2-1.2b", {"final_norm", "s_attn_norm", "s_mlp_norm", "m/m_norm",
                     "m/dt_bias", "m/A_log"}),
    ("rwkv6-1.6b", {"ln0", "ln1", "ln2", "final_norm", "decay_base",
                    "dec_w1", "dec_w2", "u", "ln_x_scale", "ln_x_bias"}),
])
def test_compute_params_keep_what_repro_reads_in_float32(arch, keep):
    """In a bf16 model, ``compute_params`` leaves exactly the weights that
    ``repro`` reads in float32 as they are (the norms; Mamba's step bias
    and decay rate; RWKV's decay, its LoRA, the bonus ``u`` and ln_x):
    cast to bf16 and back they would carry bits ``repro``'s bf16 path
    never sees.  Every other weight is bf16."""
    cfg = get_reduced(arch).with_(compute_dtype="bfloat16")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    cp = model.compute_params(params)
    assert keep <= set(cp)
    for n, p in cp.items():
        if n in keep:
            assert p is params[n] and p.dtype == torch.float32, n
        else:
            assert p.dtype == torch.bfloat16, n


def test_one_time_bf16_copy_is_a_cast_at_every_use():
    """The engine's weights, cast to bf16 once, give the bits that the
    float32 weights give when every use casts them (``repro``'s rule)."""
    from repro_torch.serve.engine import ServeEngine

    cfg = get_reduced("gemma-2b").with_(compute_dtype="bfloat16")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    engine = ServeEngine(cfg, params, device="cpu")
    for n, p in engine.compute_params.items():
        want = p if n.endswith("norm") else params[n].to(torch.bfloat16)
        assert torch.equal(p, want) and p.dtype == want.dtype, n
    toks = np.random.default_rng(5).integers(
        2, cfg.vocab_size, (2, 24)).astype(np.int32)
    with torch.no_grad():
        chains = [_decode_chain(
            lambda t, cap: model.prefill(p, {"tokens": _t(t)}, capacity=cap),
            lambda t, pos, c: model.decode(p, _t(t), c, _t(pos)),
            toks, 20, 4) for p in (params, engine.compute_params)]
    (every_use, c1), (once, c2) = chains
    for a, b in zip(every_use, once):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert all(torch.equal(c1[f], c2[f]) for f in ("k", "v", "pos"))


def test_float32_prefill_decode_gap_is_the_references():
    """End to end, float32 prefill(S + 1) and prefill(S) + decode disagree
    in ``repro`` itself on a random gemma-2b: its init (fan-in
    ``shape[-2]``, so ``wq``'s std is 1/sqrt(H)) makes attention almost
    one-hot, and a sum in another order can pick another key.  At
    gemma-2b's layout narrowed to d 512, d_ff 2048 and vocab 512 (18
    layers, 8 heads of 256, one KV head), ``repro``'s gap reads 1.8
    relative; the port's, in float64 on the same weights, 4.7e-12.  So a
    float32 gap is the model's, and the float64 one is what holds the
    port's decode to its prefill (as ``chip_smoke.py`` does at full
    width)."""
    kw = dict(d_model=512, d_ff=2048, vocab_size=512, param_dtype="float32",
              compute_dtype="float32")
    jcfg = j_get_config("gemma-2b").with_(remat=False, **kw)
    tcfg = get_config("gemma-2b").with_(**{**kw, "compute_dtype": "float64"})
    assert (tcfg.num_layers, tcfg.num_heads, tcfg.num_kv_heads,
            tcfg.head_dim) == (18, 8, 1, 256)
    B, S = 2, 64
    jm, tm = j_build_model(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(
        2, tcfg.vocab_size, (B, S + 1)).astype(np.int32)
    t = np.full((B,), S, np.int32)

    full, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    _, cache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S])},
                          capacity=S + 1)
    step, _ = jm.decode(jp, jnp.asarray(toks[:, S:]), cache, jnp.asarray(t))
    full, step = np.asarray(full), np.asarray(step)
    assert np.isfinite(full).all() and np.isfinite(step).all()
    assert np.abs(step - full).max() / np.abs(full).max() > 0.1

    tp = tm.compute_params(lm_params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jp), device="cpu"))
    assert tp["wq"].dtype == torch.float64
    with torch.no_grad():
        full, _ = tm.prefill(tp, {"tokens": _t(toks)})
        _, cache = tm.prefill(tp, {"tokens": _t(toks[:, :S])}, capacity=S + 1)
        step, _ = tm.decode(tp, _t(toks[:, S:]), cache, _t(t))
    assert full.dtype == torch.float64
    assert float((step - full).abs().max() / full.abs().max()) < 1e-9
