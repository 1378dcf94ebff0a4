"""Training parity: ``repro_torch.train`` (the train step, microbatching,
remat, compression, ``instrument_step``) against ``repro.train``, on the
CPU.

Every family's loss gradients come from the port's own train step
(``make_train_step``'s ``grad_transform`` hook sees them) and are held
against ``jax.grad`` of ``repro``'s loss on the same weights and batch,
leaf by leaf.  The models are the reduced configs (float32) with
``repro``'s weights, its zero- and one-initialised ones moved off their
init (``test_torch_rwkv.lm_pair``), and every softmax attention's query
and key weights (``wq`` / ``wk``; zamba2's ``s_wq`` / ``s_wk``; the
enc-dec's self- and cross-attention ones) scaled to std 1/sqrt(d), as the
hybrid and enc-dec parity tests do.  At ``repro``'s init (std 1/sqrt(H))
the attention is almost one-hot and amplifies float32 rounding (ROADMAP
C): reduced gemma-2b's worst leaves then read 6e-4 (``repro``) and 8e-4
(the port) from a float64 run of the port, and 8e-4 from each other.  The
batch is ``make_inputs`` at (2, 32) in both packages.

Tolerances: each gradient leaf within ``GRAD_TOL`` (2e-5) of ``repro``'s,
as ‖g_port − g_ref‖ / ‖g_ref‖ (float32 sums in another order; the worst
leaves read 1.0e-6–6.3e-6, each package as far from a float64 run as
from the other); the loss within 1e-6 relative; one ``sgd`` step's
parameters within 1e-5 of ``repro``'s (the step is linear in the
gradient, lr 0.1); one ``adamw`` step's ``loss`` and ``grad_norm`` within 1e-5
(Adam's first update is near ``lr · sign(g)``, which flips where a
gradient is near zero, so its parameters are not held); microbatching and
the 100-step descent to ``repro``'s own test tolerances; remat on against
off bit-equal; the compression functions bit-equal to ``repro``'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeSpec as JShapeSpec
from repro.models.model import make_inputs as j_make_inputs
from repro.train import compress as jcomp
from repro.train import loop as jloop
from repro.train import optim as jopt

from repro_torch import obs
from repro_torch.configs import get_reduced
from repro_torch.configs.base import ShapeSpec
from repro_torch.convert import train_state_from_numpy
from repro_torch.models.model import build_model, make_inputs
from repro_torch.train import compress as tcomp
from repro_torch.train import loop as tloop
from repro_torch.train import optim as topt

from test_torch_encdec import encdec_pair
from test_torch_rwkv import lm_pair
from test_torch_search import one_torch_thread  # noqa: F401  (autouse)

ARCHS = ("gemma-2b", "qwen2-moe-a2.7b", "internvl2-26b", "zamba2-1.2b",
         "rwkv6-1.6b", "seamless-m4t-medium")
GRAD_TOL = 2e-5
SHAPE = (32, 2)  # seq, batch


def family_pair(arch: str):
    """(``repro`` model, port model, ``repro`` params (jnp), port params)."""
    if arch == "seamless-m4t-medium":
        return encdec_pair()
    cfg = get_reduced(arch)
    f = float(np.sqrt(cfg.num_heads / cfg.d_model))
    names = {"zamba2-1.2b": ("s_wq", "s_wk"), "rwkv6-1.6b": ()}.get(
        arch, ("wq", "wk"))
    return lm_pair(arch, seed=1, scale={n: f for n in names})


def batches(cfg, seed: int = 0, seq: int = SHAPE[0], batch: int = SHAPE[1]):
    """The same train batch for both packages (``make_inputs``)."""
    j = j_make_inputs(cfg, JShapeSpec("t", "train", seq, batch), seed=seed)
    t = make_inputs(cfg, ShapeSpec("t", "train", seq, batch), seed=seed,
                    device="cpu")
    return j, t


def capture():
    """A ``grad_transform`` that keeps the gradients it is given."""
    seen = {}

    def fn(grads):
        seen.update(grads)
        return grads

    return seen, fn


def _close_step(got, want, name):
    """One ``sgd`` step's parameters within 1e-5 of ``repro``'s."""
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5, err_msg=name)


def _leaf_rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    arch = request.param
    jm, tm, jp, tp = family_pair(arch)
    jb, tb = batches(tm.cfg)
    return arch, jm, tm, jp, tp, jb, tb


def test_loss_gradients_match_jax_grad(fam):
    arch, jm, tm, jp, tp, jb, tb = fam
    (jl, _), jg = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, jb),
                                             has_aux=True))(jp)
    seen, fn = capture()
    step = tloop.make_train_step(tm, topt.sgd(lr=0.0), grad_transform=fn)
    _, m = step({"params": tp, "opt": topt.sgd().init(tp)}, tb)
    assert abs(float(m["loss"]) - float(jl)) <= 1e-6 * abs(float(jl))
    assert set(seen) == set(jg)
    worst = max(_leaf_rel(seen[n], jg[n]) for n in jg)
    assert worst <= GRAD_TOL, (arch, worst)


@pytest.mark.parametrize("arch", ["gemma-2b", "seamless-m4t-medium"])
def test_sgd_step_params_and_adamw_metrics_match(arch):
    jm, tm, jp, tp = family_pair(arch)
    jb, tb = batches(tm.cfg, seed=1)
    jsgd, tsgd = jopt.sgd(lr=0.1, momentum=0.9), topt.sgd(lr=0.1, momentum=0.9)
    js, _ = jax.jit(jloop.make_train_step(jm, jsgd))(
        {"params": jp, "opt": jsgd.init(jp)}, jb)
    ts, _ = tloop.make_train_step(tm, tsgd)(
        {"params": tp, "opt": tsgd.init(tp)}, tb)
    assert int(ts["opt"]["step"]) == int(js["opt"]["step"]) == 1
    for n in jp:
        _close_step(ts["params"][n], js["params"][n], n)
    jad, tad = jopt.adamw(lr=1e-3), topt.adamw(lr=1e-3)
    _, jmet = jax.jit(jloop.make_train_step(jm, jad))(
        {"params": jp, "opt": jad.init(jp)}, jb)
    _, tmet = tloop.make_train_step(tm, tad)(
        {"params": tp, "opt": tad.init(tp)}, tb)
    assert set(tmet) == set(jmet) == {"loss", "grad_norm", "ce", "aux"}
    for k in jmet:
        assert tmet[k].dtype == torch.float32
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_remat_is_bit_equal(fam):
    """``cfg.remat`` recomputes each layer body in the backward pass; on
    the CPU the gradients are the same bits as without it."""
    arch, jm, tm, jp, tp, jb, tb = fam
    grads = []
    for flag in (True, False):
        model = build_model(tm.cfg.with_(remat=flag))
        seen, fn = capture()
        tloop.make_train_step(model, topt.sgd(lr=0.0), grad_transform=fn)(
            {"params": tp, "opt": topt.sgd().init(tp)}, tb)
        grads.append(seen)
    assert tm.cfg.remat
    for n in grads[0]:
        assert torch.equal(grads[0][n], grads[1][n]), (arch, n)


def test_microbatch_equivalence():
    """``repro``'s ``test_microbatch_equivalence`` on the port: one step
    with 4 microbatches against one with 1, on the same global batch."""
    cfg = get_reduced("llama3-8b").with_(remat=False)
    model = build_model(cfg)
    opt = topt.adamw(lr=1e-3)
    batch = make_inputs(cfg, ShapeSpec("t", "train", 32, 8), device="cpu")
    s1 = tloop.make_train_state(model, opt, torch.Generator().manual_seed(0),
                                device="cpu")
    s4 = {"params": dict(s1["params"]), "opt": opt.init(s1["params"])}
    out1, m1 = tloop.make_train_step(model, opt, num_microbatches=1)(s1, batch)
    out4, m4 = tloop.make_train_step(model, opt, num_microbatches=4)(s4, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]), rtol=1e-4)
    assert float(m4["aux"]) == 0.0 and float(m4["ce"]) == float(m4["loss"])
    for k in out1["params"]:
        np.testing.assert_allclose(out1["params"][k].numpy(),
                                   out4["params"][k].numpy(),
                                   rtol=2e-3, atol=2e-5, err_msg=k)


def test_loss_decreases_100_steps():
    """``repro``'s ``test_loss_decreases_100_steps`` on the port (60 steps
    of ``adamw(1e-3)`` on one batch; the loss falls below 0.7× its
    first)."""
    cfg = get_reduced("gemma-2b")
    model = build_model(cfg)
    opt = topt.adamw(lr=1e-3)
    step = tloop.make_train_step(model, opt)
    state = tloop.make_train_state(model, opt, torch.Generator().manual_seed(0),
                                   device="cpu")
    batch = make_inputs(cfg, ShapeSpec("t", "train", 64, 4), device="cpu")
    first = last = None
    for i in range(60):
        state, m = step(state, batch)
        if i == 0:
            first = float(m["loss"])
        last = float(m["loss"])
    assert last < first * 0.7, (first, last)


def test_train_state_specs_and_carry_are_the_references():
    """``train_state_specs`` equals ``repro``'s; ``train_state_from_numpy``
    carries ``repro``'s state after a step across exactly, and the next
    ``sgd`` step from it matches ``repro``'s."""
    jm, tm, jp, tp = family_pair("gemma-2b")
    tspec = tloop.train_state_specs(tm, topt.adamw())
    jspec = jloop.train_state_specs(jm, jopt.adamw())

    def flat(tree, pre=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{pre}{k}/"))
            else:
                out[pre + k] = (tuple(v.shape), str(v.dtype).split(".")[-1])
        return out

    assert flat(tspec) == flat(jspec)
    jb, tb = batches(tm.cfg, seed=5)
    opt_j, opt_t = jopt.sgd(lr=0.1, momentum=0.9), topt.sgd(lr=0.1, momentum=0.9)
    jstep = jax.jit(jloop.make_train_step(jm, opt_j))
    js, _ = jstep({"params": jp, "opt": opt_j.init(jp)}, jb)
    host = jax.tree.map(np.asarray, js)
    ts = train_state_from_numpy(tm.cfg, host, device="cpu")
    assert ts["opt"]["step"].dtype == torch.int32 and int(ts["opt"]["step"]) == 1
    for n in jp:
        assert np.array_equal(ts["params"][n].numpy(), host["params"][n])
        assert np.array_equal(ts["opt"]["m"][n].numpy(), host["opt"]["m"][n])
    js2, _ = jstep(js, jb)
    ts2, _ = tloop.make_train_step(tm, opt_t)(ts, tb)
    assert int(ts2["opt"]["step"]) == 2
    for n in jp:
        _close_step(ts2["params"][n], js2["params"][n], n)
    with pytest.raises(ValueError, match="names differ"):
        train_state_from_numpy(tm.cfg, {"params": host["params"],
                                        "opt": {"m": {"x": np.zeros(1)}}},
                               device="cpu")


def test_make_train_state_keeps_the_step_with_the_params():
    model = build_model(get_reduced("seamless-m4t-medium"))
    opt = topt.adamw()
    st = tloop.make_train_state(model, opt, torch.Generator().manual_seed(0),
                                device="cpu")
    assert st["opt"]["step"].device == st["params"]["lm_head"].device
    want = model.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(st["params"][n], want[n]) for n in want)
    with pytest.raises(ValueError, match="microbatches"):
        tloop.make_train_step(model, opt, num_microbatches=3)(
            st, make_inputs(model.cfg, ShapeSpec("t", "train", 8, 2),
                            device="cpu"))


# ------------------------------------------------------------- compression
def test_quantize_matches_bit_for_bit():
    rng = np.random.default_rng(0)
    for g in (rng.standard_normal(1000).astype(np.float32),
              # exact halves of the scale (127 / 127 = 1): half to even
              np.array([127, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, 0], np.float32),
              np.zeros(5, np.float32)):
        jq, js = jcomp.quantize_int8(jnp.asarray(g))
        tq, ts = tcomp.quantize_int8(torch.from_numpy(g))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert np.float32(ts) == np.float32(js)
        np.testing.assert_array_equal(
            tcomp.dequantize_int8(tq, ts).numpy(),
            np.asarray(jcomp.dequantize_int8(jq, js)))
    tq, _ = tcomp.quantize_int8(torch.tensor([127, 0.5, 1.5, 2.5, -2.5]))
    assert tq.tolist() == [127, 0, 2, 2, -2]


def test_error_feedback_matches_bit_for_bit():
    rng = np.random.default_rng(1)
    je = jnp.zeros((64,), jnp.float32)
    te = torch.zeros(64)
    for _ in range(20):
        g = rng.standard_normal(64).astype(np.float32)
        jq, js, je = jcomp.ef_compress(jnp.asarray(g), je)
        tq, ts, te = tcomp.ef_compress(torch.from_numpy(g), te)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    params = {"a": torch.zeros((3, 4), dtype=torch.bfloat16)}
    e = tcomp.init_error_state(params)
    assert e["a"].shape == (3, 4) and e["a"].dtype == torch.float32


def test_train_instrument_step():
    """``tests/test_obs.py::test_train_instrument_step`` on the port."""
    def fake_step(state, batch):
        return state, {"loss": torch.tensor(1.5), "grad_norm": torch.tensor(0.3)}

    reg = obs.get_registry()
    reg.reset()
    step = tloop.instrument_step(fake_step)
    state, metrics = step({}, {})
    assert float(metrics["loss"]) == 1.5
    snap = reg.snapshot()
    assert snap["train.steps"]["value"] == 1
    assert snap["train.loss"]["value"] == 1.5
    assert abs(snap["train.grad_norm"]["value"] - 0.3) < 1e-7
    assert snap["train.step_seconds"]["count"] == 1
    reg.reset()


def test_float64_model_keeps_float64():
    """A float64 model's cross entropy and RoPE run in float64 (float32
    and bf16 models keep float32): each within 1e-14 of a float64 numpy
    reference, where float32 would read ~1e-8."""
    from repro_torch.models.common import apply_rope, cross_entropy, rope_freqs

    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 11)) * 3
    labels = rng.integers(0, 11, (2, 5))
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    m = logits.max(-1, keepdims=True)
    lse = np.log(np.exp(logits - m).sum(-1)) + m[..., 0]
    want = np.mean(lse - np.take_along_axis(logits, labels[..., None], -1)[..., 0])
    assert got.dtype == torch.float64 and abs(float(got) - want) <= 1e-14 * want
    x = rng.standard_normal((1, 3, 2, 8))
    pos = np.arange(3, dtype=np.int32)[None] * 977
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    freqs = 1.0 / 10000.0 ** (np.arange(0, 8, 2) / 8)
    ang = pos[..., None] * freqs
    cos, sin = np.cos(ang)[:, :, None], np.sin(ang)[:, :, None]
    x1, x2 = x[..., :4], x[..., 4:]
    want = np.concatenate([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    assert np.abs(got.numpy() - want).max() <= 1e-13
    assert rope_freqs(8, 10000.0).dtype == torch.float32
    assert cross_entropy(torch.from_numpy(logits).float(),
                         torch.from_numpy(labels)).dtype == torch.float32
