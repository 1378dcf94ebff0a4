"""Optimizer parity: ``repro_torch.train.optim`` against
``repro.train.optim`` on the same parameters and gradients, on the CPU.

Tolerances: the learning-rate schedules within 1e-7 (float32 from an int32
step in both); ``sgd`` and the scheduled ``adamw`` within 1e-6 after 20
steps on a small parameter dict (float32 elementwise arithmetic in another
order of fusion).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optim as jopt

from repro_torch.train import optim as topt

from test_torch_search import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("lr,warmup,total", [(3e-4, 10, 100), (1.0, 0, 7),
                                             (0.05, 5, 5)])
def test_schedules_match(lr, warmup, total):
    js, ts = jopt.warmup_cosine(lr, warmup, total), topt.warmup_cosine(lr, warmup, total)
    jc, tc = jopt.constant_lr(lr), topt.constant_lr(lr)
    for step in sorted({0, 1, max(warmup - 1, 0), warmup, (warmup + total) // 2,
                        total, total + 3}):
        st = np.int32(step)
        got = ts(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(js(jnp.asarray(st))),
                                   rtol=1e-7, atol=1e-7)
        assert float(tc(torch.tensor(step))) == float(jc(jnp.asarray(st)))


def _problem(seed):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((6, 5)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32),
              "s": np.asarray(rng.standard_normal(()), np.float32)}
    grads = [{k: np.asarray(rng.standard_normal(v.shape) * 0.3, np.float32)
              for k, v in params.items()} for _ in range(20)]
    return params, grads


def _run(jo, to, params, grads):
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js, jn = jo.apply(jp, {k: jnp.asarray(v) for k, v in g.items()}, js)
        tp, ts, tn = to.apply(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                              ts)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6, atol=1e-6)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    assert int(ts["step"]) == int(js["step"]) == len(grads)
    return tp, ts, js


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches(momentum):
    params, grads = _problem(1)
    tp, ts, js = _run(jopt.sgd(lr=0.05, momentum=momentum),
                      topt.sgd(lr=0.05, momentum=momentum), params, grads)
    for k in params:
        np.testing.assert_allclose(ts["m"][k].numpy(), np.asarray(js["m"][k]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(lr=0.01, warmup=5, total_steps=20),
    dict(lr=0.01, warmup=3, total_steps=12, weight_decay=0.1, grad_clip=0.5),
    dict(lr=0.02, grad_clip=None),
])
def test_scheduled_adamw_matches(kw):
    params, grads = _problem(2)
    _, ts, js = _run(jopt.adamw(**kw), topt.adamw(**kw), params, grads)
    for k in params:
        for f in ("m", "v"):
            np.testing.assert_allclose(ts[f][k].numpy(), np.asarray(js[f][k]),
                                       rtol=1e-6, atol=1e-6)


def _adamw_step_before(params, grads, state, lr, b1=0.9, b2=0.95, eps=1e-8):
    """One step of the earlier arithmetic, which made ``step`` on the host
    and copied ``lr_t``, ``b1t`` and ``b2t`` to each leaf's device: the CPU
    bits the repaired ``adamw`` must keep (constant rate, no clip)."""
    step = state["step"] + 1
    stepf = step.to(torch.float32)
    b1t = 1 - torch.tensor(b1, dtype=torch.float32) ** stepf
    b2t = 1 - torch.tensor(b2, dtype=torch.float32) ** stepf
    lr_t = torch.full((), lr, dtype=torch.float32)
    out = {}
    for k, p in params.items():
        gf = grads[k].to(torch.float32)
        m2 = b1 * state["m"][k] + (1 - b1) * gf
        v2 = b2 * state["v"][k] + (1 - b2) * gf * gf
        delta = (m2 / b1t) / (torch.sqrt(v2 / b2t) + eps)
        out[k] = (p.to(torch.float32) - lr_t * delta).to(p.dtype)
    return out, {"m": None, "v": None, "step": step}


@pytest.mark.parametrize("make", [lambda: topt.adamw(lr=0.01, grad_clip=None),
                                  lambda: topt.sgd(lr=0.05, momentum=0.9)])
def test_step_counter_sits_with_the_params(make):
    """``init`` puts ``step`` on the parameters' device, and a step keeps
    every output there (shown on the meta device, which refuses nothing a
    card would copy); on the CPU the bits are the earlier ones."""
    opt = make()
    meta = {"w": torch.zeros((3, 2), device="meta"),
            "b": torch.zeros((2,), device="meta")}
    state = opt.init(meta)
    assert state["step"].device.type == "meta"
    assert state["step"].dtype == torch.int32
    p2, s2, gn = opt.apply(meta, {k: torch.ones_like(v) for k, v in meta.items()},
                           state)
    outs = [*p2.values(), s2["step"], gn, *s2["m"].values()]
    assert all(t.device.type == "meta" for t in outs)
    params, grads = _problem(3)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    st = opt.init(tp)
    assert st["step"].device.type == "cpu"
    if "v" not in st:
        return
    for g in grads[:5]:
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        want, _ = _adamw_step_before(tp, tg, st, lr=0.01)
        tp, st, _ = opt.apply(tp, tg, st)
        for k in tp:
            assert torch.equal(tp[k], want[k]), k
