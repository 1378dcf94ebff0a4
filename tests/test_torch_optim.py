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
