"""Train step: microbatched gradient accumulation and the optimizer update
(counterpart of ``repro.train.loop``).

The state is ``{"params": ..., "opt": ...}``, plain dicts of tensors.
Gradients are ``torch.autograd.grad`` of the model's ``loss`` with respect
to the parameters as they are (float32), so every cast to the compute
dtype happens inside the step, at use, as ``repro`` casts; they are kept
in float32 (float64 for a float64 model).  ``num_microbatches > 1``
splits every batch leaf into that many row slices and accumulates the
gradients over them, scaled by ``1/M``: the activations then scale with
the microbatch, not the global batch.  A batch may be NumPy arrays; the
step moves it to the parameters' device.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.models.common import acc_dtype, torch_dtype
from repro_torch.models.transformer import TensorSpec
from repro_torch.obs import LATENCY_BUCKETS, get_registry, get_tracer
from repro_torch.train.optim import Optimizer


def make_train_state(model, optim: Optimizer, generator: torch.Generator,
                     device="cuda") -> Dict[str, Any]:
    """Parameters drawn from ``generator`` (on its device, then placed on
    ``device``) and the optimizer's state beside them."""
    params = {n: p.to(device) for n, p in model.init(generator).items()}
    return {"params": params, "opt": optim.init(params)}


def train_state_specs(model, optim: Optimizer) -> Dict[str, Any]:
    """``TensorSpec``s of the train state, allocating nothing: the
    parameters in ``param_dtype``, float32 ``m`` / ``v`` and an int32
    ``step``, as ``repro``'s."""
    dt = torch_dtype(model.cfg.param_dtype)
    table = model.param_table()
    p = {n: TensorSpec(s.shape, torch_dtype(s.dtype or dt))
         for n, s in table.items()}
    f32 = {n: TensorSpec(s.shape, torch.float32) for n, s in table.items()}
    return {"params": p,
            "opt": {"m": f32, "v": dict(f32),
                    "step": TensorSpec((), torch.int32)}}


def train_state_structure(model, optim: Optimizer) -> Dict[str, Any]:
    """The train state's tree with meta tensors for leaves: its exact
    nesting and names, allocating nothing (a checkpoint restore rebuilds
    names that hold "/" from it)."""
    params = {n: torch.empty(s.shape, device="meta")
              for n, s in sorted(model.param_table().items())}
    return {"params": params, "opt": optim.init(params)}


def _to_device(batch, device):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_train_step(model, optim: Optimizer, *, num_microbatches: int = 1,
                    grad_transform: Optional[Callable] = None):
    """``train_step(state, batch) -> (state, metrics)``; the metrics
    (``loss``, ``grad_norm`` and the model's own) are float32 scalars on
    the parameters' device.  ``grad_transform(grads) -> grads`` runs
    between the gradients and the update."""
    M = num_microbatches

    def grads_of(params, batch):
        leaves = {n: p.detach().requires_grad_(True)
                  for n, p in params.items()}
        loss, metrics = model.loss(leaves, batch)
        gs = torch.autograd.grad(loss, list(leaves.values()),
                                 allow_unused=True)
        grads = {n: torch.zeros_like(p, dtype=acc_dtype(p.dtype)) if g is None
                 else g.to(acc_dtype(g.dtype))
                 for (n, p), g in zip(leaves.items(), gs)}
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, grads

    def compute_grads(params, batch):
        if M == 1:
            return grads_of(params, batch)
        rows = next(iter(batch.values())).shape[0]
        if rows % M:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{M} microbatches")
        size = rows // M
        loss = torch.zeros((), dtype=torch.float32,
                           device=next(iter(params.values())).device)
        grads = None
        for i in range(M):
            mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            loss_i, _, g = grads_of(params, mb)
            loss = loss + loss_i
            if grads is None:
                grads = g
            else:
                for n in grads:
                    grads[n] += g[n]
            del g
        inv = 1.0 / M
        grads = {n: g * inv for n, g in grads.items()}
        loss = loss * inv
        return loss, {"ce": loss, "aux": torch.zeros_like(loss)}, grads

    def train_step(state, batch):
        params = state["params"]
        batch = _to_device(batch, next(iter(params.values())).device)
        loss, metrics, grads = compute_grads(params, batch)
        if grad_transform is not None:
            grads = grad_transform(grads)
        with torch.no_grad():
            new_params, new_opt, gnorm = optim.apply(params, grads,
                                                     state["opt"])
        del grads
        out = {"loss": loss.to(torch.float32),
               "grad_norm": gnorm.to(torch.float32),
               **{k: v.to(torch.float32) for k, v in metrics.items()}}
        return {"params": new_params, "opt": new_opt}, out

    return train_step


def _sync(metrics) -> None:
    """Wait for the device the metrics live on (nothing on the CPU)."""
    for v in metrics.values():
        if isinstance(v, torch.Tensor) and v.is_cuda:
            torch.cuda.synchronize(v.device)
            return


def instrument_step(step_fn, *, name: str = "train.step"):
    """Wrap a train step with a host-side span and registry metrics (the
    ``train.step_seconds`` histogram, the ``train.steps`` counter, the
    ``train.loss`` / ``train.grad_norm`` gauges).

    The timing waits for the card before it stops the clock, where
    ``repro`` calls ``jax.block_until_ready``, so the duration is the
    device step, not its dispatch.  With the tracer and the registry both
    disabled the wrapper adds one branch a step.
    """
    tracer = get_tracer()

    def wrapped(state, batch):
        reg = get_registry()
        if not (tracer.enabled or reg.enabled):
            return step_fn(state, batch)
        t0 = time.perf_counter()
        ts = tracer._now_us() if tracer.enabled else 0.0
        state, metrics = step_fn(state, batch)
        _sync(metrics)
        dt = time.perf_counter() - t0
        if tracer.enabled:
            tracer.complete_event(name, ts, dt * 1e6)
        if reg.enabled:
            reg.counter("train.steps", "optimizer steps").inc()
            reg.histogram("train.step_seconds", "train step latency",
                          LATENCY_BUCKETS).observe(dt)
            if "loss" in metrics:
                reg.gauge("train.loss", "last step loss").set(
                    float(metrics["loss"]))
            if "grad_norm" in metrics:
                reg.gauge("train.grad_norm", "last step grad norm").set(
                    float(metrics["grad_norm"]))
        return state, metrics

    return wrapped
