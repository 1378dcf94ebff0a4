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

Under a sharding context whose mesh spans the batch (``act_batch``'s mesh
axes, resolved for the microbatch's rows as ``repro``'s GSPMD would shard
them), every rank takes its contiguous row shard of each microbatch (the
layout ``P(("pod", "data"))`` gives), computes its gradients, and the
float32 gradients, the loss and the metrics are averaged over those ranks
(an all-reduce per mesh axis) before ``grad_transform`` and the update: the
batch-sharded step of ``repro``, within float32 reduction order.  The
model then runs under the context without those axes in ``act_batch``
(``_local_ctx``): each rank's rows are one data-parallel shard.  Off a
mesh the step is the single-process one, bit for bit.

A batch of DTensors (the dry run, ``launch.cells``) is global and placed
already: DTensor shards the step, as GSPMD shards ``repro``'s, so the step
splits nothing itself and each microbatch keeps the batch's placements.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed.sharding import (
    NULL_CTX, ShardingCtx, mesh_shape, resolve_axes,
)
from repro_torch.models.common import acc_dtype
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
    parameters as ``model.param_specs()`` gives them, float32 ``m`` / ``v``
    and an int32 ``step``, as ``repro``'s."""
    p = model.param_specs()
    f32 = {n: TensorSpec(s.shape, torch.float32) for n, s in p.items()}
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


def batch_axes(ctx: ShardingCtx, rows: int) -> Tuple[str, ...]:
    """The mesh axes a batch of ``rows`` rows is sharded over under
    ``ctx`` (none off a mesh, or where the rows do not divide)."""
    if ctx.mesh is None or ctx.profile is None:
        return ()
    entry = resolve_axes(ctx.mesh, ("act_batch",), (rows,), ctx.profile)[0]
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _shard_rows(batch, mesh, axes, M: int):
    """This rank's rows: its contiguous 1/D of each of the M microbatches,
    D the product of ``axes``' sizes and the rank's index its row-major
    coordinate over them."""
    sizes = mesh_shape(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    d, D = 0, 1
    for a in axes:
        d, D = d * sizes[a] + coord[a], D * sizes[a]
    rows = next(iter(batch.values())).shape[0]
    size = rows // M
    part = size // D
    keep = [i * size + d * part + j for i in range(M) for j in range(part)]
    idx = torch.as_tensor(keep, device=next(iter(batch.values())).device)
    return {k: v.index_select(0, idx) for k, v in batch.items()}


def _microbatches(batch, M: int):
    """The M microbatches: contiguous row slices (``repro``'s reshape to
    (M, B/M, ...)).  A DTensor leaf is gathered once and each microbatch
    takes the batch's placements (a shard of its rows on the batch axes)."""
    size = next(iter(batch.values())).shape[0] // M
    if not isinstance(next(iter(batch.values())), DTensor):
        return [{k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                for i in range(M)]
    split = {}
    for k, v in batch.items():
        mesh = v.device_mesh
        full = v.redistribute(mesh, [Replicate()] * mesh.ndim)
        full = full.reshape(M, size, *v.shape[1:])
        split[k] = full.redistribute(mesh, [
            Shard(p.dim + 1) if isinstance(p, Shard) else p
            for p in v.placements])
    return [{k: v[i] for k, v in split.items()} for i in range(M)]


def _local_ctx(ctx: ShardingCtx, axes) -> ShardingCtx:
    """The context a rank's model runs under once the step has split the
    batch over ``axes``: ``act_batch`` without them, so the rank's rows
    count as one data-parallel shard (the MoE dropping dispatch groups
    tokens by the shards left to split).  Its fallbacks go to ``ctx``'s
    list."""
    rule = ctx.profile.rules.get("act_batch")
    rule = (rule,) if isinstance(rule, str) else tuple(rule)
    rest = tuple(a for a in rule if a not in axes)
    local = ShardingCtx(ctx.mesh, ctx.profile.override(act_batch=rest or None))
    local.fallbacks = ctx.fallbacks
    return local


def _mean_over(mesh, axes, tensors: Dict[str, torch.Tensor]):
    """Each tensor's mean over the ranks of ``axes``: one all-reduce per
    axis on a copy (a loss and its metrics may share storage), in name
    order, then divided by the rank count."""
    D = 1
    for a in axes:
        D *= mesh_shape(mesh)[a]
    out = {}
    for n in sorted(tensors):
        t = tensors[n].clone()
        for a in axes:
            dist.all_reduce(t, group=mesh.get_group(a))
        out[n] = t / D
    return out


def make_train_step(model, optim: Optimizer, *, num_microbatches: int = 1,
                    ctx: ShardingCtx = NULL_CTX,
                    grad_transform: Optional[Callable] = None):
    """``train_step(state, batch) -> (state, metrics)``; the metrics
    (``loss``, ``grad_norm`` and the model's own) are float32 scalars on
    the parameters' device.  ``ctx`` is passed to ``model.loss``; where its
    mesh spans the batch the step is data-parallel (module docstring).
    ``grad_transform(grads) -> grads`` runs between the gradients and the
    update."""
    M = num_microbatches

    def grads_of(params, batch, ctx):
        leaves = {n: p.detach().requires_grad_(True)
                  for n, p in params.items()}
        loss, metrics = model.loss(leaves, batch, ctx)
        gs = torch.autograd.grad(loss, list(leaves.values()),
                                 allow_unused=True)
        grads = {n: torch.zeros_like(p, dtype=acc_dtype(p.dtype)) if g is None
                 else g.to(acc_dtype(g.dtype))
                 for (n, p), g in zip(leaves.items(), gs)}
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, grads

    def compute_grads(params, batch, ctx):
        if M == 1:
            return grads_of(params, batch, ctx)
        rows = next(iter(batch.values())).shape[0]
        if rows % M:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{M} microbatches")
        loss = torch.zeros((), dtype=torch.float32,
                           device=next(iter(params.values())).device)
        grads = None
        for mb in _microbatches(batch, M):
            loss_i, _, g = grads_of(params, mb, ctx)
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
        first = next(iter(batch.values()))
        rows = first.shape[0]
        axes = (batch_axes(ctx, rows // M)
                if rows % M == 0 and not isinstance(first, DTensor) else ())
        if axes:
            batch = _shard_rows(batch, ctx.mesh, axes, M)
        loss, metrics, grads = compute_grads(
            params, batch, _local_ctx(ctx, axes) if axes else ctx)
        if axes:
            loss = _mean_over(ctx.mesh, axes, {"": loss})[""]
            metrics = _mean_over(ctx.mesh, axes, metrics)
            grads = _mean_over(ctx.mesh, axes, grads)
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
