"""Optimizers with ``repro.train.optim``'s functional API and arithmetic.

    opt = adamw(lr=3e-4, warmup=100, total_steps=10_000)
    state = opt.init(params)                 # params: dict of tensors
    params, state, gnorm = opt.apply(params, grads, state)

Their own implementation rather than ``torch.optim``, so one step computes
what ``repro``'s does (bias corrections and the learning-rate schedule in
float32 from an int32 step).  The step counter lives with the parameters,
so a step on the card makes no host-to-device copy.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

Params = Dict[str, torch.Tensor]


def global_norm(tree: Params) -> torch.Tensor:
    """The leaves' squares summed in sorted name order (``jax.tree``'s
    leaf order), so the bits do not depend on the dict's order."""
    return torch.sqrt(
        sum(torch.sum(torch.square(tree[k].to(torch.float32)))
            for k in sorted(tree))
    )


def clip_by_global_norm(tree: Params, max_norm: float):
    g = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp_min(g, 1e-9), max=1.0)
    return {k: (x * scale).to(x.dtype) for k, x in tree.items()}, g


def warmup_cosine(lr: float, warmup: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warmup to ``lr``, then cosine decay to ``final_frac * lr`` at
    ``total_steps``; ``schedule(step)`` takes an int32 step tensor and
    returns a float32 scalar tensor."""
    def schedule(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = lr * torch.clamp(step / max(warmup, 1), max=1.0)
        prog = torch.clamp(
            (step - warmup) / max(total_steps - warmup, 1), 0.0, 1.0
        )
        cos = lr * (final_frac + (1 - final_frac) * 0.5
                    * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)

    return schedule


def constant_lr(lr: float):
    """``schedule(step)``: ``lr`` as a float32 scalar on the step's
    device."""
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def _step0(params: Params) -> torch.Tensor:
    """An int32 zero on the parameters' device."""
    dev = next(iter(params.values())).device if params else None
    return torch.zeros((), dtype=torch.int32, device=dev)


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    apply: Callable  # (params, grads, state) -> (params, state, gnorm)


def adamw(
    lr: float = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    grad_clip: Optional[float] = 1.0,
    warmup: int = 0,
    total_steps: int = 0,
) -> Optimizer:
    """``warmup_cosine(lr, warmup, total_steps)`` when ``total_steps`` is
    set, else the constant rate."""
    sched = (
        warmup_cosine(lr, warmup, total_steps) if total_steps else constant_lr(lr)
    )

    def init(params: Params):
        return {
            "m": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
            "v": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
            "step": _step0(params),
        }

    def apply(params: Params, grads: Params, state):
        if grad_clip is not None:
            grads, gnorm = clip_by_global_norm(grads, grad_clip)
        else:
            gnorm = global_norm(grads)
        step = state["step"] + 1
        stepf = step.to(torch.float32)
        lr_t = sched(step)
        b1t = 1 - torch.full_like(stepf, b1) ** stepf
        b2t = 1 - torch.full_like(stepf, b2) ** stepf
        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            gf = grads[k].to(torch.float32)
            m2 = b1 * state["m"][k] + (1 - b1) * gf
            v2 = b2 * state["v"][k] + (1 - b2) * gf * gf
            mhat = m2 / b1t
            vhat = v2 / b2t
            delta = mhat / (torch.sqrt(vhat) + eps)
            if weight_decay:
                delta = delta + weight_decay * p.to(torch.float32)
            new_p[k] = (p.to(torch.float32) - lr_t * delta).to(p.dtype)
            new_m[k], new_v[k] = m2, v2
        return new_p, {"m": new_m, "v": new_v, "step": step}, gnorm

    return Optimizer(init=init, apply=apply)


def sgd(lr: float = 1e-2, momentum: float = 0.0) -> Optimizer:
    def init(params: Params):
        return {
            "m": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
            "step": _step0(params),
        }

    def apply(params: Params, grads: Params, state):
        gnorm = global_norm(grads)
        new_p, new_m = {}, {}
        for k, p in params.items():
            m2 = momentum * state["m"][k] + grads[k].to(torch.float32)
            new_p[k] = (p.to(torch.float32) - lr * m2).to(p.dtype)
            new_m[k] = m2
        return new_p, {"m": new_m, "step": state["step"] + 1}, gnorm

    return Optimizer(init=init, apply=apply)
