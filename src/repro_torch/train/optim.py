"""AdamW with ``repro.train.optim.adamw``'s functional API and arithmetic.

    opt = adamw(lr=3e-4)
    state = opt.init(params)                 # params: dict of tensors
    params, state, gnorm = opt.apply(params, grads, state)

Its own implementation rather than ``torch.optim``, so one step computes
what ``repro``'s does (bias corrections in float32 from an int32 step).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

Params = Dict[str, torch.Tensor]


def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(
        sum(torch.sum(torch.square(x.to(torch.float32))) for x in tree.values())
    )


def clip_by_global_norm(tree: Params, max_norm: float):
    g = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp_min(g, 1e-9), max=1.0)
    return {k: (x * scale).to(x.dtype) for k, x in tree.items()}, g


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
    """Constant learning rate; ``repro``'s warmup-cosine schedule is not
    ported (the two-tower training uses the constant rate)."""
    if warmup or total_steps:
        raise NotImplementedError(
            "adamw(warmup=, total_steps=): the learning-rate schedule waits "
            "for the deferred build pieces of the port (ROADMAP A4)"
        )

    def init(params: Params):
        return {
            "m": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
            "v": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32),
        }

    def apply(params: Params, grads: Params, state):
        if grad_clip is not None:
            grads, gnorm = clip_by_global_norm(grads, grad_clip)
        else:
            gnorm = global_norm(grads)
        step = state["step"] + 1
        stepf = step.to(torch.float32)
        lr_t = torch.tensor(lr, dtype=torch.float32)
        b1t = 1 - torch.tensor(b1, dtype=torch.float32) ** stepf
        b2t = 1 - torch.tensor(b2, dtype=torch.float32) ** stepf
        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            dev = p.device
            gf = grads[k].to(torch.float32)
            m2 = b1 * state["m"][k] + (1 - b1) * gf
            v2 = b2 * state["v"][k] + (1 - b2) * gf * gf
            mhat = m2 / b1t.to(dev)
            vhat = v2 / b2t.to(dev)
            delta = mhat / (torch.sqrt(vhat) + eps)
            if weight_decay:
                delta = delta + weight_decay * p.to(torch.float32)
            new_p[k] = (p.to(torch.float32) - lr_t.to(dev) * delta).to(p.dtype)
            new_m[k], new_v[k] = m2, v2
        return new_p, {"m": new_m, "v": new_v, "step": step}, gnorm

    return Optimizer(init=init, apply=apply)
