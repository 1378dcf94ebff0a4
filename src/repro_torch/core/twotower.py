"""Contrastive two-tower model (paper §4.3).

Module I — Fusion Embedding Augmentation (Eq. 3): multi-head attention with
the hub's base vector ``p`` as the query and its WL topology tokens
``U ∈ (T, d_u)`` as keys/values; heads concatenated through ``W_O``; residual
with a learned projection of ``p``.

Module II — Projection Network: two MLP towers (hub side on the fused
embedding, query side on raw query vectors) into a shared latent space;
normalized dot product = cosine similarity; InfoNCE loss (Eq. 4) with the
hub's positive/negative query queues.

The parameters are a ``TwoTowerParams`` module whose names and layouts are
``repro``'s (``wq/wk/wv`` are ``(d_p | d_u, m, dk)``), so parameters carry
across both ways.  Online inference per query batch is one query-tower MLP.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.train.optim import adamw

PARAM_NAMES = ("wq", "wk", "wv", "wo", "wp", "h1", "hb1", "h2", "hb2",
               "q1", "qb1", "q2", "qb2")


@dataclass(frozen=True)
class TwoTowerConfig:
    d_p: int            # base-vector dim
    d_u: int = 64       # topology-feature dim
    d_k: int = 32       # per-head attention dim
    n_heads: int = 4
    d_fusion: int = 128
    d_hidden: int = 256
    d_out: int = 128    # shared latent dim
    tau: float = 0.07
    lr: float = 5e-5
    use_fusion: bool = True  # ablation: GATE w/o FE


def param_shapes(cfg: TwoTowerConfig) -> Dict[str, Tuple[int, ...]]:
    m, dk = cfg.n_heads, cfg.d_k
    return {
        "wq": (cfg.d_p, m, dk), "wk": (cfg.d_u, m, dk), "wv": (cfg.d_u, m, dk),
        "wo": (m * dk, cfg.d_fusion), "wp": (cfg.d_p, cfg.d_fusion),
        "h1": (cfg.d_fusion, cfg.d_hidden), "hb1": (cfg.d_hidden,),
        "h2": (cfg.d_hidden, cfg.d_out), "hb2": (cfg.d_out,),
        "q1": (cfg.d_p, cfg.d_hidden), "qb1": (cfg.d_hidden,),
        "q2": (cfg.d_hidden, cfg.d_out), "qb2": (cfg.d_out,),
    }


class TwoTowerParams(nn.Module):
    """The towers' parameters, one ``nn.Parameter`` per ``repro`` name;
    ``params["wq"]`` reads one as ``repro``'s dict does."""

    def __init__(self, tensors: Mapping[str, torch.Tensor]):
        super().__init__()
        for name in PARAM_NAMES:
            self.register_parameter(name, nn.Parameter(tensors[name]))

    def __getitem__(self, name: str) -> torch.Tensor:
        return getattr(self, name)

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return {n: getattr(self, n) for n in PARAM_NAMES}


def _glorot_normal(shape, generator) -> torch.Tensor:
    """``jax.nn.initializers.glorot_normal``: truncated normal, fan-average
    variance, fans along the last two axes times the receptive field."""
    receptive = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    std = np.sqrt(2.0 / (fan_in + fan_out)) / 0.87962566103423978
    t = torch.empty(shape, dtype=torch.float32)
    return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


def init_params(cfg: TwoTowerConfig, generator: Optional[torch.Generator] = None,
                *, params: Optional[Mapping] = None,
                device="cuda") -> TwoTowerParams:
    """Fresh parameters drawn from ``generator`` (a CPU generator, so the
    draw does not depend on the device), or ``params`` given as a mapping of
    arrays in ``repro``'s names and layouts."""
    shapes = param_shapes(cfg)
    if params is not None:
        tensors = {}
        for n in PARAM_NAMES:
            t = torch.tensor(np.asarray(params[n], np.float32))
            if tuple(t.shape) != shapes[n]:
                raise ValueError(f"param {n}: shape {tuple(t.shape)} != {shapes[n]}")
            tensors[n] = t
    else:
        tensors = {
            n: (torch.zeros(s, dtype=torch.float32) if len(s) == 1
                else _glorot_normal(s, generator))
            for n, s in shapes.items()
        }
    return TwoTowerParams(tensors).to(device)


def _normalize(z: torch.Tensor) -> torch.Tensor:
    return z / torch.clamp_min(torch.linalg.norm(z, dim=-1, keepdim=True), 1e-9)


def fusion_embed(params, cfg: TwoTowerConfig, p_hub, u_toks):
    """Eq. 3. p_hub: (B, d_p); u_toks: (B, T, d_u) → (B, d_fusion)."""
    if not cfg.use_fusion:  # ablation: skip topology injection
        return p_hub @ params["wp"]
    q = torch.einsum("bd,dmk->bmk", p_hub, params["wq"])
    k = torch.einsum("btd,dmk->btmk", u_toks, params["wk"])
    v = torch.einsum("btd,dmk->btmk", u_toks, params["wv"])
    scores = torch.einsum("bmk,btmk->bmt", q, k) / np.sqrt(cfg.d_k)
    attn = torch.softmax(scores, dim=-1)
    heads = torch.einsum("bmt,btmk->bmk", attn, v)
    fused = heads.reshape(heads.shape[0], -1) @ params["wo"]
    return fused + p_hub @ params["wp"]  # keep absolute spatial info


def hub_tower(params, cfg: TwoTowerConfig, p_hub, u_toks):
    """(B, d_out) L2-normalized hub representations."""
    f = fusion_embed(params, cfg, p_hub, u_toks)
    h = torch.relu(f @ params["h1"] + params["hb1"])
    return _normalize(h @ params["h2"] + params["hb2"])


def query_tower(params, cfg: TwoTowerConfig, q):
    """(B, d_out) L2-normalized query representations."""
    h = torch.relu(q @ params["q1"] + params["qb1"])
    return _normalize(h @ params["q2"] + params["qb2"])


def info_nce(params, cfg: TwoTowerConfig, batch) -> torch.Tensor:
    """Eq. 4 over a batch of hubs.

    batch: dict with
      p_hub   (B, d_p), u_toks (B, T, d_u),
      q_pos   (B, P, d_p)  positive queries (padded),  pos_mask (B, P),
      q_neg   (B, M, d_p)  negative queries (padded),  neg_mask (B, M)
    """
    z_hub = hub_tower(params, cfg, batch["p_hub"], batch["u_toks"])
    B, P, _ = batch["q_pos"].shape
    M = batch["q_neg"].shape[1]
    z_pos = query_tower(params, cfg, batch["q_pos"].reshape(B * P, -1))
    z_neg = query_tower(params, cfg, batch["q_neg"].reshape(B * M, -1))
    s_pos = torch.einsum("bo,bpo->bp", z_hub, z_pos.reshape(B, P, -1)) / cfg.tau
    s_neg = torch.einsum("bo,bmo->bm", z_hub, z_neg.reshape(B, M, -1)) / cfg.tau
    NEG = -1e30
    pos_mask = batch["pos_mask"]
    s_pos = torch.where(pos_mask > 0, s_pos, NEG)
    s_neg = torch.where(batch["neg_mask"] > 0, s_neg, NEG)
    lse = torch.logsumexp(torch.cat([s_pos, s_neg], dim=1), dim=1)
    per_pos = s_pos - lse[:, None]
    n_pos = torch.clamp_min(pos_mask.sum(dim=1), 1.0)
    loss = -torch.where(pos_mask > 0, per_pos, 0.0).sum(dim=1) / n_pos
    has_pos = pos_mask.sum(dim=1) > 0
    return torch.where(has_pos, loss, 0.0).sum() / torch.clamp_min(
        has_pos.sum(), 1)


@dataclass
class TrainReport:
    losses: list = field(default_factory=list)


def train_two_tower(
    cfg: TwoTowerConfig,
    hub_vecs: np.ndarray,     # (n_c, d_p)
    u_toks: np.ndarray,       # (n_c, T, d_u)
    queries: np.ndarray,      # (Q, d_p)
    sample_set,               # core.samples.SampleSet
    *,
    epochs: int = 200,
    batch_hubs: int = 64,
    pos_per_hub: int = 8,
    neg_per_hub: int = 32,
    seed: int = 0,
    params: Optional[TwoTowerParams] = None,
    device="cuda",
) -> Tuple[TwoTowerParams, TrainReport]:
    """Contrastive training (Adam, lr per paper §5.1).  The hub batches come
    from the same numpy stream as ``repro``'s, so given equal initial
    parameters both packages see the same batches."""
    n_c = hub_vecs.shape[0]
    if params is None:
        params = init_params(cfg, torch.Generator().manual_seed(seed),
                             device=device)
    optim = adamw(lr=cfg.lr, b1=0.9, b2=0.999, grad_clip=None)
    opt_state = optim.init({k: p.detach() for k, p in params.as_dict().items()})

    rng = np.random.default_rng(seed)
    hub_t = torch.as_tensor(hub_vecs, dtype=torch.float32, device=device)
    u_t = torch.as_tensor(u_toks, dtype=torch.float32, device=device)
    q_np = queries.astype(np.float32)
    report = TrainReport()
    batch_hubs = min(batch_hubs, n_c)

    def sample_queue(queue, want):
        if len(queue) == 0:
            return np.zeros(want, np.int64), np.zeros(want, np.float32)
        take = rng.choice(queue, size=want, replace=len(queue) < want)
        return take, np.ones(want, np.float32)

    for _ in range(epochs):
        hubs = rng.choice(n_c, size=batch_hubs, replace=False)
        qp = np.zeros((batch_hubs, pos_per_hub, q_np.shape[1]), np.float32)
        qn = np.zeros((batch_hubs, neg_per_hub, q_np.shape[1]), np.float32)
        pm = np.zeros((batch_hubs, pos_per_hub), np.float32)
        nm = np.zeros((batch_hubs, neg_per_hub), np.float32)
        for bi, hi in enumerate(hubs):
            ip, mp = sample_queue(sample_set.pos[hi], pos_per_hub)
            im, mn = sample_queue(sample_set.neg[hi], neg_per_hub)
            qp[bi], pm[bi] = q_np[ip], mp
            qn[bi], nm[bi] = q_np[im], mn
        hub_idx = torch.as_tensor(hubs, device=device)
        batch = {
            "p_hub": hub_t[hub_idx], "u_toks": u_t[hub_idx],
            "q_pos": torch.as_tensor(qp, device=device),
            "pos_mask": torch.as_tensor(pm, device=device),
            "q_neg": torch.as_tensor(qn, device=device),
            "neg_mask": torch.as_tensor(nm, device=device),
        }
        named = params.as_dict()
        loss = info_nce(params, cfg, batch)
        grads = torch.autograd.grad(loss, list(named.values()))
        with torch.no_grad():
            new, opt_state, _ = optim.apply(
                {k: p.detach() for k, p in named.items()},
                dict(zip(named, grads)), opt_state,
            )
            for k, p in named.items():
                p.copy_(new[k])
        report.losses.append(float(loss.detach()))
    return params, report
