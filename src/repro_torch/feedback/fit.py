"""Learned hardness prediction and knob calibration from a query log
(counterpart of ``repro.feedback.fit``).

Two things come out of a captured log:

1. **A hardness predictor**: a logistic regression (or one-hidden-layer
   MLP) mapping the per-query route features (``GateIndex.route_signals``:
   negated best hub score, top-2 margin, nav-descent length) to
   P(needed wide beam), supervised by the shadow-oversearch labels.  The
   formula router's ``-s1 + 0.5·(s2 − s1)`` is one fixed direction in this
   feature space; the fit finds the direction (and, for the MLP, the
   surface) the current traffic calls for.  It trains in PyTorch on
   ``device=``: full batch, balanced loss, the hand-rolled Adam of
   ``repro``.

2. **Calibration**: empirical quantiles replacing hand-tuned knobs: the
   routed ``hard_frac`` from the observed label rate, and the ladder
   ``VotePolicy`` thresholds (``proxy_p95_hi`` / ``overflow_rate_hi`` /
   ``converged_frac_lo``) from the rolling-window snapshots the log carries.

Artifacts are versioned through :class:`repro_torch.ckpt.CheckpointManager`
(atomic LATEST pointer: a crashed fit never corrupts the serving reload
point), in the layout ``repro`` writes, so an artifact of either package
loads in the other.  They hot-load into a live router via
``HardnessRouter.load_predictor`` / the daemon's ``POST /reload``.

The predictor *serves* in NumPy on the host: it scores a batch before the
bucketed split, outside the search, so a reload compiles nothing
(``search_jit_cache_size()`` stays flat).

CLI::

    python -m repro_torch.feedback.fit --log qlog.jsonl --out artifacts/predictor
"""
from __future__ import annotations

import argparse
import json
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.feedback.replay import batch_records, read_log, replay_compare
from repro_torch.obs.window import RollingWindow

# feature order contract with GateIndex.route_signals(with_features=True)
FEATURE_NAMES: Tuple[str, ...] = (
    "neg_best_score", "top2_margin", "nav_hops",
)


# --------------------------------------------------------------- the predictor
@dataclass
class HardnessPredictor:
    """A fitted hardness model with its normalization and calibration.

    ``__call__`` is pure NumPy (host-side, tiny), so serving never builds
    anything for it; training uses PyTorch (see :func:`fit_from_records`).
    """

    model: str                       # "logistic" | "mlp"
    params: Dict[str, np.ndarray]
    mu: np.ndarray                   # (F,) feature means
    sigma: np.ndarray                # (F,) feature stds
    feature_names: Tuple[str, ...] = FEATURE_NAMES
    version: int = 0
    calibration: Dict = field(default_factory=dict)
    metrics: Dict = field(default_factory=dict)

    def __call__(self, features: np.ndarray) -> np.ndarray:
        """(B, F) features → (B,) P(needed wide beam); higher = harder."""
        z = (np.asarray(features, np.float64) - self.mu) / self.sigma
        if self.model == "logistic":
            logits = z @ self.params["w"] + self.params["b"]
        else:
            h = np.tanh(z @ self.params["w1"] + self.params["b1"])
            logits = h @ self.params["w2"] + self.params["b2"]
        return 1.0 / (1.0 + np.exp(-logits))

    def vote_policy_kwargs(self) -> Dict:
        """Calibrated ``VotePolicy`` constructor kwargs (empty if the log
        carried no window records)."""
        return dict(self.calibration.get("policy", {}))


# ------------------------------------------------------------------- datasets
def dataset_from_records(
    records: Iterable[Dict],
) -> Tuple[np.ndarray, np.ndarray]:
    """(X, y) from the labeled batch records of a log: per-query feature
    rows against shadow ``needed_wide`` labels."""
    xs: List[np.ndarray] = []
    ys: List[np.ndarray] = []
    for rec in batch_records(records):
        labels = rec.get("needed_wide")
        feats = rec.get("signals", {}).get("features")
        if labels is None or feats is None:
            continue
        x = np.asarray(feats, np.float64)
        y = np.asarray(labels, bool)
        if x.ndim != 2 or x.shape[0] != y.shape[0]:
            continue
        xs.append(x)
        ys.append(y)
    if not xs:
        return np.zeros((0, len(FEATURE_NAMES))), np.zeros((0,), bool)
    return np.concatenate(xs), np.concatenate(ys)


def auc_score(scores: np.ndarray, y: np.ndarray) -> Optional[float]:
    """Rank AUC (probability a positive outranks a negative)."""
    pos = scores[y]
    neg = scores[~y]
    if pos.size == 0 or neg.size == 0:
        return None
    order = np.argsort(np.concatenate([pos, neg]), kind="stable")
    ranks = np.empty(order.size, np.float64)
    ranks[order] = np.arange(1, order.size + 1)
    return float(
        (ranks[: pos.size].sum() - pos.size * (pos.size + 1) / 2)
        / (pos.size * neg.size)
    )


# ---------------------------------------------------------------- calibration
def calibrate(
    records: Iterable[Dict],
    *,
    frac_margin: float = 1.25,
    frac_floor: float = 0.05,
    frac_ceil: float = 0.75,
) -> Dict:
    """Quantile calibration of the adaptive knobs from a captured log.

    * ``hard_frac`` — the shadow label rate with a safety margin
      (``frac_margin``×, + 0.02): route hard at least as much traffic as
      was *observed* to need it, clipped to the router's sane range.
    * ``policy`` — ladder ``VotePolicy`` thresholds as quantiles of the
      logged rolling-window aggregates, so "degraded" means degraded
      relative to this deployment's own traffic, not a hand-tuned constant.
    """
    records = list(records)
    out: Dict = {}
    labeled = needed = 0
    for rec in batch_records(records):
        labels = rec.get("needed_wide")
        if labels is not None:
            y = np.asarray(labels, bool)
            labeled += y.size
            needed += int(y.sum())
    if labeled:
        rate = needed / labeled
        out["label_rate"] = rate
        out["labeled_queries"] = labeled
        out["hard_frac"] = float(
            np.clip(frac_margin * rate + 0.02, frac_floor, frac_ceil)
        )

    proxies: List[float] = []
    overflows: List[float] = []
    conv_ratios: List[float] = []
    windows = 0
    for rec in records:
        if rec.get("kind") != "window" or "window" not in rec:
            continue
        snap = RollingWindow.from_dict(rec["window"]).snapshot()
        windows += 1
        if "entry_rank_proxy_p95" in snap:
            proxies.append(snap["entry_rank_proxy_p95"])
        if "ring_overflow_rate" in snap:
            overflows.append(snap["ring_overflow_rate"])
        conv = snap.get("mean_converged_hop")
        hops = snap.get("mean_hops")
        if conv is not None and hops:
            conv_ratios.append(conv / hops)
    out["windows"] = windows
    policy: Dict = {}
    if proxies:
        policy["proxy_p95_hi"] = float(np.quantile(proxies, 0.75))
    if overflows:
        policy["overflow_rate_hi"] = float(
            max(np.quantile(overflows, 0.9), 1e-3)
        )
    if conv_ratios:
        policy["converged_frac_lo"] = float(
            np.clip(np.quantile(conv_ratios, 0.25), 0.05, 0.9)
        )
    if policy:
        out["policy"] = policy
    return out


# ------------------------------------------------------------------- training
def _init_params(model: str, n_features: int, hidden: int,
                 seed: int) -> Dict[str, torch.Tensor]:
    """Initial parameters from a seeded CPU generator: small normal
    weights, zero biases (``repro``'s scales: 0.01 logistic, 0.3 MLP)."""
    g = torch.Generator().manual_seed(seed)
    if model == "logistic":
        return {"w": 0.01 * torch.randn((n_features,), generator=g),
                "b": torch.zeros(())}
    return {
        "w1": 0.3 * torch.randn((n_features, hidden), generator=g),
        "b1": torch.zeros((hidden,)),
        "w2": 0.3 * torch.randn((hidden,), generator=g),
        "b2": torch.zeros(()),
    }


def _forward(model: str, p: Mapping[str, torch.Tensor], z: torch.Tensor):
    if model == "logistic":
        return z @ p["w"] + p["b"]
    return torch.tanh(z @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def _train(params: Dict[str, torch.Tensor], Z: torch.Tensor, Y: torch.Tensor,
           *, model: str, epochs: int, lr: float, l2: float, pos_w: float
           ) -> Tuple[Dict[str, torch.Tensor], List[float]]:
    """Full-batch Adam on the balanced logistic loss plus ``l2`` on every
    parameter, from ``params``; returns the final parameters and the loss
    of each epoch (taken before that epoch's step)."""
    names = sorted(params)
    p = {k: params[k].detach().clone().requires_grad_(True) for k in names}
    m = {k: torch.zeros_like(p[k]) for k in names}
    v = {k: torch.zeros_like(p[k]) for k in names}
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses: List[float] = []
    for t in range(1, epochs + 1):
        logits = _forward(model, p, Z)
        nll = -(pos_w * Y * F.logsigmoid(logits)
                + (1.0 - Y) * F.logsigmoid(-logits))
        reg = sum((p[k] * p[k]).sum() for k in names)
        loss = nll.mean() + l2 * reg
        grads = torch.autograd.grad(loss, [p[k] for k in names])
        losses.append(float(loss.detach()))
        scale = lr * np.sqrt(1 - b2 ** t) / (1 - b1 ** t)
        with torch.no_grad():
            for k, g in zip(names, grads):
                m[k] = b1 * m[k] + (1 - b1) * g
                v[k] = b2 * v[k] + (1 - b2) * g * g
                p[k] = (p[k] - scale * m[k] / (torch.sqrt(v[k]) + eps)
                        ).requires_grad_(True)
    return {k: t.detach() for k, t in p.items()}, losses


def _fit(records: Iterable[Dict],
         init: Callable[[int], Mapping[str, object]], *, model: str,
         epochs: int, lr: float, l2: float, device) -> HardnessPredictor:
    """``fit_from_records`` from the initial parameters ``init(F)`` gives
    for F features (arrays or tensors)."""
    if model not in ("logistic", "mlp"):
        raise ValueError(f"model must be 'logistic' or 'mlp', got {model!r}")
    records = list(records)
    X, y = dataset_from_records(records)
    if X.shape[0] == 0:
        raise ValueError(
            "query log has no shadow-labeled records (needed_wide); run the "
            "daemon with --shadow-every or label offline before fitting"
        )
    device = torch.device(device)
    mu = X.mean(axis=0)
    sigma = X.std(axis=0)
    sigma = np.where(sigma < 1e-8, 1.0, sigma)
    Z = torch.as_tensor((X - mu) / sigma, dtype=torch.float32, device=device)
    Y = torch.as_tensor(y, dtype=torch.float32, device=device)
    n_pos = float(y.sum())
    n_neg = float((~y).sum())
    # balanced loss: rare "needed wide" labels must not be drowned out
    pos_w = float(np.clip(n_neg / max(n_pos, 1.0), 0.25, 8.0))

    params0 = {k: torch.as_tensor(np.array(v), dtype=torch.float32,
                                  device=device)
               for k, v in init(X.shape[1]).items()}
    params, losses = _train(params0, Z, Y, model=model, epochs=epochs, lr=lr,
                            l2=l2, pos_w=pos_w)
    pred = HardnessPredictor(
        model=model, params={k: t.cpu().numpy() for k, t in params.items()},
        mu=mu, sigma=sigma, calibration=calibrate(records),
    )
    scores = pred(X)
    pred.metrics = {
        "examples": int(X.shape[0]),
        "positives": int(n_pos),
        "loss_first": losses[0],
        "loss_last": losses[-1],
        "train_auc": auc_score(scores, y),
    }
    return pred


def fit_from_records(
    records: Iterable[Dict],
    *,
    model: str = "logistic",
    hidden: int = 8,
    epochs: int = 400,
    lr: float = 0.1,
    l2: float = 1e-3,
    seed: int = 0,
    device="cuda",
) -> HardnessPredictor:
    """Train a hardness predictor on a log's labeled records (full-batch
    Adam on ``device``; deterministic for a fixed log, seed and device) and
    attach the knob calibration.  Raises ``ValueError`` when the log has no
    labels."""
    return _fit(records, lambda n: _init_params(model, n, hidden, seed),
                model=model, epochs=epochs, lr=lr, l2=l2, device=device)


# ------------------------------------------------------------------ artifacts
def save_predictor(pred: HardnessPredictor, directory: str) -> int:
    """Versioned artifact via ``repro_torch.ckpt`` (atomic LATEST flip);
    returns the new version.  Layout: <dir>/step_<version>/{manifest,arrays}."""
    from repro_torch.ckpt import CheckpointManager

    mgr = CheckpointManager(directory, keep_last=5)
    version = (mgr.latest_step() or 0) + 1
    state = {
        "params": {k: np.asarray(v) for k, v in pred.params.items()},
        "norm": {"mu": np.asarray(pred.mu), "sigma": np.asarray(pred.sigma)},
    }
    extra = {
        "kind": "hardness_predictor",
        "model": pred.model,
        "feature_names": list(pred.feature_names),
        "calibration": pred.calibration,
        "metrics": pred.metrics,
        "version": version,
    }
    mgr.save(version, state, extra=extra, blocking=True)
    pred.version = version
    return version


def load_predictor(directory: str,
                   version: Optional[int] = None) -> HardnessPredictor:
    """Load the latest (or a specific) predictor artifact."""
    from repro_torch.ckpt import CheckpointManager

    mgr = CheckpointManager(directory)
    state, extra = mgr.restore(version)
    if extra.get("kind") != "hardness_predictor":
        raise ValueError(
            f"{directory} does not hold a hardness-predictor artifact "
            f"(kind={extra.get('kind')!r})"
        )
    return HardnessPredictor(
        model=extra["model"],
        params={k: np.asarray(v) for k, v in state["params"].items()},
        mu=np.asarray(state["norm"]["mu"]),
        sigma=np.asarray(state["norm"]["sigma"]),
        feature_names=tuple(extra.get("feature_names", FEATURE_NAMES)),
        version=int(extra.get("version", mgr.latest_step() or 0)),
        calibration=extra.get("calibration", {}),
        metrics=extra.get("metrics", {}),
    )


# ------------------------------------------------------------------------ CLI
def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Fit a hardness predictor + knob calibration from a "
                    "captured query log (repro_torch.feedback)"
    )
    ap.add_argument("--log", required=True, help="JSONL query log path")
    ap.add_argument("--out", required=True,
                    help="artifact directory (repro_torch.ckpt layout)")
    ap.add_argument("--model", default="logistic",
                    choices=["logistic", "mlp"])
    ap.add_argument("--hidden", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=400)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--min-labeled", type=int, default=32,
                    help="refuse to fit on fewer labeled queries")
    ap.add_argument("--replay", action="store_true",
                    help="also print the formula-vs-learned-vs-oracle "
                         "counterfactual replay")
    ap.add_argument("--device", default="cuda", help="where the fit trains")
    args = ap.parse_args(argv)

    records = read_log(args.log)
    X, y = dataset_from_records(records)
    print(f"[fit] {len(records)} records, {X.shape[0]} labeled queries "
          f"({int(y.sum())} needed-wide)", flush=True)
    if X.shape[0] < args.min_labeled:
        print(f"[fit] below --min-labeled={args.min_labeled}; not fitting",
              flush=True)
        return 2
    pred = fit_from_records(
        records, model=args.model, hidden=args.hidden, epochs=args.epochs,
        lr=args.lr, seed=args.seed, device=args.device,
    )
    print(f"[fit] metrics: {json.dumps(pred.metrics)}", flush=True)
    print(f"[fit] calibration: {json.dumps(pred.calibration)}", flush=True)
    if args.replay:
        cmp_ = replay_compare(records, pred)
        for name in ("formula", "learned", "oracle"):
            row = cmp_[name]
            print(f"[fit] replay {name}: regret={row.get('regret')} "
                  f"hard_frac={row.get('mean_hard_frac', row.get('hard_frac'))}",
                  flush=True)
    version = save_predictor(pred, args.out)
    print(f"[fit] saved predictor v{version} -> {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
