"""Per-query hardness routing over the search ladder.

The per-*batch* ``AdaptiveController`` makes every query in a
batch pay the beam width chosen for the window average.  Entry-point
adaptivity pays off per query (arXiv:2402.04713), and hardness prediction
can route individual queries to cheaper/richer configs (arXiv:2510.22316) —
so the router splits each batch by a *per-query hardness score* that GATE
already computes for free (the two-tower entry score margin from
``GateIndex.route_signals``) and sends the easy and hard sub-batches
through **two different ladder rungs**.

Static shapes: sub-batch sizes are data-dependent, so sub-batches are
padded up to a small set of static **buckets** (powers of two up to the
serving batch), as ``repro`` must to keep its compiled programs warm.  The
port compiles nothing, but pads the same way, so a router and its decisions
carry across; ``GateIndex.warmup_router`` runs every (rung, bucket) pair
once at start-up.

Learning the split instead of hand-tuning it: the router keeps the split
*threshold* as an empirical quantile of recent hardness scores at fraction
``hard_frac``, and adapts ``hard_frac`` from two per-rung
``RollingWindow``s using the same :class:`~repro_torch.obs.adaptive.VotePolicy`
the adaptive controller votes with — if the easy rung's window looks hard
(degraded entry quality, ring overflow) more traffic is routed hard; if the
hard rung's window shows convergence headroom, less is.
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.graphs.params import SearchParams
from repro_torch.obs.adaptive import LadderRung, VotePolicy
from repro_torch.obs.registry import MetricsRegistry, get_registry
from repro_torch.obs.window import RollingWindow


def route_buckets(batch_size: int, min_bucket: Optional[int] = None
                  ) -> Tuple[int, ...]:
    """Static sub-batch sizes to warm up: powers of two and their 1.5×
    midpoints up to ``batch_size`` (plus ``batch_size`` itself), floored at
    ``min_bucket`` (default ``batch_size // 8``) so tiny buckets don't
    multiply warm-up batches for marginal padding savings.  The midpoints
    cap worst-case padding waste at ~33% instead of ~100% — padded lanes
    run the full search, so the grid density is paid back every batch."""
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    if min_bucket is None:
        min_bucket = max(1, batch_size // 8)
    out = {batch_size}
    b = 1
    while b < batch_size:
        for c in (b, b + b // 2):
            if min_bucket <= c < batch_size:
                out.add(c)
        b *= 2
    return tuple(sorted(out))


@dataclass
class RouteReport:
    """What one routed batch did — returned by ``GateIndex.search_routed``
    next to the order-merged ``SearchResult``."""

    telemetry: object                 # merged SearchTelemetry, original order
    easy_idx: np.ndarray              # original positions routed easy
    hard_idx: np.ndarray              # original positions routed hard
    threshold: float                  # hardness split point used
    easy_rung: LadderRung
    hard_rung: LadderRung
    easy_summary: Optional[Dict] = None   # summarize() of the easy sub-batch
    hard_summary: Optional[Dict] = None
    easy_padded: int = 0              # bucket size the easy side ran at
    hard_padded: int = 0
    # feedback-loop capture: the raw signals behind the decision,
    # so a query log can replay it counterfactually
    hardness: Optional[np.ndarray] = None    # formula hardness, (B,)
    features: Optional[np.ndarray] = None    # route feature matrix, (B, F)
    scores: Optional[np.ndarray] = None      # scores the split used, (B,)
    predictor_version: Optional[int] = None  # None = formula routing
    hard_frac: Optional[float] = None        # router.hard_frac at decision


class HardnessRouter:
    """Splits batches by predicted hardness and learns the split fraction.

    Call sequence per batch (``GateIndex.search_routed`` does 1–3, the
    serving loop does 4):

      1. ``split(hardness)``   → (easy_idx, hard_idx, threshold)
      2. ``bucket(n)``         → static padded size per sub-batch
      3. ``observe(report)``   → per-rung windows + routed counters
      4. ``step()``            → maybe adapt ``hard_frac`` (hysteresis)
    """

    def __init__(
        self,
        ladder: Sequence[LadderRung],
        *,
        batch_size: int,
        easy_level: int = 0,
        hard_level: int = -1,
        hard_frac: float = 0.25,
        min_frac: float = 0.05,
        max_frac: float = 0.75,
        frac_step: float = 0.05,
        patience: int = 2,
        cooldown: int = 2,
        min_batches: int = 4,
        window_size: int = 16,
        history: int = 1024,
        min_bucket: Optional[int] = None,
        policy: VotePolicy = VotePolicy(),
        registry: Optional[MetricsRegistry] = None,
    ):
        ladder = tuple(ladder)
        if not ladder:
            raise ValueError("ladder must have at least one rung")
        self.easy_rung = ladder[easy_level]
        self.hard_rung = ladder[hard_level]
        self.batch_size = batch_size
        self.buckets = route_buckets(batch_size, min_bucket)
        if not 0.0 < hard_frac < 1.0:
            raise ValueError(f"hard_frac must be in (0, 1), got {hard_frac}")
        self.hard_frac = hard_frac
        self.min_frac = min_frac
        self.max_frac = max_frac
        self.frac_step = frac_step
        self.patience = patience
        self.cooldown = cooldown
        self.min_batches = min_batches
        self.policy = policy
        self.easy_window = RollingWindow(window_size)
        self.hard_window = RollingWindow(window_size)
        self._hist: deque = deque(maxlen=history)
        self._reg = registry if registry is not None else get_registry()
        self._streak = 0
        self._cooldown_left = 0
        self.history_moves = []        # applied hard_frac changes
        self.predictor = None          # learned scorer (feedback loop)
        self.last_scores: Optional[np.ndarray] = None
        self._swap_lock = threading.Lock()
        self._publish(threshold=None)

    # ----------------------------------------------------------------- split
    def split(self, hardness: np.ndarray,
              features: Optional[np.ndarray] = None
              ) -> Tuple[np.ndarray, np.ndarray, float]:
        """Partition a batch: positions with hardness above the current
        quantile threshold go hard.  Higher score = harder; the scale is
        whatever ``route_signals`` emits — only the empirical quantile over
        recent traffic matters, so no per-dataset calibration knob.

        With a loaded predictor (see :meth:`load_predictor`) and a
        ``features`` matrix, the learned score replaces the formula
        hardness.  The predictor runs in NumPy on the host — this method is
        on the host, so a predictor swap touches no search state."""
        pred = self.predictor    # snapshot: swap is atomic wrt this batch
        if pred is not None and features is not None:
            h = np.asarray(
                pred(np.asarray(features, np.float64)), np.float64
            ).reshape(-1)
        else:
            h = np.asarray(hardness, np.float64).reshape(-1)
        self.last_scores = h
        self._hist.extend(h.tolist())
        thr = float(
            np.quantile(np.asarray(self._hist), 1.0 - self.hard_frac)
        )
        hard_mask = h > thr
        easy_idx = np.nonzero(~hard_mask)[0]
        hard_idx = np.nonzero(hard_mask)[0]
        self._publish(threshold=thr)
        return easy_idx, hard_idx, thr

    # ------------------------------------------------------------- predictor
    @property
    def predictor_version(self) -> Optional[int]:
        pred = self.predictor
        return getattr(pred, "version", None) if pred is not None else None

    def load_predictor(self, predictor, *, adopt_hard_frac: bool = True
                       ) -> None:
        """Swap in a learned hardness scorer, atomically: the predictor only
        ever runs host-side in ``split``.

        The score *scale* changes with the scorer, so the quantile history
        and the per-rung vote windows are cleared — stale-scale thresholds
        would misroute the first post-swap batches.  When the predictor
        carries a calibrated ``hard_frac`` (from ``fit.calibrate``) it is
        adopted, clamped to this router's [min_frac, max_frac]."""
        with self._swap_lock:
            if adopt_hard_frac:
                frac = (getattr(predictor, "calibration", None)
                        or {}).get("hard_frac")
                if frac is not None:
                    self.hard_frac = min(
                        max(float(frac), self.min_frac), self.max_frac
                    )
            self._hist.clear()
            self.easy_window.clear()
            self.hard_window.clear()
            self._streak = 0
            self._cooldown_left = self.cooldown
            self.predictor = predictor
        if self._reg.enabled:
            self._reg.counter(
                "router.predictor_loads", "predictor hot-swaps applied"
            ).inc()
            ver = self.predictor_version
            if ver is not None:
                self._reg.gauge(
                    "router.predictor_version",
                    "version of the active learned hardness predictor",
                ).set(float(ver))
        self._publish(threshold=None)

    def set_policy(self, policy: VotePolicy) -> None:
        """Replace the vote policy (e.g. with calibrated thresholds from
        ``fit.calibrate``); windows are kept — thresholds, not scales."""
        self.policy = policy

    def bucket(self, n: int) -> int:
        """Smallest warmed bucket that fits ``n`` lanes.  An oversized
        sub-batch (caller exceeded ``batch_size``) falls back to ``n``
        itself — correct, and counted so it is visible."""
        for b in self.buckets:
            if n <= b:
                return b
        if self._reg.enabled:
            self._reg.counter(
                "router.bucket_misses",
                "routed sub-batches larger than every warmed bucket",
            ).inc()
        return n

    # --------------------------------------------------------------- observe
    def observe(self, report: RouteReport) -> None:
        """Feed one routed batch's per-rung summaries into the per-rung
        windows and the routed counters."""
        if report.easy_summary is not None:
            self.easy_window.push(report.easy_summary)
        if report.hard_summary is not None:
            self.hard_window.push(report.hard_summary)
        if self._reg.enabled:
            self._reg.counter(
                "search.routed_easy_queries",
                "queries routed to the easy rung",
            ).inc(int(report.easy_idx.size))
            self._reg.counter(
                "search.routed_hard_queries",
                "queries routed to the hard rung",
            ).inc(int(report.hard_idx.size))
            self._reg.counter(
                "search.routed_batches", "batches served via routing"
            ).inc()
            pad = (report.easy_padded + report.hard_padded
                   - report.easy_idx.size - report.hard_idx.size)
            if pad > 0:
                self._reg.counter(
                    "search.routed_padded_lanes",
                    "bucket-padding lanes searched and discarded",
                ).inc(int(pad))

    # ------------------------------------------------------------------ step
    def decide(self) -> int:
        """+1: route more traffic hard; -1: less; 0: hold.

        Uses the shared :class:`VotePolicy`: the easy rung voting "needs
        more effort" means queries are being misrouted easy (threshold too
        high); the hard rung voting "effort to spare" means the opposite.
        A side only votes once its window has ``min_batches`` batches.
        """
        easy_snap = self.easy_window.snapshot()
        if (easy_snap.get("batches", 0) >= self.min_batches
                and self.policy.vote(easy_snap) > 0):
            return +1
        hard_snap = self.hard_window.snapshot()
        if (hard_snap.get("batches", 0) >= self.min_batches
                and self.policy.vote(hard_snap) < 0):
            return -1
        return 0

    def step(self) -> float:
        """Maybe move ``hard_frac`` one ``frac_step`` (same patience /
        cooldown hysteresis as the adaptive controller); returns the
        (possibly new) ``hard_frac``."""
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            return self.hard_frac
        vote = self.decide()
        if vote == 0:
            self._streak = 0
            return self.hard_frac
        self._streak = self._streak + vote if self._streak * vote > 0 else vote
        if abs(self._streak) < self.patience:
            return self.hard_frac
        new = min(max(self.hard_frac + vote * self.frac_step, self.min_frac),
                  self.max_frac)
        if new != self.hard_frac:
            if self._reg.enabled:
                self._reg.counter(
                    "router.frac_up" if vote > 0 else "router.frac_down",
                    "hard_frac adaptation moves",
                ).inc()
            self.history_moves.append({
                "from": self.hard_frac, "to": new, "vote": vote,
            })
            self.hard_frac = new
            self._publish(threshold=None)
            self.easy_window.clear()
            self.hard_window.clear()
            self._cooldown_left = self.cooldown
        self._streak = 0
        return self.hard_frac

    # ----------------------------------------------------------------- misc
    def rung_params(self, rung: LadderRung,
                    base: Optional[SearchParams] = None) -> SearchParams:
        """The exact ``SearchParams`` a routed sub-batch runs with — shared
        by ``warmup_router`` and ``search_routed`` so both run the same
        config.  Routed search always instruments: telemetry is what
        the router learns from."""
        return rung.params(base).replace(instrument=True)

    def _publish(self, threshold: Optional[float]) -> None:
        if not self._reg.enabled:
            return
        self._reg.gauge(
            "router.hard_frac", "fraction of traffic routed hard"
        ).set(self.hard_frac)
        if threshold is not None:
            self._reg.gauge(
                "router.threshold", "current hardness split threshold"
            ).set(threshold)
        self._reg.gauge(
            "router.easy_beam_width", "easy rung beam width"
        ).set(self.easy_rung.beam_width)
        self._reg.gauge(
            "router.hard_beam_width", "hard rung beam width"
        ).set(self.hard_rung.beam_width)
