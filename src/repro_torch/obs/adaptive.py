"""Telemetry-driven adaptive search controller.

The paper's adaptive-awareness loop in its online form: per-query hardness
is visible in exactly the counters the instrumented search already returns
(arXiv:2510.22316) and entry quality is measurable without ground truth via
``entry_rank_proxy`` (arXiv:2402.04713).  The controller closes the loop —
it reads the rolling window and moves search effort up or down a **ladder**
of static ``(beam_width, max_hops)`` configs.

Why a ladder and not continuous knobs: in ``repro`` every distinct
``(beam_width, max_hops)`` is a separately compiled program, so a small
ladder warmed at start-up (``GateIndex.warmup_ladder``) keeps adaptation
free of compiles.  The port runs eagerly and compiles nothing, but keeps
the ladder: the same rungs, decisions and warm-up, so a controller carries
across unchanged.

Control policy (hysteresis built in):
  * effort UP when the window shows degrading entry quality
    (``entry_rank_proxy_p95`` above threshold) or visited-ring overflow
    (evictions mean wasted re-scoring *and* recall variance)
  * effort DOWN when the beam converges with headroom — the top-k prefix
    stopped changing well before the hops we paid for
  * a move needs ``patience`` consecutive same-direction votes, then a
    ``cooldown`` (and a window reset) before the next move can happen
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from repro_torch.graphs.params import SearchParams, warn_deprecated_kwarg
from repro_torch.obs.registry import MetricsRegistry, get_registry
from repro_torch.obs.window import RollingWindow


@dataclass(frozen=True)
class LadderRung:
    """One static search config (beam width, hop budget)."""

    beam_width: int
    max_hops: int

    def params(self, base: Optional[SearchParams] = None) -> SearchParams:
        """This rung applied onto ``base``: everything not on the rung —
        k, metric, instrument, ... — comes from ``base``."""
        base = base if base is not None else SearchParams()
        return base.replace(beam_width=self.beam_width,
                            max_hops=self.max_hops)

    def kwargs(self) -> dict:
        """Deprecated: use :meth:`params` and pass one ``SearchParams``."""
        warn_deprecated_kwarg(
            "LadderRung", "kwargs", "rung.params(base_search_params)"
        )
        return {"beam_width": self.beam_width, "max_hops": self.max_hops}


@dataclass(frozen=True)
class VotePolicy:
    """Pure hardness vote from one window snapshot (shared by the
    per-batch ``AdaptiveController`` and the per-query ``HardnessRouter``).

    ``vote`` returns +1 (more search effort needed), -1 (effort to spare),
    or 0 (hold) — with no ladder/hysteresis state, so it is reusable for
    any decision that consumes rolling-window telemetry.
    """

    proxy_p95_hi: float = 8.0
    overflow_rate_hi: float = 0.02
    converged_frac_lo: float = 0.4

    def vote(self, snap: dict) -> int:
        proxy_p95 = snap.get("entry_rank_proxy_p95")
        overflow = snap.get("ring_overflow_rate", 0.0)
        if (proxy_p95 is not None and proxy_p95 > self.proxy_p95_hi) or (
            overflow > self.overflow_rate_hi
        ):
            return +1
        conv = snap.get("mean_converged_hop")
        hops = snap.get("mean_hops")
        if (
            conv is not None
            and hops is not None
            and hops > 0
            and conv <= self.converged_frac_lo * hops
        ):
            return -1
        return 0


# Default effort ladder: ~2x beam per rung, max_hops scaled to keep the
# Algorithm-1 termination condition (all beam slots expanded) reachable.
DEFAULT_LADDER: Tuple[LadderRung, ...] = (
    LadderRung(beam_width=8, max_hops=64),
    LadderRung(beam_width=16, max_hops=96),
    LadderRung(beam_width=32, max_hops=160),
    LadderRung(beam_width=64, max_hops=256),
    LadderRung(beam_width=128, max_hops=512),
)


class AdaptiveController:
    """Steps a ladder level from rolling-window telemetry, with hysteresis.

    Call ``params`` before each batch for the current rung; call ``step()``
    after pushing that batch's summary into the window.
    """

    def __init__(
        self,
        window: RollingWindow,
        ladder: Sequence[LadderRung] = DEFAULT_LADDER,
        *,
        level: Optional[int] = None,
        proxy_p95_hi: float = 8.0,
        overflow_rate_hi: float = 0.02,
        converged_frac_lo: float = 0.4,
        patience: int = 2,
        cooldown: int = 2,
        min_batches: int = 4,
        registry: Optional[MetricsRegistry] = None,
    ):
        if not ladder:
            raise ValueError("ladder must have at least one rung")
        self.window = window
        self.ladder = tuple(ladder)
        self.level = len(self.ladder) // 2 if level is None else level
        if not 0 <= self.level < len(self.ladder):
            raise ValueError(f"level {self.level} outside ladder "
                             f"[0, {len(self.ladder)})")
        self.policy = VotePolicy(
            proxy_p95_hi=proxy_p95_hi,
            overflow_rate_hi=overflow_rate_hi,
            converged_frac_lo=converged_frac_lo,
        )
        self.patience = patience
        self.cooldown = cooldown
        self.min_batches = min_batches
        self._reg = registry if registry is not None else get_registry()
        self._streak = 0          # signed run of same-direction votes
        self._cooldown_left = 0
        self.history: List[dict] = []   # applied moves, for debugging
        self._publish()

    # ------------------------------------------------------------ properties
    @property
    def params(self) -> LadderRung:
        return self.ladder[self.level]

    def set_policy(self, policy: VotePolicy) -> None:
        """Swap the vote thresholds (e.g. calibrated ones from
        a calibration fit); hysteresis state is kept."""
        self.policy = policy

    # ---------------------------------------------------------------- policy
    def decide(self, snap: dict) -> int:
        """Vote from one window snapshot: +1 effort up, -1 down, 0 hold.

        The raw hardness vote lives in :class:`VotePolicy` (unit-testable,
        reused by the hardness router); ``decide`` additionally clamps it
        to moves the ladder can absorb *before* any ``_publish`` — on a
        one-rung ladder (or at an edge level) an up/down vote becomes a
        hold instead of pointing one past the ladder (the gauge published
        after a move can never be out of range).
        """
        vote = self.policy.vote(snap)
        if vote > 0 and self.level >= len(self.ladder) - 1:
            return 0
        if vote < 0 and self.level <= 0:
            return 0
        return vote

    def step(self) -> LadderRung:
        """Read the window, maybe move one rung; returns the (new) rung."""
        snap = self.window.snapshot()
        if snap.get("batches", 0) < self.min_batches:
            return self.params
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            return self.params
        vote = self.decide(snap)
        if vote == 0:
            self._streak = 0
            return self.params
        # same direction extends the streak; a flip restarts it
        self._streak = self._streak + vote if self._streak * vote > 0 else vote
        if abs(self._streak) < self.patience:
            return self.params
        new_level = min(max(self.level + vote, 0), len(self.ladder) - 1)
        if new_level != self.level:
            self._reg.counter(
                "adaptive.steps_up" if vote > 0 else "adaptive.steps_down",
                "adaptive ladder moves",
            ).inc()
            self.history.append({
                "batch": self.window.total_pushed,
                "from": self.level,
                "to": new_level,
                "vote": vote,
                "snapshot": snap,
            })
            self.level = new_level
            self._publish()
            # fresh stats for the new rung; cooldown guards the refill period
            self.window.clear()
            self._cooldown_left = self.cooldown
        self._streak = 0
        return self.params

    def _publish(self) -> None:
        if not self._reg.enabled:
            return
        self._reg.gauge("adaptive.level", "current ladder level").set(
            self.level
        )
        self._reg.gauge(
            "adaptive.beam_width", "current adaptive beam width"
        ).set(self.params.beam_width)
        self._reg.gauge(
            "adaptive.max_hops", "current adaptive max hops"
        ).set(self.params.max_hops)
