"""Fault-tolerant training runner: checkpoint and restart, elastic
re-shard, straggler accounting (counterpart of
``repro.distributed.fault``).

``FaultTolerantRunner`` wraps any (state, batch) → (state, metrics) step:

  * periodic asynchronous checkpoints (``ckpt.CheckpointManager``, which
    snapshots the state to the host before its background write);
  * ``run`` survives step-level failures: on an exception it restores the
    last checkpoint onto the runner's target shardings (or its device),
    rebuilds the data position from the restored step (the pipeline is
    counter-based, so no data is skipped or repeated) and retries;
    ``max_restarts`` bounds the loop;
  * straggler hooks: a ring buffer of step wall times and a z-score
    detector (``straggler_report``).

A checkpoint keys each array by its "/"-joined path, so a parameter name
that holds "/" (the enc-dec's ``enc/wq``, the hybrid's ``m/wx``) cannot
be told from nesting on restore: ``structure`` (a tree of the state's
shape, e.g. ``train.loop.train_state_structure``) rebuilds it.
``repro``'s runner passes none and nests such names one level deeper.

``restore_elastic`` loads a checkpoint onto a device or re-places every
array on a mesh, possibly of another shape than the one it was saved from,
by a sharding tree whose leaves are ``(DeviceMesh, placements)`` pairs
(checkpoints hold full arrays, so they do not depend on the mesh).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.ckpt.checkpoint import CheckpointManager


@dataclass
class RunnerConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep_last: int = 3
    max_restarts: int = 3
    straggler_window: int = 64
    straggler_zscore: float = 3.0


class FaultTolerantRunner:
    def __init__(
        self,
        cfg: RunnerConfig,
        step_fn: Callable,         # (state, batch) -> (state, metrics)
        batch_fn: Callable,        # step:int -> batch
        init_state_fn: Callable,   # () -> state
        target_shardings=None,     # optional sharding tree for elastic restore
        *,
        device="cuda",             # where a restored state is placed
        structure=None,            # a tree of the state's shape
    ):
        self.cfg = cfg
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.init_state_fn = init_state_fn
        self.target_shardings = target_shardings
        self.device = device
        self.structure = structure
        self.mgr = CheckpointManager(cfg.ckpt_dir, keep_last=cfg.keep_last)
        self.step_times: List[float] = []
        self.restarts = 0

    # ------------------------------------------------------------ lifecycle
    def _bootstrap(self):
        latest = self.mgr.latest_step()
        if latest is None:
            return self.init_state_fn(), 0
        state, extra = self.mgr.restore(
            latest, target_shardings=self.target_shardings,
            device=self.device, structure=self.structure)
        return state, int(extra.get("next_step", latest + 1))

    def run(
        self,
        num_steps: int,
        *,
        fail_at: Optional[Dict[int, int]] = None,  # test hook {step: times}
        on_metrics: Optional[Callable] = None,
    ):
        """Run to ``num_steps`` total steps, restarting on failures."""
        fail_at = dict(fail_at or {})
        while True:
            state, step = self._bootstrap()
            try:
                while step < num_steps:
                    if fail_at.get(step, 0) > 0:
                        fail_at[step] -= 1
                        raise RuntimeError(f"injected failure at step {step}")
                    t0 = time.time()
                    batch = self.batch_fn(step)
                    state, metrics = self.step_fn(state, batch)
                    self._record_time(time.time() - t0)
                    if on_metrics:
                        on_metrics(step, metrics)
                    step += 1
                    if step % self.cfg.ckpt_every == 0:
                        self.mgr.save(step, state, {"next_step": step})
                self.mgr.save(step, state, {"next_step": step}, blocking=True)
                return state, step
            except Exception:
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise
                self.mgr.wait()
                # loop → bootstrap restores the latest checkpoint

    # ----------------------------------------------------------- stragglers
    def _record_time(self, dt: float):
        self.step_times.append(dt)
        if len(self.step_times) > self.cfg.straggler_window:
            self.step_times.pop(0)

    def straggler_report(self) -> Dict[str, Any]:
        ts = np.asarray(self.step_times)
        if len(ts) < 8:
            return {"ready": False}
        mu, sd = float(ts.mean()), float(ts.std() + 1e-9)
        z = (ts - mu) / sd
        flagged = int(np.sum(z > self.cfg.straggler_zscore))
        return {
            "ready": True,
            "mean_s": mu,
            "p95_s": float(np.percentile(ts, 95)),
            "flagged_steps": flagged,
        }


def restore_elastic(ckpt_dir: str, target_shardings="cuda",
                    step: Optional[int] = None, *, structure=None):
    """Load a checkpoint (``repro``'s layout, from either package) onto a
    possibly different mesh: ``target_shardings`` is a device for every
    array or a tree of the state's shape whose leaves are devices or
    ``(DeviceMesh, placements)`` pairs.  ``structure`` rebuilds "/"-named
    leaves (see ``FaultTolerantRunner``).  Returns (state, extra)."""
    return CheckpointManager(ckpt_dir).restore(
        step, target_shardings=target_shardings, structure=structure)
