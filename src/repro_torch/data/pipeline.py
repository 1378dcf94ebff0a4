"""Deterministic, resumable token pipeline (the port's own copy of
``repro.data.pipeline``: pure NumPy, so a batch stays on the host until a
train step moves it to its device).

The stream is a pure function of (seed, step, dp_rank): every batch is
regenerated from a counter-based PRNG, so

  * RESUME is exact — restoring ``step`` from a checkpoint replays the same
    data order with no iterator state files;
  * STRAGGLER MITIGATION / REDUNDANT LOADING is free — any host can produce
    any rank's shard (there is no per-host data affinity to lose when a node
    is replaced);
  * ELASTIC RESCALE re-slices the same global batch across a different
    dp_degree without skipping or repeating examples.

Synthetic LM data: Zipf-distributed token ids with a deterministic
"documents" structure (BOS-delimited runs) — enough statistical texture for
optimizer/throughput work without external corpora.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    bos_id: int = 1
    mean_doc_len: int = 512


class TokenPipeline:
    def __init__(self, cfg: DataConfig, dp_rank: int = 0, dp_degree: int = 1):
        assert cfg.global_batch % dp_degree == 0
        self.cfg = cfg
        self.dp_rank = dp_rank
        self.dp_degree = dp_degree
        self.local_batch = cfg.global_batch // dp_degree

    def _rng(self, step: int, row: int) -> np.random.Generator:
        # counter-based: one Philox stream per (seed, step, global row)
        return np.random.Generator(
            np.random.Philox(key=self.cfg.seed, counter=[step, row, 0, 0])
        )

    def _row(self, step: int, row: int) -> np.ndarray:
        cfg = self.cfg
        rng = self._rng(step, row)
        toks = rng.zipf(cfg.zipf_a, size=cfg.seq_len).astype(np.int64)
        toks = (toks - 1) % (cfg.vocab_size - 2) + 2  # reserve 0=pad, 1=bos
        # BOS-delimited documents
        n_docs = max(cfg.seq_len // cfg.mean_doc_len, 1)
        starts = rng.choice(cfg.seq_len, size=n_docs, replace=False)
        toks[starts] = cfg.bos_id
        return toks.astype(np.int32)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Local shard of the global batch for ``step`` (deterministic)."""
        rows = [
            self._row(step, self.dp_rank * self.local_batch + r)
            for r in range(self.local_batch)
        ]
        tokens = np.stack(rows)
        return {"tokens": tokens, "labels": tokens.copy()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
