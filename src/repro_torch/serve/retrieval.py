"""Retrieval-augmented serving: GATE search feeding generation.

The port's counterpart of ``repro.serve.retrieval``: the paper's module in
its production seat (RAG, §1).  The request embedding hits the GATE index
on ``device``, the retrieved neighbor ids map to context token blocks, and
the serving engine generates conditioned on [retrieved ‖ prompt].

``RagPipeline`` keeps the two halves composable: any GateIndex × any
ServeEngine.  An optional ``AdaptiveController`` closes the loop: each
batch searches with the controller's current ladder rung, its telemetry
summary lands in the controller's rolling window, and the controller steps
after the batch.  With a ``HardnessRouter`` each batch is split by
per-query hardness instead, and a ``QueryLog`` captures the routed batches.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core.gate_index import GateIndex
from repro_torch.graphs.params import SearchParams
from repro_torch.obs import (
    AdaptiveController,
    HardnessRouter,
    SearchTelemetry,
    chain_sinks,
    get_registry,
    registry_sink,
    span,
    summarize,
)
from repro_torch.serve.engine import GenerationResult, ServeEngine


@dataclass
class RagResult:
    retrieved_ids: np.ndarray  # (B, k) database ids
    generation: GenerationResult
    # per-query search telemetry when the pipeline runs instrumented
    telemetry: Optional[SearchTelemetry] = None


class RagPipeline:
    """``device`` is where the index is searched (default ``"cuda"``); the
    engine generates on its own device."""

    def __init__(
        self,
        index: GateIndex,
        engine: ServeEngine,
        doc_tokens: np.ndarray,   # (N_db, doc_len) token block per db vector
        *,
        k: int = 4,
        beam_width: int = 64,
        kernel: str = "xla",      # distance path: xla / fused / fused_q8
        instrument: bool = False,
        pad_token: int = 0,
        controller: Optional[AdaptiveController] = None,
        router: Optional[HardnessRouter] = None,
        qlog=None,                # optional repro_torch.feedback.QueryLog
        device="cuda",
    ):
        self.index = index
        self.engine = engine
        self.doc_tokens = doc_tokens
        self.device = device
        self.base_params = SearchParams(
            k=k, beam_width=beam_width, kernel=kernel
        )
        if kernel == "fused_q8":
            index.ensure_quantized()
        self.k = k
        self.beam_width = beam_width
        # the controller/router needs telemetry to vote on
        self.instrument = (instrument or controller is not None
                           or router is not None)
        self.pad_token = pad_token
        self.controller = controller
        self.router = router
        self.qlog = qlog
        self._routed_sink = (
            chain_sinks(registry_sink, qlog.sink)
            if qlog is not None else registry_sink
        )

    def _splice(self, prompt_tokens: np.ndarray, ids: np.ndarray) -> np.ndarray:
        """[doc_0 ‖ … ‖ doc_{k-1} ‖ prompt] per request.

        Invalid retrieved ids (``-1`` — the search returned fewer than k
        candidates) splice a ``pad_token`` block instead of a document,
        increment ``rag.invalid_ids``, and warn once per call.
        """
        B = prompt_tokens.shape[0]
        invalid = ids < 0                                # (B, k)
        docs = self.doc_tokens[np.maximum(ids, 0)]       # (B, k, doc_len)
        n_bad = int(invalid.sum())
        if n_bad:
            get_registry().counter(
                "rag.invalid_ids",
                "retrieved ids < 0 replaced by padding blocks",
            ).inc(n_bad)
            warnings.warn(
                f"[RagPipeline] {n_bad}/{ids.size} retrieved ids invalid "
                f"(-1); splicing pad blocks — raise beam_width or check the "
                f"index",
                RuntimeWarning,
                stacklevel=3,
            )
            docs = np.where(invalid[:, :, None], self.pad_token, docs)
        docs = docs.reshape(B, -1)
        return np.concatenate([docs, prompt_tokens], axis=1).astype(np.int32)

    def search_params(self) -> SearchParams:
        """The full ``SearchParams`` the next retrieval runs with — the
        controller's current rung applied onto the pipeline base when
        adaptive, else the base itself."""
        base = self.base_params.replace(instrument=self.instrument)
        if self.controller is not None:
            return self.controller.params.params(base)
        return base

    def __call__(
        self,
        query_vecs: np.ndarray,      # (B, d) request embeddings
        prompt_tokens: np.ndarray,   # (B, S_prompt)
        max_new_tokens: int = 32,
        **gen_kw,
    ) -> RagResult:
        tele = None
        sp = self.search_params()
        with span("rag.retrieve", batch=len(query_vecs), k=sp.k,
                  beam_width=sp.beam_width, max_hops=sp.max_hops):
            t0 = time.perf_counter()
            if self.router is not None:
                res, report = self.index.search_routed(
                    query_vecs, router=self.router, params=sp,
                    telemetry_sink=self._routed_sink, device=self.device,
                )
                tele = report.telemetry
            elif sp.instrument:
                res, tele = self.index.search(query_vecs, params=sp,
                                              device=self.device)
            else:
                res = self.index.search(query_vecs, params=sp,
                                        device=self.device)
            ids = res.ids
            ids = ids.cpu().numpy() if torch.is_tensor(ids) else np.asarray(ids)
            dt = time.perf_counter() - t0
        if self.router is not None:
            if self.qlog is not None:
                self.qlog.annotate_last(latency_s=dt)
            self.router.step()
        elif self.controller is not None and tele is not None:
            s = summarize(tele)
            s["latency_s"] = dt
            self.controller.window.push(s)
            self.controller.step()
        tokens = self._splice(np.asarray(prompt_tokens), ids)
        with span("rag.generate", batch=len(query_vecs),
                  max_new=max_new_tokens):
            gen = self.engine.generate(
                {"tokens": tokens}, max_new_tokens, **gen_kw
            )
        return RagResult(retrieved_ids=ids, generation=gen, telemetry=tele)
