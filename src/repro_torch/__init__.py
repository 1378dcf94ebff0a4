"""repro_torch — GATE (adaptive entry selection for graph ANNS) in PyTorch.

The PyTorch and CUDA port of ``repro``.  It keeps ``repro``'s module names
and layout, so each module here has its counterpart there, and it imports
neither ``jax`` nor ``repro``.  The public surface mirrors ``repro``'s
(everything ported is importable from ``repro_torch``):

    from repro_torch import GateIndex, GateConfig, SearchParams
    idx = GateIndex.build(db, train_queries, GateConfig(), device="cuda")
    res = idx.search(queries, params=SearchParams(kernel="fused"))

Every public entry point takes ``device=`` and defaults to ``"cuda"``; pass
``device="cpu"`` to run the plain PyTorch versions of the kernels.

Attribute access is lazy (PEP 562): a name's module loads on first use.
"""
from __future__ import annotations

import importlib

import torch

# ``repro`` computes in full float32, and so does the port: no TF32 in
# matrix products or convolutions, whatever the process default is.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# name -> module; ``repro``'s export table plus ``exact_knn`` and
# ``recall_at_k``
_EXPORTS = {
    # search configuration + primitives
    "SearchParams": "repro_torch.graphs.params",
    "resolve_search_params": "repro_torch.graphs.params",
    "SearchResult": "repro_torch.graphs.search",
    "batched_search": "repro_torch.graphs.search",
    "search_jit_cache_size": "repro_torch.graphs.search",
    "exact_knn": "repro_torch.graphs.knn",
    "recall_at_k": "repro_torch.graphs.knn",
    # index
    "GateConfig": "repro_torch.core.gate_index",
    "GateIndex": "repro_torch.core.gate_index",
    "NSG": "repro_torch.graphs.nsg",
    "build_nsg": "repro_torch.graphs.nsg",
    # int8 codebook for SearchParams(kernel="fused_q8")
    "QuantizedDb": "repro_torch.quant",
    "quantize_db": "repro_torch.quant",
    # observability + adaptation
    "AdaptiveController": "repro_torch.obs.adaptive",
    "DEFAULT_LADDER": "repro_torch.obs.adaptive",
    "LadderRung": "repro_torch.obs.adaptive",
    "VotePolicy": "repro_torch.obs.adaptive",
    "HardnessRouter": "repro_torch.obs.router",
    "RouteReport": "repro_torch.obs.router",
    "route_buckets": "repro_torch.obs.router",
    "RollingWindow": "repro_torch.obs.window",
    "SearchTelemetry": "repro_torch.obs.telemetry",
    "registry_sink": "repro_torch.obs.telemetry",
    "summarize": "repro_torch.obs.telemetry",
    "MetricsExporter": "repro_torch.obs.exporter",
    "MetricsRegistry": "repro_torch.obs.registry",
    "get_registry": "repro_torch.obs.registry",
    # serving
    "SearchRequest": "repro_torch.serve.daemon",
    "ServeDaemon": "repro_torch.serve.daemon",
    "RagPipeline": "repro_torch.serve.retrieval",
    # feedback loop: capture -> replay -> fit -> hot-reload
    "QueryLog": "repro_torch.feedback.qlog",
    "ShadowOversearch": "repro_torch.feedback.qlog",
    "HardnessPredictor": "repro_torch.feedback.fit",
    "load_predictor": "repro_torch.feedback.fit",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    try:
        module = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module 'repro_torch' has no attribute {name!r}"
        ) from None
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value  # cache: next access skips __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
