"""repro_torch — GATE (adaptive entry selection for graph ANNS) in PyTorch.

The PyTorch and CUDA port of ``repro``.  It keeps ``repro``'s module names
and layout, so each module here has its counterpart there, and it imports
neither ``jax`` nor ``repro``.

Every public entry point takes ``device=`` and defaults to ``"cuda"``; pass
``device="cpu"`` to run the plain PyTorch versions of the kernels.

    from repro_torch import GateIndex, GateConfig, SearchParams
    idx = GateIndex.build(db, train_queries, GateConfig(), device="cuda")
    res = idx.search(queries, params=SearchParams(kernel="fused"))
"""
import torch

# ``repro`` computes in full float32, and so does the port: no TF32 in
# matrix products or convolutions, whatever the process default is.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from repro_torch.core.gate_index import GateConfig, GateIndex  # noqa: E402
from repro_torch.graphs.knn import exact_knn, recall_at_k  # noqa: E402
from repro_torch.graphs.nsg import build_nsg  # noqa: E402
from repro_torch.graphs.params import SearchParams  # noqa: E402
from repro_torch.graphs.search import SearchResult, batched_search  # noqa: E402
from repro_torch.obs.telemetry import SearchTelemetry, summarize  # noqa: E402

__all__ = [
    "GateConfig", "GateIndex", "SearchParams", "SearchResult",
    "SearchTelemetry", "batched_search", "build_nsg", "exact_knn",
    "recall_at_k", "summarize",
]
