"""Proximity-graph construction and Algorithm-1 search (counterpart of
``repro.graphs``).

Surface: ``SearchParams`` (the single search-knob object),
``batched_search`` / ``SearchResult`` and the compile-cache probe
``search_jit_cache_size``.  Graph builders live in ``repro_torch.graphs.nsg``
/ ``repro_torch.graphs.knn``.
"""
from repro_torch.graphs.params import SearchParams, resolve_search_params
from repro_torch.graphs.search import (
    SearchResult,
    batched_search,
    search_jit_cache_size,
)

__all__ = [
    "SearchParams",
    "SearchResult",
    "batched_search",
    "resolve_search_params",
    "search_jit_cache_size",
]
