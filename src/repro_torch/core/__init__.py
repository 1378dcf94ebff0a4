"""GATE core (counterpart of ``repro.core``): hubs, topology features,
query-aware samples, the two-tower model, the navigation graph and
``GateIndex``.

Public API:
    GateConfig, GateIndex          — build/search (core.gate_index)
    hbkm, extract_hubs             — §4.1 (core.hbkm / core.hubs)
    sample_subgraph, wl_embed      — §4.2 topology (core.subgraph/topo_embed)
    hop_counts, make_samples       — §4.2 query awareness (core.samples)
    TwoTowerConfig, train_two_tower — §4.3 (core.twotower)
    build_nav_graph                — §4.3 (core.navgraph)
"""
from repro_torch.core.gate_index import GateConfig, GateIndex
from repro_torch.core.hbkm import balanced_kmeans, cluster_size_variance, hbkm
from repro_torch.core.hubs import HubSet, extract_hubs, kmeans_hubs
from repro_torch.core.navgraph import NavGraph, build_nav_graph
from repro_torch.core.samples import (
    SampleSet,
    hop_counts,
    make_samples,
    top1_targets,
)
from repro_torch.core.subgraph import (
    Subgraph,
    sample_all_subgraphs,
    sample_subgraph,
)
from repro_torch.core.topo_embed import embed_all, wl_embed, wl_embed_tokens
from repro_torch.core.twotower import (
    TwoTowerConfig,
    hub_tower,
    info_nce,
    query_tower,
    train_two_tower,
)

__all__ = [
    "GateConfig", "GateIndex", "HubSet", "NavGraph", "SampleSet", "Subgraph",
    "TwoTowerConfig", "balanced_kmeans", "build_nav_graph",
    "cluster_size_variance", "embed_all", "extract_hubs", "hbkm",
    "hop_counts", "hub_tower", "info_nce", "kmeans_hubs", "make_samples",
    "query_tower",
    "sample_all_subgraphs", "sample_subgraph", "top1_targets",
    "train_two_tower", "wl_embed", "wl_embed_tokens",
]
