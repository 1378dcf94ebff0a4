"""GATE ANNS dry-run cells — the paper's own workload on the production
mesh (counterpart of ``repro.launch.gate_cell``).

Each shape is a partitioned-index batch-search step (``core.distributed``):
row-sharded DB + local subgraphs, per-shard GATE entry selection, fixed-hop
beam search, one all-gather k-merge.  A rank's shard is small against one
NVIDIA H100 80GB HBM3 (80 GiB), which leaves room for an LM beside it:

  search_1b     1.07 G vectors × 128 d  (sift-scale, bf16)  B=4096 queries
                256 ranks: 1 GiB of rows + 0.5 GiB of graph a rank
  search_rag    134 M vectors × 768 d  (RAG embedding scale) B=1024 queries
                256 ranks: 0.75 GiB of rows + 64 MiB of graph a rank

The cell's arguments are each rank's local shard, as the body of
``repro``'s ``shard_map`` sees them (``Cell.local``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.core.distributed import (
    gate_shardings,
    make_search_step,
    sharded_gate_specs,
)
from repro_torch.core.twotower import TwoTowerConfig
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.models.common import TensorSpec


@dataclasses.dataclass(frozen=True)
class GateShape:
    name: str
    n_total: int
    d: int
    R: int
    batch: int
    beam_width: int
    num_hops: int
    k: int
    expand_width: int = 1  # wavefront expansion (§Perf lever)


GATE_SHAPES: Dict[str, GateShape] = {
    s.name: s
    for s in (
        GateShape("search_1b", 1 << 30, 128, 32, 4096, 64, 128, 10),
        GateShape("search_rag", 1 << 27, 768, 32, 1024, 64, 128, 10),
    )
}


def build_gate_cell(shape_name: str, mesh, sets=None):
    from repro_torch.launch.cells import Cell  # avoid an import cycle

    gs = GATE_SHAPES[shape_name]
    if sets:  # --set overrides on the GateShape (perf iteration hook)
        kw = {}
        for s in sets:
            k, v = s.split("=", 1)
            kw[k] = int(v) if v.lstrip("-").isdigit() else v
        gs = dataclasses.replace(gs, **kw)
    tcfg = TwoTowerConfig(d_p=gs.d)
    step = make_search_step(
        mesh, tcfg, beam_width=gs.beam_width, max_hops=gs.num_hops, k=gs.k,
        expand_width=gs.expand_width,
    )
    sg_specs = sharded_gate_specs(
        mesh, tcfg, n_total=gs.n_total, d=gs.d, R=gs.R
    )
    q_spec = TensorSpec((gs.batch, gs.d), torch.bfloat16)
    sh = gate_shardings(mesh)
    rep = gate_shardings(mesh).tower_params
    return Cell(
        name=f"gate-anns:{shape_name}",
        fn=step,
        args=(sg_specs, q_spec),
        in_shardings=(sh, rep),
        out_shardings=None,
        donate_argnums=(),
        fallbacks=[],
        ctx=ShardingCtx(),
        local=True,
    )


def gate_model_flops(shape_name: str, n_devices: int = 256) -> float:
    """Useful FLOPs per search step across the mesh: every shard expands
    ``num_hops × expand_width`` nodes per query, each expansion evaluating R
    distances of 2·d FLOPs (dot form), plus the entry-selection matmul."""
    gs = GATE_SHAPES[shape_name]
    per_shard = (
        gs.batch * gs.num_hops * gs.expand_width * gs.R * 2.0 * gs.d
    )
    entry = gs.batch * 2.0 * gs.d * 128  # query tower (d_hidden≈2 matmuls)
    return n_devices * (per_shard + entry)
