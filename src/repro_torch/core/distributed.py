"""Distributed GATE search: a partitioned ANN index over the ranks of a
mesh (counterpart of ``repro.core.distributed``).

Layout (a DiskANN-style partitioned index):
  * the vector DB is row-sharded into P contiguous partitions over ALL mesh
    dimensions (the flat row-major view of the (data, model) or (pod, data,
    model) mesh); each rank owns (N/P, d) vectors and its own (N/P, R)
    LOCAL subgraph (neighbour ids are shard-local; graphs never cross
    shards);
  * the GATE hub representations are sharded with their partition: each
    shard picks its entry with one two-tower score product (the query
    tower's output times the local hub representations, a raw dot product
    and an argmax, as ``repro`` computes it);
  * every query searches every partition (the fixed-hop beam search,
    ``beam_search_fixed``, over the whole batch in lockstep), then the
    per-shard top-k candidates are merged with one all-gather (k·B ids and
    distances a shard) and a top-k over P·k, ties to the lowest index.

The only traffic between ranks is the final k-merge: P·k·8 bytes a query.
``repro`` runs this under ``shard_map``, where every array is a global one
placed by its sharding; here each rank holds its own shard's tensors
(``ShardedGate``), as the body of that ``shard_map`` sees them.  The
all-gather runs over ``torch.distributed`` on the tensors' own device.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from repro_torch.core.twotower import (
    PARAM_NAMES, TwoTowerConfig, param_shapes, query_tower,
)
from repro_torch.graphs.search import _beam_search_fixed


class ShardedGate(NamedTuple):
    """One rank's shard of the index, on the mesh's device (or, from
    ``sharded_gate_specs``, the global index as meta tensors)."""

    db: torch.Tensor             # (N/P, d) this rank's rows
    db_norms: torch.Tensor       # (N/P,) precomputed ‖v‖² float32
    neighbors: torch.Tensor      # (N/P, R) int32, shard-LOCAL ids
    hub_reps: torch.Tensor       # (H, d_out) float32, this shard's hubs
    hub_local_ids: torch.Tensor  # (H,) int32 local entry id per hub
    tower_params: dict           # replicated
    offsets: torch.Tensor        # (1,) int32 global row offset of the shard


def shard_index(mesh: DeviceMesh) -> int:
    """This rank's partition: its row-major coordinate over every mesh
    dimension."""
    return int(np.ravel_multi_index(tuple(mesh.get_coordinate()),
                                    tuple(mesh.shape)))


def mesh_all_gather(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """(P, *t.shape): ``t`` from every rank of the mesh, in the row-major
    order of their coordinates (``lax.all_gather`` over all axes).  One
    all-gather per mesh dimension, the last first."""
    out = t.contiguous()
    for dim in reversed(range(mesh.ndim)):
        group = mesh.get_group(dim)
        parts = [torch.empty_like(out)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, out, group=group)
        out = torch.stack(parts)
    return out.reshape(-1, *t.shape)


def merge_top_k(ids: torch.Tensor, dists: torch.Tensor, k: int):
    """(P, B, k) per-shard candidates → the (B, k) global best, ties to the
    lowest position in shard-major order (``lax.top_k``'s rule, from a
    stable sort)."""
    P, B, kk = ids.shape
    merged_ids = ids.transpose(0, 1).reshape(B, P * kk)
    merged_d = dists.transpose(0, 1).reshape(B, P * kk)
    top = torch.sort(merged_d, dim=1, stable=True).indices[:, :k]
    return merged_ids.gather(1, top), merged_d.gather(1, top)


def local_search(sg: ShardedGate, queries, tcfg: TwoTowerConfig, *,
                 beam_width: int, max_hops: int, k: int, visited_ring: int,
                 expand_width: int = 1):
    """One shard's part of the search, before the merge: the entry by the
    raw dot product of the query tower's output with the local hubs and
    its argmax (first maximum), ``beam_search_fixed`` from it over the
    whole batch in lockstep, the k best globalized by the shard's offset
    (-1 stays -1).  Returns (ids (B, k), dists (B, k), hops (B,))."""
    dev = sg.db.device
    queries = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    with torch.no_grad():
        z_q = query_tower(sg.tower_params, tcfg, queries)
        scores = z_q @ sg.hub_reps.T                            # (B, H_local)
        entry = sg.hub_local_ids[torch.argmax(scores, dim=1)]   # (B,)
        ids, dists, hops = _beam_search_fixed(
            sg.db, sg.neighbors, queries, entry[:, None],
            beam_width=beam_width, num_hops=max_hops,
            visited_ring=visited_ring, expand_width=expand_width,
            db_norms=sg.db_norms, instrument=False, conv_k=10)
        ids, dists = ids[:, :k], dists[:, :k]
        ids = torch.where(ids >= 0, ids + sg.offsets[0], -1)    # globalize
    return ids, dists, hops


def search_knobs(*, beam_width: int = 64, max_hops: int = 128, k: int = 10,
                 visited_ring: int = 256, expand_width: int = 1) -> dict:
    """``local_search``'s keyword arguments for ``make_search_step``'s: the
    ring only needs to hold every node the search can expand, so it is cut
    to ``max(max_hops * expand_width, 8)``."""
    return dict(beam_width=beam_width, max_hops=max_hops, k=k,
                visited_ring=min(visited_ring,
                                 max(max_hops * expand_width, 8)),
                expand_width=expand_width)


def make_search_step(
    mesh: DeviceMesh,
    tcfg: TwoTowerConfig,
    *,
    beam_width: int = 64,
    max_hops: int = 128,
    k: int = 10,
    visited_ring: int = 256,
    expand_width: int = 1,
) -> Callable:
    """Returns ``search_step(sharded_gate, queries) -> (ids, dists, hops)``:
    the global top-k ids and distances (B, k), the same on every rank, and
    this shard's hop counts (B,).  Every rank of the mesh calls it with the
    same queries."""
    knobs = search_knobs(beam_width=beam_width, max_hops=max_hops, k=k,
                         visited_ring=visited_ring, expand_width=expand_width)

    def search_step(sg: ShardedGate, queries):
        ids, dists, hops = local_search(sg, queries, tcfg, **knobs)
        out_ids, out_d = merge_top_k(mesh_all_gather(ids, mesh),
                                     mesh_all_gather(dists, mesh), k)
        return out_ids, out_d, hops

    return search_step


def sharded_gate_specs(
    mesh: DeviceMesh,
    tcfg: TwoTowerConfig,
    *,
    n_total: int,
    d: int,
    R: int = 32,
    hubs_per_shard: int = 64,
    dtype=torch.bfloat16,
) -> ShardedGate:
    """The global index as meta tensors, allocating nothing."""
    P = mesh.size()
    n_hubs = hubs_per_shard * P

    def meta(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")

    return ShardedGate(
        db=meta((n_total, d), dtype),
        db_norms=meta((n_total,), torch.float32),
        neighbors=meta((n_total, R), torch.int32),
        hub_reps=meta((n_hubs, tcfg.d_out), torch.float32),
        hub_local_ids=meta((n_hubs,), torch.int32),
        tower_params={n: meta(s, torch.float32)
                      for n, s in param_shapes(tcfg).items()},
        offsets=meta((P,), torch.int32),
    )


def gate_shardings(mesh: DeviceMesh) -> ShardedGate:
    """``(mesh, placements)`` per field: rows sharded over every mesh
    dimension in order, the tower parameters replicated."""
    row = (mesh, tuple(Shard(0) for _ in range(mesh.ndim)))
    rep = (mesh, tuple(Replicate() for _ in range(mesh.ndim)))
    return ShardedGate(
        db=row, db_norms=row, neighbors=row, hub_reps=row, hub_local_ids=row,
        tower_params=rep, offsets=row,
    )


# --------------------------------------------------------------------- host
def build_sharded_gate(
    mesh: DeviceMesh,
    db: np.ndarray,
    tcfg_and_params: Tuple[TwoTowerConfig, dict],
    hub_reps: np.ndarray,
    hub_global_ids: np.ndarray,
    build_neighbors: Callable,
    *,
    R: int = 16,
) -> ShardedGate:
    """This rank's shard of a small-scale sharded index (tests, examples):
    rows partitioned contiguously, a LOCAL subgraph built over the shard's
    rows with ``build_neighbors(rows, R)`` (e.g. ``knn_graph``), the hubs
    that fall in the shard given to it.

    ``db`` is the whole database (or any array whose rows ``[p·N/P,
    (p+1)·N/P)`` are shard p's, N = ``len(db)`` cut to a multiple of P).
    Every shard keeps shard 0's hub count, as ``repro`` does: a shard with
    more hubs keeps its first ones, one with fewer repeats its first hub,
    and one with none gets zero representations at local id 0."""
    tcfg, params = tcfg_and_params
    P = mesh.size()
    p = shard_index(mesh)
    per = len(db) // P
    lo, hi = p * per, (p + 1) * per
    hub_global_ids = np.asarray(hub_global_ids)
    hub_reps = np.asarray(hub_reps, np.float32)
    per_hub = max(1, int(((hub_global_ids >= 0)
                          & (hub_global_ids < per)).sum()))
    mine = (hub_global_ids >= lo) & (hub_global_ids < hi)
    reps_p, loc_p = hub_reps[mine], hub_global_ids[mine] - lo
    if len(loc_p) == 0:
        reps_p = np.zeros((per_hub, hub_reps.shape[1]), np.float32)
        loc_p = np.zeros((per_hub,), np.int64)
    while len(loc_p) < per_hub:
        reps_p = np.concatenate([reps_p, reps_p[:1]])
        loc_p = np.concatenate([loc_p, loc_p[:1]])
    rows = np.array(db[lo:hi])  # a copy: ``db`` may be a read-only memmap
    nbrs = np.asarray(build_neighbors(rows, R), np.int32)

    dev = torch.device(mesh.device_type)
    db_t = torch.as_tensor(rows, device=dev)
    params = {n: torch.as_tensor(np.asarray(params[n], np.float32), device=dev)
              if not isinstance(params[n], torch.Tensor)
              else params[n].detach().to(dev, torch.float32)
              for n in PARAM_NAMES}
    return ShardedGate(
        db=db_t,
        db_norms=torch.as_tensor(
            np.sum(rows.astype(np.float32) ** 2, axis=1), device=dev),
        neighbors=torch.as_tensor(nbrs, device=dev),
        hub_reps=torch.as_tensor(reps_p[:per_hub], device=dev),
        hub_local_ids=torch.as_tensor(loc_p[:per_hub].astype(np.int32),
                                      device=dev),
        tower_params=params,
        offsets=torch.tensor([lo], dtype=torch.int32, device=dev),
    )
