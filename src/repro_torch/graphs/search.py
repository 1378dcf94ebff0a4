"""Batched greedy beam search over a proximity graph (paper Algorithm 1).

``repro`` runs one ``lax.while_loop`` per query under ``vmap``, which
executes as one lockstep loop over the batch.  Here that batch dimension is
written out:

  state = (beam ids (B, L), beam dists (B, L), expanded flags (B, L),
           visited ring (B, V), hops (B,), evals (B,))

Every iteration expands, for each *active* query, the best unexpanded beam
node: gather its neighbor row (R,), mask ids already seen (beam + visited
ring), score the rest (the hop kernel), merge and keep the best L.  A query
is active while it has an unexpanded valid beam slot and ``hops <
max_hops``; the loop runs while any query is active, and a finished query's
state stays frozen (``torch.where(active, new, old)``).  Checking for an
active query costs one host sync per hop.

Distances are squared L2 (monotone-equivalent to L2) or 1 − cos.

Besides ``batched_search``: ``beam_search_single`` (one query, the same
loop over a batch of one), ``beam_search_fixed`` (a fixed number of
wavefront hops, the dot-form distance), ``greedy_descent`` (a 1-best walk)
and ``search_jit_cache_size``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.graphs.params import SearchParams, resolve_search_params
from repro_torch.kernels import _build, gather_rows_dist, gather_rows_dist_q8, ref
from repro_torch.obs.telemetry import SearchTelemetry
from repro_torch.quant import QuantizedDb

INF = ref.INF


class SearchResult(NamedTuple):
    ids: torch.Tensor         # (B, k) int32
    dists: torch.Tensor       # (B, k) float32
    hops: torch.Tensor        # (B,) int32 expansion count (path length ℓ)
    dist_evals: torch.Tensor  # (B,) int32 distance computations


def _merge_top_l(ids_a, d_a, exp_a, ids_b, d_b):
    """Merge beams (a) with candidates (b), keep the L best per row by
    distance; a stable sort, as ``jnp.argsort`` is, so ties keep beam
    order ahead of candidate order."""
    L = ids_a.shape[1]
    ids = torch.cat([ids_a, ids_b], dim=1)
    d = torch.cat([d_a, d_b], dim=1)
    expanded = torch.cat([exp_a, torch.zeros_like(ids_b, dtype=torch.bool)], dim=1)
    order = torch.sort(d, dim=1, stable=True).indices[:, :L]
    return ids.gather(1, order), d.gather(1, order), expanded.gather(1, order)


def _rerank_exact(beam_ids, beam_d, evals, rerank, exact_dist):
    """q8 epilogue: re-score the first ``rerank`` beam slots (sorted
    best-first by approximate distance) with the exact fp32 formulation and
    re-order.  Returns the truncated ``(ids, dists)``, the updated eval
    count and the number of valid rows re-read (for ``bytes_read``)."""
    cand = beam_ids[:, :rerank]
    d_ex = exact_dist(cand)
    d_sorted, order = torch.sort(d_ex, dim=1, stable=True)
    n_valid = (cand >= 0).sum(dim=1, dtype=torch.int32)
    return cand.gather(1, order), d_sorted, evals + n_valid, n_valid


def _make_dist_fns(db, q, *, metric, kernel, kernel_interpret, inv_norms,
                   quant):
    """Build ``(dist_to, exact_dist, vec_bytes)`` for a batch of queries.

    ``dist_to(ids (B, X)) → (B, X)`` scores each hop (the approximate q8
    distance under ``kernel="fused_q8"``); ``exact_dist`` is the plain fp32
    formulation the rerank uses; ``vec_bytes`` is the traffic-model bytes
    per scored row.  Query normalization and the q8 query widening happen
    here, once per search, never inside the hop loop.
    """
    qf = q.to(torch.float32)
    D = db.shape[1]
    if metric == "cosine":
        qx = qf / torch.clamp_min(torch.linalg.norm(qf, dim=1, keepdim=True), 1e-9)
        inv = inv_norms if inv_norms is not None else 1.0 / torch.clamp_min(
            torch.linalg.norm(db.to(torch.float32), dim=-1), 1e-9
        )
    elif metric == "l2":
        qx, inv = qf, None
    else:
        raise ValueError(metric)

    def exact_dist(ids):
        return ref.gather_rows_dist_ref(ids, db, qx, inv)

    vec_bytes = D * db.element_size() + (4 if metric == "cosine" else 0)
    if kernel == "xla":
        return exact_dist, exact_dist, vec_bytes
    if kernel == "fused":
        def dist_to(ids):
            return gather_rows_dist(ids, db, qx, inv, interpret=kernel_interpret)
        return dist_to, exact_dist, vec_bytes

    if quant is None:
        raise ValueError(
            'kernel="fused_q8" needs the quantized codebook: pass quant= '
            "(see GateIndex.ensure_quantized / repro_torch.quant.quantize_db)"
        )
    codes, scale, zero, q_inv = quant
    Dp = codes.shape[1]
    nb = scale.shape[1]
    qp = torch.zeros((qx.shape[0], Dp), dtype=torch.float32, device=qx.device)
    qp[:, :D] = qx  # widened once
    vec_bytes = Dp + 8 * nb + (4 if metric == "cosine" else 0)
    q_inv = q_inv if metric == "cosine" else None

    def dist_to(ids):
        return gather_rows_dist_q8(ids, codes, scale, zero, qp, q_inv,
                                   interpret=kernel_interpret)
    return dist_to, exact_dist, vec_bytes


def _beam_search(db, neighbors, queries, entry_ids, *, beam_width, max_hops,
                 visited_ring, instrument, conv_k, metric, kernel,
                 kernel_interpret, rerank, inv_norms, quant):
    """Lockstep Algorithm-1 search of every query of the batch.

    Returns ``(beam_ids, beam_d, hops, evals)``, plus a ``SearchTelemetry``
    when ``instrument``."""
    B = queries.shape[0]
    L, V = beam_width, visited_ring
    R = neighbors.shape[1]
    dev = queries.device
    dist_to, exact_dist, vec_bytes = _make_dist_fns(
        db, queries, metric=metric, kernel=kernel,
        kernel_interpret=kernel_interpret, inv_norms=inv_norms, quant=quant,
    )

    E = entry_ids.shape[1]
    e_d = dist_to(entry_ids)
    if E < L:
        beam_ids = torch.cat(
            [entry_ids, torch.full((B, L - E), -1, dtype=torch.int32, device=dev)], 1)
        beam_d = torch.cat(
            [e_d, torch.full((B, L - E), INF, dtype=torch.float32, device=dev)], 1)
    else:
        beam_ids, beam_d = entry_ids[:, :L], e_d[:, :L]
    beam_d, order = torch.sort(beam_d, dim=1, stable=True)
    beam_ids = beam_ids.gather(1, order)
    expanded = torch.zeros((B, L), dtype=torch.bool, device=dev)
    ring = torch.full((B, V), -1, dtype=torch.int32, device=dev)
    hops = torch.zeros((B,), dtype=torch.int32, device=dev)
    evals = torch.full((B,), E, dtype=torch.int32, device=dev)
    if instrument:
        K = min(conv_k, L)
        evictions = torch.zeros_like(hops)
        conv_hop = torch.zeros_like(hops)
        prev_topk = beam_ids[:, :K]
    rows = torch.arange(B, device=dev)

    it = 0
    while True:
        frontier = ~expanded & (beam_ids >= 0)
        active = frontier.any(dim=1) & (hops < max_hops)
        if not bool(active.any()):
            break
        masked = torch.where(expanded | (beam_ids < 0), INF, beam_d)
        j = torch.argmin(masked, dim=1)          # first occurrence
        p = beam_ids[rows, j]
        new_expanded = expanded.clone()
        new_expanded[rows, j] = True
        slot = (hops % V).long()
        old = ring[rows, slot]
        # frozen queries write their old value back: their ring is unchanged
        ring[rows, slot] = torch.where(active, p, old)
        nbrs = neighbors[p.clamp_min(0).long()]  # (B, R)
        seen_beam = (nbrs[:, :, None] == beam_ids[:, None, :]).any(dim=2)
        # every query has hops <= it, so ring slots >= it + 1 still hold -1
        # (never a valid neighbor): compare against the written prefix only
        w = min(V, it + 1)
        seen_ring = (nbrs[:, :, None] == ring[:, None, :w]).any(dim=2)
        # frozen queries score nothing: the kernel loads no row for id -1
        valid = (nbrs >= 0) & ~seen_beam & ~seen_ring & active[:, None]
        cand = torch.where(valid, nbrs, -1)
        d_n = dist_to(cand)
        m_ids, m_d, m_exp = _merge_top_l(beam_ids, beam_d, new_expanded, cand, d_n)
        a = active[:, None]
        beam_ids = torch.where(a, m_ids, beam_ids)
        beam_d = torch.where(a, m_d, beam_d)
        expanded = torch.where(a, m_exp, expanded)
        evals = evals + valid.sum(dim=1, dtype=torch.int32)
        if instrument:
            evictions = evictions + (active & (old >= 0)).to(torch.int32)
            topk = beam_ids[:, :K]
            changed = (topk != prev_topk).any(dim=1)
            conv_hop = torch.where(active & changed, hops + 1, conv_hop)
            prev_topk = topk
        hops = hops + active.to(torch.int32)
        it += 1

    if not instrument:
        if rerank > 0:
            beam_ids, beam_d, evals, _ = _rerank_exact(
                beam_ids, beam_d, evals, rerank, exact_dist)
        return beam_ids, beam_d, hops, evals

    entry_dist = e_d.min(dim=1).values
    # traffic model: every scored row reads vec_bytes, every hop one (R,)
    # int32 neighbor row; the q8 rerank re-reads its rows at fp32 width
    bytes_read = (evals.to(torch.float32) * float(vec_bytes)
                  + hops.to(torch.float32) * float(R * 4))
    if rerank > 0:
        beam_ids, beam_d, evals, rr_valid = _rerank_exact(
            beam_ids, beam_d, evals, rerank, exact_dist)
        exact_bytes = db.shape[1] * db.element_size() + (
            4 if metric == "cosine" else 0)
        bytes_read = bytes_read + rr_valid.to(torch.float32) * float(exact_bytes)
    tele = SearchTelemetry(
        hops=hops,
        dist_evals=evals,
        ring_evictions=evictions,
        converged_hop=conv_hop,
        nav_hops=torch.zeros_like(hops),
        entry_dist=entry_dist,
        entry_rank_proxy=entry_dist / torch.clamp_min(beam_d[:, 0], 1e-12),
        bytes_read=bytes_read,
    )
    return beam_ids, beam_d, hops, evals, tele


def batched_search(
    db,
    neighbors,
    queries,
    entry_ids,
    params: Optional[SearchParams] = None,
    *,
    k: Optional[int] = None,
    inv_norms=None,
    quant: Optional[QuantizedDb] = None,
    db_lane=None,
    device="cuda",
    **legacy,
):
    """Batched Algorithm-1 search.

    db (N, d) float32, neighbors (N, R) int32 (-1 padded), queries (B, d),
    entry_ids (B, E); numpy arrays or tensors, moved to ``device``.
    ``params.kernel`` selects the distance path; ``"fused_q8"`` needs
    ``quant=`` (``repro_torch.quant.quantize_db(db)``); cosine may pass
    ``inv_norms=`` to reuse a precomputed ``1/‖row‖`` cache.  ``db_lane``
    is accepted for ``repro``'s signature and not used, as in
    ``beam_search_single``.  The old per-knob keywords (``beam_width=``,
    ``max_hops=``, ...) still work through ``resolve_search_params``: each
    warns once and counts into ``api.deprecated_kwargs``.

    Returns ``SearchResult``; with ``params.instrument=True`` returns
    ``(SearchResult, SearchTelemetry)`` with (B,) telemetry fields.
    """
    del db_lane
    params = resolve_search_params("batched_search", params, legacy, k=k)
    if params.kernel == "fused_q8" and quant is None:
        raise ValueError(
            'SearchParams(kernel="fused_q8") requires quant= (the int8 '
            "codebook from repro_torch.quant.quantize_db / "
            "GateIndex.ensure_quantized)"
        )
    db, neighbors, queries, entry_ids, inv_norms, quant = _operands(
        device, db, neighbors, queries, entry_ids, inv_norms, quant)
    rerank = (
        min(params.beam_width, params.k * params.rerank_mult)
        if params.kernel == "fused_q8" else 0
    )
    with torch.no_grad():
        out = _beam_search(
            db, neighbors, queries, entry_ids,
            beam_width=params.beam_width, max_hops=params.max_hops,
            visited_ring=params.visited_ring, instrument=params.instrument,
            conv_k=params.conv_k, metric=params.metric, kernel=params.kernel,
            kernel_interpret=params.kernel_interpret, rerank=rerank,
            inv_norms=inv_norms, quant=quant,
        )
    k = params.k
    res = SearchResult(out[0][:, :k], out[1][:, :k], out[2], out[3])
    return (res, out[4]) if params.instrument else res


def _operands(device, db, neighbors, queries, entry_ids, inv_norms=None,
              quant=None):
    """The search's operands as contiguous tensors on ``device``: db and
    queries float32, neighbors and entries int32."""
    device = torch.device(device)
    db, queries = (torch.as_tensor(x, dtype=torch.float32, device=device)
                   .contiguous() for x in (db, queries))
    neighbors, entry_ids = (torch.as_tensor(x, dtype=torch.int32, device=device)
                            .contiguous() for x in (neighbors, entry_ids))
    if inv_norms is not None:
        inv_norms = torch.as_tensor(
            inv_norms, dtype=torch.float32, device=device).contiguous()
    if quant is not None:
        quant = quant.to(device)
    return db, neighbors, queries, entry_ids, inv_norms, quant


def beam_search_single(
    db,                 # (N, d)
    neighbors,          # (N, R) int32, -1 padded
    q,                  # (d,)
    entry_ids,          # (E,) int32 starting candidates
    *,
    beam_width: int,
    max_hops: int,
    visited_ring: int = 512,
    instrument: bool = False,
    conv_k: int = 10,
    metric: str = "l2",
    kernel: str = "xla",
    kernel_interpret: bool = False,
    rerank: int = 0,
    inv_norms=None,
    quant: Optional[QuantizedDb] = None,
    db_lane=None,
    device="cuda",
):
    """One query's Algorithm-1 beam search: the lockstep loop of
    ``batched_search`` over a batch of one, so the two agree by
    construction.

    ``kernel`` selects the distance path: ``"xla"`` plain gather and score,
    ``"fused"`` the hop kernel (K1, here at (1, R)), ``"fused_q8"`` the int8
    kernel (K2) on ``quant`` followed, when ``rerank > 0``, by an exact fp32
    re-scoring of the first ``rerank`` beam slots (the beam then truncates
    to ``rerank`` entries).  ``inv_norms`` is the cosine ``1/‖row‖`` cache.
    ``db_lane`` is accepted for ``repro``'s signature and not used: the
    CUDA kernels read rows of any width.

    Returns 0-d / 1-d tensors ``(beam_ids, beam_d, hops, evals)``; with
    ``instrument=True`` a fifth element, a ``SearchTelemetry`` of 0-d
    tensors, is appended.
    """
    del db_lane
    db, neighbors, q, entry_ids, inv_norms, quant = _operands(
        device, db, neighbors, q, entry_ids, inv_norms, quant)
    with torch.no_grad():
        out = _beam_search(
            db, neighbors, q[None], entry_ids[None],
            beam_width=beam_width, max_hops=max_hops,
            visited_ring=visited_ring, instrument=instrument, conv_k=conv_k,
            metric=metric, kernel=kernel, kernel_interpret=kernel_interpret,
            rerank=rerank, inv_norms=inv_norms, quant=quant,
        )
    beam_ids, beam_d, hops, evals = (t[0] for t in out[:4])
    if not instrument:
        return beam_ids, beam_d, hops, evals
    return beam_ids, beam_d, hops, evals, SearchTelemetry(*(t[0] for t in out[4]))


def search_jit_cache_size() -> int:
    """What the search path has compiled at run time: the number of CUDA
    kernel libraries ``repro_torch.kernels._build`` has loaded in this
    process.

    ``repro`` counts its jitted ``batched_search`` programs here, and its
    serving asserts that warm-up fills that cache and that ladder moves,
    routed batches and predictor reloads leave it flat.  The port compiles
    no per-shape program: a library is built once per source and serves
    every shape and ``SearchParams``, so the same assertion holds on this
    count.  It is 0 where no kernel has launched (CPU tensors)."""
    return len(_build._libs)


def _fixed_dist_fn(db, q, db_norms):
    """``beam_search_fixed``'s dot-form distance, ``max(‖v‖² − 2v·q + ‖q‖², 0)``
    with fp32 accumulation, for a batch: ids (B, X) → (B, X)."""
    qf = q.to(torch.float32)
    qn = (qf * qf).sum(dim=1, keepdim=True)
    q_st = q.to(db.dtype).to(torch.float32)  # the query in storage precision

    def dist_to(ids):
        safe = ids.clamp_min(0).long()
        vf = db[safe].to(torch.float32)      # (B, X, d)
        vq = torch.einsum("bxd,bd->bx", vf, q_st)
        vn = db_norms[safe] if db_norms is not None else (vf * vf).sum(dim=-1)
        d = torch.clamp_min(vn - 2.0 * vq + qn, 0.0)
        return torch.where(ids < 0, INF, d)
    return dist_to


def _beam_search_fixed(db, neighbors, queries, entry_ids, *, beam_width,
                       num_hops, visited_ring, expand_width, db_norms,
                       instrument, conv_k):
    """``beam_search_fixed`` for a batch: every query runs ``num_hops``
    wavefront hops in lockstep, with no early exit."""
    B = queries.shape[0]
    L, V, E = beam_width, visited_ring, expand_width
    R = neighbors.shape[1]
    dev = queries.device
    rows = torch.arange(B, device=dev)
    dist_to = _fixed_dist_fn(db, queries, db_norms)

    e_d = dist_to(entry_ids)
    n_e = entry_ids.shape[1]
    pad = max(L - n_e, 0)
    beam_ids = torch.cat([entry_ids, torch.full(
        (B, pad), -1, dtype=torch.int32, device=dev)], 1)[:, :L]
    beam_d = torch.cat([e_d, torch.full(
        (B, pad), INF, dtype=torch.float32, device=dev)], 1)[:, :L]
    beam_d, order = torch.sort(beam_d, dim=1, stable=True)
    beam_ids = beam_ids.gather(1, order)
    expanded = torch.zeros((B, L), dtype=torch.bool, device=dev)
    ring = torch.full((B, V), -1, dtype=torch.int32, device=dev)
    if instrument:
        K = min(conv_k, L)
        evals = torch.full((B,), n_e, dtype=torch.int32, device=dev)
        evictions = torch.zeros((B,), dtype=torch.int32, device=dev)
        conv_hop = torch.zeros((B,), dtype=torch.int32, device=dev)
        prev = beam_ids[:, :K]
    first_of = torch.arange(E * R, device=dev)

    for h in range(num_hops):
        masked = torch.where(expanded | (beam_ids < 0), INF, beam_d)
        # the E best unexpanded slots; ties go to the lowest slot, as
        # lax.top_k's do
        j = torch.sort(masked, dim=1, stable=True).indices[:, :E]  # (B, E)
        p = beam_ids.gather(1, j)
        expanded = expanded.scatter(1, j, True)
        # a dynamic_update_slice start is clamped to keep the slice inside
        start = min((h * E) % V, V - E)
        old = ring[:, start:start + E].clone()
        ring[:, start:start + E] = p
        nbrs = neighbors[p.clamp_min(0).long()].reshape(B, E * R)
        seen_beam = (nbrs[:, :, None] == beam_ids[:, None, :]).any(dim=2)
        seen_ring = (nbrs[:, :, None] == ring[:, None, :]).any(dim=2)
        valid = (nbrs >= 0) & ~seen_beam & ~seen_ring
        if E > 1:  # dedup within the expanded wavefront: keep each id's first
            first = (nbrs[:, :, None] == nbrs[:, None, :]).int().argmax(dim=2)
            valid &= first == first_of
        valid &= (p >= 0).repeat_interleave(R, dim=1)
        cand = torch.where(valid, nbrs, -1)
        d_n = dist_to(cand)
        beam_ids, beam_d, expanded = _merge_top_l(
            beam_ids, beam_d, expanded, cand, d_n)
        if instrument:
            evals = evals + valid.sum(dim=1, dtype=torch.int32)
            evictions = evictions + (old >= 0).sum(dim=1, dtype=torch.int32)
            topk = beam_ids[:, :K]
            conv_hop = torch.where((topk != prev).any(dim=1),
                                   torch.full_like(conv_hop, h + 1), conv_hop)
            prev = topk

    hops = torch.full((B,), num_hops * E, dtype=torch.int32, device=dev)
    if not instrument:
        return beam_ids, beam_d, hops
    entry_dist = e_d.min(dim=1).values
    vec_bytes = db.shape[1] * db.element_size() + (
        4 if db_norms is not None else 0)
    tele = SearchTelemetry(
        hops=hops,
        dist_evals=evals,
        ring_evictions=evictions,
        converged_hop=conv_hop,
        nav_hops=torch.zeros_like(hops),
        entry_dist=entry_dist,
        entry_rank_proxy=entry_dist / torch.clamp_min(beam_d[:, 0], 1e-12),
        bytes_read=evals.to(torch.float32) * float(vec_bytes)
        + hops.to(torch.float32) * float(R * 4),
    )
    return beam_ids, beam_d, hops, tele


def beam_search_fixed(
    db,                 # (N, d)
    neighbors,          # (N, R)
    q,                  # (d,)
    entry_ids,          # (E,)
    *,
    beam_width: int,
    num_hops: int,
    visited_ring: int = 256,
    expand_width: int = 1,
    db_norms=None,
    instrument: bool = False,
    conv_k: int = 10,
    device="cuda",
):
    """Fixed-trip-count beam search of one query: exactly ``num_hops``
    expansions, with no early exit (a converged query expands its best node
    again, which changes nothing).  Plain PyTorch: ``repro`` reaches no
    Pallas kernel here.

    ``expand_width`` E > 1 expands the E best unexpanded beam nodes a hop
    (wavefront expansion), deduplicating the E·R candidates among
    themselves.  Distances use the dot form ‖v‖² − 2 v·q + ‖q‖² with fp32
    accumulation; ``db_norms`` (precomputed ‖v‖²) keeps the gathered rows in
    their storage dtype.  ``db`` keeps its dtype (float32 or bfloat16).

    Returns ``(beam_ids, beam_d, hops)``; ``instrument=True`` appends a
    ``SearchTelemetry`` of 0-d tensors.
    """
    device = torch.device(device)
    db = torch.as_tensor(db, device=device).contiguous()
    q = torch.as_tensor(q, device=device)
    neighbors = torch.as_tensor(neighbors, dtype=torch.int32, device=device)
    entry_ids = torch.as_tensor(entry_ids, dtype=torch.int32, device=device)
    if db_norms is not None:
        db_norms = torch.as_tensor(db_norms, dtype=torch.float32, device=device)
    with torch.no_grad():
        out = _beam_search_fixed(
            db, neighbors, q[None], entry_ids[None], beam_width=beam_width,
            num_hops=num_hops, visited_ring=visited_ring,
            expand_width=expand_width, db_norms=db_norms,
            instrument=instrument, conv_k=conv_k,
        )
    beam_ids, beam_d, hops = (t[0] for t in out[:3])
    if not instrument:
        return beam_ids, beam_d, hops
    return beam_ids, beam_d, hops, SearchTelemetry(*(t[0] for t in out[3]))


def greedy_descent(
    vecs,               # (M, d) node vectors (e.g. hub nodes)
    neighbors,          # (M, s) int32
    q,                  # (d,)
    start,              # () int32
    max_hops: int = 32,
    metric: str = "l2",
    *,
    instrument: bool = False,
    device="cuda",
):
    """Pure greedy walk to a local minimum (1-best, no beam), as used on
    the GATE navigation graph where s is tiny.  Each hop moves to the best
    neighbour if it is strictly closer; the walk ends at the first hop that
    does not improve (counted) or at ``max_hops``.  Returns the node id as
    a 0-d tensor; with ``instrument=True`` ``(node id, hops taken)``."""
    device = torch.device(device)
    vecs = torch.as_tensor(vecs, device=device)
    neighbors = torch.as_tensor(neighbors, device=device).long()
    qf = torch.as_tensor(q, device=device).to(torch.float32)
    if metric == "l2":
        def dist(ids):
            v = vecs[ids.clamp_min(0)].to(torch.float32)
            return torch.where(ids < 0, INF, ((v - qf) ** 2).sum(dim=-1))
    elif metric == "cosine":
        qn = qf / torch.clamp_min(torch.linalg.norm(qf), 1e-9)

        def dist(ids):
            v = vecs[ids.clamp_min(0)].to(torch.float32)
            v = v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True), 1e-9)
            return torch.where(ids < 0, INF, 1.0 - v @ qn)
    else:
        raise ValueError(metric)

    with torch.no_grad():
        cur = torch.as_tensor(start, device=device).long().reshape(())
        cur_d = dist(cur[None])[0]
        h = 0
        while h < max_hops:
            nbrs = neighbors[cur]
            d_n = dist(nbrs)
            j = torch.argmin(d_n)              # first occurrence
            h += 1
            if not bool(d_n[j] < cur_d):
                break
            cur, cur_d = nbrs[j], d_n[j]
    cur = cur.to(torch.int32)
    if instrument:
        return cur, torch.tensor(h, dtype=torch.int32, device=device)
    return cur
