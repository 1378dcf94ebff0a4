"""GateIndex — the paper's full pipeline behind one build/search API.

Build (offline):
  1. underlying proximity graph (NSG by default; any padded adjacency works)
  2. hub extraction via HBKM (§4.1)
  3. guided-walk subgraph sampling + WL topology tokens (§4.2)
  4. positive/negative query queues from historical queries (Def. 4)
  5. contrastive two-tower training (§4.3, Eq. 3+4)
  6. navigation graph over learned hub representations

Search (online):
  query tower MLP → entry hub (one ``twotower_score`` pass over every hub
  when there are at most ``flat_score_max`` of them, else a greedy cosine
  descent on the nav graph) → Algorithm-1 beam search on the base graph.
  ``search_routed`` splits a batch by per-query hardness and searches each
  side at its own ladder rung.

``build_report`` holds each stage's seconds (``t_nsg`` and the NSG's own
``nsg_t_<stage>`` parts, ``t_hubs``, ``t_topo``, ``t_samples``, ``t_train``,
``t_nav``).

Persistence: ``save(path)`` writes a directory of ``arrays.npz`` and
``manifest.json``; ``load(path)`` reads it, or a pickle written by
``repro``'s ``GateIndex.save``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
import shutil
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import quant as quantlib
from repro_torch.core import navgraph as ng
from repro_torch.core.hubs import HubSet, extract_hubs, kmeans_hubs
from repro_torch.core.samples import (
    greedy_hops,
    hop_counts,
    make_samples,
    top1_targets,
)
from repro_torch.core.subgraph import sample_all_subgraphs
from repro_torch.core.topo_embed import embed_all
from repro_torch.core.twotower import (
    TwoTowerConfig,
    TwoTowerParams,
    hub_tower,
    init_params,
    query_tower,
    train_two_tower,
)
from repro_torch.graphs.nsg import NSG, build_nsg
from repro_torch.graphs.params import (
    SearchParams,
    resolve_search_params,
    warn_deprecated_kwarg,
)
from repro_torch.graphs.search import SearchResult, batched_search
from repro_torch.kernels.twotower_score import twotower_score
from repro_torch.obs.registry import get_registry
from repro_torch.obs.telemetry import (
    SearchTelemetry,
    call_telemetry_sink,
    record_search_telemetry,
    registry_sink,
    summarize,
    to_numpy,
    warn_on_ring_overflow,
)
from repro_torch.obs.trace import span

# "telemetry_sink not passed" marker: the default sink is registry_sink,
# but an explicit None means "no side effects"
_UNSET = object()

# the on-disk format of GateIndex.save
INDEX_FORMAT = "repro_torch.GateIndex"
INDEX_FORMAT_VERSION = 1


@dataclass(frozen=True)
class GateConfig:
    n_hubs: int = 64            # |V| (paper: 512 at 10M scale)
    h: int = 5                  # subgraph max hop
    t_pos: int = 3
    t_neg: int = 15
    s_edges: int = 8            # nav-graph out-degree
    d_u: int = 64
    wl_iters: int = 3
    subgraph_max_nodes: int = 256
    epochs: int = 300
    batch_hubs: int = 64
    lr: float = 1e-3
    probe_width: int = 1
    hbkm_branch: int = 8
    hbkm_lam: float = 1.0
    # H(q, V_i) measurement (Def. 4): "greedy" = Algorithm-1 path length
    # (the paper's implementation); "bfs" = literal shortest-path hops
    # (host numpy, kept for ablation)
    hop_mode: str = "greedy"
    hop_beam: int = 8
    hop_max: int = 48
    # entry selection: hub sets up to this size score every hub with one
    # twotower_score pass; larger sets use the nav-graph cosine descent
    flat_score_max: int = 128
    # ablations (§5.2 Exp-2)
    use_hbkm: bool = True        # False → GATE w/o H (plain k-means hubs)
    use_fusion: bool = True      # False → GATE w/o FE
    use_contrastive: bool = True # False → GATE w/o L (untrained towers)
    seed: int = 0


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class GateIndex:
    db: np.ndarray
    neighbors: np.ndarray          # base-graph padded adjacency
    enter_id: int                  # base-graph default entry (for baselines)
    hubs: HubSet
    tower_params: TwoTowerParams
    tower_cfg: TwoTowerConfig
    nav: ng.NavGraph
    gcfg: GateConfig
    build_report: Dict = field(default_factory=dict)
    # int8 codebook for SearchParams(kernel="fused_q8"), built lazily by
    # ensure_quantized()
    quant: Optional[quantlib.QuantizedDb] = None

    # device-side copies, keyed by the device they live on
    _dev: Optional[dict] = None

    # ------------------------------------------------------------------ build
    @classmethod
    def from_graph(
        cls,
        db: np.ndarray,
        neighbors: np.ndarray,
        enter_id: int,
        train_queries: np.ndarray,
        gcfg: GateConfig = GateConfig(),
        *,
        device="cuda",
    ) -> "GateIndex":
        device = torch.device(device)
        report = {}

        def stage(name, t0):
            _sync(device)
            report[name] = time.perf_counter() - t0

        t0 = time.perf_counter()
        with span("gate.build.hubs", n_hubs=gcfg.n_hubs,
                  method="hbkm" if gcfg.use_hbkm else "kmeans"):
            if gcfg.use_hbkm:
                hubs = extract_hubs(
                    db, gcfg.n_hubs, branch_k=gcfg.hbkm_branch,
                    lam=gcfg.hbkm_lam, seed=gcfg.seed, device=device,
                )
            else:
                hubs = kmeans_hubs(db, gcfg.n_hubs, seed=gcfg.seed,
                                   device=device)
            stage("t_hubs", t0)

        t0 = time.perf_counter()
        with span("gate.build.subgraphs", h=gcfg.h,
                  max_nodes=gcfg.subgraph_max_nodes):
            sgs = sample_all_subgraphs(
                db, neighbors, hubs.ids, h=gcfg.h,
                max_nodes=gcfg.subgraph_max_nodes, seed=gcfg.seed,
            )
        with span("gate.build.topo_embed", d_u=gcfg.d_u, wl_iters=gcfg.wl_iters):
            u_toks = embed_all(sgs, gcfg.d_u, wl_iters=gcfg.wl_iters,
                               seed=gcfg.seed)
        stage("t_topo", t0)
        report["subgraph_nodes_mean"] = float(np.mean([len(s.nodes) for s in sgs]))

        t0 = time.perf_counter()
        with span("gate.build.samples", hop_mode=gcfg.hop_mode,
                  n_queries=len(train_queries)):
            dbt = torch.as_tensor(db, device=device)
            targets = top1_targets(dbt, train_queries, device=device)
            if gcfg.hop_mode == "greedy":
                hops = greedy_hops(
                    dbt, neighbors, train_queries, hubs.ids, targets,
                    beam_width=gcfg.hop_beam, max_hops=gcfg.hop_max,
                    device=device,
                )
            else:
                hops = hop_counts(np.asarray(neighbors), targets, hubs.ids)
            samples = make_samples(hops, t_pos=gcfg.t_pos, t_neg=gcfg.t_neg,
                                   seed=gcfg.seed)
            stage("t_samples", t0)
        report["samples"] = samples.stats()

        tcfg = TwoTowerConfig(
            d_p=db.shape[1], d_u=gcfg.d_u, use_fusion=gcfg.use_fusion,
            lr=gcfg.lr,
        )
        t0 = time.perf_counter()
        with span("gate.build.train_towers", epochs=gcfg.epochs,
                  contrastive=gcfg.use_contrastive):
            if gcfg.use_contrastive:
                params, train_rep = train_two_tower(
                    tcfg, db[hubs.ids], u_toks, train_queries, samples,
                    epochs=gcfg.epochs, batch_hubs=gcfg.batch_hubs,
                    seed=gcfg.seed, device=device,
                )
                report["loss_first"] = train_rep.losses[0]
                report["loss_last"] = train_rep.losses[-1]
            else:  # ablation GATE w/o L: random-init towers, no training
                params = init_params(
                    tcfg, torch.Generator().manual_seed(gcfg.seed), device=device)
            stage("t_train", t0)

        t0 = time.perf_counter()
        with span("gate.build.nav_graph", s=gcfg.s_edges), torch.no_grad():
            reps = hub_tower(
                params, tcfg,
                torch.as_tensor(db[hubs.ids], dtype=torch.float32, device=device),
                torch.as_tensor(u_toks, dtype=torch.float32, device=device),
            ).cpu().numpy()
            nav = ng.build_nav_graph(reps, s=gcfg.s_edges)
            stage("t_nav", t0)
        return cls(
            db=db, neighbors=neighbors, enter_id=enter_id, hubs=hubs,
            tower_params=params, tower_cfg=tcfg, nav=nav, gcfg=gcfg,
            build_report=report,
        )

    @classmethod
    def build(
        cls,
        db: np.ndarray,
        train_queries: np.ndarray,
        gcfg: GateConfig = GateConfig(),
        nsg: Optional[NSG] = None,
        *,
        device="cuda",
        **nsg_kw,
    ) -> "GateIndex":
        t0 = time.perf_counter()
        if nsg is None:
            with span("gate.build.nsg", n=len(db)):
                nsg = build_nsg(db, device=device, **nsg_kw)
        t_nsg = time.perf_counter() - t0
        idx = cls.from_graph(
            db, nsg.neighbors, nsg.enter_id, train_queries, gcfg, device=device
        )
        idx.build_report["t_nsg"] = t_nsg
        for key, value in nsg.build_stats.items():
            idx.build_report["nsg_" + key] = value
        return idx

    # ----------------------------------------------------------------- search
    def _device(self, device) -> dict:
        device = torch.device(device)
        if self._dev is None or self._dev["device"] != device:
            self._dev = {
                "device": device,
                "db": torch.as_tensor(self.db, dtype=torch.float32, device=device),
                "neighbors": torch.as_tensor(self.neighbors, dtype=torch.int32,
                                             device=device),
                "hub_ids": torch.as_tensor(np.asarray(self.hubs.ids),
                                           dtype=torch.int32, device=device),
                "nav": ng.NavGraphDevice.from_host(self.nav, device),
                "tower": self.tower_params.to(device),
            }
        return self._dev

    def ensure_quantized(self, block: int = quantlib.BLOCK) -> quantlib.QuantizedDb:
        """Build (once) and return the int8 codebook for ``fused_q8`` search
        (host numpy, bit-equal to ``repro.quant``); its size is published
        as the ``gate.quant_bytes`` gauge."""
        if self.quant is None or self.quant.block != block:
            with span("gate.quantize_db", n=len(self.db), block=block):
                self.quant = quantlib.quantize_db(self.db, block=block)
            if self._dev is not None:
                self._dev.pop("quant", None)
            get_registry().gauge(
                "gate.quant_bytes", "int8 codebook resident bytes"
            ).set(quantlib.memory_bytes(self.quant))
        return self.quant

    def memory_bytes(self) -> Dict[str, int]:
        """Resident bytes per index component (host copies; the device
        copies are the same sizes).  ``quant`` appears once the codebook is
        built; ``total`` sums what a ``fused_q8`` deployment keeps resident
        (db stays for the exact rerank)."""
        out = {
            "db": int(self.db.nbytes),
            "neighbors": int(self.neighbors.nbytes),
            "nav_reps": int(np.asarray(self.nav.reps).nbytes),
            "nav_neighbors": int(np.asarray(self.nav.neighbors).nbytes),
        }
        if self.quant is not None:
            out["quant"] = quantlib.memory_bytes(self.quant)
        out["total"] = sum(out.values())
        return out

    def _search_kwargs(self, params: SearchParams, device) -> Dict:
        """Device operands ``batched_search`` needs for these params: cosine
        always gets the precomputed ``1/‖row‖`` cache (never renormalize rows
        per hop); ``fused_q8`` gets the device codebook, quantizing on first
        use."""
        dev = self._device(device)
        kw: Dict = {}
        if params.metric == "cosine":
            if "inv_norms" not in dev:
                dev["inv_norms"] = 1.0 / torch.clamp_min(
                    torch.linalg.norm(dev["db"], dim=-1), 1e-9)
            kw["inv_norms"] = dev["inv_norms"]
        if params.kernel == "fused_q8":
            if "quant" not in dev:
                dev["quant"] = self.ensure_quantized().to(dev["device"])
            kw["quant"] = dev["quant"]
        return kw

    def select_entries(self, queries, *, instrument: bool = False,
                       interpret: bool = False, device="cuda"):
        """(B, probe_width) base-graph entry ids chosen by the model.

        Small hub sets: one fused ``twotower_score`` pass over every hub.
        Large hub sets: greedy cosine descent on the navigation graph.
        ``instrument=True`` additionally returns the per-query nav-graph
        descent length (zeros on the flat-score path).
        """
        dev = self._device(device)
        with torch.no_grad():
            z_q = query_tower(
                dev["tower"], self.tower_cfg,
                torch.as_tensor(queries, dtype=torch.float32, device=dev["device"]),
            )
            w = self.gcfg.probe_width
            nav_hops = None
            if self.hubs.n <= self.gcfg.flat_score_max:
                scores = twotower_score(z_q.contiguous(), dev["nav"].reps,
                                        interpret=interpret)
                if w == 1:
                    hub_local = torch.argmax(scores, dim=1)[:, None]
                else:  # lax.top_k order: ties to the lowest index
                    hub_local = torch.sort(-scores, dim=1, stable=True).indices[:, :w]
                if instrument:
                    nav_hops = torch.zeros((hub_local.shape[0],), dtype=torch.int32,
                                           device=hub_local.device)
            elif instrument:
                hub_local, nav_hops = ng.descend(dev["nav"], z_q, probe_width=w,
                                                 instrument=True)
            else:
                hub_local = ng.descend(dev["nav"], z_q, probe_width=w)
            entries = dev["hub_ids"][hub_local]
        return (entries, nav_hops) if instrument else entries

    def route_signals(self, queries, *, with_features: bool = False,
                      interpret: bool = False, device="cuda"):
        """Per-query entry ids + hardness, from signals GATE computes anyway.

        Returns ``(entries (B, w), nav_hops (B,), hardness (B,))`` as tensors
        on ``device``, higher hardness = harder; ``with_features=True`` adds
        a ``(B, 3)`` float32 feature matrix ``[-s1, s2 - s1, nav_hops]``
        (the path that did not run contributes zero columns).  Flat-score
        path: ``hardness = 0.5·s2 − 1.5·s1`` from the best two hub scores
        ``s1 ≥ s2`` (``-s1`` alone for a single hub).  Nav-descent path: the
        descent length.  Only the router's empirical quantile of it matters.

        Entry ids equal ``select_entries``'s: the top-m hub scores come from
        a stable sort, so ties go to the lowest index as ``lax.top_k`` and
        ``argmax`` order them.
        """
        dev = self._device(device)
        with torch.no_grad():
            z_q = query_tower(
                dev["tower"], self.tower_cfg,
                torch.as_tensor(queries, dtype=torch.float32, device=dev["device"]),
            )
            w = self.gcfg.probe_width
            B = z_q.shape[0]
            zeros = torch.zeros((B,), dtype=torch.float32, device=z_q.device)
            if self.hubs.n <= self.gcfg.flat_score_max:
                scores = twotower_score(z_q.contiguous(), dev["nav"].reps,
                                        interpret=interpret)
                m = min(max(w, 2), self.hubs.n)
                neg, top_i = torch.sort(-scores, dim=1, stable=True)
                top_s, top_i = -neg[:, :m], top_i[:, :m]
                hub_local = top_i[:, :w]
                if m >= 2:
                    hardness = 0.5 * top_s[:, 1] - 1.5 * top_s[:, 0]
                    margin = top_s[:, 1] - top_s[:, 0]
                else:  # single hub: no margin term, only the affinity tell
                    hardness = -top_s[:, 0]
                    margin = zeros
                nav_hops = torch.zeros((B,), dtype=torch.int32, device=z_q.device)
                features = torch.stack([-top_s[:, 0], margin, zeros], dim=1)
            else:
                hub_local, nav_hops = ng.descend(dev["nav"], z_q, probe_width=w,
                                                 instrument=True)
                hardness = nav_hops.to(torch.float32)
                features = torch.stack([zeros, zeros, hardness], dim=1)
            entries = dev["hub_ids"][hub_local]
        if with_features:
            return entries, nav_hops, hardness, features
        return entries, nav_hops, hardness

    def warmup_ladder(
        self,
        ladder,
        *,
        batch_size: int,
        params: Optional[SearchParams] = None,
        device="cuda",
        **legacy,
    ) -> int:
        """Run one dummy batch per ladder rung before traffic arrives.

        ``repro`` compiles one program per rung here; the port compiles
        nothing, but runs the same batches, so the first served batch of
        each rung finds the device copies of the index (and the kernels)
        in place.  ``params`` is the base config each rung is applied onto
        (default ``SearchParams(instrument=True)``).  Returns the number of
        rungs warmed.
        """
        base = resolve_search_params(
            "GateIndex.warmup_ladder", params, legacy,
            default=SearchParams(instrument=True),
        )
        dummy = np.zeros((batch_size, self.db.shape[1]), self.db.dtype)
        with span("gate.warmup_ladder", rungs=len(ladder),
                  batch_size=batch_size):
            for rung in ladder:
                self.search(dummy, params=rung.params(base),
                            telemetry_sink=None, device=device)
            _sync(device)
        return len(ladder)

    def warmup_router(
        self,
        router,
        *,
        params: Optional[SearchParams] = None,
        device="cuda",
    ) -> int:
        """Run every (rung, bucket) pair the router can dispatch once, as
        ``repro`` compiles them.  Returns the number of pairs run."""
        base = params if params is not None else SearchParams()
        rungs = (
            (router.easy_rung,)
            if router.easy_rung == router.hard_rung
            else (router.easy_rung, router.hard_rung)
        )
        d = self.db.shape[1]
        warmed = 0
        with span("gate.warmup_router", rungs=len(rungs),
                  buckets=len(router.buckets)):
            for rung in rungs:
                sp = router.rung_params(rung, base)
                for m in router.buckets:
                    self.search(np.zeros((m, d), self.db.dtype), params=sp,
                                telemetry_sink=None, device=device)
                    warmed += 1
            _sync(device)
        return warmed

    def search(
        self,
        queries,
        k: Optional[int] = None,
        *,
        params: Optional[SearchParams] = None,
        telemetry_sink=_UNSET,
        device="cuda",
        **legacy,
    ):
        """GATE search at one ``SearchParams`` config.

        Returns ``SearchResult``; with ``params.instrument=True`` returns
        ``(SearchResult, SearchTelemetry)`` and hands the telemetry to
        ``telemetry_sink``: by default :func:`repro_torch.obs.registry_sink`
        (registry ``search.*`` instruments + ring-overflow warning), or any
        callable ``sink(tele, *, params, where)``; ``None`` skips the side
        effects.  ``k=`` overrides ``params.k``; the older per-knob kwargs
        (``beam_width=``, ..., ``record=``) still work with a one-time
        ``DeprecationWarning``.
        """
        if "record" in legacy:
            record = legacy.pop("record")
            warn_deprecated_kwarg(
                "GateIndex.search", "record",
                "telemetry_sink=None (or leave the default registry sink)",
            )
            if telemetry_sink is not _UNSET:
                raise TypeError(
                    "pass either telemetry_sink= or the deprecated record=, "
                    "not both"
                )
            telemetry_sink = _UNSET if record else None
        params = resolve_search_params("GateIndex.search", params, legacy, k=k)
        sink = registry_sink if telemetry_sink is _UNSET else telemetry_sink
        dev = self._device(device)
        qd = torch.as_tensor(queries, dtype=torch.float32, device=dev["device"])
        kw = self._search_kwargs(params, device)
        if not params.instrument:
            entries = self.select_entries(
                qd, interpret=params.kernel_interpret, device=device)
            return batched_search(dev["db"], dev["neighbors"], qd, entries,
                                  params, device=device, **kw)
        with span("gate.search", queries=len(qd), beam_width=params.beam_width):
            entries, nav_hops = self.select_entries(
                qd, instrument=True, interpret=params.kernel_interpret,
                device=device)
            res, tele = batched_search(dev["db"], dev["neighbors"], qd, entries,
                                       params, device=device, **kw)
        tele = tele._replace(nav_hops=nav_hops)
        if sink is not None:
            sink(tele, params=params, where="GateIndex.search")
        return res, tele

    def search_routed(
        self,
        queries,
        k: Optional[int] = None,
        *,
        router,
        params: Optional[SearchParams] = None,
        telemetry_sink=_UNSET,
        device="cuda",
    ):
        """Per-query hardness-routed search.

        One entry-selection pass gives entries *and* hardness for the whole
        batch (``route_signals``); the router splits the batch, each side
        is padded to a bucket size (pad lanes repeat the side's first
        query) and searched at its ladder rung, and the results are
        scattered back into the original order as host numpy arrays, equal
        per query to an unrouted search at the same rung.

        Always instruments.  Returns ``(SearchResult, RouteReport)``; the
        report carries the merged telemetry, the split and per-rung
        summaries, and has been fed to ``router.observe``.  Call
        ``router.step()`` once per batch to let the split fraction adapt.
        """
        from repro_torch.obs.router import RouteReport

        base = resolve_search_params("GateIndex.search_routed", params, {}, k=k)
        sink = registry_sink if telemetry_sink is _UNSET else telemetry_sink
        dev = self._device(device)
        qd = torch.as_tensor(queries, dtype=torch.float32, device=dev["device"])
        B = int(qd.shape[0])
        entries, nav_hops_d, hardness_d, features_d = self.route_signals(
            qd, with_features=True, interpret=base.kernel_interpret,
            device=device)
        nav_hops = nav_hops_d.cpu().numpy()
        hardness = hardness_d.cpu().numpy()
        features = features_d.cpu().numpy()
        easy_idx, hard_idx, thr = router.split(hardness, features=features)
        kk = base.k
        ids = np.full((B, kk), -1, np.int32)
        dists = np.full((B, kk), np.inf, np.float32)
        hops = np.zeros((B,), np.int32)
        evals = np.zeros((B,), np.int32)
        leaves = {
            f: np.zeros((B,), np.float32 if f in ("entry_dist",
                                                  "entry_rank_proxy",
                                                  "bytes_read")
               else np.int32)
            for f in SearchTelemetry._fields
        }
        summaries = {}
        padded = {}
        with span("gate.search_routed", queries=B,
                  easy=int(easy_idx.size), hard=int(hard_idx.size)):
            for side, idx, rung in (
                ("easy", easy_idx, router.easy_rung),
                ("hard", hard_idx, router.hard_rung),
            ):
                n = int(idx.size)
                if n == 0:
                    continue
                m = router.bucket(n)
                padded[side] = m
                take = idx if m == n else np.concatenate(
                    [idx, np.full(m - n, idx[0], idx.dtype)])
                tj = torch.as_tensor(take, dtype=torch.long, device=dev["device"])
                rp = router.rung_params(rung, base)
                sub_res, sub_tele = batched_search(
                    dev["db"], dev["neighbors"], qd[tj], entries[tj], rp,
                    device=device, **self._search_kwargs(rp, device))
                # a rung narrower than k returns min(beam_width, k) columns;
                # the remaining merged columns keep the -1 / inf padding
                w = min(int(sub_res.ids.shape[1]), kk)
                ids[idx[:, None], np.arange(w)] = sub_res.ids.cpu().numpy()[:n, :w]
                dists[idx[:, None], np.arange(w)] = (
                    sub_res.dists.cpu().numpy()[:n, :w])
                hops[idx] = sub_res.hops.cpu().numpy()[:n]
                evals[idx] = sub_res.dist_evals.cpu().numpy()[:n]
                sub_t = SearchTelemetry(*(a[:n] for a in to_numpy(sub_tele)))
                sub_t = sub_t._replace(nav_hops=nav_hops[idx])
                for f in SearchTelemetry._fields:
                    leaves[f][idx] = getattr(sub_t, f)
                summaries[side] = summarize(sub_t)
        tele = SearchTelemetry(**leaves)
        res = SearchResult(ids=ids, dists=dists, hops=hops, dist_evals=evals)
        report = RouteReport(
            telemetry=tele, easy_idx=easy_idx, hard_idx=hard_idx,
            threshold=thr, easy_rung=router.easy_rung,
            hard_rung=router.hard_rung,
            easy_summary=summaries.get("easy"),
            hard_summary=summaries.get("hard"),
            easy_padded=padded.get("easy", 0),
            hard_padded=padded.get("hard", 0),
            hardness=hardness,
            features=features,
            scores=getattr(router, "last_scores", None),
            predictor_version=getattr(router, "predictor_version", None),
            hard_frac=getattr(router, "hard_frac", None),
        )
        router.observe(report)
        if sink is not None:
            # extras (report/queries) reach only sinks that declare them
            call_telemetry_sink(
                sink, tele, params=base, where="GateIndex.search_routed",
                report=report, queries=queries,
            )
        return res, report

    def search_baseline(
        self,
        queries,
        k: Optional[int] = None,
        *,
        params: Optional[SearchParams] = None,
        entry: str = "medoid",
        telemetry_sink=_UNSET,
        device="cuda",
        **legacy,
    ):
        """Underlying-index search without GATE (entry ∈ {medoid, random});
        the same ``SearchParams`` / ``telemetry_sink`` contract as ``search``
        (by default the telemetry lands under ``search_baseline.<entry>.*``)."""
        params = resolve_search_params(
            "GateIndex.search_baseline", params, legacy, k=k)
        dev = self._device(device)
        B = len(queries)
        if entry == "medoid":
            entries = torch.full((B, 1), self.enter_id, dtype=torch.int32,
                                 device=dev["device"])
        elif entry == "random":
            rng = np.random.default_rng(0)
            entries = torch.as_tensor(
                rng.integers(0, len(self.db), (B, 1)).astype(np.int32),
                device=dev["device"])
        else:
            raise ValueError(entry)
        out = batched_search(dev["db"], dev["neighbors"], queries, entries,
                             params, device=device,
                             **self._search_kwargs(params, device))
        if params.instrument:
            where = f"search_baseline({entry})"
            if telemetry_sink is _UNSET:
                record_search_telemetry(out[1], prefix=f"search_baseline.{entry}")
                warn_on_ring_overflow(out[1], params.visited_ring, where=where)
            elif telemetry_sink is not None:
                telemetry_sink(out[1], params=params, where=where)
        return out

    # ------------------------------------------------------------ persistence
    def save(self, path: str) -> None:
        """Write the index to the directory ``path``: ``arrays.npz`` (every
        array, uncompressed) and ``manifest.json`` (format version,
        ``GateConfig``, ``TwoTowerConfig``, ``build_report``, ``enter_id``,
        the nav graph's start, and each array's shape and dtype).  The
        directory is written under a temporary name beside ``path`` and
        renamed, so a crash leaves no half-written index."""
        arrays = {
            "db": np.asarray(self.db),
            "neighbors": np.asarray(self.neighbors),
            "hubs/ids": np.asarray(self.hubs.ids),
            "hubs/assign": np.asarray(self.hubs.assign),
            "hubs/centroids": np.asarray(self.hubs.centroids),
            "nav/neighbors": np.asarray(self.nav.neighbors),
            "nav/reps": np.asarray(self.nav.reps),
        }
        for name, t in self.tower_params.as_dict().items():
            arrays[f"tower/{name}"] = t.detach().cpu().numpy()
        if self.quant is not None:
            for name, a in zip(quantlib.QuantizedDb._fields, self.quant):
                arrays[f"quant/{name}"] = (a.cpu().numpy()
                                           if isinstance(a, torch.Tensor)
                                           else np.asarray(a))
        manifest = {
            "format": INDEX_FORMAT,
            "version": INDEX_FORMAT_VERSION,
            "enter_id": int(self.enter_id),
            "nav_start": int(self.nav.start),
            "gcfg": dataclasses.asdict(self.gcfg),
            "tower_cfg": dataclasses.asdict(self.tower_cfg),
            "build_report": self.build_report,
            "arrays": {k: {"shape": list(a.shape), "dtype": str(a.dtype)}
                       for k, a in arrays.items()},
        }
        path = os.path.abspath(path)
        parent, name = os.path.split(path)
        os.makedirs(parent, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix=f".{name}.", dir=parent)
        try:
            np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, default=_json_default)
            if os.path.exists(path):
                shutil.rmtree(path)
            os.rename(tmp, path)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    @classmethod
    def load(cls, path: str, *, device="cuda") -> "GateIndex":
        """Read an index written by ``save`` (a directory), or a pickle file
        written by ``repro``'s ``GateIndex.save``, and place it on
        ``device``.  The pickle is read by a restricted unpickler that maps
        ``repro``'s ``GateConfig`` / ``TwoTowerConfig`` to the port's
        classes, allows numpy's array reconstructors and refuses every other
        class (``pickle.UnpicklingError``); ``repro`` is never imported."""
        from repro_torch.convert import index_from_numpy

        if os.path.isdir(path):
            state = _read_index_dir(path)
        else:
            with open(path, "rb") as f:
                state = _ReferenceUnpickler(f).load()
            for key in ("gcfg", "tower_cfg"):
                state[key] = dataclasses.asdict(state[key])
        return index_from_numpy(state, device=device)


def _json_default(x):
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, np.ndarray):
        return x.tolist()
    raise TypeError(f"{type(x).__name__} is not JSON serializable")


def _read_index_dir(path: str) -> dict:
    """The state dict ``convert.index_from_numpy`` takes, from a directory
    ``GateIndex.save`` wrote."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if (manifest.get("format") != INDEX_FORMAT
            or manifest.get("version") != INDEX_FORMAT_VERSION):
        raise ValueError(
            f"{path}: not a {INDEX_FORMAT} v{INDEX_FORMAT_VERSION} index "
            f"(format={manifest.get('format')!r}, "
            f"version={manifest.get('version')!r})")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        a = {k: z[k] for k in z.files}
    for k, spec in manifest["arrays"].items():
        if k not in a or list(a[k].shape) != spec["shape"] \
                or str(a[k].dtype) != spec["dtype"]:
            raise ValueError(f"{path}: array {k!r} is missing or is not "
                             f"{spec['dtype']} {spec['shape']}")
    quant = (tuple(a[f"quant/{n}"] for n in quantlib.QuantizedDb._fields)
             if "quant/codes" in a else None)
    return {
        "db": a["db"], "neighbors": a["neighbors"],
        "enter_id": manifest["enter_id"],
        "hubs": (a["hubs/ids"], a["hubs/assign"], a["hubs/centroids"]),
        "tower_params": {k[len("tower/"):]: v for k, v in a.items()
                         if k.startswith("tower/")},
        "tower_cfg": manifest["tower_cfg"], "gcfg": manifest["gcfg"],
        "nav": (a["nav/neighbors"], a["nav/reps"], manifest["nav_start"]),
        "build_report": manifest["build_report"],
        "quant": quant,
    }


class _ReferenceUnpickler(pickle.Unpickler):
    """Unpickles ``repro``'s saved index: its two config classes become the
    port's, numpy arrays load as numpy arrays, and any other class is
    refused."""

    _CONFIGS = {
        ("repro.core.gate_index", "GateConfig"): GateConfig,
        ("repro.core.twotower", "TwoTowerConfig"): TwoTowerConfig,
    }
    # an array pickles through _reconstruct, or _frombuffer under protocol
    # 5; numpy 2 names the module numpy._core, numpy 1 numpy.core
    _NUMPY = {
        ("numpy", "ndarray"), ("numpy", "dtype"),
        ("numpy._core.multiarray", "_reconstruct"),
        ("numpy.core.multiarray", "_reconstruct"),
        ("numpy._core.numeric", "_frombuffer"),
        ("numpy.core.numeric", "_frombuffer"),
    }

    def find_class(self, module, name):
        if (module, name) in self._CONFIGS:
            return self._CONFIGS[(module, name)]
        if (module, name) in self._NUMPY:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"GateIndex.load: refusing to unpickle {module}.{name}: only "
            "repro's GateConfig / TwoTowerConfig and numpy arrays are allowed")
