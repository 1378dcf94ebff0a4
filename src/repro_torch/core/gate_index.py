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

``build_report`` holds each stage's seconds (``t_nsg`` and the NSG's own
``nsg_t_<stage>`` parts, ``t_hubs``, ``t_topo``, ``t_samples``, ``t_train``,
``t_nav``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import quant as quantlib
from repro_torch.core import navgraph as ng
from repro_torch.core.hubs import HubSet, extract_hubs
from repro_torch.core.samples import greedy_hops, make_samples, top1_targets
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
from repro_torch.graphs.params import SearchParams
from repro_torch.graphs.search import batched_search
from repro_torch.kernels import twotower_score


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
    # H(q, V_i) measurement (Def. 4): "greedy" = Algorithm-1 path length;
    # "bfs" (literal shortest-path hops) is not ported yet
    hop_mode: str = "greedy"
    hop_beam: int = 8
    hop_max: int = 48
    # entry selection: hub sets up to this size score every hub with one
    # twotower_score pass; larger sets use the nav-graph cosine descent
    flat_score_max: int = 128
    # ablations (§5.2 Exp-2)
    use_hbkm: bool = True        # False → GATE w/o H (not ported yet)
    use_fusion: bool = True      # False → GATE w/o FE
    use_contrastive: bool = True # False → GATE w/o L (untrained towers)
    seed: int = 0


def _not_ported(gcfg: GateConfig) -> None:
    if gcfg.hop_mode != "greedy":
        raise NotImplementedError(
            f'GateConfig(hop_mode={gcfg.hop_mode!r}): hop_counts ("bfs") is '
            "not ported yet (ROADMAP A4, deferred pieces)"
        )
    if not gcfg.use_hbkm:
        raise NotImplementedError(
            "GateConfig(use_hbkm=False): kmeans_hubs is not ported yet "
            "(ROADMAP A4, deferred pieces)"
        )


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
        _not_ported(gcfg)
        device = torch.device(device)
        report = {}

        def stage(name, t0):
            _sync(device)
            report[name] = time.perf_counter() - t0

        t0 = time.perf_counter()
        hubs = extract_hubs(
            db, gcfg.n_hubs, branch_k=gcfg.hbkm_branch, lam=gcfg.hbkm_lam,
            seed=gcfg.seed, device=device,
        )
        stage("t_hubs", t0)

        t0 = time.perf_counter()
        sgs = sample_all_subgraphs(
            db, neighbors, hubs.ids, h=gcfg.h,
            max_nodes=gcfg.subgraph_max_nodes, seed=gcfg.seed,
        )
        u_toks = embed_all(sgs, gcfg.d_u, wl_iters=gcfg.wl_iters, seed=gcfg.seed)
        stage("t_topo", t0)
        report["subgraph_nodes_mean"] = float(np.mean([len(s.nodes) for s in sgs]))

        t0 = time.perf_counter()
        dbt = torch.as_tensor(db, device=device)
        targets = top1_targets(dbt, train_queries, device=device)
        hops = greedy_hops(
            dbt, neighbors, train_queries, hubs.ids, targets,
            beam_width=gcfg.hop_beam, max_hops=gcfg.hop_max, device=device,
        )
        samples = make_samples(hops, t_pos=gcfg.t_pos, t_neg=gcfg.t_neg,
                               seed=gcfg.seed)
        stage("t_samples", t0)
        report["samples"] = samples.stats()

        tcfg = TwoTowerConfig(
            d_p=db.shape[1], d_u=gcfg.d_u, use_fusion=gcfg.use_fusion,
            lr=gcfg.lr,
        )
        t0 = time.perf_counter()
        if gcfg.use_contrastive:
            params, train_rep = train_two_tower(
                tcfg, db[hubs.ids], u_toks, train_queries, samples,
                epochs=gcfg.epochs, batch_hubs=gcfg.batch_hubs,
                seed=gcfg.seed, device=device,
            )
            report["loss_first"] = train_rep.losses[0]
            report["loss_last"] = train_rep.losses[-1]
        else:  # ablation GATE w/o L: random-init towers, no training
            params = init_params(tcfg, torch.Generator().manual_seed(gcfg.seed),
                                 device=device)
        stage("t_train", t0)

        t0 = time.perf_counter()
        with torch.no_grad():
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
        _not_ported(gcfg)
        t0 = time.perf_counter()
        if nsg is None:
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
        (host numpy, bit-equal to ``repro.quant``)."""
        if self.quant is None or self.quant.block != block:
            self.quant = quantlib.quantize_db(self.db, block=block)
            if self._dev is not None:
                self._dev.pop("quant", None)
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

    def search(
        self,
        queries,
        k: Optional[int] = None,
        *,
        params: Optional[SearchParams] = None,
        telemetry_sink=None,
        device="cuda",
    ):
        """GATE search at one ``SearchParams`` config.

        Returns ``SearchResult``; with ``params.instrument=True`` returns
        ``(SearchResult, SearchTelemetry)`` and hands the telemetry to
        ``telemetry_sink(tele, params=, where=)`` when one is given.
        """
        params = params if params is not None else SearchParams()
        if k is not None:
            params = params.replace(k=k)
        dev = self._device(device)
        qd = torch.as_tensor(queries, dtype=torch.float32, device=dev["device"])
        kw = self._search_kwargs(params, device)
        if not params.instrument:
            entries = self.select_entries(
                qd, interpret=params.kernel_interpret, device=device)
            return batched_search(dev["db"], dev["neighbors"], qd, entries,
                                  params, device=device, **kw)
        entries, nav_hops = self.select_entries(
            qd, instrument=True, interpret=params.kernel_interpret, device=device)
        res, tele = batched_search(dev["db"], dev["neighbors"], qd, entries,
                                   params, device=device, **kw)
        tele = tele._replace(nav_hops=nav_hops)
        if telemetry_sink is not None:
            telemetry_sink(tele, params=params, where="GateIndex.search")
        return res, tele

    def search_baseline(
        self,
        queries,
        k: Optional[int] = None,
        *,
        params: Optional[SearchParams] = None,
        entry: str = "medoid",
        telemetry_sink=None,
        device="cuda",
    ):
        """Underlying-index search without GATE (entry ∈ {medoid, random});
        the same ``SearchParams`` / ``telemetry_sink`` contract as ``search``."""
        params = params if params is not None else SearchParams()
        if k is not None:
            params = params.replace(k=k)
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
        if params.instrument and telemetry_sink is not None:
            telemetry_sink(out[1], params=params,
                           where=f"search_baseline({entry})")
        return out
