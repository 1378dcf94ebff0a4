"""Long-running serving daemon: a request queue in front of
``GateIndex.search``, per-request latency into ``LATENCY_BUCKETS``, a rolling
SLO window, an optional adaptive controller or hardness router, and the
whole registry exposed on ``GET /metrics``.

Architecture — one worker thread, everything else observes it:

    submit() ──► queue ──► worker ──► index.search / search_routed
                             │            (current ladder rung, instrumented)
                             ├─► registry   search.latency_seconds, search.*
                             ├─► window     summarize(tele) + latency_s
                             └─► controller / router step() (hysteresis)
    exporter (daemon thread) ◄── /metrics /metrics.json /healthz /debug/telemetry

The worker is single-threaded: the search is itself batched and runs on the
card, so queueing — not thread fan-out — is the concurrency model, and it
keeps ladder stepping race-free.

CLI smoke / load-drive mode (a tiny synthetic index built on ``--device``):

    python -m repro_torch.serve.daemon --n 400 --batches 8 --metrics-port 9100
    curl -s localhost:9100/metrics | grep search_latency_seconds_bucket
"""
from __future__ import annotations

import argparse
import json
import queue
import signal
import threading
import time
import warnings
from dataclasses import dataclass
from typing import Optional, Sequence, Union

import numpy as np

from repro_torch.core.gate_index import GateIndex
from repro_torch.feedback.qlog import QueryLog, ShadowOversearch
from repro_torch.graphs.params import SearchParams
from repro_torch.obs import (
    AdaptiveController,
    DEFAULT_LADDER,
    HardnessRouter,
    LATENCY_BUCKETS,
    LadderRung,
    MetricsExporter,
    RollingWindow,
    chain_sinks,
    get_registry,
    registry_sink,
    summarize,
)


@dataclass
class SearchRequest:
    queries: np.ndarray                        # (B, d)
    k: int = 10
    # per-request search config: overrides the daemon's base SearchParams;
    # the ladder rung / router still set beam_width + max_hops
    params: Optional[SearchParams] = None


class PendingResult:
    """Minimal future: the worker fulfils it, the submitter waits on it."""

    def __init__(self):
        self._done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None

    def _fulfil(self, result=None, error=None):
        self.result = result
        self.error = error
        self._done.set()

    def get(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError("request not served in time")
        if self.error is not None:
            raise self.error
        return self.result


class ServeDaemon:
    """Queue-driven search serving with live metrics and adaptation.

    ``device`` is where the index is searched (default ``"cuda"``).  A
    routed daemon returns ``(SearchResult, SearchTelemetry)`` of host numpy
    arrays per request; an unrouted one the tensors of ``GateIndex.search``.
    """

    def __init__(
        self,
        index: GateIndex,
        *,
        pipeline=None,
        ladder: Sequence[LadderRung] = DEFAULT_LADDER,
        adaptive: bool = True,
        level: Optional[int] = None,
        window_size: int = 16,
        batch_size: int = 16,
        k: int = 10,
        visited_ring: int = 512,
        kernel: str = "xla",
        kernel_interpret: bool = False,
        route: bool = False,
        router_kw: Optional[dict] = None,
        metrics_host: str = "127.0.0.1",
        metrics_port: Optional[int] = None,
        controller_kw: Optional[dict] = None,
        qlog: Optional[Union[QueryLog, str]] = None,
        shadow_every: int = 0,
        predictor_dir: Optional[str] = None,
        window_log_every: int = 8,
        device="cuda",
    ):
        if pipeline is not None:
            raise NotImplementedError(
                "ServeDaemon(pipeline=...): the RAG pipeline and the LM stack "
                "are not ported yet (ROADMAP A7)")
        if predictor_dir is not None:
            raise NotImplementedError(
                "ServeDaemon(predictor_dir=...): predictor hot-reload needs "
                "the hardness-predictor fit, not ported yet (ROADMAP A6)")
        self.index = index
        self.device = device
        self.ladder = tuple(ladder)
        self.adaptive = adaptive
        self.batch_size = batch_size
        self.k = k
        self.visited_ring = visited_ring
        # everything except beam_width/max_hops (those come from the rung or
        # the router side); serving always runs instrumented.  ``kernel``
        # picks the distance path daemon-wide; fused_q8 quantizes the index
        # before traffic arrives.
        self.base_params = SearchParams(
            k=k, visited_ring=visited_ring, instrument=True,
            kernel=kernel, kernel_interpret=kernel_interpret,
        )
        if kernel == "fused_q8":
            index.ensure_quantized()
        self.window = RollingWindow(window_size)
        self.controller = AdaptiveController(
            self.window, self.ladder, level=level, **(controller_kw or {})
        )
        # per-query routing replaces per-batch ladder stepping: the router
        # owns adaptation (hard_frac), the controller stays idle
        self.router = (
            HardnessRouter(self.ladder, batch_size=batch_size,
                           **(router_kw or {}))
            if route
            else None
        )
        # feedback loop: query-log capture + shadow labeling
        self.qlog = QueryLog(qlog) if isinstance(qlog, str) else qlog
        self.shadow = (
            ShadowOversearch(index, self.router, every=shadow_every,
                             device=device)
            if shadow_every > 0 and self.router is not None
            else None
        )
        self.window_log_every = max(1, window_log_every)
        self._routed_sink = (
            chain_sinks(registry_sink, self.qlog.sink)
            if self.qlog is not None
            else registry_sink
        )
        self.exporter = (
            MetricsExporter(window=self.window, host=metrics_host,
                            port=metrics_port)
            if metrics_port is not None
            else None
        )
        self._queue: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._worker: Optional[threading.Thread] = None
        self._reg = get_registry()
        self._batches_served = 0

    # ------------------------------------------------------------- lifecycle
    def start(self, warmup: bool = True) -> Optional[int]:
        """Warm the ladder, start exporter + worker; returns metrics port."""
        port = self.exporter.start() if self.exporter is not None else None
        if warmup:
            if self.router is not None:
                self.index.warmup_router(self.router, params=self.base_params,
                                         device=self.device)
            else:
                rungs = (self.ladder if self.adaptive
                         else (self.controller.params,))
                self.index.warmup_ladder(
                    rungs, batch_size=self.batch_size,
                    params=self.base_params, device=self.device,
                )
        self._stop.clear()
        self._worker = threading.Thread(
            target=self._run, name="serve-daemon-worker", daemon=True
        )
        self._worker.start()
        return port

    def stop(self, timeout: float = 10.0) -> None:
        """Graceful shutdown: drain the worker, flush + fsync the query-log
        tail, close the exporter — safe to call twice, and what the CLI's
        SIGTERM/SIGINT handler runs."""
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout)
            self._worker = None
        if self.qlog is not None:
            self.qlog.close()
        if self.exporter is not None:
            self.exporter.stop()

    # ------------------------------------------------------------ hot-reload
    def reload_predictor(self):
        """The POST /reload hook in ``repro``: it needs the hardness
        predictor fit, which is not ported yet."""
        raise NotImplementedError(
            "ServeDaemon.reload_predictor: the hardness-predictor fit "
            "(feedback/fit.py) is not ported yet (ROADMAP A6)")

    def __enter__(self) -> "ServeDaemon":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -------------------------------------------------------------- requests
    def submit(self, req: SearchRequest) -> PendingResult:
        pending = PendingResult()
        self._queue.put((req, pending))
        if self._reg.enabled:
            self._reg.gauge(
                "daemon.queue_depth", "requests waiting in the daemon queue"
            ).set(self._queue.qsize())
        return pending

    def search(self, queries: np.ndarray, k: Optional[int] = None,
               timeout: float = 60.0):
        """Synchronous convenience wrapper around submit()."""
        return self.submit(
            SearchRequest(queries=queries, k=k if k is not None else self.k)
        ).get(timeout)

    # ---------------------------------------------------------------- worker
    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                req, pending = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            t0 = time.perf_counter()
            try:
                result = self._serve_one(req)
            except BaseException as e:  # noqa: BLE001 — surfaced via future
                self._reg.counter(
                    "daemon.errors", "requests that raised"
                ).inc()
                pending._fulfil(error=e)
                continue
            dt = time.perf_counter() - t0
            if self._reg.enabled:
                self._reg.histogram(
                    "search.latency_seconds",
                    "end-to-end request latency (daemon)",
                    LATENCY_BUCKETS,
                ).observe(dt)
                self._reg.counter("daemon.requests", "served requests").inc()
                self._reg.counter(
                    "daemon.queries", "served queries"
                ).inc(len(req.queries))
                self._reg.gauge(
                    "daemon.queue_depth",
                    "requests waiting in the daemon queue",
                ).set(self._queue.qsize())
            pending._fulfil(result=result)

    def _serve_one(self, req: SearchRequest):
        base = req.params if req.params is not None else self.base_params
        base = base.replace(k=req.k, instrument=True)
        t0 = time.perf_counter()
        if self.router is not None:
            res, report = self.index.search_routed(
                req.queries, router=self.router, params=base,
                telemetry_sink=self._routed_sink, device=self.device,
            )
            tele = report.telemetry
        else:
            res, tele = self.index.search(
                req.queries, params=self.controller.params.params(base),
                device=self.device,
            )
        # summarize copies the telemetry to the host: the latency below is
        # that of a finished search, not of its enqueueing
        s = summarize(tele)
        s["latency_s"] = time.perf_counter() - t0
        self.window.push(s)
        self._batches_served += 1
        if self.router is not None:
            if self.qlog is not None:
                # the sink logged this batch; attach what's only known now
                self.qlog.annotate_last(latency_s=s["latency_s"])
                if self.shadow is not None:
                    needed = self.shadow.maybe_label(req.queries, base)
                    if needed is not None:
                        self.qlog.annotate_last(needed_wide=needed)
                if self._batches_served % self.window_log_every == 0:
                    self.qlog.log_window(self.window, name="serve")
            self.router.step()
        elif self.adaptive:
            self.controller.step()
        return res, tele


# --------------------------------------------------------------------- CLI
def _build_tiny_index(n: int, profile: str, seed: int, device="cuda") -> GateIndex:
    from repro_torch.core.gate_index import GateConfig
    from repro_torch.data.synthetic import make_database, make_queries_in_dist
    from repro_torch.graphs.nsg import build_nsg

    db, _ = make_database(profile, n, seed=seed)
    nsg = build_nsg(db, R=12, knn_k=12, search_l=16, pool_size=32, device=device)
    tq = make_queries_in_dist(db, 64, seed=seed + 1)
    return GateIndex.from_graph(
        db, nsg.neighbors, nsg.enter_id, tq,
        GateConfig(n_hubs=8, epochs=4, batch_hubs=8, subgraph_max_nodes=32,
                   seed=seed),
        device=device,
    )


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="GATE serving daemon with /metrics + adaptive search"
    )
    ap.add_argument("--n", type=int, default=400,
                    help="synthetic database size")
    ap.add_argument("--profile", default="sift10m-like")
    ap.add_argument("--batch", type=int, default=16,
                    help="queries per request batch")
    ap.add_argument("--batches", type=int, default=8,
                    help="synthetic request batches to drive")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--ood-every", type=int, default=0,
                    help="every Nth batch is out-of-distribution (0 = never)")
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="0 = ephemeral (printed at startup)")
    ap.add_argument("--serve-seconds", type=float, default=0.0,
                    help="keep serving /metrics this long after the drive "
                         "loop (Ctrl-C exits early)")
    ap.add_argument("--kernel", default="xla",
                    choices=("xla", "fused", "fused_q8"),
                    help="distance path: xla = plain gather and score, "
                         "fused = the gather kernel, fused_q8 = the int8 "
                         "codebook kernel + exact rerank")
    ap.add_argument("--kernel-interpret", action="store_true",
                    help="run the kernels' plain versions")
    ap.add_argument("--no-adaptive", dest="adaptive", action="store_false")
    ap.add_argument("--route", action="store_true",
                    help="per-query hardness routing over the ladder "
                         "instead of per-batch adaptation")
    ap.add_argument("--qlog", default=None,
                    help="JSONL query-log path (routed mode)")
    ap.add_argument("--shadow-every", type=int, default=0,
                    help="shadow-oversearch every Nth batch for "
                         "needed-wide-beam labels (0 = off)")
    ap.add_argument("--device", default="cuda",
                    help="where the index is built and searched")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    # the daemon itself must use the SearchParams API: a deprecated-kwarg
    # use from within repro_torch is an error here, not a warning
    warnings.filterwarnings(
        "error", category=DeprecationWarning, module=r"repro_torch(\..*)?"
    )

    from repro_torch.data.synthetic import make_queries_in_dist, make_queries_ood

    print(f"[daemon] building index (n={args.n}, {args.profile}, "
          f"{args.device}) ...", flush=True)
    index = _build_tiny_index(args.n, args.profile, args.seed, args.device)
    daemon = ServeDaemon(
        index, adaptive=args.adaptive, batch_size=args.batch, k=args.k,
        kernel=args.kernel, kernel_interpret=args.kernel_interpret,
        route=args.route, metrics_port=args.metrics_port,
        qlog=args.qlog, shadow_every=args.shadow_every, device=args.device,
    )

    # graceful shutdown on SIGTERM too: the handler raises so the finally
    # block flushes/fsyncs the query log
    def _sigterm(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _sigterm)
    port = daemon.start()
    print(f"[daemon] metrics on http://127.0.0.1:{port}/metrics", flush=True)
    print("[daemon] ready", flush=True)

    try:
        for i in range(args.batches):
            hard = args.ood_every and (i + 1) % args.ood_every == 0
            maker = make_queries_ood if hard else make_queries_in_dist
            q = maker(index.db, args.batch, seed=args.seed + 10 + i)
            _res, tele = daemon.search(q)
            if daemon.router is not None:
                r = daemon.router
                mode = (f"easy={r.easy_rung.beam_width} "
                        f"hard={r.hard_rung.beam_width} "
                        f"hard_frac={r.hard_frac:.2f}")
            else:
                rung = daemon.controller.params
                mode = f"beam={rung.beam_width} max_hops={rung.max_hops}"
            print(
                f"[daemon] batch {i + 1}/{args.batches} "
                f"({'ood' if hard else 'in-dist'}) {mode} "
                f"mean_hops={summarize(tele)['mean_hops']:.1f}",
                flush=True,
            )
        if args.serve_seconds > 0:
            print(f"[daemon] serving /metrics for {args.serve_seconds:.0f}s "
                  f"(Ctrl-C to exit)", flush=True)
            time.sleep(args.serve_seconds)
    except KeyboardInterrupt:
        print("[daemon] interrupted", flush=True)
    finally:
        snap = daemon.window.snapshot()
        daemon.stop()
        print("[daemon] final window: " + json.dumps(snap), flush=True)
        if daemon.qlog is not None:
            print(f"[daemon] query log: {daemon.qlog.written} records "
                  f"({daemon.qlog.bytes_written} bytes, "
                  f"{daemon.qlog.dropped} dropped) -> {daemon.qlog.path}",
                  flush=True)
        print("[daemon] shut down cleanly", flush=True)


if __name__ == "__main__":
    main()
