"""Serving parity: ``repro_torch``'s registry, window, trace, adaptive
controller, hardness router, query log, ``GateIndex`` routing and
``ServeDaemon`` against ``repro``'s, on the same inputs, on the CPU.

The index is ``repro``'s own 400-row serving fixture
(``repro.serve.daemon._build_tiny_index``), carried across with
``repro_torch.convert.index_from_numpy``.  ``repro`` runs its Pallas kernels
in interpret mode where a kernel is reached.

Tolerances: decisions, counters, ids, entries, nav_hops and hops are equal;
hardness and route features within 1e-5 (fp32 sums in another order);
search distances within 1e-5, as tests/test_torch_gate_index.py holds them.
"""
import dataclasses
import json
import urllib.request
import warnings

import jax
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.feedback.qlog import QueryLog as JQueryLog
from repro.feedback.qlog import ShadowOversearch as JShadow
from repro.graphs.params import SearchParams as JParams
from repro.obs.adaptive import LadderRung as JRung
from repro.serve.daemon import _build_tiny_index

from repro_torch import obs
from repro_torch.convert import index_from_numpy
from repro_torch.feedback.qlog import QueryLog, ShadowOversearch
from repro_torch.graphs import params as tparams
from repro_torch.graphs.params import SearchParams
from repro_torch.obs.adaptive import LadderRung
from repro_torch.serve.daemon import SearchRequest, ServeDaemon

from test_torch_search import one_torch_thread  # noqa: F401  (autouse)

LADDER = (LadderRung(8, 32), LadderRung(16, 64), LadderRung(32, 128))
JLADDER = tuple(JRung(r.beam_width, r.max_hops) for r in LADDER)


@pytest.fixture(scope="module")
def pair():
    """repro's serving fixture and the same index carried into the port."""
    jidx = _build_tiny_index(400, "sift10m-like", seed=0)
    state = {
        "db": jidx.db, "neighbors": jidx.neighbors, "enter_id": jidx.enter_id,
        "hubs": (jidx.hubs.ids, jidx.hubs.assign, jidx.hubs.centroids),
        "tower_params": jax.tree.map(np.asarray, jidx.tower_params),
        "tower_cfg": dataclasses.asdict(jidx.tower_cfg),
        "gcfg": dataclasses.asdict(jidx.gcfg),
        "nav": (jidx.nav.neighbors, jidx.nav.reps, jidx.nav.start),
        "build_report": jidx.build_report,
        "quant": None,
    }
    return jidx, index_from_numpy(state, device="cpu")


def _queries(idx, n, seed, noise=0.05):
    rng = np.random.default_rng(seed)
    return (idx.db[rng.integers(0, len(idx.db), n)]
            + noise * rng.standard_normal((n, idx.db.shape[1]))
            ).astype(np.float32)


def _summary(rng, hard: bool):
    return {
        "queries": int(rng.integers(8, 64)),
        "latency_s": float(rng.uniform(1e-3, 1e-1)),
        "mean_hops": 40.0,
        "mean_dist_evals": float(rng.uniform(100, 900)),
        "mean_converged_hop": 39.0 if hard else 8.0,
        "mean_nav_hops": 1.0,
        "mean_entry_rank_proxy": float(rng.uniform(1, 20)),
        "p95_entry_rank_proxy": 40.0 if hard else 1.5,
        "ring_evictions_total": int(hard) * 3,
        "ring_overflow_queries": int(hard) * 2,
    }


def _tele_pair(rng, B):
    """The same random telemetry as repro's and the port's NamedTuple."""
    fields = dict(
        hops=rng.integers(0, 300, B).astype(np.int32),
        dist_evals=rng.integers(0, 5000, B).astype(np.int32),
        ring_evictions=(rng.random(B) < 0.2).astype(np.int32) * 3,
        converged_hop=rng.integers(0, 100, B).astype(np.int32),
        nav_hops=rng.integers(0, 9, B).astype(np.int32),
        entry_dist=rng.uniform(0, 9, B).astype(np.float32),
        entry_rank_proxy=rng.uniform(1, 900, B).astype(np.float32),
        bytes_read=rng.uniform(0, 1e7, B).astype(np.float32),
    )
    return jobs.SearchTelemetry(**fields), obs.SearchTelemetry(**fields)


# ------------------------------------------------------ registry and window
def test_registry_exports_equal_repros():
    regs = (jobs.MetricsRegistry(), obs.MetricsRegistry())
    rng = np.random.default_rng(0)
    vals = rng.exponential(3.0, 500)
    for reg in regs:
        reg.counter("a.count", "a counter").inc(3)
        reg.gauge("b-gauge", "a gauge").set(-2.5)
        h = reg.histogram("lat.seconds", "latency", obs.LATENCY_BUCKETS)
        for v in vals[:50]:
            h.observe(v)
        h.observe_many(vals[50:])
        reg.histogram("1hops", "pow2").observe_many(rng.integers(0, 99, 7))
        rng = np.random.default_rng(0)  # same draws for the second registry
        rng.exponential(3.0, 500)
    assert regs[1].to_prometheus() == regs[0].to_prometheus()
    assert regs[1].to_json() == regs[0].to_json()
    assert regs[1].get("lat.seconds").quantile(0.9) == regs[0].get(
        "lat.seconds").quantile(0.9)
    regs[1].disable()
    regs[1].counter("a.count").inc(5)
    assert regs[1].get("a.count").value == 3


def test_record_search_telemetry_equals_repros():
    regs = (jobs.MetricsRegistry(), obs.MetricsRegistry())
    jt, tt = _tele_pair(np.random.default_rng(1), 64)
    jobs.record_search_telemetry(jt, regs[0], prefix="search")
    obs.record_search_telemetry(tt, regs[1], prefix="search")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        n = obs.warn_on_ring_overflow(tt, 512, registry=regs[1])
        assert n == jobs.warn_on_ring_overflow(jt, 512, registry=regs[0]) > 0
    assert any("visited-ring overflow" in str(w.message) for w in caught)
    assert regs[1].to_prometheus() == regs[0].to_prometheus()
    assert obs.summarize(tt) == jobs.summarize(jt)


def test_window_snapshots_equal_repros():
    rng = np.random.default_rng(2)
    rows = [_summary(rng, hard=bool(i % 3 == 0)) for i in range(40)]
    rows[5]["recall"] = 0.9
    rows[6].pop("latency_s")
    jw, tw = jobs.RollingWindow(16), obs.RollingWindow(16)
    for r in rows:
        jw.push(r)
        tw.push(r)
        assert tw.snapshot() == jw.snapshot()
    assert tw.to_dict() == jw.to_dict()
    assert obs.RollingWindow.from_json(tw.to_json()).snapshot() == tw.snapshot()


def test_span_trace_file(tmp_path):
    tracer = obs.get_tracer()
    path = tmp_path / "trace.json"
    tracer.start(str(path))
    try:
        with obs.span("outer", n=3):
            with obs.span("inner"):
                pass
    finally:
        tracer.stop()
    events = obs.read_trace(str(path))
    assert [e["name"] for e in events] == ["inner", "outer"]
    assert events[1]["args"] == {"n": 3}
    assert tracer.span_summary()["outer"]["count"] == 1
    with obs.span("disabled"):  # tracing off: records nothing
        pass
    assert "disabled" not in tracer.span_summary()


# -------------------------------------------------- adaptive and the router
def test_adaptive_controller_moves_as_repros():
    rng = np.random.default_rng(3)
    kw = dict(level=1, patience=2, cooldown=1, min_batches=2)
    regs = (jobs.MetricsRegistry(), obs.MetricsRegistry())
    jc = jobs.AdaptiveController(jobs.RollingWindow(4), JLADDER,
                                 registry=regs[0], **kw)
    tc = obs.AdaptiveController(obs.RollingWindow(4), LADDER,
                                registry=regs[1], **kw)
    pattern = [True] * 9 + [False] * 14 + [True] * 5
    levels = []
    for hard in pattern:
        s = _summary(rng, hard)
        jc.window.push(s)
        tc.window.push(s)
        jr, tr = jc.step(), tc.step()
        assert (tr.beam_width, tr.max_hops) == (jr.beam_width, jr.max_hops)
        levels.append(tc.level)
        assert tc.decide(tc.window.snapshot()) == jc.decide(jc.window.snapshot())
    assert len(set(levels)) > 1  # it moved
    assert [h["to"] for h in tc.history] == [h["to"] for h in jc.history]
    assert regs[1].to_prometheus() == regs[0].to_prometheus()
    p = LadderRung(16, 64).params(SearchParams(k=5, metric="cosine"))
    assert (p.beam_width, p.max_hops, p.k, p.metric) == (16, 64, 5, "cosine")


def test_router_splits_and_adapts_as_repros():
    assert all(obs.route_buckets(b) == jobs.route_buckets(b)
               for b in (1, 7, 48, 64, 1000, 1024))
    rng = np.random.default_rng(4)
    kw = dict(batch_size=32, hard_frac=0.25, min_batches=2, patience=1,
              cooldown=1, history=200)
    regs = (jobs.MetricsRegistry(), obs.MetricsRegistry())
    jr = jobs.HardnessRouter(JLADDER, registry=regs[0], **kw)
    tr = obs.HardnessRouter(LADDER, registry=regs[1], **kw)
    for i in range(30):
        h = rng.standard_normal(32) + (3.0 if i % 7 == 0 else 0.0)
        je, jh, jthr = jr.split(h)
        te, th, tthr = tr.split(h)
        assert tthr == jthr
        np.testing.assert_array_equal(te, je)
        np.testing.assert_array_equal(th, jh)
        assert tr.bucket(te.size) == jr.bucket(je.size)
        hard_side = i < 12
        for router, report_cls, rung in ((jr, jobs.RouteReport, JLADDER),
                                         (tr, obs.RouteReport, LADDER)):
            router.observe(report_cls(
                telemetry=None, easy_idx=te, hard_idx=th, threshold=tthr,
                easy_rung=rung[0], hard_rung=rung[-1],
                easy_summary=_summary(np.random.default_rng(i), hard_side),
                hard_summary=_summary(np.random.default_rng(i), hard_side),
                easy_padded=tr.bucket(te.size), hard_padded=tr.bucket(th.size),
            ))
        assert tr.step() == jr.step()
    assert tr.history_moves == jr.history_moves and tr.history_moves
    assert regs[1].to_prometheus() == regs[0].to_prometheus()


def test_search_params_shim_warns_once_and_counts():
    tparams.reset_deprecation_state()
    reg = obs.get_registry()
    before = (reg.get("api.deprecated_kwargs").value
              if "api.deprecated_kwargs" in reg else 0.0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(2):
            p = tparams.resolve_search_params(
                "f", SearchParams(k=3), {"beam_width": 16}, k=7)
    assert (p.k, p.beam_width) == (7, 16)
    assert sum(issubclass(w.category, DeprecationWarning) for w in caught) == 1
    assert "called from" in str(caught[0].message)
    assert reg.get("api.deprecated_kwargs").value == before + 2
    with pytest.raises(TypeError, match="unexpected keyword"):
        tparams.resolve_search_params("f", None, {"bogus": 1})


# ------------------------------------------------------- GateIndex routing
@pytest.mark.parametrize("entry_path", ["flat_score", "nav_descent"])
def test_route_signals_equal_repros(pair, entry_path):
    jidx, tidx = pair
    limit = 128 if entry_path == "flat_score" else 4  # n_hubs = 8
    for idx in pair:
        idx.gcfg = dataclasses.replace(idx.gcfg, flat_score_max=limit)
    try:
        q = _queries(jidx, 24, seed=5)
        je, jn, jh, jf = jidx.route_signals(q, with_features=True)
        te, tn, th, tf = tidx.route_signals(q, with_features=True, device="cpu")
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(
            te.numpy(), tidx.select_entries(q, device="cpu").numpy())
        if entry_path == "nav_descent":
            assert tn.max() > 0
    finally:
        for idx in pair:
            idx.gcfg = dataclasses.replace(idx.gcfg, flat_score_max=128)


def test_routed_bit_identical_to_unrouted_same_rung(pair):
    """Both sides at one rung: the split, the bucket padding and the
    scatter-merge are invisible, and the ids are repro's."""
    jidx, tidx = pair
    reg = obs.MetricsRegistry()
    router = obs.HardnessRouter(LADDER, batch_size=32, easy_level=2,
                                hard_level=2, registry=reg)
    base = SearchParams(k=5, instrument=True, kernel="fused")
    assert tidx.warmup_router(router, params=base, device="cpu") == len(router.buckets)
    q = _queries(tidx, 32, seed=6)
    routed, report = tidx.search_routed(q, router=router, params=base,
                                        telemetry_sink=None, device="cpu")
    plain, _ = tidx.search(q, params=LADDER[2].params(base),
                           telemetry_sink=None, device="cpu")
    assert report.easy_idx.size + report.hard_idx.size == 32
    assert report.easy_idx.size and report.hard_idx.size
    np.testing.assert_array_equal(routed.ids, plain.ids.numpy())
    np.testing.assert_array_equal(routed.dists, plain.dists.numpy())
    np.testing.assert_array_equal(routed.hops, plain.hops.numpy())
    jrouter = jobs.HardnessRouter(JLADDER, batch_size=32, easy_level=2,
                                  hard_level=2, registry=jobs.MetricsRegistry())
    jrouted, jreport = jidx.search_routed(
        q, router=jrouter, params=JParams(k=5, instrument=True, kernel="fused",
                                          kernel_interpret=True),
        telemetry_sink=None)
    np.testing.assert_array_equal(report.easy_idx, jreport.easy_idx)
    np.testing.assert_array_equal(routed.ids, np.asarray(jrouted.ids))
    np.testing.assert_allclose(routed.dists, np.asarray(jrouted.dists),
                               rtol=1e-5, atol=1e-5)
    assert reg.get("search.routed_batches").value == 1


def test_bucket_padding_never_changes_topk(pair):
    """Odd sub-batch sizes force pad lanes, which repeat the side's first
    query; each query's result equals a search of its side alone."""
    _, tidx = pair
    router = obs.HardnessRouter(LADDER, batch_size=32, easy_level=0,
                                hard_level=2, hard_frac=0.3,
                                registry=obs.MetricsRegistry())
    base = SearchParams(k=5, instrument=True)
    for bsz in (5, 11, 17, 29):
        q = np.random.default_rng(bsz).standard_normal(
            (bsz, tidx.db.shape[1])).astype(np.float32)
        routed, report = tidx.search_routed(q, router=router, params=base,
                                            telemetry_sink=None, device="cpu")
        for idx, rung, m in ((report.easy_idx, report.easy_rung,
                              report.easy_padded),
                             (report.hard_idx, report.hard_rung,
                              report.hard_padded)):
            if idx.size == 0:
                continue
            assert m >= idx.size
            ref, _ = tidx.search(q[idx], params=rung.params(base),
                                 telemetry_sink=None, device="cpu")
            w = ref.ids.shape[1]
            np.testing.assert_array_equal(routed.ids[idx][:, :w], ref.ids.numpy())


def test_search_defaults_to_the_registry_sink(pair):
    _, tidx = pair
    reg = obs.get_registry()
    reg.reset()
    sp = SearchParams(k=5, beam_width=8, max_hops=32, instrument=True)
    q = _queries(tidx, 6, seed=7)
    tidx.search(q, params=sp, device="cpu")
    assert reg.get("search.queries").value == 6
    assert reg.get("search.hops").count == 6
    tidx.search(q, params=sp, telemetry_sink=None, device="cpu")
    assert reg.get("search.queries").value == 6
    tidx.search_baseline(q, params=sp, device="cpu")
    assert reg.get("search_baseline.medoid.queries").value == 6
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        res, _ = tidx.search(q, params=sp, record=False, device="cpu")
    assert reg.get("search.queries").value == 6
    assert tidx.warmup_ladder(LADDER, batch_size=4, device="cpu") == 3
    assert reg.get("search.queries").value == 6  # warm-up records nothing


# -------------------------------------------------- query log and shadowing
def test_query_log_records_equal_repros(tmp_path, pair):
    jidx, tidx = pair
    jlog = JQueryLog(str(tmp_path / "j.jsonl"), flush_every=2)
    tlog = QueryLog(str(tmp_path / "t.jsonl"), flush_every=2)
    jt, tt = _tele_pair(np.random.default_rng(8), 16)
    for i in range(5):
        jlog.sink(jt, params=JParams(k=5), where="w")
        tlog.sink(tt, params=SearchParams(k=5), where="w")
        jlog.annotate_last(latency_s=0.5 * i)
        tlog.annotate_last(latency_s=0.5 * i)
    jlog.close()
    tlog.close()
    read = lambda p: [json.loads(x) for x in p.read_text().splitlines()]  # noqa: E731
    assert read(tmp_path / "t.jsonl") == read(tmp_path / "j.jsonl")
    assert tlog.written == 5 and len(tlog) == 5
    bounded = QueryLog(None, max_records=2, registry=obs.MetricsRegistry())
    assert [bounded.log({"x": i}) for i in range(3)] == [True, True, False]
    assert bounded.dropped == 1
    # shadow labels: the easy rung's top-k against the hard rung's
    q = _queries(tidx, 16, seed=9)
    rkw = dict(batch_size=16, easy_level=0, hard_level=2)
    tsh = ShadowOversearch(tidx, obs.HardnessRouter(LADDER, **rkw), every=2,
                           registry=obs.MetricsRegistry(), device="cpu")
    jsh = JShadow(jidx, jobs.HardnessRouter(JLADDER, **rkw), every=2,
                  registry=jobs.MetricsRegistry())
    base = SearchParams(k=5, instrument=True)
    got = tsh.maybe_label(q, base)
    want = jsh.maybe_label(q, JParams(k=5, instrument=True))
    np.testing.assert_array_equal(got, want)
    assert tsh.maybe_label(q, base) is None  # off-cycle


# ------------------------------------------------------------------ daemon
def test_daemon_serves_exports_metrics_and_adapts(pair):
    _, tidx = pair
    obs.get_registry().reset()
    daemon = ServeDaemon(tidx, ladder=LADDER, level=0, batch_size=8, k=5,
                         metrics_port=0, window_size=4, device="cpu",
                         controller_kw=dict(min_batches=1, patience=1))
    port = daemon.start()
    assert port and daemon.exporter.running
    try:
        for i in range(4):
            rung = daemon.controller.params
            q = _queries(tidx, 8, seed=10 + i)
            res, tele = daemon.search(q)
            assert tuple(res.ids.shape) == (8, 5)
            want, _ = tidx.search(q, params=rung.params(daemon.base_params.replace(k=5)),
                                  telemetry_sink=None, device="cpu")
            assert torch.equal(res.ids, want.ids)  # served at its rung
        base = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(f"{base}/metrics", timeout=5) as r:
            text = r.read().decode()
        assert "search_latency_seconds_bucket" in text
        assert "search_latency_seconds_count 4" in text
        assert "search_hops_bucket" in text
        assert "daemon_requests 4" in text
        assert "daemon_queries 32" in text
        with urllib.request.urlopen(f"{base}/debug/telemetry", timeout=5) as r:
            snap = json.loads(r.read().decode())
        assert snap["total_pushed"] == 4  # a ladder move clears the window
        with urllib.request.urlopen(f"{base}/healthz", timeout=5) as r:
            assert r.status == 200
    finally:
        daemon.stop()
    assert not daemon.exporter.running


def test_routed_daemon_writes_the_query_log(tmp_path, pair):
    _, tidx = pair
    obs.get_registry().reset()
    path = tmp_path / "qlog.jsonl"
    daemon = ServeDaemon(tidx, ladder=LADDER, batch_size=16, k=5, route=True,
                         qlog=str(path), shadow_every=2, window_log_every=2,
                         device="cpu")
    daemon.start()
    try:
        for i in range(4):
            res, tele = daemon.search(_queries(tidx, 16, seed=20 + i))
            assert res.ids.shape == (16, 5) and (res.ids >= 0).all()
        bad = SearchRequest(queries=np.zeros((2,)), k=5)  # wrong rank
        with pytest.raises(Exception):
            daemon.submit(bad).get(timeout=30)
    finally:
        daemon.stop()
    recs = [json.loads(x) for x in path.read_text().splitlines()]
    batches = [r for r in recs if r["kind"] == "batch"]
    assert len(batches) == 4
    assert sum(r["kind"] == "window" for r in recs) == 2
    assert all("latency_s" in r and "route" in r for r in batches)
    assert sum("needed_wide" in r for r in batches) == 2
    assert obs.get_registry().get("search.routed_batches").value == 4
    assert obs.get_registry().get("daemon.errors").value == 1


def test_daemon_unported_parts_raise(pair):
    _, tidx = pair
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        ServeDaemon(tidx, pipeline=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        ServeDaemon(tidx, route=True, predictor_dir="/nonexistent", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        ServeDaemon(tidx, route=True, device="cpu").reload_predictor()
