"""Retrieval-augmented serving parity: ``repro_torch``'s ``ServeEngine``,
``RagPipeline`` and ``ServeDaemon(pipeline=)`` against ``repro``'s, on the
same weights, index and inputs, on the CPU.

The index is ``repro``'s 400-row serving fixture
(``repro.serve.daemon._build_tiny_index``) carried across with
``repro_torch.convert.index_from_numpy``; the LM weights are ``repro``'s
(reduced configs, float32) carried across with ``lm_params_from_numpy``.

Tolerances: generated tokens and retrieved ids equal; last logits within
1e-4 (fp32 sums in another order).  Temperature sampling is held to its own
contract (deterministic per seed), not to ``jax.random``'s draws.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import get_reduced as j_get_reduced
from repro.models.model import build_model as j_build_model
from repro.obs.adaptive import LadderRung as JRung
from repro.serve.daemon import SearchRequest as JRequest
from repro.serve.daemon import ServeDaemon as JDaemon
from repro.serve.daemon import _build_tiny_index
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.retrieval import RagPipeline as JRag

from repro_torch import obs
from repro_torch.configs import get_reduced
from repro_torch.convert import index_from_numpy, lm_params_from_numpy
from repro_torch.obs.adaptive import LadderRung
from repro_torch.serve.daemon import SearchRequest, ServeDaemon
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.retrieval import RagPipeline

from test_torch_search import one_torch_thread  # noqa: F401  (autouse)

LADDER = (LadderRung(8, 32), LadderRung(16, 64))
JLADDER = tuple(JRung(r.beam_width, r.max_hops) for r in LADDER)


def _engines(arch):
    jcfg = j_get_reduced(arch)
    jp = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    cfg = get_reduced(arch)
    tp = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return JEngine(jcfg, jp), ServeEngine(cfg, tp, device="cpu"), cfg


@pytest.fixture(scope="module")
def gemma():
    return _engines("gemma-2b")


@pytest.fixture(scope="module")
def index_pair():
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


def _queries(db, n, seed):
    rng = np.random.default_rng(seed)
    return (db[rng.integers(0, len(db), n)]
            + 0.05 * rng.standard_normal((n, db.shape[1]))).astype(np.float32)


def test_generate_greedy_matches(gemma):
    jeng, eng, cfg = gemma
    prompts = np.random.default_rng(1).integers(
        2, cfg.vocab_size, (3, 12)).astype(np.int32)
    want = jeng.generate({"tokens": jnp.asarray(prompts)}, 6)
    got = eng.generate({"tokens": prompts}, 6)
    assert got.steps == want.steps == 6
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.logits_last, np.asarray(want.logits_last,
                                                           np.float32),
                               rtol=1e-4, atol=1e-4)
    # registry metrics as in repro
    reg = obs.get_registry()
    assert reg.get("serve.tokens").value >= 18
    assert reg.get("serve.tokens_per_sec").value > 0


def test_generate_shape_contract_eos_and_plain(gemma):
    jeng, eng, cfg = gemma
    prompts = np.random.default_rng(3).integers(
        2, cfg.vocab_size, (2, 8)).astype(np.int32)
    plain = eng.generate({"tokens": prompts}, 5)
    assert plain.tokens.shape == (2, 5) and plain.steps == 5
    assert plain.logits_last.shape == (2, cfg.vocab_size)
    assert plain.logits_last.dtype == np.float32
    eos_id = int(plain.tokens[0, 0])
    got = eng.generate({"tokens": prompts}, 5, eos_id=eos_id)
    want = jeng.generate({"tokens": jnp.asarray(prompts)}, 5, eos_id=eos_id)
    assert got.steps == want.steps and 1 <= got.steps <= 5
    assert got.tokens.shape == (2, got.steps)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.logits_last.shape == (2, cfg.vocab_size)
    # every request ends in EOS: the loop stops after the step all did
    first = eng.generate({"tokens": prompts[:1]}, 5, eos_id=eos_id)
    assert first.steps == 1 and first.tokens.shape == (1, 1)


def test_temperature_sampling_is_deterministic_per_seed(gemma):
    _, eng, cfg = gemma
    prompts = np.random.default_rng(4).integers(
        2, cfg.vocab_size, (4, 8)).astype(np.int32)
    a = eng.generate({"tokens": prompts}, 8, temperature=1.5, seed=7)
    b = eng.generate({"tokens": prompts}, 8, temperature=1.5, seed=7)
    c = eng.generate({"tokens": prompts}, 8, temperature=1.5, seed=8)
    greedy = eng.generate({"tokens": prompts}, 8)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert not np.array_equal(a.tokens, c.tokens)
    assert not np.array_equal(a.tokens, greedy.tokens)
    assert ((a.tokens >= 0) & (a.tokens < cfg.vocab_size)).all()


def test_rag_splice_invalid_ids_pad_not_doc0():
    doc_tokens = np.arange(1, 25, dtype=np.int32).reshape(6, 4)  # no zeros
    pipe = RagPipeline(None, None, doc_tokens, k=2, pad_token=0, device="cpu")
    jpipe = JRag(None, None, doc_tokens, k=2, pad_token=0)
    prompts = np.full((2, 3), 99, np.int32)
    ids = np.array([[1, -1], [-1, -1]], np.int32)
    reg = obs.get_registry()
    reg.reset()
    with pytest.warns(RuntimeWarning, match="retrieved ids invalid"):
        out = pipe._splice(prompts, ids)
    with pytest.warns(RuntimeWarning, match="retrieved ids invalid"):
        want = jpipe._splice(prompts, ids)
    np.testing.assert_array_equal(out, want)
    assert out.shape == (2, 2 * 4 + 3) and out.dtype == np.int32
    assert (out[0, 4:8] == 0).all() and (out[1, :8] == 0).all()
    assert reg.get("rag.invalid_ids").value == 3
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        clean = pipe._splice(prompts, np.array([[0, 1], [2, 3]], np.int32))
    np.testing.assert_array_equal(clean[0, :4], doc_tokens[0])
    assert reg.get("rag.invalid_ids").value == 3
    reg.reset()


def test_rag_pipeline_end_to_end_matches(index_pair):
    jidx, tidx = index_pair
    jeng, eng, cfg = _engines("llama3-8b")
    rng = np.random.default_rng(0)
    doc_tokens = rng.integers(2, cfg.vocab_size, (400, 4)).astype(np.int32)
    queries = _queries(jidx.db, 3, seed=2)
    prompts = rng.integers(2, cfg.vocab_size, (3, 8)).astype(np.int32)
    for kernel in ("xla", "fused"):
        jpipe = JRag(jidx, jeng, doc_tokens, k=2, beam_width=16,
                     kernel=kernel)
        pipe = RagPipeline(tidx, eng, doc_tokens, k=2, beam_width=16,
                           kernel=kernel, device="cpu")
        want = jpipe(queries, prompts, max_new_tokens=4)
        got = pipe(queries, prompts, max_new_tokens=4)
        assert got.retrieved_ids.shape == (3, 2)
        np.testing.assert_array_equal(got.retrieved_ids,
                                      np.asarray(want.retrieved_ids))
        np.testing.assert_array_equal(got.generation.tokens,
                                      want.generation.tokens)

    # adaptive wiring: a controller forces instrumentation, each batch lands
    # in its window, and searches run at the controller's rung
    ctl = obs.AdaptiveController(obs.RollingWindow(4), obs.DEFAULT_LADDER,
                                 level=1, registry=obs.MetricsRegistry())
    apipe = RagPipeline(tidx, eng, doc_tokens, k=2, controller=ctl,
                        device="cpu")
    assert apipe.instrument
    sp = apipe.search_params()
    assert (sp.beam_width, sp.max_hops, sp.k) == (16, 96, 2) and sp.instrument
    res = apipe(queries, prompts, max_new_tokens=2)
    assert res.telemetry is not None and len(ctl.window) == 1
    assert "latency_s" in ctl.window._rows()[0]
    want, _ = tidx.search(queries, params=sp, device="cpu")
    np.testing.assert_array_equal(res.retrieved_ids, want.ids.numpy())


def test_rag_pipeline_routed_with_query_log(index_pair, tmp_path):
    _, tidx = index_pair
    from repro_torch.feedback.qlog import QueryLog

    _, eng, cfg = _engines("llama3-8b")
    rng = np.random.default_rng(5)
    doc_tokens = rng.integers(2, cfg.vocab_size, (400, 4)).astype(np.int32)
    router = obs.HardnessRouter(LADDER, batch_size=4,
                                registry=obs.MetricsRegistry())
    qlog = QueryLog(str(tmp_path / "q.jsonl"))
    pipe = RagPipeline(tidx, eng, doc_tokens, k=2, router=router, qlog=qlog,
                       device="cpu")
    res = pipe(_queries(tidx.db, 4, seed=6),
               rng.integers(2, cfg.vocab_size, (4, 5)).astype(np.int32),
               max_new_tokens=2)
    qlog.close()
    assert res.retrieved_ids.shape == (4, 2) and res.telemetry is not None
    assert qlog.written == 1
    assert res.generation.tokens.shape == (4, 2)


def test_daemon_rag_path_matches(index_pair, gemma):
    """``ServeDaemon(pipeline=)`` on the CPU as tests/test_serve_daemon.py
    runs ``repro``'s: the daemon wires its controller into the pipeline and
    a request with prompts is served by the pipeline, which feeds the
    daemon's window.  Ids and tokens equal ``repro``'s daemon's."""
    jidx, tidx = index_pair
    jeng, eng, cfg = gemma
    rng = np.random.default_rng(0)
    doc_tokens = rng.integers(2, cfg.vocab_size, (400, 4)).astype(np.int32)
    pipe = RagPipeline(tidx, eng, doc_tokens, k=2, device="cpu")
    daemon = ServeDaemon(tidx, pipeline=pipe, ladder=LADDER, level=0,
                         batch_size=2, device="cpu")
    jpipe = JRag(jidx, jeng, doc_tokens, k=2)
    jdaemon = JDaemon(jidx, pipeline=jpipe, ladder=JLADDER, level=0,
                      batch_size=2)
    assert pipe.controller is daemon.controller and pipe.instrument
    q = np.asarray(tidx.db[:2])
    prompts = rng.integers(2, cfg.vocab_size, (2, 6)).astype(np.int32)
    daemon.start(warmup=False)
    jdaemon.start(warmup=False)
    try:
        res = daemon.submit(SearchRequest(
            queries=q, k=2, prompt_tokens=prompts, max_new_tokens=3,
        )).get(timeout=120)
        want = jdaemon.submit(JRequest(
            queries=q, k=2, prompt_tokens=prompts, max_new_tokens=3,
        )).get(timeout=120)
        assert res.retrieved_ids.shape == (2, 2)
        assert res.generation.tokens.shape == (2, 3)
        np.testing.assert_array_equal(res.retrieved_ids,
                                      np.asarray(want.retrieved_ids))
        np.testing.assert_array_equal(res.generation.tokens,
                                      want.generation.tokens)
        assert len(daemon.window) == 1
        assert "latency_s" in daemon.window._rows()[0]
        # a request without prompts is a bare search, as before
        bare, tele = daemon.search(q, k=2)
        assert tuple(bare.ids.shape) == (2, 2)
    finally:
        daemon.stop()
        jdaemon.stop()
    jobs.get_registry().reset()
