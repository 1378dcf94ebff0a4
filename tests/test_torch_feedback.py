"""Feedback-loop parity: ``repro_torch.feedback`` (replay, dataset, AUC,
calibration, the hardness-predictor fit and its artifacts, the CLI) and the
daemon's predictor hot reload, against ``repro.feedback`` on the CPU.

The query log is captured once from ``repro``'s routed search over its
400-row serving fixture (``tests/test_torch_serve.py``'s ``pair``), with a
shadow label on every batch, exactly as ``tests/test_feedback.py`` captures
one.

Tolerances: replay dicts, datasets, AUC, calibration and predictor scores
are exactly equal (the same NumPy code on the same inputs).  The training
loop runs fp32 in PyTorch against fp32 in JAX, started from ``repro``'s own
init.  Adam divides each step by the gradient's running RMS, so a rounding
difference in a small gradient moves a parameter by a step's size, and the
MLP drifts along directions the loss does not see (measured on this log,
largest parameter difference: logistic 1.5e-6 at any epoch count; MLP
1.7e-6 after 100 steps, 1.2e-5 after 200, 2.4e-4 after 400, with the final
loss equal to within one fp32 ulp).  So: logistic at the default 400 steps
and the MLP at 100 within 1e-5, the MLP at 400 within 1e-3, the loss and
the training AUC within 1e-5.
"""
import json
import urllib.request

import jax
import numpy as np
import pytest
import torch

from repro.feedback import fit as jfit
from repro.feedback import replay as jreplay

from repro_torch import obs
from repro_torch.feedback import fit as tfit
from repro_torch.feedback import replay as treplay
from repro_torch.obs.adaptive import LadderRung
from repro_torch.serve.daemon import ServeDaemon

from test_feedback import capture_log
from test_torch_search import one_torch_thread  # noqa: F401  (autouse)
from test_torch_serve import _queries, pair  # noqa: F401  (fixture)

LADDER = (LadderRung(8, 32), LadderRung(16, 64), LadderRung(32, 128))


@pytest.fixture(scope="module")
def log_path(pair, tmp_path_factory):  # noqa: F811
    """A log of 8 routed batches of 16 from ``repro``, every batch labeled,
    with a torn last line (a killed writer's)."""
    jidx, _ = pair
    path = tmp_path_factory.mktemp("qlog") / "q.jsonl"
    capture_log(jidx, str(path), rounds=8).close()
    with open(path, "a") as f:
        f.write('{"kind": "batch", "seq": 99, "sig')
    return str(path)


@pytest.fixture(scope="module")
def records(log_path):
    return treplay.read_log(log_path)


def _synthetic_records(seed=0, n_batches=8, batch=16):
    """Labels that follow the first feature: a separable fit."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        feats = rng.standard_normal((batch, len(tfit.FEATURE_NAMES)))
        out.append({
            "kind": "batch", "seq": b, "batch": batch,
            "signals": {"features": feats.tolist(),
                        "hardness": feats[:, 0].tolist()},
            "route": {"easy_idx": [], "hard_idx": list(range(batch)),
                      "threshold": 0.0},
            "needed_wide": (feats[:, 0] > 0.3).tolist(),
        })
    return out


# -------------------------------------------------------------------- replay
def test_read_log_skips_the_torn_tail(log_path, records):
    assert records == jreplay.read_log(log_path)
    assert len(treplay.batch_records(records)) == 8
    assert treplay.batch_records(records) == jreplay.batch_records(records)
    assert all("seq" not in r or r["seq"] != 99 for r in records)


@pytest.mark.parametrize("hard_frac,history", [(0.25, 1024), (0.1, 16),
                                               (0.6, 1024)])
def test_replay_routing_equals_reference_and_is_deterministic(
        records, hard_frac, history):
    kw = dict(hard_frac=hard_frac, history=history)
    got = treplay.replay_routing(records, **kw)
    assert got == jreplay.replay_routing(records, **kw)
    assert got == treplay.replay_routing(records, **kw)
    assert got["batches"] == 8 and got["labeled"] == 8 * 16
    assert got["regret"] is not None


def test_replay_compare_equals_reference(records):
    pred = jfit.fit_from_records(records, epochs=100)
    got = treplay.replay_compare(records, pred)
    assert got == jreplay.replay_compare(records, pred)
    assert got == treplay.replay_compare(records, pred)
    assert got["oracle"]["regret"] == 0.0
    # a learned scorer replays through the port's own predictor too
    port_pred = tfit.HardnessPredictor(**{
        f: getattr(pred, f) for f in ("model", "params", "mu", "sigma",
                                      "calibration")})
    assert treplay.replay_compare(records, port_pred) == got
    with pytest.raises(ValueError, match="hard_frac"):
        treplay.replay_routing(records, hard_frac=1.0)


# ------------------------------------------------- dataset, AUC, calibration
def test_dataset_auc_and_calibrate_equal_reference(records):
    X, y = tfit.dataset_from_records(records)
    jX, jy = jfit.dataset_from_records(records)
    assert X.dtype == jX.dtype and np.array_equal(X, jX)
    assert np.array_equal(y, jy) and X.shape == (8 * 16, 3)
    for scores in (X[:, 0], -X[:, 1], np.zeros(len(y))):
        assert tfit.auc_score(scores, y) == jfit.auc_score(scores, y)
    assert tfit.auc_score(X[:, 0], np.zeros(len(y), bool)) is None
    cal = tfit.calibrate(records)
    assert cal == jfit.calibrate(records)
    assert cal["windows"] == 2 and "policy" in cal
    for kw in (dict(frac_margin=2.0), dict(frac_floor=0.3, frac_ceil=0.4)):
        assert tfit.calibrate(records, **kw) == jfit.calibrate(records, **kw)
    empty = tfit.dataset_from_records([{"kind": "window"}])
    assert empty[0].shape == (0, 3) and empty[1].shape == (0,)


# --------------------------------------------------------------------- fit
def _reference_init(model, F, hidden, seed):
    """``repro``'s initial parameters (``fit.py``'s jax.random draws)."""
    key = jax.random.PRNGKey(seed)
    if model == "logistic":
        return {"w": np.asarray(0.01 * jax.random.normal(key, (F,))),
                "b": np.zeros((), np.float32)}
    k1, k2 = jax.random.split(key)
    return {"w1": np.asarray(0.3 * jax.random.normal(k1, (F, hidden))),
            "b1": np.zeros((hidden,), np.float32),
            "w2": np.asarray(0.3 * jax.random.normal(k2, (hidden,))),
            "b2": np.zeros((), np.float32)}


@pytest.mark.parametrize("model,epochs,atol", [("logistic", 400, 1e-5),
                                                ("mlp", 100, 1e-5),
                                                ("mlp", 400, 1e-3)])
def test_training_loop_from_reference_init_matches(records, model, epochs,
                                                   atol):
    want = jfit.fit_from_records(records, model=model, hidden=8,
                                 epochs=epochs, seed=3)
    got = tfit._fit(records, lambda F: _reference_init(model, F, 8, 3),
                    model=model, epochs=epochs, lr=0.1, l2=1e-3, device="cpu")
    assert got.params.keys() == want.params.keys()
    for k in want.params:
        assert got.params[k].dtype == np.float32
        np.testing.assert_allclose(got.params[k], want.params[k], rtol=0,
                                   atol=atol, err_msg=k)
    for f in ("mu", "sigma"):
        assert np.array_equal(getattr(got, f), getattr(want, f))
    assert got.calibration == want.calibration
    for f in ("examples", "positives"):
        assert got.metrics[f] == want.metrics[f]
    for f in ("loss_first", "loss_last", "train_auc"):
        assert got.metrics[f] == pytest.approx(want.metrics[f], abs=1e-5)


def test_fit_learns_separable_labels_deterministically():
    recs = _synthetic_records()
    p1 = tfit.fit_from_records(recs, epochs=200, seed=3, device="cpu")
    p2 = tfit.fit_from_records(recs, epochs=200, seed=3, device="cpu")
    assert p1.metrics["train_auc"] > 0.95
    assert p1.metrics["loss_last"] < p1.metrics["loss_first"]
    np.testing.assert_array_equal(p1.params["w"], p2.params["w"])
    X, y = tfit.dataset_from_records(recs)
    s = p1(X)
    assert s.shape == (8 * 16,) and ((0 <= s) & (s <= 1)).all()
    assert s[y].mean() > s[~y].mean()
    mlp = tfit.fit_from_records(recs, model="mlp", epochs=200, device="cpu")
    assert mlp.metrics["train_auc"] > 0.95
    assert set(mlp.params) == {"w1", "b1", "w2", "b2"}
    with pytest.raises(ValueError, match="no shadow-labeled"):
        tfit.fit_from_records([{"kind": "window"}], device="cpu")
    with pytest.raises(ValueError, match="logistic"):
        tfit.fit_from_records(recs, model="tree", device="cpu")


# --------------------------------------------------------------- artifacts
@pytest.mark.parametrize("model", ["logistic", "mlp"])
def test_reference_predictor_loads_in_the_port(records, tmp_path, model):
    pred = jfit.fit_from_records(records, model=model, epochs=50)
    d = str(tmp_path / "pred")
    assert jfit.save_predictor(pred, d) == 1
    assert jfit.save_predictor(pred, d) == 2
    got = tfit.load_predictor(d)
    assert (got.version, got.model) == (2, model)
    assert got.calibration == pred.calibration and got.metrics == pred.metrics
    X, _ = tfit.dataset_from_records(records)
    s = got(X)
    assert np.array_equal(s.view(np.uint8), pred(X).view(np.uint8))
    assert tfit.load_predictor(d, version=1).version == 1
    # and back: the port's artifact loads in the reference
    assert tfit.save_predictor(got, d) == 3
    back = jfit.load_predictor(d)
    assert back.version == 3 and np.array_equal(back(X), s)


def test_load_predictor_rejects_foreign_artifacts(tmp_path):
    from repro_torch.ckpt import CheckpointManager

    d = str(tmp_path / "notpred")
    CheckpointManager(d).save(1, {"x": np.zeros(2)}, extra={"kind": "other"},
                              blocking=True)
    with pytest.raises(ValueError, match="hardness-predictor"):
        tfit.load_predictor(d)


def test_fit_cli_end_to_end(log_path, tmp_path, capsys):
    out = str(tmp_path / "pred")
    rc = tfit.main(["--log", log_path, "--out", out, "--epochs", "50",
                    "--min-labeled", "32", "--replay", "--device", "cpu"])
    assert rc == 0
    pred = tfit.load_predictor(out)
    assert pred.version == 1 and pred.metrics["examples"] == 8 * 16
    printed = capsys.readouterr().out
    assert "saved predictor v1" in printed and "replay oracle" in printed
    rc = tfit.main(["--log", log_path, "--out", str(tmp_path / "p2"),
                    "--min-labeled", "10000", "--device", "cpu"])
    assert rc == 2
    assert not (tmp_path / "p2" / "LATEST").exists()


# ----------------------------------------------------- daemon hot reload
def test_daemon_reloads_the_predictor_over_post(pair, records,  # noqa: F811
                                                tmp_path):
    """A routed CPU daemon with ``predictor_dir`` reloads over POST /reload
    with no compile-cache growth, adopts the calibrated hard_frac, and the
    batches it serves afterwards report the predictor's version."""
    _, tidx = pair
    pdir = str(tmp_path / "pred")
    pred = tfit.fit_from_records(records, epochs=50, device="cpu")
    assert tfit.save_predictor(pred, pdir) == 1
    obs.get_registry().reset()
    qlog = tmp_path / "after.jsonl"
    daemon = ServeDaemon(tidx, ladder=LADDER, batch_size=16, k=5, route=True,
                         metrics_port=0, predictor_dir=pdir, qlog=str(qlog),
                         router_kw=dict(min_frac=0.05, max_frac=0.6),
                         device="cpu")
    port = daemon.start()
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{port}/reload",
                                     method="POST")
        with urllib.request.urlopen(req, timeout=30) as resp:
            body = json.loads(resp.read())
        assert body["status"] == "ok"
        got = body["result"]
        assert got["version"] == 1 and got["jit_cache_growth"] == 0
        assert got["model"] == "logistic"
        want_frac = min(max(pred.calibration["hard_frac"], 0.05), 0.6)
        assert got["hard_frac"] == pytest.approx(want_frac)
        assert daemon.router.predictor_version == 1
        for i in range(3):
            res, _ = daemon.search(_queries(tidx, 16, seed=70 + i))
            assert res.ids.shape == (16, 5) and (res.ids >= 0).all()
        reg = obs.get_registry()
        assert reg.get("feedback.reloads").value == 1
        assert reg.get("feedback.predictor_version").value == 1.0
    finally:
        daemon.stop()
    batches = treplay.batch_records(treplay.read_log(str(qlog)))
    assert len(batches) == 3
    assert all(b["route"]["predictor_version"] == 1 for b in batches)

