"""The data pipeline, the fault-tolerant runner and the train CLI of the
port, on the CPU.

``repro_torch.data.pipeline`` is a copy of ``repro``'s and must give the
same bits (every step, row and dp shard).  The runner's cases mirror
``tests/test_ckpt_fault.py``'s (clean, injected failures, the restart
limit, the straggler report) on the port's runner, with the state as
tensors; then a real train step (reduced seamless-m4t-medium, ``adamw``,
remat on) run through the runner with injected failures must end on the
same bits as an uninterrupted run.  Checkpoints cross between the two
packages.  The CLI runs as a subprocess with ``--device cpu``.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import CheckpointManager as JCheckpointManager
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline

from repro_torch.configs import get_reduced
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.distributed.fault import (
    FaultTolerantRunner,
    RunnerConfig,
    restore_elastic,
)
from repro_torch.launch import train as launch_train
from repro_torch.obs import read_trace

from test_torch_search import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


# ---------------------------------------------------------------- pipeline
@pytest.mark.parametrize("kw", [
    dict(vocab_size=100, seq_len=32, global_batch=4, seed=7),
    dict(vocab_size=256206, seq_len=64, global_batch=3, seed=0,
         mean_doc_len=16),
    dict(vocab_size=50, seq_len=128, global_batch=2, zipf_a=1.1, bos_id=3),
])
def test_pipeline_is_the_reference_bit_for_bit(kw):
    tp, jp = TokenPipeline(DataConfig(**kw)), JTokenPipeline(JDataConfig(**kw))
    for step in (0, 1, 5, 1000):
        got, want = tp.batch(step), jp.batch(step)
        assert list(got) == list(want) == ["tokens", "labels"]
        for k in got:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
    it = iter(tp)
    np.testing.assert_array_equal(next(it)["tokens"], jp.batch(0)["tokens"])


def test_pipeline_dp_reshard_is_the_reference():
    """dp = 2 shards concatenated are the dp = 1 global batch, and each
    shard is ``repro``'s."""
    cfg, jcfg = (DataConfig(vocab_size=100, seq_len=16, global_batch=4, seed=3),
                 JDataConfig(vocab_size=100, seq_len=16, global_batch=4, seed=3))
    full = TokenPipeline(cfg).batch(9)["tokens"]
    shards = []
    for r in (0, 1):
        got = TokenPipeline(cfg, dp_rank=r, dp_degree=2).batch(9)["tokens"]
        want = JTokenPipeline(jcfg, dp_rank=r, dp_degree=2).batch(9)["tokens"]
        np.testing.assert_array_equal(got, want)
        shards.append(got)
    np.testing.assert_array_equal(np.concatenate(shards), full)


# ------------------------------------------------------------ fault runner
def _state(x=0.0):
    return {"params": {"w": torch.full((4, 4), x), "b": torch.zeros(4)},
            "opt": {"step": torch.tensor(0, dtype=torch.int32)}}


def _make_runner(path, ckpt_every=5):
    def step_fn(state, batch):
        w = state["params"]["w"] + torch.as_tensor(
            batch["tokens"]).to(torch.float32).mean()
        return ({"params": {"w": w, "b": state["params"]["b"]},
                 "opt": {"step": state["opt"]["step"] + 1}},
                {"loss": torch.mean(w)})

    pipe = TokenPipeline(DataConfig(vocab_size=64, seq_len=8, global_batch=2))
    return FaultTolerantRunner(
        RunnerConfig(str(path), ckpt_every=ckpt_every, max_restarts=5),
        step_fn, pipe.batch, _state, device="cpu")


def test_runner_completes_clean(tmp_path):
    runner = _make_runner(tmp_path / "clean")
    state, step = runner.run(12)
    assert step == 12 and runner.restarts == 0
    assert int(state["opt"]["step"]) == 12


def test_runner_survives_injected_failures(tmp_path):
    """Crashes at steps 7 and 9: the runner restores from its checkpoints
    and ends on the bits of an uninterrupted run."""
    clean = _make_runner(tmp_path / "a").run(12)[0]
    runner = _make_runner(tmp_path / "b")
    state, step = runner.run(12, fail_at={7: 1, 9: 1})
    assert step == 12 and runner.restarts == 2
    assert isinstance(state["params"]["w"], torch.Tensor)
    assert torch.equal(state["params"]["w"], clean["params"]["w"])
    assert int(state["opt"]["step"]) == 12


def test_runner_gives_up_after_max_restarts(tmp_path):
    runner = _make_runner(tmp_path / "c")
    runner.cfg.max_restarts = 1
    with pytest.raises(RuntimeError, match="injected"):
        runner.run(12, fail_at={3: 10})


def test_straggler_report(tmp_path):
    runner = _make_runner(tmp_path / "d")
    assert runner.straggler_report() == {"ready": False}
    runner.run(12)
    rep = runner.straggler_report()
    assert rep["ready"] and rep["mean_s"] > 0 and rep["flagged_steps"] >= 0
    short = _make_runner(tmp_path / "e")
    short.cfg.straggler_window = 4
    short.run(12)
    assert len(short.step_times) == 4


def test_resume_of_a_real_train_step_is_the_uninterrupted_run(tmp_path):
    """``chip_smoke.resume_run`` (phase 14's check (e)) on the CPU: the
    reduced seamless-m4t-medium trained 8 steps by a runner that
    checkpoints every 2, with and without failures at steps 3 and 5."""
    clean, r0 = chip_smoke.resume_run(torch, tmp_path / "clean", None, "cpu")
    resumed, r2 = chip_smoke.resume_run(torch, tmp_path / "resumed",
                                        {3: 1, 5: 1}, "cpu")
    assert (r0, r2) == (0, 2)
    assert int(resumed["opt"]["step"]) == 8
    for part in ("params", "opt"):
        for k, v in clean[part].items():
            if isinstance(v, dict):
                assert all(torch.equal(resumed[part][k][n], v[n]) for n in v), k
            else:
                assert torch.equal(resumed[part][k], v), k


def test_checkpoints_cross_packages_and_restore_elastic(tmp_path):
    """A ``repro`` checkpoint restores onto the port's device, and the
    port's restores in ``repro``."""
    jm = JCheckpointManager(str(tmp_path / "j"))
    jm.save(4, {"params": {"w": jnp.full((3, 2), 1.5)},
                "opt": {"step": jnp.asarray(4, jnp.int32)}},
            {"next_step": 4}, blocking=True)
    state, extra = restore_elastic(str(tmp_path / "j"), "cpu")
    assert extra == {"next_step": 4}
    assert isinstance(state["params"]["w"], torch.Tensor)
    assert state["opt"]["step"].dtype == torch.int32
    assert float(state["params"]["w"][0, 0]) == 1.5
    _make_runner(tmp_path / "t").run(6)
    jstate, jextra = JCheckpointManager(str(tmp_path / "t")).restore()
    assert jextra["next_step"] == 6 and int(jstate["opt"]["step"]) == 6
    if torch.cuda.is_available():
        assert restore_elastic(str(tmp_path / "j"))[0]["params"]["w"].is_cuda
    else:  # the default device is the card: no fallback to the CPU
        with pytest.raises((AssertionError, RuntimeError)):
            restore_elastic(str(tmp_path / "j"))


# ------------------------------------------------------------------ the CLI
def test_train_main_returns_the_run_record():
    rec = launch_train.main(["--arch", "seamless-m4t-medium", "--reduced",
                             "--steps", "3", "--batch", "2", "--seq", "16",
                             "--micro", "2", "--device", "cpu"])
    assert rec["arch"] == "seamless-m4t-medium" and rec["device"] == "cpu"
    assert len(rec["losses"]) == len(rec["grad_norms"]) == 3
    assert len(rec["step_seconds"]) == 3
    assert np.isfinite(rec["losses"]).all() and np.isfinite(rec["grad_norms"]).all()
    assert int(rec["state"]["opt"]["step"]) == 3
    cfg = get_reduced("seamless-m4t-medium")
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, 16, 2))
    b = launch_train.batch_fn_for(cfg, pipe, 2, 16)(5)
    np.testing.assert_array_equal(
        b["frames"], np.random.default_rng(5).standard_normal(
            (2, 16, cfg.d_model)).astype(np.float32))
    vlm = get_reduced("internvl2-26b")
    b = launch_train.batch_fn_for(vlm, pipe, 2, 16)(5)
    assert b["patches"].shape == (2, vlm.num_patches, vlm.patch_dim)
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises((AssertionError, RuntimeError)):
            launch_train.main(["--arch", "gemma-2b", "--reduced", "--steps",
                               "1", "--batch", "2", "--seq", "8"])


def test_train_cli_restartable_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    trace = tmp_path / "t.json"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "gemma-2b", "--reduced", "--steps", "4", "--batch", "2", "--seq",
         "32", "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck"),
         "--ckpt-every", "2", "--trace", str(trace)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "done: 4 steps" in out.stdout
    assert (tmp_path / "ck" / "LATEST").read_text() == "step_000000004"
    events = read_trace(str(trace))
    assert sum(e.get("name") == "train.step" for e in events) == 4
