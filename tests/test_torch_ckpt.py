"""Checkpoint parity: ``repro_torch.ckpt.CheckpointManager`` writes
``repro.ckpt``'s layout, so a checkpoint of either package restores in the
other, and it keeps the reference's save / restore behaviour (round trip,
async save, ``keep_last`` pruning, a specific step), on the CPU.

Tolerance: none; restored arrays are bit-equal and ``extra`` equal.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import CheckpointManager as JManager

from repro_torch.ckpt import CheckpointManager


def _state(seed=0, x=None):
    rng = np.random.default_rng(seed)
    w = (np.full((4, 4), x, np.float32) if x is not None
         else rng.standard_normal((4, 4)).astype(np.float32))
    return {
        "params": {"w": w, "b": rng.standard_normal(4).astype(np.float32)},
        "opt": {"step": np.asarray(7, np.int32),
                "ids": rng.integers(0, 9, (3, 2)).astype(np.int64)},
    }


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _assert_same(got, want):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in w:
        a, b = np.asarray(g[k]), np.asarray(w[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k


EXTRA = {"next_step": 10, "kind": "test", "nested": {"a": [1, 2.5, "x"]}}


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    st = _state(1)
    JManager(str(tmp_path)).save(
        10, {"params": {k: jnp.asarray(v) for k, v in st["params"].items()},
             "opt": st["opt"]}, EXTRA, blocking=True)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 10
    got, extra = mgr.restore()
    assert extra == EXTRA
    _assert_same(got, st)
    assert isinstance(got["params"]["w"], np.ndarray)
    # with a device: tensors there, the same values
    on_cpu, _ = mgr.restore(10, device="cpu")
    assert isinstance(on_cpu["params"]["w"], torch.Tensor)
    _assert_same({k: {kk: vv.numpy() for kk, vv in v.items()}
                  for k, v in on_cpu.items()}, st)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    st = _state(2)
    st_t = {"params": {k: torch.from_numpy(v) for k, v in st["params"].items()},
            "opt": st["opt"]}  # tensors and arrays mixed, as a trainer has
    CheckpointManager(str(tmp_path)).save(3, st_t, EXTRA, blocking=True)
    jm = JManager(str(tmp_path))
    assert jm.latest_step() == 3
    got, extra = jm.restore()
    assert extra == EXTRA
    _assert_same(got, st)
    # the same manifest fields as the reference writes
    m = json.loads((tmp_path / "step_000000003" / "manifest.json").read_text())
    assert set(m) == {"step", "keys", "extra", "time"}
    assert m["keys"]["params/w"] == {"shape": [4, 4], "dtype": "float32"}
    assert (tmp_path / "LATEST").read_text() == "step_000000003"
    assert not (tmp_path / ".LATEST.tmp").exists()


def test_restore_with_structure_rebuilds_lists_and_tuples(tmp_path):
    st = {"layers": [np.arange(3.0), np.ones((2, 2))], "pair": (np.int32(4),
                                                              np.zeros(2))}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, st, blocking=True)
    got, _ = mgr.restore(structure=st)
    assert isinstance(got["layers"], list) and isinstance(got["pair"], tuple)
    want, _ = JManager(str(tmp_path)).restore(structure=st)
    for a, b in zip(got["layers"] + list(got["pair"]),
                    want["layers"] + list(want["pair"])):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("case", ["roundtrip", "async", "keep_last",
                                  "specific_step"])
def test_reference_save_restore_cases(tmp_path, case):
    """``tests/test_ckpt_fault.py``'s checkpoint cases, on the port."""
    if case == "roundtrip":
        mgr = CheckpointManager(str(tmp_path))
        st = _state(x=1.5)
        mgr.save(10, st, {"next_step": 10}, blocking=True)
        restored, extra = mgr.restore()
        np.testing.assert_array_equal(restored["params"]["w"], st["params"]["w"])
        assert extra["next_step"] == 10
        assert mgr.latest_step() == 10
    elif case == "async":
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, _state(x=2.0), blocking=False)
        mgr.wait()
        assert mgr.latest_step() == 1
    elif case == "keep_last":
        mgr = CheckpointManager(str(tmp_path), keep_last=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, _state(x=float(s)), blocking=True)
        steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
        assert steps == ["step_000000003", "step_000000004"]
        assert mgr.latest_step() == 4
    else:
        mgr = CheckpointManager(str(tmp_path), keep_last=5)
        for s in (1, 2):
            mgr.save(s, _state(x=float(s)), blocking=True)
        restored, _ = mgr.restore(1)
        assert float(restored["params"]["w"][0, 0]) == 1.0


def test_async_save_error_surfaces_on_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    (tmp_path / "step_000000001").write_text("x")  # a file where the step goes
    mgr.save(1, _state(), blocking=False)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        mgr.wait()
    assert mgr.latest_step() is None
    assert os.listdir(tmp_path) == ["step_000000001"]  # no temp dir left
    mgr.wait()  # the error is raised once
    with pytest.raises(FileNotFoundError):
        mgr.restore()
