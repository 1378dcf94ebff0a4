"""Training across ranks: the data-parallel ``make_train_step(ctx=)`` on 2
gloo ranks against the 1-rank step, and ``restore_elastic``'s and
``FaultTolerantRunner``'s ``repro`` signatures.

The train step runs the reduced gemma-2b in float32, two ``sgd`` steps on
one ``make_inputs`` batch of 4 x 16 (seed 0), with 1 and 2 microbatches.
Tolerances: the first loss within 1e-6 relative of the 1-rank loss; the
parameters after two steps within rtol 2e-3, atol 2e-5 (the smoke's
micro 1 against 2 tolerance: both change only the float32 sum order of the
gradients); both ranks hold the same bits; and at one rank a (1,) "data"
mesh gives the bits of the step without a sharding context.
"""
import numpy as np
import pytest
import torch

from tests._torch_ranks import data_parallel_train_rank, run_ranks

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.distributed.fault import (
    FaultTolerantRunner, RunnerConfig, restore_elastic,
)

ARGS = ("gemma-2b", 4, 16)  # arch, rows, seq
STEPS = 2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(world, micro): each rank's result}: one spawn per world size."""
    out = {}
    for world in (2, 1):
        d = tmp_path_factory.mktemp(f"world{world}")
        res = run_ranks(_both_micro, world, d)
        for micro in (1, 2):
            out[(world, micro)] = [r[micro] for r in res]
    return out


def _both_micro(rank, world):
    return {m: data_parallel_train_rank(rank, world, *ARGS, m, STEPS)
            for m in (1, 2)}


@pytest.mark.parametrize("micro", [1, 2])
def test_data_parallel_step_matches_one_rank(runs, micro):
    (l1, p1, axes1, l_plain, p_plain), = runs[(1, micro)]
    r0, r1 = runs[(2, micro)]
    assert r0[2] == ("data",)
    # the two ranks hold the same step
    assert r0[0] == r1[0]
    for n in r0[1]:
        np.testing.assert_array_equal(r0[1][n], r1[1][n], err_msg=n)
    # against one rank
    np.testing.assert_allclose(r0[0][0], l1[0], rtol=1e-6, atol=0)
    for n in p1:
        np.testing.assert_allclose(r0[1][n], p1[n], rtol=2e-3, atol=2e-5,
                                   err_msg=n)
    # at one rank the mesh changes no bit
    assert axes1 == ("data",) and l1 == l_plain
    for n in p1:
        np.testing.assert_array_equal(p1[n], p_plain[n], err_msg=n)


def test_ranks_rows_are_one_moe_group():
    """Under the data-parallel step each rank's rows are one data shard:
    the model's context leaves the split axes out of ``act_batch``, so the
    dropping dispatch makes one group of them, as ``repro``'s GSPMD step
    makes one group per data shard."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.distributed.sharding import ShardingCtx, make_profile
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.moe import _dp_groups
    from repro_torch.train.loop import _local_ctx, batch_axes

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        mesh = make_host_mesh((2, 2, 2), ("pod", "data", "model"),
                              device="cpu")
        ctx = ShardingCtx(mesh, make_profile("train"))
        assert _dp_groups(ctx) == 4
        assert batch_axes(ctx, 8) == ("pod", "data")
        assert _dp_groups(_local_ctx(ctx, ("pod", "data"))) == 1
        assert batch_axes(ctx, 2) == ("pod",)  # 2 rows: the prefix divides
        local = _local_ctx(ctx, ("pod",))
        assert _dp_groups(local) == 2 and local.fallbacks is ctx.fallbacks
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------- restore_elastic (C5)
def _save_two_steps(d):
    mgr = CheckpointManager(str(d))
    for step in (4, 6):
        mgr.save(step, {"params": {"enc/wq": torch.full((2, 3), float(step)),
                                   "b": torch.zeros(3)},
                        "opt": {"step": torch.tensor(step, dtype=torch.int32)}},
                 {"next_step": step}, blocking=True)
    return mgr


def test_restore_elastic_takes_repros_argument_order(tmp_path):
    """``restore_elastic(ckpt_dir, target_shardings, step)``: a device, or
    a tree of devices, second; the step third."""
    _save_two_steps(tmp_path)
    state, extra = restore_elastic(str(tmp_path), "cpu", 4)
    assert extra == {"next_step": 4}
    assert float(state["params"]["enc"]["wq"][0, 0]) == 4.0  # nested by path
    state, extra = restore_elastic(str(tmp_path), "cpu")
    assert extra == {"next_step": 6} and int(state["opt"]["step"]) == 6
    tree = {"params": {"enc": {"wq": "cpu"}, "b": "cpu"}}
    state, _ = restore_elastic(str(tmp_path), tree)
    assert isinstance(state["params"]["enc"]["wq"], torch.Tensor)
    assert isinstance(state["opt"]["step"], np.ndarray)  # no target: host


def test_restore_elastic_rebuilds_slash_names(tmp_path):
    _save_two_steps(tmp_path)
    structure = {"params": {"enc/wq": None, "b": None},
                 "opt": {"step": None}}
    state, _ = restore_elastic(str(tmp_path), "cpu", 6, structure=structure)
    assert sorted(state["params"]) == ["b", "enc/wq"]
    assert state["params"]["enc/wq"].device.type == "cpu"
    assert float(state["params"]["enc/wq"][1, 2]) == 6.0


def test_runner_takes_target_shardings_in_repros_position(tmp_path):
    """``FaultTolerantRunner(cfg, step_fn, batch_fn, init_state_fn,
    target_shardings)``: a restart restores onto the given tree."""
    def step_fn(state, batch):
        return {"w": state["w"] + batch}, {}

    runner = FaultTolerantRunner(
        RunnerConfig(str(tmp_path), ckpt_every=1, max_restarts=2),
        step_fn, lambda step: torch.ones(2), lambda: {"w": torch.zeros(2)},
        {"w": "cpu"}, device="meta")
    state, step = runner.run(4, fail_at={2: 1})
    assert runner.restarts == 1 and step == 4
    assert state["w"].device.type == "cpu"  # the tree, not device=
    assert state["w"].tolist() == [4.0, 4.0]
