"""The MoE dropping dispatch on a sharded mesh
(``repro_torch.models.moe._dropping_dispatch`` on DTensors).

The reduced qwen2-moe-a2.7b's dispatch runs on 4 gloo ranks
(``tests/_torch_ranks.py``) as a (2, 2) ("data", "model") mesh under the
train profile: its parameters laid out as a train cell lays them out and
gathered over "data" as a loss-path layer gathers them, its (4, 16, d)
input sharded over its rows, so the 2 data-parallel groups are the two
"data" shards.  ``repro``'s side runs once, in a subprocess with 4 fake JAX
devices (``tests/_subproc.py``), at capacity factors 0.5 (tokens dropped)
and 1.25 (``repro``'s default).

Tolerances: the DTensor run against the same dispatch on plain tensors
under the same context (one process's group-local dispatch): the sort, the
scatter, the kept slots and the slot-order combine are each rank's own
groups' and the same ops, so in float64 the output and the input's
gradient equal to the bit where the "model" axis does not split a
product's sum (a profile with the experts' hidden width whole), and within
1e-12 under the train profile, whose "model" axis splits it (each rank a
part of the sum, added in another order, as ``repro``'s GSPMD splits it);
float32 within 1e-6; the gradients within 1e-5 (float32) and 1e-12
(float64) of the plain run's autograd (a weight's sum over the tokens is
split over the "data" ranks); float32 within 1e-5 of ``repro``.
"""
import numpy as np
import pytest

from tests._subproc import run_with_devices
from tests._torch_ranks import moe_mesh_rank, run_ranks

CFS = (0.5, 1.25)
ROWS, SEQ = 4, 16

REPRO_SIDE = """
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_reduced
from repro.distributed.sharding import ShardingCtx, make_profile
from repro.models import moe as jmoe
from repro.models.common import init_params

out_path, cfs, rows, seq = sys.argv[1], json.loads(sys.argv[2]), \\
    int(sys.argv[3]), int(sys.argv[4])
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(
    jax.sharding.AxisType.Auto,) * 2)
ctx = ShardingCtx(mesh, make_profile("train"))
base = get_reduced("qwen2-moe-a2.7b")
jp = init_params(jmoe.moe_param_table(base, "", 0), jax.random.PRNGKey(2),
                 "float32")
x = np.random.default_rng(7).standard_normal(
    (rows, seq, base.d_model)).astype(np.float32)
res = {}
for cf in cfs:
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, impl="dropping", capacity_factor=cf))
    for rows_, tag in ((rows, ""), (1, "one_")):  # one row: one group
        with mesh:
            o, aux = jax.jit(lambda x: jmoe.moe_ffn(x, jp, "", cfg, ctx))(
                jnp.asarray(x[:rows_]))
        res[f"{tag}out_{cf}"], res[f"{tag}aux_{cf}"] = np.asarray(o), \
            np.asarray(aux)
res["groups"] = np.asarray(jmoe._dp_groups(ctx))
np.savez(out_path, x=x, **res,
         **{"p_" + k: np.asarray(v) for k, v in jp.items()})
print("ok")
"""


@pytest.fixture(scope="module")
def repro_side(tmp_path_factory):
    import json

    path = tmp_path_factory.mktemp("moe_mesh") / "repro.npz"
    run_with_devices(
        f"import sys; sys.argv[1:] = {[str(path), json.dumps(CFS), str(ROWS), str(SEQ)]!r}\n"
        + REPRO_SIDE, n_devices=4)
    z = np.load(path)
    return {k: z[k] for k in z.files}


def _cases(repro_side):
    params = {k[2:]: v for k, v in repro_side.items() if k.startswith("p_")}
    x = repro_side["x"]
    gy = np.random.default_rng(11).standard_normal(x.shape)
    cases = {}
    p64 = {k: v.astype(np.float64) for k, v in params.items()}
    for cf in CFS:
        kw = {"impl": "dropping", "capacity_factor": cf}
        cases[f"float32_{cf}"] = (kw, "float32", params, x,
                                  gy.astype(np.float32), {})
        cases[f"float64_{cf}"] = (kw, "float64", p64, x.astype(np.float64),
                                  gy, {})
        # no hidden width split over "model": no sum in another order
        cases[f"whole_ff_{cf}"] = (kw, "float64", p64, x.astype(np.float64),
                                   gy, {"ff": None, "act_ff": None})
        # one row, which "data" does not divide: one group on every rank,
        # its capacity rows split over "data"
        cases[f"one32_{cf}"] = (kw, "float32", params, x[:1],
                                gy[:1].astype(np.float32), {})
        cases[f"one64_{cf}"] = (kw, "float64", p64, x[:1].astype(np.float64),
                                gy[:1], {})
    return cases


@pytest.fixture(scope="module")
def mesh_ranks(repro_side, tmp_path_factory):
    return run_ranks(moe_mesh_rank, 4, tmp_path_factory.mktemp("moe_ranks"),
                     _cases(repro_side))


NAMES = ("out", "aux", "d_x", "d_we_gate", "d_we_up", "d_we_down")


@pytest.mark.parametrize("cf", CFS)
def test_mesh_dispatch_is_the_plain_group_local_dispatch(mesh_ranks, cf):
    """The DTensor dispatch's output and aux against the plain tensors'
    on every rank (two groups, the "data" shards): in float64 equal to the
    bit, and the input's gradient too, where "model" splits no product's
    sum (the experts' hidden width whole); under the train profile, whose
    "model" axis splits the hidden width, within 1e-12 (a token dropped on
    one side or kept in another slot would move the output by O(1));
    float32 within 1e-6.  Without a gradient (a prefill's way, the pending
    sums settled in place) the output is the same to the bit."""
    for r in mesh_ranks:
        got = r[f"whole_ff_{cf}"]
        for name, a, b in list(zip(NAMES, got["mesh"], got["plain"]))[:3]:
            np.testing.assert_array_equal(a, b, err_msg=name)
        for case in ("float64", "float32", "one64", "one32", "whole_ff"):
            # without a gradient the pending sums are settled in place:
            # the same sums
            got = r[f"{case}_{cf}"]
            np.testing.assert_array_equal(got["no_grad"], got["mesh"][0],
                                          err_msg=case)
        for case, tol in (("float64", 1e-12), ("float32", 1e-6),
                          ("one64", 1e-12), ("one32", 1e-6)):
            got = r[f"{case}_{cf}"]
            assert got["groups"] == 2
            for name, a, b in zip(NAMES[:2], got["mesh"], got["plain"]):
                np.testing.assert_allclose(a, b, rtol=tol, atol=tol,
                                           err_msg=f"{case} {name}")


@pytest.mark.parametrize("cf", CFS)
def test_mesh_dispatch_is_repros(mesh_ranks, repro_side, cf):
    """float32 output and aux within 1e-5 of ``repro``'s shard-local
    dispatch compiled on 4 fake JAX devices (2 groups there too; one for
    the one row)."""
    assert int(repro_side["groups"]) == 2
    for r in mesh_ranks:
        for case, tag in (("float32", ""), ("one32", "one_")):
            out, aux = r[f"{case}_{cf}"]["mesh"][:2]
            np.testing.assert_allclose(out, repro_side[f"{tag}out_{cf}"],
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(aux, repro_side[f"{tag}aux_{cf}"],
                                       rtol=1e-5)


@pytest.mark.parametrize("cf", CFS)
def test_mesh_dispatch_gradients_are_one_process_autograds(mesh_ranks, cf):
    """The gradients of ``(out · g).sum() + aux`` with respect to the input
    and the three expert weights (their FSDP and tensor-parallel shards
    reduced back: a weight's sum over the tokens is split over the groups'
    "data" ranks) within 1e-5 of the plain run's autograd in float32 and
    1e-12 in float64; every one of them non-zero."""
    for r in mesh_ranks:
        for case, tol in (("float32", 1e-5), ("float64", 1e-12),
                          ("whole_ff", 1e-12), ("one32", 1e-5),
                          ("one64", 1e-12)):
            got = r[f"{case}_{cf}"]
            for name, a, b in list(zip(NAMES, got["mesh"], got["plain"]))[2:]:
                assert np.abs(b).max() > 0, name
                np.testing.assert_allclose(a, b, rtol=tol, atol=tol,
                                           err_msg=f"{case} {name}")


@pytest.mark.parametrize("cf", CFS)
def test_mesh_dispatch_is_shard_local(mesh_ranks, cf):
    """No op of the dispatch is rescued by ``ReplicateFallback`` (nor,
    with two groups, any activation's layout); each rank sorts only its own group's T/G · K
    slot ids (2 rows of 16 tokens, top 2: 64; the router's top-k sorts its
    own 2 rows' probabilities), and every expert product, forward and
    backward, multiplies only its group's capacity rows by its own block
    of the hidden width (the "model" half).  With one row, one group on
    every rank: each sorts its 32 slots, and multiplies its half of the
    group's capacity rows (split over "data")."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.models.moe import capacity

    cfg = get_reduced("qwen2-moe-a2.7b")
    K, E = cfg.moe.experts_per_token, cfg.moe.num_experts
    spec = dataclasses.replace(cfg.moe, capacity_factor=cf)
    fe = cfg.moe.expert_d_ff
    for r in mesh_ranks:
        for case, rows, t_loc, rows_a_rank in (
                ("float32", ROWS // 2, ROWS * SEQ // 2,
                 capacity(ROWS * SEQ // 2, spec)),
                ("one32", 1, SEQ, capacity(SEQ, spec) // 2)):
            got = r[f"{case}_{cf}"]
            # the one row's layouts fall back as repro's (its rows do not
            # divide "data"); no op does
            assert not [f for f in got["fallbacks"] if f.startswith("op/")]
            assert bool(got["fallbacks"]) == (case == "one32"), \
                got["fallbacks"]
            # the router's top-k over its own rows, then the group's slots
            assert got["sorted"] == [(rows, SEQ, E), (t_loc * K,)], \
                got["sorted"]
            # every operand (E, ·, ·) of its capacity rows, the width and
            # the rank's half of the hidden width
            bmm = [p for p in got["products"] if len(p[0]) == 3]
            assert len(bmm) == 9, bmm
            for a, b in bmm:
                dims = set(a[1:]) | set(b[1:])
                assert a[0] == b[0] == E and rows_a_rank in dims \
                    and fe // 2 in dims \
                    and dims <= {rows_a_rank, cfg.d_model, fe // 2}, \
                    (case, a, b)
