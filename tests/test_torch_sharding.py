"""The sharding stack: ``repro_torch.launch.mesh`` and
``repro_torch.distributed.sharding`` against ``repro``'s, elastic restore,
the cross-pod gradient sync and the MoE dropping dispatch under a mesh.

``repro``'s side runs once, in a subprocess with 4 fake JAX devices
(``tests/_subproc.py``), and writes its results to a file; the port's
meshes are ``DeviceMesh``es on a "fake" process group in this process
(resolution only reads a mesh's names and sizes) or, where ranks talk, 4
gloo ranks on the CPU spawned once (``tests/_torch_ranks.py``).

Tolerances: the specs and the fallback strings equal; the restored values
equal; ``cross_pod_grad_sync`` 0.5 within 0.02 on every rank, as
``tests/test_distributed.py`` holds ``repro``'s, and equal to ``repro``'s;
the dropping dispatch with G = 2 data-parallel groups within 1e-5 of
``repro``'s.
"""
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tests._subproc import run_with_devices
from tests._torch_ranks import fake_mesh_shapes, run_ranks, sharding_checks_rank

from repro_torch.distributed.sharding import (
    NULL_CTX, P, ShardingCtx, make_profile, named_sharding, placements,
    resolve_axes,
)
from repro_torch.launch.mesh import make_host_mesh

KINDS = [("train", True), ("train", False), ("prefill", True),
         ("decode", True), ("decode_serve", True), ("long", True)]
MESHES = {"dm": ((2, 2), ("data", "model")), "pd": ((2, 2), ("pod", "data")),
          "pdm": ((1, 2, 2), ("pod", "data", "model"))}
CASES = [
    (("embed", "ff"), (128, 256)),
    (("heads",), (7,)),
    (("heads",), (8,)),
    (("layers", "embed", "heads", "head_dim"), (2, 64, 4, 16)),
    (("layers", "embed", "kv_heads", "head_dim"), (2, 64, 1, 16)),
    (("vocab", "embed"), (1001, 64)),
    (("experts", "embed", "ff"), (4, 64, 96)),
    (("act_batch", "act_seq", "act_embed"), (4, 16, 64)),
    (("act_batch", "act_seq", "act_embed"), (3, 16, 64)),
    (("act_batch", None, "act_heads", None), (2, 16, 5, 8)),
    (("cache_batch", "cache_seq", "cache_heads", None), (4, 32, 2, 8)),
    (("cache_batch", "cache_seq", "cache_heads", None), (1, 33, 3, 8)),
    ((None, "act_ff"), (6, 10)),
    (("act_batch", "act_seq", "act_vocab"), (2, 8, 1001)),
]
MOE_KW = {"impl": "dropping", "capacity_factor": 0.5}

REPRO_SIDE = """
import json, sys, dataclasses, jax, jax.numpy as jnp, numpy as np
from functools import partial
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.ckpt.checkpoint import CheckpointManager
from repro.configs import get_reduced
from repro.distributed.sharding import (
    NULL_CTX, ShardingCtx, make_profile, resolve_axes)
from repro.models import moe as jmoe
from repro.models.common import init_params
from repro.train.compress import cross_pod_grad_sync

out_path, ckpt_dir = sys.argv[1], sys.argv[2]
kinds, meshes, cases, moe_kw = json.loads(sys.argv[3])

def mk(shape, axes):
    return jax.make_mesh(tuple(shape), tuple(axes), axis_types=(
        jax.sharding.AxisType.Auto,) * len(axes))

def as_list(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]

rec = {"specs": {}, "fallbacks": {}}
for mname, (shape, axes) in meshes.items():
    mesh = mk(shape, axes)
    for kind, fsdp in kinds:
        prof = make_profile(kind, fsdp=fsdp)
        fb = []
        rec["specs"][f"{mname}/{kind}/{fsdp}"] = [
            as_list(resolve_axes(mesh, tuple(a), tuple(s), prof, fb,
                                 context=f"c{i}"))
            for i, (a, s) in enumerate(cases)]
        rec["fallbacks"][f"{mname}/{kind}/{fsdp}"] = fb
try:
    make_profile("nope")
except ValueError as e:
    rec["bad_kind"] = str(e)

mesh = mk((2, 2), ("data", "model"))
ctx = ShardingCtx(mesh, make_profile("train"))
with mesh:
    jax.jit(lambda x: ctx.constrain(x, ("act_batch", None, "act_heads")))(
        jnp.zeros((3, 5, 7)))
rec["ctx_fallbacks"] = ctx.fallbacks

# elastic restore: tests/test_distributed.py's checkpoint
mesh4 = mk((4,), ("data",))
state = {"params": {"w": jax.device_put(jnp.arange(16.0).reshape(8, 2),
                                        NamedSharding(mesh4, P("data")))}}
CheckpointManager(ckpt_dir).save(5, state, {"next_step": 5}, blocking=True)

# cross-pod sync: tests/test_distributed.py's case
pmesh = mk((2, 2), ("pod", "data"))
grads = jnp.stack([jnp.full((8,), float(i)) for i in range(2)])
@partial(jax.shard_map, mesh=pmesh, in_specs=(P("pod"), P("pod")),
         out_specs=(P("pod"), P("pod")), check_vma=False)
def sync(g, e):
    g2, e2 = cross_pod_grad_sync({"w": g[0]}, {"w": e[0]}, axis="pod")
    return g2["w"][None], e2["w"][None]
with pmesh:
    g_synced, e_new = sync(grads, jnp.zeros((2, 8), jnp.float32))

# the dropping dispatch, G = 2 under the mesh and G = 1 off it
cfg = get_reduced("qwen2-moe-a2.7b")
cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_kw))
jp = init_params(jmoe.moe_param_table(cfg, "", 0), jax.random.PRNGKey(2),
                 "float32")
x = np.random.default_rng(7).standard_normal(
    (2, 24, cfg.d_model)).astype(np.float32)
with mesh:
    moe2, aux2 = jax.jit(lambda x: jmoe.moe_ffn(x, jp, "", cfg, ctx))(
        jnp.asarray(x))
moe1, _ = jmoe.moe_ffn(jnp.asarray(x), jp, "", cfg, NULL_CTX)
rec["moe_groups"] = jmoe._dp_groups(ctx)
np.savez(out_path, g_synced=np.asarray(g_synced), e_new=np.asarray(e_new),
         moe2=np.asarray(moe2), aux2=np.asarray(aux2), moe1=np.asarray(moe1),
         x=x, json=np.asarray(json.dumps(rec)),
         **{"p_" + k: np.asarray(v) for k, v in jp.items()})
print("ok")
"""


def _as_list(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


@pytest.fixture(scope="module")
def repro_side(tmp_path_factory):
    d = tmp_path_factory.mktemp("repro")
    args = [str(d / "out.npz"), str(d / "ckpt"),
            json.dumps([KINDS, MESHES, CASES, MOE_KW])]
    run_with_devices(f"import sys; sys.argv = ['x'] + {args!r}\n"
                     + REPRO_SIDE, n_devices=4)
    z = dict(np.load(d / "out.npz"))
    z["rec"] = json.loads(str(z.pop("json")))
    z["ckpt"] = str(d / "ckpt")
    return z


@pytest.fixture(scope="module")
def ranks(repro_side, tmp_path_factory):
    """The port's side of the restore, cross-pod and MoE checks: 4 gloo
    ranks, spawned once."""
    d = tmp_path_factory.mktemp("ranks")
    params = {k[2:]: v for k, v in repro_side.items() if k.startswith("p_")}
    return run_ranks(sharding_checks_rank, 4, d, str(d / "ckpt"),
                     repro_side["ckpt"], params, repro_side["x"], MOE_KW)


@pytest.fixture()
def fake_world():
    """A "fake" process group of 4 ranks in this process (rank 0): enough
    to build ``DeviceMesh``es whose names and sizes resolution reads."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield {name: make_host_mesh(shape, axes, device="cpu")
               for name, (shape, axes) in MESHES.items()}
    finally:
        dist.destroy_process_group()


def test_resolve_axes_and_fallbacks_match_repro(repro_side, fake_world):
    rec = repro_side["rec"]
    for mname, mesh in fake_world.items():
        for kind, fsdp in KINDS:
            key = f"{mname}/{kind}/{fsdp}"
            prof = make_profile(kind, fsdp=fsdp)
            fb = []
            specs = [_as_list(resolve_axes(mesh, a, s, prof, fb,
                                           context=f"c{i}"))
                     for i, (a, s) in enumerate(CASES)]
            assert specs == rec["specs"][key], key
            assert fb == rec["fallbacks"][key], key
    with pytest.raises(ValueError) as e:
        make_profile("nope")
    assert str(e.value) == rec["bad_kind"]
    # the same fallback, recorded by the activation context
    ctx = ShardingCtx(fake_world["dm"], make_profile("train"))
    x = torch.zeros((3, 5, 7))
    assert ctx.constrain(x, ("act_batch", None, "act_heads")) is x
    assert ctx.fallbacks == rec["ctx_fallbacks"]
    with pytest.raises(ValueError):
        ctx.constrain(x, ("act_batch", None))


def test_profiles_are_repros():
    """``_base_rules`` and every profile's overrides, entry by entry."""
    from repro.distributed.sharding import make_profile as j_make_profile

    for kind, fsdp in KINDS:
        assert make_profile(kind, fsdp=fsdp).rules == \
            j_make_profile(kind, fsdp=fsdp).rules, kind
    prof = make_profile("train").override(experts="model")
    assert prof.rules["experts"] == "model" and prof.name == "train"
    assert make_profile("train").rules["experts"] is None


def test_placements_and_the_null_context(fake_world):
    mesh = fake_world["pdm"]
    got = [repr(p) for p in placements(mesh, P(("pod", "data"), None,
                                               "model"))]
    assert got == ["Shard(dim=0)", "Shard(dim=0)", "Shard(dim=2)"]
    with pytest.raises(ValueError):  # out of the mesh's order
        placements(mesh, P(("data", "pod")))
    m, pl = named_sharding(fake_world["dm"], ("embed", "ff"), (128, 256),
                           make_profile("train"))
    assert m is fake_world["dm"]
    assert [repr(p) for p in pl] == ["Shard(dim=0)", "Shard(dim=1)"]
    x = torch.ones(3)
    assert NULL_CTX.constrain(x, ("a", "b", "c", "d")) is x
    assert ShardingCtx(fake_world["dm"]).constrain(x, ()) is x  # no profile


def test_production_mesh_shapes():
    """``tests/test_distributed.py``'s shapes on 512 ranks of a "fake"
    process group in one process."""
    (s1, n1), (s2, n2) = fake_mesh_shapes()
    assert s1 == {"data": 16, "model": 16} and n1 == 256
    assert s2 == {"pod": 2, "data": 16, "model": 16} and n2 == 512


def test_host_mesh_needs_enough_ranks():
    with pytest.raises(RuntimeError):  # no process group at all
        make_host_mesh((2, 2), device="cpu")


def test_elastic_restore_across_meshes(ranks):
    want = np.arange(16.0).reshape(8, 2)
    for rank_out in ranks:
        for name in ("port", "repro"):
            local, full, pl, extra, (i, j) = rank_out["restore"][name]
            np.testing.assert_array_equal(full, want)
            np.testing.assert_array_equal(local,
                                          want[i * 4:(i + 1) * 4, j:j + 1])
            assert pl == ["Shard(dim=0)", "Shard(dim=1)"], name
            assert extra == {"next_step": 5}


def test_cross_pod_compressed_allreduce(ranks, repro_side):
    for r in ranks:
        g, e = r["cross_pod"]
        np.testing.assert_allclose(g, 0.5, atol=0.02)
        np.testing.assert_array_equal(g, repro_side["g_synced"][0])
        np.testing.assert_array_equal(e, repro_side["e_new"][0])


def test_moe_dropping_dispatch_in_data_parallel_groups(ranks, repro_side):
    assert repro_side["rec"]["moe_groups"] == 2
    for r in ranks:
        out, aux, groups, fallbacks = r["moe"]
        assert groups == 2
        np.testing.assert_allclose(out, repro_side["moe2"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(aux, repro_side["aux2"], rtol=1e-5)
        assert isinstance(fallbacks, list)
    # two groups drop other slots than one group does
    assert np.abs(repro_side["moe2"] - repro_side["moe1"]).max() > 1e-3


def test_entry_points_default_to_the_card():
    import inspect

    from repro_torch.distributed.fault import restore_elastic
    from repro_torch.launch.mesh import make_production_mesh

    for fn, arg in ((make_host_mesh, "device"), (make_production_mesh, "device"),
                    (restore_elastic, "target_shardings")):
        assert inspect.signature(fn).parameters[arg].default == "cuda", fn


def test_gather_fsdp_gathers_the_embed_shards_in_the_compute_dtype(
        fake_world):
    """``ShardingCtx.gather_fsdp`` under the train profile: a weight sharded
    on ``embed`` over "data" (FSDP) and on ``ff`` over "model" comes back
    replicated over "data", still sharded over "model", cast to the
    compute dtype unless its name is kept; a weight with no "data" shard,
    a plain tensor, and anything under ``NULL_CTX`` or the no-FSDP train
    profile come back as they are."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = fake_world["dm"]
    ctx = ShardingCtx(mesh, make_profile("train"))

    def dt(placements, local_shape):
        return DTensor.from_local(torch.zeros(local_shape), mesh, placements,
                                  run_check=False)

    w = dt([Shard(0), Shard(1)], (64, 128))
    norm = dt([Shard(0), Replicate()], (64,))
    heads = dt([Replicate(), Shard(1)], (64, 128))
    plain = torch.zeros(3)
    out = ctx.gather_fsdp({"w": w, "norm": norm, "heads": heads,
                           "plain": plain}, torch.bfloat16, ("norm",))
    assert list(out["w"].placements) == [Replicate(), Shard(1)]
    assert out["w"].dtype == torch.bfloat16
    assert out["w"].to_local().shape == (128, 128)
    assert list(out["norm"].placements) == [Replicate(), Replicate()]
    assert out["norm"].dtype == torch.float32
    assert out["heads"] is heads and out["plain"] is plain
    assert ctx.gather_fsdp(w).dtype == torch.float32
    assert NULL_CTX.gather_fsdp({"w": w})["w"] is w
    no_fsdp = ShardingCtx(mesh, make_profile("train", fsdp=False))
    assert no_fsdp.gather_fsdp(w, torch.bfloat16) is w
