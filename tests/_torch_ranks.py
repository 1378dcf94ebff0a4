"""Helper: run a function on N ranks of a gloo process group, and the
port's side of the multi-rank parity tests.

``run_ranks(fn, world, tmp_path, *args)`` spawns ``world`` processes with
``torch.multiprocessing`` (the spawn method), joins them in a
``file://`` rendezvous under ``tmp_path`` (so parallel test workers never
race for a port), sets ``torch.set_num_threads(1)`` in each, and calls
``fn(rank, world, *args)`` there; it returns the ranks' results in rank
order and fails the test with a rank's traceback, or after ``timeout``
seconds if a collective hangs.  ``fn`` must be a module-level function
(it is pickled by name): the ones here import the port and never JAX, so a
rank starts in a few seconds.
"""
import datetime
import os
import queue
import sys
import time
import traceback

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
TIMEOUT_S = 120


def _entry(rank, world, init_file, fn, args, out_q):
    if SRC not in sys.path:
        sys.path.insert(0, SRC)
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        out_q.put((rank, True, out))
    except BaseException:  # noqa: BLE001 — reported to the parent, re-raised there
        out_q.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world, tmp_path, *args, timeout=TIMEOUT_S):
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    init_file = os.path.join(str(tmp_path), f"rendezvous-{fn.__name__}")
    procs = [ctx.Process(target=_entry,
                         args=(r, world, init_file, fn, args, out_q))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            try:
                rank, ok, out = out_q.get(
                    timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                raise AssertionError(
                    f"{fn.__name__}: {world - len(results)} of {world} ranks "
                    f"did not finish in {timeout} s") from None
            assert ok, f"{fn.__name__}: rank {rank} failed:\n{out}"
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert not any(p.is_alive() for p in procs)
    return [results[r] for r in range(world)]


# ---------------------------------------------------------------------------
# Rank bodies: the port's side of the parity tests (numpy in, numpy out)
# ---------------------------------------------------------------------------

def sharded_search_rank(rank, world, db, params, hub_reps, hub_ids, queries,
                        knobs):
    """The sharded GATE search on a (2, 2) ("data", "model") CPU mesh:
    ``build_sharded_gate`` over ``knn_graph(R=16)`` local graphs, then
    ``make_search_step``.  Returns (ids, dists, this shard's local ids and
    distances, its shard index)."""
    from repro_torch.core.distributed import (
        build_sharded_gate, local_search, make_search_step, search_knobs,
        shard_index,
    )
    from repro_torch.core.twotower import TwoTowerConfig
    from repro_torch.graphs.knn import knn_graph
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh((2, 2), ("data", "model"), device="cpu")
    tcfg = TwoTowerConfig(d_p=db.shape[1])
    sg = build_sharded_gate(mesh, db, (tcfg, params), hub_reps, hub_ids,
                            lambda x, R: knn_graph(x, R, device="cpu"), R=16)
    step = make_search_step(mesh, tcfg, **knobs)
    ids, dists, hops = step(sg, queries)
    loc_ids, loc_d, _ = local_search(sg, queries, tcfg,
                                     **search_knobs(**knobs))
    return (ids.numpy(), dists.numpy(), loc_ids.numpy(), loc_d.numpy(),
            shard_index(mesh), hops.numpy())


def sharding_checks_rank(rank, world, ckpt_dir, repro_ckpt_dir, moe_params,
                         x, moe_kw):
    """Three checks on 4 CPU ranks, one spawn: ``elastic_restore`` from a
    (4,) "data" mesh and from ``repro``'s checkpoint onto a (2, 2) ("data",
    "model") mesh, ``cross_pod_grad_sync`` on a (2, 2) ("pod", "data")
    mesh, and the MoE dropping dispatch under a (2, 2) train-profile
    ``ShardingCtx``."""
    return {"restore": _elastic_restore(ckpt_dir, repro_ckpt_dir),
            "cross_pod": _cross_pod(),
            "moe": _moe_dropping(moe_params, x, moe_kw)}


def _elastic_restore(ckpt_dir, repro_ckpt_dir):
    """Save a (8, 2) array sharded over a (4,) "data" mesh, restore it (and
    ``repro``'s checkpoint of the same array) onto a (2, 2) ("data",
    "model") mesh sharded over both.  Per checkpoint: the local shard, the
    full tensor, the placements' reprs and ``extra``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.distributed.fault import restore_elastic
    from repro_torch.distributed.sharding import P, placements
    from repro_torch.launch.mesh import make_host_mesh

    mesh4 = make_host_mesh((4,), ("data",), device="cpu")
    w = distribute_tensor(torch.arange(16.0).reshape(8, 2), mesh4, [Shard(0)])
    CheckpointManager(ckpt_dir).save(5, {"params": {"w": w}},
                                     {"next_step": 5}, blocking=True)
    dist.barrier()
    mesh2 = make_host_mesh((2, 2), ("data", "model"), device="cpu")
    target = {"params": {"w": (mesh2, placements(mesh2, P("data", "model")))}}
    out = {}
    for name, d in (("port", ckpt_dir), ("repro", repro_ckpt_dir)):
        restored, extra = restore_elastic(d, target)
        got = restored["params"]["w"]
        out[name] = (got.to_local().numpy(), got.full_tensor().numpy(),
                     [repr(p) for p in got.placements], extra,
                     tuple(mesh2.get_coordinate()))
    return out


def _cross_pod():
    """``cross_pod_grad_sync`` on a (2, 2) ("pod", "data") CPU mesh, the
    gradient on pod i all i's: the synced gradient and the new error."""
    import torch

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.compress import cross_pod_grad_sync

    mesh = make_host_mesh((2, 2), ("pod", "data"), device="cpu")
    pod = mesh.get_coordinate()[0]
    g, e = cross_pod_grad_sync({"w": torch.full((8,), float(pod))},
                               {"w": torch.zeros(8)}, mesh, axis="pod")
    return g["w"].numpy(), e["w"].numpy()


def _moe_dropping(params, x, moe_kw):
    """The reduced qwen2-moe's dropping dispatch (``moe_kw`` on its MoE
    spec) under a (2, 2) ("data", "model") train-profile ``ShardingCtx``:
    the output, the aux term, the group count and the fallbacks."""
    import dataclasses

    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.distributed.sharding import ShardingCtx, make_profile
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe as tmoe

    mesh = make_host_mesh((2, 2), ("data", "model"), device="cpu")
    ctx = ShardingCtx(mesh, make_profile("train"))
    cfg = get_reduced("qwen2-moe-a2.7b")
    cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, **moe_kw))
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    with torch.no_grad():
        out, aux = tmoe.moe_ffn(torch.from_numpy(x), tp, "", cfg, ctx)
    return out.numpy(), float(aux), tmoe._dp_groups(ctx), ctx.fallbacks


def data_parallel_train_rank(rank, world, arch, rows, seq, micro, steps):
    """``steps`` sgd steps of ``arch``'s reduced config in float32 on one
    ``make_inputs`` batch of ``rows`` x ``seq`` (seed 0), under a (world,)
    "data" mesh and the train profile.  Returns (losses, final parameters,
    the step's batch axes); at one rank also the losses and parameters of
    the same steps without a sharding context."""
    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.sharding import ShardingCtx, make_profile
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model, make_inputs
    from repro_torch.train.loop import batch_axes, make_train_step
    from repro_torch.train.optim import sgd

    cfg = get_reduced(arch).with_(compute_dtype="float32")
    model = build_model(cfg)
    batch = make_inputs(cfg, ShapeSpec("t", "train", seq, rows), seed=0,
                        device="cpu")
    ctx = ShardingCtx(make_host_mesh((world,), ("data",), device="cpu"),
                      make_profile("train"))

    def run(ctx):
        params = model.init(torch.Generator().manual_seed(0))
        optim = sgd(1e-2)
        state = {"params": params, "opt": optim.init(params)}
        kw = {} if ctx is None else {"ctx": ctx}
        step = make_train_step(model, optim, num_microbatches=micro, **kw)
        losses = []
        for _ in range(steps):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        return losses, {n: p.numpy() for n, p in state["params"].items()}

    out = run(ctx) + (batch_axes(ctx, rows // micro),)
    return out + run(None) if world == 1 else out


def fake_mesh_shapes():
    """``make_production_mesh`` on a 512-rank "fake" process group in this
    one process: each mesh's axis sizes by name and its size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.distributed.sharding import mesh_shape
    from repro_torch.launch.mesh import make_production_mesh

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    try:
        m1 = make_production_mesh(device="cpu")
        m2 = make_production_mesh(multi_pod=True, device="cpu")
        return [(mesh_shape(m), m.size()) for m in (m1, m2)]
    finally:
        dist.destroy_process_group()


def vocab_parallel_ce_rank(rank, world, cases, embeds):
    """``next_token_ce`` and ``cross_entropy`` (no mask) on logits that are
    a DTensor sharded over a ("data", "model") mesh of ``(world // 2, 2)``:
    rows over "data", the vocabulary over "model"; the labels a DTensor
    sharded as the rows.  ``cases`` maps a name to (logits, labels) numpy
    arrays; returns per case and per loss the loss, the logits' whole
    gradient, the rank's shard of the logits and the shapes of the
    buffers every op of the loss and its backward made.  ``embeds`` maps a
    name to (table, tokens, cotangent): ``embed_rows(vocab_parallel=True)``
    of the table sharded as the train profile shards it, the rows and the
    table's gradient under ``sum(rows * cotangent)``, the same way."""
    import torch
    from torch.distributed.tensor import (
        DTensor, Replicate, Shard, distribute_tensor,
    )
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.common import (
        cross_entropy, embed_rows, next_token_ce,
    )

    class LocalShapes(TorchDispatchMode):
        """The shapes of the buffers ops allocate on this rank (a DTensor
        op is passed on to DTensor, whose local ops come back here; its
        sharding propagation's fake tensors at global shape, and views,
        allocate nothing)."""

        def __init__(self):
            super().__init__()
            self.shapes = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            if any(r.alias_info is not None for r in func._schema.returns):
                return out
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor) and t.device.type != "meta" \
                        and not isinstance(t, FakeTensor):
                    self.shapes.append(tuple(t.shape))
            return out

    mesh = make_host_mesh((world // 2, 2), ("data", "model"), device="cpu")
    out = {}
    for name, (logits, labels) in cases.items():
        for loss_name in ("next_token_ce", "cross_entropy"):
            lg = distribute_tensor(torch.from_numpy(logits), mesh,
                                   [Shard(0), Shard(2)])
            lg.requires_grad_(True)
            lb = distribute_tensor(torch.from_numpy(labels), mesh,
                                   [Shard(0), Replicate()])
            with LocalShapes() as rec:
                if loss_name == "next_token_ce":
                    loss = next_token_ce(lg, lb)
                else:
                    loss = cross_entropy(lg, torch.clamp_min(lb, 0))
                loss.backward()
            out[(name, loss_name)] = (loss.detach().full_tensor().numpy(),
                                      lg.grad.full_tensor().numpy(),
                                      lg.to_local().shape, rec.shapes)
    for name, (table, tokens, cot) in embeds.items():
        # the table as the train profile shards it: vocab over "model",
        # embed over "data" (FSDP); the tokens and the cotangent over rows
        emb = distribute_tensor(torch.from_numpy(table), mesh,
                                [Shard(1), Shard(0)])
        emb.requires_grad_(True)
        tk = distribute_tensor(torch.from_numpy(tokens), mesh,
                               [Shard(0), Replicate()])
        ct = distribute_tensor(torch.from_numpy(cot), mesh,
                               [Shard(0), Replicate()])
        with LocalShapes() as rec:
            rows = embed_rows(emb, tk, vocab_parallel=True)
            (rows * ct).sum().backward()
        out[(name, "embed_rows")] = (rows.detach().full_tensor().numpy(),
                                     emb.grad.full_tensor().numpy(),
                                     emb.to_local().shape, rec.shapes)
    return out
