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
    name to (table, tokens, cotangent): ``embed_rows``
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
            rows = embed_rows(emb, tk)
            (rows * ct).sum().backward()
        out[(name, "embed_rows")] = (rows.detach().full_tensor().numpy(),
                                     emb.grad.full_tensor().numpy(),
                                     emb.to_local().shape, rec.shapes)
    return out


def batch_local_state_rank(rank, world, cases):
    """``blockwise_attention``, ``wkv6_chunked`` and ``ssd_chunked`` on
    DTensors over a ("data", "model") mesh of ``(world // 2, 2)``, laid out
    as the train cells lay them out, plain tensors taken as replicated as
    the dry run takes them (``cases`` maps a name to the function's name,
    its numpy arguments and each argument's placements as (mesh dim,
    tensor dim or None) pairs); returns per case the outputs gathered
    whole, the all-gathers the call made, as (input shape, output shape),
    the floating arguments' gradients of the outputs' summed squares
    gathered whole, and the all-gathers of that backward."""
    import torch
    from torch.distributed.tensor import (
        DTensor, Replicate, Shard, distribute_tensor,
    )
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import common, rwkv, ssm

    fns = {"blockwise_attention": common.blockwise_attention,
           "wkv6_chunked": rwkv.wkv6_chunked, "ssd_chunked": ssm.ssd_chunked}

    class Gathers(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            if "all_gather" in func.name():
                self.seen.append((tuple(args[0].shape), tuple(out.shape)))
            return out

    mesh = make_host_mesh((world // 2, 2), ("data", "model"), device="cpu")
    out = {}
    for name, (fn, arrays, layouts, kw) in cases.items():
        args = []
        for a, lay in zip(arrays, layouts):
            pl = [Replicate(), Replicate()]
            for mesh_dim, dim in lay:
                pl[mesh_dim] = Shard(dim)
            t = distribute_tensor(torch.from_numpy(a), mesh, pl)
            args.append(t.requires_grad_(t.dtype.is_floating_point))
        with implicit_replication(), Gathers() as rec:
            res = fns[fn](*args, **kw)
        res = res if isinstance(res, tuple) else (res,)
        with implicit_replication(), Gathers() as rec_b:
            sum((r * r).sum() for r in res).backward()
        out[name] = ([r.detach().full_tensor().numpy() for r in res],
                     rec.seen,
                     [None if a.grad is None else a.grad.full_tensor().numpy()
                      for a in args], rec_b.seen)
    return out


def decode_lookup_head_rank(rank, world, cases):
    """A decode step's token lookup and LM head without a gradient on
    DTensors over a ("data", "model") mesh of ``(world // 2, 2)``: the
    table (V, d) and the head (d, V) sharded over "data" on ``d`` (FSDP)
    and, where ``whole_vocab`` is false, over "model" on the vocabulary;
    the tokens (B, 1) and the rows (B, 1, d) over "data".  ``cases`` maps
    a name to (table, tokens, head, x, whole_vocab); returns per case the
    rows and logits gathered whole and the largest element count any
    collective made."""
    import torch
    from torch.distributed.tensor import (
        DTensor, Replicate, Shard, distribute_tensor,
    )
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.common import embed_rows, head_logits

    class Largest(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.numel = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            if func.namespace == "_c10d_functional":
                for t in (out if isinstance(out, (list, tuple)) else (out,)):
                    if isinstance(t, torch.Tensor):
                        self.numel = max(self.numel, t.numel())
            return out

    mesh = make_host_mesh((world // 2, 2), ("data", "model"), device="cpu")
    out = {}
    for name, (table, tokens, head, x, whole_vocab) in cases.items():
        vocab = Replicate() if whole_vocab else None
        emb = distribute_tensor(torch.from_numpy(table), mesh,
                                [Shard(1), vocab or Shard(0)])
        hd = distribute_tensor(torch.from_numpy(head), mesh,
                               [Shard(0), vocab or Shard(1)])
        tk = distribute_tensor(torch.from_numpy(tokens), mesh,
                               [Shard(0), Replicate()])
        xs = distribute_tensor(torch.from_numpy(x), mesh,
                               [Shard(0), Replicate()])
        with torch.no_grad(), Largest() as rec:
            rows = embed_rows(emb, tk)
            logits = head_logits(xs, hd)
        out[name] = (rows.full_tensor().numpy(), logits.full_tensor().numpy(),
                     rec.numel)
    return out


class _Ops:
    """A dispatch mode below DTensor that records each local op's name,
    output shapes and dtypes and input shapes on this rank (DTensor's ops
    pass on to DTensor, whose local ops come back here); with
    ``local_only``, not the ops DTensor's sharding propagation runs on fake
    or meta tensors at the global shape."""

    @staticmethod
    def mode(local_only=False):
        import torch
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode

        class Ops(TorchDispatchMode):
            def __init__(self):
                super().__init__()
                self.seen = []

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                out = func(*args, **(kwargs or {}))
                if local_only and any(
                        isinstance(a, FakeTensor) or a.device.type == "meta"
                        for a in args if isinstance(a, torch.Tensor)):
                    return out
                outs = out if isinstance(out, (tuple, list)) else (out,)
                self.seen.append((
                    func.name(),
                    [(tuple(t.shape), str(t.dtype)) for t in outs
                     if isinstance(t, torch.Tensor)],
                    [tuple(a.shape) for a in args
                     if isinstance(a, torch.Tensor)]))
                return out

        return Ops()


def whole_vocab_ce_rank(rank, world, cases, chunk_bytes):
    """``next_token_ce`` on bf16 logits that are a DTensor sharded over
    the rows on "data" of a ("data", "model") mesh of ``(world // 2, 2)``
    and whole on the vocabulary (replicated over "model": a vocabulary the
    mesh does not divide), with ``CE_CHUNK_BYTES`` at ``chunk_bytes``.
    ``cases`` maps a name to (logits float32, labels); returns per case the
    loss, the logits' whole gradient (float32) and every op's output
    shapes and dtypes on this rank, forward and backward."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import common

    common.CE_CHUNK_BYTES = chunk_bytes
    mesh = make_host_mesh((world // 2, 2), ("data", "model"), device="cpu")
    out = {}
    for name, (logits, labels) in cases.items():
        lg = distribute_tensor(
            torch.from_numpy(logits).to(torch.bfloat16), mesh,
            [Shard(0), Replicate()]).requires_grad_(True)
        lb = distribute_tensor(torch.from_numpy(labels), mesh,
                               [Shard(0), Replicate()])
        with _Ops.mode() as rec:
            loss = common.next_token_ce(lg, lb)
            loss.backward()
        out[name] = (float(loss.detach().full_tensor()),
                     lg.grad.full_tensor().float().numpy(),
                     [o for _, outs, _ in rec.seen for o in outs])
    return out


def rms_norm_rank(rank, world, cases, chunk_bytes):
    """``rms_norm`` without a gradient on a (B, S, d) DTensor sharded over
    its rows on "data" of a ("data", "model") mesh of ``(world // 2, 2)``,
    replicated over "model" or (``pending``) a pending sum over it (the
    first "model" rank holds the rows, the other zeros), with
    ``NORM_CHUNK_BYTES`` at ``chunk_bytes``.  ``cases`` maps a name to (x
    float32, w float32, dtype name, pending); returns per case the whole
    output as float64 and every op's output shapes and dtypes on this
    rank."""
    import torch
    from torch.distributed.tensor import (
        DTensor, Partial, Replicate, Shard, distribute_tensor,
    )
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import common

    common.NORM_CHUNK_BYTES = chunk_bytes
    mesh = make_host_mesh((world // 2, 2), ("data", "model"), device="cpu")
    out = {}
    for name, (x, w, dtype, pending) in cases.items():
        xt = torch.from_numpy(x).to(getattr(torch, dtype))
        if pending:
            piece = distribute_tensor(xt, mesh, [Shard(0), Replicate()])
            local = piece.to_local()
            if mesh.get_coordinate()[1]:
                local = torch.zeros_like(local)
            xd = DTensor.from_local(local, mesh, [Shard(0), Partial()],
                                    run_check=False)
        else:
            xd = distribute_tensor(xt, mesh, [Shard(0), Replicate()])
        with torch.no_grad(), implicit_replication(), \
                _Ops.mode(local_only=True) as rec:
            y = common.rms_norm(xd, torch.from_numpy(w), 1e-6)
        out[name] = (y.full_tensor().double().numpy(),
                     [o for _, outs, _ in rec.seen for o in outs])
    return out


def decode_step_rank(rank, world, cases):
    """``wkv6_step``, ``ssd_decode_step`` and ``decode_attention`` without
    a gradient on DTensors over a ("data", "model") mesh of ``(world // 2,
    2)``, laid out as the decode cells lay them out (``cases`` maps a name
    to the function's name, its numpy arguments, each argument's
    placements as (mesh dim, tensor dim) pairs and keyword arguments; a
    plain tensor is taken as replicated); returns per case the outputs
    gathered whole, the all-gathers the call made, as (input shape, output
    shape), and the placements of the last output and of the last
    argument (a step's new and old state)."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import common, rwkv, ssm

    fns = {"wkv6_step": rwkv.wkv6_step, "ssd_decode_step": ssm.ssd_decode_step,
           "decode_attention": common.decode_attention}
    mesh = make_host_mesh((world // 2, 2), ("data", "model"), device="cpu")
    out = {}
    for name, (fn, arrays, layouts, kw) in cases.items():
        args = []
        for a, lay in zip(arrays, layouts):
            pl = [Replicate(), Replicate()]
            for mesh_dim, dim in lay:
                pl[mesh_dim] = Shard(dim)
            args.append(distribute_tensor(torch.from_numpy(a), mesh, pl))
        with torch.no_grad(), _Ops.mode() as rec:
            res = fns[fn](*args, **kw)
        res = res if isinstance(res, tuple) else (res,)
        out[name] = ([r.full_tensor().numpy() for r in res],
                     [(ins[0], outs[0][0]) for op, outs, ins in rec.seen
                      if "all_gather" in op],
                     (str(res[-1].placements), str(args[-1].placements)))
    return out


def held_remat_rank(rank, world, arch, rows, seq):
    """The loss and its gradients of ``arch``'s reduced config in float32
    with ``remat`` on and off, its parameters sharded as the train profile
    shards them over a ("data", "model") mesh of ``(world // 2, 2)`` and a
    batch of ``rows`` that the "data" axis does not divide (replicated
    over it, as the cells' fallback leaves it).  Returns per setting the
    loss, every parameter's whole gradient and the all-gathers of the
    forward and of the backward, as (input shape, output shape)."""
    import torch
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.sharding import ShardingCtx, make_profile
    from repro_torch.launch.cells import param_shardings
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model, make_inputs

    mesh = make_host_mesh((world // 2, 2), ("data", "model"), device="cpu")
    profile = make_profile("train")
    batch = make_inputs(get_reduced(arch), ShapeSpec("t", "train", seq, rows),
                        seed=0, device="cpu")
    out = {}
    for remat in (True, False):
        cfg = get_reduced(arch).with_(remat=remat)
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        shard = param_shardings(model, mesh, profile, [])
        dparams = {n: distribute_tensor(p, *shard[n]).requires_grad_(True)
                   for n, p in params.items()}
        dbatch = {k: distribute_tensor(v, mesh, [Replicate(), Replicate()])
                  for k, v in batch.items()}
        ctx = ShardingCtx(mesh, profile)
        with implicit_replication(), _Ops.mode() as fwd:
            loss, _ = model.loss(dparams, dbatch, ctx)
        names = sorted(dparams)
        with implicit_replication(), _Ops.mode() as bwd:
            grads = torch.autograd.grad(loss, [dparams[n] for n in names])
        out[remat] = (float(loss.detach().full_tensor()),
                      {n: g.full_tensor().numpy() for n, g in
                       zip(names, grads)},
                      [[(ins[0], outs[0][0]) for op, outs, ins in rec.seen
                        if "all_gather" in op] for rec in (fwd, bwd)])
    return out


def split_work_rank(rank, world, cases):
    """The loss and its gradients of a reduced config in float64, its
    parameters sharded as the train profile shards them over a ("data",
    "model") mesh and its batch a DTensor replicated over it, as a train
    cell's microbatch whose rows do not divide "data" lies (``cases``
    maps a name to (arch, config overrides, rows, seq, mesh shape)).
    Returns per case the loss, every parameter's whole gradient and, for
    each matrix product of the loss and its backward on this rank, its
    operands' shapes."""
    import torch
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.sharding import ShardingCtx, make_profile
    from repro_torch.launch.cells import param_shardings
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model, make_inputs

    profile = make_profile("train")
    out = {}
    for name, (arch, over, rows, seq, shape) in cases.items():
        cfg = get_reduced(arch).with_(param_dtype="float64",
                                      compute_dtype="float64", **over)
        mesh = make_host_mesh(tuple(shape), ("data", "model"), device="cpu")
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        batch = make_inputs(cfg, ShapeSpec("t", "train", seq, rows), seed=0,
                            device="cpu")
        shard = param_shardings(model, mesh, profile, [])
        dparams = {n: distribute_tensor(p, *shard[n]).requires_grad_(True)
                   for n, p in params.items()}
        dbatch = {k: distribute_tensor(v, mesh, [Replicate(), Replicate()])
                  for k, v in batch.items()}
        names = sorted(dparams)
        with implicit_replication(), _Ops.mode(local_only=True) as rec:
            loss, _ = model.loss(dparams, dbatch, ShardingCtx(mesh, profile))
            grads = torch.autograd.grad(loss, [dparams[n] for n in names])
        out[name] = (float(loss.detach().full_tensor()),
                     {n: g.full_tensor().numpy()
                      for n, g in zip(names, grads)},
                     [ins[:2] for op, _, ins in rec.seen
                      if op in ("aten::mm", "aten::bmm")])
    return out


def decode_model_rank(rank, world, cases):
    """One decode step of a reduced config in float64 on a ("data",
    "model") mesh of ``(world // 2, 2)``, its parameters, tokens, cache and
    positions laid out as a decode cell lays them out (the decode
    profile); ``cases`` maps a name to (arch, rows, cache length).
    Returns per case the logits and every cache entry gathered whole."""
    import torch
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.sharding import ShardingCtx, make_profile
    from repro_torch.launch.cells import (
        BATCH_AXES, CACHE_AXES, _tree_shardings, param_shardings,
    )
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model, make_cache, make_inputs
    from repro_torch.distributed.sharding import named_sharding

    mesh = make_host_mesh((world // 2, 2), ("data", "model"), device="cpu")
    profile = make_profile("decode")
    out = {}
    for name, (arch, rows, seq) in cases.items():
        cfg = get_reduced(arch).with_(param_dtype="float64",
                                      compute_dtype="float64")
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        shape = ShapeSpec("d", "decode", seq, rows)
        tokens = make_inputs(cfg, shape, seed=1, device="cpu")["tokens"]
        cache = make_cache(cfg, rows, seq, filled=seq // 2, device="cpu")
        g = torch.Generator().manual_seed(2)
        cache = {k: v if v.dtype == torch.int32 else
                 torch.randn(v.shape, generator=g, dtype=v.dtype)
                 for k, v in cache.items()}
        t = torch.full((rows,), seq // 2, dtype=torch.int32)
        ps = param_shardings(model, mesh, profile, [])
        cs = _tree_shardings({k: v for k, v in cache.items()}, CACHE_AXES,
                             mesh, profile, [], "cache")
        bs = _tree_shardings({"tokens": tokens}, BATCH_AXES, mesh, profile,
                             [], "batch")
        with implicit_replication(), torch.no_grad():
            logits, new = model.decode(
                {n: distribute_tensor(p, *ps[n]) for n, p in params.items()},
                distribute_tensor(tokens, *bs["tokens"]),
                {k: distribute_tensor(v, *cs[k]) for k, v in cache.items()},
                distribute_tensor(t, *named_sharding(
                    mesh, ("cache_batch",), t.shape, profile)),
                ShardingCtx(mesh, profile))
        out[name] = (logits.full_tensor().numpy(),
                     {k: v.full_tensor().numpy() for k, v in new.items()})
    return out


def moe_mesh_rank(rank, world, cases):
    """The reduced qwen2-moe's dropping dispatch on a (2, 2) ("data",
    "model") mesh under the train profile, its parameters laid out as a
    train cell lays them out and gathered over "data" as a loss-path layer
    gathers them (``ShardingCtx.gather_fsdp``), its input a DTensor
    sharded over its rows.  ``cases`` maps a name to (MoE spec overrides,
    dtype, parameters, input, output cotangent, the train profile's rule
    overrides), all numpy.  Returns per
    case, for the DTensor run and for the same dispatch on plain tensors
    under the same context (the group-local dispatch of one process): the
    output, the aux term, the gradients of ``(out · cotangent).sum() +
    aux`` with respect to the input and the three expert weights; and of
    the DTensor run, its output without a gradient, the group count, the fallbacks (the context's and
    ``ReplicateFallback``'s), the shapes the sort read on this rank and
    the local products' operand shapes."""
    import dataclasses

    import torch
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_reduced
    from repro_torch.distributed.sharding import (
        ShardingCtx, make_profile, named_sharding,
    )
    from repro_torch.launch.cells import ReplicateFallback
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe as tmoe

    device = "cpu"
    mesh = make_host_mesh((2, 2), ("data", "model"), device=device)
    wrt = ("we_gate", "we_up", "we_down")
    out = {}
    for name, (moe_kw, dtype, params, x, gy, rules) in cases.items():
        profile = make_profile("train").override(**rules)
        dt = getattr(torch, dtype)
        cfg = get_reduced("qwen2-moe-a2.7b").with_(param_dtype=dtype,
                                                   compute_dtype=dtype)
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, **moe_kw))
        table = tmoe.moe_param_table(cfg, "", 0)

        def run(ctx, put):
            p = {k: put(torch.from_numpy(v).to(device, dt),
                        table[k].axes).requires_grad_(True)
                 for k, v in params.items()}
            xt = put(torch.from_numpy(x).to(device, dt),
                     ("act_batch", "act_seq", "act_embed")
                     ).requires_grad_(True)
            o, aux = tmoe.moe_ffn(xt, ctx.gather_fsdp(p, dt), "", cfg, ctx)
            g = put(torch.from_numpy(gy).to(device, dt),
                    ("act_batch", "act_seq", "act_embed"))
            grads = torch.autograd.grad((o * g).sum() + aux,
                                        [xt] + [p[k] for k in wrt])
            return [t.full_tensor() if hasattr(t, "full_tensor") else t
                    for t in [o, aux] + list(grads)]

        def dist_put(t, axes):
            return distribute_tensor(
                t, *named_sharding(mesh, axes, t.shape, profile))

        ctx = ShardingCtx(mesh, profile)
        fallbacks = []
        with implicit_replication(), _Ops.mode(local_only=True) as rec, \
                ReplicateFallback(fallbacks):
            got = run(ctx, dist_put)
        with implicit_replication(), torch.no_grad():  # a prefill's way
            p = {k: dist_put(torch.from_numpy(v).to(device, dt),
                             table[k].axes) for k, v in params.items()}
            o, _ = tmoe.moe_ffn(
                dist_put(torch.from_numpy(x).to(device, dt),
                         ("act_batch", "act_seq", "act_embed")),
                ctx.gather_fsdp(p, dt), "", cfg, ShardingCtx(mesh, profile))
            no_grad = o.full_tensor()
        plain = run(ShardingCtx(mesh, profile), lambda t, axes: t)
        out[name] = {
            "mesh": [t.detach().cpu().numpy() for t in got],
            "plain": [t.detach().cpu().numpy() for t in plain],
            "no_grad": no_grad.cpu().numpy(),
            "groups": tmoe._dp_groups(ctx),
            "fallbacks": ctx.fallbacks + fallbacks,
            "sorted": [ins[0] for op, _, ins in rec.seen
                       if op.split(".")[0] == "aten::sort"],
            "products": [ins[:2] for op, _, ins in rec.seen
                         if op in ("aten::mm", "aten::bmm")]}
    return out
