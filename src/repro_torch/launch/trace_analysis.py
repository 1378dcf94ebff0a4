"""Per-device op analysis of one rank's run of a cell: FLOPs, bytes,
collectives (counterpart of ``repro.launch.hlo_analysis``).

``repro`` compiles a cell for placeholder devices and parses the
post-partitioning HLO text.  The port runs the cell on rank 0 of a "fake"
process group, on fake tensors that hold each rank's local shard, with
DTensor's sharding propagation in GSPMD's place (``launch.cells.lower_cell``).
``OpTrace``, a ``TorchDispatchMode`` below DTensor, records every local
ATen op the rank runs, including the collectives DTensor makes when it
redistributes (``_c10d_functional.*``) and those ``dist.all_gather``
makes (``c10d.*_``).  ``analyze`` prices the record by ``repro``'s rules:

  * dot FLOPs: 2 · prod(out_shape) · prod(contracting dims), for ``mm``,
    ``bmm``, ``addmm``, ``baddbmm`` and ``convolution``
  * collective bytes per device (ring approximations):
      all-gather → out_bytes, all-reduce → 2·out_bytes,
      reduce-scatter → in_bytes, all-to-all/collective-permute → out_bytes
  * HBM traffic proxy: Σ op output bytes × 2 (read+write) over every op
    that is not a view or a metadata op (``hbm_bytes``); ``hbm_bytes_fused``
    prices only the ATen counterparts of ``MEMORY_MOVING_KINDS``, and a
    scatter into a buffer (an in-place cache write) by the slice written

All numbers are PER DEVICE: the record holds the rank's local shapes.
DTensor's propagator also runs each new op once on fake tensors at global
shape; ``mute_propagation`` keeps that call out of the record.  Python
loops unroll, so the record needs no trip-count correction of its own;
``launch.cells`` extrapolates the layer and microbatch loops from runs at
fewer trips (``while_loops`` lists them).
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

# torch dtypes by their HLO names, so records price through DTYPE_BYTES
HLO_DTYPE = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.float8_e4m3fn: "f8e4m3fn", torch.float8_e5m2: "f8e5m2",
    torch.int16: "s16", torch.float16: "f16", torch.bfloat16: "bf16",
    torch.int32: "s32", torch.float32: "f32", torch.int64: "s64",
    torch.float64: "f64", torch.complex64: "c64", torch.complex128: "c128",
}

# Ops whose outputs genuinely move through HBM.  Pure elementwise / layout
# ops (add, exp, select, convert, broadcast, …) fuse into their
# producer/consumer in a fusing compiler — pricing each separately
# (hbm_bytes) models a fusion-less machine and overstates the memory term
# ~3-5x on attention loops.  ``hbm_bytes_fused`` prices only this set.
MEMORY_MOVING_KINDS = frozenset((
    "dot", "convolution", "gather", "scatter", "dynamic-slice",
    "dynamic-update-slice", "reduce", "reduce-window", "sort", "copy",
    "concatenate", "pad", "reverse", "transpose", "iota-nd",
    "rng", "rng-bit-generator",
))

# ATen op (overload packet name) → the HLO kind it lowers to; an op not
# listed is elementwise
ATEN_KINDS = {
    **dict.fromkeys(("mm", "bmm", "addmm", "baddbmm"), "dot"),
    "convolution": "convolution",
    **dict.fromkeys(("index", "gather", "index_select", "embedding",
                     "take_along_dim"), "gather"),
    **dict.fromkeys(("index_put", "index_put_", "_index_put_impl_",
                     "scatter", "scatter_", "scatter_add", "scatter_add_",
                     "scatter_reduce", "scatter_reduce_", "index_add",
                     "index_add_", "index_copy", "index_copy_",
                     "embedding_dense_backward"), "scatter"),
    **dict.fromkeys(("slice_scatter", "select_scatter",
                     "diagonal_scatter"), "dynamic-update-slice"),
    **dict.fromkeys(("sum", "mean", "amax", "amin", "max", "min", "argmax",
                     "argmin", "prod", "var", "std", "var_mean",
                     "linalg_vector_norm", "norm", "any", "all",
                     "logsumexp", "_softmax", "_log_softmax",
                     "_softmax_backward_data", "_log_softmax_backward_data"),
                    "reduce"),
    **dict.fromkeys(("cumsum", "cumprod", "logcumsumexp"), "reduce-window"),
    **dict.fromkeys(("sort", "topk"), "sort"),
    **dict.fromkeys(("clone", "copy_", "copy"), "copy"),
    "cat": "concatenate",
    "constant_pad_nd": "pad",
    "flip": "reverse",
    "roll": "concatenate",
    **dict.fromkeys(("randn", "rand", "normal", "normal_", "uniform_",
                     "bernoulli", "bernoulli_", "randint"), "rng"),
}

# the positional argument holding the update a scatter writes
UPDATE_ARG = {
    "index_put": 2, "index_put_": 2, "_index_put_impl_": 2,
    "scatter": 3, "scatter_": 3, "scatter_add": 3, "scatter_add_": 3,
    "scatter_reduce": 3, "scatter_reduce_": 3, "index_add": 3,
    "index_add_": 3, "index_copy": 3, "index_copy_": 3,
    "slice_scatter": 1, "select_scatter": 1, "diagonal_scatter": 1,
}

# (namespace, op) → (collective kind, what it is priced on)
COLLECTIVES = {
    ("_c10d_functional", "all_gather_into_tensor"): ("all-gather", "out"),
    ("_c10d_functional", "all_gather_into_tensor_coalesced"):
        ("all-gather", "out"),
    ("_c10d_functional", "all_reduce"): ("all-reduce", "out"),
    ("_c10d_functional", "all_reduce_coalesced"): ("all-reduce", "out"),
    ("_c10d_functional", "reduce_scatter_tensor"): ("reduce-scatter", "in"),
    ("_c10d_functional", "reduce_scatter_tensor_coalesced"):
        ("reduce-scatter", "in"),
    ("_c10d_functional", "all_to_all_single"): ("all-to-all", "out"),
    ("_c10d_functional", "broadcast"): ("collective-permute", "out"),
    ("c10d", "allgather_"): ("all-gather", "arg0"),
    ("c10d", "_allgather_base_"): ("all-gather", "arg0"),
    ("c10d", "allreduce_"): ("all-reduce", "arg0"),
    ("c10d", "reduce_scatter_"): ("reduce-scatter", "arg1"),
    ("c10d", "_reduce_scatter_base_"): ("reduce-scatter", "arg1"),
    ("c10d", "alltoall_"): ("all-to-all", "arg0"),
    ("c10d", "alltoall_base_"): ("all-to-all", "arg0"),
    ("c10d", "broadcast_"): ("collective-permute", "arg0"),
    ("_dtensor", "shard_dim_alltoall"): ("all-to-all", "out"),
}

# ops that allocate or only describe: no bytes move
FREE_OPS = frozenset((
    "empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
    "wait_tensor", "detach", "lift_fresh", "alias", "_unsafe_view",
    "lift_fresh_copy", "_wrap_tensor_autograd",
))


def _spec(x):
    """A record's view of one argument: ``[shape, hlo dtype]`` for a
    tensor, a list of those for a tensor list, None otherwise."""
    if isinstance(x, torch.Tensor):
        return [list(x.shape), HLO_DTYPE.get(x.dtype, "f32")]
    if isinstance(x, (list, tuple)) and x and all(
            isinstance(t, (torch.Tensor, list, tuple)) for t in x):
        return [_spec(t) for t in x]
    return None


def spec_bytes(spec) -> int:
    """Bytes of a record's argument or output spec; lists summed."""
    if spec is None:
        return 0
    if len(spec) == 2 and isinstance(spec[1], str):
        n = 1
        for d in spec[0]:
            n *= int(d)
        return n * DTYPE_BYTES[spec[1]]
    return sum(spec_bytes(s) for s in spec)


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _is_view(func) -> bool:
    """An op whose outputs alias its inputs without writing them."""
    returns = func._schema.returns
    return bool(returns) and all(
        r.alias_info is not None and not r.alias_info.is_write
        for r in returns)


def _allocates(func) -> bool:
    """An op whose outputs are new buffers (no output aliases an input)."""
    return all(r.alias_info is None for r in func._schema.returns)


class OpTrace(TorchDispatchMode):
    """Records every local op of this rank: ``records`` is a list of
    ``[op, kind, outs, args]`` (``op`` "namespace::name", ``kind`` "view",
    "free" or "op", ``outs`` / ``args`` the tensors' ``[shape, dtype]``).
    Ops on DTensors pass through (``NotImplemented``) to DTensor, whose
    local ops come back here; ops that touch no fake tensor (host
    arithmetic on small real ones) are not the rank's program.  Tracks the live bytes of the buffers the
    ops allocate and their peak (``peak_bytes``)."""

    def __init__(self):
        super().__init__()
        self.records: List[list] = []
        self.muted = 0
        self.live = 0
        self.peak_bytes = 0
        self.read = set()  # storages the ops read

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        name = func.name()
        ns, _, base = name.partition("::")
        base = base.split(".")[0]
        coll = (ns, base) in COLLECTIVES  # its inner ops are not the program's
        self.muted += coll
        try:
            out = func(*args, **kwargs)
        finally:
            self.muted -= coll
        if self.muted:
            return out
        outs = out if isinstance(out, (tuple, list)) else (out,)
        tensors = [t for t in _flat(outs) if isinstance(t, torch.Tensor)]
        ins = [t for t in list(_flat(args)) + list(_flat(kwargs.values()))
               if isinstance(t, FakeTensor)]
        if not ins and not any(isinstance(t, FakeTensor) for t in tensors):
            return out  # host arithmetic on small real tensors
        self.read.update(t.untyped_storage()._cdata for t in ins)
        if not tensors and not coll:
            return out  # metadata (prim.device, sym sizes, dtypes)
        kind = ("view" if _is_view(func) else
                "free" if base in FREE_OPS else "op")
        self.records.append([f"{ns}::{base}", kind,
                             [_spec(t) for t in tensors],
                             [_spec(a) for a in args]])
        if kind == "op" and _allocates(func):
            for t in tensors:
                n = _numel(t.shape) * t.element_size()
                self.live += n
                weakref.finalize(t, self._free, n)
            self.peak_bytes = max(self.peak_bytes, self.live)
        return out


def _flat(xs):
    for x in xs:
        if isinstance(x, (tuple, list)):
            yield from _flat(x)
        else:
            yield x


@contextlib.contextmanager
def mute_propagation(trace: OpTrace):
    """Keeps DTensor's sharding propagation out of ``trace``: the
    propagator runs each new op once on fake tensors at GLOBAL shape to
    learn its output's metadata, which no rank computes."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    names = [n for n in ("_propagate_tensor_meta_non_cached",
                         "_propagate_tensor_meta")
             if n in ShardingPropagator.__dict__]
    saved = {n: ShardingPropagator.__dict__[n] for n in names}

    def muted(fn):
        def run(*a, **k):
            trace.muted += 1
            try:
                return fn(*a, **k)
            finally:
                trace.muted -= 1
        return run

    for n in names:
        setattr(ShardingPropagator, n, muted(saved[n]))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ShardingPropagator, n, fn)


def _contract(base: str, args) -> int:
    """prod(contracting dims) of a dot or convolution from its operands."""
    if base in ("mm", "bmm"):
        return int(args[0][0][-1])
    if base in ("addmm", "baddbmm"):
        return int(args[1][0][-1])
    if base == "convolution":
        return _numel(args[1][0][1:])  # C_in / groups · kernel
    raise KeyError(base)


def analyze(records: List[list]) -> Dict:
    """Price one run's record (``OpTrace.records``) by the rules above;
    ``repro``'s keys."""
    totals = {
        "dot_flops": 0.0,
        "collective_bytes": 0.0,
        "hbm_bytes": 0.0,
        "hbm_bytes_fused": 0.0,
        "dot_count": 0.0,
        "conv_count": 0.0,
    }
    coll = defaultdict(lambda: {"count": 0.0, "bytes": 0.0})
    for name, kind, outs, args in records:
        ns, _, base = name.partition("::")
        if kind in ("view", "free"):
            continue
        out_b = spec_bytes(outs)
        c = COLLECTIVES.get((ns, base))
        if c is not None:
            ckind, on = c
            if on == "out":
                size = out_b
            elif on == "in":
                size = spec_bytes(args[0])
            else:
                size = spec_bytes(args[int(on[-1])])
            moved = 2.0 * size if ckind == "all-reduce" else float(size)
            coll[ckind]["count"] += 1
            coll[ckind]["bytes"] += moved
            totals["collective_bytes"] += moved
            totals["hbm_bytes"] += 2.0 * (out_b or size)
            totals["hbm_bytes_fused"] += 2.0 * (out_b or size)
            continue
        hlo = ATEN_KINDS.get(base, "elementwise")
        if hlo in ("dot", "convolution"):
            out_n = _numel(outs[0][0])
            totals["dot_flops"] += 2.0 * out_n * _contract(base, args)
            totals["dot_count" if hlo == "dot" else "conv_count"] += 1
        b = 2.0 * out_b
        totals["hbm_bytes"] += b
        if hlo in ("scatter", "dynamic-update-slice"):
            # an update into a buffer moves the slice it writes
            upd = UPDATE_ARG.get(base)
            if upd is not None and upd < len(args) and args[upd] is not None:
                b = 2.0 * spec_bytes(args[upd])
        if hlo in MEMORY_MOVING_KINDS:
            totals["hbm_bytes_fused"] += b
    return {
        **totals,
        "collectives": {k: dict(v) for k, v in coll.items()},
        "num_ops": float(sum(r[1] == "op" for r in records)),
    }


def combine(analyses: List[Dict], weights: List[float]) -> Dict:
    """Σ weight · analysis, key by key (collectives by kind): the value of
    a loop at its full trip count from runs at fewer trips."""
    out: Dict = {}
    coll: Dict = defaultdict(lambda: {"count": 0.0, "bytes": 0.0})
    for a, w in zip(analyses, weights):
        for k, v in a.items():
            if k == "collectives":
                for ck, cv in v.items():
                    coll[ck]["count"] += w * cv["count"]
                    coll[ck]["bytes"] += w * cv["bytes"]
            elif isinstance(v, (int, float)):
                out[k] = out.get(k, 0.0) + w * v
    out["collectives"] = {k: dict(v) for k, v in coll.items()
                          if v["count"] or v["bytes"]}
    return out


def analyze_trace(trace: Dict) -> Dict:
    """The analysis of a cell's trace (``launch.cells.CellTrace.to_json``):
    each run priced, then combined with the trace's weights."""
    out = combine([analyze(r) for r in trace["runs"]], trace["weights"])
    out["while_loops"] = list(trace.get("while_loops", []))
    return out
