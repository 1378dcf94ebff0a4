"""Cell assembly: (arch × shape × mesh) → step fn + specs + shardings
(counterpart of ``repro.launch.cells``).

This is the single place that decides how every dry-run/launch cell is sharded:
parameter shardings come from each model's param_table logical axes, batch and
cache shardings from per-model cache axis tables, all resolved through the
profile rules with divisibility fallbacks recorded for the roofline report.
A sharding is ``(mesh, placements)`` per leaf, what ``named_sharding``
returns.

``lower_cell`` is the port's counterpart of ``jax.jit(...).lower``: it runs
the cell on rank 0 of the mesh's process group (a "fake" group for the dry
run), on fake tensors that hold the rank's local shard, as DTensors placed
by the cell's shardings, so DTensor's sharding propagation decides the
collectives as GSPMD does for ``repro``.  It returns a ``CellTrace`` of
every local op (``launch.trace_analysis``).  An op DTensor cannot shard
as its inputs lie (no strategy, or a view of an uneven shard) runs on
replicated inputs instead, the redistribution priced and recorded in the
cell's ``fallbacks``.

The layer and microbatch loops are Python loops, unrolled: a prefill of
32k tokens runs tens of thousands of ops a layer.  So ``lower_cell`` runs
the cell at a few small trip counts (1–2 layers, 2–3 microbatches) and
extrapolates every count to the cell's own, exactly where each trip costs
the same: the counterpart of ``repro``'s while-loop trip-count correction.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import sys
from collections import Counter
from fractions import Fraction
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed.sharding import (
    ShardingCtx,
    ShardingProfile,
    make_profile,
    named_sharding,
)
from repro_torch.launch.trace_analysis import _flat, _is_view, _numel
from repro_torch.models.common import TensorSpec
from repro_torch.models.model import batch_specs, build_model
from repro_torch.train.loop import make_train_step, train_state_specs
from repro_torch.train.optim import adamw

# global-batch microbatch counts for train cells (memory lever; copied from
# ``repro``, which tuned them from its dry-run memory analysis)
TRAIN_MICROBATCHES: Dict[str, int] = {
    "mistral-large-123b": 32,
    "mixtral-8x22b": 16,
    "internvl2-26b": 16,
    "qwen2.5-32b": 16,
    "llama3-8b": 8,
    "qwen2-moe-a2.7b": 8,
    "gemma-2b": 4,
    "zamba2-1.2b": 4,
    "rwkv6-1.6b": 4,
    "seamless-m4t-medium": 4,
}

BATCH_AXES: Dict[str, Tuple] = {
    "tokens": ("act_batch", None),
    "labels": ("act_batch", None),
    "frames": ("act_batch", "act_seq", "act_embed"),
    "patches": ("act_batch", None, None),
}

CACHE_AXES: Dict[str, Tuple] = {
    "k": ("layers", "cache_batch", "cache_seq", "cache_heads", None),
    "v": ("layers", "cache_batch", "cache_seq", "cache_heads", None),
    "xk": ("layers", "cache_batch", "cache_seq", "cache_heads", None),
    "xv": ("layers", "cache_batch", "cache_seq", "cache_heads", None),
    "pos": ("cache_batch", "cache_seq"),
    "enc_pos": ("cache_batch", "cache_seq"),
    "ssm": ("layers", "cache_batch", "cache_heads", None, None),
    "conv": ("layers", "cache_batch", None, "act_ff"),
    "wkv": ("layers", "cache_batch", "cache_heads", None, None),
    "shift_t": ("layers", "cache_batch", None),
    "shift_c": ("layers", "cache_batch", None),
}


@dataclasses.dataclass
class Loops:
    """The Python loops ``lower_cell`` extrapolates: ``full`` the cell's
    trip count per loop, ``points`` the trip counts it runs, ``build``
    the cell at a point, and ``monomials`` the products of loops the
    cell's counts are affine in (every count is Σ coefficient · monomial)."""

    full: Dict[str, int]
    points: List[Dict[str, int]]
    build: Callable[[Dict[str, int]], "Cell"]
    monomials: List[Tuple[str, ...]]

    def weights(self) -> List[Fraction]:
        """w with Σ w_i · count(point_i) = count(full) for every count
        affine in the monomials (exact, in rationals)."""
        def row(pt):
            out = []
            for m in self.monomials:
                v = Fraction(1)
                for name in m:
                    v *= pt[name]
                out.append(v)
            return out

        A = [row(p) for p in self.points]  # n × n
        t = row(self.full)
        n = len(A)
        # solve Aᵀ w = t by Gauss-Jordan elimination
        M = [[A[j][i] for j in range(n)] + [t[i]] for i in range(n)]
        for c in range(n):
            piv = next(r for r in range(c, n) if M[r][c] != 0)
            M[c], M[piv] = M[piv], M[c]
            M[c] = [x / M[c][c] for x in M[c]]
            for r in range(n):
                if r != c and M[r][c] != 0:
                    f = M[r][c]
                    M[r] = [a - f * b for a, b in zip(M[r], M[c])]
        return [M[i][n] for i in range(n)]

    def peak(self, runs: List[Dict]) -> int:
        """The temporaries' peak at the full trip counts from the runs'
        (``temp``, and ``held``, the carried state's peak net of the
        outputs, as ``temp`` is the peak net of them).

        A peak is a maximum over the run's phases, not a sum, so the
        affine weights do not apply: a run's peak may sit in a transient
        of one trip where the full run's sits in the state the loop
        carries, and the weights of products of loops (±2,500 at 88 layers
        × 32 microbatches) turn MBs of difference between runs into GBs.
        Each loop's growth is fitted on its own (least squares over the
        main-effect monomials, no product of two loops: a peak lies
        within one trip of an outer loop), for the peak and for the held
        state, and the steeper of the two is taken, never below 0; each
        run plus that growth up to the full trips bounds the full run's
        peak from above wherever every phase grows no faster, so the
        least of them is taken, and never less than any run's."""
        import numpy as np

        main = [m for m in self.monomials if len(set(m)) <= 1]

        def value(m, pt):
            v = 1
            for name in m:
                v *= pt[name]
            return v

        A = np.array([[value(m, r["point"]) for m in main] for r in runs],
                     dtype=np.float64)

        def growth(key):
            c = np.linalg.lstsq(A, np.array([r[key] for r in runs],
                                            dtype=np.float64), rcond=None)[0]
            out = []
            for r in runs:
                g = 0.0
                for loop in self.full:
                    g += max(0.0, sum(
                        ci * (value(m, self.full) - value(m, r["point"]))
                        for ci, m in zip(c, main) if m and m[0] == loop))
                out.append(g)
            return out

        grow = [max(a, b) for a, b in zip(growth("temp"), growth("held"))]
        bound = min(r["temp"] + g for r, g in zip(runs, grow))
        # to the byte: the least squares' float noise is no growth
        return int(math.ceil(round(max(bound, max(r["temp"] for r in runs)),
                                   3)))


@dataclasses.dataclass
class Cell:
    name: str
    fn: Any  # callable to run
    args: Tuple  # TensorSpecs / meta tensors, global shapes
    in_shardings: Tuple
    out_shardings: Any
    donate_argnums: Tuple[int, ...]
    fallbacks: List[str]
    ctx: ShardingCtx
    local: bool = False  # args are each rank's shard (``shard_map`` body)
    loops: Optional[Loops] = None


def profile_for(shape: ShapeSpec) -> ShardingProfile:
    if shape.kind == "train":
        return make_profile("train")
    if shape.kind == "prefill":
        return make_profile("prefill")
    if shape.name.startswith("long"):
        return make_profile("long")
    return make_profile("decode")


def param_shardings(model, mesh, profile, fallbacks):
    table = model.param_table()
    return {
        name: named_sharding(
            mesh, spec.axes, spec.shape, profile, fallbacks, context=name
        )
        for name, spec in table.items()
    }


def _tree_shardings(specs, axes_table, mesh, profile, fallbacks, context):
    out = {}
    for k, s in specs.items():
        axes = axes_table.get(k)
        if axes is None or len(axes) != len(s.shape):
            axes = (None,) * len(s.shape)
        out[k] = named_sharding(
            mesh, axes, s.shape, profile, fallbacks, context=f"{context}/{k}"
        )
    return out


def _replicated(mesh: DeviceMesh):
    return mesh, tuple(Replicate() for _ in range(mesh.ndim))


def prefill_out_specs(cfg: ModelConfig, shape: ShapeSpec):
    """(logits spec, cache specs) of the model's ``prefill`` on the cell's
    batch (``repro`` calls ``jax.eval_shape``): runs on meta tensors at the
    cell's loop points, each chunk loop one chunk (which changes no
    output's shape), every dimension extrapolated to the cell's own trips
    as ``lower_cell`` extrapolates counts."""
    full, pts, monos, at = _trips(cfg, shape, 1)
    w = Loops(full, pts, None, monos).weights()
    runs = []
    for p in pts:
        c, s, _ = at(p)
        model = build_model(c.with_(attn_chunk=s.seq_len, ssm_chunk=s.seq_len,
                                    rwkv_chunk=s.seq_len))
        params = {n: torch.empty(t.shape, dtype=t.dtype, device="meta")
                  for n, t in model.param_specs().items()}
        batch = {k: torch.empty(t.shape, dtype=t.dtype, device="meta")
                 for k, t in batch_specs(c, s).items()}
        with torch.no_grad():
            logits, cache = model.prefill(params, batch)
        runs.append({"logits": logits, **cache})

    def spec(k):
        dims = zip(*(r[k].shape for r in runs))
        return TensorSpec(tuple(int(sum(wi * d for wi, d in zip(w, ds)))
                                for ds in dims), runs[0][k].dtype)

    return spec("logits"), {k: spec(k) for k in runs[0] if k != "logits"}


def build_cell(
    cfg: ModelConfig,
    shape: ShapeSpec,
    mesh,
    *,
    profile: Optional[ShardingProfile] = None,
    num_microbatches: Optional[int] = None,
) -> Cell:
    profile = profile or profile_for(shape)
    fallbacks: List[str] = []
    ctx = ShardingCtx(mesh, profile)
    model = build_model(cfg)
    p_shard = param_shardings(model, mesh, profile, fallbacks)
    replicated = _replicated(mesh)
    nm = num_microbatches or TRAIN_MICROBATCHES.get(cfg.name, 4)
    loops = _loops(cfg, shape, mesh, profile, nm)

    if shape.kind == "train":
        optim = adamw(lr=3e-4, warmup=100, total_steps=100_000)
        step = make_train_step(model, optim, num_microbatches=nm, ctx=ctx)
        state_specs = train_state_specs(model, optim)
        b_specs = batch_specs(cfg, shape)
        state_shardings = {
            "params": p_shard,
            "opt": {
                "m": p_shard,
                "v": p_shard,
                "step": replicated,
            },
        }
        b_shardings = _tree_shardings(
            b_specs, BATCH_AXES, mesh, profile, fallbacks, "batch"
        )
        metrics_shardings = {
            k: replicated for k in ("loss", "grad_norm", "ce", "aux")
        }
        return Cell(
            name=f"{cfg.name}:{shape.name}",
            fn=step,
            args=(state_specs, b_specs),
            in_shardings=(state_shardings, b_shardings),
            out_shardings=(state_shardings, metrics_shardings),
            donate_argnums=(0,),
            fallbacks=fallbacks,
            ctx=ctx,
            loops=loops,
        )

    if shape.kind == "prefill":
        b_specs = batch_specs(cfg, shape)
        b_shardings = _tree_shardings(
            b_specs, BATCH_AXES, mesh, profile, fallbacks, "batch"
        )

        def prefill(params, batch):
            return model.prefill(params, batch, ctx)

        # out_shardings MUST pin the KV cache to (batch, seq) shards, as
        # ``repro``'s do: an unspecified output stays as the step leaves it
        logits_s, cache_s = prefill_out_specs(cfg, shape)
        logits_shard = named_sharding(
            mesh, ("act_batch", "act_vocab"), logits_s.shape, profile,
            fallbacks, "logits",
        )
        c_shardings = _tree_shardings(
            cache_s, CACHE_AXES, mesh, profile, fallbacks, "cache"
        )
        return Cell(
            name=f"{cfg.name}:{shape.name}",
            fn=prefill,
            args=(model.param_specs(), b_specs),
            in_shardings=(p_shard, b_shardings),
            out_shardings=(logits_shard, c_shardings),
            donate_argnums=(),
            fallbacks=fallbacks,
            ctx=ctx,
            loops=loops,
        )

    # decode
    b_specs = batch_specs(cfg, shape)
    cache_specs = model.cache_specs(shape.global_batch, shape.seq_len)
    t_spec = TensorSpec((shape.global_batch,), torch.int32)
    b_shardings = _tree_shardings(
        b_specs, BATCH_AXES, mesh, profile, fallbacks, "batch"
    )
    c_shardings = _tree_shardings(
        cache_specs, CACHE_AXES, mesh, profile, fallbacks, "cache"
    )
    t_shard = named_sharding(
        mesh, ("cache_batch",), t_spec.shape, profile, fallbacks, "t"
    )

    def decode(params, tokens, cache, t):
        return model.decode(params, tokens, cache, t, ctx)

    return Cell(
        name=f"{cfg.name}:{shape.name}",
        fn=decode,
        args=(model.param_specs(), b_specs["tokens"], cache_specs, t_spec),
        in_shardings=(p_shard, b_shardings["tokens"], c_shardings, t_shard),
        out_shardings=(None, c_shardings),
        donate_argnums=(2,),
        fallbacks=fallbacks,
        ctx=ctx,
        loops=loops,
    )


# ------------------------------------------------------------------ loops
def _layer_loops(cfg: ModelConfig):
    """(the layer loops' full trip counts, the points run, the config at a
    point): one trip count per loop, affine in each."""
    if cfg.family == "audio":
        full = {"enc_layers": cfg.encoder_layers, "layers": cfg.num_layers}
        pts = [{"enc_layers": 2, "layers": 2}, {"enc_layers": 3, "layers": 2},
               {"enc_layers": 2, "layers": 3}]
        return full, pts, lambda p: cfg.with_(encoder_layers=p["enc_layers"],
                                              num_layers=p["layers"])
    if cfg.family == "hybrid":
        # Mamba blocks and shared-block applications (one every attn_every)
        full = {"layers": cfg.num_layers,
                "shared": cfg.num_layers // cfg.attn_every}
        pts = [{"layers": 2, "shared": 2}, {"layers": 3, "shared": 3},
               {"layers": 4, "shared": 2}]
        return full, pts, lambda p: cfg.with_(
            num_layers=p["layers"], attn_every=p["layers"] // p["shared"])
    full = {"layers": cfg.num_layers}
    pts = [{"layers": 2}, {"layers": 3}]
    return full, pts, lambda p: cfg.with_(num_layers=p["layers"])


Q_CHUNK = 512  # blockwise_attention's query chunk


def _seq_points(cfg: ModelConfig, seq_len: int) -> Optional[List[int]]:
    """Three prompt lengths for a prefill's sequence loops (the attention's
    query × key chunks, the scans' chunks): ``seq_len``/8, /4 and /2 (or
    /4, /2 and 3/4 past a window), so each count is a quadratic in the
    length as at ``seq_len``, with the same powers of two dividing the
    chunk counts (DTensor shards a dimension by what divides it); None
    when they fall off the chunks' grid, below the first query chunk's
    split or inside the window."""
    step = math.lcm(cfg.attn_chunk, Q_CHUNK, cfg.ssm_chunk, cfg.rwkv_chunk)
    for pts in ([seq_len // 8, seq_len // 4, seq_len // 2],
                [seq_len // 4, seq_len // 2, 3 * seq_len // 4]):
        if all(p % step == 0 and p > Q_CHUNK and p > (cfg.window or 0)
               for p in pts):
            return pts
    return None


def _trips(cfg, shape, nm):
    """A cell's loops: (full trip counts, the points run, the monomials
    every count is affine in, ``at(point) -> (cfg, shape, microbatches)``).
    The layer loops; for a train cell of M ≥ 2 microbatches the microbatch
    loop (2 and 3 microbatches of the cell's size); for a long prefill the
    sequence loops (three prompt lengths)."""
    full, pts, at_layers = _layer_loops(cfg)
    monos = [()] + [(n,) for n in full]
    micro = shape.kind == "train" and nm >= 2
    if micro:
        rows = shape.global_batch // nm
        full = {**full, "micro": nm}
        pts = [{**p, "micro": m} for m in (2, 3) for p in pts]
        monos = monos + [m + ("micro",) for m in monos]
    seqs = _seq_points(cfg, shape.seq_len) if shape.kind == "prefill" \
        else None
    if seqs:
        full = {**full, "seq": shape.seq_len}
        pts = [{**p, "seq": s} for s in seqs for p in pts]
        monos = [m + e for e in ((), ("seq",), ("seq", "seq"))
                 for m in monos]

    def at(p):
        s = shape
        if micro:
            s = dataclasses.replace(s, global_batch=rows * p["micro"])
        if seqs:
            s = dataclasses.replace(s, seq_len=p["seq"])
        return at_layers(p), s, p["micro"] if micro else nm

    return full, pts, monos, at


def _loops(cfg, shape, mesh, profile, nm) -> Loops:
    full, pts, monos, at = _trips(cfg, shape, nm)

    def build(p):
        c, s, m = at(p)
        return dataclasses.replace(
            build_cell(c, s, mesh, profile=profile, num_microbatches=m),
            loops=None)

    return Loops(full=full, points=pts, build=build, monomials=monos)


# ----------------------------------------------------------------- lowering
@dataclasses.dataclass
class MemoryAnalysis:
    """Per-device bytes (``compiled.memory_analysis()``'s names): the
    arguments' local shards, the outputs', the peak of the buffers the run
    allocates beyond its outputs, and the donated bytes an output reuses.
    No code is generated, so ``generated_code_size_in_bytes`` is absent."""

    argument_size_in_bytes: int
    output_size_in_bytes: int
    temp_size_in_bytes: int
    alias_size_in_bytes: int


@dataclasses.dataclass
class CellTrace:
    """What ``lower_cell`` returns: each run's op record (``runs``), the
    weights that combine the runs into the cell's own trip counts, the
    memory and the fallbacks the runs took, and each run's point, temp,
    held state and largest buffers live at its peak (``peaks``)."""

    runs: List[list]
    weights: List[float]
    memory: MemoryAnalysis
    fallbacks: List[str]
    while_loops: List[Dict]
    peaks: List[Dict] = dataclasses.field(default_factory=list)

    def memory_analysis(self) -> MemoryAnalysis:
        return self.memory

    def cost_analysis(self) -> Dict:
        """The op analysis (``trace_analysis.analyze``), combined; not
        XLA's cost analysis, which counts loop bodies once."""
        from repro_torch.launch.trace_analysis import analyze_trace
        return analyze_trace(self.to_json())

    def to_json(self) -> Dict:
        return {"runs": self.runs, "weights": self.weights,
                "while_loops": self.while_loops}


def _is_leaf(x) -> bool:
    return isinstance(x, (TensorSpec, torch.Tensor))


def _is_sharding(x) -> bool:
    return (isinstance(x, tuple) and len(x) == 2
            and isinstance(x[0], DeviceMesh))


def _zip_map(fn, tree, shardings):
    """``fn(leaf, sharding)`` over ``tree``; ``shardings`` may be a prefix
    of it (one sharding for a whole subtree), or None."""
    if _is_leaf(tree) or tree is None:
        return fn(tree, shardings) if tree is not None else None
    if _is_sharding(shardings) or shardings is None:
        return _zip_map(fn, tree, _broadcast(tree, shardings))
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, shardings[k]) for k, v in tree.items()}
    if hasattr(tree, "_fields"):  # NamedTuple
        return type(tree)(*(_zip_map(fn, v, s)
                            for v, s in zip(tree, shardings)))
    return type(tree)(_zip_map(fn, v, s) for v, s in zip(tree, shardings))


def _broadcast(tree, sh):
    if _is_leaf(tree):
        return sh
    if isinstance(tree, dict):
        return {k: sh for k in tree}
    if hasattr(tree, "_fields"):
        return type(tree)(*(sh for _ in tree))
    return type(tree)(sh for _ in tree)


def _leaves(tree) -> list:
    if _is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return []


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def local_shape(shape, sharding) -> Tuple[int, ...]:
    """This rank's shard of a global ``shape`` under ``(mesh,
    placements)`` (DTensor's chunking: an uneven shard gives the first
    ranks one row more)."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )
    mesh, placements = sharding
    return tuple(compute_local_shape_and_global_offset(
        torch.Size(shape), mesh, placements)[0])


def argument_bytes(cell: Cell, used=None) -> int:
    """The local shards' bytes of the arguments (those whose flat leaf
    index is in ``used``, when given: XLA drops the arguments a program
    never reads from ``argument_size_in_bytes``, and so does this)."""
    total = []

    def one(spec, sh):
        total.append(_numel(local_shape(spec.shape, sh))
                     * torch.empty((), dtype=spec.dtype).element_size())

    for a, s in zip(cell.args, cell.in_shardings):
        _zip_map(one, a, s)
    return sum(b for i, b in enumerate(total) if used is None or i in used)


class ReplicateFallback(TorchDispatchMode):
    """A dispatch mode above DTensor: an op whose sharding propagation
    fails runs again with its inputs replicated but for their shards of
    dimension 0 (the batch, in every rule's layout), then replicated over
    the whole mesh, then, if DTensor has no strategy for it at all, on the
    whole tensors with its outputs replicated; and a view of a masked
    partial (a vocab-sharded gather's output, whose mask DTensor keeps at
    the gather's shape) gets it reduced first.  Each such op is recorded
    once in ``fallbacks``, in ``repro``'s fallback words."""

    def __init__(self, fallbacks: List[str]):
        super().__init__()
        self.fallbacks = fallbacks

    def _note(self, msg: str) -> None:
        if msg not in self.fallbacks:
            self.fallbacks.append(msg)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        if _is_view(func) and any(_masked(a) for a in args):
            self._note(f"op/{func}: a view of a masked partial; reduced")
            args = tuple(_reduce_masked(a) for a in args)
        errors = (RuntimeError, NotImplementedError, AssertionError,
                  IndexError)
        try:
            return func(*args, **kwargs)
        except errors as e:  # an empty message: the exception's type
            why = (str(e).strip().splitlines() or [type(e).__name__])[0]
            why = why[:160]
        for relax, words in ((_keep_dim0, "replicated but dim 0"),
                             (_replicate, "replicated")):
            r_args, r_kwargs = tree_map(relax, (args, kwargs))
            try:
                out = func(*r_args, **r_kwargs)
                break
            except errors:
                continue
        else:  # no strategy at all: the op on the whole tensors
            args, kwargs = tree_map(_replicate, (args, kwargs))
            mesh = next(a.device_mesh for a in _flat(args)
                        if isinstance(a, DTensor))
            rep = [Replicate()] * mesh.ndim
            largs, lkwargs = tree_map(_local, (args, kwargs))
            out = tree_map(
                lambda t: DTensor.from_local(t, mesh, rep, run_check=False)
                if isinstance(t, torch.Tensor) else t,
                func(*largs, **lkwargs))
        self._note(f"op/{func}: no sharding for its inputs ({why}); {words}")
        return out


def _masked(a) -> bool:
    return isinstance(a, DTensor) and any(
        type(p).__name__ == "_MaskPartial" for p in a.placements)


def _reduce_masked(a):
    if not _masked(a):
        return a
    return a.redistribute(a.device_mesh, [
        Replicate() if type(p).__name__ == "_MaskPartial" else p
        for p in a.placements])


def _replicate(a):
    if isinstance(a, DTensor):
        m = a.device_mesh
        with torch.no_grad():  # below autograd: no graph to keep
            return a.detach().redistribute(m, [Replicate()] * m.ndim)
    return a


def _keep_dim0(a):
    if not isinstance(a, DTensor):
        return a
    with torch.no_grad():
        return a.detach().redistribute(a.device_mesh, [
            p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in a.placements])


class FakeLocal(TorchDispatchMode):
    """The bottom dispatch mode of a run: an op on a fake tensor runs on
    fake tensors, and so does a factory (an op with no tensor input),
    unless DTensor's own code calls it: its shard bookkeeping builds index
    tensors on the host and reads them back, which it does for real, at no
    cost to the device."""

    def __init__(self, fake):
        super().__init__()
        self.fake = fake

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch._subclasses.fake_tensor import FakeTensor
        leaves = [x for x in _flat(list(args) + list(kwargs.values()))
                  if isinstance(x, torch.Tensor)]
        if any(isinstance(x, FakeTensor) for x in leaves) or (
                not leaves and not _called_by_dtensor()):
            with self.fake:
                return func(*args, **kwargs)
        return func(*args, **kwargs)


def _called_by_dtensor() -> bool:
    """Whether the nearest caller outside the dispatch machinery (PyTorch's
    and the dispatch modes') is DTensor's own code."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename.replace(os.sep, "/")
        if "/torch/distributed/tensor/" in name or \
                "/torch/distributed/_local_tensor/" in name:
            return True
        if "/torch/" not in name and f.f_code.co_name != "__torch_dispatch__":
            return False
        f = f.f_back
    return False


def _run(cell: Cell) -> Dict:
    """One run of ``cell`` on rank 0: its op record, output / temp / alias
    bytes and the fallbacks it took."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.trace_analysis import OpTrace, mute_propagation

    fake = FakeTensorMode(allow_non_fake_inputs=True)

    def materialize(spec, sh):
        mesh, placements = sh
        shape = local_shape(spec.shape, sh)
        with fake:
            loc = torch.empty(shape, dtype=spec.dtype,
                              device=mesh.device_type)
        if cell.local:
            return loc
        return DTensor.from_local(
            loc, mesh, placements, run_check=False,
            shape=torch.Size(spec.shape),
            stride=torch.empty(spec.shape, device="meta").stride())

    args = tuple(_zip_map(materialize, a, s)
                 for a, s in zip(cell.args, cell.in_shardings))
    trace, op_fallbacks = OpTrace(), []
    cell.ctx.fallbacks = []
    # a cell of local shards has no DTensor to propagate or fall back
    with contextlib.ExitStack() as stack:
        if not cell.local:
            stack.enter_context(mute_propagation(trace))
            stack.enter_context(implicit_replication())
        stack.enter_context(FakeLocal(fake))
        stack.enter_context(trace)
        if not cell.local:
            stack.enter_context(ReplicateFallback(op_fallbacks))
        out = cell.fn(*args)
        if cell.out_shardings is not None:
            out = _zip_map(
                lambda t, sh: t if sh is None or not isinstance(t, DTensor)
                else t.redistribute(*sh), out, cell.out_shardings)
        with torch.no_grad():
            outs = [_local(t) for t in _leaves(out)]
    out_b = sum(_nbytes(t) for t in outs)
    donated = Counter()
    for i in cell.donate_argnums:
        for t in _leaves(args[i]):
            t = _local(t)
            donated[(tuple(t.shape), t.dtype)] += _nbytes(t)
    produced = Counter()
    for t in outs:
        produced[(tuple(t.shape), t.dtype)] += _nbytes(t)
    alias = sum(min(v, produced[k]) for k, v in donated.items())
    used = {i for i, t in enumerate(_leaves(args))
            if _local(t).untyped_storage()._cdata in trace.read}
    return {
        "used": used,
        "records": trace.records,
        "output": out_b,
        "temp": max(trace.peak_bytes - out_b, 0),
        "held": trace.held_peak() - out_b,
        "peak_live": trace.live_at_peak(),
        "alias": alias,
        "fallbacks": op_fallbacks,
        "ctx_fallbacks": list(cell.ctx.fallbacks),
    }


def lower_cell(cell: Cell) -> CellTrace:
    """Runs the cell (at each of its loops' points) on rank 0 of its mesh
    and returns the ``CellTrace``; the process group must be initialised
    (a "fake" one for the dry run: ``launch.dryrun.init_fake_world``)."""
    if cell.loops is None or cell.loops.full in cell.loops.points:
        runs, weights, loops = [_run(cell)], [Fraction(1)], []
        temp = runs[0]["temp"]
    else:
        weights = cell.loops.weights()
        runs = [{**_run(cell.loops.build(p)), "point": p}
                for p in cell.loops.points]
        loops = [{"body": k, "trip": v}
                 for k, v in cell.loops.full.items()]
        temp = cell.loops.peak(runs)

    def comb(key):
        return int(round(sum(w * r[key] for w, r in zip(weights, runs))))

    memory = MemoryAnalysis(
        argument_size_in_bytes=argument_bytes(cell, runs[0]["used"]),
        output_size_in_bytes=comb("output"),
        temp_size_in_bytes=temp,
        alias_size_in_bytes=comb("alias"),
    )
    fallbacks = list(runs[0]["ctx_fallbacks"])
    for r in runs:
        fallbacks += [f for f in r["fallbacks"] if f not in fallbacks]
    traced = CellTrace(
        runs=[r["records"] for r in runs],
        weights=[float(w) for w in weights],
        memory=memory,
        fallbacks=fallbacks,
        while_loops=loops,
        peaks=[{k: r.get(k) for k in ("point", "temp", "held", "output",
                                      "peak_live")} for r in runs],
    )
    if len(runs) > 1:  # an extrapolation that leaves the affine regime
        bad = [k for k, v in traced.cost_analysis().items()
               if isinstance(v, float) and v < 0]
        if bad or memory.output_size_in_bytes < 0:
            raise ValueError(
                f"{cell.name}: extrapolating {cell.loops.points} to "
                f"{cell.loops.full} gives negative {bad or ['output']}: a "
                "count is not affine in the loops at these points")
    return traced
