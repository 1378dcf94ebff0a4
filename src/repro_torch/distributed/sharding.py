"""Logical-axis sharding rules (MaxText-style) with divisibility fallback,
on ``torch.distributed``'s ``DeviceMesh`` and DTensor placements
(counterpart of ``repro.distributed.sharding``).

Params and activations are annotated with *logical* axis names; a profile
maps each logical name to mesh axes.  ``resolve_axes`` drops mesh axes the
current mesh does not have (so the same rules serve the (data, model)
single-pod mesh and the (pod, data, model) multi-pod mesh), and falls back
to replication when the dimension is not divisible by the mapped axes'
size, as ``repro`` must for GSPMD.  Every fallback is recorded, in
``repro``'s words.

A spec is a ``PartitionSpec``: one entry per tensor dimension, ``None``, a
mesh axis name or a tuple of them.  ``named_sharding`` turns it into the
mesh and one DTensor placement per mesh dimension.  The port's models
compute on whole local tensors, so ``ShardingCtx.constrain`` changes no
value: it checks and records the spec, and redistributes a DTensor.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

AxisRule = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """Per-dimension mesh axes: ``PartitionSpec("data", None, ("pod",
    "model"))``.  A tuple, so two specs compare as ``repro``'s do."""

    def __new__(cls, *parts: AxisRule):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


# ---------------------------------------------------------------------------
# Profiles
# ---------------------------------------------------------------------------

# the mesh axes an activation's rows (batch) are sharded over
ROW_RULE = ("pod", "data")


def _base_rules() -> Dict[str, AxisRule]:
    return {
        # -- parameter logical axes ------------------------------------------
        "layers": None,
        "stack": None,          # enc/dec stacks, fused qkv, etc.
        "embed": None,          # d_model dim of weights (FSDP target)
        "heads": "model",       # query heads (tensor parallel)
        "kv_heads": None,       # usually <= mesh model size; replicated
        "head_dim": None,
        "ff": "model",          # MLP hidden (tensor parallel)
        "vocab": "model",
        "experts": None,        # MoE expert dim (EP optional)
        "state": None,          # SSM state dims
        "conv": None,
        "norm": None,
        "patch": None,
        # -- activation logical axes -----------------------------------------
        "act_batch": ROW_RULE,
        "act_seq": None,
        "act_embed": None,
        "act_heads": "model",
        "act_ff": "model",
        "act_vocab": "model",
        "cache_batch": ("pod", "data"),
        "cache_seq": None,
        "cache_heads": None,
    }


@dataclass
class ShardingProfile:
    name: str
    rules: Dict[str, AxisRule] = field(default_factory=_base_rules)
    notes: List[str] = field(default_factory=list)

    def override(self, **kw: AxisRule) -> "ShardingProfile":
        r = dict(self.rules)
        r.update(kw)
        return ShardingProfile(self.name, r, list(self.notes))


def make_profile(kind: str, *, fsdp: bool = True) -> ShardingProfile:
    """Profiles per shape kind.

    train:   FSDP: params and optimizer sharded over data x model; batch
             over (pod, data); microbatched grad accumulation upstream.
    prefill: weights 2-D sharded; batch over data; seq replicated.
    decode:  weights 2-D sharded; batch over data; KV-cache *sequence*
             sharded over model (flash-decoding split).
    decode_serve: as decode, but weights sharded over the model axis only
             (FSDP weights would be all-gathered every token).
    long:    batch 1: cache sequence over data AND heads over model.
    """
    p = ShardingProfile(kind)
    if kind == "train":
        p = p.override(embed="data" if fsdp else None)
    elif kind == "prefill":
        p = p.override(embed="data")
    elif kind == "decode":
        p = p.override(embed="data", cache_seq="model", act_heads=None)
    elif kind == "decode_serve":
        p = p.override(embed=None, cache_seq="model", act_heads=None)
    elif kind == "long":
        p = p.override(
            embed="data",
            cache_seq="data",
            cache_batch=None,
            cache_heads="model",
            act_batch=None,
            act_heads=None,
        )
    else:
        raise ValueError(f"unknown profile kind {kind!r}")
    return p


# ---------------------------------------------------------------------------
# Resolution
# ---------------------------------------------------------------------------

def mesh_shape(mesh: DeviceMesh) -> Dict[str, int]:
    """The mesh's axis sizes by name (``jax.sharding.Mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def resolve_axes(
    mesh: DeviceMesh,
    logical_axes: Sequence[Optional[str]],
    shape: Sequence[int],
    profile: ShardingProfile,
    fallbacks: Optional[List[str]] = None,
    context: str = "",
) -> PartitionSpec:
    """Map logical axis names to a PartitionSpec, respecting divisibility."""
    sizes = mesh_shape(mesh)
    spec: List[AxisRule] = []
    used: set = set()
    for dim, name in enumerate(logical_axes):
        rule = profile.rules.get(name) if name is not None else None
        if rule is None:
            spec.append(None)
            continue
        axes = (rule,) if isinstance(rule, str) else tuple(rule)
        axes = tuple(a for a in axes if a in sizes and a not in used)
        if not axes:
            spec.append(None)
            continue
        size = 1
        for a in axes:
            size *= sizes[a]
        if shape[dim] % size != 0:
            # try progressively smaller prefixes of the axis tuple
            while axes and shape[dim] % size != 0:
                size //= sizes[axes[-1]]
                axes = axes[:-1]
            if not axes:
                if fallbacks is not None:
                    fallbacks.append(
                        f"{context}[{name}] dim={shape[dim]} not divisible by "
                        f"rule {rule!r}; replicated"
                    )
                spec.append(None)
                continue
        used.update(axes)
        spec.append(axes[0] if len(axes) == 1 else tuple(axes))
    return PartitionSpec(*spec)


def placements(mesh: DeviceMesh, spec: PartitionSpec) -> Tuple[Placement, ...]:
    """One DTensor placement per mesh dimension: ``Shard(dim)`` on each mesh
    axis that a tensor dimension maps to, ``Replicate()`` elsewhere.  A
    tuple entry shards its dimension over several mesh axes, which DTensor
    can express only in the mesh's own order."""
    names = list(mesh.mesh_dim_names)
    out: List[Placement] = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        where = [names.index(a) for a in axes]
        if where != sorted(where):
            raise ValueError(
                f"dimension {dim} is sharded over {axes}, out of the mesh's "
                f"order {tuple(names)}; DTensor placements cannot express it"
            )
        for m in where:
            out[m] = Shard(dim)
    return tuple(out)


def named_sharding(
    mesh: DeviceMesh,
    logical_axes: Sequence[Optional[str]],
    shape: Sequence[int],
    profile: ShardingProfile,
    fallbacks: Optional[List[str]] = None,
    context: str = "",
) -> Tuple[DeviceMesh, Tuple[Placement, ...]]:
    """``(mesh, placements)``: what ``distribute_tensor`` and a checkpoint's
    target-shardings tree take."""
    spec = resolve_axes(mesh, logical_axes, shape, profile, fallbacks, context)
    return mesh, placements(mesh, spec)


# ---------------------------------------------------------------------------
# Activation-constraint context (threaded through model code)
# ---------------------------------------------------------------------------

class ShardingCtx:
    """Checks activations against their logical axes; off a mesh it does
    nothing."""

    def __init__(self, mesh: Optional[DeviceMesh] = None,
                 profile: Optional[ShardingProfile] = None):
        self.mesh = mesh
        self.profile = profile
        self.fallbacks: List[str] = []
        # mesh dimensions a loss path's sequence is folded into rows over
        # (``sequence_fold``)
        self.seq_fold: Tuple[int, ...] = ()

    def constrain(self, x, logical_axes: Sequence[Optional[str]],
                  keep: Sequence[int] = ()):
        """``x`` itself off a mesh.  On one: the rank checked and the spec
        resolved (fallbacks recorded); a DTensor is redistributed to the
        spec's placements, but for the mesh dimensions ``keep``, where its
        own stay (work split by hand over them), a plain tensor returned
        as it is.  The value never changes."""
        if self.mesh is None or self.profile is None:
            return x
        if len(logical_axes) != x.ndim:
            raise ValueError(
                f"logical axes {logical_axes} rank != array rank {x.shape}"
            )
        spec = resolve_axes(
            self.mesh, logical_axes, x.shape, self.profile, self.fallbacks,
            context="act",
        )
        if isinstance(x, DTensor):
            pl = self._keep_split(x, logical_axes, spec)
            return x.redistribute(self.mesh, [
                x.placements[i] if i in keep else p
                for i, p in enumerate(pl)])
        return x

    # activation axes whose fallback the models split by hand (uneven
    # heads and vocabularies, ``models.common.own_part``)
    SPLIT_AXES = ("act_heads", "act_vocab")

    def _keep_split(self, x, logical_axes, spec) -> Tuple[Placement, ...]:
        """``spec``'s placements, but where a dimension of ``SPLIT_AXES``
        fell back to replicated and ``x`` is already sharded on it over
        mesh axes of its rule: those shards stay (work split on purpose, as
        GSPMD splits a replicated operand, is not gathered back)."""
        out = list(placements(self.mesh, spec))
        for i, (name, p) in enumerate(zip(self.mesh.mesh_dim_names,
                                          x.placements)):
            if not (type(p) is Shard and out[i].is_replicate()
                    and spec[p.dim] is None
                    and logical_axes[p.dim] in self.SPLIT_AXES):
                continue
            rule = self.profile.rules.get(logical_axes[p.dim])
            axes = (rule,) if isinstance(rule, str) else tuple(rule or ())
            if name in axes:
                out[i] = p
        return tuple(out)

    def sequence_fold(self, x) -> "ShardingCtx":
        """The context a loss path runs under when the rows of the (B, S,
        …) DTensor ``x`` fall back to replicated over mesh axes of
        ``ROW_RULE`` whose rank count ``k`` divides S: the same rules, with
        ``seq_fold`` naming those mesh dimensions.  The caller then folds
        each row's sequence into ``k`` rows (``models.common.fold_rows``),
        which the axes divide: every token-wise product, norm and residual
        runs on each rank's own ``S / k`` positions (the work GSPMD splits
        across a replicated operand) instead of the whole rows on every
        rank, and attention gathers the keys back.  ``self`` for anything
        else."""
        if self.mesh is None or self.profile is None or self.seq_fold or \
                not isinstance(x, DTensor) or x.ndim < 2:
            return self
        names = self.mesh.mesh_dim_names
        rule = self.profile.rules.get("act_batch")
        axes = (rule,) if isinstance(rule, str) else tuple(rule or ())
        dims = tuple(i for i, n in enumerate(names) if n in axes
                     and n in ROW_RULE and x.placements[i].is_replicate())
        rows = resolve_axes(self.mesh, ("act_batch",), x.shape[:1],
                            self.profile)[0]
        used = () if rows is None else (rows,) if isinstance(rows, str) \
            else tuple(rows)
        dims = tuple(i for i in dims if names[i] not in used)
        k = 1
        for i in dims:
            k *= self.mesh.size(i)
        if not dims or x.shape[1] % k:
            return self
        ctx = ShardingCtx(self.mesh, self.profile)
        ctx.fallbacks, ctx.seq_fold = self.fallbacks, dims
        return ctx

    def gather_fsdp(self, params, dtype=None, keep: Sequence[str] = (),
                    tp_only: bool = False):
        """A weight, or a dict of a layer's weights, for the loss path:
        each DTensor's shards on the mesh axes of the profile's ``embed``
        rule (FSDP's: "data" under the train profile) gathered, its
        tensor-parallel shards kept: the all-gather at use that GSPMD
        places in ``repro``'s train step.  With both operands of a product
        laid out so, DTensor keeps the activations on their batch shards
        and the weights' gradients on their own shards (reduce-scattered
        back).  A gathered weight is cast to ``dtype`` first (the compute
        dtype its every use reads it in: half float32's bytes move), but
        for the names in ``keep``.  Off a mesh, with no FSDP axis, and for
        a plain tensor, the weights as they are; the values never
        change.  With ``tp_only`` (a decode step's) only the weights that
        also have tensor-parallel shards, whose gathered blocks are small
        beside the token's rows; the others stay whole over "model" and
        sharded, for DTensor to bring the few rows to them."""
        if isinstance(params, dict):
            return {k: self.gather_fsdp(w, None if k in keep else dtype,
                                        tp_only=tp_only)
                    for k, w in params.items()}
        if self.mesh is None or self.profile is None or \
                not isinstance(params, DTensor):
            return params
        rule = self.profile.rules.get("embed")
        axes = () if rule is None else (rule,) if isinstance(rule, str) \
            else tuple(rule)
        dims = [i for i, n in enumerate(self.mesh.mesh_dim_names)
                if n in axes]
        if not any(params.placements[i].is_shard() for i in dims) or (
                tp_only and not any(p.is_shard() for i, p in
                                    enumerate(params.placements)
                                    if i not in dims)):
            return params
        if dtype is not None:
            params = params.to(dtype)
        return params.redistribute(self.mesh, [
            Replicate() if i in dims else p
            for i, p in enumerate(params.placements)])


NULL_CTX = ShardingCtx()
