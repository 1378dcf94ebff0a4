"""``SearchParams`` — the single search-knob object.

The same fields, defaults and validation as ``repro.graphs.params``, so a
config carries across.  In the port ``kernel="xla"`` is the plain
gather-and-score path, ``"fused"`` the hand-written gather kernel and
``"fused_q8"`` the int8-codebook kernel followed by an exact fp32 rerank.
``kernel_interpret=True`` runs each kernel's plain PyTorch version even on
CUDA tensors (the comparison arm).

Old per-knob keyword arguments keep working through
:func:`resolve_search_params`: each one warns once per (call site, keyword)
with a ``DeprecationWarning`` attributed to the caller and increments the
``api.deprecated_kwargs`` counter.
"""
from __future__ import annotations

import dataclasses
import sys
import warnings
from dataclasses import dataclass
from typing import Dict, Optional, Set, Tuple

_METRICS = ("l2", "cosine")
_KERNELS = ("xla", "fused", "fused_q8")

# legacy keyword names resolve_search_params understands, in field order
LEGACY_SEARCH_KWARGS: Tuple[str, ...] = (
    "k", "beam_width", "max_hops", "visited_ring", "metric", "instrument",
    "conv_k",
)

_warned_once: Set[Tuple[str, str]] = set()


@dataclass(frozen=True)
class SearchParams:
    """Frozen bundle of every Algorithm-1 search knob."""

    k: int = 10                 # results returned per query
    beam_width: int = 64        # Algorithm-1 beam slots L
    max_hops: int = 256         # expansion budget
    visited_ring: int = 512     # dedup ring capacity
    metric: str = "l2"          # "l2" (squared) or "cosine" (1 - cos)
    instrument: bool = False    # SearchTelemetry on/off
    conv_k: int = 10            # top-k prefix watched for convergence
    kernel: str = "xla"         # distance kernel: "xla" | "fused" | "fused_q8"
    rerank_mult: int = 4        # q8 exact-rerank width α: top k·α beam slots
    kernel_interpret: bool = False  # run the kernels' plain versions

    def __post_init__(self):
        if self.metric not in _METRICS:
            raise ValueError(
                f"metric must be one of {_METRICS}, got {self.metric!r}"
            )
        if self.kernel not in _KERNELS:
            raise ValueError(
                f"kernel must be one of {_KERNELS}, got {self.kernel!r}"
            )
        for name in ("k", "beam_width", "max_hops", "visited_ring", "conv_k",
                     "rerank_mult"):
            v = getattr(self, name)
            if not isinstance(v, (int,)) or isinstance(v, bool) or v < 1:
                raise ValueError(f"{name} must be a positive int, got {v!r}")

    def replace(self, **changes) -> "SearchParams":
        """Functional update (``dataclasses.replace`` shorthand)."""
        return dataclasses.replace(self, **changes)


def reset_deprecation_state() -> None:
    """Forget which (call site, kwarg) pairs already warned (a test hook)."""
    _warned_once.clear()


def warn_deprecated_kwarg(
    where: str, kwarg: str, instead: str, *, stacklevel: int = 3
) -> None:
    """Warn once per (where, kwarg); always bump ``api.deprecated_kwargs``.

    ``stacklevel=3`` attributes the warning to the caller of the shimmed
    API (this helper → the shimmed API → its caller); the message names
    that caller's ``file:line``.
    """
    # imported here: this module sits below repro_torch.obs in the imports
    from repro_torch.obs.registry import get_registry

    get_registry().counter(
        "api.deprecated_kwargs",
        "calls that used pre-SearchParams keyword arguments",
    ).inc()
    key = (where, kwarg)
    if key in _warned_once:
        return
    _warned_once.add(key)
    caller = ""
    try:
        frame = sys._getframe(max(stacklevel - 1, 1))
        caller = f" (called from {frame.f_code.co_filename}:{frame.f_lineno})"
    except ValueError:
        pass  # fewer frames than stacklevel
    warnings.warn(
        f"{where}({kwarg}=...) is deprecated; pass {instead} instead{caller}",
        DeprecationWarning,
        stacklevel=stacklevel,
    )


def resolve_search_params(
    where: str,
    params: Optional[SearchParams],
    legacy: Dict,
    *,
    k: Optional[int] = None,
    default: Optional[SearchParams] = None,
) -> SearchParams:
    """Merge ``params`` + deprecated per-knob ``legacy`` kwargs + ``k``.

    Precedence (last wins): ``default`` → ``params`` → legacy kwargs → the
    ``k=`` shortcut.  Unknown legacy keys raise ``TypeError`` as a bad
    keyword would.
    """
    unknown = set(legacy) - set(LEGACY_SEARCH_KWARGS)
    if unknown:
        raise TypeError(
            f"{where}() got unexpected keyword argument(s) "
            f"{sorted(unknown)}; valid search knobs live on SearchParams"
        )
    out = params if params is not None else (
        default if default is not None else SearchParams()
    )
    if legacy:
        for key in legacy:
            warn_deprecated_kwarg(
                where, key, f"params=SearchParams({key}=...)", stacklevel=4
            )
        out = out.replace(**legacy)
    if k is not None:
        out = out.replace(k=k)
    return out
