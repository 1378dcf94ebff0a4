"""``SearchParams`` — the single search-knob object.

The same fields, defaults and validation as ``repro.graphs.params``, so a
config carries across.  In the port ``kernel="xla"`` is the plain
gather-and-score path, ``"fused"`` the hand-written gather kernel and
``"fused_q8"`` the int8-codebook kernel followed by an exact fp32 rerank.
``kernel_interpret=True`` runs each kernel's plain PyTorch version even on
CUDA tensors (the comparison arm).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

_METRICS = ("l2", "cosine")
_KERNELS = ("xla", "fused", "fused_q8")


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
