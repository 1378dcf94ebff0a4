"""Mesh factories on ``torch.distributed`` (counterpart of
``repro.launch.mesh``).

Functions, not module-level constants, so importing touches no process
group.  Single pod: (16, 16) = ("data", "model"), 256 ranks.  Multi-pod:
(2, 16, 16) = ("pod", "data", "model"), 512 ranks; the "pod" axis carries
only data parallelism, the in-pod axes FSDP and tensor parallelism.

A mesh is a ``DeviceMesh`` over the ranks of the process group the caller
initialised (``torch.distributed.init_process_group``); each rank of it is
one device.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_host_mesh(shape, axes, device=device)


def make_host_mesh(shape: Sequence[int] = (2, 2),
                   axes: Sequence[str] = ("data", "model"), *,
                   device: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` over the first prod(shape) ranks of the
    initialised process group (tests, examples)."""
    n = 1
    for s in shape:
        n *= s
    avail = dist.get_world_size() if dist.is_initialized() else 0
    if avail < n:
        raise RuntimeError(
            f"need {n} ranks, have {avail}; start that many processes and "
            "call torch.distributed.init_process_group in each first"
        )
    if avail == n:
        return init_device_mesh(device, tuple(shape),
                                mesh_dim_names=tuple(axes))
    return DeviceMesh(device, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))
