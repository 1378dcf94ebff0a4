"""Checkpoint and restore with an asynchronous save, in ``repro.ckpt``'s
on-disk layout, so a checkpoint written by either package restores in the
other.

Layout: one directory per step —
    <dir>/step_000000120/
        manifest.json     step, key shapes and dtypes, ``extra``, time
        arrays.npz        the flat state, one array per "/"-joined key path
    <dir>/LATEST          atomic pointer (written to .LATEST.tmp, renamed)

  * save snapshots the state to host numpy (tensors leave the device), then
    serializes on one background thread; ``wait()`` joins it and raises
    what it raised;
  * every step directory is written under a temporary name and renamed,
    and LATEST flips by ``os.replace``, so a crash mid-save leaves the last
    complete checkpoint as the restore point;
  * ``keep_last`` prunes old steps after the pointer lands;
  * restore returns numpy arrays, or places them by ``target_shardings``:
    a tree of the state's shape whose leaves are each a device or a
    ``(DeviceMesh, placements)`` pair (``distributed.sharding.
    named_sharding``'s result), or one device for every array;
  * a DTensor is saved as its ``full_tensor()``, and where
    ``torch.distributed`` is initialised only rank 0 writes (every rank
    takes part in gathering the full tensors).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor

SEP = "/"


def _flatten(tree, prefix=""):
    """Leaves by "/"-joined key path; a ``(DeviceMesh, placements)`` pair
    of a target-shardings tree is a leaf."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}{SEP}"))
    elif isinstance(tree, (list, tuple)) and not _is_sharding(tree):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}{SEP}"))
    else:
        out[prefix[: -len(SEP)]] = tree
    return out


def _unflatten(flat: Dict[str, Any], structure):
    """Rebuild ``structure``'s nesting (dicts, lists, tuples) from key
    paths."""
    def under(key):
        return {kk[len(key) + 1:]: v for kk, v in flat.items()
                if kk == key or kk.startswith(key + SEP)}

    if isinstance(structure, dict):
        return {k: _unflatten(under(k), structure[k]) for k in structure}
    if isinstance(structure, (list, tuple)):
        return type(structure)(_unflatten(under(str(i)), s)
                               for i, s in enumerate(structure))
    return flat[""] if "" in flat else next(iter(flat.values()))


def _nest_from_paths(flat: Dict[str, Any]):
    root: Dict[str, Any] = {}
    for k, v in flat.items():
        parts = k.split(SEP)
        cur = root
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return root


def _to_host(v) -> np.ndarray:
    if isinstance(v, DTensor):
        v = v.full_tensor()  # a collective: every rank of the mesh calls it
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _is_sharding(t) -> bool:
    """A ``(DeviceMesh, placements)`` leaf of a target-shardings tree."""
    return (isinstance(t, tuple) and len(t) == 2
            and isinstance(t[0], DeviceMesh))


def _place(v: np.ndarray, target):
    if target is None:
        return v
    if _is_sharding(target):
        mesh, placements = target
        return distribute_tensor(torch.as_tensor(v, device=mesh.device_type),
                                 mesh, list(placements))
    return torch.as_tensor(v, device=target)


def _writes() -> bool:
    """Only rank 0 writes where a process group is initialised."""
    return not (dist.is_available() and dist.is_initialized()) or (
        dist.get_rank() == 0)


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def save(
        self,
        step: int,
        state,
        extra: Optional[Dict[str, Any]] = None,
        *,
        blocking: bool = False,
    ):
        """Snapshot ``state`` (nested dicts / lists of arrays, tensors or
        DTensors) to host, then serialize it on a background thread."""
        self.wait()  # one save in flight at a time
        host = {k: _to_host(v) for k, v in _flatten(state).items()}
        if not _writes():
            return
        manifest = {
            "step": step,
            "keys": {
                k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                for k, v in host.items()
            },
            "extra": extra or {},
            "time": time.time(),
        }

        def work():
            try:
                self._write(step, host, manifest)
            except BaseException as e:  # noqa: BLE001 — surfaced via wait()
                self._error = e

        if blocking:
            work()
            self._raise_if_failed()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def _write(self, step: int, host, manifest):
        name = f"step_{step:09d}"
        final = os.path.join(self.dir, name)
        tmp = tempfile.mkdtemp(prefix=f".{name}.", dir=self.dir)
        try:
            np.savez(os.path.join(tmp, "arrays.npz"), **host)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        ptr_tmp = os.path.join(self.dir, ".LATEST.tmp")
        with open(ptr_tmp, "w") as f:
            f.write(name)
        os.replace(ptr_tmp, os.path.join(self.dir, "LATEST"))
        self._prune()

    def _prune(self):
        steps = sorted(d for d in os.listdir(self.dir) if d.startswith("step_"))
        for d in steps[: -self.keep_last]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from e

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        ptr = os.path.join(self.dir, "LATEST")
        if not os.path.exists(ptr):
            return None
        with open(ptr) as f:
            return int(f.read().strip().split("_")[1])

    def restore(
        self,
        step: Optional[int] = None,
        *,
        target_shardings=None,
        device=None,
        structure=None,
    ) -> Tuple[Any, Dict[str, Any]]:
        """Returns ``(state, extra)`` of ``step`` (default: LATEST).

        ``target_shardings`` is a tree of the state's shape whose leaves are
        each a device or a ``(DeviceMesh, placements)`` pair (the array
        comes back as ``distribute_tensor`` on that mesh, so every rank of
        it calls ``restore``), or one device for every array; ``device=``
        is that one device.  An array with no target stays numpy, as
        ``repro`` returns it without shardings.  ``structure`` (a tree of
        the state's shape) restores lists, tuples and "/"-named leaves;
        without it the state nests dicts by key path."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        targets = target_shardings if target_shardings is not None else device
        if isinstance(targets, (dict, list, tuple)) and not _is_sharding(
                targets):
            leaves = _flatten(targets)
            flat = {k: _place(v, leaves.get(k)) for k, v in flat.items()}
        else:
            flat = {k: _place(v, targets) for k, v in flat.items()}
        state = (_nest_from_paths(flat) if structure is None
                 else _unflatten(flat, structure))
        return state, manifest.get("extra", {})
