"""Carry ``repro`` state across: ``index_from_numpy``,
``lm_params_from_numpy``, ``train_state_from_numpy``.

``repro``'s ``GateIndex.save`` pickles one dictionary; ``index_from_numpy``
takes exactly that dictionary, with its dataclasses (``tower_cfg``,
``gcfg``) given as plain dicts and every array as a numpy array, and
returns a port ``GateIndex`` whose ``search`` computes what ``repro``'s
does.  ``lm_params_from_numpy`` does the same for a language model's
parameter dict, and ``train_state_from_numpy`` for a whole train state
(a restored ``repro`` checkpoint, say).  This module imports nothing of
``repro``: the caller reads the pickle (or the live objects).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.gate_index import GateConfig, GateIndex
from repro_torch.core.hubs import HubSet
from repro_torch.core.navgraph import NavGraph
from repro_torch.core.twotower import TwoTowerConfig, init_params
from repro_torch.models.common import torch_dtype
from repro_torch.models.model import build_model
from repro_torch.quant import QuantizedDb


def index_from_numpy(state: Mapping, device="cuda") -> GateIndex:
    """Build a port ``GateIndex`` on ``device`` from ``repro``'s saved state.

    ``state`` keys: db, neighbors, enter_id, hubs (ids, assign, centroids),
    tower_params (``repro`` names and layouts), tower_cfg, gcfg, nav
    (neighbors, reps, start), build_report, quant (codes, scale, zero,
    inv_norms) or None.
    """
    tcfg = TwoTowerConfig(**dict(state["tower_cfg"]))
    nav_nbrs, nav_reps, nav_start = state["nav"]
    q = state.get("quant")
    idx = GateIndex(
        db=np.asarray(state["db"], np.float32),
        neighbors=np.asarray(state["neighbors"], np.int32),
        enter_id=int(state["enter_id"]),
        hubs=HubSet(*(np.asarray(a) for a in state["hubs"])),
        tower_params=init_params(tcfg, params=state["tower_params"],
                                 device=device),
        tower_cfg=tcfg,
        nav=NavGraph(neighbors=np.asarray(nav_nbrs, np.int32),
                     reps=np.asarray(nav_reps, np.float32),
                     start=int(nav_start)),
        gcfg=GateConfig(**dict(state["gcfg"])),
        build_report=dict(state.get("build_report") or {}),
        quant=QuantizedDb(*(np.asarray(a) for a in q)) if q is not None else None,
    )
    idx._device(device)
    return idx


def lm_params_from_numpy(cfg: ModelConfig, params: Mapping,
                         device="cuda") -> dict:
    """``repro``'s LM parameters (name -> array, ``repro``'s names and
    layouts) as the port's parameter dict on ``device``, in the config's
    ``param_dtype``.  Raises unless the names and shapes are exactly those
    of the port model's ``param_table``."""
    table = build_model(cfg).param_table()
    if set(params) != set(table):
        raise ValueError(
            f"lm_params_from_numpy: names differ from {cfg.name}'s table: "
            f"missing {sorted(set(table) - set(params))}, "
            f"extra {sorted(set(params) - set(table))}")
    out = {}
    for name, spec in table.items():
        a = np.array(params[name], np.float32)
        if a.shape != spec.shape:
            raise ValueError(f"lm_params_from_numpy: {name} has shape "
                             f"{a.shape}, the table {spec.shape}")
        out[name] = torch.as_tensor(a, device=device).to(
            torch_dtype(spec.dtype or cfg.param_dtype))
    return out


def train_state_from_numpy(cfg: ModelConfig, state: Mapping,
                           device="cuda") -> dict:
    """``repro``'s train state (``{"params", "opt": {"m", "v", "step"}}``,
    arrays; an ``sgd`` state has no ``v``) as the port's on ``device``:
    the parameters through ``lm_params_from_numpy``, ``m`` / ``v`` float32
    under the same names and shapes, ``step`` an int32 scalar."""
    params = lm_params_from_numpy(cfg, state["params"], device=device)
    opt = {}
    for key, val in state["opt"].items():
        if key == "step":
            opt[key] = torch.as_tensor(np.array(val, np.int32).reshape(()),
                                       device=device)
            continue
        if set(val) != set(params):
            raise ValueError(f"train_state_from_numpy: opt/{key} names "
                             "differ from the parameters'")
        opt[key] = {}
        for n, a in val.items():
            a = np.array(a, np.float32)
            if a.shape != tuple(params[n].shape):
                raise ValueError(f"train_state_from_numpy: opt/{key}/{n} has "
                                 f"shape {a.shape}, the parameter "
                                 f"{tuple(params[n].shape)}")
            opt[key][n] = torch.as_tensor(a, device=device)
    return {"params": params, "opt": opt}
