"""Carry a ``repro`` index across: ``index_from_numpy``.

``repro``'s ``GateIndex.save`` pickles one dictionary; this module takes
exactly that dictionary, with its dataclasses (``tower_cfg``, ``gcfg``) given
as plain dicts and every array as a numpy array, and returns a port
``GateIndex`` whose ``search`` computes what ``repro``'s does.  It imports
nothing of ``repro``: the caller reads the pickle (or the live index).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np

from repro_torch.core.gate_index import GateConfig, GateIndex
from repro_torch.core.hubs import HubSet
from repro_torch.core.navgraph import NavGraph
from repro_torch.core.twotower import TwoTowerConfig, init_params
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
