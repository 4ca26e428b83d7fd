"""Carry a prepared triangle-count plan across from gms_tpu.

`plan_from_numpy` rebuilds a port TrianglePlan from the arrays of a gms_tpu
TrianglePlan, handed over as numpy (the caller extracts them; this module
imports nothing of gms_tpu). uint32 bit words are viewed as int32, the port's
carrier for the same bits. The adjacency `nbr` must be gms_tpu's padded
layout (rows sorted, SENTINEL tail, guard row): the port's merge kernels
rely on it, and GMS_TPU_PARANOID=1 checks it here.

state keys:
    nbr        int32[V_pad, D_pad]              plan.padded.nbr
    tiers      [(wa, wb, c, edges[E,2], valid[E])]
    hub        [(w, k, gc, b_ids[G], nbrs[G,k])] or None
    hub_rows   uint32[Nw+1, HW] or None
    tiers_mat  [(cm, a_mat[wa,E], b_mat[wb,E])] or None
    hub_mat    [(gc, b_mat[G,W], a_mat[G,K,W])] or None
optional:
    method (default "compare"), num_nodes (default V_pad - 1),
    num_edges_undirected (default the DAG's edge count).
"""

from __future__ import annotations

import numpy as np
import torch

from gms_tpu_torch.algorithms.triangle_count import TrianglePlan
from gms_tpu_torch.device import resolve
from gms_tpu_torch.graphs.tiles import SENTINEL, PaddedGraph
from gms_tpu_torch.harness import checks


def plan_from_numpy(state: dict, *, device="cuda") -> TrianglePlan:
    dev = resolve(device)

    def t(a):
        a = np.array(a)  # an owned, writable copy
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a).to(dev)

    def listed(key, convert):
        items = state.get(key)
        return None if items is None else [convert(it) for it in items]

    nbr = np.asarray(state["nbr"], dtype=np.int32)
    deg = (nbr != SENTINEL).sum(axis=1).astype(np.int32)
    num_nodes = state.get("num_nodes", nbr.shape[0] - 1)
    if checks.paranoid():
        checks.validate_padded(nbr, deg, num_nodes, name="plan_from_numpy")
    plan = TrianglePlan.__new__(TrianglePlan)
    plan.device = dev
    plan.dag = None
    plan.padded = PaddedGraph(t(nbr), t(deg), num_nodes, int(deg.sum()))
    plan.num_edges_undirected = state.get("num_edges_undirected",
                                          int(deg.sum()))
    plan.method = state.get("method", "compare")
    plan.tiers = listed("tiers", lambda x: (*map(int, x[:3]), t(x[3]), t(x[4])))
    plan.hub = listed("hub", lambda x: (*map(int, x[:3]), t(x[3]), t(x[4])))
    rows = state.get("hub_rows")
    plan.hub_rows = None if rows is None else t(rows)
    plan.tiers_mat = listed("tiers_mat", lambda x: (int(x[0]), t(x[1]), t(x[2])))
    plan.hub_mat = listed("hub_mat", lambda x: (int(x[0]), t(x[1]), t(x[2])))
    if plan.tiers_mat is not None and plan.hub_mat is None:
        plan.hub_mat = []
    return plan
