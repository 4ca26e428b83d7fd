"""Carry gms_tpu's prepared state across as port tensors.

The caller hands over numpy arrays taken from gms_tpu objects (this module
imports nothing of gms_tpu). uint32 bit words are viewed as int32, the
port's carrier for the same bits.

* `tensor_from_numpy`: one array (bit words, a k-clique root chunk, ...).
* `padded_from_numpy`: a PaddedGraph's `nbr` (any lane, e.g. the lane-32
  layout of k-clique counting) as a port PaddedGraph.
* `plan_from_numpy`: a triangle-count plan.
* `bitmap_from_numpy`: a BitmapGraph's uint32 words as a port BitmapGraph.
* `train_tables_from_numpy`: link prediction's train tables (`_train_tables`
  of gms_tpu's algorithms/link_prediction.py) as the port's.
* `tiers_from_numpy`: coloring's degree tiers (`_TierGraph.tiers` of gms_tpu's
  algorithms/coloring.py, (ids_pad, nbrt) pairs) as port tensors.
* `kbit_from_numpy`: a k-bit packed graph (gms_tpu's graphs/compressed.py
  KbitGraph: packed words, degrees, k, d_pad) as a port KbitGraph.

The adjacency `nbr` must be gms_tpu's padded layout (rows sorted, SENTINEL
tail, guard row): the port's merge and search kernels rely on it, and
GMS_TPU_PARANOID=1 checks it here.

plan_from_numpy state keys:
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
from gms_tpu_torch.graphs.bitmap import BitmapGraph
from gms_tpu_torch.graphs.tiles import SENTINEL, PaddedGraph
from gms_tpu_torch.harness import checks


def tensor_from_numpy(a, *, device="cuda") -> torch.Tensor:
    """An owned tensor of `a` on `device`; uint32 words become int32 words
    with the same bits."""
    a = np.array(a)  # an owned, writable copy
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(resolve(device))


def padded_from_numpy(nbr, *, device="cuda", num_nodes: int | None = None
                      ) -> PaddedGraph:
    """A port PaddedGraph from gms_tpu's padded adjacency `nbr`; `num_nodes`
    defaults to V_pad - 1."""
    nbr = np.asarray(nbr, dtype=np.int32)
    deg = (nbr != SENTINEL).sum(axis=1).astype(np.int32)
    if num_nodes is None:
        num_nodes = nbr.shape[0] - 1
    if checks.paranoid():
        checks.validate_padded(nbr, deg, num_nodes, name="padded_from_numpy")
    return PaddedGraph(tensor_from_numpy(nbr, device=device),
                       tensor_from_numpy(deg, device=device), num_nodes,
                       int(deg.sum()))


def bitmap_from_numpy(words, *, device="cuda", num_nodes: int | None = None,
                      num_edges: int | None = None) -> BitmapGraph:
    """A port BitmapGraph from gms_tpu's BitmapGraph words (uint32[V_pad,
    W_pad]); `num_nodes` defaults to V_pad, `num_edges` to the set bits."""
    words = np.asarray(words, dtype=np.uint32)
    if num_nodes is None:
        num_nodes = words.shape[0]
    if num_edges is None:
        num_edges = int(np.unpackbits(words.view(np.uint8)).sum())
    return BitmapGraph(tensor_from_numpy(words, device=device), num_nodes,
                       num_edges)


def train_tables_from_numpy(nbr, deg, bm_words, hub_idx, vw, hub_t, *,
                            device="cuda"):
    """The port's train tables (algorithms/link_prediction._Tables) from
    gms_tpu's `_train_tables` arrays: nbr int32[V_pad, D_pad] and deg
    int32[V_pad] (its PaddedGraph), bm_words uint32[H * vw] hub bitmaps,
    hub_idx int32[V_pad + 1], and the ints vw and hub_t. hub_t must be the
    port's HUB_THRESHOLD, where its pair scorer splits the pairs."""
    from gms_tpu_torch.algorithms import link_prediction as lp
    from gms_tpu_torch.algorithms.similarity import _deg_lookup

    if int(hub_t) != lp.HUB_THRESHOLD:
        raise ValueError(f"train_tables_from_numpy: hub_t {hub_t} != "
                         f"{lp.HUB_THRESHOLD}")
    dev = resolve(device)
    nbr = np.asarray(nbr, dtype=np.int32)
    deg = np.asarray(deg, dtype=np.int32)
    if checks.paranoid():
        checks.validate_padded(nbr, deg, nbr.shape[0] - 1,
                               name="train_tables_from_numpy")
    pg = PaddedGraph(tensor_from_numpy(nbr, device=dev),
                     tensor_from_numpy(deg, device=dev), nbr.shape[0] - 1,
                     int(deg.sum()))
    return lp._Tables(
        pg, _deg_lookup(pg),
        tensor_from_numpy(np.asarray(bm_words, np.uint32).reshape(-1),
                          device=dev),
        tensor_from_numpy(np.asarray(hub_idx, np.int32), device=dev),
        int(vw))


def tiers_from_numpy(tiers, *, device="cuda") -> list:
    """[(ids int32[Vt], nbrt int32[Vt, Dt])] tensors from gms_tpu's
    `_TierGraph.tiers`, the rows the coloring rounds of both packages take
    (each row sorted with a SENTINEL tail, checked under
    GMS_TPU_PARANOID=1)."""
    dev = resolve(device)
    out = []
    for ids, nbrt in tiers:
        nbrt = np.asarray(nbrt, dtype=np.int32)
        if checks.paranoid():
            checks.validate_sorted_rows(nbrt, name="tiers_from_numpy")
        out.append((tensor_from_numpy(np.asarray(ids, dtype=np.int32),
                                      device=dev),
                    tensor_from_numpy(nbrt, device=dev)))
    return out


def kbit_from_numpy(packed, deg, k: int, d_pad: int, num_nodes: int,
                    num_edges: int, *, device="cuda"):
    """A port KbitGraph from gms_tpu's KbitGraph arrays: packed
    uint32[V_pad, W] (k bits a lane), deg int32[V_pad], and its k, d_pad,
    num_nodes and num_edges."""
    from gms_tpu_torch.graphs.compressed import KbitGraph

    dev = resolve(device)
    packed = np.asarray(packed, dtype=np.uint32)
    deg = np.asarray(deg, dtype=np.int32)
    if packed.ndim != 2 or deg.shape != (packed.shape[0],):
        raise ValueError(f"kbit_from_numpy: packed {packed.shape} and deg "
                         f"{deg.shape} do not match")
    if not 1 <= int(k) <= 32 or int(d_pad) * int(k) > 32 * packed.shape[1]:
        raise ValueError(f"kbit_from_numpy: {d_pad} lanes of {k} bits do not "
                         f"fit {packed.shape[1]} words")
    return KbitGraph(tensor_from_numpy(packed, device=dev),
                     tensor_from_numpy(deg, device=dev), int(k), int(d_pad),
                     int(num_nodes), int(num_edges))


def plan_from_numpy(state: dict, *, device="cuda") -> TrianglePlan:
    dev = resolve(device)

    def t(a):
        return tensor_from_numpy(a, device=dev)

    def listed(key, convert):
        items = state.get(key)
        return None if items is None else [convert(it) for it in items]

    nbr = np.asarray(state["nbr"], dtype=np.int32)
    plan = TrianglePlan.__new__(TrianglePlan)
    plan.device = dev
    plan.dag = None
    plan.padded = padded_from_numpy(
        nbr, device=dev, num_nodes=state.get("num_nodes", nbr.shape[0] - 1))
    plan.num_edges_undirected = state.get("num_edges_undirected",
                                          plan.padded.num_edges)
    plan.method = state.get("method", "compare")
    plan.tiers = listed("tiers", lambda x: (*map(int, x[:3]), t(x[3]), t(x[4])))
    plan.hub = listed("hub", lambda x: (*map(int, x[:3]), t(x[3]), t(x[4])))
    rows = state.get("hub_rows")
    plan.hub_rows = None if rows is None else t(rows)
    plan.tiers_mat = listed("tiers_mat", lambda x: (int(x[0]), t(x[1]), t(x[2])))
    # no live counts: K2 reads every slot of gms_tpu's streams
    plan.hub_mat = listed("hub_mat",
                          lambda x: (int(x[0]), t(x[1]), t(x[2]), None))
    if plan.tiers_mat is not None and plan.hub_mat is None:
        plan.hub_mat = []
    return plan
