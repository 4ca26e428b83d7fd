"""Edge-list -> CSR graph construction ("Builder" layer).

Covers the behavior of GAPBS `BuilderBase` (reference
gms/third_party/gapbs/builder.h): MakeGraphFromEL (:279-298) = count degrees,
prefix sum, scatter; SquishGraph (:204-251) = per-row sort + dedup + self-loop
removal; symmetrization for undirected inputs; RelabelByDegree (:1697-1733).

All of this is bulk array work, so it is vectorized numpy (lexsort + unique
+ bincount) on the host — there is no per-vertex loop. A copy of
gms_tpu/io/builder.py: same inputs give the same arrays.
"""

from __future__ import annotations

import numpy as np

from gms_tpu_torch.graphs.csr import CSRGraph, _csr_from_sorted_pairs


def build_csr(
    edges: np.ndarray,
    num_nodes: int | None = None,
    *,
    symmetrize: bool = True,
    remove_self_loops: bool = True,
    dedup: bool = True,
) -> CSRGraph:
    """Build a CSR graph from an int edge array [E, 2].

    symmetrize=True mirrors GAPBS's undirected build (builder.h:264-276 inserts
    both directions when `!symmetrize_` is false); squish semantics
    (sort + unique + de-loop) follow builder.h:204-251.
    """
    edges = np.asarray(edges)
    if edges.size == 0:
        edges = edges.reshape(0, 2)
    edges = edges.astype(np.int64, copy=False)
    if num_nodes is None:
        num_nodes = int(edges.max(initial=-1)) + 1
    if remove_self_loops:
        edges = edges[edges[:, 0] != edges[:, 1]]
    if symmetrize:
        edges = np.concatenate([edges, edges[:, ::-1]], axis=0)
    # Sort by (src, dst) via a single int64 key — the vectorized equivalent of
    # GAPBS's scatter + per-row std::sort.
    key = edges[:, 0] * np.int64(num_nodes) + edges[:, 1]
    if dedup:
        key = np.unique(key)
    else:
        key = np.sort(key)
    pairs = np.stack([key // num_nodes, key % num_nodes], axis=1).astype(np.int32)
    return _csr_from_sorted_pairs(pairs, num_nodes, directed=not symmetrize)


def relabel_by_degree(g: CSRGraph, *, ascending: bool = False) -> CSRGraph:
    """Relabel vertices by degree (default: descending, GAPBS builder.h:1697-1733).

    Ties broken by original id (stable sort), matching the reference's
    stable std::sort on (degree, id) pairs.
    """
    deg = g.degrees
    keyed = np.lexsort((np.arange(g.num_nodes), -deg if not ascending else deg))
    # keyed[i] = old id of the vertex that gets new id i
    new_id = np.empty(g.num_nodes, dtype=np.int32)
    new_id[keyed] = np.arange(g.num_nodes, dtype=np.int32)
    return g.relabel(new_id)


def worth_relabelling(g: CSRGraph) -> bool:
    """Average-vs-median degree skew heuristic (gapbs/benchmark.h:158-176).

    The reference samples vertices; we compute exactly (cheap in numpy):
    relabel when average degree is much larger than the median (power-law).
    """
    deg = g.degrees
    if g.num_nodes == 0:
        return False
    return float(deg.mean()) > 4.0 * float(np.median(deg))


def build_csr_weighted(
    edges: np.ndarray,
    weights: np.ndarray,
    num_nodes: int | None = None,
    *,
    symmetrize: bool = True,
    remove_self_loops: bool = True,
) -> CSRGraph:
    """Weighted build (.wel / WGraph role): squish keeps the first weight of
    each duplicate edge (GAPBS keeps an arbitrary one of the duplicates)."""
    edges = np.asarray(edges).astype(np.int64, copy=False).reshape(-1, 2)
    weights = np.asarray(weights).astype(np.int64, copy=False)
    if num_nodes is None:
        num_nodes = int(edges.max(initial=-1)) + 1
    if remove_self_loops:
        keep = edges[:, 0] != edges[:, 1]
        edges, weights = edges[keep], weights[keep]
    if symmetrize:
        edges = np.concatenate([edges, edges[:, ::-1]], axis=0)
        weights = np.concatenate([weights, weights])
    key = edges[:, 0] * np.int64(num_nodes) + edges[:, 1]
    order = np.argsort(key, kind="stable")
    key, weights = key[order], weights[order]
    first = np.ones(len(key), dtype=bool)
    first[1:] = key[1:] != key[:-1]
    key, weights = key[first], weights[first]
    pairs = np.stack([key // num_nodes, key % num_nodes], axis=1).astype(np.int32)
    g = _csr_from_sorted_pairs(pairs, num_nodes, directed=not symmetrize)
    return CSRGraph(g.indptr, g.indices, directed=not symmetrize,
                    weights=weights.astype(np.int32))
