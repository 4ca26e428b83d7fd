"""Vertex relabeling strategies for compression / locality — the port of
gms_tpu/graphs/permuters.py, host numpy copied as it is.

Role of gms/representations/graphs/permuters/ (permuters.h:25-44
PermuterVariant): degree-based orderings plus 12 CPLEX ILP/LP "optimal gap"
variants. The degree orderings are implemented exactly; the CPLEX family
(an optional dependency even in the reference — cmake/FindCPLEX.cmake) is
covered by three non-ILP gap minimizers over the same objective (mean
log2 neighbor-id gap, `average_gap_bits`): `gap_bfs` (BFS locality),
`rcm` (reverse Cuthill–McKee), and `gap_barycenter` (iterative barycenter
local search keeping the best measured sweep). Permutations compose with
the k-bit/varint coders in compressed.py, whose footprint the gap
structure determines.
"""

from __future__ import annotations

import numpy as np

from gms_tpu_torch.graphs.csr import CSRGraph

VARIANTS = (
    "identity", "random",
    "degree_asc", "degree_desc",
    "in_degree_asc", "in_degree_desc",
    "out_degree_asc", "out_degree_desc",
    "gap_bfs", "rcm", "gap_barycenter",
)


def permutation_map(g: CSRGraph, variant: str, *, seed: int = 0) -> np.ndarray:
    """new_id[v] for the given variant (Permuter::permutation_map role)."""
    n = g.num_nodes
    deg = g.degrees
    if variant == "identity":
        return np.arange(n, dtype=np.int32)
    if variant == "random":
        return np.random.default_rng(seed).permutation(n).astype(np.int32)
    if variant in ("degree_asc", "in_degree_asc", "out_degree_asc"):
        order = np.lexsort((np.arange(n), deg))
    elif variant in ("degree_desc", "in_degree_desc", "out_degree_desc"):
        order = np.lexsort((np.arange(n), -deg))
    elif variant == "gap_bfs":
        order = _bfs_order(g)
    elif variant == "rcm":
        order = _rcm_order(g)
    elif variant == "gap_barycenter":
        order = _barycenter_order(g)
    else:
        raise ValueError(f"unknown permuter variant {variant!r}")
    new_id = np.empty(n, dtype=np.int32)
    new_id[order] = np.arange(n, dtype=np.int32)
    return new_id


def apply_permutation(g: CSRGraph, variant: str, *, seed: int = 0) -> CSRGraph:
    return g.relabel(permutation_map(g, variant, seed=seed))


def _frontier_targets(g: CSRGraph, frontier: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Concatenated neighbor lists of `frontier` in frontier order:
    (targets, parent_slot) — one repeat + fancy gather, no Python loop."""
    deg = g.degrees.astype(np.int64)[frontier]
    total = int(deg.sum())
    out_ptr = np.zeros(len(frontier) + 1, dtype=np.int64)
    np.cumsum(deg, out=out_ptr[1:])
    src = (np.repeat(np.asarray(g.indptr[:-1], np.int64)[frontier], deg)
           + np.arange(total, dtype=np.int64)
           - np.repeat(out_ptr[:-1], deg))
    targets = g.indices[src].astype(np.int64)
    parent_slot = np.repeat(np.arange(len(frontier), dtype=np.int64), deg)
    return targets, parent_slot


def _first_unseen_in_order(targets: np.ndarray, seen: np.ndarray) -> np.ndarray:
    """First occurrence of each not-yet-seen target, in list order — exactly
    the set a FIFO queue would append (each parent in order, skipping seen
    or already-queued)."""
    t = targets[~seen[targets]]
    uniq, first = np.unique(t, return_index=True)
    return uniq[np.argsort(first, kind="stable")]


def _bfs_order(g: CSRGraph) -> np.ndarray:
    """BFS visit order from the max-degree vertex per component: neighbors
    get adjacent ids, shrinking the delta gaps the varint/k-bit coders pay
    for (the objective of the reference's CPLEX gap orderings).
    Level-synchronous bulk frontiers (identical order to a FIFO queue)."""
    n = g.num_nodes
    seen = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    by_deg = np.argsort(-g.degrees, kind="stable")
    ri = 0
    while pos < n:
        while ri < n and seen[by_deg[ri]]:
            ri += 1
        frontier = np.array([by_deg[ri]], dtype=np.int64)
        seen[frontier] = True
        while len(frontier):
            order[pos : pos + len(frontier)] = frontier
            pos += len(frontier)
            nxt = _first_unseen_in_order(_frontier_targets(g, frontier)[0],
                                         seen)
            seen[nxt] = True
            frontier = nxt
    return order


def _rcm_order(g: CSRGraph) -> np.ndarray:
    """Reverse Cuthill–McKee: BFS from a low-degree peripheral vertex with
    degree-sorted neighbor expansion, order reversed. The classic non-ILP
    member of the reference's gap-minimizing family (permuters.h:25-44) —
    clusters each neighborhood's labels, shrinking coder gaps."""
    n = g.num_nodes
    seen = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    deg = g.degrees
    by_deg = np.argsort(deg, kind="stable")  # min-degree roots
    ri = 0
    while pos < n:
        while ri < n and seen[by_deg[ri]]:
            ri += 1
        frontier = np.array([by_deg[ri]], dtype=np.int64)
        seen[frontier] = True
        while len(frontier):
            order[pos : pos + len(frontier)] = frontier
            pos += len(frontier)
            targets, parent_slot = _frontier_targets(g, frontier)
            # queue semantics: each parent in order appends its unseen
            # neighbors sorted by degree (stable in row position)
            srt = np.lexsort((np.arange(len(targets)), deg[targets],
                              parent_slot))
            nxt = _first_unseen_in_order(targets[srt], seen)
            seen[nxt] = True
            frontier = nxt
    return order[::-1].copy()


def _barycenter_order(g: CSRGraph, *, sweeps: int = 10) -> np.ndarray:
    """Iterative barycenter local search: each sweep re-ranks every vertex by
    the mean position of its neighbors. The practical stand-in for the
    reference's 12 CPLEX ILP/LP 'optimal gap' orderings (an optional solver
    dependency there — FindCPLEX.cmake): same objective (small neighbor-id
    gaps), hill-climbed instead of solved exactly. Seeded from gap_bfs;
    keeps the best sweep by measured average_gap_bits."""
    n = g.num_nodes
    order = _bfs_order(g)
    pos = np.empty(n, dtype=np.float64)
    best_order = order.copy()
    best = _gap_bits_for_order(g, order)
    deg = g.degrees.astype(np.int64)
    row_of = np.repeat(np.arange(n, dtype=np.int64), deg)
    for _ in range(sweeps):
        pos[order] = np.arange(n)
        sums = np.bincount(row_of, weights=pos[g.indices], minlength=n)
        bary = np.where(deg > 0, sums / np.maximum(deg, 1), pos)
        order = np.argsort(bary, kind="stable")
        cur = _gap_bits_for_order(g, order)
        if cur < best:
            best, best_order = cur, order.copy()
    return best_order


def _row_gap_bits(indptr: np.ndarray, sorted_vals: np.ndarray) -> float:
    """Mean log2(gap+1) over per-row deltas of sorted values, first delta
    measured from -1 — one global diff, no per-vertex loop."""
    m = len(sorted_vals)
    if m == 0:
        return 0.0
    deg = np.diff(indptr)
    first = np.asarray(indptr[:-1], np.int64)[deg > 0]
    gaps = np.empty(m, dtype=np.int64)
    gaps[1:] = sorted_vals[1:] - sorted_vals[:-1]
    gaps[first] = sorted_vals[first] + 1
    return float(np.log2(np.maximum(gaps, 1) + 1).sum()) / m


def _gap_bits_for_order(g: CSRGraph, order: np.ndarray) -> float:
    n = g.num_nodes
    new_id = np.empty(n, dtype=np.int64)
    new_id[order] = np.arange(n)
    # sort relabeled ids within each row via one composite-key global sort
    deg = g.degrees.astype(np.int64)
    comp = np.repeat(np.arange(n, dtype=np.int64), deg) * n + new_id[g.indices]
    comp.sort()
    return _row_gap_bits(g.indptr, comp % n)


def average_gap_bits(g: CSRGraph) -> float:
    """Mean log2 neighbor-gap — the coder-footprint figure of merit."""
    return _row_gap_bits(g.indptr, g.indices.astype(np.int64))
