"""Vertex orderings: degree, exact degeneracy, approximate degeneracy (ADG) —
the port of gms_tpu/preprocessing/degeneracy.py (host numpy, as there).

Covers reference gms/algorithms/preprocessing/:
  * getDegreeOrdering (parallel/degree.h:25-61, sequential/degree.h:11-46)
  * getDegeneracyOrderingMatula (sequential/degeneracy_matula.h:13-66) — exact
    bucket peel; inherently sequential, so it runs on the host.
  * getDegeneracyOrderingApproxSGraph / CGraph (parallel/degeneracy_approx_set.h
    :13-85, degeneracy_approx_csr.h:12-79) — ADG: iteratively peel all
    vertices whose degree <= boundary(remaining degrees); ε-parameterized.
  * boundary functions avgDegree/minDegree/probMinDegree/probMedianDegree
    (parallel/boundary_function.h:9-93).
  * order-format vs rank-format duality + conversion
    (util/core_number_evaluator.h:47-70): Order-Format res[i] = i-th vertex;
    Rank-Format res[v] = rank of v.

All functions return RANK format (rank[v] = position of v); use
`rank_to_order` / `order_to_rank` to convert.

The exact peel is gms_tpu's numpy loop; gms_tpu runs a native C++ peel first,
whose ranks may differ from this loop's on ties (core numbers and degeneracy
agree). The device ADG (`adg_ordering_rank_device`) and the triangle-count
ordering are not ported yet.
"""

from __future__ import annotations

import numpy as np

from gms_tpu_torch.graphs.csr import CSRGraph


def order_to_rank(order: np.ndarray) -> np.ndarray:
    rank = np.empty(len(order), dtype=np.int32)
    rank[order] = np.arange(len(order), dtype=np.int32)
    return rank


def rank_to_order(rank: np.ndarray) -> np.ndarray:
    return order_to_rank(rank)  # involution


def degree_ordering_rank(g: CSRGraph) -> np.ndarray:
    """rank by (degree asc, id asc) — parallel/degree.h:25-61."""
    order = np.lexsort((np.arange(g.num_nodes), g.degrees))
    return order_to_rank(order)


def degeneracy_ordering_rank(g: CSRGraph) -> tuple[np.ndarray, int]:
    """Exact degeneracy (smallest-last) ordering; returns (rank, degeneracy)."""
    rank, _core, k = _degeneracy_peel(g)
    return rank, k


def _degeneracy_peel(g: CSRGraph) -> tuple[np.ndarray, np.ndarray, int]:
    """Batagelj-Zaversnik bucket peel -> (rank, core_numbers, degeneracy).

    O(n + m) exact smallest-last ordering — the role of
    getDegeneracyOrderingMatula (sequential/degeneracy_matula.h:13-66) and
    CoreNumberEvaluator (util/core_number_evaluator.h:19-44) in one pass.
    """
    n = g.num_nodes
    if n == 0:
        return np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.int32), 0
    deg = g.degrees.astype(np.int64).copy()
    max_deg = int(deg.max(initial=0))
    # vert: vertices sorted by current degree; bin_ptr[d] = start of bucket d
    bin_count = np.bincount(deg, minlength=max_deg + 1)
    bin_ptr = np.zeros(max_deg + 2, dtype=np.int64)
    np.cumsum(bin_count, out=bin_ptr[1:])
    bin_ptr = bin_ptr[:-1]
    order = np.argsort(deg, kind="stable")
    vert = order.copy()
    pos = np.empty(n, dtype=np.int64)
    pos[vert] = np.arange(n)
    indptr, indices = g.indptr, g.indices
    rank = np.empty(n, dtype=np.int32)
    core = np.zeros(n, dtype=np.int32)
    degeneracy = 0
    for i in range(n):
        v = vert[i]
        degeneracy = max(degeneracy, int(deg[v]))
        core[v] = degeneracy
        rank[v] = i
        for w in indices[indptr[v]:indptr[v + 1]]:
            dw = deg[w]
            if dw > deg[v]:
                # swap w with the first vertex of its bucket, advance bucket
                pw, pfront = pos[w], bin_ptr[dw]
                front = vert[pfront]
                vert[pw], vert[pfront] = front, w
                pos[w], pos[front] = pfront, pw
                bin_ptr[dw] += 1
                deg[w] = dw - 1
    return rank, core, degeneracy


# ---------------------------------------------------------------------------
# boundary functions (parallel/boundary_function.h:9-93)
# ---------------------------------------------------------------------------

def boundary_avg_degree(deg_remaining: np.ndarray, eps: float, rng) -> float:
    return (1.0 + eps) * float(deg_remaining.mean())


def boundary_min_degree(deg_remaining: np.ndarray, eps: float, rng) -> float:
    return (2.0 + eps) * float(deg_remaining.min())


def boundary_prob_min_degree(deg_remaining: np.ndarray, eps: float, rng,
                             samples: int = 128) -> float:
    take = rng.integers(0, len(deg_remaining), size=min(samples, len(deg_remaining)))
    return (2.0 + eps) * float(deg_remaining[take].min())


def boundary_prob_median_degree(deg_remaining: np.ndarray, eps: float, rng,
                                samples: int = 128) -> float:
    take = rng.integers(0, len(deg_remaining), size=min(samples, len(deg_remaining)))
    return (1.0 + eps) * float(np.median(deg_remaining[take]))


BOUNDARY_FUNCTIONS = {
    "avg": boundary_avg_degree,
    "min": boundary_min_degree,
    "prob_min": boundary_prob_min_degree,
    "prob_median": boundary_prob_median_degree,
}


def adg_ordering_rank(
    g: CSRGraph, eps: float = 0.1, boundary: str = "avg", seed: int = 0,
) -> np.ndarray:
    """Approximate degeneracy ordering (ADG).

    Iteratively: compute boundary from remaining-degree stats; peel ALL
    vertices with remaining degree <= boundary at once (sorted by degree,
    ties by id, within the peel — matching the reference's partition+sort,
    degeneracy_approx_set.h:36-56); decrement neighbor degrees (bulk
    'pull' update). O(log n) rounds. The sampled boundaries draw from
    np.random.default_rng(seed), as gms_tpu's host version does, so a seed
    gives gms_tpu's rank.
    """
    n = g.num_nodes
    if n == 0:
        return np.zeros(0, dtype=np.int32)
    rng = np.random.default_rng(seed)
    bfun = BOUNDARY_FUNCTIONS[boundary]
    deg = g.degrees.astype(np.int64).copy()
    alive = np.ones(n, dtype=bool)
    rank = np.empty(n, dtype=np.int32)
    next_rank = 0
    while alive.any():
        live_deg = deg[alive]
        bound = bfun(live_deg, eps, rng)
        peel = alive & (deg <= bound)
        if not peel.any():  # guard: always progress
            peel = alive & (deg <= live_deg.min())
        ids = np.nonzero(peel)[0]
        order = ids[np.lexsort((ids, deg[ids]))]
        rank[order] = np.arange(next_rank, next_rank + len(order), dtype=np.int32)
        next_rank += len(order)
        # bulk degree update: subtract, for each remaining vertex, its edge
        # count into the peeled set (reference PULL via intersect_count)
        peeled_edges = peel[g.indices]
        dec = np.bincount(
            np.repeat(np.arange(n), g.degrees.astype(np.int64))[peeled_edges],
            minlength=n,
        )
        deg -= dec
        alive &= ~peel
    return rank


def core_numbers(g: CSRGraph) -> np.ndarray:
    """Exact core number per vertex (util/core_number_evaluator.h:19-44)."""
    _rank, core, _k = _degeneracy_peel(g)
    return core


# ---------------------------------------------------------------------------
# verifiers (verifiers/degeneracy_verifier.h, verifiers/verifiers.h:7-13)
# ---------------------------------------------------------------------------

def verify_degeneracy_order(g: CSRGraph, rank: np.ndarray) -> bool:
    """Exact-degeneracy check via naive peeling
    (degeneracy_verifier.h:38-84): walking the order, each vertex's
    forward degree must never exceed the true degeneracy, and the max must
    reach it."""
    e = g.edge_array()
    fwd = rank[e[:, 0]] < rank[e[:, 1]]
    fwd_deg = np.bincount(e[fwd][:, 0], minlength=g.num_nodes)
    _, true_k = degeneracy_ordering_rank(g)
    return int(fwd_deg.max(initial=0)) == true_k


def verify_approx_degeneracy_order(
    g: CSRGraph, rank: np.ndarray, eps: float
) -> bool:
    """ADG check (degeneracy_verifier.h:87-111): the approximate order's
    core number (max forward degree) must be at least as good as the degree
    ordering's, on top of the 2(2+eps)+1 theory bound (+1 slack for sampled
    boundary estimates), and the rank must be a permutation."""
    rank = np.asarray(rank)
    if sorted(rank.tolist()) != list(range(g.num_nodes)):
        return False
    stats = evaluate_ordering(g, rank)
    deg_stats = evaluate_ordering(g, degree_ordering_rank(g))
    return (stats["max_forward_degree"] <= deg_stats["max_forward_degree"]
            and stats["ratio"] <= 2 * (2.0 + eps) + 1)


def verify_degree_monotone(g: CSRGraph, rank: np.ndarray) -> bool:
    """Degree-monotonicity check (degeneracy_verifier.h:113-137): the order
    lists vertices by non-decreasing degree."""
    order = rank_to_order(np.asarray(rank))
    deg = g.degrees[order]
    return bool(np.all(np.diff(deg) >= 0))


def evaluate_ordering(g: CSRGraph, rank: np.ndarray) -> dict:
    """Core-number accuracy stats for an (approximate) ordering vs exact
    (util/core_number_evaluator.h accuracy stats): for each v, its forward
    degree under `rank`; compare max to true degeneracy."""
    e = g.edge_array()
    fwd = rank[e[:, 0]] < rank[e[:, 1]]
    fwd_deg = np.bincount(e[fwd][:, 0], minlength=g.num_nodes)
    _, true_degeneracy = degeneracy_ordering_rank(g)
    return {
        "max_forward_degree": int(fwd_deg.max(initial=0)),
        "true_degeneracy": int(true_degeneracy),
        "ratio": float(fwd_deg.max(initial=0)) / max(true_degeneracy, 1),
    }
