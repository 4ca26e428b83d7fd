"""Vertex orderings: degree, exact degeneracy, approximate degeneracy (ADG),
triangle count — the port of gms_tpu/preprocessing/degeneracy.py.

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
agree). The host orderings are numpy, as in gms_tpu. The device ADG
(`adg_ordering_rank_device`) runs each round through one hand-written CUDA
kernel, `adg_round` (csrc/adg_round.cu, one cooperative launch a round),
with its plain version for CPU tensors, and ranks each round's peeled
vertices with one torch.sort; the triangle-count ordering runs the
per-vertex triangle kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from gms_tpu_torch import _kernels, prng
from gms_tpu_torch.device import resolve
from gms_tpu_torch.graphs.csr import CSRGraph

# Kernel launches, counted only where the CUDA kernel launches.
LAUNCHES = {"adg_round": 0}


def reset_launches() -> None:
    LAUNCHES["adg_round"] = 0


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


# ---------------------------------------------------------------------------
# device ADG (adg_ordering_rank_device)
# ---------------------------------------------------------------------------

# adg_round's boundary modes: computed from the round's stats, or drawn
_ADG_MODE = {"avg": 0, "min": 1, "prob_min": 2, "prob_median": 2}
ADG_SAMPLES = 128


# adg_round's grid: at most this many resident blocks an SM (csrc/
# adg_round.cu launches the fewer of this and what the occupancy allows)
ADG_BLOCKS_PER_SM = 4


def adg_round_plain(indptr, indices, deg, alive, *, boundary: str,
                    eps: float, bound: float | None = None):
    """Plain version of adg_round."""
    live = deg[alive]
    mn = live.min()
    if boundary == "avg":
        bound = (1.0 + eps) * live.sum().double() / alive.sum().double()
    elif boundary == "min":
        bound = (2.0 + eps) * mn.double()
    thr = torch.where(mn.double() <= bound, bound, mn.double())
    peel = alive & (deg.double() <= thr)
    src = torch.repeat_interleave(
        torch.arange(deg.shape[0], device=deg.device), indptr.diff())
    dec = torch.zeros_like(deg).index_add_(
        0, src, peel[indices.long()].long())
    deg -= torch.where(alive & ~peel, dec, 0)
    alive &= ~peel
    return peel


def adg_round(indptr, indices, deg, alive, *, boundary: str, eps: float,
              bound: float | None = None):
    """One ADG round, in place on deg and alive; returns the peel mask.

    indptr int64[n+1] and indices int32[E] are the undirected CSR, deg
    int64[n] the alive vertices' remaining degrees, alive bool[n]. The
    boundary is computed in float64 as gms_tpu's device version does —
    avg: ((1 + eps) * Σ deg) / n_alive, min: (2 + eps) * min deg, over the
    alive vertices — or, for the sampled boundaries, is the given `bound`.
    peel = alive & (deg <= bound), or the alive vertices of minimum degree
    when that is empty; each vertex that stays alive loses its peeled
    neighbours from deg. Replaces the round of gms_tpu's
    adg_ordering_rank_device (degeneracy.py:215-250) but its ranking. On
    the card one cooperative launch of csrc/adg_round.cu: stats, mask and
    pull between two grid barriers, a staying row's pieces of 512 entries
    a warp each.
    """
    name = "adg_round"
    if boundary not in _ADG_MODE:
        raise ValueError(f"{name}: unknown boundary {boundary!r}")
    if _ADG_MODE[boundary] == 2 and bound is None:
        raise ValueError(f"{name}: boundary {boundary!r} needs `bound`")
    n = deg.shape[0]
    for what, t, dtype, shape in (("indptr", indptr, torch.int64, (n + 1,)),
                                  ("indices", indices, torch.int32, None),
                                  ("deg", deg, torch.int64, (n,)),
                                  ("alive", alive, torch.bool, (n,))):
        _kernels.check_tensor(name, what, t, 1, dtype)
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    if not _kernels.on_cuda(name, indptr, indices, deg, alive):
        return adg_round_plain(indptr, indices, deg, alive,
                               boundary=boundary, eps=eps, bound=bound)
    peel = torch.empty_like(alive)
    # the item count, the blocks' partials and the work list of the pull
    max_blocks = ADG_BLOCKS_PER_SM * _kernels.sm_count(deg.device.index)
    scratch = torch.empty(2 + 3 * max_blocks + n + indices.shape[0] // 512,
                          dtype=torch.int64, device=deg.device)
    _kernels.launch("adg_round", "adg_round", indptr, indices, n, deg, alive,
                    peel, scratch, max_blocks, _ADG_MODE[boundary],
                    float(eps), float(bound or 0.0))
    LAUNCHES[name] += 1
    return peel


def adg_ordering_rank_device(
    g: CSRGraph, eps: float = 0.1, boundary: str = "avg", seed: int = 0, *,
    device="cuda",
) -> np.ndarray:
    """ADG on the device — the port of gms_tpu's adg_ordering_rank_device.

    Each round is one `adg_round` (boundary, peel, pull) and one torch.sort
    of the peeled vertices by (deg, id); the loop is Python, with one
    read-back a round (the peeled count). "avg" and "min" match gms_tpu's
    device and host versions rank for rank. "prob_min" and "prob_median"
    draw ADG_SAMPLES positions a round, with replacement, into the sorted
    alive degrees — gms_tpu's draw, jax.random's int64 randint over
    [0, n_alive) keyed PRNGKey(seed) folded with the round (prng.py) — so
    they too equal gms_tpu's ranks; the median averages the two middle
    samples, as jnp.median does.
    """
    dev = resolve(device)
    n = g.num_nodes
    if n == 0:
        return np.zeros(0, dtype=np.int32)
    if boundary not in _ADG_MODE:
        raise ValueError(f"unknown device ADG boundary {boundary!r}")
    indptr = torch.from_numpy(g.indptr).to(dev)
    indices = torch.from_numpy(g.indices).to(dev)
    deg = torch.from_numpy(g.degrees.astype(np.int64)).to(dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    rank = torch.empty(n, dtype=torch.int32, device=dev)
    key0 = prng.PRNGKey(seed, dev)
    next_rank, rnd = 0, 0
    while next_rank < n:
        bound = None
        if _ADG_MODE[boundary] == 2:
            live = torch.sort(deg[alive]).values
            take = prng.randint(prng.fold_in(key0, rnd), (ADG_SAMPLES,), 0,
                                max(live.numel(), 1), torch.int64)
            vals = live[take].cpu().numpy().astype(np.float64)
            bound = ((2.0 + eps) * vals.min() if boundary == "prob_min"
                     else (1.0 + eps) * np.median(vals))
        peel = adg_round(indptr, indices, deg, alive, boundary=boundary,
                         eps=eps, bound=bound)
        ids = torch.nonzero(peel)[:, 0]
        order = ids[torch.argsort(deg[ids] * n + ids)]
        rank[order] = torch.arange(next_rank, next_rank + len(ids),
                                   dtype=torch.int32, device=dev)
        next_rank += len(ids)
        rnd += 1
    return rank.cpu().numpy()


def core_numbers(g: CSRGraph) -> np.ndarray:
    """Exact core number per vertex (util/core_number_evaluator.h:19-44)."""
    _rank, core, _k = _degeneracy_peel(g)
    return core


def triangle_count_ordering_rank(g: CSRGraph, *, device="cuda") -> np.ndarray:
    """Rank by per-vertex triangle count (asc, ties by id) —
    triangleCountOrdering (parallel/triangle_count.h:11-31)."""
    from gms_tpu_torch.algorithms.triangle_count import (
        triangle_count_per_vertex)

    tc = triangle_count_per_vertex(g, device=device)
    order = np.lexsort((np.arange(g.num_nodes), tc))
    return order_to_rank(order)


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
