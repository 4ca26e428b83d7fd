"""Orientation / DAG induction helpers.

Role of PpSequential::InduceDirectedGraph (reference
gms/algorithms/preprocessing/sequential/apply_order.h:10-35) plus the implicit
`u < v` orientation used by triangle counting (reference
gms/algorithms/set_based/triangle_count/parallel/total.h:12-21 iterates
u < v over a degree-relabeled graph).

An orientation is defined by a rank array; the oriented graph keeps edges
u -> v with rank[u] < rank[v]. Every counting kernel in the suite runs on the
resulting DAG, whose max out-degree bounds all candidate-set widths (the
padding dimension of the device tiles) — this is the device analog of the
reference's working-set-bounding orderings (SURVEY.md §5 long-context note).
"""

from __future__ import annotations

import numpy as np

from gms_tpu_torch.graphs.csr import CSRGraph


def id_rank(g: CSRGraph) -> np.ndarray:
    return np.arange(g.num_nodes, dtype=np.int32)


def degree_rank(g: CSRGraph) -> np.ndarray:
    """rank[v] = position of v in (degree asc, id asc) order.

    Orienting low-degree -> high-degree bounds DAG out-degree by O(sqrt(m))
    — the arboricity argument behind the reference's degree preprocessing
    (gms/algorithms/preprocessing/parallel/degree.h:25-61).
    """
    order = np.lexsort((np.arange(g.num_nodes), g.degrees))
    rank = np.empty(g.num_nodes, dtype=np.int32)
    rank[order] = np.arange(g.num_nodes, dtype=np.int32)
    return rank


def orient(g: CSRGraph, rank: np.ndarray | None = None) -> CSRGraph:
    """Induce the DAG keeping edges with rank[u] < rank[v]."""
    if rank is None:
        rank = id_rank(g)
    return g.induce_dag(rank)
