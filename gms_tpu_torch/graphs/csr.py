"""Host-side CSR graph (the "CGraph" layer).

Covers the role of GAPBS `CSRGraph` (reference: gms/third_party/gapbs/graph.h:93-376)
as the canonical in-memory representation that every device layout is built
from. Unlike the reference (pointer-based C++), this is a pair of flat numpy
arrays — already the natural precursor to a padded device layout.

Conventions (matching reference semantics):
  * Vertex ids are int32 ("NodeId", reference gms/common/types.h:9).
  * `num_edges()` counts directed edges stored (for an undirected graph each
    edge appears twice); `num_edges_undirected()` halves it
    (reference gapbs/graph.h:244-252).
  * Neighbor lists are sorted ascending and deduplicated after `squish`.
"""

from __future__ import annotations

import numpy as np


class CSRGraph:
    """Compressed-sparse-row adjacency over int32 vertex ids.

    indptr: int64[num_nodes + 1]
    indices: int32[num_edges]   (sorted within each row after squish)
    """

    def __init__(self, indptr: np.ndarray, indices: np.ndarray, *,
                 directed: bool = False, weights: np.ndarray | None = None):
        self.indptr = np.ascontiguousarray(indptr, dtype=np.int64)
        self.indices = np.ascontiguousarray(indices, dtype=np.int32)
        self._directed = bool(directed)
        # optional per-CSR-slot weights (the reference's WGraph/.wel role,
        # gapbs/graph.h WNode); None for unweighted graphs
        self.weights = (None if weights is None
                        else np.ascontiguousarray(weights, dtype=np.int32))
        if self.indptr[0] != 0 or self.indptr[-1] != len(self.indices):
            raise ValueError("inconsistent indptr/indices")
        if self.weights is not None and len(self.weights) != len(self.indices):
            raise ValueError("weights/indices length mismatch")

    # -- basic accessors (reference gapbs/graph.h:226-268) --------------------

    @property
    def num_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def num_edges(self) -> int:
        """Directed edge count (undirected edges counted twice)."""
        return len(self.indices)

    @property
    def num_edges_undirected(self) -> int:
        return self.num_edges // 2 if not self._directed else self.num_edges

    def directed(self) -> bool:
        return self._directed

    def out_degree(self, v: int) -> int:
        return int(self.indptr[v + 1] - self.indptr[v])

    @property
    def degrees(self) -> np.ndarray:
        return (self.indptr[1:] - self.indptr[:-1]).astype(np.int32)

    def out_neigh(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v] : self.indptr[v + 1]]

    @property
    def max_degree(self) -> int:
        return 0 if self.num_nodes == 0 else int(self.degrees.max(initial=0))

    # -- conversions ----------------------------------------------------------

    def edge_array(self) -> np.ndarray:
        """All directed edges as int32[E, 2] (src, dst), CSR order."""
        src = np.repeat(
            np.arange(self.num_nodes, dtype=np.int32), self.degrees.astype(np.int64)
        )
        return np.stack([src, self.indices], axis=1)

    def undirected_edge_array(self) -> np.ndarray:
        """Unique undirected edges (u < v) as int32[M, 2]."""
        e = self.edge_array()
        return e[e[:, 0] < e[:, 1]]

    def to_sets(self) -> list:
        """Row views (for host-side oracles / debugging)."""
        return [self.out_neigh(v) for v in range(self.num_nodes)]

    def clone(self) -> "CSRGraph":
        return CSRGraph(self.indptr.copy(), self.indices.copy(), directed=self._directed)

    # -- induced / relabeled variants used across the suite -------------------

    def induce_dag(self, rank: np.ndarray) -> "CSRGraph":
        """Keep edges u->v with rank[u] < rank[v] (DAG orientation).

        Equivalent of PpSequential::InduceDirectedGraph
        (reference gms/algorithms/preprocessing/sequential/apply_order.h:10-35):
        applies a rank array and rebuilds CSR keeping only forward edges.
        Vertex ids are NOT relabeled; only the edge set is filtered.
        """
        rank = np.asarray(rank)
        e = self.edge_array()
        keep = rank[e[:, 0]] < rank[e[:, 1]]
        e = e[keep]
        return _csr_from_sorted_pairs(e, self.num_nodes, directed=True)

    def relabel(self, new_id: np.ndarray) -> "CSRGraph":
        """Relabel vertices: vertex v becomes new_id[v]; rows re-sorted."""
        new_id = np.asarray(new_id, dtype=np.int32)
        e = self.edge_array()
        e = np.stack([new_id[e[:, 0]], new_id[e[:, 1]]], axis=1)
        order = np.lexsort((e[:, 1], e[:, 0]))
        return _csr_from_sorted_pairs(e[order], self.num_nodes, directed=self._directed)

    def remove_isolated(self) -> tuple["CSRGraph", np.ndarray]:
        """Drop degree-0 vertices, compacting ids.

        Equivalent of SetGraph's isolated-vertex removal
        (reference gms/representations/graphs/set_graph.h:190-232).
        Returns (graph, old_ids) where old_ids[i] is the original id of new
        vertex i.
        """
        deg = self.degrees
        keep = deg > 0
        old_ids = np.nonzero(keep)[0].astype(np.int32)
        remap = np.full(self.num_nodes, -1, dtype=np.int32)
        remap[old_ids] = np.arange(len(old_ids), dtype=np.int32)
        e = self.edge_array()
        e = np.stack([remap[e[:, 0]], remap[e[:, 1]]], axis=1)
        order = np.lexsort((e[:, 1], e[:, 0]))
        g = _csr_from_sorted_pairs(e[order], len(old_ids), directed=self._directed)
        return g, old_ids

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, CSRGraph)
            and np.array_equal(self.indptr, other.indptr)
            and np.array_equal(self.indices, other.indices)
        )

    def __repr__(self) -> str:
        kind = "directed" if self._directed else "undirected"
        return f"CSRGraph({kind}, n={self.num_nodes}, m={self.num_edges})"


def _csr_from_sorted_pairs(e: np.ndarray, num_nodes: int, *, directed: bool) -> CSRGraph:
    """Build CSR from edge pairs already sorted by (src, dst)."""
    counts = np.bincount(e[:, 0], minlength=num_nodes).astype(np.int64)
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSRGraph(indptr, e[:, 1].astype(np.int32), directed=directed)
