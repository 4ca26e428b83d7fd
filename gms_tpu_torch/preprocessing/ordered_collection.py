"""Tracked ordered collections + Danisch degeneracy-peel variants — the port
of gms_tpu/preprocessing/ordered_collection.py (host numpy, as there; no
device program).

Covers reference gms/algorithms/preprocessing/util/OrderedCollection.h
(TrackingBubblingArray:26, TrackingStdHeap:136) and
sequential/degeneracy_danisch.h:11-64 (getDegeneracyOrderingDanisch{Heap,
Bubble}): exact degeneracy via repeated PopHead of the minimum-degree
vertex from a collection supporting decrease-key with position tracking.
The reference uses these to build the kClist DAG; their unit-test surface
is testing/clique_counting.cpp's TrackingHeap_tests.h /
TrackingBubblingArray_tests.h, mirrored by tests/test_torch_degeneracy.py.

These are host-side preprocessing strategy variants (the peel is
inherently sequential — the reference keeps it serial too); the output
contract is identical to `degeneracy_ordering_rank` (rank format, peel
order), so every device kernel downstream is unchanged. The default exact
path remains the Batagelj-Zaversnik bucket peel of degeneracy.py.
"""

from __future__ import annotations

import numpy as np

from gms_tpu_torch.graphs.csr import CSRGraph


class TrackingBubblingArray:
    """Array kept sorted by value (ascending); decrease-key bubbles the
    entry toward the front past equal-valued neighbors; PopHead takes the
    minimum and advances the window start (OrderedCollection.h:26-134).

    Keys are 0..n-1; `index(k)` is -1 once k is popped."""

    def __init__(self, values: np.ndarray):
        n = len(values)
        order = np.argsort(values, kind="stable").astype(np.int64)
        self._keys = order.copy()                 # position -> key
        self._vals = np.asarray(values, dtype=np.int64)[order]
        self._pos = np.empty(n, np.int64)         # key -> position
        self._pos[order] = np.arange(n)
        self._start = 0
        self._n = n

    def __len__(self) -> int:
        return self._n - self._start

    def index(self, key: int) -> int:
        p = self._pos[key]
        return -1 if p < self._start else int(p - self._start)

    def value(self, key: int) -> int:
        p = self._pos[key]
        if p < self._start:  # popped (or outside the window): no value
            raise KeyError(key)
        return int(self._vals[p])

    def pop_head(self) -> tuple[int, int]:
        p = self._start
        self._start += 1
        key = int(self._keys[p])
        self._pos[key] = -1 - p  # mark popped (negative)
        return key, int(self._vals[p])

    def decrease_key(self, key: int) -> None:
        p = self._pos[key]
        if p < self._start:
            raise KeyError(key)
        self._vals[p] -= 1
        v = self._vals[p]
        # bubble left past entries with larger value
        q = p
        while q > self._start and self._vals[q - 1] > v:
            q -= 1
        if q != p:
            other = self._keys[q]
            self._keys[p], self._keys[q] = other, key
            self._vals[p], self._vals[q] = self._vals[q], v
            self._pos[key], self._pos[other] = q, p


class TrackingHeap:
    """Binary min-heap keyed by value with key->slot tracking so
    decrease-key is O(log n) (OrderedCollection.h:136+ TrackingStdHeap
    role; the reference wraps std::push_heap with lazy rebuilds — here a
    direct tracked heap, same observable contract)."""

    def __init__(self, values: np.ndarray):
        n = len(values)
        self._vals = np.asarray(values, dtype=np.int64).copy()
        self._heap = np.arange(n, dtype=np.int64)  # slot -> key
        self._slot = np.arange(n, dtype=np.int64)  # key -> slot
        self._n = n
        for i in range(n // 2 - 1, -1, -1):
            self._sift_down(i)

    def __len__(self) -> int:
        return self._n

    def index(self, key: int) -> int:
        s = self._slot[key]
        return -1 if s < 0 or s >= self._n else int(s)

    def value(self, key: int) -> int:
        return int(self._vals[key])

    def _less(self, a: int, b: int) -> bool:
        ka, kb = self._heap[a], self._heap[b]
        va, vb = self._vals[ka], self._vals[kb]
        return (va, ka) < (vb, kb)

    def _swap(self, a: int, b: int) -> None:
        ka, kb = self._heap[a], self._heap[b]
        self._heap[a], self._heap[b] = kb, ka
        self._slot[ka], self._slot[kb] = b, a

    def _sift_up(self, i: int) -> None:
        while i > 0:
            p = (i - 1) // 2
            if self._less(i, p):
                self._swap(i, p)
                i = p
            else:
                break

    def _sift_down(self, i: int) -> None:
        while True:
            l, r = 2 * i + 1, 2 * i + 2
            m = i
            if l < self._n and self._less(l, m):
                m = l
            if r < self._n and self._less(r, m):
                m = r
            if m == i:
                break
            self._swap(i, m)
            i = m

    def pop_head(self) -> tuple[int, int]:
        key = int(self._heap[0])
        val = int(self._vals[key])
        last = self._n - 1
        self._swap(0, last)
        self._slot[key] = -1
        self._n = last
        if last:
            self._sift_down(0)
        return key, val

    def decrease_key(self, key: int) -> None:
        s = self._slot[key]
        if s < 0 or s >= self._n:
            raise KeyError(key)
        self._vals[key] -= 1
        self._sift_up(int(s))


def degeneracy_ordering_rank_danisch(
    g: CSRGraph, *, collection: str = "heap",
) -> tuple[np.ndarray, int]:
    """Exact degeneracy rank via the Danisch decrease-key peel
    (degeneracy_danisch.h:11-64). Returns (rank, degeneracy) with the same
    rank-format contract as `degeneracy.degeneracy_ordering_rank`
    (rank[v] = peel position; every downstream DAG induction unchanged)."""
    n = g.num_nodes
    if collection == "heap":
        coll = TrackingHeap(g.degrees)
    elif collection == "bubble":
        coll = TrackingBubblingArray(g.degrees)
    else:
        raise ValueError(f"unknown collection {collection!r}")
    rank = np.empty(n, dtype=np.int32)
    core = 0
    for i in range(n):
        v, d = coll.pop_head()
        core = max(core, d)
        rank[v] = i
        for w in g.out_neigh(v):
            if coll.index(int(w)) != -1:
                coll.decrease_key(int(w))
    return rank, core
