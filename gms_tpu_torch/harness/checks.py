"""Paranoid-mode invariant checking — the sanitizer-build analog.

Role of the reference's `DEBUG_WITH_SANITIZERS` CMake option (the
reference's CMakeLists.txt:5,24-30: ASan+UBSan on Debug builds) and its
pervasive asserts (`check_is_sorted`, sorted_set.h:265-268). The port's CUDA
kernels take the padded layout on trust — the merge in csrc/tier_intersect.cu
needs rows sorted with a SENTINEL tail — so the failure mode worth catching is
silent data corruption through a malformed padded layout (unsorted rows,
holes before the SENTINEL tail, a clobbered guard row, deg/row mismatch).
Enable with GMS_TPU_PARANOID=1:

  * `PaddedGraph.from_csr` and `convert.plan_from_numpy` validate every
    padded graph they build;
  * the merge kernels' wrappers (`count_tier_mat`, `count_dag_edges`) check
    their operand rows with `validate_sorted_rows`;
  * `validate_padded` can be called directly around custom layouts.

Checks are O(V*D) host numpy — debug builds only, like the reference's.
"""

from __future__ import annotations

import os

import numpy as np

SENTINEL = np.int32(np.iinfo(np.int32).max)


def paranoid() -> bool:
    return bool(os.environ.get("GMS_TPU_PARANOID"))


def enable(flag: bool = True) -> None:
    """Programmatic switch: sets the GMS_TPU_PARANOID environment flag."""
    os.environ["GMS_TPU_PARANOID"] = "1" if flag else ""


def _host(x) -> np.ndarray:
    """numpy view of a numpy array or a tensor on any device."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def validate_sorted_rows(rows, *, name: str = "rows") -> None:
    """Assert what a sorted-row merge needs of int32[R, W] rows: each row
    strictly ascending up to its first SENTINEL, and SENTINEL after it."""
    rows = _host(rows)
    valid = rows != SENTINEL
    if (valid[:, 1:] & ~valid[:, :-1]).any():
        bad = int(np.nonzero((valid[:, 1:] & ~valid[:, :-1]).any(axis=1))[0][0])
        raise AssertionError(f"{name}: row {bad} has SENTINEL holes")
    step = np.where(valid[:, 1:], rows[:, 1:].astype(np.int64) - rows[:, :-1], 1)
    if (step <= 0).any():
        bad = int(np.nonzero((step <= 0).any(axis=1))[0][0])
        raise AssertionError(f"{name}: row {bad} not strictly sorted")


def validate_padded(nbr, deg, num_nodes: int, *, name: str = "graph") -> None:
    """Assert the padded-adjacency invariants every kernel relies on:

      1. each row's first deg[v] slots are sorted strictly ascending, in
         [0, num_nodes), with no SENTINEL holes;
      2. everything at or beyond deg[v] is SENTINEL;
      3. at least one all-SENTINEL guard row exists past the real vertices
         (clip-gather target for pad ids);
      4. deg matches the SENTINEL boundary exactly.
    """
    nbr = _host(nbr)
    deg = _host(deg)
    V, D = nbr.shape
    if V < num_nodes + 1:
        raise AssertionError(f"{name}: no guard row (V={V}, n={num_nodes})")
    lanes = np.arange(D)[None, :]
    valid = nbr != SENTINEL
    count = valid.sum(axis=1)
    if not (count == deg[:V]).all():
        bad = int(np.nonzero(count != deg[:V])[0][0])
        raise AssertionError(
            f"{name}: row {bad} has {count[bad]} entries but deg {deg[bad]}")
    in_deg = lanes < deg[:V, None]
    if (valid != in_deg).any():
        bad = int(np.nonzero((valid != in_deg).any(axis=1))[0][0])
        raise AssertionError(f"{name}: row {bad} has SENTINEL holes")
    body = np.where(in_deg, nbr, np.int32(-1))
    if body.max(initial=-1) >= num_nodes or (
            np.where(in_deg, nbr, 0) < 0).any():
        raise AssertionError(f"{name}: neighbor id out of [0, n)")
    nxt = np.where(in_deg[:, 1:] & in_deg[:, :-1],
                   nbr[:, 1:] - nbr[:, :-1], 1)
    if (nxt <= 0).any():
        bad = int(np.nonzero((nxt <= 0).any(axis=1))[0][0])
        raise AssertionError(f"{name}: row {bad} not strictly sorted")
    if (nbr[num_nodes:] != SENTINEL).any():
        raise AssertionError(f"{name}: guard rows clobbered")
