"""Batched set algebra over padded sorted rows — the port of gms_tpu/sets/ops.py.

Role of the reference's Set concept (gms/representations/sets/sorted_set.h:
89-262: cardinality / intersect / intersect_count / union / difference /
contains). Every op takes a *batch* of set pairs as two rectangular int32
tensors

    a : int32[B, Da]    b : int32[B, Db]

rows sorted ascending, padded with SENTINEL (int32 max). Two membership
strategies, as in gms_tpu:
  * compare: (a[:,:,None] == b[:,None,:]) masked + reduced;
  * searchsorted: binary-search b for each element of a.

These are plain PyTorch on any device; they are the plain versions under the
triangle-count tier kernels (csrc/tier_intersect.cu), which merge sorted rows
instead. All counts are exact integers (int32 per pair, int64 above).
"""

from __future__ import annotations

import numpy as np
import torch

from gms_tpu_torch.graphs.tiles import SENTINEL

# Above this compare-matrix size per pair, switch to searchsorted.
_COMPARE_LIMIT = 1 << 21

_SENT = int(SENTINEL)


def valid_mask(rows):
    return rows != _SENT


def cardinality(rows):
    """int32[B] true sizes (sorted_set.h cardinality)."""
    return valid_mask(rows).sum(dim=-1, dtype=torch.int32)


def _sorted(x):
    return torch.sort(x, dim=1).values


# ---------------------------------------------------------------------------
# membership cores
# ---------------------------------------------------------------------------

def _member_compare(a, b):
    """bool[B, Da]: a[i] in b-row, via dense broadcast equality."""
    hit = (a[:, :, None] == b[:, None, :]).any(dim=2)
    return hit & valid_mask(a)


def _member_searchsorted(a, b):
    """bool[B, Da]: a[i] in b-row, via per-row binary search."""
    idx = torch.searchsorted(b, a, side="left")
    idx = idx.clamp_(max=b.shape[1] - 1)
    found = torch.gather(b, 1, idx) == a
    return found & valid_mask(a)


def member(a, b, *, method: str = "auto"):
    """bool[B, Da]: membership of each a-element in its paired b-row."""
    if method == "auto":
        method = ("compare" if a.shape[1] * b.shape[1] <= _COMPARE_LIMIT
                  else "searchsorted")
    if method == "compare":
        return _member_compare(a, b)
    if method == "searchsorted":
        return _member_searchsorted(a, b)
    raise ValueError(f"unknown method {method!r}")


# ---------------------------------------------------------------------------
# the Set concept ops
# ---------------------------------------------------------------------------

def intersect_count(a, b, *, method: str = "auto"):
    """int32[B] = |a_i ∩ b_i| (sorted_set.h:176-182)."""
    return member(a, b, method=method).sum(dim=1, dtype=torch.int32)


def intersect(a, b, *, method: str = "auto"):
    """int32[B, Da] = sorted (a_i ∩ b_i), SENTINEL-padded."""
    m = member(a, b, method=method)
    return _sorted(torch.where(m, a, _SENT))


def difference(a, b, *, method: str = "auto"):
    """int32[B, Da] = sorted (a_i \\ b_i) (sorted_set.h:184-216)."""
    m = member(a, b, method=method)
    keep = valid_mask(a) & ~m
    return _sorted(torch.where(keep, a, _SENT))


def union(a, b):
    """int32[B, Da+Db] = sorted (a_i ∪ b_i) (sorted_set.h:104-158).

    concat -> sort -> drop duplicates (neighbor-equal after sort) -> re-sort.
    """
    cat = _sorted(torch.cat([a, b], dim=1))
    dup = torch.cat([torch.zeros((cat.shape[0], 1), dtype=torch.bool,
                                 device=cat.device),
                     cat[:, 1:] == cat[:, :-1]], dim=1)
    keep = valid_mask(cat) & ~dup
    return _sorted(torch.where(keep, cat, _SENT))


def union_count(a, b):
    """int32[B] = |a_i ∪ b_i| without materializing (|a|+|b|-|a∩b|)."""
    return cardinality(a) + cardinality(b) - intersect_count(a, b)


def difference_count(a, b):
    return cardinality(a) - intersect_count(a, b)


def contains(rows, x):
    """bool[B]: x_i ∈ row_i (sorted_set.h:218 lower_bound probe)."""
    x = x[:, None]
    idx = torch.searchsorted(rows, x, side="left").clamp_(max=rows.shape[1] - 1)
    return (torch.gather(rows, 1, idx) == x)[:, 0] & (x[:, 0] != _SENT)


def add(rows, x):
    """int32[B, D+1]: insert x_i into each row (sorted_set.h add)."""
    return _sorted(torch.cat([rows, x[:, None]], dim=1))


def remove(rows, x):
    """int32[B, D]: delete x_i from each row if present."""
    hit = rows == x[:, None]
    return _sorted(torch.where(hit, _SENT, rows))


def to_array(row) -> np.ndarray:
    """Host-side: compact one padded row to its true elements (numpy)."""
    row = row.cpu().numpy() if isinstance(row, torch.Tensor) else np.asarray(row)
    return row[row != SENTINEL]


def from_array(values, width: int, *, device="cuda") -> torch.Tensor:
    """Pad a sorted 1-D array to a padded row of `width` on `device`."""
    from gms_tpu_torch.device import resolve

    values = np.sort(np.asarray(values, dtype=np.int32))
    out = np.full(width, SENTINEL, dtype=np.int32)
    out[: len(values)] = values
    return torch.from_numpy(out).to(resolve(device))
