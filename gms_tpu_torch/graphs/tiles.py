"""Padded dense-tile graph layout — the port of gms_tpu/graphs/tiles.py.

Role of `SetGraph<SortedSet>` (reference gms/representations/graphs/set_graph.h
:10-233): adjacency as sorted neighbor lists, held as ONE rectangular tensor

    nbr : int32[V_pad, D_pad]   rows sorted ascending, padded with SENTINEL
    deg : int32[V_pad]          true row lengths

SENTINEL = int32 max keeps padded rows sorted, so searchsorted and merge
logic need no special cases; validity is `x != SENTINEL`.

The layout is built in numpy exactly as gms_tpu builds it — D_pad rounds up to
a multiple of 128, V_pad to a multiple of 8 with at least one all-SENTINEL
guard row — so `nbr` equals gms_tpu's element for element, then moves to the
requested device.
"""

from __future__ import annotations

import numpy as np
import torch

from gms_tpu_torch.device import resolve

SENTINEL = np.int32(np.iinfo(np.int32).max)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class PaddedGraph:
    """Rectangular padded adjacency resident on a device."""

    def __init__(self, nbr: torch.Tensor, deg: torch.Tensor, num_nodes: int,
                 num_edges: int):
        self.nbr = nbr  # int32[V_pad, D_pad]
        self.deg = deg  # int32[V_pad]
        self.num_nodes = int(num_nodes)
        self.num_edges = int(num_edges)  # directed (stored) edge count

    @property
    def v_pad(self) -> int:
        return self.nbr.shape[0]

    @property
    def d_pad(self) -> int:
        return self.nbr.shape[1]

    @classmethod
    def from_csr(cls, g, *, device="cuda", d_pad: int | None = None,
                 v_pad: int | None = None, lane: int = 128,
                 sublane: int = 8) -> "PaddedGraph":
        """Build from a host CSRGraph (role of SetGraph::FromCGraph,
        set_graph.h:162-168 — one bulk scatter, not per-vertex builds)."""
        dev = resolve(device)
        n = g.num_nodes
        deg = g.degrees.astype(np.int32)
        dmax = int(deg.max(initial=0))
        D = round_up(max(d_pad or 0, dmax, 1), lane)
        # always reserve >= 1 all-SENTINEL row beyond the real vertices:
        # work arrays are padded with vertex id v_pad and clip-gathers of it
        # must land on an empty row
        V = round_up(max(v_pad or 0, n + 1, 1), sublane)
        nbr = np.full((V, D), SENTINEL, dtype=np.int32)
        if g.num_edges:
            rows = np.repeat(np.arange(n), deg.astype(np.int64))
            offs = (np.arange(g.num_edges, dtype=np.int64)
                    - np.repeat(g.indptr[:-1], deg.astype(np.int64)))
            nbr[rows, offs] = g.indices
        deg_full = np.zeros(V, dtype=np.int32)
        deg_full[:n] = deg
        from gms_tpu_torch.harness import checks
        if checks.paranoid():  # sanitizer-build analog (GMS_TPU_PARANOID=1)
            checks.validate_padded(nbr, deg_full, n, name="PaddedGraph")
        return cls(torch.from_numpy(nbr).to(dev),
                   torch.from_numpy(deg_full).to(dev), n, g.num_edges)

    def rows(self, vids: torch.Tensor) -> torch.Tensor:
        """Gather neighbor rows for a batch of vertex ids: int32[B, D_pad]."""
        return self.nbr.index_select(0, vids)

    def degrees_of(self, vids: torch.Tensor) -> torch.Tensor:
        return self.deg.index_select(0, vids)
