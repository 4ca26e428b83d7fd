"""Bitmap-tile graph layout — the port of gms_tpu/graphs/bitmap.py.

Role of `SetGraph<RoaringSet>` (reference gms/representations/sets/roaring_set.h
:15-234 over CRoaring): neighborhoods as bitmaps, intersection = word-AND +
popcount. An uncompressed rectangular bitmap

    words : int32[V_pad, W_pad]   bit j of word w of row v set iff edge v->(32w+j)

with the bits of gms_tpu's uint32 words. Memory is V²/8 bytes, so the layout
is for moderate V; its whole-graph consumer is
algorithms/triangle_count.py:triangle_count_dense. It is built in numpy with
gms_tpu's lane and sublane padding, so `words` equals gms_tpu's bit for bit,
then moves to the requested device.
"""

from __future__ import annotations

import numpy as np
import torch

from gms_tpu_torch.device import resolve
from gms_tpu_torch.graphs.tiles import round_up


class BitmapGraph:
    def __init__(self, words: torch.Tensor, num_nodes: int, num_edges: int):
        self.words = words  # int32[V_pad, W_pad]
        self.num_nodes = int(num_nodes)
        self.num_edges = int(num_edges)

    @property
    def v_pad(self) -> int:
        return self.words.shape[0]

    @property
    def w_pad(self) -> int:
        return self.words.shape[1]

    @classmethod
    def from_csr(cls, g, *, device="cuda", lane: int = 128,
                 sublane: int = 8) -> "BitmapGraph":
        dev = resolve(device)
        n = g.num_nodes
        W = round_up(max((n + 31) // 32, 1), lane)
        V = round_up(max(n, 1), sublane)
        words = np.zeros((V, W), dtype=np.uint32)
        if g.num_edges:
            rows = np.repeat(np.arange(n), g.degrees.astype(np.int64))
            cols = g.indices.astype(np.int64)
            np.bitwise_or.at(words, (rows, cols >> 5),
                             np.uint32(1) << (cols & 31).astype(np.uint32))
        return cls(torch.from_numpy(words.view(np.int32)).to(dev), n,
                   g.num_edges)

    def rows(self, vids: torch.Tensor) -> torch.Tensor:
        return self.words.index_select(0, vids)
