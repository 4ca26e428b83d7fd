"""Compressed graph representations — the port of gms_tpu/graphs/compressed.py.

Role of the reference's Log(Graph) layer (gms/representations/graphs/):
  * Kbit_Adjacency_Array (log_graph/kbit_adjacency_array.h:17-60): neighbor
    ids packed at ceil(log2 n) bits, global width — `KbitGraph`, packed into
    32-bit lanes on the host, decoded on the device by `kbit_decode_rows`;
  * per-neighborhood local widths (`_Local` variants) — `KbitGraphBucketed`:
    rows grouped into width buckets {8, 16, 24, 32}, one packed array each;
  * varint byte- and word-based coders (coders/varint_byte_based_graph.h:
    9-70, varint_utils.h:26-115): host numpy codecs;
  * Bit_Tree_Graph's per-vertex encoding choice (log_graph/bit_tree_graph.h:
    26-50) — `HybridGraph`: per row, k-bit packing or a dense bitmap over the
    vertex space, whichever is smaller;
  * `KbitWeightedGraph`: ids and weights in two packed planes.

Packing stays on the host in numpy and gives gms_tpu's words word for word;
the packed words and degrees then move to `device` (default "cuda"). Words
are int32 tensors carrying the bits of gms_tpu's uint32 words.

One device program of gms_tpu is on this layer: `kbit_decode_rows` (:43),
the hand-written CUDA kernel K28 (csrc/kbit_decode.cu). Its wrapper runs
`kbit_decode_rows_plain` for CPU tensors, launches the kernel or raises for
CUDA tensors, and adds one to LAUNCHES["kbit_decode_rows"] per launch. All
decoders return SENTINEL-padded int32 rows, so compressed graphs are drop-in
inputs for every set kernel; `as_csr` decodes any form back to a host
CSRGraph (what `triangle_count` does with one).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gms_tpu_torch import _kernels
from gms_tpu_torch.device import resolve
from gms_tpu_torch.graphs.csr import CSRGraph
from gms_tpu_torch.graphs.tiles import PaddedGraph, SENTINEL, round_up

_SENT = int(SENTINEL)

# Kernel launches, counted only where the CUDA kernel launches.
LAUNCHES = {"kbit_decode_rows": 0}

# elements a plain version materialises at once
_PLAIN_BUDGET = 1 << 24


def reset_launches() -> None:
    LAUNCHES["kbit_decode_rows"] = 0


def _bits_for(n: int) -> int:
    return max(1, int(np.ceil(np.log2(max(n, 2)))))


def _pack_lanes(vals: np.ndarray, k: int) -> np.ndarray:
    """uint32[V, W] words holding vals[:, j] (each < 2^k) at bits
    [j k, j k + k) of each row, W = ceil(D k / 32): the words of gms_tpu's
    bitwise_or.at scatter. Lanes j with one phase j mod L (L = 32 /
    gcd(k, 32)) share the bit offset and never share a word, so each phase
    is one plain fancy-indexed OR."""
    V, D = vals.shape
    packed = np.zeros((V, round_up(D * k, 32) // 32), dtype=np.uint32)
    period = 32 // math.gcd(k, 32)
    for p in range(min(period, D)):
        cols = np.arange(p, D, period)
        s = (p * k) & 31
        w0 = (cols * k) >> 5
        part = vals[:, cols].astype(np.uint64)
        packed[:, w0] |= ((part << np.uint64(s))
                          & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        if s + k > 32:
            packed[:, w0 + 1] |= (part >> np.uint64(32 - s)).astype(np.uint32)
    return packed


def _words(a: np.ndarray, dev) -> torch.Tensor:
    """uint32 words as an int32 tensor on dev (same bits)."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)


# ---------------------------------------------------------------------------
# K28: k-bit row decode
# ---------------------------------------------------------------------------

def kbit_decode_rows_plain(packed, deg, vids, *, k: int, d_pad: int):
    """Plain version of kbit_decode_rows, in int64 (torch has no uint32
    shifts on the CPU), masked to 32 bits, rows a slice at a time."""
    V, W = packed.shape
    dev = packed.device
    j = torch.arange(d_pad, dtype=torch.int64, device=dev)
    bitpos = j * k
    w0i = bitpos >> 5
    w1i = (w0i + 1).clamp(max=W - 1)
    s = bitpos & 31
    mask = (1 << k) - 1
    out = torch.empty((vids.shape[0], d_pad), dtype=torch.int32, device=dev)
    step = max(1, _PLAIN_BUDGET // max(d_pad + W, 1))
    for b0 in range(0, vids.shape[0], step):
        v = vids[b0:b0 + step].long().clamp(0, V - 1)
        rows = packed[v].long() & 0xFFFFFFFF
        lo = rows[:, w0i] >> s
        hi = torch.where(s == 0, 0, (rows[:, w1i] << (32 - s)) & 0xFFFFFFFF)
        val = (lo | hi) & mask
        val = torch.where(val >= (1 << 31), val - (1 << 32), val)
        out[b0:b0 + step] = torch.where(j[None, :] < deg[v].long()[:, None],
                                        val, _SENT).to(torch.int32)
    return out


def kbit_decode_rows(packed, deg, vids, *, k: int, d_pad: int):
    """int32[B, d_pad] padded rows `vids` (clipped to [0, V_pad - 1]) of the
    k-bit packed words packed int32[V_pad, W] with degrees deg int32[V_pad];
    SENTINEL from deg on. Replaces gms_tpu's kbit_decode_rows
    (graphs/compressed.py:43)."""
    name = "kbit_decode_rows"
    _kernels.check_tensor(name, "packed", packed, 2)
    _kernels.check_tensor(name, "deg", deg, 1)
    _kernels.check_tensor(name, "vids", vids, 1)
    V, W = packed.shape
    if not 1 <= k <= 32:
        raise ValueError(f"{name}: k must be in [1, 32], got {k}")
    if deg.shape[0] != V or V == 0:
        raise ValueError(f"{name}: deg has {deg.shape[0]} entries for "
                         f"{V} packed rows (at least 1)")
    if d_pad < 0 or d_pad * k > 32 * W:
        raise ValueError(f"{name}: d_pad {d_pad} lanes of {k} bits do not "
                         f"fit {W} words")
    if not _kernels.on_cuda(name, packed, deg, vids):
        return kbit_decode_rows_plain(packed, deg, vids, k=k, d_pad=d_pad)
    out = torch.empty((vids.shape[0], d_pad), dtype=torch.int32,
                      device=packed.device)
    _kernels.launch("kbit_decode", "kbit_decode_rows", packed, V, W, deg,
                    vids, vids.shape[0], d_pad, k, out)
    LAUNCHES[name] += 1
    return out


# ---------------------------------------------------------------------------
# k-bit layouts
# ---------------------------------------------------------------------------

class KbitGraph:
    """Global-width k-bit packed adjacency (Kbit_Adjacency_Array role)."""

    def __init__(self, packed, deg, k: int, d_pad: int, num_nodes: int,
                 num_edges: int):
        self.packed = packed        # int32[V_pad, W] (uint32 words' bits)
        self.deg = deg              # int32[V_pad]
        self.k = k
        self.d_pad = d_pad
        self.num_nodes = num_nodes
        self.num_edges = num_edges

    @classmethod
    def from_csr(cls, g: CSRGraph, *, k: int | None = None,
                 device="cuda") -> "KbitGraph":
        dev = resolve(device)
        pg = PaddedGraph.from_csr(g, device="cpu")  # gms_tpu's padded rows
        nbr = pg.nbr.numpy()
        k = k or _bits_for(g.num_nodes)
        # padding packs as 0
        packed = _pack_lanes(np.where(nbr == SENTINEL, 0, nbr), k)
        return cls(_words(packed, dev), pg.deg.to(dev), k, nbr.shape[1],
                   g.num_nodes, g.num_edges)

    @property
    def nbr(self):
        """Materialized padded rows (for whole-graph kernels)."""
        return self.rows(torch.arange(self.packed.shape[0], dtype=torch.int32,
                                      device=self.packed.device))

    def rows(self, vids):
        return kbit_decode_rows(self.packed, self.deg, vids, k=self.k,
                                d_pad=self.d_pad)

    def bits_per_edge(self) -> float:
        return self.packed.numel() * 32 / max(self.num_edges, 1)


class KbitGraphBucketed:
    """Per-neighborhood local widths, bucketed ({8,16,24,32} bits) —
    the `_Local` variants' form."""

    BUCKETS = (8, 16, 24, 32)

    def __init__(self, parts, num_nodes: int, num_edges: int, v_pad: int):
        self.parts = parts          # {k: (KbitGraph, vids int32 numpy)}
        self.num_nodes = num_nodes
        self.num_edges = num_edges
        self.v_pad = v_pad

    @classmethod
    def from_csr(cls, g: CSRGraph, *, device="cuda") -> "KbitGraphBucketed":
        dev = resolve(device)
        # row's local width = bits of its max neighbor id; rows are sorted,
        # so the max is the last CSR entry of each non-empty row
        maxn = np.ones(g.num_nodes, dtype=np.int64)
        nz = g.degrees > 0
        if g.num_edges:
            maxn[nz] = g.indices[np.asarray(g.indptr[1:])[nz] - 1]
        kreq = np.ceil(np.log2(np.maximum(maxn + 1, 2))).astype(np.int64)
        parts = {}
        pg_vpad = round_up(max(g.num_nodes, 1), 8)
        for kb in cls.BUCKETS:
            sel = (kreq <= kb)
            for smaller in cls.BUCKETS:
                if smaller < kb:
                    sel &= kreq > smaller
            vids = np.nonzero(sel)[0].astype(np.int32)
            if not len(vids):
                continue
            sub = _induce_rows(g, vids)
            parts[kb] = (KbitGraph.from_csr(sub, k=kb, device=dev), vids)
        return cls(parts, g.num_nodes, g.num_edges, pg_vpad)

    def decode_all(self) -> np.ndarray:
        """int32[V_pad, D_pad] padded rows (host), for verification."""
        d_pad = max((p.d_pad for p, _ in self.parts.values()), default=1)
        out = np.full((self.v_pad, d_pad), SENTINEL, dtype=np.int32)
        for kb, (kg, vids) in self.parts.items():
            rows = kg.rows(torch.arange(len(vids), dtype=torch.int32,
                                        device=kg.packed.device))
            out[vids, : kg.d_pad] = rows.cpu().numpy()[: len(vids)]
        return out

    def bits_per_edge(self) -> float:
        total = sum(p.packed.numel() * 32 for p, _ in self.parts.values())
        return total / max(self.num_edges, 1)


def _gather_rows(g: CSRGraph, deg: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Bulk CSR row gather: new (indptr, indices) keeping deg[v] entries of
    each row (deg[v] in {0, degree(v)}) — one repeat + one fancy gather,
    no per-vertex Python loop."""
    deg = deg.astype(np.int64)
    indptr = np.zeros(len(deg) + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    total = int(indptr[-1])
    src_start = np.asarray(g.indptr[:-1], dtype=np.int64)
    pos = (np.repeat(src_start, deg)
           + np.arange(total, dtype=np.int64)
           - np.repeat(indptr[:-1], deg))
    return indptr, g.indices[pos].astype(np.int32)


def _induce_rows(g: CSRGraph, vids: np.ndarray) -> CSRGraph:
    """CSR containing only the rows of vids (compacted), ids unchanged."""
    deg = np.zeros(len(vids), dtype=np.int64)
    deg[:] = g.degrees[vids]
    sub_start = np.asarray(g.indptr[:-1], dtype=np.int64)[vids]
    indptr = np.zeros(len(vids) + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    total = int(indptr[-1])
    pos = (np.repeat(sub_start, deg)
           + np.arange(total, dtype=np.int64)
           - np.repeat(indptr[:-1], deg))
    return CSRGraph(indptr, g.indices[pos].astype(np.int32), directed=True)


class KbitWeightedGraph:
    """Weighted k-bit adjacency (Kbit_Weighted_Adjacency_Array role,
    gapbs/builder.h:440,488 csrToKbitWeighted*).

    Two packed planes sharing slot order: neighbor ids at ceil(log2 n) bits
    and weights at ceil(log2 (wmax+1)) bits, both decoded by K28."""

    def __init__(self, ids: KbitGraph, wplane, kw: int):
        self.ids = ids
        self.wplane = wplane      # int32[V_pad, Ww] (uint32 words' bits)
        self.kw = kw
        self.num_nodes = ids.num_nodes
        self.num_edges = ids.num_edges

    @classmethod
    def from_csr(cls, g: CSRGraph, weights: np.ndarray | None = None,
                 *, k: int | None = None,
                 device="cuda") -> "KbitWeightedGraph":
        dev = resolve(device)
        if weights is None:
            weights = (g.weights if g.weights is not None
                       else np.ones(g.num_edges, dtype=np.int32))
        ids = KbitGraph.from_csr(g, k=k, device=dev)
        kw = _bits_for(int(np.max(weights, initial=1)) + 1)
        # weight rows laid out like the padded adjacency, then packed
        V, D = ids.deg.shape[0], ids.d_pad
        wrows = np.zeros((V, D), dtype=np.uint64)
        deg = g.degrees.astype(np.int64)
        rows = np.repeat(np.arange(g.num_nodes), deg)
        offs = (np.arange(g.num_edges, dtype=np.int64)
                - np.repeat(np.asarray(g.indptr[:-1], dtype=np.int64), deg))
        wrows[rows, offs] = np.asarray(weights, dtype=np.uint64)
        return cls(ids, _words(_pack_lanes(wrows, kw), dev), kw)

    @property
    def nbr(self):
        return self.ids.nbr

    def weight_rows(self):
        """int32[V_pad, D_pad] per-slot weights (0 on padding)."""
        vids = torch.arange(self.wplane.shape[0], dtype=torch.int32,
                            device=self.wplane.device)
        w = kbit_decode_rows(self.wplane, self.ids.deg, vids, k=self.kw,
                             d_pad=self.ids.d_pad)
        return torch.where(w == _SENT, 0, w)  # pad slots -> weight 0

    def bits_per_edge(self) -> float:
        total = (self.ids.packed.numel() + self.wplane.numel()) * 32
        return total / max(self.num_edges, 1)


# ---------------------------------------------------------------------------
# varint (delta + continuation bytes) — host storage codec
# ---------------------------------------------------------------------------

def varint_encode_graph(g: CSRGraph) -> dict:
    """Delta + varint bytes per row (varint_byte_based_graph.h role).

    First value per row is the raw id; the rest are gaps-1 (rows are sorted
    strictly increasing after squish). Fully vectorized: per-token byte
    lengths, one cumsum for positions, one masked store per byte lane.
    """
    n = g.num_nodes
    m = int(g.num_edges)
    idx = g.indices.astype(np.int64)
    indptr = np.asarray(g.indptr, dtype=np.int64)
    starts = indptr[:-1][g.degrees > 0]          # first-token positions
    vals = np.empty(m, dtype=np.int64)
    if m:
        vals[1:] = idx[1:] - idx[:-1] - 1
        vals[starts] = idx[starts]
    # bytes per token: ceil(bit_length/7), min 1
    nb = np.ones(m, dtype=np.int64)
    v = vals >> 7
    while v.any():
        nb[v > 0] += 1
        v >>= 7
    cum = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(nb, out=cum[1:])
    payload = np.zeros(int(cum[-1]), dtype=np.uint8)
    for b in range(int(nb.max(initial=0))):
        sel = nb > b
        more = nb > b + 1
        payload[cum[:-1][sel] + b] = (
            ((vals[sel] >> (7 * b)) & 0x7F) | np.where(more[sel], 0x80, 0)
        ).astype(np.uint8)
    offsets = cum[indptr]
    return {"payload": payload.tobytes(), "offsets": offsets,
            "num_nodes": n, "directed": g.directed()}


def _decode_tokens(vals: np.ndarray, offsets: np.ndarray,
                   tok_of_unit: np.ndarray, directed: bool) -> CSRGraph:
    """CSRGraph from the token values of a varint payload: the first token
    of a row is raw, the rest are gap - 1."""
    indptr = tok_of_unit[offsets]
    m = int(indptr[-1])
    deg = np.diff(indptr)
    row_start = indptr[:-1][deg > 0]
    adj = vals + 1
    if m:
        adj[row_start] = vals[row_start]
    # segment prefix-sum: token t in row v decodes to
    # first + Σ(gap_i + 1) = csum[t] - (csum[start] - vals[start])
    csum = np.cumsum(adj)
    base = np.zeros(m, dtype=np.int64)
    if m:
        base[:] = np.repeat(csum[row_start] - vals[row_start], deg[deg > 0])
    indices = csum - base
    return CSRGraph(indptr, indices.astype(np.int32), directed=directed)


def _token_values(buf: np.ndarray, bits: int) -> tuple[np.ndarray, np.ndarray]:
    """(token values, token index of each unit boundary) of a payload of
    units (bytes or words) carrying `bits` payload bits and a top
    continuation bit."""
    cont = (buf >> bits) > 0
    ends = np.nonzero(~cont)[0]
    starts = np.concatenate([[0], ends[:-1] + 1])
    vals = np.zeros(len(ends), dtype=np.int64)
    width = ends - starts + 1
    low = (1 << bits) - 1
    for b in range(int(width.max(initial=0))):
        sel = width > b
        vals[sel] |= ((buf[starts[sel] + b] & low).astype(np.int64)
                      << (bits * b))
    tok_of_unit = np.zeros(len(buf) + 1, dtype=np.int64)
    tok_of_unit[ends + 1] = 1
    return vals, np.cumsum(tok_of_unit)


def varint_decode_graph(data: dict) -> CSRGraph:
    buf = np.frombuffer(data["payload"], dtype=np.uint8)
    vals, tok = _token_values(buf, 7)
    return _decode_tokens(vals, data["offsets"], tok, data["directed"])


def varint_encode_graph_words(g: CSRGraph) -> dict:
    """WORD-packed delta varint (VarintWordBasedGraph role, builder.h
    csrToVarintWordBased:656): each token is a run of uint32 words carrying
    31 payload bits plus an MSB continuation bit. Same delta scheme as
    `varint_encode_graph` (first token per row raw, rest gap-1)."""
    n = g.num_nodes
    m = int(g.num_edges)
    idx = g.indices.astype(np.int64)
    indptr = np.asarray(g.indptr, dtype=np.int64)
    starts = indptr[:-1][g.degrees > 0]
    vals = np.empty(m, dtype=np.int64)
    if m:
        vals[1:] = idx[1:] - idx[:-1] - 1
        vals[starts] = idx[starts]
    nw = np.ones(m, dtype=np.int64)
    v = vals >> 31
    while v.any():
        nw[v > 0] += 1
        v >>= 31
    cum = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(nw, out=cum[1:])
    payload = np.zeros(int(cum[-1]), dtype=np.uint32)
    for w in range(int(nw.max(initial=0))):
        sel = nw > w
        more = nw > w + 1
        payload[cum[:-1][sel] + w] = (
            ((vals[sel] >> (31 * w)) & 0x7FFFFFFF)
            | np.where(more[sel], np.int64(1) << 31, 0)
        ).astype(np.uint32)
    offsets = cum[indptr]
    return {"payload": payload.tobytes(), "offsets": offsets,
            "num_nodes": n, "directed": g.directed(), "word": True}


def varint_decode_graph_words(data: dict) -> CSRGraph:
    buf = np.frombuffer(data["payload"], dtype=np.uint32)
    vals, tok = _token_values(buf, 31)
    return _decode_tokens(vals, data["offsets"], tok, data["directed"])


# ---------------------------------------------------------------------------
# hybrid per-row representation (Bit_Tree_Graph role)
# ---------------------------------------------------------------------------

class HybridGraph:
    """Per-row k-bit vs dense-bitmap choice by footprint
    (bit_tree_graph.h:26-50 Offset_Or_Address role)."""

    def __init__(self, kbit: KbitGraph, bitmap_rows, bitmap_vids,
                 num_nodes: int, num_edges: int):
        self.kbit = kbit
        self.bitmap_rows = bitmap_rows    # int32[Nb, V_words]
        self.bitmap_vids = bitmap_vids    # int32[Nb]
        self.num_nodes = num_nodes
        self.num_edges = num_edges

    @classmethod
    def from_csr(cls, g: CSRGraph, *, device="cuda") -> "HybridGraph":
        dev = resolve(device)
        k = _bits_for(g.num_nodes)
        vwords = round_up(max(g.num_nodes, 32), 32) // 32
        deg = g.degrees
        # bitmap wins when deg * k > V bits
        use_bitmap = deg.astype(np.int64) * k > 32 * vwords
        bm_vids = np.nonzero(use_bitmap)[0].astype(np.int32)
        bm = np.zeros((len(bm_vids), vwords), dtype=np.uint32)
        for i, v in enumerate(bm_vids):
            row = g.out_neigh(int(v))
            np.bitwise_or.at(bm[i], row >> 5,
                             (np.uint32(1) << (row.astype(np.uint32) & 31)))
        # k-bit part stores non-bitmap rows (bitmap rows truncated to empty)
        g2 = _mask_rows(g, bm_vids)
        return cls(KbitGraph.from_csr(g2, k=k, device=dev), _words(bm, dev),
                   torch.from_numpy(bm_vids).to(dev), g.num_nodes,
                   g.num_edges)

    def decode_all(self) -> np.ndarray:
        from gms_tpu_torch.sets.bitmap_ops import cardinality, to_ids

        kb = self.kbit.nbr.cpu().numpy()
        width = kb.shape[1]
        if len(self.bitmap_vids):
            bm_deg = int(cardinality(self.bitmap_rows).max())
            width = max(width, round_up(max(bm_deg, 1), 128))
        out = np.full((kb.shape[0], width), SENTINEL, dtype=np.int32)
        out[:, : kb.shape[1]] = kb
        if len(self.bitmap_vids):
            w = min(width, self.bitmap_rows.shape[1] * 32)
            ids = to_ids(self.bitmap_rows, w).cpu().numpy()
            out[self.bitmap_vids.cpu().numpy(), :w] = ids
        return out

    def bits_per_edge(self) -> float:
        total = (self.kbit.packed.numel() + self.bitmap_rows.numel()) * 32
        return total / max(self.num_edges, 1)


def as_csr(rep) -> CSRGraph:
    """Decode any compressed representation back to a host CSRGraph.

    Bridge for algorithms whose preparation is host-side (the tiered
    TrianglePlan): the compressed form is the storage/footprint option
    (log_graph converter.cc role).
    """
    if isinstance(rep, CSRGraph):
        return rep
    if isinstance(rep, KbitGraph):
        rows = rep.nbr.cpu().numpy()[: rep.num_nodes]
    elif isinstance(rep, (KbitGraphBucketed, HybridGraph)):
        rows = rep.decode_all()[: rep.num_nodes]
    else:
        raise TypeError(f"unsupported representation: {type(rep)!r}")
    sent = np.int32(SENTINEL)
    deg = (rows != sent).sum(axis=1)
    indptr = np.zeros(rep.num_nodes + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(deg)
    indices = rows[rows != sent].astype(np.int32)
    return CSRGraph(indptr, indices, directed=False)


def _mask_rows(g: CSRGraph, vids: np.ndarray) -> CSRGraph:
    """CSR with the rows of vids emptied (bulk gather, no Python loop)."""
    deg = g.degrees.astype(np.int64).copy()
    deg[vids] = 0
    indptr, indices = _gather_rows(g, deg)
    return CSRGraph(indptr, indices, directed=True)
