"""Graph file readers.

Covers GAPBS `Reader` (reference gms/third_party/gapbs/reader.h:220-268):
formats .el (edge list), .wel (weighted edge list), .mtx (MatrixMarket),
.graph (METIS), .gr (DIMACS9), plus a binary serialized format. The
reference's .sg/.wsg binary (reader.h:252-305, writer.h) is replaced by a
numpy .npz container (`save_npz` / `load_npz`) — same role: skip re-parsing.

Parsing is vectorized (np.loadtxt / frombuffer), not line-by-line. This is
gms_tpu/io/readers.py without its optional C++ edge-list parser
(gms_tpu/native/); the numpy parse gives the same arrays.
"""

from __future__ import annotations

import gzip
import io as _io
import os

import numpy as np

from gms_tpu_torch.graphs.csr import CSRGraph
from gms_tpu_torch.io.builder import build_csr


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def _load_int_pairs(path: str, comments: str = "#%") -> np.ndarray:
    with _open(path) as f:
        text = f.read()
    lines = [ln for ln in text.splitlines() if ln and ln.lstrip()[:1] not in set(comments)]
    if not lines:
        return np.zeros((0, 2), dtype=np.int64)
    data = np.loadtxt(_io.StringIO("\n".join(lines)), dtype=np.float64, ndmin=2)
    return data[:, :2].astype(np.int64)


def read_el(path: str, *, symmetrize: bool = True) -> CSRGraph:
    """Edge-list file: one `u v` pair per line (reader.h ReadInEL)."""
    return build_csr(_load_int_pairs(path), symmetrize=symmetrize)


def read_wel(path: str, *, symmetrize: bool = True) -> CSRGraph:
    """Weighted edge list `u v w` (reader.h ReadInWEL): weights preserved on
    the CSR (used by SSSP); set-based mining ignores them as in the
    reference."""
    from gms_tpu_torch.io.builder import build_csr_weighted

    with _open(path) as f:
        text = f.read()
    rows = [ln.split() for ln in text.splitlines()
            if ln and ln.lstrip()[:1] not in "#%"]
    if not rows:
        return build_csr(np.zeros((0, 2), dtype=np.int64),
                         symmetrize=symmetrize)
    data = np.asarray([[float(r[0]), float(r[1]),
                        float(r[2]) if len(r) > 2 else 1.0] for r in rows])
    return build_csr_weighted(data[:, :2].astype(np.int64),
                              data[:, 2].astype(np.int64),
                              symmetrize=symmetrize)


def read_mtx(path: str, *, symmetrize: bool = True) -> CSRGraph:
    """MatrixMarket coordinate format; 1-indexed (reader.h ReadInMTX :136-177)."""
    with _open(path) as f:
        header = f.readline()
        sym_file = "symmetric" in header
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        # `line` is the size line: rows cols nnz
        rows, cols, _nnz = (int(x) for x in line.split()[:3])
        body = f.read()
    data = np.loadtxt(_io.StringIO(body), dtype=np.float64, ndmin=2)
    edges = data[:, :2].astype(np.int64) - 1  # 1-indexed -> 0-indexed
    n = max(rows, cols)
    return build_csr(edges, num_nodes=n, symmetrize=symmetrize or sym_file)


def read_metis(path: str) -> CSRGraph:
    """METIS .graph: line i+1 lists neighbors of vertex i, 1-indexed
    (reader.h ReadInMetis :179-218)."""
    with _open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln and not ln.startswith("%")]
    n, _m = (int(x) for x in lines[0].split()[:2])
    src, dst = [], []
    for v, ln in enumerate(lines[1 : n + 1]):
        for tok in ln.split():
            src.append(v)
            dst.append(int(tok) - 1)
    edges = np.stack(
        [np.asarray(src, dtype=np.int64), np.asarray(dst, dtype=np.int64)], axis=1
    ) if src else np.zeros((0, 2), dtype=np.int64)
    return build_csr(edges, num_nodes=n, symmetrize=True)


def read_gr(path: str, *, symmetrize: bool = True) -> CSRGraph:
    """DIMACS9 .gr: `a u v w` arc lines, 1-indexed (reader.h ReadInGR :96-134)."""
    src, dst = [], []
    n = 0
    with _open(path) as f:
        for ln in f:
            if ln.startswith("p"):
                n = int(ln.split()[2])
            elif ln.startswith("a"):
                parts = ln.split()
                src.append(int(parts[1]) - 1)
                dst.append(int(parts[2]) - 1)
    edges = np.stack(
        [np.asarray(src, dtype=np.int64), np.asarray(dst, dtype=np.int64)], axis=1
    ) if src else np.zeros((0, 2), dtype=np.int64)
    return build_csr(edges, num_nodes=n or None, symmetrize=symmetrize)


def read_sg(path: str) -> CSRGraph:
    """Reference-compatible binary serialized graph (reader.h:252-305).

    Layout: [bool directed][int64 num_edges][int64 num_nodes]
    [(n+1) int64 offsets][num_edges int32 neighbors]
    [if directed: inverse offsets + neighbors] — the inverse CSR is
    skipped on load (this framework derives transposes on demand).
    """
    weighted = path.endswith(".wsg")
    with open(path, "rb") as f:
        directed = bool(np.frombuffer(f.read(1), dtype=np.uint8)[0])
        num_edges = int(np.frombuffer(f.read(8), dtype=np.int64)[0])
        num_nodes = int(np.frombuffer(f.read(8), dtype=np.int64)[0])
        indptr = np.frombuffer(f.read(8 * (num_nodes + 1)), dtype=np.int64)
        if weighted:
            pairs = np.frombuffer(f.read(8 * num_edges), dtype=np.int32)
            indices, weights = pairs[0::2].copy(), pairs[1::2].copy()
        else:
            indices = np.frombuffer(f.read(4 * num_edges), dtype=np.int32)
            weights = None
    return CSRGraph(indptr, indices, directed=directed, weights=weights)


read_wsg = read_sg


def save_npz(g: CSRGraph, path: str) -> None:
    """Binary serialized graph — role of .sg (gapbs/writer.h)."""
    payload = dict(indptr=g.indptr, indices=g.indices,
                   directed=np.array(g.directed()))
    if g.weights is not None:
        payload["weights"] = g.weights
    np.savez_compressed(path, **payload)


def load_npz(path: str) -> CSRGraph:
    with np.load(path) as z:
        return CSRGraph(z["indptr"], z["indices"], directed=bool(z["directed"]),
                        weights=z["weights"] if "weights" in z.files else None)


_READERS = {
    ".el": read_el,
    ".wel": read_wel,
    ".mtx": read_mtx,
    ".graph": read_metis,
    ".gr": read_gr,
    ".npz": lambda p, **kw: load_npz(p),
    ".sg": lambda p, **kw: read_sg(p),
    ".wsg": lambda p, **kw: read_sg(p),
}


def read_graph(path: str, *, symmetrize: bool = True) -> CSRGraph:
    """Dispatch on extension (reader.h ReadFile :220-250)."""
    base = path[:-3] if path.endswith(".gz") else path
    ext = os.path.splitext(base)[1]
    if ext not in _READERS:
        raise ValueError(f"unsupported graph format: {ext!r} ({path})")
    reader = _READERS[ext]
    if ext in (".graph", ".npz", ".sg", ".wsg"):
        return reader(path)
    return reader(path, symmetrize=symmetrize)
