"""Subgraph isomorphism (VF2) — the port of gms_tpu/algorithms/subgraph_iso.py.

Role of gms/algorithms/non_set_based/subgraphiso/ (vf2/util/vf2State.hpp,
candidateGeneration.hpp, feasibilityRules.hpp; the find-first solver
vf2/sequential/vf2.hpp:40-83, the parallel one vf2/parallel/vf2.hpp:40-106;
verification util/subgraphiso_verification.hpp:11-60).

The search, as in gms_tpu: a partial mapping is an item int32[P] (target ids
of the pattern positions 0..d-1 in a connected search order: max degree
first, then most placed neighbours). Level d takes a slice of items M[N, P],
gathers each item's candidates (the padded row of its first mapped
pattern-neighbour, or blocks of all vertex ids for a disconnected pattern),
masks them (`feasible`) and compacts the children (`emit`). Slices live on a
LIFO stack, root chunks pushed reversed, so limit=1 expands depth-first from
the lowest root and returns gms_tpu's first mapping; a slice is cut to
rows_max = _bucket(item_budget // Dc) items, and a level's output keeps the
bucketed capacity cap = _bucket(#children), dead rows -1.

Two device programs of gms_tpu carry a level; each is a hand-written CUDA
kernel here (csrc/), wrapped by the function named:

    feasible   csrc/vf2_feasible.cu   K26 (_feasible, :81)
    emit       csrc/vf2_emit.cu       K27 (_emit, :128)

Each wrapper checks device, dtype, shape and contiguity; for CPU tensors it
runs its `*_plain` PyTorch version, for CUDA tensors it launches the kernel
(raising if the launch fails) and adds one to LAUNCHES["vf2_feasible"] or
LAUNCHES["vf2_emit"]. `feasible` also
returns the mask's count (int64), so a level reads back 8 bytes. The host
pre-pass `_host_find_first` (hybrid mode, host_budget > 0) and the oracle are
gms_tpu's host code, copied.
"""

from __future__ import annotations

import numpy as np
import torch

from gms_tpu_torch import _kernels
from gms_tpu_torch.algorithms.k_clique import _bucket
from gms_tpu_torch.device import resolve
from gms_tpu_torch.graphs.csr import CSRGraph
from gms_tpu_torch.graphs.tiles import PaddedGraph, SENTINEL

_SENT = int(SENTINEL)

# Kernel launches, counted only where the CUDA kernel launches.
LAUNCHES = {"vf2_feasible": 0, "vf2_emit": 0}

# pattern positions a parents / nonparents bit mask holds
MAX_PATTERN = 64

# elements a plain version materialises at once
_PLAIN_BUDGET = 1 << 24

# head-to-head pattern set of bench.py's vf2 round and
# scripts/measure_reference.py (gms_tpu subgraph_iso.py:44)
VF2_PATTERNS = {
    "k4": ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)),
    "p4": ((0, 1), (1, 2), (2, 3)),
    "c5": ((0, 1), (1, 2), (2, 3), (3, 4), (4, 0)),
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _search_order(pattern: CSRGraph):
    """Connected search order + per-position (parents, nonparents)."""
    P = pattern.num_nodes
    deg = pattern.degrees
    placed: list[int] = []
    remaining = set(range(P))
    adj = [set(pattern.out_neigh(v).tolist()) for v in range(P)]
    while remaining:
        if not placed:
            nxt = max(remaining, key=lambda v: (deg[v], -v))
        else:
            nxt = max(
                remaining,
                key=lambda v: (sum(1 for u in placed if u in adj[v]), deg[v], -v),
            )
        placed.append(nxt)
        remaining.discard(nxt)
    pos_of = {v: i for i, v in enumerate(placed)}
    parents, nonparents = [], []
    for i, v in enumerate(placed):
        ps = tuple(sorted(pos_of[u] for u in adj[v] if pos_of[u] < i))
        nps = tuple(j for j in range(i) if j not in ps)
        parents.append(ps)
        nonparents.append(nps)
    return placed, parents, nonparents


def _mask(positions) -> int:
    return sum(1 << p for p in positions)


# ---------------------------------------------------------------------------
# K26: the candidate mask
# ---------------------------------------------------------------------------

def _member_plain(nbr, a, c):
    """bool: c in the padded row clip(a) of nbr — gms_tpu's searchsorted
    (left) in the row, the index clamped to its last slot."""
    rows = nbr[a.long().clamp(0, nbr.shape[0] - 1)]
    idx = torch.searchsorted(rows, c).clamp(max=nbr.shape[1] - 1)
    return torch.gather(rows, 1, idx) == c


def _probe_plain(bmp, a, c):
    """bool: bit c of bitmap row a, c clipped to the row's bits and a to the
    rows (gms_tpu's one word probe)."""
    V, vw = bmp.shape
    q = c.long().clamp(0, 32 * vw - 1)
    r = a.long().clamp(0, V - 1)
    w = bmp.reshape(-1)[r[:, None] * vw + (q >> 5)].long()
    return ((w >> (q & 31)) & 1) == 1


def feasible_plain(M, cand, nbr, deg1, bmp, pdeg_d: int, *, d: int,
                   parents, nonparents, induced: bool):
    """Plain version of feasible: gms_tpu's mask, items a slice at a time."""
    N, Dc = cand.shape
    ok = torch.empty((N, Dc), dtype=torch.bool, device=cand.device)
    use_bmp = bmp.shape[0] > 1
    step = max(1, _PLAIN_BUDGET // max(Dc + nbr.shape[1], 1))
    for s in range(0, N, step):
        m, c = M[s:s + step], cand[s:s + step]
        o = (c != _SENT) & (m[:, 0] >= 0)[:, None]
        o &= deg1[c.long().clamp(0, deg1.shape[0] - 1)] >= pdeg_d
        for j in range(d):
            o &= c != m[:, j][:, None]

        def adj(p):
            if use_bmp:
                return _probe_plain(bmp, m[:, p], c)
            return _member_plain(nbr, m[:, p], c)
        for p in parents:
            o &= adj(p)
        if induced:
            for p in nonparents:
                o &= ~adj(p)
        ok[s:s + step] = o
    return ok, ok.sum(dtype=torch.int64).reshape(1)


def feasible(M, cand, nbr, deg1, bmp, pdeg_d: int, *, d: int, parents,
             nonparents, induced: bool):
    """(ok bool[N, Dc], count int64[1]): candidate cand[n, i] extends mapping
    M[n] (int32[N, P]) at position d. nbr int32[V_pad, D_pad] padded rows,
    deg1 int32[V_pad + 1] (degrees and a trailing 0), bmp int32[V, vw] the
    id-space bitmap or a [1, 1] dummy (then adjacency is a binary search in
    nbr's sorted rows), pdeg_d the pattern degree at d; parents and
    nonparents: positions < d. Replaces gms_tpu's _feasible
    (subgraph_iso.py:81)."""
    name = "vf2_feasible"
    _kernels.check_tensor(name, "M", M, 2)
    _kernels.check_tensor(name, "cand", cand, 2)
    _kernels.check_tensor(name, "nbr", nbr, 2)
    _kernels.check_tensor(name, "deg1", deg1, 1)
    _kernels.check_tensor(name, "bmp", bmp, 2)
    N, P = M.shape
    if cand.shape[0] != N:
        raise ValueError(f"{name}: cand has {cand.shape[0]} rows for {N} "
                         f"items")
    if not 0 < d < P or P > MAX_PATTERN:
        raise ValueError(f"{name}: level d={d} of a {P}-vertex pattern "
                         f"(1 <= d < P <= {MAX_PATTERN})")
    if any(not 0 <= p < d for p in (*parents, *nonparents)):
        raise ValueError(f"{name}: parents {parents} and nonparents "
                         f"{nonparents} must lie in [0, {d})")
    if nbr.shape[0] == 0 or nbr.shape[1] == 0 or deg1.shape[0] == 0:
        raise ValueError(f"{name}: empty nbr or deg1")
    if not _kernels.on_cuda(name, M, cand, nbr, deg1, bmp):
        return feasible_plain(M, cand, nbr, deg1, bmp, pdeg_d, d=d,
                              parents=parents, nonparents=nonparents,
                              induced=induced)
    Dc = cand.shape[1]
    ok = torch.empty((N, Dc), dtype=torch.bool, device=M.device)
    count = torch.zeros(1, dtype=torch.int64, device=M.device)
    use_bmp = bmp.shape[0] > 1
    _kernels.launch("vf2_feasible", "vf2_feasible", M, P, cand, N, Dc, nbr,
                    nbr.shape[0], nbr.shape[1], deg1, deg1.shape[0],
                    bmp if use_bmp else None, bmp.shape[0], bmp.shape[1],
                    int(pdeg_d), d, _mask(parents), _mask(nonparents),
                    int(bool(induced)), ok, count)
    LAUNCHES[name] += 1
    return ok, count


# ---------------------------------------------------------------------------
# K27: child compaction
# ---------------------------------------------------------------------------

def emit_plain(M, cand, ok, *, d: int, cap: int):
    """Plain version of emit: nonzero (item-major) and a gather."""
    N, P = M.shape
    out = torch.full((cap, P), -1, dtype=torch.int32, device=M.device)
    n, i = torch.nonzero(ok, as_tuple=True)
    n_out = n.shape[0]
    n, i = n[:cap], i[:cap]
    rows = M[n].clone()
    rows[:, d] = cand[n, i]
    out[:n.shape[0]] = rows
    return out, torch.tensor([n_out], dtype=torch.int64, device=M.device)


def emit(M, cand, ok, *, d: int, cap: int):
    """(int32[cap, P], n_out int64[1]): the children of (M, cand, ok) in
    item-major order — M's row with column d := the candidate — then rows of
    -1; children past cap are dropped. Replaces gms_tpu's _emit
    (subgraph_iso.py:128)."""
    name = "vf2_emit"
    _kernels.check_tensor(name, "M", M, 2)
    _kernels.check_tensor(name, "cand", cand, 2)
    _kernels.check_tensor(name, "ok", ok, 2, torch.bool)
    N, P = M.shape
    if cand.shape != ok.shape or cand.shape[0] != N:
        raise ValueError(f"{name}: cand {tuple(cand.shape)} and ok "
                         f"{tuple(ok.shape)} do not match {N} items")
    if not 0 <= d < P or cap < 0:
        raise ValueError(f"{name}: d={d} of P={P}, cap={cap}")
    if not _kernels.on_cuda(name, M, cand, ok):
        return emit_plain(M, cand, ok, d=d, cap=cap)
    out = torch.empty((cap, P), dtype=torch.int32, device=M.device)
    cnt = torch.zeros(N, dtype=torch.int64, device=M.device)
    n_out = torch.empty(1, dtype=torch.int64, device=M.device)
    _kernels.launch("vf2_emit", "vf2_emit", M, P, cand, ok, N, cand.shape[1],
                    d, cap, cnt, out, n_out)
    LAUNCHES[name] += 1
    return out, n_out


def _level(M, cand, nbr, deg1, bmp, d, parents, nonparents, pdeg_d,
           induced):
    ok, count = feasible(M, cand, nbr, deg1, bmp, pdeg_d, d=d,
                         parents=parents, nonparents=nonparents,
                         induced=induced)
    nc = int(count.item())
    if nc == 0:
        return M.new_zeros((0, M.shape[1]))
    # keep the bucketed capacity (dead rows are -1 and inert)
    return emit(M, cand, ok, d=d, cap=_bucket(nc))[0]


# ---------------------------------------------------------------------------
# host pre-pass, entry point, verification, oracle
# ---------------------------------------------------------------------------

def _host_find_first(g: CSRGraph, order, parents, nonparents, pdeg, *,
                     induced: bool, budget: int):
    """Budgeted host DFS find-first, for instances a few thousand
    feasibility checks resolve. Returns (mapping int32[P] in position space
    | None, budget_exhausted); budget_exhausted=True hands the instance to
    the device search."""
    indptr = g.indptr
    indices = g.indices
    deg = g.degrees
    P = len(order)

    def row(v):
        return indices[indptr[v]:indptr[v + 1]]

    def is_nbr(a, c):
        r = row(a)
        i = np.searchsorted(r, c)
        return i < len(r) and r[i] == c

    mapping = np.full(P, -1, np.int64)
    cand_lists: list = [np.nonzero(deg >= pdeg[0])[0]] + [None] * (P - 1)
    pos = [0] * P
    steps = 0
    d = 0
    while d >= 0:
        lst = cand_lists[d]
        advanced = False
        while pos[d] < len(lst):
            c = int(lst[pos[d]])
            pos[d] += 1
            steps += 1
            if steps > budget:
                return None, True
            if deg[c] < pdeg[d]:
                continue
            if (mapping[:d] == c).any():
                continue
            if not all(is_nbr(int(mapping[p]), c) for p in parents[d]):
                continue
            if induced and any(is_nbr(int(mapping[p]), c)
                               for p in nonparents[d]):
                continue
            mapping[d] = c
            if d == P - 1:
                return mapping.astype(np.int32), False
            d += 1
            cand_lists[d] = (row(int(mapping[parents[d][0]]))
                             if parents[d]
                             else np.arange(g.num_nodes, dtype=np.int64))
            pos[d] = 0
            advanced = True
            break
        if not advanced:
            mapping[d] = -1
            d -= 1
    return None, False  # search space exhausted: no mapping exists


def _id_bitmap(g: CSRGraph, dev) -> torch.Tensor:
    """gms_tpu's id-space bitmap adjacency int32[V, ceil(V/32)] when it
    takes at most 1 GB, else a [1, 1] dummy (binary-search adjacency)."""
    vw = (g.num_nodes + 31) // 32
    if g.num_nodes * vw * 4 > (1 << 30):
        return torch.zeros((1, 1), dtype=torch.int32, device=dev)
    bmp = np.zeros((max(g.num_nodes, 1), vw), np.uint32)
    uu = np.repeat(np.arange(g.num_nodes, dtype=np.int64),
                   g.degrees.astype(np.int64))
    vv = g.indices.astype(np.int64)
    np.bitwise_or.at(bmp, (uu, vv >> 5),
                     np.uint32(1) << (vv & 31).astype(np.uint32))
    return torch.from_numpy(bmp.view(np.int32)).to(dev)


def subgraph_isomorphism(
    g: CSRGraph,
    pattern: CSRGraph,
    *,
    induced: bool = False,
    limit: int | None = 1,
    root_chunk: int = 4096,
    item_budget: int = 1 << 18,
    host_budget: int = 200_000,
    device="cuda",
) -> np.ndarray:
    """Find mappings of `pattern` into `g`.

    Returns int32[k, P]: row r maps pattern vertex j -> result[r, j].
    limit=1 is the reference's find-first (vf2.hpp:53-83), gms_tpu's first
    mapping; limit=None enumerates all. host_budget > 0 with limit=1 first
    runs the budgeted host DFS (hybrid mode), which launches nothing when it
    resolves the instance; host_budget=0 is the device search alone.
    """
    dev = resolve(device)
    P = pattern.num_nodes
    if P == 0 or g.num_nodes < P:
        return np.zeros((0, P), np.int32)
    if P > MAX_PATTERN:
        raise ValueError(f"subgraph_isomorphism: pattern of {P} vertices "
                         f"(at most {MAX_PATTERN})")
    order, parents, nonparents = _search_order(pattern)
    pdeg = pattern.degrees[order]
    col_order = np.asarray(order)
    if limit == 1 and host_budget > 0:
        m, exhausted = _host_find_first(
            g, order, parents, nonparents, pdeg,
            induced=induced, budget=host_budget)
        if m is not None:
            out = np.empty((1, P), np.int32)
            out[0, col_order] = m
            return out
        if not exhausted:
            return np.zeros((0, P), np.int32)
    pg = PaddedGraph.from_csr(g, device=dev)
    deg1 = torch.cat([pg.deg, pg.deg.new_zeros(1)])
    nbr = pg.nbr
    bmp = _id_bitmap(g, dev)

    roots = np.nonzero(g.degrees >= pdeg[0])[0].astype(np.int32)
    found: list[np.ndarray] = []
    total = 0
    # LIFO stack of (partial-mapping slice, next level d); root chunks pushed
    # reversed so low root ids expand first (deterministic find-first order)
    stack: list[tuple] = []
    for start in reversed(range(0, len(roots), root_chunk)):
        chunk = roots[start : start + root_chunk]
        M0 = np.full((len(chunk), P), -1, np.int32)
        M0[:, 0] = chunk
        stack.append((torch.from_numpy(M0).to(dev), 1))

    while stack:
        M, d = stack.pop()
        if d == P:
            full = M.cpu().numpy()
            full = full[(full >= 0).all(axis=1)]
            if len(full):
                out = np.empty_like(full)
                out[:, col_order] = full  # positions -> pattern-vertex cols
                found.append(out)
                total += len(full)
                if limit is not None and total >= limit:
                    break
            continue
        # slice the input so this level's emit buffer stays <= ~item_budget
        Dc = nbr.shape[1] if parents[d] else max(256, nbr.shape[1])
        rows_max = _bucket(max(1, item_budget // max(Dc, 1)))
        if M.shape[0] > rows_max:
            for s0 in reversed(range(0, M.shape[0], rows_max)):
                stack.append((M[s0 : s0 + rows_max], d))
            continue
        if parents[d]:
            anchor = M[:, parents[d][0]].long().clamp(0, nbr.shape[0] - 1)
            cand = nbr.index_select(0, anchor)
            out = _level(M, cand, nbr, deg1, bmp, d, parents[d],
                         nonparents[d], int(pdeg[d]), induced)
            if out.shape[0]:
                stack.append((out, d + 1))
        else:
            # disconnected pattern: candidates = all vertices, blockwise
            V = g.num_nodes
            blk = max(256, nbr.shape[1])
            for b0 in reversed(range(0, V, blk)):
                ids_pad = np.full(blk, SENTINEL, np.int32)
                ids = np.arange(b0, min(b0 + blk, V), dtype=np.int32)
                ids_pad[: len(ids)] = ids
                cand = (torch.from_numpy(ids_pad).to(dev)
                        .expand(M.shape[0], blk).contiguous())
                out = _level(M, cand, nbr, deg1, bmp, d, parents[d],
                             nonparents[d], int(pdeg[d]), induced)
                if out.shape[0]:
                    stack.append((out, d + 1))
    if not found:
        return np.zeros((0, P), np.int32)
    res = np.concatenate(found, axis=0)
    return res[:limit] if limit is not None else res


def verify_mapping(
    g: CSRGraph, pattern: CSRGraph, mapping: np.ndarray, *, induced: bool = False
) -> bool:
    """Edge-set check (subgraphiso_verification.hpp:11-60): induced ->
    mapped target edges == pattern edges; else pattern ⊆ target."""
    mapping = np.asarray(mapping)
    if len(set(mapping.tolist())) != len(mapping):
        return False
    tadj = [set(g.out_neigh(v).tolist()) for v in range(g.num_nodes)]
    for a in range(pattern.num_nodes):
        pa = set(pattern.out_neigh(a).tolist())
        for b in range(pattern.num_nodes):
            if a == b:
                continue
            has_p = b in pa
            has_t = int(mapping[b]) in tadj[int(mapping[a])]
            if has_p and not has_t:
                return False
            if induced and has_t and not has_p:
                return False
    return True


def subgraph_isomorphism_oracle(
    g: CSRGraph, pattern: CSRGraph, *, induced: bool = False
) -> list[tuple]:
    """All mappings pattern->g as tuples (target id per pattern vertex):
    plain recursive backtracking, independent of the device path."""
    P = pattern.num_nodes
    tadj = [set(g.out_neigh(v).tolist()) for v in range(g.num_nodes)]
    padj = [set(pattern.out_neigh(v).tolist()) for v in range(P)]
    out = []

    def rec(mapping: dict):
        if len(mapping) == P:
            out.append(tuple(mapping[j] for j in range(P)))
            return
        a = len(mapping)
        for c in range(g.num_nodes):
            if c in mapping.values():
                continue
            ok = True
            for b, t in mapping.items():
                has_p = b in padj[a]
                has_t = t in tadj[c]
                if has_p and not has_t:
                    ok = False
                    break
                if induced and has_t and not has_p:
                    ok = False
                    break
            if ok:
                mapping[a] = c
                rec(mapping)
                del mapping[a]

    rec({})
    return out
