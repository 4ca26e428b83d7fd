"""Classic graph kernels (BFS / PageRank / CC / SSSP / BC) — the port of
gms_tpu/algorithms/gapbs.py.

Role of the reference's Log(Graph) GAPBS benchmark set
(gms/representations/graphs/log_graph/{bfs,pr,cc,sssp,bc}.cc and their
kbit_ variants): the standard kernels over plain and compressed graph
representations. gms_tpu runs each as one jitted whole-graph pull program
over padded rows int32[V_pad, D_pad]; at RMAT-18 (max degree 25,196) that
layout is 26.4 GB against a 32 MB CSR, and every pull step reads all of it.
The port runs the same functions over CSR rows on the device (`indptr`
int64[n + 1], `indices` int32[E]), read to each row's degree: the rows are
gms_tpu's padded rows in the same order without the SENTINEL tail, so BFS,
CC and SSSP are exact either way and only float sum order changes for
PageRank and BC. `_prep` gives those rows for every form gms_tpu's `_prep`
takes (CSRGraph, PaddedGraph, KbitGraph, HybridGraph, KbitGraphBucketed),
the compressed ones by a masked compaction of their decoded padded rows.

The loops are Python, one small read-back a step (a count or a changed
flag), and each step is a hand-written CUDA kernel (csrc/):

    bfs_pull                  csrc/gapbs_bfs.cu       K29 (_bfs_dense :85,
                                                      _bfs_dopt's pull)
    frontier_ids, bfs_push    csrc/gapbs_bfs.cu       K30 (_bfs_dopt's push,
                                                      :108)
    bfs_kbit_pull             csrc/gapbs_kbit_bfs.cu  K31 (_bfs_kbit, :185)
    pr_pull                   csrc/gapbs_pr.cu        K32 (_pagerank, :216)
    cc_step, sssp_step        csrc/gapbs_min.cu       K33 (_cc :245,
                                                      _sssp :275)
    bc_forward, bc_backward   csrc/gapbs_bc.cu        K34 (_bc_one_source
                                                      :337, _bc_batched :375;
                                                      a batch of <= 64
                                                      sources, one bit each)

Each wrapper checks device, dtype, shape and contiguity; for CPU tensors it
runs its `*_plain` PyTorch version (row ids from repeat_interleave, sums and
minima by index_add_ and scatter_reduce_), for CUDA tensors it launches the
kernel (raising if the launch fails) and adds one to LAUNCHES[name].
PageRank's and BC's row sums accumulate in float64 and round once to
float32, in the kernels and in the plain versions alike, so the two agree
whatever order each sums in. pr_pull and the BC steps run on the
degree-balanced row schedule of graphs/row_schedule.py, which `_pagerank`
and `_bc_total` build once a call. BC keeps a batch as one 64-bit word a
vertex a depth (bc_state), sigma and delta vertex-major [n, 64]; bc_dist
gives gms_tpu's dist from it.
The host oracles are gms_tpu's, copied.
"""

from __future__ import annotations

import functools
from collections import deque

import numpy as np
import torch

from gms_tpu_torch import _kernels
from gms_tpu_torch.device import resolve
from gms_tpu_torch.graphs.csr import CSRGraph
from gms_tpu_torch.graphs.row_schedule import (RowSchedule,
                                               build_row_schedule,
                                               check_schedule)
from gms_tpu_torch.graphs.tiles import PaddedGraph, SENTINEL, round_up

_SENT = int(SENTINEL)
INF = int(np.iinfo(np.int32).max)          # gms_tpu's _INF
BIG = int(np.iinfo(np.int64).max // 4)     # SSSP's unreached distance

# Kernel launches, counted only where a CUDA kernel launches.
LAUNCHES = {"bfs_pull": 0, "frontier_ids": 0, "bfs_push": 0,
            "bfs_kbit_pull": 0, "pr_pull": 0, "cc_step": 0, "sssp_step": 0,
            "bc_forward": 0, "bc_backward": 0}
# what the last call of each loop did: BFS's direction per level ("push" or
# "pull"), the CC and SSSP rounds (gms_tpu's while_loop iterations)
STEPS = {"bfs": [], "cc": 0, "sssp": 0}

# sources a BC batch runs at once, one bit each of a 64-bit word: lvl
# [max_depth + 1, n] words (27 MB at RMAT-18, max_depth 12), sigma and delta
# [n, 64] float32 (67 MB each; gms_tpu sizes its vmapped batch to a
# [B, V, D] gather)
BC_BATCH = 64
# elements a plain version materialises at once
_PLAIN_BUDGET = 1 << 24


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# graph forms -> device CSR rows
# ---------------------------------------------------------------------------

def _compact(nbr: torch.Tensor, n: int):
    """CSR rows of padded rows nbr[:n] (int32, SENTINEL where empty), in row
    order: the masked compaction of gms_tpu's `valid = nbr != SENTINEL`."""
    rows = nbr[:n]
    valid = rows != _SENT
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=rows.device)
    torch.cumsum(valid.sum(dim=1), 0, out=indptr[1:])
    return indptr, rows[valid].to(torch.int32), valid


def _prep(g, dev):
    """(indptr int64[n+1], indices int32[E], deg int32[n], n, v_pad) on dev
    for every form gms_tpu's `_prep` (gapbs.py:34) takes.

    deg (PageRank's out-degree) is each row's own length. gms_tpu's `_prep`
    gives a HybridGraph its k-bit part's degrees, 0 on the bitmap rows, so
    its PageRank of a HybridGraph with bitmap rows departs from the oracle
    (at RMAT-10 the ranks sum to 3e31); the port follows the oracle there.
    v_pad is gms_tpu's padded row count (BFS's frontier cap reads it)."""
    from gms_tpu_torch.graphs import compressed as cp

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(dev)

    if isinstance(g, CSRGraph):
        n = g.num_nodes
        return (t(g.indptr, torch.int64), t(g.indices, torch.int32),
                t(g.degrees, torch.int32), n, round_up(max(n + 1, 1), 8))
    if isinstance(g, PaddedGraph):
        nbr, v_pad = g.nbr, g.v_pad
    elif isinstance(g, cp.KbitGraph):
        nbr, v_pad = g.nbr, g.packed.shape[0]
    elif isinstance(g, cp.HybridGraph):
        nbr, v_pad = torch.from_numpy(g.decode_all()), g.kbit.packed.shape[0]
    elif isinstance(g, cp.KbitGraphBucketed):
        nbr, v_pad = torch.from_numpy(g.decode_all()), g.v_pad
    else:
        raise TypeError(f"unsupported graph representation: {type(g)!r}")
    n = g.num_nodes
    indptr, indices, valid = _compact(nbr, n)
    deg = valid.sum(dim=1)
    return (indptr.to(dev), indices.to(dev), deg.to(device=dev,
                                                     dtype=torch.int32),
            n, v_pad)


def _check_csr(name, indptr, indices, n_state=None):
    _kernels.check_tensor(name, "indptr", indptr, 1, torch.int64)
    _kernels.check_tensor(name, "indices", indices, 1)
    n = indptr.shape[0] - 1
    if n < 0:
        raise ValueError(f"{name}: indptr needs n + 1 >= 1 entries")
    if n_state is not None and n_state != n:
        raise ValueError(f"{name}: state of {n_state} vertices for {n} rows")
    return n


def _row_ids(indptr):
    n = indptr.shape[0] - 1
    return torch.repeat_interleave(
        torch.arange(n, device=indptr.device), indptr.diff())


def _count(dev):
    return torch.zeros(1, dtype=torch.int64, device=dev)


# ---------------------------------------------------------------------------
# K29: the pull BFS level
# ---------------------------------------------------------------------------

def bfs_pull_plain(indptr, indices, dist, it: int):
    src = _row_ids(indptr)
    hit = (dist[indices.long()] == it).long()
    reach = torch.zeros_like(dist, dtype=torch.long).index_add_(0, src, hit)
    new = (reach > 0) & (dist == INF)
    dist[new] = it + 1
    return new.sum().reshape(1)


def bfs_pull(indptr, indices, dist, it: int):
    """One bottom-up level, in place: every unreached vertex (dist == INF)
    with a neighbour at dist == it gets it + 1. Returns int64[1], the
    vertices reached (the next frontier's size)."""
    name = "bfs_pull"
    _kernels.check_tensor(name, "dist", dist, 1)
    n = _check_csr(name, indptr, indices, dist.shape[0])
    if not _kernels.on_cuda(name, indptr, indices, dist):
        return bfs_pull_plain(indptr, indices, dist, it)
    count = _count(dist.device)
    _kernels.launch("gapbs_bfs", "bfs_pull", indptr, indices, n, dist, it,
                    count)
    LAUNCHES[name] += 1
    return count


# ---------------------------------------------------------------------------
# K30: the push BFS level
# ---------------------------------------------------------------------------

def frontier_ids_plain(dist, it: int):
    ids = torch.nonzero(dist == it)[:, 0].to(torch.int32)
    out = torch.zeros_like(dist)
    out[:ids.numel()] = ids
    return out, torch.tensor([ids.numel()], dtype=torch.int64,
                             device=dist.device)


def frontier_ids(dist, it: int):
    """(ids int32[n], count int64[1]): the vertices with dist == it in the
    first `count` slots of ids, in any order."""
    name = "frontier_ids"
    _kernels.check_tensor(name, "dist", dist, 1)
    if not _kernels.on_cuda(name, dist):
        return frontier_ids_plain(dist, it)
    ids, count = torch.empty_like(dist), _count(dist.device)
    _kernels.launch("gapbs_bfs", "frontier_ids", dist, dist.shape[0], it, ids,
                    count)
    LAUNCHES[name] += 1
    return ids, count


def bfs_push_plain(indptr, indices, ids, fcount: int, dist, it: int):
    f = ids[:fcount].long()
    start, lens = indptr[f], indptr[f + 1] - indptr[f]
    total = int(lens.sum())
    pos = (torch.repeat_interleave(start - (torch.cumsum(lens, 0) - lens),
                                   lens)
           + torch.arange(total, device=dist.device))
    w = indices[pos].long()
    won = torch.unique(w[dist[w] == INF])
    dist[won] = it + 1
    out = torch.zeros_like(dist)
    out[:won.numel()] = won.to(torch.int32)
    return out, torch.tensor([won.numel()], dtype=torch.int64,
                             device=dist.device)


def bfs_push(indptr, indices, ids, fcount: int, dist, it: int):
    """One top-down level from the frontier ids[:fcount], in place: each
    neighbour still at INF gets it + 1 (gms_tpu's scatter-min). Returns
    (next_ids int32[n], next_count int64[1]): the vertices it reached, the
    next frontier, in any order."""
    name = "bfs_push"
    _kernels.check_tensor(name, "dist", dist, 1)
    _kernels.check_tensor(name, "ids", ids, 1)
    n = _check_csr(name, indptr, indices, dist.shape[0])
    if not 0 <= fcount <= ids.shape[0]:
        raise ValueError(f"{name}: fcount {fcount} outside the "
                         f"{ids.shape[0]} ids")
    if not _kernels.on_cuda(name, indptr, indices, ids, dist):
        return bfs_push_plain(indptr, indices, ids, fcount, dist, it)
    nxt, count = torch.empty_like(dist), _count(dist.device)
    _kernels.launch("gapbs_bfs", "bfs_push", indptr, indices, ids, fcount,
                    dist, it, nxt, count)
    LAUNCHES[name] += 1
    return nxt, count


# ---------------------------------------------------------------------------
# K31: the pull level from the k-bit words
# ---------------------------------------------------------------------------

def bfs_kbit_pull_plain(packed, deg, dist, it: int, *, k: int, d_pad: int):
    from gms_tpu_torch.graphs.compressed import kbit_decode_rows_plain

    n = dist.shape[0]
    reach = torch.zeros(n, dtype=torch.bool, device=dist.device)
    step = max(1, _PLAIN_BUDGET // max(d_pad, 1))
    for v0 in range(0, n, step):
        vids = torch.arange(v0, min(n, v0 + step), dtype=torch.int32,
                            device=dist.device)
        rows = kbit_decode_rows_plain(packed, deg, vids, k=k, d_pad=d_pad)
        ok = (rows != _SENT) & (rows < n)
        hit = ok & (dist[rows.long().clamp(0, n - 1)] == it)
        reach[v0:v0 + vids.numel()] = hit.any(dim=1)
    new = reach & (dist == INF)
    dist[new] = it + 1
    return new.sum().reshape(1)


def bfs_kbit_pull(packed, deg, dist, it: int, *, k: int, d_pad: int):
    """bfs_pull over the k-bit packed rows (int32 words of packed
    uint32[>= n, W], deg int32[>= n]), decoding each row's lanes j < deg as
    it scans them; the rows are never materialized."""
    name = "bfs_kbit_pull"
    _kernels.check_tensor(name, "packed", packed, 2)
    _kernels.check_tensor(name, "deg", deg, 1)
    _kernels.check_tensor(name, "dist", dist, 1)
    n = dist.shape[0]
    if packed.shape[0] < n or deg.shape[0] < n:
        raise ValueError(f"{name}: {packed.shape[0]} packed rows, "
                         f"{deg.shape[0]} degrees for {n} vertices")
    if not 1 <= k <= 32 or d_pad * k > 32 * packed.shape[1]:
        raise ValueError(f"{name}: {d_pad} lanes of k={k} bits do not fit "
                         f"{packed.shape[1]} words")
    if not _kernels.on_cuda(name, packed, deg, dist):
        return bfs_kbit_pull_plain(packed, deg, dist, it, k=k, d_pad=d_pad)
    count = _count(dist.device)
    _kernels.launch("gapbs_kbit_bfs", "bfs_kbit_pull", packed,
                    packed.shape[1], deg, n, k, dist, it, count)
    LAUNCHES[name] += 1
    return count


# ---------------------------------------------------------------------------
# K32: one PageRank iteration
# ---------------------------------------------------------------------------

def pr_pull_plain(indptr, indices, deg, pr, base: float, damp: float):
    contrib = pr / deg.clamp(min=1).to(torch.float32)
    s = torch.zeros(pr.shape, dtype=torch.float64, device=pr.device)
    s.index_add_(0, _row_ids(indptr), contrib[indices.long()].double())
    f32 = dict(dtype=torch.float32, device=pr.device)
    return torch.tensor(base, **f32) + torch.tensor(damp, **f32) * s.float()


def pr_pull(indptr, indices, deg, pr, base: float, damp: float, *,
            schedule: RowSchedule | None = None):
    """float32[n]: base + damp * sum over row v of pr[w] / max(deg[w], 1)
    (base and damp already float32 values). `schedule` is the row
    schedule built from this indptr tensor (built here when None): a
    caller that iterates builds it once."""
    name = "pr_pull"
    _kernels.check_tensor(name, "deg", deg, 1)
    _kernels.check_tensor(name, "pr", pr, 1, torch.float32)
    n = _check_csr(name, indptr, indices, pr.shape[0])
    if deg.shape[0] != n:
        raise ValueError(f"{name}: {deg.shape[0]} degrees for {n} rows")
    if schedule is not None:
        check_schedule(name, schedule, indptr)
    if not _kernels.on_cuda(name, indptr, indices, deg, pr):
        return pr_pull_plain(indptr, indices, deg, pr, base, damp)
    if schedule is None:
        schedule = build_row_schedule(indptr)
    out = torch.empty_like(pr)
    contrib = torch.empty_like(pr)
    partial = (torch.empty(schedule.n_seg, dtype=torch.float64,
                           device=pr.device) if schedule.n_wide else None)
    _kernels.launch("gapbs_pr", "pr_pull", indptr, indices, n, deg, pr,
                    base, damp, *schedule.launch_args(), partial, contrib,
                    out)
    LAUNCHES[name] += 1
    return out


# ---------------------------------------------------------------------------
# K33: one Jacobi min step (CC labels, SSSP distances)
# ---------------------------------------------------------------------------

def _min_step_plain(indptr, cur, cand):
    nxt = cur.clone().scatter_reduce_(0, _row_ids(indptr), cand, "amin")
    return nxt, (nxt != cur).any().to(torch.int32).reshape(1)


def cc_step_plain(indptr, indices, cur):
    return _min_step_plain(indptr, cur, cur[indices.long()])


def cc_step(indptr, indices, cur):
    """(nxt int32[n], changed int32[1]): nxt = min(cur, the row's min of
    cur), one Jacobi step of min-label propagation."""
    name = "cc_step"
    _kernels.check_tensor(name, "cur", cur, 1)
    n = _check_csr(name, indptr, indices, cur.shape[0])
    if not _kernels.on_cuda(name, indptr, indices, cur):
        return cc_step_plain(indptr, indices, cur)
    nxt = torch.empty_like(cur)
    changed = torch.zeros(1, dtype=torch.int32, device=cur.device)
    _kernels.launch("gapbs_min", "cc_step", indptr, indices, n, cur, nxt,
                    changed)
    LAUNCHES[name] += 1
    return nxt, changed


def sssp_step_plain(indptr, indices, weights, cur):
    cand = cur[indices.long()] + (1 if weights is None else weights.long())
    return _min_step_plain(indptr, cur, cand)


def sssp_step(indptr, indices, weights, cur):
    """(nxt int64[n], changed int32[1]): nxt = min(cur, the row's min of
    cur[w] + weight), one Bellman-Ford step; weights int32[E] per CSR slot,
    or None for unit weights."""
    name = "sssp_step"
    _kernels.check_tensor(name, "cur", cur, 1, torch.int64)
    n = _check_csr(name, indptr, indices, cur.shape[0])
    args = (indptr, indices, cur)
    if weights is not None:
        _kernels.check_tensor(name, "weights", weights, 1)
        if weights.shape != indices.shape:
            raise ValueError(f"{name}: {weights.shape[0]} weights for "
                             f"{indices.shape[0]} slots")
        args += (weights,)
    if not _kernels.on_cuda(name, *args):
        return sssp_step_plain(indptr, indices, weights, cur)
    nxt = torch.empty_like(cur)
    changed = torch.zeros(1, dtype=torch.int32, device=cur.device)
    _kernels.launch("gapbs_min", "sssp_step", indptr, indices, weights, n,
                    cur, nxt, changed)
    LAUNCHES[name] += 1
    return nxt, changed


# ---------------------------------------------------------------------------
# K34: Brandes' forward and backward steps over a batch of sources
# ---------------------------------------------------------------------------

def _bit_shifts(dev):
    return torch.arange(BC_BATCH, dtype=torch.int64, device=dev)


def _unpack64(words):
    """bool[..., 64]: bit b of each int64 word (a uint64's bits)."""
    return ((words.unsqueeze(-1) >> _bit_shifts(words.device)) & 1).bool()


def _pack64(bits):
    """int64[...]: the words of bool[..., 64] (the sum of distinct powers of
    two is their OR, bit 63 included, in two's complement)."""
    return (bits.long() << _bit_shifts(bits.device)).sum(-1)


def bc_state(n: int, sources, max_depth: int, device):
    """A batch's state (lvl, seen, sigma, delta) for B = len(sources) <= 64
    sources, bit b for source b:
      lvl   int64[max_depth + 1, n] (uint64 words): bit b of lvl[d][v] set
            when source b reaches v at depth d; lvl[0] holds the sources;
      seen  int64[n]: the pairs reached, and the bits b >= B of every
            vertex, so that ~seen[v] is v's unreached pairs;
      sigma float32[n, 64]: 1 at (source, b), else 0; delta float32[n, 64]
            zeros.
    A vertex may be several sources (a repeated source counts each time, as
    in gms_tpu's vmap)."""
    src = torch.as_tensor(np.asarray(sources), dtype=torch.int64)
    B = src.numel()
    if not 1 <= B <= BC_BATCH:
        raise ValueError(f"bc_state: {B} sources, a batch holds 1 to "
                         f"{BC_BATCH}")
    if not (0 <= int(src.min()) and int(src.max()) < n):
        raise ValueError(f"bc_state: a source outside [0, {n})")
    src = src.to(device)
    bits = torch.ones(B, dtype=torch.int64, device=device) << torch.arange(
        B, dtype=torch.int64, device=device)
    lvl = torch.zeros((max_depth + 1, n), dtype=torch.int64, device=device)
    lvl[0].index_put_((src,), bits, accumulate=True)
    unused = 0 if B == BC_BATCH else ~((1 << B) - 1)
    seen = torch.full((n,), unused, dtype=torch.int64, device=device) | lvl[0]
    sigma = torch.zeros((n, BC_BATCH), dtype=torch.float32, device=device)
    sigma[src, torch.arange(B, device=device)] = 1.0
    return lvl, seen, sigma, torch.zeros_like(sigma)


def bc_dist(lvl, B: int):
    """int32[B, n]: each pair's depth from lvl (gms_tpu's dist), INF where
    the pair is unreached."""
    dist = torch.full((B, lvl.shape[1]), INF, dtype=torch.int32,
                      device=lvl.device)
    for d in range(lvl.shape[0]):
        dist[_unpack64(lvl[d])[:, :B].T] = d
    return dist


def _bc_chunks(indptr, indices):
    """(row, neighbour) ids of the CSR slots, in slices a plain step takes
    at once (each slice's terms are [slots, 64])."""
    src, idx = _row_ids(indptr), indices.long()
    step = max(1, _PLAIN_BUDGET // BC_BATCH)
    for e0 in range(0, idx.numel(), step):
        yield src[e0:e0 + step], idx[e0:e0 + step]


def bc_forward_plain(indptr, indices, lvl, seen, sigma, it: int):
    need = ~_unpack64(seen)
    front = _unpack64(lvl[it])
    s = torch.zeros(sigma.shape, dtype=torch.float64, device=sigma.device)
    for v, w in _bc_chunks(indptr, indices):
        s.index_add_(0, v, torch.where(front[w] & need[v], sigma[w],
                                       0.0).double())
    new = need & (s > 0)
    words = _pack64(new)
    lvl[it + 1] |= words
    seen |= words
    sigma[new] = s[new].float()


def bc_backward_plain(indptr, indices, lvl, sigma, delta, it: int, total):
    at = _unpack64(lvl[it])
    succ = _unpack64(lvl[it + 1])
    acc = torch.zeros(delta.shape, dtype=torch.float64, device=delta.device)
    for v, w in _bc_chunks(indptr, indices):
        nsig = sigma[w]
        hit = succ[w] & at[v] & (nsig > 0)
        term = (sigma[v] / nsig.clamp(min=1e-30)) * (1.0 + delta[w])
        acc.index_add_(0, v, torch.where(hit, term, 0.0).double())
    acc = acc.float()
    delta[at] = acc[at]
    if it > 0:
        total += torch.where(at, acc, 0.0).double().sum(1).float()


def _check_bc(name, indptr, indices, lvl, it: int, *state):
    _kernels.check_tensor(name, "lvl", lvl, 2, torch.int64)
    n = _check_csr(name, indptr, indices, lvl.shape[1])
    if not 0 <= it < lvl.shape[0] - 1:
        raise ValueError(f"{name}: step {it} outside the {lvl.shape[0]} "
                         f"levels")
    for what, t in state:
        _kernels.check_tensor(name, what, t, 2, torch.float32)
        if t.shape != (n, BC_BATCH):
            raise ValueError(f"{name}: {what} {tuple(t.shape)}, not "
                             f"({n}, {BC_BATCH})")
    return n


def _bc_launch(name, schedule, indptr, *args):
    """K34's C entry `name` on the row schedule (built when None), with
    float64 partials for the wide rows' segments."""
    if schedule is None:
        schedule = build_row_schedule(indptr)
    partial = (torch.empty((schedule.n_seg, BC_BATCH), dtype=torch.float64,
                           device=indptr.device) if schedule.n_wide else None)
    _kernels.launch("gapbs_bc", name, indptr, *args,
                    *schedule.launch_args(), partial)
    LAUNCHES[name] += 1


def bc_forward(indptr, indices, lvl, seen, sigma, it: int, *,
               schedule: RowSchedule | None = None):
    """Forward step `it` of a batch (bc_state), in place: each unreached
    pair (b, v) whose neighbours at depth it carry sigma sum s > 0 takes
    depth it + 1 (its bit in lvl[it + 1] and seen) and sigma s. `schedule`
    is the row schedule of this indptr tensor (built here when None)."""
    name = "bc_forward"
    n = _check_bc(name, indptr, indices, lvl, it, ("sigma", sigma))
    _kernels.check_tensor(name, "seen", seen, 1, torch.int64)
    if seen.shape[0] != n:
        raise ValueError(f"{name}: seen of {seen.shape[0]} for {n} rows")
    if schedule is not None:
        check_schedule(name, schedule, indptr)
    if not _kernels.on_cuda(name, indptr, indices, lvl, seen, sigma):
        return bc_forward_plain(indptr, indices, lvl, seen, sigma, it)
    _bc_launch(name, schedule, indptr, indices, n, lvl, seen, sigma, it)


def bc_backward(indptr, indices, lvl, sigma, delta, it: int, total, *,
                schedule: RowSchedule | None = None):
    """Backward step `it`, in place on delta: a pair (b, v) at depth it
    takes the sum over v's successors w of sigma[v, b] / max(sigma[w, b],
    1e-30) * (1 + delta[w, b]); for it > 0 the row's new deltas are added
    to total float32[n] (the source, at depth 0, is not)."""
    name = "bc_backward"
    n = _check_bc(name, indptr, indices, lvl, it, ("sigma", sigma),
                  ("delta", delta))
    _kernels.check_tensor(name, "total", total, 1, torch.float32)
    if total.shape[0] != n:
        raise ValueError(f"{name}: total of {total.shape[0]} for {n} rows")
    if schedule is not None:
        check_schedule(name, schedule, indptr)
    if not _kernels.on_cuda(name, indptr, indices, lvl, sigma, delta,
                            total):
        return bc_backward_plain(indptr, indices, lvl, sigma, delta, it,
                                 total)
    _bc_launch(name, schedule, indptr, indices, n, lvl, sigma, delta, it,
               total)


# ---------------------------------------------------------------------------
# the loops (step functions passed in, so the plain runs share them)
# ---------------------------------------------------------------------------

def _start(n: int, source: int, dev):
    if not 0 <= source < n:
        raise ValueError(f"source {source} outside [0, {n})")
    dist = torch.full((n,), INF, dtype=torch.int32, device=dev)
    dist[source] = 0
    return dist


def _bfs_dense(indptr, indices, dist, pull=None):
    """gms_tpu's _bfs_dense: pull levels until one reaches nothing."""
    pull = pull or bfs_pull
    it = 0
    while True:
        STEPS["bfs"].append("pull")
        reached = int(pull(indptr, indices, dist, it))
        it += 1
        if reached == 0:
            return dist


def _bfs_dopt(indptr, indices, dist, source: int, f_cap: int):
    """gms_tpu's _bfs_dopt: a level whose frontier count is at most f_cap
    pushes from the frontier's ids (the previous push's output, else
    compacted), a larger one pulls; one 8-byte count read back a level."""
    fcount, it = 1, 0
    ids = torch.tensor([source], dtype=torch.int32, device=dist.device)
    while fcount > 0:
        if fcount <= f_cap:
            STEPS["bfs"].append("push")
            if ids is None:
                ids, _ = frontier_ids(dist, it)
            ids, count = bfs_push(indptr, indices, ids, fcount, dist, it)
        else:
            STEPS["bfs"].append("pull")
            count, ids = bfs_pull(indptr, indices, dist, it), None
        fcount = int(count)
        it += 1
    return dist


def _as_hops(dist) -> np.ndarray:
    d = dist.cpu().numpy()
    return np.where(d == INF, -1, d).astype(np.int32)


def bfs(g, source: int, *, direction_optimizing: bool = True,
        device="cuda") -> np.ndarray:
    """Hop distances int32[n] from source; unreachable = -1. Equal to
    gms_tpu's for every form `_prep` takes. direction_optimizing (and
    n >= 32) pushes levels whose frontier is at most f_cap = max(64,
    V_pad // 16) vertices and pulls the rest; else every level pulls."""
    dev = resolve(device)
    indptr, indices, _, n, v_pad = _prep(g, dev)
    STEPS["bfs"] = []
    if n == 0:
        return np.zeros(0, np.int32)
    dist = _start(n, source, dev)
    if direction_optimizing and n >= 32:
        _bfs_dopt(indptr, indices, dist, source, max(64, v_pad // 16))
    else:
        _bfs_dense(indptr, indices, dist)
    return _as_hops(dist)


def bfs_kbit(kg, source: int, *, device="cuda") -> np.ndarray:
    """BFS computing from the k-bit packed form (a KbitGraph): every level
    decodes the packed words it scans (kbit_bfs.cc role), pull only, as
    gms_tpu's _bfs_kbit."""
    dev = resolve(device)
    n = kg.num_nodes
    STEPS["bfs"] = []
    if n == 0:
        return np.zeros(0, np.int32)
    packed, deg = kg.packed.to(dev), kg.deg.to(dev)
    dist = _start(n, source, dev)

    def pull(_indptr, _indices, dist, it):
        return bfs_kbit_pull(packed, deg, dist, it, k=kg.k, d_pad=kg.d_pad)

    _bfs_dense(None, None, dist, pull)
    return _as_hops(dist)


def _pagerank(indptr, indices, deg, n: int, iters: int, damp: float,
              step=None):
    if step is None:
        # one row schedule for every iteration of the call
        step = functools.partial(pr_pull,
                                 schedule=build_row_schedule(indptr))
    # gms_tpu (x64 on): the weak float64 (1 - damp) rounds once to float32
    # against float32 n; damp * sum multiplies by float32(damp)
    nf = np.float32(n)
    base = float(np.float32(1.0 - damp) / nf)
    pr = torch.full((n,), float(np.float32(1.0) / nf), dtype=torch.float32,
                    device=deg.device)
    for _ in range(iters):
        pr = step(indptr, indices, deg, pr, base, float(np.float32(damp)))
    return pr


def pagerank(g, iters: int = 20, damp: float = 0.85, *,
             device="cuda") -> np.ndarray:
    """PageRank (GAPBS PageRankPull), float32[n]: `iters` pull iterations;
    dangling mass is not redistributed. gms_tpu's values to rounding."""
    dev = resolve(device)
    indptr, indices, deg, n, _ = _prep(g, dev)
    if n == 0:
        return np.zeros(0, np.float32)
    return _pagerank(indptr, indices, deg, n, iters, damp).cpu().numpy()


def _fixpoint(step, cur, key: str):
    """gms_tpu's while_loop(changed): Jacobi steps until one changes
    nothing, the last included; STEPS[key] counts them."""
    STEPS[key] = 0
    while True:
        cur, changed = step(cur)
        STEPS[key] += 1
        if not int(changed):
            return cur


def connected_components(g, *, device="cuda") -> np.ndarray:
    """Component id per vertex (the min vertex id in its component),
    int32[n], by min-label propagation to a fixpoint."""
    dev = resolve(device)
    indptr, indices, _, n, _ = _prep(g, dev)
    if n == 0:
        return np.zeros(0, np.int32)
    labels = torch.arange(n, dtype=torch.int32, device=dev)
    return _fixpoint(lambda c: cc_step(indptr, indices, c), labels,
                     "cc").cpu().numpy()


def _sssp_rows(g, weights, dev):
    """(indptr, indices, weights int32[E] or None for unit, n)."""
    from gms_tpu_torch.graphs.compressed import KbitWeightedGraph

    if isinstance(g, KbitWeightedGraph):
        if weights is not None:
            raise ValueError("KbitWeightedGraph carries its own weights")
        n = g.num_nodes
        indptr, indices, valid = _compact(g.nbr, n)
        w = g.weight_rows()[:n][valid].to(torch.int32)
        return indptr.to(dev), indices.to(dev), w.to(dev), n
    if isinstance(g, CSRGraph):
        if weights is None:
            weights = g.weights
        w = (None if weights is None else torch.from_numpy(
            np.ascontiguousarray(weights).astype(np.int32)).to(dev))
        if w is not None and w.shape[0] != g.num_edges:
            raise ValueError(f"{w.shape[0]} weights for {g.num_edges} slots")
        indptr, indices, _, n, _ = _prep(g, dev)
        return indptr, indices, w, n
    if weights is not None:
        raise ValueError("per-slot weights require a CSRGraph")
    indptr, indices, _, n, _ = _prep(g, dev)
    return indptr, indices, None, n


def sssp(g, source: int, weights: np.ndarray | None = None, *,
         device="cuda") -> np.ndarray:
    """Shortest-path distances int64[n] (Bellman-Ford to a fixpoint);
    unreachable = -1. weights are int per directed CSR slot (a CSRGraph's
    own `weights` when None, else unit); a KbitWeightedGraph computes from
    its packed ids and weights; other forms run with unit weights."""
    dev = resolve(device)
    indptr, indices, w, n = _sssp_rows(g, weights, dev)
    if n == 0:
        return np.zeros(0, np.int64)
    if not 0 <= source < n:
        raise ValueError(f"source {source} outside [0, {n})")
    dist = torch.full((n,), BIG, dtype=torch.int64, device=dev)
    dist[source] = 0
    d = _fixpoint(lambda c: sssp_step(indptr, indices, w, c), dist,
                  "sssp").cpu().numpy()
    return np.where(d >= BIG, -1, d)


def _bc_total(indptr, indices, n: int, sources: np.ndarray, max_depth: int,
              forward=None, backward=None):
    """float32[n] on the device: the sum of the sources' Brandes deltas,
    BC_BATCH sources at a time, max_depth steps each way (gms_tpu's
    _bc_batched; the batch size only changes the sum order). The kernels
    share one row schedule, built here."""
    if forward is None or backward is None:
        sched = build_row_schedule(indptr)
        forward = forward or functools.partial(bc_forward, schedule=sched)
        backward = backward or functools.partial(bc_backward,
                                                 schedule=sched)
    total = torch.zeros(n, dtype=torch.float32, device=indptr.device)
    for b0 in range(0, len(sources), BC_BATCH):
        lvl, seen, sigma, delta = bc_state(n, sources[b0:b0 + BC_BATCH],
                                           max_depth, indptr.device)
        for it in range(max_depth):
            forward(indptr, indices, lvl, seen, sigma, it)
        for it in range(max_depth - 1, -1, -1):
            backward(indptr, indices, lvl, sigma, delta, it, total)
    return total


def bc_sources(n: int, sources=None, num_samples: int | None = None,
               seed: int = 0) -> np.ndarray:
    """gms_tpu's source list: `sources`, else num_samples < n drawn by
    np.random.default_rng(seed).choice without replacement, else all."""
    if sources is None and num_samples is not None and num_samples < n:
        sources = np.random.default_rng(seed).choice(
            n, size=num_samples, replace=False)
    if sources is None:
        sources = range(n)
    return np.asarray(list(sources), dtype=np.int32)


def bc_max_depth(g, *, device="cuda") -> int:
    """gms_tpu's depth bound min(n, max(4, 2 _diameter_bound(g)))."""
    return int(min(g.num_nodes, max(4, 2 * _diameter_bound(g,
                                                           device=device))))


def betweenness_centrality(g, sources=None, *, normalize: bool = True,
                           num_samples: int | None = None, seed: int = 0,
                           device="cuda") -> np.ndarray:
    """Brandes BC float32[n] from the given sources (default: all vertices;
    num_samples picks that many at random, estimates scaled by
    n / num_samples, the GAPBS bc.cc sampled mode). gms_tpu's depth bound,
    quirks included: max_depth = min(n, max(4, 2 (ecc(0) + 2))), so a
    component deeper than BFS from vertex 0 reaches is cut there."""
    dev = resolve(device)
    indptr, indices, _, n, _ = _prep(g, dev)
    src = bc_sources(n, sources, num_samples, seed)
    if len(src) == 0:
        return np.zeros(n, np.float32)
    total = _bc_total(indptr, indices, n, src, bc_max_depth(g, device=dev))
    total = total.cpu().numpy().astype(np.float64)
    if num_samples is not None and num_samples < n:
        total *= n / num_samples
    if normalize and total.max() > 0:
        total /= total.max()
    return total.astype(np.float32)


def _diameter_bound(g, *, device="cuda") -> int:
    if g.num_nodes == 0:
        return 1
    d = bfs(g, 0, device=device)
    return int(max(d.max(initial=1), 1)) + 2


# ---------------------------------------------------------------------------
# host oracles (gms_tpu's, copied)
# ---------------------------------------------------------------------------

def bfs_oracle(g: CSRGraph, source: int) -> np.ndarray:
    dist = np.full(g.num_nodes, -1, np.int64)
    dist[source] = 0
    q = deque([source])
    while q:
        v = q.popleft()
        for w in g.out_neigh(v):
            if dist[w] < 0:
                dist[w] = dist[v] + 1
                q.append(int(w))
    return dist


def cc_oracle(g: CSRGraph) -> np.ndarray:
    labels = np.arange(g.num_nodes)
    changed = True
    while changed:
        changed = False
        for v in range(g.num_nodes):
            for w in g.out_neigh(v):
                m = min(labels[v], labels[w])
                if labels[v] != m or labels[w] != m:
                    labels[v] = labels[w] = m
                    changed = True
    return labels


def sssp_oracle(g: CSRGraph, source: int, weights=None) -> np.ndarray:
    import heapq

    if weights is None:
        weights = np.ones(g.num_edges, dtype=np.int64)
    dist = np.full(g.num_nodes, -1, np.int64)
    seen = {source: 0}
    pq = [(0, source)]
    while pq:
        d, v = heapq.heappop(pq)
        if dist[v] >= 0:
            continue
        dist[v] = d
        for k in range(g.indptr[v], g.indptr[v + 1]):
            w, wt = int(g.indices[k]), int(weights[k])
            nd = d + wt
            if dist[w] < 0 and (w not in seen or nd < seen[w]):
                seen[w] = nd
                heapq.heappush(pq, (nd, w))
    return dist


def pagerank_oracle(g: CSRGraph, iters=20, damp=0.85) -> np.ndarray:
    n = g.num_nodes
    pr = np.full(n, 1.0 / n)
    outdeg = np.maximum(g.degrees, 1)
    for _ in range(iters):
        contrib = pr / outdeg
        nxt = np.full(n, (1 - damp) / n)
        for v in range(n):
            nxt[v] += damp * contrib[g.out_neigh(v)].sum()
        pr = nxt
    return pr
