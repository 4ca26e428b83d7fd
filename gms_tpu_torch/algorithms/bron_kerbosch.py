r"""Maximal clique enumeration (Bron–Kerbosch) — the port of
gms_tpu/algorithms/bron_kerbosch.py.

Role of the reference's MCE family (gms/algorithms/set_based/
maximal_clique_enum/): BkSimple (the host oracle `bron_kerbosch_simple`),
Tomita pivoting (pivot = argmax |cand ∩ N(u)| over u ∈ cand ∪ fini),
Eppstein's degeneracy-ordered roots and per-root subgraphs.

The path, as gms_tpu's default (fused DAG-universe) path:
  1. a rank (exact degeneracy by default), orient into a DAG, pad at lane 32;
     the lower-ranked neighbours of every vertex as one CSR;
  2. `plan_tier_chunks` (k_clique.py) cuts the roots into degree tiers of
     local width W; `_indeg_sub_chunks` cuts each tier by in-degree bucket,
     so the cover width IN (a power of two >= 32) stays within 2x of every
     root's count of lower neighbours;
  3. per sub-chunk: the cover bitsets M[c, i] (which of root c's DAG slots
     lie in N⁺(w_i), for its lower neighbours w_i), the local DAG adjacency,
     symmetrized, and the Tomita search over (cand, fini, R) bitsets. A leaf
     R is the clique {root} ∪ R, maximal in the root's out-neighbourhood;
     it is globally maximal, and counted, iff no w_i has R ⊆ M[c, i]. Each
     maximal clique is counted once, at its lowest-ranked member.

Four device programs of gms_tpu carry this path besides build_local_adj
(K4, k_clique.py), and two more the direct=True variant; each is a
hand-written CUDA kernel here (csrc/):

    symmetrize_bits        csrc/bk_symmetrize.cu  (_symmetrize_bits, :406)
    hub_cover_bits         csrc/bk_cover.cu       (_gather_wlists, :876, and
                                                   _hub_cover_bits, :376)
    bk_stack_machine       csrc/bk_stack.cu       (bk_stack_machine, :550)
    decode_clique_members  csrc/bk_decode.cu      (decode_clique_members, :832)
    init_items             csrc/bk_init.cu        (init_items, :254)
    bk_direct_stack        csrc/bk_direct.cu      (the search of
                                                   bk_count_chunk, :131)

bk_stack_machine and bk_direct_stack walk their trees with one core,
csrc/bk_walk.cuh: the root's rows in the warp's registers up to W = 128,
K9's leaf filter as a running cover on the path, the wider pivot by
bit-sliced counters.

The direct=True variant, as gms_tpu's (:1115-1140): roots of degree above
hub_threshold (at most 1024) take the fused path; the others are cut into
degree tiers of the undirected graph padded at lane 32, and per chunk
`bk_count_chunk` builds the local adjacency of each root's full
neighbourhood (K4), its starting sets cand = the higher-ranked neighbours
and fini = the lower-ranked ones (K35), and counts the maximal cliques by
the Tomita search over (cand, fini) (K36), which needs no leaf filter.

Each wrapper checks device, dtype, shape and contiguity; for CPU tensors it
runs its `*_plain` PyTorch version, for CUDA tensors it launches the kernel
(raising if the launch fails) and adds one to `LAUNCHES[name]` per launch.
Bit words are int32 tensors carrying gms_tpu's uint32 bits; counts are
int64.

What gms_tpu's stack machine does only for its platform is not ported: the
adaptive pop window, band-sort compaction, leaf buffer and flush blocks, the
stack and output capacities with their overflow flag and split-and-retry,
and the `iter_budget` segments with resumable state (a dispatch watchdog).
The depth-first kernel keeps one node per level of a warp's path, so in
count mode nothing can overflow; enumerate mode counts first and sizes its
output exactly. K36 walks its tree depth-first too, with a path sized from
the core bound, so `bk_count_async`'s split-and-retry is never entered.
`_bk_fused(devices=)` and `bk_count_async(devices=)` place the plan on every
device and hand out the jobs round-robin (parallel/multi.py's fan-out).
"""

from __future__ import annotations

import numpy as np
import torch

from gms_tpu_torch import _kernels
from gms_tpu_torch.algorithms.k_clique import (
    _bucket, _check_adj, _extent, build_local_adj, build_local_adj_plain,
    pack_bits, plan_tier_chunks, unpack_bits)
from gms_tpu_torch.algorithms.triangle_count import (
    _check, _on_cuda, _zero, popcount32)
from gms_tpu_torch.device import resolve
from gms_tpu_torch.graphs.csr import CSRGraph
from gms_tpu_torch.graphs.tiles import PaddedGraph, SENTINEL
from gms_tpu_torch.preprocessing import degeneracy, orient

DEFAULT_ROOT_CHUNK = 4096

_SENT = int(SENTINEL)

# Kernel launches per wrapper, counted only where the CUDA kernel launches.
LAUNCHES = dict.fromkeys(("symmetrize_bits", "hub_cover_bits",
                          "bk_stack_machine", "decode_clique_members",
                          "init_items", "bk_direct_stack"), 0)

# elements per step of the plain versions' broadcast tensors
_PLAIN_BUDGET = 1 << 24

# The queue of donated nodes of K9 and K36 (csrc/bk_walk.cuh) holds at most
# _QUEUE_NODES nodes and _QUEUE_BYTES bytes; the kernels choose their own
# grid and where their search paths lie
_QUEUE_NODES = 1 << 20
_QUEUE_BYTES = 1 << 28

_INT32_MAX = int(np.iinfo(np.int32).max)

# The parts of a walk's per-warp cycle split (csrc/bk_walk.cuh's WalkPart)
WALK_PARTS = ("walk", "pivot", "child", "leaf", "wait")


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# host planning (numpy, as in gms_tpu)
# ---------------------------------------------------------------------------

def _lower_neighbor_csr(g: CSRGraph, rank: np.ndarray):
    """CSR of each vertex's lower-ranked neighbours, (indptr int32[n+1],
    cols int32[E_lo]); gms_tpu's, unchanged (one SENTINEL column when there
    are none, so device gathers stay defined)."""
    deg = g.degrees.astype(np.int64)
    rows = np.repeat(np.arange(g.num_nodes, dtype=np.int32), deg)
    lower = rank[g.indices] < rank[rows]
    counts = np.bincount(rows[lower], minlength=g.num_nodes).astype(np.int64)
    indptr = np.zeros(g.num_nodes + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    cols = g.indices[lower]
    if not len(cols):
        cols = np.full(1, SENTINEL, np.int32)
    return indptr.astype(np.int32), np.ascontiguousarray(cols)


def _indeg_sub_chunks(chunk, WW: int, indeg_all, pad_id,
                      words_budget: int = 1 << 24):
    """Split a tier chunk into sub-chunks bounded by the cover budget
    C_sub · IN · WW words and grouped by in-degree bucket, so IN stays
    within 2x of every member's in-degree (the leaf filter pays IN · WW
    words per leaf). gms_tpu's, unchanged."""
    real = chunk[chunk != pad_id]
    if not len(real):
        return
    order = np.argsort(indeg_all[real], kind="stable")
    real = real[order]
    ind = np.maximum(indeg_all[real], 1)
    bucket_of = np.ceil(np.log2(np.maximum(ind, 32))).astype(np.int32)
    s = 0
    while s < len(real):
        e = s + 1
        while e < len(real):
            if bucket_of[e] != bucket_of[s]:
                break
            inp = max(32, int(ind[e]))
            if _bucket(e + 1 - s) * inp * WW > words_budget:
                break
            e += 1
        size = _bucket(e - s)
        sub = np.full(size, pad_id, np.int32)
        sub[: e - s] = real[s:e]
        yield sub
        s = e


def cover_width(chunk, indeg_all, pad_id) -> int:
    """IN of a sub-chunk: the largest in-degree of its real roots, rounded
    up to a power of two, at least 32 (gms_tpu's _bk_fused.plan, whose other
    sizes shape its work stack and have no counterpart)."""
    real = chunk[chunk != pad_id]
    mx = int(indeg_all[real].max(initial=1)) if len(real) else 1
    return max(32, 1 << int(np.ceil(np.log2(max(mx, 1)))))


class BKPlan:
    """The device inputs of the Bron–Kerbosch path: the oriented graph
    padded at lane 32 (`padded`), the lower-neighbour CSR on the device
    (`lo_indptr`, `lo_cols`) and the jobs, [(chunk int32[C] on the device,
    w_words, in_width)]; `dag_deg` and `indeg` are the host's out- and
    in-degrees."""

    def __init__(self, g: CSRGraph, rank: np.ndarray, roots: np.ndarray, *,
                 device="cuda", root_chunk: int = DEFAULT_ROOT_CHUNK):
        dev = resolve(device)
        dag = orient.orient(g, rank)
        self.padded = PaddedGraph.from_csr(dag, device=dev, lane=32)
        self.dag_deg = np.asarray(dag.degrees)
        pad_id = np.int32(self.padded.v_pad)  # clips to the guard row
        lo_indptr, lo_cols = _lower_neighbor_csr(g, rank)
        self.indeg = (lo_indptr[1:] - lo_indptr[:-1]).astype(np.int32)
        self.lo_indptr = torch.from_numpy(lo_indptr).to(dev)
        self.lo_cols = torch.from_numpy(lo_cols).to(dev)
        self.jobs = []
        for tchunk, ww in plan_tier_chunks(self.dag_deg, roots, pad_id,
                                           root_chunk=root_chunk):
            for chunk in _indeg_sub_chunks(tchunk, ww, self.indeg, pad_id):
                self.jobs.append((torch.from_numpy(chunk).to(dev), ww,
                                  cover_width(chunk, self.indeg, pad_id)))


# ---------------------------------------------------------------------------
# K8: cover bitsets
# ---------------------------------------------------------------------------

def gather_wlists(lo_indptr, lo_cols, chunk, *, in_width: int):
    """int32[C, in_width] lower-neighbour lists of a chunk's roots, SENTINEL
    beyond each list: gms_tpu's _gather_wlists (:876). Roots >= n (pad ids)
    have none."""
    n = lo_indptr.shape[0] - 1
    ch = chunk.long()
    ptr = lo_indptr.long()
    safe = ch.clamp(0, n - 1)
    start = ptr[safe]
    cnt = torch.where(ch < n, ptr[safe + 1] - start, 0)
    ii = torch.arange(in_width, device=chunk.device)
    idx = (start[:, None] + ii).clamp(0, lo_cols.shape[0] - 1)
    return torch.where(ii < cnt[:, None], lo_cols[idx], _SENT)


def hub_cover_bits_plain(dag_nbr, lo_indptr, lo_cols, chunk, *,
                         in_width: int, w_words: int):
    """Plain version of hub_cover_bits: gather_wlists, then gms_tpu's
    broadcast compare, trimmed to each row's last non-SENTINEL slot, in
    steps of at most _PLAIN_BUDGET compares. It needs no sorted rows."""
    V, D = dag_nbr.shape
    W = 32 * w_words
    C = chunk.shape[0]
    wl = gather_wlists(lo_indptr, lo_cols, chunk, in_width=in_width)
    q = dag_nbr[chunk.long().clamp(0, V - 1), :min(W, D)]
    if q.shape[1] < W:
        q = torch.cat([q, q.new_full((C, W - q.shape[1]), _SENT)], 1)
    qvalid = q != _SENT
    nq = max(1, int(_extent(qvalid).max())) if C else 1
    rows = wl.long().clamp(0, V - 1)
    lens = _extent(dag_nbr != _SENT)[rows]
    dt = max(1, int(lens.max())) if lens.numel() else 1
    nbr = dag_nbr[:, :dt]
    M = torch.zeros((C, in_width, w_words), dtype=torch.int32,
                    device=dag_nbr.device)
    per_root = in_width * nq * dt
    cg = max(1, _PLAIN_BUDGET // per_root)
    ib = in_width if cg > 1 else max(1, _PLAIN_BUDGET // (nq * dt))
    for c0 in range(0, C, cg):
        qg, vg = q[c0:c0 + cg, :nq], qvalid[c0:c0 + cg, :nq]
        for i0 in range(0, in_width, ib):
            r = nbr[rows[c0:c0 + cg, i0:i0 + ib]]             # [c, ib, dt]
            m = (r[:, :, None, :] == qg[:, None, :, None]).any(3)
            m &= vg[:, None, :]                                # [c, ib, nq]
            m = torch.cat([m, m.new_zeros((*m.shape[:2], W - nq))], 2)
            M[c0:c0 + cg, i0:i0 + r.shape[1]] = pack_bits(m)
    return M, wl != _SENT


def hub_cover_bits(dag_nbr, lo_indptr, lo_cols, chunk, *, in_width: int,
                   w_words: int):
    """Cover bitsets of a chunk's roots for the leaf maximality filter.

    dag_nbr:   int32[V_pad, D] oriented padded adjacency, rows strictly
               ascending with a SENTINEL tail (the kernel binary-searches
               the root's slots, as build_local_adj's does)
    lo_indptr: int32[n+1], lo_cols: int32[E_lo] lower-neighbour CSR
    chunk:     int32[C] root ids; pad ids (>= n) have no lower neighbours
    Returns (M int32[C, in_width, w_words], wvalid bool[C, in_width]): with
    w_i the root's i-th lower neighbour (SENTINEL beyond its count), bit j
    of M[c, i] is set iff the root's DAG slot j is not SENTINEL and lies in
    N⁺(w_i); wvalid[c, i] iff w_i is not SENTINEL. Bit for bit gms_tpu's
    _hub_cover_bits(dag_nbr, roots, _gather_wlists(...)) (:376, :876).
    """
    name = "hub_cover_bits"
    _check(name, "dag_nbr", dag_nbr, 2)
    _check(name, "lo_indptr", lo_indptr, 1)
    _check(name, "lo_cols", lo_cols, 1)
    _check(name, "chunk", chunk, 1)
    if w_words < 1 or in_width < 1:
        raise ValueError(f"{name}: w_words and in_width must be >= 1, got "
                         f"{w_words}, {in_width}")
    if lo_indptr.shape[0] < 2 or lo_cols.shape[0] < 1:
        raise ValueError(f"{name}: the lower-neighbour CSR is empty")
    if not _on_cuda(name, dag_nbr, lo_indptr, lo_cols, chunk):
        return hub_cover_bits_plain(dag_nbr, lo_indptr, lo_cols, chunk,
                                    in_width=in_width, w_words=w_words)
    C = chunk.shape[0]
    M = torch.empty((C, in_width, w_words), dtype=torch.int32,
                    device=dag_nbr.device)
    wvalid = torch.empty((C, in_width), dtype=torch.bool,
                         device=dag_nbr.device)
    _kernels.launch("bk_cover", "hub_cover_bits", dag_nbr, dag_nbr.shape[0],
                    dag_nbr.shape[1], lo_indptr, lo_indptr.shape[0] - 1,
                    lo_cols, lo_cols.shape[0], chunk, C, w_words, in_width, M,
                    wvalid)
    LAUNCHES[name] += 1
    return M, wvalid


# ---------------------------------------------------------------------------
# K7: symmetrize
# ---------------------------------------------------------------------------

def symmetrize_bits_plain(adj):
    """Plain version of symmetrize_bits: unpack, OR with the transpose,
    pack, a group of roots at a time."""
    C, W, WW = adj.shape
    out = torch.empty_like(adj)
    cg = max(1, _PLAIN_BUDGET // (W * W))
    for c0 in range(0, C, cg):
        bits = unpack_bits(adj[c0:c0 + cg])                    # [c, W, W]
        out[c0:c0 + cg] = pack_bits(bits | bits.transpose(1, 2))
    return out


def symmetrize_bits(adj):
    """adj[c, i, j] | adj[c, j, i] over int32[C, W, WW], W = 32*WW: the
    undirected induced adjacency from build_local_adj's oriented one.
    gms_tpu's _symmetrize_bits (:406), bit for bit; a new tensor."""
    name = "symmetrize_bits"
    _check_adj(name, adj)
    if not _on_cuda(name, adj):
        return symmetrize_bits_plain(adj)
    out = torch.empty_like(adj)
    _kernels.launch("bk_symmetrize", "symmetrize_bits", adj, adj.shape[0],
                    adj.shape[2], out)
    LAUNCHES[name] += 1
    return out


# ---------------------------------------------------------------------------
# K9: the Tomita-pivot search
# ---------------------------------------------------------------------------

def _below_words(W: int, WW: int, device) -> torch.Tensor:
    """int32[W, WW]: row i = the bits below i."""
    i = torch.arange(W, device=device)
    return pack_bits(i[None, :] < i[:, None])


def _check_stack_inputs(name, adj, S0, live0, M, wvalid):
    _check_adj(name, adj)
    _check(name, "S0", S0, 2)
    _check(name, "M", M, 3)
    C, W, WW = adj.shape
    if S0.shape != (C, WW) or M.shape[0] != C or M.shape[2] != WW:
        raise ValueError(f"{name}: S0 {tuple(S0.shape)} or M "
                         f"{tuple(M.shape)} does not match adj {(C, W, WW)}")
    for what, t, shape in (("live0", live0, (C,)),
                           ("wvalid", wvalid, tuple(M.shape[:2]))):
        if t.dtype != torch.bool or tuple(t.shape) != shape:
            raise TypeError(f"{name}: {what} must be bool {shape}, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")


def _pivot_need(member, cand):
    """The pivot scores' words a batch of nodes needs, the cheaper of two
    ways a node: each member of cand ∪ fini scored on cand's nonzero words,
    or each member of cand's row added to every score."""
    WW = cand.shape[1]
    return torch.minimum(member.sum(1) * (cand != 0).sum(1),
                         popcount32(cand).sum(1) * WW).sum()


def _covered(R, root, M, wvalid):
    """bool[B]: whether some valid lower neighbour w of root covers R (R ⊆
    M[root, w]), in steps of at most _PLAIN_BUDGET words."""
    step = max(1, _PLAIN_BUDGET // (M.shape[1] * M.shape[2]))
    out = torch.zeros(R.shape[0], dtype=torch.bool, device=R.device)
    for p in range(0, R.shape[0], step):
        rp = root[p:p + step]
        out[p:p + step] = (((R[p:p + step, None, :] & ~M[rp]) == 0).all(2)
                           & wvalid[rp]).any(1)
    return out


def bk_stack_machine_plain(adj, S0, live0, M, wvalid, *, emit: bool = False,
                           stats: dict | None = None):
    """Plain version of bk_stack_machine: the same tree, expanded
    breadth-wise in batches of nodes (cand, fini, R, root) kept in a LIFO
    so memory stays bounded; leaves are filtered in batches.

    With `stats`, adds the tree's word operations by type:
    stats["popc_ops"], the popcounts of the pivot scores (|cand ∪ fini|·WW
    per expanded node), and stats["bit_ops"], the 32-bit bitwise operations
    — the pivot scores' ANDs, 2·WW per child (cand' and fini', one
    three-input AND/OR each) and, per leaf tested, (|R| + 1) words of the
    transposed cover over the root's valid rows, (|R| + 1)·⌈indeg / 32⌉;
    and what the function needs at least: stats["popc_need"], the pivot
    scores' words by the cheaper of two ways a node (|cand ∪ fini| · cand's
    nonzero words, or |cand| · WW, each member's row added to every score),
    stats["child_ops"], the 2·WW words of each child, and
    stats["cover_ops"], a running cover's ⌈indeg / 32⌉ words for each child
    formed (searched or leaf) whose parent's cover is not empty.
    """
    C, W, WW = adj.shape
    IN = M.shape[1]
    dev = adj.device
    below = _below_words(W, WW, dev)
    onehot = pack_bits(torch.eye(W, dtype=torch.bool, device=dev))
    total, popc, bit = _zero(dev), _zero(dev), _zero(dev)
    popc_need, cover, kids = _zero(dev), _zero(dev), 0
    in_words = (wvalid.sum(1) + 31) // 32
    rows = []

    def leaves(R, root):
        nonlocal total, bit
        lb = max(1, _PLAIN_BUDGET // (IN * WW))
        for p0 in range(0, R.shape[0], lb):
            Rp, rp = R[p0:p0 + lb], root[p0:p0 + lb]
            cov = ((Rp[:, None, :] & ~M[rp]) == 0).all(2) & wvalid[rp]
            ok = ~cov.any(1)
            total += ok.sum()
            bit += ((popcount32(Rp).sum(1) + 1) * in_words[rp]).sum()
            if emit:
                rows.append(torch.cat([Rp[ok], rp[ok, None].to(torch.int32)],
                                      1))

    s0_empty = (S0 == 0).all(1)
    r0 = (live0 & s0_empty).nonzero()[:, 0]
    leaves(S0.new_zeros((r0.shape[0], WW)), r0)
    work = (live0 & ~s0_empty).nonzero()[:, 0]
    zero = S0.new_zeros((work.shape[0], WW))
    stack = [(S0[work], zero, zero, work)]
    batch = max(1, _PLAIN_BUDGET // (W * WW))
    while stack:
        cand, fini, R, root = stack.pop()
        if cand.shape[0] > batch:
            stack.append((cand[batch:], fini[batch:], R[batch:], root[batch:]))
            cand, fini, R, root = cand[:batch], fini[:batch], R[:batch], \
                root[:batch]
        A = adj[root]                                          # [B, W, WW]
        member = unpack_bits(cand | fini)                      # [B, W]
        scores = popcount32(cand[:, None, :] & A).sum(2)
        pivot = torch.where(member, scores, -1).argmax(1)      # first max
        popc += member.sum() * WW
        ext = cand & ~A[torch.arange(A.shape[0], device=dev), pivot]
        item, i = unpack_bits(ext).nonzero(as_tuple=True)
        if stats is not None:
            popc_need += _pivot_need(member, cand)
            kids += 2 * WW * item.shape[0]
            live = _covered(R, root, M, wvalid)
            cover += (live[item] * in_words[root[item]]).sum()
        extb = ext[item] & below[i]
        ai = A[item, i]
        cC = (cand[item] & ~extb) & ai
        cF = (fini[item] | extb) & ai
        cR = R[item] | onehot[i]
        bit += member.sum() * WW + 2 * WW * item.shape[0]
        c_empty = (cC == 0).all(1)
        leaf = c_empty & (cF == 0).all(1)
        if leaf.any():
            leaves(cR[leaf], root[item[leaf]])
        if not c_empty.all():
            push = ~c_empty
            stack.append((cC[push], cF[push], cR[push], root[item[push]]))
    if stats is not None:
        for key, n in (("popc_ops", popc), ("bit_ops", bit),
                       ("popc_need", popc_need), ("child_ops", kids),
                       ("cover_ops", cover)):
            stats[key] = stats.get(key, 0) + int(n)
    if not emit:
        return total
    out = torch.cat(rows) if rows else adj.new_zeros((0, WW + 1))
    return total, out


def _no_cpu_stats(name: str, stats: dict | None) -> None:
    """A walk's `stats` are its kernel's counters, which a CPU tensor does
    not reach."""
    if stats is not None:
        raise ValueError(f"{name}: stats= reads the kernel's counters, and "
                         f"the inputs lie on the CPU; {name}_plain(stats=) "
                         f"counts the tree's operations")


def _walk_stats(ctl, stats: dict) -> None:
    """Reads back a walk's counters from its control words (the fourth
    line): the items its warps took (root items and queued nodes), the most
    one warp took, the warps, the per-warp cycles by part (WALK_PARTS),
    summed over warps, the children formed (steps), the pivots taken
    (nodes) and the children formed on a path level in device memory
    (deep_steps)."""
    n = len(WALK_PARTS)
    vals = ctl[49:55 + n].tolist()
    stats.update(items=vals[0], max_items=vals[1], warps=vals[2],
                 cycles=dict(zip(WALK_PARTS, vals[3:3 + n])),
                 steps=vals[3 + n], nodes=vals[4 + n],
                 deep_steps=vals[5 + n])


def _launch_stack(adj, S0, live0, M, wvalid, total, out=None, stats=None):
    """One launch of K9 (csrc/bk_stack.cu): a count pass, or with `out` an
    emit pass writing out.shape[0] rows; with `stats`, the counting
    instantiation, read back by _walk_stats."""
    C, W, WW = adj.shape
    dev = adj.device
    stride = 3 * WW + 2  # a queued node: cand | fini | R | root | level
    cap = max(1024, min(_QUEUE_NODES, _QUEUE_BYTES // (stride * 4)))
    ctl = torch.zeros(64, dtype=torch.int64, device=dev)  # 4 lines
    _kernels.launch(
        "bk_stack", "bk_stack", adj, S0, live0, C, WW, M, wvalid, M.shape[1],
        torch.empty(C + 2, dtype=torch.int64, device=dev),
        torch.empty(C * WW, dtype=torch.int32, device=dev),
        torch.empty(C * (W + 1) * -(-M.shape[1] // 32), dtype=torch.int32,
                    device=dev),
        ctl, torch.empty(cap * stride, dtype=torch.int32, device=dev),
        torch.zeros(cap, dtype=torch.int32, device=dev), cap, out,
        0 if out is None else out.shape[0], int(stats is not None), total)
    LAUNCHES["bk_stack_machine"] += 1
    if stats is not None:
        _walk_stats(ctl, stats)


def bk_stack_machine(adj, S0, live0, M, wvalid, *, emit: bool = False,
                     stats: dict | None = None):
    """The globally maximal cliques rooted at a chunk, from its prebuilt
    local universe: adj int32[C, W, WW] symmetrized induced adjacency, S0
    int32[C, WW] initial candidates, live0 bool[C] real roots, M int32[C,
    IN, WW] / wvalid bool[C, IN] cover bitsets (hub_cover_bits). gms_tpu's
    bk_stack_machine (:550), with the same inputs, so that a port of its
    sharded plan can reuse it.

    Count mode: int64 0-d tensor, no read-back. emit=True: (count, out
    int32[count, WW+1]), each row (R bits | root-local index) as gms_tpu's
    OUT rows (the order of rows may differ); the kernel counts first, reads
    the count back and sizes `out` exactly, so it cannot overflow.

    With `stats` the count pass reads back stats["items"] (the items its
    warps took: the root items and the queued nodes), stats["max_items"]
    (the most one warp took), stats["warps"], stats["cycles"], the warps'
    cycles by part of the walk (WALK_PARTS), summed, stats["steps"], the
    children formed, stats["nodes"], the pivots taken, and
    stats["deep_steps"], the children formed on a path level in device
    memory. These are the kernel's counters: on the CPU `stats` raises
    (bk_stack_machine_plain's `stats` counts the tree's operations).
    """
    name = "bk_stack_machine"
    _check_stack_inputs(name, adj, S0, live0, M, wvalid)
    if not _on_cuda(name, adj, S0, live0, M, wvalid):
        _no_cpu_stats(name, stats)
        return bk_stack_machine_plain(adj, S0, live0, M, wvalid, emit=emit)
    total = _zero(adj.device)
    _launch_stack(adj, S0, live0, M, wvalid, total, stats=stats)
    if not emit:
        return total
    out = torch.empty((int(total), adj.shape[2] + 1), dtype=torch.int32,
                      device=adj.device)
    if out.shape[0]:
        _launch_stack(adj, S0, live0, M, wvalid, _zero(adj.device), out)
    return total, out


def bk_fused_chunk(dag_nbr, chunk, M, wvalid, *, w_words: int,
                   emit: bool = False):
    """Count (or, with emit, enumerate) the globally maximal cliques rooted
    at `chunk`: gms_tpu's bk_fused_chunk (:483) — build_local_adj (K4),
    symmetrize_bits (K7), bk_stack_machine (K9). Pad slots hold V_pad."""
    adj, s0 = build_local_adj(dag_nbr, chunk, w_words=w_words)
    adj = symmetrize_bits(adj)
    live0 = chunk != dag_nbr.shape[0]
    return bk_stack_machine(adj, s0, live0, M, wvalid, emit=emit)


# ---------------------------------------------------------------------------
# the direct=True variant: K35 starting sets, K36 the search
# ---------------------------------------------------------------------------

def init_items_plain(nbr, rank_pad, roots, *, w_words: int):
    """Plain version of init_items: gms_tpu's gathers and compares."""
    V, D = nbr.shape
    W = 32 * w_words
    C = roots.shape[0]
    r_nbr = nbr[roots.long().clamp(0, V - 1), :min(W, D)]
    if r_nbr.shape[1] < W:
        r_nbr = torch.cat([r_nbr, r_nbr.new_full((C, W - r_nbr.shape[1]),
                                                 _SENT)], 1)
    valid = r_nbr != _SENT
    nr = rank_pad.shape[0]
    nbr_rank = rank_pad[r_nbr.long().clamp(0, nr - 1)]
    root_rank = rank_pad[roots.long().clamp(0, nr - 1)]
    higher = valid & (nbr_rank > root_rank[:, None])
    return pack_bits(higher), pack_bits(valid & ~higher)


def init_items(nbr, rank_pad, roots, *, w_words: int):
    """The starting sets of each root's direct search: (cand, fini), each
    int32[C, w_words], over the first W = 32*w_words slots of the root's
    padded row: bit j of cand iff slot j holds a neighbour ranked above the
    root, of fini iff it holds one ranked at or below it. nbr int32[V_pad,
    D] padded rows (roots clip to [0, V_pad-1]), rank_pad int32[n_rank]
    ranks (ids clip to [0, n_rank-1]; gms_tpu pads it with INT32_MAX), roots
    int32[C]. gms_tpu's init_items (:254), bit for bit."""
    name = "init_items"
    _check(name, "nbr", nbr, 2)
    _check(name, "rank_pad", rank_pad, 1)
    _check(name, "roots", roots, 1)
    if w_words < 1 or rank_pad.shape[0] < 1:
        raise ValueError(f"{name}: w_words ({w_words}) and rank_pad's "
                         f"length ({rank_pad.shape[0]}) must be >= 1")
    if not _on_cuda(name, nbr, rank_pad, roots):
        return init_items_plain(nbr, rank_pad, roots, w_words=w_words)
    C = roots.shape[0]
    cand = torch.empty((C, w_words), dtype=torch.int32, device=nbr.device)
    fini = torch.empty_like(cand)
    _kernels.launch("bk_init", "init_items", nbr, nbr.shape[0], nbr.shape[1],
                    rank_pad, rank_pad.shape[0], roots, C, w_words, cand,
                    fini)
    LAUNCHES[name] += 1
    return cand, fini


def _check_direct_inputs(name, adj, cand0, fini0, live0):
    _check_adj(name, adj)
    C, _, WW = adj.shape
    for what, t in (("cand0", cand0), ("fini0", fini0)):
        _check(name, what, t, 2)
        if t.shape != (C, WW):
            raise ValueError(f"{name}: {what} {tuple(t.shape)} does not "
                             f"match adj {tuple(adj.shape)}")
    if live0.dtype != torch.bool or tuple(live0.shape) != (C,):
        raise TypeError(f"{name}: live0 must be bool {(C,)}, got "
                        f"{live0.dtype} {tuple(live0.shape)}")
    if not live0.is_contiguous():
        raise ValueError(f"{name}: live0 must be contiguous")


def bk_direct_stack_plain(adj, cand0, fini0, live0, *,
                          depth: int | None = None,
                          stats: dict | None = None):
    """Plain version of bk_direct_stack: the same tree expanded breadth-wise
    in batches of nodes (cand, fini, root) kept in a LIFO. It counts every
    maximal clique; its overflow says whether the kernel's path of `depth`
    levels would have been too short (a searched node at level >= depth,
    the root's children being level 0).

    With `stats`, adds the tree's word operations by type, as
    bk_stack_machine_plain: stats["popc_ops"], |cand ∪ fini|·WW per expanded
    node (the pivot's popcounts), stats["bit_ops"], the pivot's ANDs and
    2·WW per child, and what the function needs at least:
    stats["popc_need"], the pivot scores' words by the cheaper of two ways
    a node (|cand ∪ fini| · cand's nonzero words, or |cand| · WW), and
    stats["child_ops"], the 2·WW words of each child.
    """
    C, W, WW = adj.shape
    dev = adj.device
    below = _below_words(W, WW, dev)
    c_empty = (cand0 == 0).all(1)
    total = (live0 & c_empty & (fini0 == 0).all(1)).sum()
    popc, bit, popc_need, kids = _zero(dev), _zero(dev), _zero(dev), 0
    work = (live0 & ~c_empty).nonzero()[:, 0]
    stack = [(cand0[work], fini0[work], work, -1)]
    batch = max(1, _PLAIN_BUDGET // (W * WW))
    overflow = False
    while stack:
        cand, fini, root, level = stack.pop()
        if cand.shape[0] > batch:
            stack.append((cand[batch:], fini[batch:], root[batch:], level))
            cand, fini, root = cand[:batch], fini[:batch], root[:batch]
        A = adj[root]                                          # [B, W, WW]
        member = unpack_bits(cand | fini)                      # [B, W]
        scores = popcount32(cand[:, None, :] & A).sum(2)
        pivot = torch.where(member, scores, -1).argmax(1)      # first max
        ext = cand & ~A[torch.arange(A.shape[0], device=dev), pivot]
        item, i = unpack_bits(ext).nonzero(as_tuple=True)
        extb = ext[item] & below[i]
        ai = A[item, i]
        cC = (cand[item] & ~extb) & ai
        cF = (fini[item] | extb) & ai
        popc += member.sum() * WW
        popc_need += _pivot_need(member, cand)
        kids += 2 * WW * item.shape[0]
        bit += member.sum() * WW + 2 * WW * item.shape[0]
        ce = (cC == 0).all(1)
        total += (ce & (cF == 0).all(1)).sum()
        if not ce.all():
            overflow |= depth is not None and level + 1 >= depth
            push = ~ce
            stack.append((cC[push], cF[push], root[item[push]], level + 1))
    if stats is not None:
        for key, n in (("popc_ops", popc), ("bit_ops", bit),
                       ("popc_need", popc_need), ("child_ops", kids)):
            stats[key] = stats.get(key, 0) + int(n)
    return total, torch.tensor(overflow, device=dev)


def bk_direct_stack(adj, cand0, fini0, live0, *, depth: int | None = None,
                    stats: dict | None = None):
    """The maximal cliques rooted at a chunk, by the Tomita search over
    each root's full neighbourhood: adj int32[C, W, WW] the undirected local
    adjacency (build_local_adj of the undirected padded rows), cand0, fini0
    int32[C, WW] (init_items), live0 bool[C] the real roots. The search of
    gms_tpu's bk_count_chunk (:131), with the same tree.

    `depth` is the kernel's path length, min(W, core bound) + 2 in
    bk_count_async (default W + 1, which no tree exceeds). Returns (count
    int64 0-d, overflow bool 0-d), no read-back; overflow means a path was
    too short and the count is short. With `stats` the kernel's run reads
    back stats["items"] (the items its warps took: the root items and the
    queued nodes), stats["max_items"] (the most one warp took),
    stats["warps"], stats["cycles"], stats["steps"], stats["nodes"] and
    stats["deep_steps"], as bk_stack_machine's; on the CPU `stats` raises
    (bk_direct_stack_plain's `stats` counts the tree's operations).
    """
    name = "bk_direct_stack"
    _check_direct_inputs(name, adj, cand0, fini0, live0)
    C, W, WW = adj.shape
    depth = W + 1 if depth is None else depth
    if depth < 1:
        raise ValueError(f"{name}: depth must be >= 1, got {depth}")
    if not _on_cuda(name, adj, cand0, fini0, live0):
        _no_cpu_stats(name, stats)
        return bk_direct_stack_plain(adj, cand0, fini0, live0, depth=depth)
    dev = adj.device
    stride = 2 * WW + 2  # a queued node: cand | fini | root | level
    cap = max(1024, min(_QUEUE_NODES, _QUEUE_BYTES // (stride * 4)))
    total = _zero(dev)
    ctl = torch.zeros(64, dtype=torch.int64, device=dev)  # 4 lines
    _kernels.launch(
        "bk_direct", "bk_direct_stack", adj, cand0, fini0, live0, C, WW,
        depth, torch.empty(C + 2, dtype=torch.int64, device=dev),
        torch.empty(C * WW, dtype=torch.int32, device=dev), ctl,
        torch.empty(cap * stride, dtype=torch.int32, device=dev),
        torch.zeros(cap, dtype=torch.int32, device=dev), cap,
        int(stats is not None), total)
    LAUNCHES[name] += 1
    if stats is not None:
        _walk_stats(ctl, stats)
    return total, ctl[48] != 0


def bk_count_chunk_plain(nbr, rank_pad, chunk, root_live, *, w_words: int,
                         depth: int | None = None):
    """Plain version of bk_count_chunk: the plain versions of K4, K35 and
    K36."""
    adj, _ = build_local_adj_plain(nbr, chunk, w_words=w_words)
    cand, fini = init_items_plain(nbr, rank_pad, chunk, w_words=w_words)
    return bk_direct_stack_plain(adj, cand, fini, root_live, depth=depth)


def bk_count_chunk(nbr, rank_pad, chunk, root_live, *, w_words: int,
                   depth: int | None = None):
    """The maximal cliques rooted at one chunk, direct variant: gms_tpu's
    bk_count_chunk (:131) — build_local_adj (K4) over the undirected padded
    rows nbr, init_items (K35), bk_direct_stack (K36). chunk int32[C] root
    ids (pad ids V_pad), root_live bool[C]; every root's degree fits W =
    32*w_words. Returns (count int64 0-d, overflow bool 0-d). Its capacity,
    batch and iter_budget shaped gms_tpu's stack and have no counterpart;
    `depth` is K36's path length."""
    adj, _ = build_local_adj(nbr, chunk, w_words=w_words)
    cand, fini = init_items(nbr, rank_pad, chunk, w_words=w_words)
    return bk_direct_stack(adj, cand, fini, root_live, depth=depth)


def _read_back(outs):
    """[(tensors on one device)] -> their values as lists: one stack and one
    copy to the host per device."""
    by_dev = {}
    for j, ts in enumerate(outs):
        by_dev.setdefault(ts[0].device, []).append(
            (j, torch.stack([t.to(torch.int64) for t in ts])))
    vals = [None] * len(outs)
    for group in by_dev.values():
        for (j, _), v in zip(group, torch.stack([x for _, x in group])
                             .tolist()):
            vals[j] = v
    return vals


def _placed(tensors):
    """device -> `tensors` on that device, copied there on first use."""
    cache = {tensors[0].device: tensors}

    def on(dev):
        if dev not in cache:
            cache[dev] = tuple(t.to(dev) for t in tensors)
        return cache[dev]

    return on


def bk_count_async(nbr, rank_pad, chunks, devices=None, *,
                   core_bound: int | None = None) -> int:
    """Count the maximal cliques of every (chunk, w_words) job with
    bk_count_chunk, jobs round-robin over `devices` (default: nbr's), every
    job launched before the one read-back a device. gms_tpu's
    bk_count_async (:290).

    K36's path takes min(W, core_bound) + 2 levels (W + 1 without a bound):
    a node at level d holds d + 1 of the root's higher-ranked neighbours, so
    with the orientation's largest out-degree as core_bound no path is too
    short and no chunk overflows. gms_tpu's retry stays for a wrong bound,
    and a kernel that reports no overflow never enters it: an overflowed
    chunk splits its roots in half (same padded shape), a single root
    doubles its depth; after 12 retries it raises. gms_tpu's words_budget,
    max_inflight and batch shaped its stack capacity and have no
    counterpart.
    """
    devs = ([nbr.device] if devices is None
            else [resolve(d) for d in devices])
    table = _placed((nbr, rank_pad))
    pad_id = nbr.shape[0]

    def depth_of(ww):
        W = 32 * ww
        return min(W, core_bound) + 2 if core_bound else W + 1

    queue = [(np.asarray(chunk), ww, depth_of(ww), 0) for chunk, ww in chunks]
    total = 0
    while queue:
        outs = []
        for i, (chunk, ww, depth, _) in enumerate(queue):
            dev = devs[i % len(devs)]
            nbr_d, rank_d = table(dev)
            ch = torch.from_numpy(chunk).to(dev)
            outs.append(bk_count_chunk(nbr_d, rank_d, ch, ch != pad_id,
                                       w_words=ww, depth=depth))
        retry = []
        for (chunk, ww, depth, retries), (count, ovf) in zip(
                queue, _read_back(outs)):
            if not ovf:
                total += count
                continue
            if retries > 12:
                raise RuntimeError(
                    "bk_count_chunk (direct=True) overflowed 12 times; the "
                    "core bound given is below the graph's")
            real = chunk[chunk != pad_id]
            if len(real) > 1:  # split roots, keep the padded shape
                h = len(real) // 2
                for part in (real[:h], real[h:]):
                    sub = np.full(len(chunk), pad_id, chunk.dtype)
                    sub[:len(part)] = part
                    retry.append((sub, ww, depth, retries + 1))
            else:
                retry.append((chunk, ww, min(2 * depth, 32 * ww + 1),
                              retries + 1))
        queue = retry
    return total


# ---------------------------------------------------------------------------
# K10: decode
# ---------------------------------------------------------------------------

def decode_clique_members_plain(dag_nbr, chunk, out):
    """Plain version of decode_clique_members."""
    V, D = dag_nbr.shape
    C = chunk.shape[0]
    L, WW = out.shape[0], out.shape[1] - 1
    W = 32 * WW
    gid = chunk[out[:, WW].long().clamp(0, C - 1)]
    rows = dag_nbr[gid.long().clamp(0, V - 1), :min(W, D)]
    if rows.shape[1] < W:
        rows = torch.cat([rows, rows.new_full((L, W - rows.shape[1]), _SENT)],
                         1)
    bit = unpack_bits(out[:, :WW].contiguous())
    return gid, torch.where(bit & (rows != _SENT), rows, -1)


def decode_clique_members(dag_nbr, chunk, out):
    """Emitted rows (R bits | root-local index) -> (gid int32[L], the
    global root ids, members int32[L, W], the root's DAG slots in R, -1 in
    the other lanes). gms_tpu's decode_clique_members (:832)."""
    name = "decode_clique_members"
    _check(name, "dag_nbr", dag_nbr, 2)
    _check(name, "chunk", chunk, 1)
    _check(name, "out", out, 2)
    if out.shape[1] < 2:
        raise ValueError(f"{name}: out rows need WW+1 >= 2 words")
    if not _on_cuda(name, dag_nbr, chunk, out):
        return decode_clique_members_plain(dag_nbr, chunk, out)
    L, WW = out.shape[0], out.shape[1] - 1
    gid = torch.empty(L, dtype=torch.int32, device=out.device)
    members = torch.empty((L, 32 * WW), dtype=torch.int32, device=out.device)
    _kernels.launch("bk_decode", "decode_clique_members", dag_nbr,
                    dag_nbr.shape[0], dag_nbr.shape[1], chunk, chunk.shape[0],
                    out, L, WW, gid, members)
    LAUNCHES[name] += 1
    return gid, members


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------

def ordering_rank(g: CSRGraph, ordering: str) -> np.ndarray:
    """The rank of an ordering of BK-GMS-{DEG, ADG, DGR, SG}."""
    if ordering == "degeneracy":
        return degeneracy.degeneracy_ordering_rank(g)[0]
    if ordering == "adg":
        return degeneracy.adg_ordering_rank(g)
    if ordering == "degree":
        return degeneracy.degree_ordering_rank(g)
    if ordering == "id":
        return np.arange(g.num_nodes, dtype=np.int32)
    raise ValueError(f"unknown ordering {ordering!r}")


def _bk_fused(g: CSRGraph, rank: np.ndarray, roots: np.ndarray, devices, *,
              collect: bool = False, root_chunk: int = DEFAULT_ROOT_CHUNK,
              sink=None):
    """Count (or enumerate) the maximal cliques rooted at `roots`; returns
    (count, cliques or None). The plan is built once and copied to every
    device of `devices`; jobs go round-robin over them (gms_tpu's
    _bk_fused(devices=), :893). In count mode every job's launches are
    enqueued before the one read-back a device; enumerate mode reads each
    job's count back to size its rows."""
    devs = [resolve(d) for d in devices]
    plan = BKPlan(g, rank, roots, device=devs[0], root_chunk=root_chunk)
    table = _placed((plan.padded.nbr, plan.lo_indptr, plan.lo_cols))

    def run(i, chunk, ww, in_w, emit):
        nbr, lo_indptr, lo_cols = table(devs[i % len(devs)])
        chunk = chunk.to(nbr.device)
        m, wv = hub_cover_bits(nbr, lo_indptr, lo_cols, chunk,
                               in_width=in_w, w_words=ww)
        return nbr, chunk, bk_fused_chunk(nbr, chunk, m, wv, w_words=ww,
                                          emit=emit)

    if not collect:
        outs = [(run(i, *job, False)[2],) for i, job in enumerate(plan.jobs)]
        return sum(v[0] for v in _read_back(outs)), None
    total = 0
    cliques: list[frozenset] | None = None if sink is not None else []
    for i, job in enumerate(plan.jobs):
        nbr, chunk, (count, out) = run(i, *job, True)
        total += int(count)
        if not out.shape[0]:
            continue
        gid, members = (t.cpu().numpy() for t in
                        decode_clique_members(nbr, chunk, out))
        if sink is not None:
            sink(gid, members)
            continue
        for l in range(len(gid)):
            ms = members[l]
            cliques.append(frozenset([int(gid[l]), *ms[ms >= 0].tolist()]))
    return total, cliques


def bron_kerbosch(
    g: CSRGraph,
    *,
    device="cuda",
    rank: np.ndarray | None = None,
    ordering: str = "degeneracy",
    root_chunk: int = DEFAULT_ROOT_CHUNK,
    collect: bool = False,
    roots: np.ndarray | None = None,
    hub_threshold: int = 1024,
    direct: bool = False,
    sink=None,
):
    """Count (or enumerate) all maximal cliques of the undirected graph g.

    ordering ∈ {"degeneracy", "adg", "degree", "id"} — the reference's
    BK-GMS-{DEG, ADG, DGR, SG} variants; `rank` overrides it. Returns the
    count (int) if collect=False, else (count, list[frozenset[int]]); with
    `sink`, collect mode calls sink(gid int32[L], members int32[L, W]) with
    each job's decoded cliques as numpy arrays ({gid[l]} ∪ members[l][
    members[l] >= 0]) and returns (count, None). `roots` limits the root
    set: each maximal clique is reported at its lowest-ranked member, so
    disjoint root sets sum exactly (parallel/multi.py fans root chunks out
    over devices through _bk_fused).

    The default is the fused DAG-universe path for every root, with no
    waves, segments or split-and-retry: the depth-first kernel cannot
    overflow in count mode, and enumerate mode sizes its rows from a count
    pass. direct=True counts the roots of degree at most `hub_threshold`
    (capped at 1024, as in gms_tpu) by the full-neighbourhood search
    (bk_count_async) and the rest on the fused path; collect=True always
    takes the fused path, as gms_tpu's.
    """
    dev = resolve(device)
    n = g.num_nodes
    if n == 0:
        return (0, []) if collect else 0
    rank = np.asarray(ordering_rank(g, ordering) if rank is None else rank)
    roots_all = (np.arange(n, dtype=np.int32) if roots is None
                 else np.asarray(roots, dtype=np.int32))
    if not direct or collect:
        total, cliques = _bk_fused(g, rank, roots_all, [dev],
                                   collect=collect, root_chunk=root_chunk,
                                   sink=sink)
        return (total, cliques) if collect else total

    hub_threshold = min(hub_threshold, 1024)
    deg_all = g.degrees
    hub_sel = deg_all[roots_all] > hub_threshold
    hub_roots, roots_all = roots_all[hub_sel], roots_all[~hub_sel]
    total = 0
    if len(hub_roots):
        total, _ = _bk_fused(g, rank, hub_roots, [dev],
                             root_chunk=root_chunk)
    pg = PaddedGraph.from_csr(g, device=dev, lane=32)
    rank_pad = np.full(pg.v_pad + 1, _INT32_MAX, np.int32)
    rank_pad[:n] = rank
    e = g.edge_array()
    higher = rank[e[:, 1]] > rank[e[:, 0]]
    core_bound = int(np.bincount(e[:, 0][higher], minlength=n)
                     .max(initial=1))
    return total + bk_count_async(
        pg.nbr, torch.from_numpy(rank_pad).to(dev),
        plan_tier_chunks(deg_all, roots_all, np.int32(pg.v_pad),
                         root_chunk=root_chunk),
        core_bound=core_bound)


# ---------------------------------------------------------------------------
# host oracle — role of BkSimple (sequential/simple.h:13-61) + verifier.h
# ---------------------------------------------------------------------------

def bron_kerbosch_simple(g: CSRGraph) -> list[frozenset]:
    """Textbook no-pivot BK on the host; the correctness anchor."""
    adj = [set(g.out_neigh(v).tolist()) for v in range(g.num_nodes)]
    out: list[frozenset] = []

    def rec(R: set, P: set, X: set):
        if not P and not X:
            out.append(frozenset(R))
            return
        for v in sorted(P):
            rec(R | {v}, P & adj[v], X & adj[v])
            P = P - {v}
            X = X | {v}

    rec(set(), set(range(g.num_nodes)), set())
    return out


def is_clique(g: CSRGraph, clique) -> bool:
    adj = [set(g.out_neigh(v).tolist()) for v in range(g.num_nodes)]
    cl = list(clique)
    return all(b in adj[a] for i, a in enumerate(cl) for b in cl[i + 1:])


def is_maximal(g: CSRGraph, clique) -> bool:
    adj = [set(g.out_neigh(v).tolist()) for v in range(g.num_nodes)]
    cl = set(clique)
    return not any(cl <= adj[v] for v in range(g.num_nodes) if v not in cl)
