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
(K4, k_clique.py); each is a hand-written CUDA kernel here (csrc/):

    symmetrize_bits        csrc/bk_symmetrize.cu  (_symmetrize_bits, :406)
    hub_cover_bits         csrc/bk_cover.cu       (_gather_wlists, :876, and
                                                   _hub_cover_bits, :376)
    bk_stack_machine       csrc/bk_stack.cu       (bk_stack_machine, :550)
    decode_clique_members  csrc/bk_decode.cu      (decode_clique_members, :832)

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
output exactly. The `direct=True` variant (`bk_count_chunk`, `init_items`)
and the `devices=` fan-out are not ported yet (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import numpy as np
import torch

from gms_tpu_torch import _kernels
from gms_tpu_torch.algorithms.k_clique import (
    _bucket, _check_adj, _extent, build_local_adj, pack_bits,
    plan_tier_chunks, unpack_bits)
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
                          "bk_stack_machine", "decode_clique_members"), 0)

# elements per step of the plain versions' broadcast tensors
_PLAIN_BUDGET = 1 << 24

# K9's queue of donated nodes (csrc/bk_stack.cu) holds at most _QUEUE_NODES
# nodes and _QUEUE_BYTES bytes; the kernel chooses its own grid and where
# its search paths lie
_QUEUE_NODES = 1 << 20
_QUEUE_BYTES = 1 << 28


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


def bk_stack_machine_plain(adj, S0, live0, M, wvalid, *, emit: bool = False,
                           stats: dict | None = None):
    """Plain version of bk_stack_machine: the same tree, expanded
    breadth-wise in batches of nodes (cand, fini, R, root) kept in a LIFO
    so memory stays bounded; leaves are filtered in batches.

    With `stats`, adds the kernel's word operations without its early
    exit, by type: stats["popc_ops"], the popcounts of the pivot scores
    (|cand ∪ fini|·WW per expanded node), and stats["bit_ops"], the 32-bit
    bitwise operations — the pivot scores' ANDs, 2·WW per child (cand' and
    fini', one three-input AND/OR each) and, per leaf tested, (|R| + 1)
    words of the transposed cover over the root's valid rows, (|R| + 1)·
    ⌈indeg / 32⌉.
    """
    C, W, WW = adj.shape
    IN = M.shape[1]
    dev = adj.device
    below = _below_words(W, WW, dev)
    onehot = pack_bits(torch.eye(W, dtype=torch.bool, device=dev))
    total, popc, bit = _zero(dev), _zero(dev), _zero(dev)
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
        stats["popc_ops"] = stats.get("popc_ops", 0) + int(popc)
        stats["bit_ops"] = stats.get("bit_ops", 0) + int(bit)
    if not emit:
        return total
    out = torch.cat(rows) if rows else adj.new_zeros((0, WW + 1))
    return total, out


def _launch_stack(adj, S0, live0, M, wvalid, total, out=None):
    """One launch of K9 (csrc/bk_stack.cu): a count pass, or with `out` an
    emit pass writing out.shape[0] rows."""
    C, W, WW = adj.shape
    dev = adj.device
    stride = 3 * WW + 1
    cap = max(1024, min(_QUEUE_NODES, _QUEUE_BYTES // (stride * 4)))
    _kernels.launch(
        "bk_stack", "bk_stack", adj, S0, live0, C, WW, M, wvalid, M.shape[1],
        torch.empty(C + 2, dtype=torch.int64, device=dev),
        torch.empty(C * WW, dtype=torch.int32, device=dev),
        torch.empty(C * (W + 1) * -(-M.shape[1] // 32), dtype=torch.int32,
                    device=dev),
        torch.zeros(64, dtype=torch.int64, device=dev),  # 4 lines
        torch.empty(cap * stride, dtype=torch.int32, device=dev),
        torch.zeros(cap, dtype=torch.int32, device=dev), cap, out,
        0 if out is None else out.shape[0], total)
    LAUNCHES["bk_stack_machine"] += 1


def bk_stack_machine(adj, S0, live0, M, wvalid, *, emit: bool = False):
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
    """
    name = "bk_stack_machine"
    _check_stack_inputs(name, adj, S0, live0, M, wvalid)
    if not _on_cuda(name, adj, S0, live0, M, wvalid):
        return bk_stack_machine_plain(adj, S0, live0, M, wvalid, emit=emit)
    total = _zero(adj.device)
    _launch_stack(adj, S0, live0, M, wvalid, total)
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


def _bk_fused(g: CSRGraph, rank: np.ndarray, roots: np.ndarray, *,
              device="cuda", collect: bool = False,
              root_chunk: int = DEFAULT_ROOT_CHUNK, sink=None):
    """Count (or enumerate) the maximal cliques rooted at `roots`; returns
    (count, cliques or None). In count mode every job's launches are
    enqueued before the one read-back; enumerate mode reads each job's count
    back to size its rows."""
    plan = BKPlan(g, rank, roots, device=device, root_chunk=root_chunk)
    nbr = plan.padded.nbr

    def cover(chunk, ww, in_w):
        return hub_cover_bits(nbr, plan.lo_indptr, plan.lo_cols, chunk,
                              in_width=in_w, w_words=ww)

    if not collect:
        outs = [bk_fused_chunk(nbr, chunk, *cover(chunk, ww, in_w),
                               w_words=ww)
                for chunk, ww, in_w in plan.jobs]
        return (int(torch.stack(outs).sum()) if outs else 0), None
    total = 0
    cliques: list[frozenset] | None = None if sink is not None else []
    for chunk, ww, in_w in plan.jobs:
        count, out = bk_fused_chunk(nbr, chunk, *cover(chunk, ww, in_w),
                                    w_words=ww, emit=True)
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
    direct: bool = False,
    devices=None,
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
    disjoint root sets sum exactly.

    The port has the fused DAG-universe path only, with no waves, segments
    or split-and-retry: the depth-first kernel cannot overflow in count
    mode, and enumerate mode sizes its rows from a count pass. direct=True
    and devices= raise NotImplementedError (ROADMAP Queue 1 item 7).
    """
    dev = resolve(device)
    if direct:
        raise NotImplementedError(
            "bron_kerbosch(direct=True): the direct full-neighbourhood "
            "variant is not ported yet (ROADMAP Queue 1 item 7)")
    if devices is not None:
        raise NotImplementedError(
            "bron_kerbosch(devices=...): the multi-device fan-out is not "
            "ported yet (ROADMAP Queue 1 items 7 and 13)")
    n = g.num_nodes
    if n == 0:
        return (0, []) if collect else 0
    rank = np.asarray(ordering_rank(g, ordering) if rank is None else rank)
    roots_all = (np.arange(n, dtype=np.int32) if roots is None
                 else np.asarray(roots, dtype=np.int32))
    total, cliques = _bk_fused(g, rank, roots_all, device=dev,
                               collect=collect, root_chunk=root_chunk,
                               sink=sink)
    return (total, cliques) if collect else total


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
