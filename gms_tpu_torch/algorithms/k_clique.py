"""k-clique counting — the port of gms_tpu/algorithms/k_clique.py.

Role of the reference's kClist (gms/algorithms/non_set_based/k_clique_list/
kernels/kclisting.h:18-190, parallelizationStrategy/parallelize.h:38-121) and
its set-based count (set_based/k_clique_count/k_clique_count_set_based.h:5-28):
orient the graph by degeneracy rank into a DAG, then count the cliques rooted
at each vertex inside its out-neighbourhood. Each clique is counted once,
along its unique topological order.

The path, as in gms_tpu:
  1. exact degeneracy rank (host peel, preprocessing/degeneracy.py), orient,
     pad at lane 32;
  2. `plan_tier_chunks` cuts the roots into degree-tiered chunks; W, the
     chunk's local width, is a power of two >= 32 covering its out-degrees;
  3. per chunk, `build_local_adj` builds the local DAG bitsets: bit j of
     adj[b, i] says local vertex j is an out-neighbour of local vertex i,
     both in N+(root b);
  4. k <= 5: `kclique_dense_count` sums the bit formulas of the dense path;
     k >= 6: `kc_stack_count` walks the pruned search tree of each (root,
     first-level child) item depth-first.

Three device programs of gms_tpu carry this path, two more the sharded
count (parallel/multi.py) and one the vertex-sharded plans' ring
(parallel/sharding.py); each is a hand-written CUDA kernel here (csrc/),
wrapped by the function named:

    build_local_adj      csrc/local_adj.cu       (k_clique.py:82)
    kclique_dense_count  csrc/kclique_dense.cu   (kclique_dense_chunk, :548)
    kc_stack_count       csrc/kclique_stack.cu   (kc_fused_chunk, :343)
    expand_level         csrc/kc_expand.cu       (expand_level, :161)
    total_popcount       csrc/popcount_sum.cu    (total_popcount, :209)
    member_pack          csrc/ring_member.cu     (the packs of the vertex-
                         sharded plans, parallel/sharding.py:379-400, :579-603)

`kclique_dense_chunk` and `kc_fused_chunk` keep gms_tpu's names: each builds
the chunk's local adjacency and counts on it (two launches). Each wrapper
checks device, dtype, shape and contiguity; for CPU tensors it runs its
`*_plain` PyTorch version, for CUDA tensors it launches the kernel (raising
if the launch fails) and adds one to `LAUNCHES[name]`. Bit words are int32
tensors carrying gms_tpu's uint32 bits; counts are int64.

What gms_tpu's k >= 6 program does only for its platform is not ported: the
resumable `state` and `iter_budget` (a dispatch watchdog), the bounded push
window with its band sort and overflow retry (the depth-first kernel needs at
most k-3 bitsets per warp, so nothing overflows), and the rem==4 matrix-unit
branch. `kc_stack_machine` and `kclique_count_chunk` (k_clique.py:258,
:219), the counts of gms_tpu's vertex-sharded plan on a prebuilt universe,
return (total, False, True, None) over K6, or K5 for k <= 4.
"""

from __future__ import annotations

import numpy as np
import torch

from gms_tpu_torch import _kernels
from gms_tpu_torch.algorithms.triangle_count import (
    _check, _on_cuda, _zero, popcount32)
from gms_tpu_torch.device import resolve
from gms_tpu_torch.graphs.csr import CSRGraph
from gms_tpu_torch.graphs.tiles import PaddedGraph, SENTINEL
from gms_tpu_torch.harness import checks
from gms_tpu_torch.preprocessing import degeneracy, orient

DEFAULT_ROOT_CHUNK = 1024

_SENT = int(SENTINEL)

# Kernel launches per wrapper, counted only where the CUDA kernel launches.
LAUNCHES = dict.fromkeys(
    ("build_local_adj", "kclique_dense_count", "kc_stack_count",
     "expand_level", "total_popcount", "member_pack"), 0)

# elements per step of the plain versions' broadcast tensors
_PLAIN_BUDGET = 1 << 24


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# bit words (int32 carriers of gms_tpu's uint32 words)
# ---------------------------------------------------------------------------

_WEIGHTS = torch.tensor([1 << j for j in range(31)] + [-(1 << 31)],
                        dtype=torch.int32)
_SHIFTS = torch.arange(32, dtype=torch.int32)


def pack_bits(m: torch.Tensor) -> torch.Tensor:
    """bool[..., 32*WW] -> int32[..., WW]; bit j of word w is m[..., 32w+j].

    Distinct powers of two never carry, so the int32 sum is exact."""
    words = m.reshape(*m.shape[:-1], m.shape[-1] // 32, 32).to(torch.int32)
    return (words * _WEIGHTS.to(m.device)).sum(-1, dtype=torch.int32)


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """int32[..., WW] -> bool[..., 32*WW], the inverse of pack_bits."""
    bits = (words[..., None] >> _SHIFTS.to(words.device)) & 1
    return bits.reshape(*words.shape[:-1], words.shape[-1] * 32).bool()


# ---------------------------------------------------------------------------
# K4: local DAG adjacency
# ---------------------------------------------------------------------------

def _extent(mask: torch.Tensor) -> torch.Tensor:
    """Per row of a bool[N, L] mask: 1 + the index of its last True, or 0."""
    if mask.shape[1] == 0:
        return mask.new_zeros(mask.shape[0], dtype=torch.long)
    last = mask.shape[1] - mask.flip(1).to(torch.int8).argmax(1)
    return torch.where(mask.any(1), last, 0)


def build_local_adj_plain(nbr, roots, *, w_words: int):
    """Plain version of build_local_adj: the broadcast compare of gms_tpu's
    dense branch, in steps of at most _PLAIN_BUDGET compares. It compares
    only up to the last non-SENTINEL slot of the rows gathered and of the
    root rows: beyond it, only SENTINEL slots of the root could match, and
    those are masked. It needs no sorted rows."""
    V, D = nbr.shape
    W = 32 * w_words
    C = roots.shape[0]
    r_nbr = nbr[roots.long().clamp(0, V - 1), :min(W, D)]
    if r_nbr.shape[1] < W:
        r_nbr = torch.cat([r_nbr, r_nbr.new_full((C, W - r_nbr.shape[1]),
                                                 _SENT)], 1)
    valid = r_nbr != _SENT                                     # [C, W]
    adj = torch.zeros((C, W, w_words), dtype=torch.int32, device=nbr.device)
    lens = _extent(nbr != _SENT)[r_nbr.long().clamp(0, V - 1)]
    D = max(1, int(lens.max())) if lens.numel() else 1
    nbr = nbr[:, :D]
    per_root = W * W * D
    cg = max(1, _PLAIN_BUDGET // per_root)
    ib = W if cg > 1 else max(1, _PLAIN_BUDGET // (W * D))
    root_len = _extent(valid)
    for c0 in range(0, C, cg):
        rn, vd = r_nbr[c0:c0 + cg], valid[c0:c0 + cg]
        # slots from nv on are SENTINEL in every root of the group: their
        # bits stay 0
        nv = int(root_len[c0:c0 + cg].max())
        for i0 in range(0, nv, ib):
            cols = rn[:, i0:min(i0 + ib, nv)]                  # [c, ib]
            rows = nbr[cols.long().clamp(0, V - 1)]            # [c, ib, D]
            m = (rows[:, :, None, :] == rn[:, None, :nv, None]).any(3)
            m &= vd[:, None, :nv] & (cols != _SENT)[:, :, None]  # [c, ib, nv]
            m = torch.cat([m, m.new_zeros((*m.shape[:2], W - nv))], 2)
            adj[c0:c0 + cg, i0:i0 + cols.shape[1]] = pack_bits(m)
    return adj, pack_bits(valid)


def build_local_adj(nbr, roots, *, w_words: int):
    """Per-root local DAG adjacency bitsets and initial candidate sets.

    nbr:   int32[V_pad, D] oriented padded adjacency, each row strictly
           ascending with a SENTINEL tail (the padded layout; the kernel
           takes a root's live slots as a prefix of its row and stops a row
           once it passes the root's last one, so it would miss members of
           an unsorted row, which the plain version would not)
    roots: int32[C] root ids; they clip to [0, V_pad-1], so the pad id
           V_pad lands on the all-SENTINEL guard row and gives empty sets.
    Returns (adj int32[C, W, w_words], S0 int32[C, w_words]), W = 32*w_words:
    with r_nbr the first min(W, D) slots of the root's row (SENTINEL beyond
    D), bit j of adj[b, i] is set iff r_nbr[i] and r_nbr[j] are not SENTINEL
    and r_nbr[j] lies in the row of r_nbr[i]; bit j of S0[b] iff r_nbr[j] is
    not SENTINEL. Bit for bit gms_tpu's build_local_adj (k_clique.py:82).
    """
    name = "build_local_adj"
    _check(name, "nbr", nbr, 2)
    _check(name, "roots", roots, 1)
    if w_words < 1:
        raise ValueError(f"{name}: w_words must be >= 1, got {w_words}")
    if not _on_cuda(name, nbr, roots):
        return build_local_adj_plain(nbr, roots, w_words=w_words)
    C, W = roots.shape[0], 32 * w_words
    adj = torch.empty((C, W, w_words), dtype=torch.int32, device=nbr.device)
    s0 = torch.empty((C, w_words), dtype=torch.int32, device=nbr.device)
    _kernels.launch("local_adj", "build_local_adj", nbr, nbr.shape[0],
                    nbr.shape[1], roots, C, w_words, adj, s0)
    LAUNCHES[name] += 1
    return adj, s0


def member_pack_plain(q, vis, locs, sel, out):
    """Plain version of member_pack: gms_tpu's broadcast compare over the
    selected slots, trimmed to the last non-SENTINEL slot of the rows and of
    q, in steps of at most _PLAIN_BUDGET compares. It needs no sorted
    rows."""
    c, i = sel.nonzero(as_tuple=True)
    if c.numel() == 0:
        return out
    Vs = vis.shape[0]
    W = q.shape[1]
    rows = locs[c, i].long().clamp(0, Vs - 1)
    dt = max(1, int(_extent(vis != _SENT)[rows].max()))
    qvalid = q != _SENT
    nq = max(1, int(_extent(qvalid).max()))
    step = max(1, _PLAIN_BUDGET // (nq * dt))
    for p0 in range(0, c.numel(), step):
        cc, ii = c[p0:p0 + step], i[p0:p0 + step]
        r = vis[rows[p0:p0 + step], :dt]                       # [p, dt]
        m = (r[:, None, :] == q[cc, :nq, None]).any(2) & qvalid[cc, :nq]
        m = torch.cat([m, m.new_zeros((m.shape[0], W - nq))], 1)
        out[cc, ii] |= pack_bits(m)
    return out


def member_pack(q, vis, locs, sel, out):
    """OR one ring rotation's membership bits into out — out, updated in
    place (build_local_adj's kernel with an indirection, a mask and an OR).

    q:    int32[C, W] each root's row (W = 32*WW), strictly ascending with a
          SENTINEL tail (pad roots all SENTINEL)
    vis:  int32[Vs, D] the visiting table shard, rows in the same layout
    locs: int32[C, L] a row of vis for each slot (clipped to [0, Vs-1])
    sel:  bool[C, L] the slots this rotation fills
    out:  int32[C, L, WW] bitsets
    For each selected (c, i): out[c, i] |= {j : q[c, j] != SENTINEL and
    q[c, j] in vis[locs[c, i]]}; the rest of out is left as it is. The two
    packs of gms_tpu's vertex-sharded plans (parallel/sharding.py:379-400,
    :579-603): adj with locs the root row's own slots, BK's cover bitsets M
    with locs its lower neighbours. Rows must be sorted as stated (checked
    under GMS_TPU_PARANOID=1): the kernel stops a visiting row past q's
    last live value and would miss members of an unsorted one, which the
    plain version would not.
    """
    name = "member_pack"
    _check(name, "q", q, 2)
    _check(name, "vis", vis, 2)
    _check(name, "locs", locs, 2)
    _check(name, "sel", sel, 2, dtype=torch.bool)
    _check(name, "out", out, 3)
    C, W = q.shape
    if W % 32 or out.shape != (C, locs.shape[1], W // 32) \
            or sel.shape != locs.shape or locs.shape[0] != C:
        raise ValueError(f"{name}: q {tuple(q.shape)}, locs "
                         f"{tuple(locs.shape)}, sel {tuple(sel.shape)} and "
                         f"out {tuple(out.shape)} do not match")
    if checks.paranoid():
        checks.validate_sorted_rows(q, name=f"{name} q")
        checks.validate_sorted_rows(vis, name=f"{name} vis")
    if not _on_cuda(name, q, vis, locs, sel, out):
        return member_pack_plain(q, vis, locs, sel, out)
    _kernels.launch("ring_member", "member_pack", q, W // 32, vis,
                    vis.shape[0], vis.shape[1], locs, sel, C, locs.shape[1],
                    out)
    LAUNCHES[name] += 1
    return out


def _check_adj(name, adj):
    _check(name, "adj", adj, 3)
    if adj.shape[1] != 32 * adj.shape[2]:
        raise ValueError(f"{name}: adj {tuple(adj.shape)} is not [C, 32*WW, WW]")


# ---------------------------------------------------------------------------
# K5: dense count, k in {3, 4, 5}
# ---------------------------------------------------------------------------

def kclique_dense_count_plain(adj, *, k: int, stats: dict | None = None):
    """Plain version of kclique_dense_count: the bit formulas in torch ops,
    over the set bits of root groups, in batches of (root, i, j) triples.

    With `stats`, adds stats["word_ops"]: the AND+popcount word operations
    the sums need, a word only where it can be non-zero: k=3 every word of
    A; k=4 A_i's non-zero words a pair (i, j ∈ A_i); k=5 those, which form
    X = A_i & A_j, and X's non-zero words a triple (i, j, m ∈ X).
    """
    C, W, WW = adj.shape
    if k == 3:
        if stats is not None:
            stats["word_ops"] = stats.get("word_ops", 0) + adj.numel()
        return popcount32(adj).sum()
    total = _zero(adj.device)
    ops = _zero(adj.device)
    pb = max(1, _PLAIN_BUDGET // (W * WW))
    cg = max(1, _PLAIN_BUDGET // (W * W))
    for c0 in range(0, C, cg):
        A = adj[c0:c0 + cg]
        b, i, j = unpack_bits(A).nonzero(as_tuple=True)        # j ∈ A_i
        for p0 in range(0, b.shape[0], pb):
            bb, ii, jj = b[p0:p0 + pb], i[p0:p0 + pb], j[p0:p0 + pb]
            Ai = A[bb, ii]
            X = Ai & A[bb, jj]                                 # [p, WW]
            ops += (Ai != 0).sum()
            if k == 4:
                total += popcount32(X).sum()
                continue
            ops += (popcount32(X).sum(1) * (X != 0).sum(1)).sum()
            p, m = unpack_bits(X).nonzero(as_tuple=True)       # m ∈ A_i ∩ A_j
            total += popcount32(X[p] & A[bb[p], m]).sum()
    if stats is not None:
        stats["word_ops"] = stats.get("word_ops", 0) + int(ops)
    return total


def kclique_dense_count(adj, *, k: int):
    """k-cliques (k in {3, 4, 5}) rooted at a chunk, from its local DAG
    adjacency A = adj (int32[C, W, WW]) — int64 0-d tensor:

        k=3: Σ popcount(A)
        k=4: Σ_b Σ_i Σ_{j∈A_i} popcount(A_i & A_j)              (= Σ A⊙(A@A))
        k=5: Σ_b Σ_i Σ_{j∈A_i} Σ_{m∈A_i∩A_j} popcount(A_i & A_j & A_m)
                                                               (= Σ M⊙(M@A))

    The counting half of gms_tpu's kclique_dense_chunk (k_clique.py:548),
    which computes the products on its matrix unit; the kernel counts the
    same bits with AND + popcount, exactly, at any W.
    """
    name = "kclique_dense_count"
    _check_adj(name, adj)
    if k not in (3, 4, 5):
        raise ValueError(f"{name}: k must be 3, 4 or 5, got {k}")
    if not _on_cuda(name, adj):
        return kclique_dense_count_plain(adj, k=k)
    out = _zero(adj.device)
    _kernels.launch("kclique_dense", "kclique_dense_count", adj,
                    adj.shape[0], adj.shape[2], k, out)
    LAUNCHES[name] += 1
    return out


def kclique_dense_chunk(nbr, chunk, *, w_words: int, k: int):
    """k-cliques (k in {3, 4, 5}) rooted at `chunk` — int64 0-d tensor.
    gms_tpu's kclique_dense_chunk (k_clique.py:548): build_local_adj, then
    kclique_dense_count. Its `group` and `i_block` sized the matrix unit's
    working set and have no counterpart."""
    adj, _s0 = build_local_adj(nbr, chunk, w_words=w_words)
    return kclique_dense_count(adj, k=k)


# ---------------------------------------------------------------------------
# K6: depth-first search tree, k >= 5
# ---------------------------------------------------------------------------

def kc_stack_count_plain(adj, S0, *, k: int, stats: dict | None = None):
    """Plain version of kc_stack_count: breadth-wise expansion of batches of
    items (S, root) sharing `rem`, the vertices still needed, kept in a LIFO
    so memory stays bounded. Prunes as the kernel and gms_tpu do: a root
    needs |S0| >= k-1, a child needing r >= 3 more needs |S| >= r, and a
    child needing 2 is counted inline as Σ_{j∈S} popcount(S & adj_j).

    With `stats`, adds stats["word_ops"]: the AND+popcount word operations
    of the search (|S|·WW per expanded item plus |S|·WW per inline count),
    which is the kernel's work too.
    """
    C, W, WW = adj.shape
    dev = adj.device
    total = _zero(dev)
    ops = _zero(dev)
    root_ok = popcount32(S0).sum(1) >= k - 1
    stack = [(S0[root_ok], torch.arange(C, device=dev)[root_ok], k - 1)]
    batch = max(1, _PLAIN_BUDGET // (W * WW))
    while stack:
        S, R, rem = stack.pop()
        if S.shape[0] > batch:
            stack.append((S[batch:], R[batch:], rem))
            S, R = S[:batch], R[:batch]
        item, i = unpack_bits(S).nonzero(as_tuple=True)
        ops += item.shape[0] * WW
        R = R[item]
        cS = S[item] & adj[R, i]                               # [M, WW]
        pcS = popcount32(cS).sum(1)
        r = rem - 1
        if r == 1:
            total += pcS.sum()
        elif r == 2:
            ops += pcS.sum() * WW
            for p0 in range(0, cS.shape[0], batch):
                X, RX = cS[p0:p0 + batch], R[p0:p0 + batch]
                p, j = unpack_bits(X).nonzero(as_tuple=True)   # j ∈ X
                total += popcount32(X[p] & adj[RX[p], j]).sum()
        else:
            keep = pcS >= r
            if keep.any():
                stack.append((cS[keep], R[keep], r))
    if stats is not None:
        stats["word_ops"] = stats.get("word_ops", 0) + int(ops)
    return total


def kc_stack_count(adj, S0, *, k: int):
    """k-cliques (k >= 5) rooted at a chunk, from its local DAG adjacency
    adj int32[C, W, WW] and candidate sets S0 int32[C, WW] — int64 0-d
    tensor. The counting half of gms_tpu's kc_fused_chunk (k_clique.py:343):
    each (root, first-level child) item is searched depth-first, pruned by
    |S| >= rem, with the last two levels counted inline.

    k <= 4 is refused: gms_tpu's stack on narrow tiers gives 0 there and
    routes those k to the dense path; so does the port.
    """
    name = "kc_stack_count"
    _check_adj(name, adj)
    _check(name, "S0", S0, 2)
    if S0.shape != (adj.shape[0], adj.shape[2]):
        raise ValueError(f"{name}: S0 {tuple(S0.shape)} does not match adj "
                         f"{tuple(adj.shape)}")
    if k < 5:
        raise ValueError(f"{name}: k must be >= 5, got {k}; "
                         "kclique_dense_count counts k <= 5")
    if not _on_cuda(name, adj, S0):
        return kc_stack_count_plain(adj, S0, k=k)
    C, W, WW = adj.shape
    out = _zero(adj.device)
    roff = torch.empty(C + 2, dtype=torch.int64, device=adj.device)
    ioff = torch.empty(C * W, dtype=torch.int32, device=adj.device)
    _kernels.launch("kclique_stack", "kc_stack_count", adj, S0, C, WW, k,
                    roff, ioff, out)
    LAUNCHES[name] += 1
    return out


def kc_fused_chunk(nbr, chunk, *, w_words: int, k: int):
    """k-cliques (k >= 5) rooted at `chunk` — int64 0-d tensor. gms_tpu's
    kc_fused_chunk (k_clique.py:343): build_local_adj, then kc_stack_count,
    in one pass with no resumable state and no overflow."""
    adj, s0 = build_local_adj(nbr, chunk, w_words=w_words)
    return kc_stack_count(adj, s0, k=k)


def kc_stack_machine(adj, S0, state=None, *, k: int,
                     w_words: int | None = None, cap: int | None = None,
                     batch: int | None = None, iter_budget: int = 1 << 30,
                     resume: bool = False):
    """k-cliques (k >= 3) rooted at a chunk, from its PREBUILT local DAG
    universe adj int32[C, W, WW] and candidate sets S0 int32[C, WW] (pad
    roots have S0 = 0 and contribute nothing): gms_tpu's kc_stack_machine
    (k_clique.py:258), the count of its vertex-sharded plan's k >= 6 branch
    on ring-built universes. Returns (total int64 0-d tensor, overflow
    False, done True, state None): the port's search cannot overflow and
    leaves nothing to resume.

    k >= 5 runs K6 (kc_stack_count). k in {3, 4}, which K6 refuses, runs K5
    (kclique_dense_count), which counts adj's bits without reading S0: the
    two agree whenever adj's rows and bits lie inside S0, as build_local_adj
    and the ring-built universes give them. `state`, `cap`, `batch`,
    `iter_budget` and `resume` served gms_tpu's bounded stack and its
    platform's dispatch watchdog; they are accepted and have no effect.
    `w_words`, when given, must be adj's.
    """
    if w_words is not None and w_words != adj.shape[2]:
        raise ValueError(f"kc_stack_machine: w_words {w_words} but adj "
                         f"{tuple(adj.shape)}")
    if k < 3:
        raise ValueError(f"kc_stack_machine: k must be >= 3, got {k}")
    if k >= 5:
        total = kc_stack_count(adj, S0, k=k)
    else:
        total = kclique_dense_count(adj, k=k)
    return total, False, True, None


def kclique_count_chunk(nbr, chunk, state=None, *, w_words: int, k: int,
                        cap: int | None = None, batch: int | None = None,
                        iter_budget: int = 1 << 30, resume: bool = False):
    """k-cliques rooted at `chunk`: gms_tpu's kclique_count_chunk
    (k_clique.py:219), build_local_adj (K4) then kc_stack_machine; returns
    kc_stack_machine's (total, False, True, None). `state`, `cap`, `batch`,
    `iter_budget` and `resume` have no effect (see kc_stack_machine)."""
    adj, s0 = build_local_adj(nbr, chunk, w_words=w_words)
    return kc_stack_machine(adj, s0, k=k)


# ---------------------------------------------------------------------------
# K37: one breadth-wise expansion; K38: the popcount sum
# ---------------------------------------------------------------------------

def _live_rows(S, n_live) -> int:
    """min(N, n_live) on the host (the plain version's sync), N without
    n_live."""
    if n_live is None:
        return S.shape[0]
    return max(0, min(S.shape[0], int(n_live)))


def expand_level_plain(S, root_idx, adj, *, cap: int, need: int,
                       n_live=None):
    """Plain version of expand_level: the set bits of the live rows of S in
    (item, i) order, their children ANDed and counted in batches, the first
    `cap` survivors written in that order."""
    N, WW = S.shape
    C = adj.shape[0]
    dev = S.device
    live = _live_rows(S, n_live)
    S_out = torch.zeros((cap, WW), dtype=torch.int32, device=dev)
    R_out = torch.zeros(cap, dtype=torch.int32, device=dev)
    n_children, pcs = _zero(dev), _zero(dev)
    ib = max(1, _PLAIN_BUDGET // (32 * WW))
    for n0 in range(0, live, ib):
        item, i = unpack_bits(S[n0:min(n0 + ib, live)]).nonzero(
            as_tuple=True)
        item = item + n0
        r = root_idx[item]
        child = S[item] & adj[r.long().clamp(0, C - 1), i]
        pc = popcount32(child).sum(1)
        ok = pc >= need
        pos = n_children + torch.cumsum(ok, 0) - 1
        put = ok & (pos < cap)
        S_out[pos[put]] = child[put]
        R_out[pos[put]] = r[put]
        n_children += ok.sum()
        pcs += pc[ok].sum()
    return S_out, R_out, n_children, pcs


def expand_level(S, root_idx, adj, *, cap: int, need: int, n_live=None):
    """One breadth-wise expansion of all items: gms_tpu's expand_level
    (k_clique.py:161), bit for bit.

    S:        int32[N, WW] candidate bitsets (zero rows emit nothing)
    root_idx: int32[N] index into adj's first axis, in [0, C)
    adj:      int32[C, W, WW], W = 32*WW
    cap:      output rows; the survivors beyond it are counted, not written
    need:     a child survives iff its popcount is at least `need`
    n_live:   optional int64 0-d tensor: only the rows below min(N, n_live)
              are expanded (the caller passes the previous level's
              n_children, past which its rows are zero); the kernel reads
              it on the device, so no host sync
    Returns (S_out int32[cap, WW], R_out int32[cap], n_children, pcs): the
    first `cap` surviving children S[n] & adj[root_idx[n], i] in (item, i)
    order with their items' root_idx, unfilled rows zero with R 0;
    n_children (int64 0-d) every survivor, also beyond cap; pcs (int64
    0-d) the sum of their popcounts. The kernel forms no [N, W, WW] tensor:
    one pass over tiles of the live words of S, each tile's offset found by
    decoupled look-back, then the rows past the survivors zeroed.
    """
    name = "expand_level"
    _check(name, "S", S, 2)
    _check(name, "root_idx", root_idx, 1)
    _check_adj(name, adj)
    if adj.shape[2] != S.shape[1] or root_idx.shape[0] != S.shape[0]:
        raise ValueError(f"{name}: S {tuple(S.shape)}, root_idx "
                         f"{tuple(root_idx.shape)} and adj {tuple(adj.shape)}"
                         " do not match")
    if cap < 0:
        raise ValueError(f"{name}: cap must be >= 0, got {cap}")
    extra = []
    if n_live is not None:
        if n_live.dtype != torch.int64 or n_live.numel() != 1:
            raise TypeError(f"{name}: n_live must be one int64, got "
                            f"{n_live.dtype} {tuple(n_live.shape)}")
        extra.append(n_live)
    if not _on_cuda(name, S, root_idx, adj, *extra):
        return expand_level_plain(S, root_idx, adj, cap=cap, need=need,
                                  n_live=n_live)
    N, WW = S.shape
    dev = S.device
    stats = torch.zeros(2, dtype=torch.int64, device=dev)
    if not (N and adj.shape[0]):
        return (torch.zeros((cap, WW), dtype=torch.int32, device=dev),
                torch.zeros(cap, dtype=torch.int32, device=dev), stats[0],
                stats[1])
    S_out = torch.empty((cap, WW), dtype=torch.int32, device=dev)
    R_out = torch.empty(cap, dtype=torch.int32, device=dev)
    grid = max(1, min(N * WW, 8 * _kernels.sm_count(dev.index)))
    # the tile counter, then a status word for each tile of <= 256 words
    status = torch.zeros(1 + max(grid, -(-N * WW // 256)), dtype=torch.int64,
                         device=dev)
    _kernels.launch("kc_expand", "expand_level", S, root_idx, N,
                    None if n_live is None else n_live.reshape(1), adj,
                    adj.shape[0], WW, need, cap, grid, status, S_out, R_out,
                    stats)
    LAUNCHES[name] += 1
    return S_out, R_out, stats[0], stats[1]


def total_popcount_plain(S):
    """Plain version of total_popcount."""
    return popcount32(S).sum(dtype=torch.int64)


def total_popcount(S):
    """The set bits of the int32 words S (any shape), int64 0-d tensor:
    gms_tpu's total_popcount (k_clique.py:209)."""
    name = "total_popcount"
    _kernels.check_tensor(name, "S", S, S.dim())
    if not _on_cuda(name, S):
        return total_popcount_plain(S)
    out = _zero(S.device)
    if S.numel():
        _kernels.launch("popcount_sum", "total_popcount", S, S.numel(), out)
        LAUNCHES[name] += 1
    return out


# ---------------------------------------------------------------------------
# host planning and orchestration
# ---------------------------------------------------------------------------

def _bucket(n: int) -> int:
    """n rounded up to a power of two, at least 256: gms_tpu's chunk-size
    rounding (k_clique.py:50), kept so plans equal gms_tpu's."""
    return 1 << max(8, int(np.ceil(np.log2(max(n, 1)))))


def plan_tier_chunks(deg_all, roots_all, pad_id, *, root_chunk: int = 4096,
                     mem_budget_words: int = 1 << 25, min_w: int = 32):
    """Degree-tiered root chunks: yields (chunk int32[cmax] padded with
    pad_id, w_words). Sorting roots by degree keeps the local width W (and
    everything cubic in it) at the tier's max degree instead of the global
    one — the form of the reference's per-root subgraph sizing
    (EppsteinSubGraphAdaptive.h boundary switch / SubGraphBuilder.h:24-60).
    `mem_budget_words` caps the [C, W, W/32] local adjacency. gms_tpu's
    planner, unchanged."""
    order = np.argsort(deg_all[roots_all], kind="stable")
    roots_sorted = roots_all[order]
    start = 0
    while start < len(roots_sorted):
        d0 = int(deg_all[roots_sorted[start]])
        W = max(min_w, 1 << int(np.ceil(np.log2(max(d0, 1)))))
        WW = W // 32
        cmax = max(1, min(root_chunk,
                          1 << int(np.log2(max(mem_budget_words // (W * WW),
                                               1)))))
        stop = start
        while stop < len(roots_sorted) and stop - start < cmax and \
                deg_all[roots_sorted[stop]] <= W:
            stop += 1
        chunk = roots_sorted[start:stop]
        start = stop
        if len(chunk) < cmax:
            chunk = np.concatenate(
                [chunk, np.full(cmax - len(chunk), pad_id, dtype=np.int32)])
        yield chunk, WW


def plan_chunks(g: CSRGraph, k: int, *, device="cuda",
                rank: np.ndarray | None = None,
                root_chunk: int = DEFAULT_ROOT_CHUNK):
    """The device inputs of kclique_count for k >= 3: (PaddedGraph of the
    oriented graph at lane 32, [(chunk int32[C] on the device, w_words)]).
    `rank` defaults to the exact degeneracy rank."""
    dev = resolve(device)
    if rank is None:
        rank, _ = degeneracy.degeneracy_ordering_rank(g)
    dag = orient.orient(g, rank)
    pg = PaddedGraph.from_csr(dag, device=dev, lane=32)
    deg = np.asarray(dag.degrees)
    roots = np.nonzero(deg >= k - 1)[0].astype(np.int32)
    pad_id = np.int32(pg.v_pad)  # clips to the last (all-SENTINEL) row
    chunks = [(torch.from_numpy(chunk).to(dev), ww)
              for chunk, ww in plan_tier_chunks(deg, roots, pad_id,
                                                root_chunk=root_chunk)]
    return pg, chunks


def kclique_count(g: CSRGraph, k: int, *, device="cuda",
                  rank: np.ndarray | None = None,
                  root_chunk: int = DEFAULT_ROOT_CHUNK) -> int:
    """Exact number of k-cliques in the undirected graph g.

    Equivalent output to kClist node-parallel counting
    (k_clique_list_danisch_node_parallel.cc); each clique counted once.
    Every chunk's launches are enqueued before the one read-back.
    """
    if k < 1:
        raise ValueError("k must be >= 1")
    dev = resolve(device)
    if k == 1:
        return g.num_nodes
    if k == 2:
        return g.num_edges_undirected
    pg, chunks = plan_chunks(g, k, device=dev, rank=rank,
                             root_chunk=root_chunk)
    count = kclique_dense_chunk if k <= 5 else kc_fused_chunk
    outs = [count(pg.nbr, chunk, w_words=ww, k=k) for chunk, ww in chunks]
    if not outs:
        return 0
    return int(torch.stack(outs).sum())


# ---------------------------------------------------------------------------
# independent host oracle (role of verification/kclisting_original.h)
# ---------------------------------------------------------------------------

def _bits(x: int):
    while x:
        low = x & -x
        yield low.bit_length() - 1
        x ^= low


def kclique_count_oracle(g: CSRGraph, k: int) -> int:
    """Serial DFS over the degeneracy DAG — an independent recount, as
    gms_tpu's oracle (k_clique.py:772), with each out-neighbourhood held as
    a Python int bitset and the last two levels counted by popcount."""
    if k == 1:
        return g.num_nodes
    if k == 2:
        return g.num_edges_undirected
    rank, _ = degeneracy.degeneracy_ordering_rank(g)
    dag = orient.orient(g, rank)
    adj = []
    for v in range(dag.num_nodes):
        x = 0
        for w in dag.out_neigh(v).tolist():
            x |= 1 << w
        adj.append(x)

    def rec(cands: int, need: int) -> int:
        if need == 1:
            return cands.bit_count()
        if need == 2:
            return sum((cands & adj[v]).bit_count() for v in _bits(cands))
        total = 0
        for v in _bits(cands):
            nxt = cands & adj[v]
            if nxt.bit_count() >= need - 1:
                total += rec(nxt, need - 1)
        return total

    return sum(rec(a, k - 1) for a in adj if a.bit_count() >= k - 1)
