r"""k-clique-star listing — the port of gms_tpu/algorithms/k_clique_star.py.

Role of the reference's k_clique_star_list (gms/algorithms/set_based/
k_clique_star_list/: sequential/recursive.h:32-69, output.h ListOutput modes
Count and List): enumerate the k-cliques; the star of a clique is the set of
vertices adjacent to all its members, (∩_{v ∈ clique} N(v)) \ clique; emit
(clique, star).

The path, as gms_tpu's:
  1. a rank (exact degeneracy by default); the undirected graph padded at
     lane 32; `rank_pad` = the rank, int32 max at and past V_pad;
  2. the roots (degree >= k-1) cut by `plan_tier_chunks` (k_clique.py) into
     degree tiers of local width W at 2^24 words a matrix, each tier split
     into sub-chunks of at most 2^27 / (W·D) roots (gms_tpu's `csub`);
  3. per job, `build_local_univ` builds the root's universe, its full
     neighbourhood: adj_full (undirected local adjacency), adj_dag (the same
     towards higher-ranked locals), S0 (locals ranked above the root) and I0
     (all locals); `star_stack` walks the kClist tree over (S, I, R):
     S the candidates that keep the clique's members in rank order, I the
     running common neighbourhood, R the members besides the root; a leaf R
     is the clique {root} ∪ R and its star is I \ R. Each k-clique is found
     once, at its lowest-ranked member.

Three device programs of gms_tpu carry this path; each is a hand-written
CUDA kernel here (csrc/), wrapped by the function named:

    build_local_univ   csrc/star_univ.cu    (build_local_univ, :54)
    star_stack         csrc/star_stack.cu   (star_fused_chunk, :137, less
                                             its build_local_univ)
    decode_star_rows   csrc/star_decode.cu  (decode_star_rows, :346)

`star_fused_chunk` keeps gms_tpu's name: it builds a job's universe and
searches it (two launches). Each wrapper checks device, dtype, shape and
contiguity; for CPU tensors it runs its `*_plain` PyTorch version, for CUDA
tensors it launches the kernel (raising if the launch fails) and adds one to
`LAUNCHES[name]` per launch. Bit words are int32 tensors carrying gms_tpu's
uint32 bits; counts are int64.

What gms_tpu's search does only for its platform is not ported: the
`stack_words`, `out_budget`, `max_inflight` and `iter_budget` arguments —
a compiled stack and output capacity with their overflow flag and
split-and-retry, waves of dispatches and a dispatch watchdog's segments with
resumable state. The depth-first kernel keeps one node per level of a warp's
path, so counting cannot overflow, and emit mode counts first and sizes its
rows exactly. `_onehot_masks` and `_band_compact` (gms_tpu's
bron_kerbosch.py), row moves through its sort network, have no counterpart.

The reference's disabled `remove_redundancy` (k_clique_star_list.cc:11-12)
means its output may repeat {centroid, star} pairs; here, as in gms_tpu,
each k-clique is emitted exactly once (PARITY.md §2.8).
"""

from __future__ import annotations

import gc
from itertools import combinations

import numpy as np
import torch

from gms_tpu_torch import _kernels
from gms_tpu_torch.algorithms.k_clique import (
    _check_adj, _extent, build_local_adj_plain, pack_bits, plan_tier_chunks,
    unpack_bits)
from gms_tpu_torch.algorithms.triangle_count import (
    _check, _on_cuda, popcount32)
from gms_tpu_torch.device import resolve
from gms_tpu_torch.graphs.csr import CSRGraph
from gms_tpu_torch.graphs.tiles import PaddedGraph, SENTINEL
from gms_tpu_torch.harness import checks
from gms_tpu_torch.preprocessing import degeneracy

DEFAULT_ROOT_CHUNK = 4096

_SENT = int(SENTINEL)
_RANK_PAD = int(np.iinfo(np.int32).max)

# Kernel launches per wrapper, counted only where the CUDA kernel launches.
LAUNCHES = dict.fromkeys(
    ("build_local_univ", "star_stack", "decode_star_rows"), 0)

# elements per step of the plain versions' broadcast tensors
_PLAIN_BUDGET = 1 << 24

# K12's least items a run, csrc/star_stack.cu's kRunItems: of 1, 4, 16 and
# 64, 4 was the fastest over the RMAT-12 k=4 emit pass on an H100 (1 within
# 2 %, 16 9 % slower; PERF.md §5)
RUN_ITEMS = 4
# K12's control words before the roots' look-back status, and the runs of
# one tile of its base scan (csrc/star_stack.cu's kCtl and kTile)
_CTL_WORDS = 8
_BASE_TILE = 2048
# rows of a job that star_pairs cuts at a time, so that it holds the Python
# ints of one slab of ids, not of the job
_PAIR_ROWS = 1 << 15


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# host planning (numpy, as in gms_tpu)
# ---------------------------------------------------------------------------

def plan_star_jobs(g: CSRGraph, k: int, *, device="cuda",
                   rank: np.ndarray | None = None,
                   root_chunk: int = DEFAULT_ROOT_CHUNK):
    """The device inputs of kclique_star_list: (PaddedGraph of g at lane 32,
    rank_pad int32[V_pad + 1] on the device, [(chunk int32[C] on the device,
    w_words)]). gms_tpu's job list (:446-464): the roots of degree >= k-1 in
    `plan_tier_chunks` tiers at 2^24 words a matrix, each tier cut into
    sub-chunks of `csub` roots, all-pad sub-chunks dropped. Pad slots hold
    V_pad. `rank` defaults to the exact degeneracy rank."""
    dev = resolve(device)
    if rank is None:
        rank, _ = degeneracy.degeneracy_ordering_rank(g)
    pg = PaddedGraph.from_csr(g, device=dev, lane=32)
    rank_pad = np.full(pg.v_pad + 1, _RANK_PAD, dtype=np.int32)
    rank_pad[:g.num_nodes] = rank
    deg_all = np.asarray(g.degrees)
    roots_all = np.nonzero(deg_all >= k - 1)[0].astype(np.int32)
    pad_id = np.int32(pg.v_pad)
    D = pg.d_pad
    jobs = []
    for tchunk, ww in plan_tier_chunks(deg_all, roots_all, pad_id,
                                       root_chunk=root_chunk,
                                       mem_budget_words=1 << 24):
        W = 32 * ww
        csub = max(4, min(len(tchunk), (1 << 27) // max(W * D, 1)))
        csub = 1 << int(np.log2(csub))
        for s in range(0, len(tchunk), csub):
            sub = np.ascontiguousarray(tchunk[s:s + csub])
            if np.all(sub == pad_id):
                continue
            jobs.append((torch.from_numpy(sub).to(dev), ww))
    return pg, torch.from_numpy(rank_pad).to(dev), jobs


# ---------------------------------------------------------------------------
# K11: local universe
# ---------------------------------------------------------------------------

def build_local_univ_plain(nbr, rank_pad, roots, *, w_words: int):
    """Plain version of build_local_univ: adj_full and I0 are
    build_local_adj's plain broadcast compare over the undirected rows (the
    same bits); adj_dag and S0 mask them by rank, a group of roots with
    valid slots at a time, up to the last valid slot (adj_full is 0 beyond
    it). It needs no sorted rows."""
    V, D = nbr.shape
    W = 32 * w_words
    C = roots.shape[0]
    adj_full, i0 = build_local_adj_plain(nbr, roots, w_words=w_words)
    r_nbr = nbr[roots.long().clamp(0, V - 1), :min(W, D)]
    if r_nbr.shape[1] < W:
        r_nbr = torch.cat([r_nbr, r_nbr.new_full((C, W - r_nbr.shape[1]),
                                                 _SENT)], 1)
    valid = r_nbr != _SENT
    n_rank = rank_pad.shape[0]
    lrank = rank_pad[r_nbr.long().clamp(0, n_rank - 1)]            # [C, W]
    rrank = rank_pad[roots.long().clamp(0, n_rank - 1)]            # [C]
    s0 = pack_bits(valid & (lrank > rrank[:, None]))
    adj_dag = torch.zeros_like(adj_full)
    extent = _extent(valid)
    live = extent.nonzero()[:, 0]
    cg = max(1, _PLAIN_BUDGET // (W * W))
    for p0 in range(0, live.shape[0], cg):
        idx = live[p0:p0 + cg]
        nv = int(extent[idx].max())
        lr = lrank[idx, :nv]
        m = lr[:, None, :] > lr[:, :, None]                        # [c, i, j]
        m = torch.cat([m, m.new_zeros((*m.shape[:2], W - nv))], 2)
        adj_dag[idx, :nv] = adj_full[idx, :nv] & pack_bits(m)
    return adj_full, adj_dag, s0, i0


def build_local_univ(nbr, rank_pad, roots, *, w_words: int):
    """Per-root local universe over the root's full neighbourhood.

    nbr:      int32[V_pad, D] undirected padded adjacency, each row strictly
              ascending with a SENTINEL tail (the padded layout; the kernel
              takes a root's valid slots as a prefix and stops a row past
              the root's last value, so it would miss members of an
              unsorted row, which the plain version would not;
              GMS_TPU_PARANOID=1 checks it)
    rank_pad: int32[R] ranks; lookups clip to [0, R-1] (gms_tpu passes
              R = V_pad + 1 with int32 max from n on)
    roots:    int32[C] root ids; they clip to [0, V_pad-1] for rows, so the
              pad id V_pad lands on the all-SENTINEL guard row
    Returns (adj_full, adj_dag int32[C, W, w_words], S0, I0 int32[C,
    w_words]), W = 32*w_words: with r_nbr the first min(W, D) slots of the
    root's row (SENTINEL beyond D), bit j of adj_full[b, i] is set iff
    r_nbr[i] and r_nbr[j] are not SENTINEL and r_nbr[j] lies in the row of
    r_nbr[i]; adj_dag keeps the bits with rank(r_nbr[j]) > rank(r_nbr[i]);
    S0 the valid slots ranked above the root, I0 all valid slots. Bit for
    bit gms_tpu's build_local_univ (k_clique_star.py:54), both branches.
    """
    name = "build_local_univ"
    _check(name, "nbr", nbr, 2)
    _check(name, "rank_pad", rank_pad, 1)
    _check(name, "roots", roots, 1)
    if w_words < 1:
        raise ValueError(f"{name}: w_words must be >= 1, got {w_words}")
    if rank_pad.shape[0] < 1:
        raise ValueError(f"{name}: rank_pad is empty")
    if checks.paranoid():
        checks.validate_sorted_rows(nbr, name=f"{name} nbr")
    if not _on_cuda(name, nbr, rank_pad, roots):
        return build_local_univ_plain(nbr, rank_pad, roots, w_words=w_words)
    C, W = roots.shape[0], 32 * w_words
    dev = nbr.device
    adj_full = torch.empty((C, W, w_words), dtype=torch.int32, device=dev)
    adj_dag = torch.empty_like(adj_full)
    s0 = torch.empty((C, w_words), dtype=torch.int32, device=dev)
    i0 = torch.empty_like(s0)
    _kernels.launch("star_univ", "build_local_univ", nbr, nbr.shape[0],
                    nbr.shape[1], rank_pad, rank_pad.shape[0], roots, C,
                    w_words, adj_full, adj_dag, s0, i0)
    LAUNCHES[name] += 1
    return adj_full, adj_dag, s0, i0


# ---------------------------------------------------------------------------
# K12: the star search
# ---------------------------------------------------------------------------

def _check_univ(name, adj_full, adj_dag, S0, I0, live0):
    _check_adj(name, adj_full)
    _check_adj(name, adj_dag)
    _check(name, "S0", S0, 2)
    _check(name, "I0", I0, 2)
    C, W, WW = adj_full.shape
    if adj_dag.shape != adj_full.shape or S0.shape != (C, WW) or \
            I0.shape != (C, WW):
        raise ValueError(f"{name}: adj_dag {tuple(adj_dag.shape)}, S0 "
                         f"{tuple(S0.shape)} or I0 {tuple(I0.shape)} does not "
                         f"match adj_full {(C, W, WW)}")
    if live0.dtype != torch.bool or tuple(live0.shape) != (C,):
        raise TypeError(f"{name}: live0 must be bool ({C},), got "
                        f"{live0.dtype} {tuple(live0.shape)}")
    if not live0.is_contiguous():
        raise ValueError(f"{name}: live0 must be contiguous")


def star_stack_plain(adj_full, adj_dag, S0, I0, live0, *, k: int,
                     emit: bool = False, stats: dict | None = None):
    """Plain version of star_stack: the same tree, expanded breadth-wise in
    batches of nodes (S, I, R, root) sharing `rem`, kept in a LIFO so memory
    stays bounded. A node of rem 1 makes its children as leaves.

    With `stats`, adds the tree's word operations by type: stats["popc_ops"],
    the popcounts (WW per live root for |S0|, WW per child node for |S|, WW
    per leaf for its star), and stats["bit_ops"], the 32-bit bitwise
    operations (2·WW per child node for S and I, WW three-input operations
    per leaf for the star).
    """
    C, W, WW = adj_full.shape
    dev = adj_full.device
    onehot = pack_bits(torch.eye(W, dtype=torch.bool, device=dev))
    n_cl = torch.zeros((), dtype=torch.int64, device=dev)
    n_st = torch.zeros((), dtype=torch.int64, device=dev)
    popc = int(live0.sum()) * WW
    bit = 0
    rows = []
    root_ok = live0 & (popcount32(S0).sum(1) >= k - 1)
    roots = root_ok.nonzero()[:, 0]
    stack = [(S0[roots], I0[roots], S0.new_zeros((roots.shape[0], WW)), roots,
              k - 1)]
    batch = max(1, _PLAIN_BUDGET // (W * WW))
    while stack:
        S, I, R, root, rem = stack.pop()
        if S.shape[0] > batch:
            stack.append((S[batch:], I[batch:], R[batch:], root[batch:], rem))
            S, I, R, root = S[:batch], I[:batch], R[:batch], root[:batch]
        item, i = unpack_bits(S).nonzero(as_tuple=True)
        b = root[item]
        cR = R[item] | onehot[i]
        cI = I[item] & adj_full[b, i]
        n = item.shape[0]
        if rem == 1:  # the children are k-cliques
            star = cI & ~cR
            n_cl += n
            n_st += popcount32(star).sum()
            popc += n * WW
            bit += n * WW
            if emit:
                rows.append(torch.cat([cR, star, b[:, None].to(torch.int32)],
                                      1))
            continue
        cS = S[item] & adj_dag[b, i]
        popc += n * WW
        bit += 2 * n * WW
        keep = popcount32(cS).sum(1) >= rem - 1
        if keep.any():
            stack.append((cS[keep], cI[keep], cR[keep], b[keep], rem - 1))
    if stats is not None:
        stats["popc_ops"] = stats.get("popc_ops", 0) + popc
        stats["bit_ops"] = stats.get("bit_ops", 0) + bit
    counts = torch.stack([n_cl, n_st])
    if not emit:
        return counts
    out = torch.cat(rows) if rows else adj_full.new_zeros((0, 2 * WW + 1))
    return counts, out


def star_runs_plain(adj_full, adj_dag, S0, I0, live0, *, k: int,
                    run: int = RUN_ITEMS):
    """Plain version of star_stack's run table and its leaves a run:
    (table int32[n, 4], leaves int64[n]). A row (b, i, first, items) is a
    run of `items` consecutive items sharing their parent: at depth 1 (k <=
    3) i = -1 and the items are the set bits of S0[b] ranked [first, first
    + items); at depth 2 (k >= 4) the set bits of S0[b] & adj_dag[b, i] so
    ranked, for each i ∈ S0[b] with at least k-2 of them. Roots ascending,
    then i; only roots with live0 and |S0| >= k-1. A run holds `run` items,
    the last of a parent fewer; at depth 2 a root with over W·run items
    takes runs of ceil(items / W), so that it has at most 2W runs. leaves:
    the k-cliques below each run; their exclusive prefix sums are the emit
    pass's first row of each run."""
    C, W, WW = adj_full.shape
    dev = adj_full.device
    root_ok = live0 & (popcount32(S0).sum(1) >= k - 1)
    bits0 = unpack_bits(S0) & root_ok[:, None]                     # [C, W]
    if k <= 3:
        n = bits0.sum(1)                                           # [C]
        runs = (n + run - 1) // run
        b = torch.repeat_interleave(torch.arange(C, device=dev), runs)
        first = (torch.arange(b.shape[0], device=dev)
                 - torch.repeat_interleave(runs.cumsum(0) - runs, runs)) * run
        i = torch.full_like(b, -1)
        cnt = torch.clamp(n[b] - first, max=run)
    else:
        n = popcount32(S0[:, None, :] & adj_dag).sum(2) * bits0   # [C, W]
        n = torch.where(n >= k - 2, n, 0)
        rb = torch.clamp((n.sum(1) + W - 1) // W, min=run)         # [C]
        runs = ((n + rb[:, None] - 1) // rb[:, None]).reshape(-1)
        pair = torch.repeat_interleave(torch.arange(C * W, device=dev), runs)
        b, i = pair // W, pair % W
        t = (torch.arange(pair.shape[0], device=dev)
             - torch.repeat_interleave(runs.cumsum(0) - runs, runs))
        first = t * rb[b]
        cnt = torch.minimum(n.reshape(-1)[pair] - first, rb[b])
    table = torch.stack([b, i, first, cnt], 1).to(torch.int32)
    return table, _run_leaves(adj_dag, S0, table, k)


def _run_leaves(adj_dag, S0, table, k):
    """The k-cliques below each run of `table` (star_runs_plain), counted
    apart from star_stack_plain: a node of rem 1 has |S| leaves, and one of
    rem r >= 2 those of its children along each i ∈ S, S & adj_dag[i], kept
    iff they hold at least r-1 bits."""
    C, W, WW = adj_dag.shape
    if k == 2:  # the items are leaves
        return table[:, 3].long()
    b, i, first, cnt = table.long().unbind(1)
    S = S0[b]                               # the runs' parents
    if k >= 4:                              # the root's child along i
        S = S & adj_dag[b, i]
    bits = unpack_bits(S)
    rank = bits.cumsum(1) - 1
    mine = bits & (rank >= first[:, None]) & (rank < (first + cnt)[:, None])
    tag, v = mine.nonzero(as_tuple=True)    # each run's items
    S = S[tag] & adj_dag[b[tag], v]
    rem = k - 1 - (1 if k <= 3 else 2)      # the items'
    keep = popcount32(S).sum(1) >= rem
    stack = [(S[keep], b[tag][keep], tag[keep], rem)]
    leaves = torch.zeros(b.shape[0], dtype=torch.int64, device=S0.device)
    batch = max(1, _PLAIN_BUDGET // (W * WW))
    while stack:
        S, root, tag, rem = stack.pop()
        if S.shape[0] > batch:
            stack.append((S[batch:], root[batch:], tag[batch:], rem))
            S, root, tag = S[:batch], root[:batch], tag[:batch]
        if rem == 1:
            leaves.index_add_(0, tag, popcount32(S).sum(1))
            continue
        item, u = unpack_bits(S).nonzero(as_tuple=True)
        cS = S[item] & adj_dag[root[item], u]
        keep = popcount32(cS).sum(1) >= rem - 1
        stack.append((cS[keep], root[item][keep], tag[item][keep], rem - 1))
    return leaves


def _count_pass(adj_full, adj_dag, S0, I0, live0, k, sizes=False):
    """K12's count pass (csrc/star_stack.cu's star_stack_count): (ctl int64:
    cliques, star total and runs, then the kernel's counters; table
    int32[2CW, 4], the run table in its first `runs` rows; leaf_cnt
    int64[2CW], each run's leaves). With `sizes` it counts the cliques
    only and leaves the star total at 0 for the emit pass to sum."""
    C, W, WW = adj_full.shape
    dev = adj_full.device
    cap = 2 * C * W
    ctl = torch.zeros(_CTL_WORDS + C + -(-cap // _BASE_TILE),
                      dtype=torch.int64, device=dev)
    table = torch.empty((cap, 4), dtype=torch.int32, device=dev)
    leaf_cnt = torch.empty(cap, dtype=torch.int64, device=dev)
    _kernels.launch(
        "star_stack", "star_stack_count", adj_full, adj_dag, S0, I0, live0,
        C, WW, k, int(sizes), ctl,
        torch.empty(C * W, dtype=torch.int32, device=dev), table, leaf_cnt)
    LAUNCHES["star_stack"] += 1
    return ctl, table, leaf_cnt


def star_stack(adj_full, adj_dag, S0, I0, live0, *, k: int,
               emit: bool = False):
    """The k-clique-stars rooted at a chunk, from its universe
    (build_local_univ) and live0 bool[C], the real roots. The search of
    gms_tpu's star_fused_chunk (:137): a root is searched iff live and
    |S0| >= k-1; the child of (S, I, R) along i ∈ S is (S & adj_dag[i],
    I & adj_full[i], R ∪ {i}); a child needing r >= 1 more members is
    searched iff |S| >= r, and one needing none is the clique {root} ∪ R
    with star I & ~R.

    Count mode: int64[2] (cliques, star total), no read-back. emit=True:
    (that pair, out int32[cliques, 2WW+1]), each row (R bits | star bits |
    root-local index) as gms_tpu's OUT rows; the kernel counts first, reads
    the count back and sizes `out` exactly. On the card the rows come in
    the same order on every run, the walk's (roots ascending, then the
    members in local order, depth-first); the plain version's order
    differs, and so may gms_tpu's: compare rows as sets.
    """
    name = "star_stack"
    _check_univ(name, adj_full, adj_dag, S0, I0, live0)
    if k < 2:
        raise ValueError(f"{name}: k must be >= 2, got {k}")
    if not _on_cuda(name, adj_full, adj_dag, S0, I0, live0):
        return star_stack_plain(adj_full, adj_dag, S0, I0, live0, k=k,
                                emit=emit)
    ctl, table, leaf_cnt = _count_pass(adj_full, adj_dag, S0, I0, live0, k,
                                       sizes=emit)
    counts = ctl[:2]
    if not emit:
        return counts
    n_rows, _, n_runs = ctl[:3].tolist()
    C, W, WW = adj_full.shape
    dev = adj_full.device
    out = torch.empty((n_rows, 2 * WW + 1), dtype=torch.int32, device=dev)
    if n_rows:
        _kernels.launch(
            "star_stack", "star_stack_emit", adj_full, adj_dag, S0, I0, C,
            WW, k, ctl, table, leaf_cnt, n_runs,
            torch.empty(n_runs, dtype=torch.int64, device=dev), out, n_rows)
        LAUNCHES["star_stack"] += 1
    return counts, out


def star_fused_chunk(nbr, rank_pad, chunk, *, w_words: int, k: int,
                     emit: bool = False):
    """Count (or, with emit, enumerate) the k-clique-stars rooted at
    `chunk`: gms_tpu's star_fused_chunk (:137) — build_local_univ (K11),
    then star_stack (K12). Pad slots hold V_pad."""
    univ = build_local_univ(nbr, rank_pad, chunk, w_words=w_words)
    return star_stack(*univ, chunk != nbr.shape[0], k=k, emit=emit)


# ---------------------------------------------------------------------------
# K13: decode
# ---------------------------------------------------------------------------

def decode_star_rows_plain(nbr, chunk, out):
    """Plain version of decode_star_rows."""
    V, D = nbr.shape
    C = chunk.shape[0]
    L, WW = out.shape[0], (out.shape[1] - 1) // 2
    W = 32 * WW
    gid = chunk[out[:, 2 * WW].long().clamp(0, C - 1)]
    rows = nbr[gid.long().clamp(0, V - 1), :min(W, D)]
    if rows.shape[1] < W:
        rows = torch.cat([rows, rows.new_full((L, W - rows.shape[1]), _SENT)],
                         1)
    ok = rows != _SENT

    def ids(bits):
        return torch.where(unpack_bits(bits.contiguous()) & ok, rows, -1)

    return gid, ids(out[:, :WW]), ids(out[:, WW:2 * WW])


def decode_star_rows(nbr, chunk, out):
    """Emitted rows (R bits | star bits | root-local index) -> (gid int32[L],
    the global root ids, members int32[L, W] and stars int32[L, W], the
    root's undirected slots in R and in the star, -1 in the other lanes).
    gms_tpu's decode_star_rows (:346)."""
    name = "decode_star_rows"
    _check(name, "nbr", nbr, 2)
    _check(name, "chunk", chunk, 1)
    _check(name, "out", out, 2)
    if out.shape[1] < 3 or out.shape[1] % 2 == 0:
        raise ValueError(f"{name}: out rows need 2WW+1 >= 3 words, got "
                         f"{out.shape[1]}")
    if not _on_cuda(name, nbr, chunk, out):
        return decode_star_rows_plain(nbr, chunk, out)
    L, WW = out.shape[0], (out.shape[1] - 1) // 2
    gid = torch.empty(L, dtype=torch.int32, device=out.device)
    ids = torch.empty((2, L, 32 * WW), dtype=torch.int32, device=out.device)
    _kernels.launch("star_decode", "decode_star_rows", nbr, nbr.shape[0],
                    nbr.shape[1], chunk, chunk.shape[0], out, L, WW, gid, ids)
    LAUNCHES[name] += 1
    return gid, ids[0], ids[1]


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------

def kclique_star_list(g: CSRGraph, k: int, *, device="cuda",
                      rank: np.ndarray | None = None,
                      root_chunk: int = DEFAULT_ROOT_CHUNK,
                      mode: str = "list"):
    """k-clique-stars of the undirected graph g.

    mode="list": [(clique frozenset, star frozenset)], one pair per k-clique
    (k_clique_star_list.cc semantics less its duplicate quirk). mode="count":
    (num_cliques, total_star_size) as ints — the ListOutput Count mode
    (output.h:15-96); every job's launches are enqueued before one
    read-back. `rank` defaults to the exact degeneracy rank.
    """
    if k < 2:
        raise ValueError("k must be >= 2")
    if mode not in ("list", "count"):
        raise ValueError(f"mode must be 'list' or 'count', got {mode!r}")
    dev = resolve(device)
    collect = mode == "list"
    if g.num_nodes == 0:
        return [] if collect else (0, 0)
    pg, rank_pad, jobs = plan_star_jobs(g, k, device=dev, rank=rank,
                                        root_chunk=root_chunk)
    nbr = pg.nbr
    if not collect:
        outs = [star_fused_chunk(nbr, rank_pad, chunk, w_words=ww, k=k)
                for chunk, ww in jobs]
        if not outs:
            return 0, 0
        n_cl, n_st = torch.stack(outs).sum(0).tolist()
        return n_cl, n_st
    rows = []
    for chunk, ww in jobs:
        _, out = star_fused_chunk(nbr, rank_pad, chunk, w_words=ww, k=k,
                                  emit=True)
        if out.shape[0]:
            rows.append(compact_star_rows(*decode_star_rows(nbr, chunk,
                                                            out)))
    return star_pairs(rows)


def compact_star_rows(gid, members, stars):
    """decode_star_rows' output with its -1 ids dropped on their device
    (row-major) and copied once: numpy (roots, member ids, each row's end
    among them, star ids, each row's end among them)."""
    def compact(ids):
        keep = ids >= 0
        return ids[keep].cpu().numpy(), keep.sum(1).cumsum(0).cpu().numpy()

    return (gid.cpu().numpy(), *compact(members), *compact(stars))


def star_pairs(jobs) -> list[tuple[frozenset, frozenset]]:
    """The [(clique, star)] frozensets of compacted jobs (compact_star_rows'
    tuples): each row's root and member ids, and its star ids, cut from the
    ids by the rows' ends, _PAIR_ROWS rows at a time, one slice a row.
    Python's cyclic garbage collector is off while they are built: the pairs
    hold no cycles, and its passes over the millions of frozensets they add
    cost more than building them."""
    pairs = []
    collecting = gc.isenabled()
    gc.disable()
    try:
        for roots, mem, mem_end, st, st_end in jobs:
            m0 = s0 = 0
            for a in range(0, len(roots), _PAIR_ROWS):
                me, se = mem_end[a:a + _PAIR_ROWS], st_end[a:a + _PAIR_ROWS]
                mids, sids = mem[m0:me[-1]].tolist(), st[s0:se[-1]].tolist()
                i = j = 0
                for root, m1, s1 in zip(roots[a:a + _PAIR_ROWS].tolist(),
                                        (me - m0).tolist(),
                                        (se - s0).tolist()):
                    pairs.append((frozenset([root, *mids[i:m1]]),
                                  frozenset(sids[j:s1])))
                    i, j = m1, s1
                m0, s0 = int(me[-1]), int(se[-1])
    finally:
        if collecting:
            gc.enable()
    return pairs

# ---------------------------------------------------------------------------
# host oracle + validity check (verifiers/valid_kcstar.h:17-60 role)
# ---------------------------------------------------------------------------

def kclique_star_oracle(g: CSRGraph, k: int) -> list[tuple[frozenset, frozenset]]:
    """Every k-subset that is a clique, with its star; gms_tpu's oracle."""
    rows = [set(g.out_neigh(v).tolist()) for v in range(g.num_nodes)]
    out = []
    for clique in combinations(range(g.num_nodes), k):
        if all(b in rows[a] for a, b in combinations(clique, 2)):
            star = set.intersection(*(rows[v] for v in clique)) - set(clique)
            out.append((frozenset(clique), frozenset(star)))
    return out


def is_valid_star(g: CSRGraph, clique: frozenset, star: frozenset) -> bool:
    """The clique is a clique and every star vertex is adjacent to all its
    members and outside it (a subset check, as gms_tpu's)."""
    rows = [set(g.out_neigh(v).tolist()) for v in range(g.num_nodes)]
    if not all(b in rows[a] for a, b in combinations(sorted(clique), 2)):
        return False
    return all(all(s in rows[v] for v in clique) and s not in clique
               for s in star)
