"""Triangle counting — the port of gms_tpu/algorithms/triangle_count.py.

Role of the reference's set-based TC (gms/algorithms/set_based/
triangle_count/parallel/total.h:7-24): orient the graph into a DAG
(rank[u] < rank[v]), then

    triangles = Σ_{(u,v) ∈ DAG} |N⁺(u) ∩ N⁺(v)|

with each triangle counted exactly once. `TrianglePlan` splits the DAG edges
as gms_tpu does: edges with a wide endpoint go through hub bitmaps (AND +
popcount over the small hub universe), the rest through 2-D degree tiers
(sorted-row intersection at the tier's widths). Counts are exact int64.

Per-vertex counts (`triangle_count_per_vertex`) run the same 2-D tiers with
no hub path, each triangle counted at its three corners; the dense-bitmap
count (`triangle_count_dense`) ANDs V-wide DAG bitmap rows per edge.

Seven device programs of gms_tpu carry these paths, and the rotation body of
its VertexShardedTrianglePlan (parallel/sharding.py:206-216) an eighth; each
is a hand-written CUDA kernel here (csrc/), wrapped by the function named:

    count_tier_mat              csrc/tier_intersect.cu  (stream mode)
    count_dag_edges             csrc/tier_intersect.cu  (gather mode)
    count_dag_edges_cross       csrc/tier_intersect.cu  (owned rows staged)
    count_dag_edges_per_vertex  csrc/tier_intersect.cu  (per-vertex mode)
    count_hub_groups_mat        csrc/hub_popcount.cu    (stream mode)
    count_hub_groups            csrc/hub_popcount.cu    (gather mode)
    build_hub_rows              csrc/hub_rows.cu
    count_hub_edges             csrc/bitmap_count.cu    (bitmap_edge_count)

Each wrapper checks device, dtype, shape and contiguity; for CPU tensors it
runs its `*_plain` PyTorch version, for CUDA tensors it launches the kernel
(raising if the launch fails) and adds one to `LAUNCHES[name]`. The plain
versions are never used on the main path when a card is present; chip_smoke.py
holds each kernel against its plain version on the card.

`triangle_count` also takes the compressed forms of graphs/compressed.py,
decoded to a CSRGraph first.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from gms_tpu_torch import _kernels
from gms_tpu_torch._kernels import check_tensor as _check
from gms_tpu_torch._kernels import on_cuda as _on_cuda
from gms_tpu_torch.device import resolve
from gms_tpu_torch.graphs.bitmap import BitmapGraph
from gms_tpu_torch.graphs.csr import CSRGraph
from gms_tpu_torch.graphs.tiles import PaddedGraph, SENTINEL, round_up
from gms_tpu_torch.harness import checks
from gms_tpu_torch.preprocessing import orient
from gms_tpu_torch.sets import ops
# popcount32 lives with the bitmap set algebra; k_clique, k_clique_star and
# bron_kerbosch import it from here
from gms_tpu_torch.sets.bitmap_ops import int32_bits, popcount32

DEFAULT_CHUNK = 4096

# Edge-tier widths: each DAG edge is processed at the narrowest width that
# covers both endpoint out-degrees (the reference's `omp schedule(dynamic)`
# skew handling, SURVEY.md §7 "Skew").
DEFAULT_TIERS = (16, 64, 256)

_SENT = int(SENTINEL)

# Kernel launches per wrapper, counted only where the CUDA kernel launches.
LAUNCHES = dict.fromkeys((
    "count_tier_mat", "count_dag_edges", "count_hub_groups_mat",
    "count_hub_groups", "build_hub_rows", "count_dag_edges_per_vertex",
    "count_hub_edges", "count_dag_edges_cross"), 0)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# host plan helpers (numpy, as in gms_tpu)
# ---------------------------------------------------------------------------

def _pad_edges(edges: np.ndarray, chunk: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad edge array to a chunk multiple; padding rows marked invalid."""
    e = len(edges)
    ep = round_up(max(e, 1), chunk)
    out = np.zeros((ep, 2), dtype=np.int32)
    out[:e] = edges
    valid = np.zeros(ep, dtype=np.int32)
    valid[:e] = 1
    return out, valid


def _tier_widths(d_pad: int, tiers) -> list[int]:
    """Ascending tier widths covering up to d_pad."""
    ws = sorted(w for w in tiers if w < d_pad)
    return ws + [d_pad]


def _bucketize(deg: np.ndarray, widths) -> np.ndarray:
    """Index of the narrowest width covering each degree."""
    out = np.full(len(deg), len(widths) - 1, dtype=np.int8)
    for i in reversed(range(len(widths) - 1)):
        out[deg <= widths[i]] = i
    return out


def partition_edges_2d(edges: np.ndarray, outdeg: np.ndarray, widths):
    """2-D degree tiering with smaller endpoint first.

    |A ∩ B| is symmetric, so each edge is stored (small-side, large-side) and
    bucketed by (width covering small out-degree, width covering large
    out-degree). Returns {(wa, wb): edges[K, 2]} with wa <= wb.
    """
    da = outdeg[edges[:, 0]]
    db = outdeg[edges[:, 1]]
    swap = da > db
    e = edges.copy()
    e[swap] = e[swap][:, ::-1]
    lo = np.minimum(da, db)
    hi = np.maximum(da, db)
    bl = _bucketize(lo, widths)
    bh = _bucketize(hi, widths)
    parts = {}
    for i in range(len(widths)):
        for j in range(i, len(widths)):
            sel = (bl == i) & (bh == j)
            if sel.any():
                parts[(widths[i], widths[j])] = e[sel]
    return parts


def _build_hub_groups(hedges_rows, words, tier_ws, guard_row):
    """Group wide edges by their v endpoint into K-slot pieces per width tier.

    hedges_rows: int32[E, 2] (u_row, v_row) with edges SORTED by v_row
        (all edges of one v contiguous) and all edges of one v sharing
        one width (words is per-edge but constant within a group).
    Returns {(width, K): (b_ids[G], nbrs[G, K])} numpy arrays, guard-padded.
    """
    KS = (16, 64)  # remainder tier, full tier
    v_rows = hedges_rows[:, 1]
    u_rows = np.ascontiguousarray(hedges_rows[:, 0])
    uniq, starts, counts = np.unique(v_rows, return_index=True,
                                     return_counts=True)
    gw = words[starts]  # per-group width (constant within group)
    wtier = np.searchsorted(tier_ws, gw, side="left")

    out = {}
    Kmax = KS[-1]
    full = counts // Kmax
    rem = counts - full * Kmax
    # piece lists: (group_index, piece_start, piece_len, K)
    n_full = int(full.sum())
    gi_full = np.repeat(np.arange(len(uniq)), full)
    within = np.arange(n_full) - np.repeat(np.cumsum(full) - full, full)
    st_full = starts[gi_full] + Kmax * within
    ln_full = np.full(n_full, Kmax, dtype=np.int64)
    k_full = np.full(n_full, Kmax, dtype=np.int64)

    has_rem = rem > 0
    gi_rem = np.flatnonzero(has_rem)
    st_rem = starts[gi_rem] + Kmax * full[gi_rem]
    ln_rem = rem[gi_rem]
    k_rem = np.where(ln_rem <= KS[0], KS[0], Kmax)

    gi = np.concatenate([gi_full, gi_rem])
    st = np.concatenate([st_full, st_rem])
    ln = np.concatenate([ln_full, ln_rem])
    kk = np.concatenate([k_full, k_rem])

    u_pad = np.concatenate([u_rows, np.full(Kmax, guard_row, np.int32)])
    for ti, w in enumerate(tier_ws):
        for K in KS:
            sel = (wtier[gi] == ti) & (kk == K)
            if not sel.any():
                continue
            s, l, g = st[sel], ln[sel], gi[sel]
            idx = s[:, None] + np.arange(K)[None, :]
            valid = np.arange(K)[None, :] < l[:, None]
            nbrs = np.where(valid, u_pad[np.minimum(idx, len(u_rows))],
                            guard_row).astype(np.int32)
            b_ids = v_rows[starts[g]].astype(np.int32)
            out[(w, K)] = (b_ids, nbrs)
    return out


def _group_chunk(width: int, k: int) -> int:
    """Groups per plain-version step: bounds per-step word traffic to ~8MB."""
    c = (1 << 21) // ((k + 1) * width)
    return int(min(1 << 14, max(1 << 3, 1 << int(np.log2(max(c, 1))))))


def _pad_groups(b_ids, nbrs, chunk, guard_row):
    g = len(b_ids)
    gp = round_up(max(g, 1), chunk)
    b = np.full(gp, guard_row, dtype=np.int32)
    b[:g] = b_ids
    n = np.full((gp, nbrs.shape[1]), guard_row, dtype=np.int32)
    n[:g] = nbrs
    return b, n


# per-step compare budget of the plain versions: chunk * width^2 ≈ this
_WORK_BUDGET = 1 << 26


def tier_chunk_2d(wa: int, wb: int) -> int:
    return int(min(1 << 15, max(1 << 8, _WORK_BUDGET // (wa * wb))))


# ---------------------------------------------------------------------------
# kernel wrappers and their plain versions
# ---------------------------------------------------------------------------

def _check_edges(name: str, edges: torch.Tensor, valid: torch.Tensor) -> None:
    _check(name, "edges", edges, 2)
    _check(name, "valid", valid, 1)
    if edges.shape[1] != 2 or valid.shape[0] != edges.shape[0]:
        raise ValueError(f"{name}: edges {tuple(edges.shape)} and valid "
                         f"{tuple(valid.shape)} do not match")


def _zero(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int64, device=device)


def count_tier_mat_plain(a_mat, b_mat, *, chunk: int | None = None):
    """Plain version of count_tier_mat: broadcast compares, `chunk` edges
    at a time, as gms_tpu's program (salt 0)."""
    wa, E = a_mat.shape
    chunk = chunk or max(E, 1)
    total = _zero(a_mat.device)
    for j in range(0, E, chunk):
        a = a_mat[:, j:j + chunk]
        b = b_mat[:, j:j + chunk]
        hit = torch.zeros(a.shape, dtype=torch.bool, device=a.device)
        for k in range(b.shape[0]):
            hit |= a == b[k][None, :]
        hit &= a != _SENT
        total += hit.sum(dtype=torch.int64)
    return total


def count_tier_mat(a_mat, b_mat, *, chunk: int | None = None):
    """Σ |a_e ∩ b_e| over materialized narrow-tier edges — int64 0-d tensor.

    a_mat: int32[wa, E], b_mat: int32[wb, E] — operand rows stored
    transposed (column e is edge e); padding edges are all-SENTINEL columns.
    Precondition: each column is strictly ascending with a SENTINEL tail.
    The kernel merges columns and miscounts any other column, which the
    plain version would not; GMS_TPU_PARANOID=1 checks it. Replaces
    gms_tpu's count_tier_mat (triangle_count.py:383); its `salt` is dropped,
    see csrc/tier_intersect.cu. `chunk` only steps the plain version.
    """
    name = "count_tier_mat"
    _check(name, "a_mat", a_mat, 2)
    _check(name, "b_mat", b_mat, 2)
    if a_mat.shape[1] != b_mat.shape[1]:
        raise ValueError(f"{name}: edge counts differ: {tuple(a_mat.shape)} "
                         f"vs {tuple(b_mat.shape)}")
    if checks.paranoid():
        checks.validate_sorted_rows(a_mat.T, name=f"{name} a_mat column")
        checks.validate_sorted_rows(b_mat.T, name=f"{name} b_mat column")
    if not _on_cuda(name, a_mat, b_mat):
        return count_tier_mat_plain(a_mat, b_mat, chunk=chunk)
    out = _zero(a_mat.device)
    _kernels.launch("tier_intersect", "tier_intersect_stream", a_mat, b_mat,
                    a_mat.shape[0], b_mat.shape[0], a_mat.shape[1], out)
    LAUNCHES[name] += 1
    return out


def _widths(nbr, width_a, width_b):
    d = nbr.shape[1]
    return min(width_a or d, d), min(width_b or d, d)


def count_dag_edges_plain(nbr, edges, valid, *, chunk: int = DEFAULT_CHUNK,
                          method: str = "compare", width_a: int | None = None,
                          width_b: int | None = None):
    """Plain version of count_dag_edges: gather `chunk` edges' rows, then
    sets.ops.intersect_count by `method`."""
    return count_dag_edges_cross_plain(nbr, nbr, edges, valid, chunk=chunk,
                                       method=method, width_a=width_a,
                                       width_b=width_b)


def count_dag_edges(nbr, edges, valid, *, chunk: int = DEFAULT_CHUNK,
                    method: str = "compare", width_a: int | None = None,
                    width_b: int | None = None):
    """Σ over DAG edges of valid[e] * |N⁺(u) ∩ N⁺(v)| — int64 0-d tensor.

    nbr:   int32[V_pad, D_pad] oriented padded adjacency
    edges: int32[E, 2] (u, v), valid: int32[E] (0 for padding edges)
    width_a/width_b: row-slice widths; tier contract is
        outdeg(u) <= width_a and outdeg(v) <= width_b.
    Precondition: each row of nbr is strictly ascending with a SENTINEL tail
    (the padded layout). The kernel merges rows and miscounts any other row,
    which the plain version would not; GMS_TPU_PARANOID=1 checks it.
    Replaces gms_tpu's count_dag_edges (triangle_count.py:99). `chunk` and
    `method` only shape the plain version.
    """
    name = "count_dag_edges"
    _check(name, "nbr", nbr, 2)
    _check_edges(name, edges, valid)
    if checks.paranoid():
        checks.validate_sorted_rows(nbr, name=f"{name} nbr")
    if not _on_cuda(name, nbr, edges, valid):
        return count_dag_edges_plain(nbr, edges, valid, chunk=chunk,
                                     method=method, width_a=width_a,
                                     width_b=width_b)
    wa, wb = _widths(nbr, width_a, width_b)
    out = _zero(nbr.device)
    _kernels.launch("tier_intersect", "tier_intersect_gather", nbr,
                    nbr.shape[1], edges, valid, wa, wb, edges.shape[0], out)
    LAUNCHES[name] += 1
    return out


@dataclasses.dataclass(frozen=True)
class CrossSchedule:
    """K40's schedule of one bucket (cross_schedule): its valid edges
    grouped by owned row and cut into work items of at most `span` edges.
    items int32[I, 3]: (owned row, first edge, count), ascending by owned
    row; vis, wt, vlen int32[E']: each scheduled edge's visiting row, weight
    (valid) and the visiting row's live length (its entries before the
    first SENTINEL), item by item."""
    items: torch.Tensor
    vis: torch.Tensor
    wt: torch.Tensor
    vlen: torch.Tensor
    span: int

    def edges(self):
        """(edges int32[E', 2], valid int32[E']) in schedule order."""
        own = torch.repeat_interleave(self.items[:, 0], self.items[:, 2])
        return torch.stack([own, self.vis], 1), self.wt


# K40's work items: at most this many edges of one owned row, so that a hub
# row's edges spread over several blocks (RMAT-18's rotation: 32 edges an
# item and 512 were slower than 128, PERF.md PR 19)
CROSS_SPAN = 128


def row_lengths(nbr) -> torch.Tensor:
    """int32[V]: each padded row's live length (entries before its first
    SENTINEL; rows are ascending with a SENTINEL tail)."""
    return (nbr != _SENT).sum(1, dtype=torch.int32)


def cross_schedule(edges, valid, vis_len, *,
                   span: int = CROSS_SPAN) -> CrossSchedule:
    """K40's schedule of a bucket (edges int32[E, 2] as (owned row,
    visiting row), valid int32[E]; vis_len int32[Vb], the visiting table's
    row_lengths), built with torch ops on their device: the edges with
    valid != 0, stably sorted by owned row, each owned row's run cut into
    items of at most `span` edges. Padding edges (valid 0) are left out."""
    _check_edges("cross_schedule", edges, valid)
    _check("cross_schedule", "vis_len", vis_len, 1)
    if span < 1:
        raise ValueError(f"cross_schedule: span {span} < 1")
    dev = edges.device
    keep = (valid != 0).nonzero().reshape(-1)
    own, order = torch.sort(edges[keep, 0], stable=True)
    keep = keep[order]
    rows, counts = torch.unique_consecutive(own, return_counts=True)
    counts = counts.long()
    n_items = (counts + span - 1) // span
    run = torch.repeat_interleave(torch.arange(rows.numel(), device=dev),
                                  n_items)
    k = (torch.arange(run.numel(), device=dev)
         - (torch.cumsum(n_items, 0) - n_items)[run])
    first = (torch.cumsum(counts, 0) - counts)[run] + k * span
    count = torch.clamp(counts[run] - k * span, max=span)
    if keep.numel() >= 1 << 31:
        raise ValueError(f"cross_schedule: {keep.numel()} edges do not fit "
                         f"int32 offsets")
    items = torch.stack([rows[run].long(), first, count], 1).to(torch.int32)
    vis = edges[keep, 1].contiguous()
    return CrossSchedule(items.contiguous(), vis, valid[keep].contiguous(),
                         vis_len[vis.long()].contiguous(), span)


def _check_schedule(name, schedule, edges, valid, nbr_b) -> None:
    for what in ("items", "vis", "wt", "vlen"):
        t = getattr(schedule, what)
        _check(name, f"schedule.{what}", t, 2 if what == "items" else 1)
        if t.device != edges.device:
            raise ValueError(f"{name}: schedule.{what} on {t.device}, the "
                             f"edges on {edges.device}")
    if schedule.items.shape[1] != 3 or not \
            schedule.vis.shape == schedule.wt.shape == schedule.vlen.shape:
        raise ValueError(f"{name}: schedule items "
                         f"{tuple(schedule.items.shape)}, vis "
                         f"{tuple(schedule.vis.shape)}, wt "
                         f"{tuple(schedule.wt.shape)}, vlen "
                         f"{tuple(schedule.vlen.shape)}")
    if checks.paranoid():
        ref = cross_schedule(edges, valid, row_lengths(nbr_b),
                             span=schedule.span)
        if not all(torch.equal(getattr(ref, f), getattr(schedule, f))
                   for f in ("items", "vis", "wt", "vlen")):
            raise ValueError(f"{name}: the schedule is not these edges' "
                             f"and rows'")


def count_dag_edges_cross_plain(nbr_a, nbr_b, edges, valid, *,
                                chunk: int = DEFAULT_CHUNK,
                                method: str = "compare",
                                width_a: int | None = None,
                                width_b: int | None = None,
                                schedule: CrossSchedule | None = None):
    """Plain version of count_dag_edges_cross: gather `chunk` edges' rows,
    u's from nbr_a and v's from nbr_b, then sets.ops.intersect_count by
    `method`; with a schedule, over its edges (in its order) in place of
    edges and valid."""
    if schedule is not None:
        edges, valid = schedule.edges()
    wa = min(width_a or nbr_a.shape[1], nbr_a.shape[1])
    wb = min(width_b or nbr_b.shape[1], nbr_b.shape[1])
    total = _zero(nbr_a.device)
    for j in range(0, edges.shape[0], chunk):
        e = edges[j:j + chunk]
        a = nbr_a[e[:, 0], :wa]
        b = nbr_b[e[:, 1], :wb]
        cnt = ops.intersect_count(a, b, method=method)
        total += (cnt * valid[j:j + chunk]).sum(dtype=torch.int64)
    return total


def count_dag_edges_cross(nbr_a, nbr_b, edges, valid, *,
                          chunk: int = DEFAULT_CHUNK, method: str = "compare",
                          width_a: int | None = None,
                          width_b: int | None = None,
                          schedule: CrossSchedule | None = None):
    """Σ over edges e of valid[e] * |nbr_a[u] ∩ nbr_b[v]| — int64 0-d
    tensor, (u, v) = edges[e]: K40 over two row tables.

    nbr_a: int32[Va, Da], nbr_b: int32[Vb, Db] padded rows, strictly
    ascending with a SENTINEL tail (checked under GMS_TPU_PARANOID=1; the
    kernel looks entries up in the owned row and stops a visiting row past
    its last value, and miscounts any other row, which the plain version
    would not); edges: int32[E, 2] row indices into nbr_a (the
    owned row) and nbr_b (the visiting row), valid: int32[E] (0 for padding
    edges). width_a/width_b slice the rows (default their full width).
    schedule: cross_schedule(edges, valid, row_lengths(nbr_b)), which a
    caller that counts the same edges again builds once (checked against
    the edges and nbr_b under GMS_TPU_PARANOID=1); built here when None.
    The rotation body of gms_tpu's VertexShardedTrianglePlan
    (parallel/sharding.py:206-216), with the owned shard as nbr_a and the
    visiting shard as nbr_b, so no rows are copied into one table. `chunk`
    and `method` only shape the plain version.
    """
    name = "count_dag_edges_cross"
    _check(name, "nbr_a", nbr_a, 2)
    _check(name, "nbr_b", nbr_b, 2)
    _check_edges(name, edges, valid)
    if schedule is not None:
        _check_schedule(name, schedule, edges, valid, nbr_b)
    if checks.paranoid():
        checks.validate_sorted_rows(nbr_a, name=f"{name} nbr_a")
        checks.validate_sorted_rows(nbr_b, name=f"{name} nbr_b")
    if not _on_cuda(name, nbr_a, nbr_b, edges, valid):
        return count_dag_edges_cross_plain(
            nbr_a, nbr_b, edges, valid, chunk=chunk, method=method,
            width_a=width_a, width_b=width_b, schedule=schedule)
    if schedule is None:
        schedule = cross_schedule(edges, valid, row_lengths(nbr_b))
    wa = min(width_a or nbr_a.shape[1], nbr_a.shape[1])
    wb = min(width_b or nbr_b.shape[1], nbr_b.shape[1])
    out = _zero(nbr_a.device)
    _kernels.launch("tier_intersect", "tier_intersect_owned", nbr_a,
                    nbr_a.shape[1], nbr_b, nbr_b.shape[1], schedule.items,
                    schedule.items.shape[0], schedule.vis, schedule.wt,
                    schedule.vlen, wa, wb, out)
    LAUNCHES[name] += 1
    return out


def count_dag_edges_per_vertex_plain(nbr, edges, valid, *, num_segments: int,
                                     chunk: int = DEFAULT_CHUNK,
                                     method: str = "compare",
                                     width_a: int | None = None,
                                     width_b: int | None = None, out=None):
    """Plain version of count_dag_edges_per_vertex: gathered rows, the
    membership mask of sets.ops by `method`, int64 index_add_."""
    wa, wb = _widths(nbr, width_a, width_b)
    acc = (torch.zeros(num_segments, dtype=torch.int64, device=nbr.device)
           if out is None else out)

    def scatter(ids, add):  # gms_tpu's scatter drops ids out of range
        ok = (ids >= 0) & (ids < num_segments)
        acc.index_add_(0, ids[ok], add[ok])

    for j in range(0, edges.shape[0], chunk):
        e = edges[j:j + chunk].long()
        v = valid[j:j + chunk].long()
        a = nbr[e[:, 0], :wa]
        m = ops.member(a, nbr[e[:, 1], :wb], method=method) & (v[:, None] > 0)
        add = m.sum(1) * v
        scatter(e[:, 0], add)
        scatter(e[:, 1], add)
        w = a[m].long()
        scatter(w, torch.ones_like(w))
    return acc


def count_dag_edges_per_vertex(nbr, edges, valid, *, num_segments: int,
                               chunk: int = DEFAULT_CHUNK,
                               method: str = "compare",
                               width_a: int | None = None,
                               width_b: int | None = None, out=None):
    """Per-vertex triangle participation counts — int64[num_segments].

    Each triangle (u, v, w) found on DAG edge (u, v) with witness w adds
    valid[e] * c to u and v, c = |N⁺(u) ∩ N⁺(v)|, and 1 to each witness w,
    for edges with valid[e] > 0; ids outside [0, num_segments) are dropped.
    The counts are added into `out` (int64[num_segments] on nbr's device)
    when it is given, else into a new zeroed tensor; either is returned.
    Same inputs and preconditions as count_dag_edges: nbr's rows strictly
    ascending with a SENTINEL tail (the kernel merges them; GMS_TPU_PARANOID=1
    checks it). Replaces gms_tpu's count_dag_edges_per_vertex
    (triangle_count.py:129); SENTINEL slots are never counted, so its
    overflow bucket has no counterpart. `chunk` and `method` only shape the
    plain version.
    """
    name = "count_dag_edges_per_vertex"
    _check(name, "nbr", nbr, 2)
    _check_edges(name, edges, valid)
    if out is not None:
        _check(name, "out", out, 1, torch.int64)
        if out.shape[0] != num_segments or out.device != nbr.device:
            raise ValueError(f"{name}: out is {tuple(out.shape)} on "
                             f"{out.device}, expected ({num_segments},) on "
                             f"{nbr.device}")
    if checks.paranoid():
        checks.validate_sorted_rows(nbr, name=f"{name} nbr")
    if not _on_cuda(name, nbr, edges, valid):
        return count_dag_edges_per_vertex_plain(
            nbr, edges, valid, num_segments=num_segments, chunk=chunk,
            method=method, width_a=width_a, width_b=width_b, out=out)
    wa, wb = _widths(nbr, width_a, width_b)
    if out is None:
        out = torch.zeros(num_segments, dtype=torch.int64, device=nbr.device)
    _kernels.launch("tier_intersect", "tier_intersect_vertex", nbr,
                    nbr.shape[1], edges, valid, wa, wb, edges.shape[0], out,
                    num_segments)
    LAUNCHES[name] += 1
    return out


def count_hub_edges_plain(rows, row_of, edges, valid, *, chunk: int,
                          width: int | None = None):
    """Plain version of count_hub_edges, `chunk` edges at a time."""
    w = min(width or rows.shape[1], rows.shape[1])
    total = _zero(rows.device)
    for j in range(0, edges.shape[0], chunk):
        e = edges[j:j + chunk].long()
        if row_of is not None:
            e = row_of[e.clamp(0, row_of.shape[0] - 1)].long()
        e = e.clamp(0, rows.shape[0] - 1)
        cnt = popcount32(rows[e[:, 0], :w] & rows[e[:, 1], :w]).sum(1)
        total += (cnt * valid[j:j + chunk]).sum()
    return total


def count_hub_edges(rows, row_of, edges, valid, *, chunk: int,
                    width: int | None = None):
    """Σ valid[e] * popcount(row(u) & row(v)) over edges — int64 0-d tensor.

    rows:   int32[N, HW] bitmap rows (gms_tpu's uint32 bits): hub bitmaps
            [Nw, HW], or a BitmapGraph's words [V_pad, W_pad]
    row_of: int32[V_pad+1] vertex -> row, or None (edges hold rows)
    width:  prefix width in words; only rows[:, :width] is read
    Indices clip into range, as gms_tpu's `mode="clip"` takes. Replaces
    gms_tpu's count_hub_edges (triangle_count.py:184). `chunk` only steps
    the plain version.
    """
    name = "count_hub_edges"
    _check(name, "rows", rows, 2)
    _check_edges(name, edges, valid)
    if row_of is not None:
        _check(name, "row_of", row_of, 1)
    tensors = (rows, edges, valid) + (() if row_of is None else (row_of,))
    if not _on_cuda(name, *tensors):
        return count_hub_edges_plain(rows, row_of, edges, valid, chunk=chunk,
                                     width=width)
    out = _zero(rows.device)
    _kernels.launch("bitmap_count", "bitmap_edge_count", rows, rows.shape[0],
                    rows.shape[1], row_of,
                    0 if row_of is None else row_of.shape[0], edges, valid,
                    edges.shape[0], min(width or rows.shape[1], rows.shape[1]),
                    out)
    LAUNCHES[name] += 1
    return out


def count_hub_groups_mat_plain(b_mat, a_mat, *, chunk: int | None = None):
    """Plain version of count_hub_groups_mat, `chunk` groups at a time."""
    G = b_mat.shape[0]
    chunk = chunk or max(G, 1)
    total = _zero(b_mat.device)
    for j in range(0, G, chunk):
        both = a_mat[j:j + chunk] & b_mat[j:j + chunk, None, :]
        total += popcount32(both).sum()
    return total


def count_hub_groups_mat(b_mat, a_mat, *, chunk: int | None = None):
    """Σ popcount(a & b) over materialized hub groups — int64 0-d tensor.

    b_mat: int32[G, W]     each group's head row (v), sliced to its width
    a_mat: int32[G, K, W]  the group's partner rows (u)
    Words are int32 carrying gms_tpu's uint32 bits. Replaces gms_tpu's
    count_hub_groups_mat (triangle_count.py:359); its `salt` is dropped.
    `chunk` only steps the plain version.
    """
    name = "count_hub_groups_mat"
    _check(name, "b_mat", b_mat, 2)
    _check(name, "a_mat", a_mat, 3)
    G, W = b_mat.shape
    if a_mat.shape[0] != G or a_mat.shape[2] != W:
        raise ValueError(f"{name}: a_mat {tuple(a_mat.shape)} does not match "
                         f"b_mat {tuple(b_mat.shape)}")
    if not _on_cuda(name, b_mat, a_mat):
        return count_hub_groups_mat_plain(b_mat, a_mat, chunk=chunk)
    out = _zero(b_mat.device)
    _kernels.launch("hub_popcount", "hub_popcount_stream", b_mat, a_mat, G,
                    a_mat.shape[1], W, out)
    LAUNCHES[name] += 1
    return out


def count_hub_groups_plain(rows, b_ids, nbrs, *, chunk: int, width: int,
                           k: int):
    """Plain version of count_hub_groups, `chunk` groups at a time."""
    w = min(width, rows.shape[1])
    total = _zero(rows.device)
    for j in range(0, b_ids.shape[0], chunk):
        b = rows[b_ids[j:j + chunk], :w]
        a = rows[nbrs[j:j + chunk].reshape(-1), :w].reshape(b.shape[0], k, w)
        total += popcount32(a & b[:, None, :]).sum()
    return total


def count_hub_groups(rows, b_ids, nbrs, *, chunk: int, width: int, k: int):
    """Σ over groups g, slots j of popcount(rows[b_ids[g]] & rows[nbrs[g,j]])
    over the first `width` words — int64 0-d tensor.

    rows:  int32[Nw+1, HW] hub bitmaps, last row all-zero (guard)
    b_ids: int32[G] row of each group's v (guard-padded)
    nbrs:  int32[G, k] rows of the group's u's (guard-padded)
    Replaces gms_tpu's count_hub_groups (triangle_count.py:239). `chunk`
    only steps the plain version.
    """
    name = "count_hub_groups"
    _check(name, "rows", rows, 2)
    _check(name, "b_ids", b_ids, 1)
    _check(name, "nbrs", nbrs, 2)
    if nbrs.shape != (b_ids.shape[0], k):
        raise ValueError(f"{name}: nbrs {tuple(nbrs.shape)} is not "
                         f"({b_ids.shape[0]}, {k})")
    if not _on_cuda(name, rows, b_ids, nbrs):
        return count_hub_groups_plain(rows, b_ids, nbrs, chunk=chunk,
                                      width=width, k=k)
    out = _zero(rows.device)
    _kernels.launch("hub_popcount", "hub_popcount_gather", rows, rows.shape[1],
                    b_ids, nbrs, b_ids.shape[0], k,
                    min(width, rows.shape[1]), out)
    LAUNCHES[name] += 1
    return out


def build_hub_rows_plain(nbr, hub_id, wide_ids, *, hub_words: int):
    """Plain version of build_hub_rows: clip gathers, then an int64
    scatter-add of each bit (distinct bits, so add == or), as gms_tpu."""
    v_pad = nbr.shape[0]
    r = nbr[wide_ids.clamp(0, v_pad - 1).long()]                     # [Nw, D]
    h = hub_id[r.clamp(0, hub_id.shape[0] - 1).long()].long()       # [Nw, D]
    keep = (h >= 0) & (h < 32 * hub_words)
    row = torch.arange(r.shape[0], device=nbr.device)[:, None].expand_as(h)
    hk = h[keep]
    out = torch.zeros(r.shape[0] * hub_words, dtype=torch.int64,
                      device=nbr.device)
    out.index_add_(0, row[keep] * hub_words + (hk >> 5),
                   torch.ones_like(hk) << (hk & 31))
    return int32_bits(out).view(r.shape[0], hub_words)


def build_hub_rows(nbr, hub_id, wide_ids, *, hub_words: int):
    """int32[Nw, hub_words] hub bitmaps: bit hub_id[w] set for w ∈
    N⁺(wide_ids[i]).

    hub_id: int32[V_pad+1]; the SENTINEL-clip slot and non-hub vertices map
    to 32*hub_words (dropped). Replaces gms_tpu's build_hub_rows
    (triangle_count.py:219).
    """
    name = "build_hub_rows"
    _check(name, "nbr", nbr, 2)
    _check(name, "hub_id", hub_id, 1)
    _check(name, "wide_ids", wide_ids, 1)
    if hub_id.shape[0] != nbr.shape[0] + 1:
        raise ValueError(f"{name}: hub_id has {hub_id.shape[0]} entries, "
                         f"expected V_pad+1 = {nbr.shape[0] + 1}")
    if not _on_cuda(name, nbr, hub_id, wide_ids):
        return build_hub_rows_plain(nbr, hub_id, wide_ids, hub_words=hub_words)
    out = torch.zeros((wide_ids.shape[0], hub_words), dtype=torch.int32,
                      device=nbr.device)
    _kernels.launch("hub_rows", "build_hub_rows", nbr, nbr.shape[0],
                    nbr.shape[1], hub_id, wide_ids, wide_ids.shape[0],
                    hub_words, out)
    LAUNCHES[name] += 1
    return out


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

def timed_trials(fn, device, trials: int):
    """(count, seconds a trial) of `trials` calls of fn, each returning an
    int64 0-d tensor, after one untimed call, launched back to back and
    timed as one span: CUDA events on the card, the host clock on the CPU.
    The counts are read back once and must agree."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        counts = [fn() for _ in range(trials)]
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3 / trials
    else:
        t0 = time.perf_counter()
        counts = [fn() for _ in range(trials)]
        dt = (time.perf_counter() - t0) / trials
    vals = torch.stack(counts).tolist()
    if any(v != vals[0] for v in vals):
        raise RuntimeError(f"nondeterministic counts: {vals}")
    return int(vals[0]), dt



class TrianglePlan:
    """Prepared (oriented + padded + tiered + device-resident) TC problem.

    Separates one-time graph preparation from the per-trial kernels,
    mirroring the reference's BenchmarkKernelBk split of "GraphExec
    buildTime" vs trial time (common/benchmark.h:96-133). Builds on
    `device` (default "cuda"; raises there without a card).
    """

    # materialized operand streams are built when their footprint fits this
    MAT_BUDGET = 3 << 30

    def __init__(self, g: CSRGraph, *, device="cuda",
                 rank: np.ndarray | None = None, chunk: int | None = None,
                 method: str = "compare", tiers=DEFAULT_TIERS,
                 hub_threshold: int | None = 65,
                 materialize: bool | None = None):
        dev = resolve(device)
        degree_oriented = rank is None
        if rank is None:
            rank = orient.degree_rank(g)
        dag = orient.orient(g, rank)
        pg = PaddedGraph.from_csr(dag, device=dev)
        self.device = dev
        self.num_edges_undirected = g.num_edges_undirected
        self.dag = dag
        self.padded = pg
        self.method = method
        self.hub = None
        self.hub_rows = self.hub_id = self.wide_ids = None

        def to_dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        all_edges = dag.edge_array()
        outdeg = np.asarray(dag.degrees)
        narrow = all_edges
        # hub-bitmap path (valid only under degree orientation): if EITHER
        # endpoint has out-degree >= t, every intersection member x satisfies
        # deg(x) >= deg(wide endpoint) >= t, so x ∈ H_t and the count is
        # popcount(bits_u & bits_v) over hub bitmaps.
        if degree_oriented and hub_threshold is not None and len(all_edges):
            t = hub_threshold
            deg_full = np.asarray(g.degrees)
            hub_mask = deg_full >= t
            n_hub = int(hub_mask.sum())
            da, db = outdeg[all_edges[:, 0]], outdeg[all_edges[:, 1]]
            hub_sel = (da >= t) | (db >= t)
            if n_hub and hub_sel.any():
                hw = round_up(n_hub, 32) // 32
                # hub ids in DESCENDING degree order (ties by id), so each
                # edge's whole intersection lives in a bitmap prefix
                hub_vids = np.flatnonzero(hub_mask).astype(np.int32)
                order = np.lexsort((hub_vids, -deg_full[hub_vids]))
                hub_vids = hub_vids[order]
                hub_id = np.full(pg.v_pad + 1, np.int32(32 * hw), dtype=np.int32)
                hub_id[hub_vids] = np.arange(n_hub, dtype=np.int32)
                hedges = all_edges[hub_sel]
                endpoint_ids = np.unique(hedges.reshape(-1)).astype(np.int32)
                guard_row = len(endpoint_ids)
                row_of = np.full(pg.v_pad + 1, np.int32(guard_row), np.int32)
                row_of[endpoint_ids] = np.arange(len(endpoint_ids),
                                                 dtype=np.int32)
                # build_hub_rows' inputs, kept for holding the kernel against
                # its plain version on the plan's own arrays
                self.hub_id = to_dev(hub_id)
                self.wide_ids = to_dev(endpoint_ids)
                rows = build_hub_rows(pg.nbr, self.hub_id, self.wide_ids,
                                      hub_words=hw)
                # all-zero guard row: padding slots gather it and add 0
                rows = torch.cat([rows, rows.new_zeros((1, hw))])
                # per-edge prefix width in words: covers {h: deg(h)>=deg(w)},
                # a function of the v endpoint alone
                hub_deg_desc = deg_full[hub_vids]  # descending
                dw = deg_full[hedges[:, 1]]
                cnt = np.searchsorted(-hub_deg_desc, -dw, side="right")
                words = -(-np.maximum(cnt, 1) // 32)
                # sort edges by v so each group is contiguous; vertex ids ->
                # row ids on the host
                order = np.lexsort((hedges[:, 0], hedges[:, 1]))
                hedges = row_of[hedges[order]]
                words = words[order]
                tier_ws = [w for w in (16, 32, 64, 128, 256) if w < hw] + [hw]
                groups = _build_hub_groups(hedges, words, tier_ws, guard_row)
                self.hub = []
                for (w, k), (b_ids, nbrs) in groups.items():
                    gc = chunk or _group_chunk(w, k)
                    b_ids, nbrs = _pad_groups(b_ids, nbrs, gc, guard_row)
                    self.hub.append((w, k, gc, to_dev(b_ids), to_dev(nbrs)))
                self.hub_rows = rows
                narrow = all_edges[~hub_sel]

        widths = _tier_widths(pg.d_pad, tiers)
        parts = partition_edges_2d(narrow, outdeg, widths)
        self.tiers = []
        for (wa, wb), part in parts.items():
            c = chunk or tier_chunk_2d(wa, wb)
            edges, valid = _pad_edges(part, c)
            self.tiers.append((wa, wb, c, to_dev(edges), to_dev(valid)))

        if materialize is None:
            materialize = self.traffic_bytes() <= self.MAT_BUDGET
        self.tiers_mat = self.hub_mat = None
        if materialize:
            self._materialize()

    def _materialize(self):
        """Pre-gather every operand row into contiguous per-edge streams.

        One-time build work (the reference's SetGraph build role) that turns
        the per-trial kernels from row gathers into sequential streams.
        Gathers run on the plan's device; footprint == traffic_bytes(),
        gated by MAT_BUDGET.
        """
        nbr = self.padded.nbr
        self.tiers_mat = []
        for wa, wb, c, edges, valid in self.tiers:
            cm = min(c, 1 << max(8, int(np.log2(max((1 << 21) // (wa + wb), 1)))))
            keep = (valid > 0)[:, None]  # padding -> all-SENTINEL
            a_mat = torch.where(keep, nbr[edges[:, 0], :wa], _SENT)
            b_mat = torch.where(keep, nbr[edges[:, 1], :wb], _SENT)
            self.tiers_mat.append((cm, a_mat.T.contiguous(),
                                   b_mat.T.contiguous()))
        self.hub_mat = []
        for w, k, gc, b_ids, nbrs in self.hub or []:
            b_mat = self.hub_rows[b_ids, :w].contiguous()              # [G, W]
            a_mat = self.hub_rows[nbrs.reshape(-1), :w].reshape(
                len(b_ids), k, w).contiguous()                         # [G, K, W]
            self.hub_mat.append((gc, b_mat, a_mat))

    def _count(self) -> torch.Tensor:
        """Launch one trial's kernels; the total as an int64 0-d tensor."""
        if self.tiers_mat is not None:
            outs = [count_tier_mat(a, b, chunk=cm)
                    for cm, a, b in self.tiers_mat]
            outs += [count_hub_groups_mat(b, a, chunk=gc)
                     for gc, b, a in self.hub_mat]
        else:
            outs = self.run_async()
        if not outs:
            return _zero(self.device)
        return torch.stack(outs).sum()

    def run(self) -> int:
        return int(self._count())

    def run_async(self) -> list:
        """Launch every tier's K1 and every hub group's K2 gather entry;
        returns their int64 0-d tensors unsummed, nothing read back.
        gms_tpu's run_async (triangle_count.py:571)."""
        out = [count_dag_edges(self.padded.nbr, edges, valid, chunk=c,
                               method=self.method, width_a=wa, width_b=wb)
               for wa, wb, c, edges, valid in self.tiers]
        out += [count_hub_groups(self.hub_rows, b_ids, nbrs, chunk=gc,
                                 width=w, k=k)
                for w, k, gc, b_ids, nbrs in self.hub or []]
        return out

    def run_steady(self, trials: int = 8):
        """Steady-state timing: (count, seconds_per_trial).

        One warm-up trial, then `trials` trials launched back to back and
        timed as one span: CUDA events on the card, the host clock on the
        CPU. Counts are read back once and must agree across trials.
        """
        return timed_trials(self._count, self.device, trials)

    def traffic_bytes(self) -> int:
        """Modeled operand traffic of one trial (for roofline reporting)."""
        total = 0
        for wa, wb, c, edges, valid in self.tiers:
            total += valid.numel() * (wa + wb) * 4
        for w, k, gc, b_ids, nbrs in self.hub or []:
            total += (b_ids.numel() + nbrs.numel()) * w * 4
        return total


def triangle_count(g, *, device="cuda", rank: np.ndarray | None = None,
                   chunk: int | None = None, method: str = "compare",
                   tiers=DEFAULT_TIERS) -> int:
    """End-to-end total triangle count of an undirected graph.

    Accepts a CSRGraph or a compressed form (KbitGraph, KbitGraphBucketed,
    HybridGraph), which decodes through graphs.compressed.as_csr, as
    gms_tpu's does (triangle_count.py:720-724).
    """
    if not isinstance(g, CSRGraph):
        from gms_tpu_torch.graphs.compressed import as_csr

        g = as_csr(g)
    return TrianglePlan(g, device=device, rank=rank, chunk=chunk,
                        method=method, tiers=tiers).run()


def plan_per_vertex(g: CSRGraph, *, device="cuda",
                    rank: np.ndarray | None = None, chunk: int | None = None,
                    tiers=DEFAULT_TIERS):
    """Host half of triangle_count_per_vertex: orient, pad and tier the DAG
    edges as gms_tpu does (2-D tiers, no hub path). Returns (PaddedGraph on
    `device`, [(wa, wb, chunk, edges, valid)] on `device`)."""
    dev = resolve(device)
    if rank is None:
        rank = orient.degree_rank(g)
    dag = orient.orient(g, rank)
    pg = PaddedGraph.from_csr(dag, device=dev)
    widths = _tier_widths(pg.d_pad, tiers)
    parts = partition_edges_2d(dag.edge_array(), np.asarray(dag.degrees),
                               widths)
    out = []
    for (wa, wb), part in parts.items():
        c = chunk or tier_chunk_2d(wa, wb)
        edges, valid = _pad_edges(part, c)
        out.append((wa, wb, c, torch.from_numpy(edges).to(dev),
                    torch.from_numpy(valid).to(dev)))
    return pg, out


def triangle_count_per_vertex(g: CSRGraph, *, device="cuda",
                              rank: np.ndarray | None = None,
                              chunk: int | None = None,
                              method: str = "compare",
                              tiers=DEFAULT_TIERS) -> np.ndarray:
    """Per-vertex triangle counts (each triangle counted at all 3 corners),
    int64[num_nodes]. One launch per tier into one device accumulator, read
    back once (gms_tpu reads back once per tier)."""
    pg, parts = plan_per_vertex(g, device=device, rank=rank, chunk=chunk,
                                tiers=tiers)
    acc = torch.zeros(pg.v_pad, dtype=torch.int64, device=pg.nbr.device)
    for wa, wb, c, edges, valid in parts:
        count_dag_edges_per_vertex(
            pg.nbr, edges, valid, num_segments=pg.v_pad, chunk=c,
            method=method, width_a=wa, width_b=wb, out=acc)
    return acc[:g.num_nodes].cpu().numpy()


def triangle_count_dense(g: CSRGraph, *, device="cuda",
                         chunk: int = 1024) -> int:
    """Whole-graph dense-bitmap TC (the RoaringGraph-variant role,
    triangle_count.cc:22-48 over SetGraph<RoaringSet>): DAG rows as V-wide
    bitmaps (graphs/bitmap.py BitmapGraph), count =
    Σ_{(u,v)∈DAG} popcount(row_u & row_v). O(V²/8) bytes: the representation
    for small and moderate V, not the scale path (that is TrianglePlan).
    `chunk` pads the edge list, as gms_tpu's."""
    dev = resolve(device)
    dag = orient.orient(g, orient.degree_rank(g))
    bg = BitmapGraph.from_csr(dag, device=dev)
    edges, valid = _pad_edges(dag.edge_array(), chunk)
    return int(count_hub_edges(bg.words, None, torch.from_numpy(edges).to(dev),
                               torch.from_numpy(valid).to(dev), chunk=chunk))


# ---------------------------------------------------------------------------
# independent host oracle (role of triangle_count/verifier.h:13-42)
# ---------------------------------------------------------------------------

def triangle_count_oracle(g: CSRGraph) -> int:
    """Serial numpy recount: Σ_v Σ_{w∈N(v)} |N(v) ∩ N(w)| / 6."""
    total = 0
    rows = [set(g.out_neigh(v).tolist()) for v in range(g.num_nodes)]
    for v in range(g.num_nodes):
        for w in g.out_neigh(v):
            total += len(rows[v] & rows[int(w)])
    return total // 6


def triangle_count_per_vertex_oracle(g: CSRGraph) -> np.ndarray:
    out = np.zeros(g.num_nodes, dtype=np.int64)
    rows = [set(g.out_neigh(v).tolist()) for v in range(g.num_nodes)]
    for v in range(g.num_nodes):
        for w in g.out_neigh(v):
            out[v] += len(rows[v] & rows[int(w)])
    return out // 2  # each triangle seen twice per corner in this loop
