"""Vertex similarity metrics — the port of gms_tpu/algorithms/similarity.py.

Role of gms/algorithms/set_based/vertex_similarity/vertex_similarity.h:
seven metrics behind one dispatch (Metric enum :18, dispatch :201-221), with
the reference's quirks kept exactly:
  * Jaccard (:30-37): both sets empty -> 1.0; else c / (|A| + |B| + c) — NOT
    the textbook |A|+|B|-c (`jaccard_standard` gives that one);
  * Overlap (:63-66): c / min(|A|,|B|), 0/0 -> NaN as in C++;
  * AdamicAdar (:95-106): Σ_{w ∈ A∩B} 1/ln(deg w), +inf when deg w == 1;
  * Resource (:117-126), CommonNeighbors (:138-142), TotalNeighbors
    (:154-158), PreferentialAttachment (:168-171).
Scores are float32 from int32 counts, the Jaccard denominator summed as
(ca + cb) + c, so the five count metrics equal gms_tpu bit for bit; AA and
RA sum float32 weights in another order than XLA and equal it to rtol 1e-5.

Three hand-written CUDA kernels carry the module; for CPU tensors each wrapper
runs its plain version, for CUDA tensors it launches the kernel or raises, and
adds one to LAUNCHES[name]:
  * `pair_scores` (K18, csrc/pair_scores.cu, entry pair_scores_merge): a batch
    of (u, v) pairs over padded sorted rows;
  * `pair_scores_hub` (K19, same file): pairs whose v is a hub, each
    membership one bit test in v's id-space bitmap;
  * `tile_all_pairs` (K21, csrc/tile_scores.cu): a block of rows against
    every vertex from bitmap rows, AND+popcount — the engine of
    `all_pairs_scores`, which keeps gms_tpu's dense 0/1 interface and packs
    its inputs into words first.
The padded rows must be sorted with a SENTINEL tail (K1's contract, checked
under GMS_TPU_PARANOID=1); gms_tpu's broadcast compare takes any order.
"""

from __future__ import annotations

import numpy as np
import torch

from gms_tpu_torch import _kernels
from gms_tpu_torch.device import resolve
from gms_tpu_torch.graphs.tiles import SENTINEL, PaddedGraph
from gms_tpu_torch.harness import checks
from gms_tpu_torch.sets import ops
from gms_tpu_torch.sets.bitmap_ops import int32_bits

METRICS = (
    "jaccard", "overlap", "adamic_adar", "resource",
    "common_neighbors", "total_neighbors", "preferential_attachment",
)
WEIGHTED = ("adamic_adar", "resource")

# Kernel launches, counted only where a CUDA kernel launches.
LAUNCHES = {"pair_scores": 0, "pair_scores_hub": 0, "tile_all_pairs": 0}

_SENT = int(SENTINEL)
# elements a plain version materialises at once (row gathers, compares),
# the pairs it takes at once, and the largest Da·Db its "auto" compares
_PLAIN_BUDGET = 1 << 24
_PLAIN_PAIRS = 1 << 12
_PLAIN_COMPARE = 1 << 12


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _metric_id(name: str, metric: str) -> int:
    if metric not in METRICS:
        raise ValueError(f"{name}: unknown metric {metric!r}")
    return METRICS.index(metric)


def _deg_lookup(pg: PaddedGraph) -> torch.Tensor:
    """deg with one trailing slot so SENTINEL clip-gathers return 0."""
    return torch.cat([pg.deg, torch.zeros(1, dtype=torch.int32,
                                          device=pg.deg.device)])


def _take_clip(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t[idx] with idx clipped into range (jnp.take's mode="clip")."""
    return t[idx.long().clamp(0, t.shape[0] - 1)]


def _trim(rows: torch.Tensor) -> torch.Tensor:
    """rows cut after the last column that holds an element in any row —
    SENTINEL columns change no membership."""
    if rows.numel() == 0:
        return rows
    cols = torch.arange(1, rows.shape[1] + 1, device=rows.device)
    last = int(((rows != _SENT) * cols).amax())
    return rows[:, :max(last, 1)].contiguous()


def _scatter(scores, out, out_pos):
    """scores into out at out_pos (or whole), or scores alone without out."""
    if out is None:
        return scores
    if out_pos is None:
        out.copy_(scores)
    else:
        out[out_pos.long()] = scores
    return out


def _check_out(name, B, out, out_pos):
    if out_pos is not None:
        if out is None:
            raise ValueError(f"{name}: out_pos needs out")
        _kernels.check_tensor(name, "out_pos", out_pos, 1)
        if out_pos.shape[0] != B:
            raise ValueError(f"{name}: out_pos has {out_pos.shape[0]} entries "
                             f"for {B} pairs")
    if out is not None:
        _kernels.check_tensor(name, "out", out, 1, torch.float32)
        if out_pos is None and out.shape[0] != B:
            raise ValueError(f"{name}: out has {out.shape[0]} slots for {B} "
                             f"pairs")
    return [t for t in (out, out_pos) if t is not None]


def _check_pairs(name, pairs):
    _kernels.check_tensor(name, "pairs", pairs, 2)
    if pairs.shape[1] != 2:
        raise ValueError(f"{name}: pairs must be [B, 2], got "
                         f"{tuple(pairs.shape)}")


def _check_rows(name, what, rows):
    _kernels.check_tensor(name, what, rows, 2)
    if rows.shape[0] == 0:
        raise ValueError(f"{name}: {what} has no rows")


# ---------------------------------------------------------------------------
# the metric finish (plain)
# ---------------------------------------------------------------------------

def _finish_metric(metric: str, m, a, ca, cb, deg1):
    """Reference metric formulas from the membership mask `m` over the
    u-side row `a` (vertex_similarity.h:29-187 semantics, quirks intact)."""
    c = m.sum(dim=1, dtype=torch.int32).to(torch.float32)
    if metric == "jaccard":
        both_empty = (ca == 0) & (cb == 0)
        return torch.where(both_empty, torch.ones_like(c), c / (ca + cb + c))
    if metric == "overlap":
        return c / torch.minimum(ca, cb)
    if metric == "common_neighbors":
        return c
    if metric == "total_neighbors":
        return ca + cb - c
    if metric == "preferential_attachment":
        return ca * cb
    if metric in WEIGHTED:
        wdeg = _take_clip(deg1, a).to(torch.float32)
        w = 1.0 / torch.log(wdeg) if metric == "adamic_adar" else 1.0 / wdeg
        return torch.where(m, w, torch.zeros_like(w)).sum(dim=1)
    raise ValueError(f"unknown metric {metric!r}")


def _member(a, b, method):
    """ops.member in slices small enough for the compare's [B, Da, Db].
    "auto" takes the compare only for small rows: both tests give the same
    mask, and on the host the binary search is the cheaper one above that
    (gms_tpu's rule, Da·Db <= 2^21, is the TPU's)."""
    if method == "auto":
        method = ("compare" if a.shape[1] * b.shape[1] <= _PLAIN_COMPARE
                  else "searchsorted")
    per_row = a.shape[1] * b.shape[1] if method == "compare" else a.shape[1]
    step = max(1, _PLAIN_BUDGET // max(per_row, 1))
    return torch.cat([ops.member(a[s:s + step], b[s:s + step], method=method)
                      for s in range(0, max(a.shape[0], 1), step)])


def _plain_chunks(pairs, deg1, width):
    """(positions, pairs) slices of the pairs ordered by their larger
    degree, so that each slice's rows trim to about its own width."""
    big = torch.maximum(_take_clip(deg1, pairs[:, 0]),
                        _take_clip(deg1, pairs[:, 1]))
    order = torch.argsort(big, stable=True)
    step = max(1, min(_PLAIN_PAIRS, _PLAIN_BUDGET // max(width, 1)))
    return [(order[s:s + step], pairs[order[s:s + step]])
            for s in range(0, pairs.shape[0], step)]


def _plain_scores(pairs, deg1, width, score):
    """float32[B]: score(p) of each slice of _plain_chunks, in pair order."""
    out = torch.empty(pairs.shape[0], dtype=torch.float32,
                      device=pairs.device)
    for pos, p in _plain_chunks(pairs, deg1, width):
        out[pos] = score(p)
    return out


# ---------------------------------------------------------------------------
# K18: pair scores over padded rows
# ---------------------------------------------------------------------------

def pair_scores_plain(nbr, deg1, pairs, *, metric: str, method: str = "auto",
                      nbr_b=None):
    """Plain version of pair_scores: gathered rows (trimmed to their
    elements), gms_tpu's membership mask, the metric."""
    nb = nbr if nbr_b is None else nbr_b

    def score(p):
        a = _trim(_take_clip(nbr, p[:, 0]))
        b = _trim(_take_clip(nb, p[:, 1]))
        ca = _take_clip(deg1, p[:, 0]).to(torch.float32)
        cb = _take_clip(deg1, p[:, 1]).to(torch.float32)
        return _finish_metric(metric, _member(a, b, method), a, ca, cb, deg1)

    return _plain_scores(pairs, deg1, nbr.shape[1] + nb.shape[1], score)


def pair_scores(nbr, deg1, pairs, *, metric: str, method: str = "auto",
                nbr_b=None, out=None, out_pos=None):
    """float32[B] similarity for pairs int32[B, 2] over padded adjacency
    (gms_tpu similarity.py:51).

    deg1: int32[V_pad + 1] degree lookup (last slot 0, absorbs clip).
    nbr_b: optional second table for the v side. Every metric is symmetric
    in (u, v); the kernel walks the shorter row and searches the longer, so
    it needs no narrower slices. `method` picks the plain version's
    membership test (the kernel's is its own search; both give the same
    mask). With `out` (float32) the scores land in out[out_pos] (or fill
    out), so that pairs split between K18 and K19 score into one array in
    pair order. Rows must be sorted with a SENTINEL tail.
    """
    name = "pair_scores"
    mid = _metric_id(name, metric)
    nb = nbr if nbr_b is None else nbr_b
    _check_rows(name, "nbr", nbr)
    _check_rows(name, "nbr_b", nb)
    _kernels.check_tensor(name, "deg1", deg1, 1)
    _check_pairs(name, pairs)
    extra = _check_out(name, pairs.shape[0], out, out_pos)
    if checks.paranoid():
        checks.validate_sorted_rows(nbr, name=f"{name} nbr")
        checks.validate_sorted_rows(nb, name=f"{name} nbr_b")
    if not _kernels.on_cuda(name, nbr, nb, deg1, pairs, *extra):
        return _scatter(pair_scores_plain(nbr, deg1, pairs, metric=metric,
                                          method=method, nbr_b=nbr_b),
                        out, out_pos)
    B = pairs.shape[0]
    if out is None:
        out = torch.empty(B, dtype=torch.float32, device=nbr.device)
    if B:
        _kernels.launch("pair_scores", "pair_scores_merge", nbr, nbr.shape[0],
                        nbr.shape[1], nb, nb.shape[0], nb.shape[1], deg1,
                        deg1.shape[0], pairs, B, mid, out_pos, out)
        LAUNCHES[name] += 1
    return out


# ---------------------------------------------------------------------------
# K19: pair scores against a hub's bitmap
# ---------------------------------------------------------------------------

def pair_scores_hub_plain(nbr_a, deg1, bm_flat, hub_idx, pairs, *,
                          metric: str, vw: int):
    """Plain version of pair_scores_hub, gms_tpu's clipped bit tests."""

    def score(p):
        a = _trim(_take_clip(nbr_a, p[:, 0]))
        ca = _take_clip(deg1, p[:, 0]).to(torch.float32)
        cb = _take_clip(deg1, p[:, 1]).to(torch.float32)
        h = _take_clip(hub_idx, p[:, 1]).long()
        aw = a.long().clamp(0, 32 * vw - 1)
        widx = (h[:, None] * vw + (aw >> 5)).clamp(0, bm_flat.shape[0] - 1)
        words = bm_flat[widx].long()
        m = (((words >> (aw & 31)) & 1) == 1) & (a != _SENT)
        return _finish_metric(metric, m, a, ca, cb, deg1)

    return _plain_scores(pairs, deg1, nbr_a.shape[1], score)


def pair_scores_hub(nbr_a, deg1, bm_flat, hub_idx, pairs, *, metric: str,
                    vw: int, out=None, out_pos=None):
    """pair_scores for pairs whose v side is a HUB (gms_tpu similarity.py:94):
    membership of each u-row element is ONE bit test in the hub's id-space
    bitmap (bm_flat: int32[H * vw] words of packed rows, hub_idx:
    int32[V_pad + 1] hub slot of v). `out`/`out_pos` as in pair_scores."""
    name = "pair_scores_hub"
    mid = _metric_id(name, metric)
    _check_rows(name, "nbr_a", nbr_a)
    _kernels.check_tensor(name, "deg1", deg1, 1)
    _kernels.check_tensor(name, "bm_flat", bm_flat, 1)
    _kernels.check_tensor(name, "hub_idx", hub_idx, 1)
    _check_pairs(name, pairs)
    if vw < 1 or bm_flat.shape[0] == 0 or hub_idx.shape[0] == 0:
        raise ValueError(f"{name}: empty hub bitmaps or vw {vw} < 1")
    extra = _check_out(name, pairs.shape[0], out, out_pos)
    if checks.paranoid():
        checks.validate_sorted_rows(nbr_a, name=f"{name} nbr_a")
    if not _kernels.on_cuda(name, nbr_a, deg1, bm_flat, hub_idx, pairs,
                            *extra):
        return _scatter(pair_scores_hub_plain(nbr_a, deg1, bm_flat, hub_idx,
                                              pairs, metric=metric, vw=vw),
                        out, out_pos)
    B = pairs.shape[0]
    if out is None:
        out = torch.empty(B, dtype=torch.float32, device=nbr_a.device)
    if B:
        _kernels.launch("pair_scores", "pair_scores_hub", nbr_a,
                        nbr_a.shape[0], nbr_a.shape[1], deg1, deg1.shape[0],
                        bm_flat, bm_flat.shape[0], hub_idx, hub_idx.shape[0],
                        vw, pairs, B, mid, out_pos, out)
        LAUNCHES[name] += 1
    return out


# ---------------------------------------------------------------------------
# K21 tile_all_pairs: a block of rows against every vertex
# ---------------------------------------------------------------------------

def column_weights(deg, metric: str, width: int):
    """float32[width] weight of each column (neighbour id) for AA/RA: 1/ln d
    (+inf at d = 1) or 1/d where 0 < d, 0 at deg 0 and past len(deg) —
    gms_tpu's finite weights with its deg-1 +inf restored in place."""
    d = torch.zeros(width, dtype=torch.float32, device=deg.device)
    n = min(deg.shape[0], width)
    d[:n] = deg[:n].to(torch.float32)
    w = 1.0 / torch.log(d) if metric == "adamic_adar" else 1.0 / d
    return torch.where(d > 0, w, torch.zeros_like(w))


def dense_scores(metric: str, u_dense, v_dense, deg_u, deg_v, wcol=None):
    """float32[Bu, Bv] metric of every row pair of two float32 0/1 blocks
    (columns = neighbour ids), counts from one float32 matmul (exact below
    2^24) — gms_tpu's all_pairs_scores arithmetic. AA/RA take `wcol`
    (column_weights); an infinite weight becomes a second count matmul, as
    gms_tpu restores its deg-1 +inf."""
    ca = deg_u[:, None].to(torch.float32)
    cb = deg_v[None, :].to(torch.float32)
    if metric in WEIGHTED:
        inf = torch.isinf(wcol)
        s = (u_dense * torch.where(inf, 0.0, wcol)[None, :]) @ v_dense.T
        if bool(inf.any()):
            n_inf = (u_dense * inf.to(torch.float32)[None, :]) @ v_dense.T
            s = torch.where(n_inf > 0, torch.inf, s)
        return s
    common = u_dense @ v_dense.T
    if metric == "jaccard":
        both_empty = (ca == 0) & (cb == 0)
        return torch.where(both_empty, 1.0, common / (ca + cb + common))
    if metric == "overlap":
        return common / torch.minimum(ca, cb)
    if metric == "common_neighbors":
        return common
    if metric == "total_neighbors":
        return ca + cb - common
    if metric == "preferential_attachment":
        return (ca * cb).expand(common.shape).contiguous()
    raise ValueError(f"unknown metric {metric!r}")


def pack_rows(dense) -> torch.Tensor:
    """int32[R, ceil(C/32)] bit words of a dense [R, C] 0/1 block: bit j of
    word w set iff dense[r, 32w + j] != 0."""
    R, C = dense.shape
    W = (C + 31) // 32
    bits = torch.zeros((R, 32 * W), dtype=torch.int64, device=dense.device)
    bits[:, :C] = (dense != 0).to(torch.int64)
    lanes = torch.arange(32, device=dense.device, dtype=torch.int64)
    return int32_bits((bits.view(R, W, 32) << lanes).sum(dim=2))


def unpack_rows(words, width: int | None = None) -> torch.Tensor:
    """float32 0/1 [R, 32W] (or its first `width` columns) of int32 words,
    unpacked a slice of rows at a time."""
    R, W = words.shape
    C = 32 * W if width is None else width
    out = torch.empty((R, C), dtype=torch.float32, device=words.device)
    lanes = torch.arange(32, device=words.device, dtype=torch.int32)
    step = max(1, _PLAIN_BUDGET // max(32 * W, 1))
    for s in range(0, R, step):
        bits = (words[s:s + step, :, None] >> lanes) & 1
        out[s:s + step] = bits.view(-1, 32 * W)[:, :C]
    return out


def tile_all_pairs_plain(u_words, v_words, deg_u, deg_v, *, metric: str,
                         wcol=None):
    """Plain version of tile_all_pairs: unpack, then dense_scores."""
    return dense_scores(metric, unpack_rows(u_words), unpack_rows(v_words),
                        deg_u, deg_v, wcol)


def tile_all_pairs(u_words, v_words, deg_u, deg_v, *, metric: str,
                   wcol=None):
    """float32[Bu, Vn]: metric between rows u_words (int32[Bu, W] bitmap
    rows) and v_words (int32[Vn, W]); deg_u int32[Bu], deg_v int32[Vn]; wcol
    float32[32W] column weights for AA/RA. K21's all-pairs entry."""
    name = "tile_all_pairs"
    mid = _metric_id(name, metric)
    _kernels.check_tensor(name, "u_words", u_words, 2)
    _kernels.check_tensor(name, "v_words", v_words, 2)
    _kernels.check_tensor(name, "deg_u", deg_u, 1)
    _kernels.check_tensor(name, "deg_v", deg_v, 1)
    W = u_words.shape[1]
    if v_words.shape[1] != W or deg_u.shape[0] != u_words.shape[0] \
            or deg_v.shape[0] != v_words.shape[0]:
        raise ValueError(f"{name}: shapes do not match: {tuple(u_words.shape)}"
                         f", {tuple(v_words.shape)}, deg {deg_u.shape[0]}, "
                         f"{deg_v.shape[0]}")
    tensors = [u_words, v_words, deg_u, deg_v]
    if metric in WEIGHTED:
        _kernels.check_tensor(name, "wcol", wcol, 1, torch.float32)
        if wcol.shape[0] != 32 * W:
            raise ValueError(f"{name}: wcol has {wcol.shape[0]} entries, "
                             f"expected 32*W = {32 * W}")
        tensors.append(wcol)
    if not _kernels.on_cuda(name, *tensors):
        return tile_all_pairs_plain(u_words, v_words, deg_u, deg_v,
                                    metric=metric, wcol=wcol)
    Bu, Vn = u_words.shape[0], v_words.shape[0]
    out = torch.empty((Bu, Vn), dtype=torch.float32, device=u_words.device)
    if Bu and Vn:
        _kernels.launch("tile_scores", "tile_all_pairs", u_words, Bu, v_words,
                        Vn, W, deg_u, deg_v,
                        wcol if metric in WEIGHTED else None, mid, out)
        LAUNCHES[name] += 1
    return out


def all_pairs_scores_plain(adj_blk, deg_blk, adj_all, deg_all, *,
                           metric: str):
    """Plain version of all_pairs_scores: gms_tpu's float32 matmuls."""
    wcol = (column_weights(deg_all, metric, adj_blk.shape[1])
            if metric in WEIGHTED else None)
    return dense_scores(metric, adj_blk.to(torch.float32),
                        adj_all.to(torch.float32), deg_blk, deg_all, wcol)


def all_pairs_scores(adj_blk, deg_blk, adj_all, deg_all, *, metric: str):
    """float32[Bu, V]: metric between each block row and every vertex
    (gms_tpu similarity.py:115).

    adj_blk: float32/bf16[Bu, C] 0/1 rows of the block's vertices
    adj_all: [V, C] 0/1 adjacency; columns are neighbour ids, C >= V.
    On CUDA both are packed into bit words and K21 counts exactly with
    AND+popcount; on the CPU the plain version's float32 matmuls count
    (exact below 2^24).
    """
    _metric_id("all_pairs_scores", metric)
    if adj_blk.shape[1] != adj_all.shape[1]:
        raise ValueError("all_pairs_scores: adj_blk and adj_all widths differ")
    if not _kernels.on_cuda("all_pairs_scores", adj_blk, deg_blk, adj_all,
                            deg_all):
        return all_pairs_scores_plain(adj_blk, deg_blk, adj_all, deg_all,
                                      metric=metric)
    u_words, v_words = pack_rows(adj_blk), pack_rows(adj_all)
    wcol = (column_weights(deg_all, metric, 32 * u_words.shape[1])
            if metric in WEIGHTED else None)
    return tile_all_pairs(u_words, v_words, deg_blk.to(torch.int32).contiguous(),
                          deg_all.to(torch.int32).contiguous(), metric=metric,
                          wcol=wcol)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def jaccard_standard(nbr, deg1, pairs, *, method: str = "auto"):
    """Textbook Jaccard c / (|A| + |B| - c) (NOT the reference's variant);
    c is K18's common-neighbour count on CUDA."""
    c = pair_scores(nbr, deg1, pairs, metric="common_neighbors",
                    method=method)
    ca = _take_clip(deg1, pairs[:, 0]).to(torch.float32)
    cb = _take_clip(deg1, pairs[:, 1]).to(torch.float32)
    return torch.where((ca == 0) & (cb == 0), torch.ones_like(c),
                       c / (ca + cb - c))


def vertex_similarity(g, pairs, metric: str, *, device="cuda") -> np.ndarray:
    """Host convenience: scores for int pairs on an undirected CSR graph."""
    dev = resolve(device)
    pg = PaddedGraph.from_csr(g, device=dev)
    p = torch.from_numpy(np.array(pairs, dtype=np.int32).reshape(-1, 2))
    return pair_scores(pg.nbr, _deg_lookup(pg), p.to(dev),
                       metric=metric).cpu().numpy()


# ---------------------------------------------------------------------------
# host oracle (independent recount of each metric)
# ---------------------------------------------------------------------------

def vertex_similarity_oracle(g, pairs, metric: str) -> np.ndarray:
    rows = [set(g.out_neigh(v).tolist()) for v in range(g.num_nodes)]
    deg = g.degrees
    out = np.zeros(len(pairs), dtype=np.float64)
    for i, (u, v) in enumerate(np.asarray(pairs)):
        A, B = rows[int(u)], rows[int(v)]
        c = len(A & B)
        if metric == "jaccard":
            out[i] = 1.0 if not A and not B else c / (len(A) + len(B) + c)
        elif metric == "overlap":
            with np.errstate(invalid="ignore"):
                out[i] = np.float64(c) / min(len(A), len(B))
        elif metric == "common_neighbors":
            out[i] = c
        elif metric == "total_neighbors":
            out[i] = len(A | B)
        elif metric == "preferential_attachment":
            out[i] = len(A) * len(B)
        elif metric == "adamic_adar":
            with np.errstate(divide="ignore"):
                out[i] = sum(1.0 / np.log(deg[w]) for w in A & B)
        elif metric == "resource":
            out[i] = sum(1.0 / deg[w] for w in A & B)
        else:
            raise ValueError(metric)
    return out
