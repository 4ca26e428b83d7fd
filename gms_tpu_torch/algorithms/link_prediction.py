"""Link prediction (Liben-Nowell-Kleinberg) — the port of
gms_tpu/algorithms/link_prediction.py: train/test split, AUC,
precision/recall, top-q ranking.

Role of gms/algorithms/set_based/link_prediction/:
  * EdgeSampler (edge_sampler.h:24-155) and extract_random_test_edges
    (evaluation.h:32-83), add_false_links (:184-200),
    score_link_prediction_precision (:99-124): host numpy, copied from
    gms_tpu line for line so that both packages draw the same pairs;
  * score_link_prediction_auc (evaluation.h:137-174): `score_auc` and the
    prepared `AUCPlan`, (higher + 0.5 * equal) / trials with similarity on
    the train graph;
  * link_prediction_similarity (link_prediction.h:42-101): the top-q scan
    over ALL non-edges, a u-block at a time.

Kernels. Every trial's pairs are scored by similarity.pair_scores (K18) and,
for pairs whose larger-degree end is a hub, similarity.pair_scores_hub (K19),
both writing into one score array in pair order. `auc_count` (K20,
csrc/auc_count.cu) compares them and chains the next trial's shift on the
device. `tile_topq` (K21, csrc/tile_scores.cu) scores a u-block against the
v-strips from the CSR and its transpose, a wedge at a time, and keeps each
CTA's best q by gms_tpu's key. For CPU tensors each
wrapper runs its plain version; for CUDA tensors it launches its kernel or
raises, and adds one to LAUNCHES[name].

Exact-count semantics: scores are float32; AUC compares the same scores for
both sides, so the ordering is self-consistent.
"""

from __future__ import annotations

import time
import weakref
from typing import NamedTuple

import numpy as np
import torch

from gms_tpu_torch import _kernels
from gms_tpu_torch.algorithms import similarity as sim
from gms_tpu_torch.device import resolve
from gms_tpu_torch.graphs.csr import CSRGraph, _csr_from_sorted_pairs
from gms_tpu_torch.graphs.tiles import PaddedGraph, round_up

# Kernel launches, counted only where a CUDA kernel launches.
LAUNCHES = {"auc_count": 0, "tile_topq": 0}

HUB_THRESHOLD = 512          # rows with deg > this get id-space bitmaps
# K21's chunk of v and the strip table's column width (csrc/tile_scores.cu's
# kCW), and its u-rows a unit (kTU)
STRIP = 1024
_TU = 32
# link_prediction_similarity builds the strip table when it takes at most
# this many bytes, else the kernel finds each row's range by binary search
# (about a fifth slower on an H100 at RMAT-16: PERF.md row 14b)
STRIP_TABLE_BYTES = 1 << 31
# elements of a plain version's wedge batch (ascending_sums)
_PLAIN_BUDGET = 1 << 24


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# host sampling (gms_tpu's numpy, line for line)
# ---------------------------------------------------------------------------

def _csr_from_undirected(edges_uv: np.ndarray, num_nodes: int) -> CSRGraph:
    """Build symmetric CSR from unique (u < v) undirected edges."""
    if len(edges_uv) == 0:
        return CSRGraph(np.zeros(num_nodes + 1, np.int64), np.zeros(0, np.int32))
    both = np.concatenate([edges_uv, edges_uv[:, ::-1]])
    order = np.lexsort((both[:, 1], both[:, 0]))
    return _csr_from_sorted_pairs(both[order], num_nodes, directed=False)


def _edge_key(e: np.ndarray, n: int) -> np.ndarray:
    return e[:, 0].astype(np.int64) * n + e[:, 1]


def extract_random_test_edges(
    g: CSRGraph, test_edges_required: int, *, seed: int = 0
) -> tuple[CSRGraph, CSRGraph]:
    """Uniformly split off test edges; returns (g_train, g_test)."""
    und = g.undirected_edge_array()
    m = len(und)
    if test_edges_required > m:
        raise ValueError("not enough edges for requested test split")
    rng = np.random.default_rng(seed)
    pick = rng.choice(m, size=test_edges_required, replace=False)
    mask = np.zeros(m, dtype=bool)
    mask[pick] = True
    return (
        _csr_from_undirected(und[~mask], g.num_nodes),
        _csr_from_undirected(und[mask], g.num_nodes),
    )


def sample_non_edges(
    g: CSRGraph, count: int, *, seed: int = 0, forbid: CSRGraph | None = None
) -> np.ndarray:
    """Uniform non-edges of g (batch rejection), optionally also not in
    `forbid` — EdgeSampler::sample_complement role."""
    n = g.num_nodes
    keys = set(_edge_key(g.undirected_edge_array(), n).tolist())
    if forbid is not None:
        keys |= set(_edge_key(forbid.undirected_edge_array(), n).tolist())
    rng = np.random.default_rng(seed)
    out = np.empty((count, 2), dtype=np.int32)
    got = 0
    while got < count:
        batch = max(64, 2 * (count - got))
        uv = rng.integers(0, n, size=(batch, 2))
        uv = np.sort(uv, axis=1)
        ok = uv[:, 0] != uv[:, 1]
        uv = uv[ok]
        k = _edge_key(uv, n)
        fresh = np.array([kk not in keys for kk in k])
        uv = uv[fresh]
        take = min(len(uv), count - got)
        out[got : got + take] = uv[:take]
        got += take
    return out


def _sample_non_edges_fast(
    g: CSRGraph, count: int, *, seed: int = 0,
    forbid: CSRGraph | None = None) -> np.ndarray:
    """Vectorized `sample_non_edges` (sorted-key searchsorted rejection
    instead of a Python set probe per candidate)."""
    n = g.num_nodes
    keys = _edge_key(g.undirected_edge_array(), n)
    if forbid is not None:
        keys = np.concatenate([keys, _edge_key(
            forbid.undirected_edge_array(), n)])
    keys = np.sort(keys)
    rng = np.random.default_rng(seed)
    out = np.empty((count, 2), dtype=np.int32)
    got = 0
    while got < count:
        batch = max(1024, 2 * (count - got))
        uv = rng.integers(0, n, size=(batch, 2))
        uv = np.sort(uv, axis=1)
        uv = uv[uv[:, 0] != uv[:, 1]]
        k = _edge_key(uv, n)
        pos = np.searchsorted(keys, k)
        hit = (pos < len(keys)) & (keys[np.minimum(pos, len(keys) - 1)] == k)
        uv = uv[~hit]
        take = min(len(uv), count - got)
        out[got : got + take] = uv[:take]
        got += take
    return out


def add_false_links(
    g_train: CSRGraph, mutations: int, g_test: CSRGraph, *, seed: int = 42
) -> CSRGraph:
    """Replace `mutations` random train edges with random non-edges
    (evaluation.h:184-200)."""
    und = g_train.undirected_edge_array()
    rng = np.random.default_rng(seed)
    remove = rng.choice(len(und), size=mutations, replace=False)
    keep = np.ones(len(und), dtype=bool)
    keep[remove] = False
    create = sample_non_edges(g_train, mutations, seed=seed + 1, forbid=g_test)
    new = np.concatenate([und[keep], create.astype(und.dtype)])
    new = np.unique(new, axis=0)
    return _csr_from_undirected(new, g_train.num_nodes)


def score_precision_recall(
    predicted: np.ndarray, g_true: CSRGraph
) -> tuple[float, float]:
    """(precision, recall) of predicted (u < v) edges vs g_true's edges."""
    n = g_true.num_nodes
    true_keys = set(_edge_key(g_true.undirected_edge_array(), n).tolist())
    pred = np.asarray(predicted)
    pred = np.sort(pred, axis=1)
    tp = sum(1 for k in _edge_key(pred, n).tolist() if k in true_keys)
    precision = tp / max(len(pred), 1)
    recall = tp / max(len(true_keys), 1)
    return precision, recall


# ---------------------------------------------------------------------------
# train tables and the pair scorer
# ---------------------------------------------------------------------------

class _Tables(NamedTuple):
    """A train graph's tables on one device: the padded rows, the degree
    lookup, and id-space bitmaps (int32 words, vw a hub) of the rows with
    deg > HUB_THRESHOLD, with each vertex's hub slot."""
    pg: PaddedGraph
    deg1: torch.Tensor
    bm_flat: torch.Tensor
    hub_idx: torch.Tensor
    vw: int


# one train graph's tables stay resident: (weakref to the graph, device,
# tables)
_tables_cache: list = []


def _hub_bitmaps(g_train: CSRGraph, deg: np.ndarray, v_pad: int, hub_t: int):
    """(uint32[H, vw] id-space bitmaps of the rows with deg > hub_t, built
    from the host CSR, hub_idx int32[v_pad + 1], vw), as gms_tpu's."""
    hubs = np.nonzero(deg > hub_t)[0]
    vw = (v_pad + 31) // 32
    if len(hubs):
        hdeg = g_train.degrees[hubs].astype(np.int64)
        hi = np.repeat(np.arange(len(hubs)), hdeg)
        off = (np.arange(hdeg.sum())
               - np.repeat(np.cumsum(hdeg) - hdeg, hdeg))
        hv = g_train.indices[np.repeat(g_train.indptr[hubs], hdeg) + off]
        bm = np.zeros((len(hubs), vw), np.uint32)
        np.bitwise_or.at(bm, (hi, hv >> 5),
                         np.uint32(1) << (hv & 31).astype(np.uint32))
    else:
        bm = np.zeros((1, 1), np.uint32)
    hub_idx = np.zeros(v_pad + 1, np.int32)
    hub_idx[hubs] = np.arange(len(hubs), dtype=np.int32)
    return bm, hub_idx, vw


def _train_tables(g_train: CSRGraph, device="cuda") -> _Tables:
    """A train graph's tables on `device`, cached for one graph."""
    dev = resolve(device)
    if _tables_cache:
        ref, cached_dev, t = _tables_cache[0]
        if ref() is g_train and cached_dev == dev:
            return t
    pg = PaddedGraph.from_csr(g_train, device=dev)
    deg = np.zeros(pg.v_pad, np.int32)
    deg[:g_train.num_nodes] = g_train.degrees
    bm, hub_idx, vw = _hub_bitmaps(g_train, deg, pg.v_pad, HUB_THRESHOLD)
    t = _Tables(pg, sim._deg_lookup(pg),
                torch.from_numpy(bm.reshape(-1).view(np.int32)).to(dev),
                torch.from_numpy(hub_idx).to(dev), vw)
    _tables_cache[:] = [(weakref.ref(g_train), dev, t)]
    return t


class _PairSplit:
    """Pairs ordered smaller-degree end first and split between K18 (v not
    a hub) and K19 (v a hub), each with its positions in pair order — on the
    tables' device, made once. gms_tpu buckets pairs into degree tiers so
    that XLA's static shapes track each pair's degree; the kernels take each
    row to its first SENTINEL and need no buckets."""

    def __init__(self, edges: np.ndarray, t: _Tables):
        deg = t.pg.deg.cpu().numpy()
        device = t.pg.nbr.device
        e = np.asarray(edges, dtype=np.int32).reshape(-1, 2)
        # smaller-degree endpoint first: all metrics are symmetric
        swap = deg[e[:, 0]] > deg[e[:, 1]]
        e = np.where(swap[:, None], e[:, ::-1], e)
        is_hub = deg[e[:, 1]] > HUB_THRESHOLD

        def part(sel):
            return (torch.from_numpy(np.ascontiguousarray(e[sel])).to(device),
                    torch.from_numpy(np.nonzero(sel)[0].astype(np.int32)
                                     ).to(device))

        self.size = len(e)
        self.merge = part(~is_hub)
        self.hub = part(is_hub)


def _score_into(out, t: _Tables, split: _PairSplit, metric: str):
    """Scores of `split`'s pairs into out[0, split.size), in pair order: one
    K18 launch for the non-hub pairs and one K19 launch for the hub pairs."""
    (pn, qn), (ph, qh) = split.merge, split.hub
    if pn.shape[0]:
        sim.pair_scores(t.pg.nbr, t.deg1, pn, metric=metric, out=out,
                        out_pos=qn)
    if ph.shape[0]:
        sim.pair_scores_hub(t.pg.nbr, t.deg1, t.bm_flat, t.hub_idx, ph,
                            metric=metric, vw=t.vw, out=out, out_pos=qh)
    return out


def _score_into_plain(out, t: _Tables, split: _PairSplit, metric: str):
    """_score_into through the plain versions of K18 and K19, on the
    tables' device: the reference the kernels are held to."""
    (pn, qn), (ph, qh) = split.merge, split.hub
    if pn.shape[0]:
        out[qn.long()] = sim.pair_scores_plain(t.pg.nbr, t.deg1, pn,
                                               metric=metric)
    if ph.shape[0]:
        out[qh.long()] = sim.pair_scores_hub_plain(
            t.pg.nbr, t.deg1, t.bm_flat, t.hub_idx, ph, metric=metric,
            vw=t.vw)
    return out


def _pair_scores_np(t: _Tables, edges, metric: str,
                    score_into=_score_into) -> np.ndarray:
    """float32[len(edges)] scores of `edges` over the tables `t`."""
    split = _PairSplit(edges, t)
    out = torch.empty(split.size, dtype=torch.float32, device=t.pg.nbr.device)
    return score_into(out, t, split, metric).cpu().numpy()


def _auc_pairs(g_true, g_test, num_trials, seed):
    """score_auc's sampled (true edges, false edges)."""
    test_und = g_test.undirected_edge_array()
    if len(test_und) == 0:
        raise ValueError("empty test graph")
    rng = np.random.default_rng(seed)
    true_edges = test_und[rng.integers(0, len(test_und), size=num_trials)]
    false_edges = sample_non_edges(g_true, num_trials, seed=seed + 1,
                                   forbid=g_test)
    return true_edges, false_edges


def score_auc(
    g_true: CSRGraph,
    g_train: CSRGraph,
    g_test: CSRGraph,
    num_trials: int,
    *,
    metric: str = "jaccard",
    seed: int = 0,
    device="cuda",
) -> float:
    """Sampled AUC (evaluation.h:137-174): P(score(true) > score(false)) +
    0.5 * P(equal), scores computed on the TRAIN graph."""
    sim._metric_id("score_auc", metric)
    true_edges, false_edges = _auc_pairs(g_true, g_test, num_trials, seed)
    t = _train_tables(g_train, device)
    st = _pair_scores_np(t, true_edges, metric)
    sf = _pair_scores_np(t, false_edges, metric)
    return float((np.sum(st > sf) + 0.5 * np.sum(st == sf)) / num_trials)


# ---------------------------------------------------------------------------
# K20: one trial's AUC counts and the next shift
# ---------------------------------------------------------------------------

def _check_auc(name, scores, shift, counts):
    _kernels.check_tensor(name, "scores", scores, 1, torch.float32)
    _kernels.check_tensor(name, "shift", shift, 1)
    _kernels.check_tensor(name, "counts", counts, 1)
    if scores.shape[0] % 2 or scores.shape[0] == 0:
        raise ValueError(f"{name}: scores must hold 2T > 0 entries, got "
                         f"{scores.shape[0]}")
    if shift.shape[0] != 1 or counts.shape[0] != 2:
        raise ValueError(f"{name}: shift must be [1] and counts [2], got "
                         f"{tuple(shift.shape)}, {tuple(counts.shape)}")


def auc_count_plain(scores, shift, counts):
    """Plain version of auc_count: torch.roll, as gms_tpu's jnp.roll."""
    T = scores.shape[0] // 2
    st, sf = scores[:T], torch.roll(scores[T:], int(shift[0]))
    higher, equal = int((st > sf).sum()), int((st == sf).sum())
    counts[0], counts[1] = higher, equal
    shift[0] = higher % T + 1


def auc_count(scores, shift, counts):
    """One AUC trial (gms_tpu link_prediction.py:237-256): from scores
    float32[2T] (true pairs, then false, in pair order) and the device shift
    int32[1] s, writes counts int32[2] = (Σ st[i] > sf[(i-s) mod T], Σ st[i]
    == sf[...]) and overwrites s with (higher mod T) + 1. NaN counts in
    neither."""
    name = "auc_count"
    _check_auc(name, scores, shift, counts)
    if not _kernels.on_cuda(name, scores, shift, counts):
        return auc_count_plain(scores, shift, counts)
    _kernels.launch("auc_count", "auc_count", scores, scores.shape[0] // 2,
                    shift, counts)
    LAUNCHES[name] += 1


class AUCPlan:
    """Prepared sampled AUC (evaluation.h:137-174 semantics): the sampling,
    the smaller-degree-first order, the hub split and the tables happen ONCE
    on the host; a trial then re-scores all 2T pairs (one K18 and one K19
    launch into one score array in pair order) and counts them with K20.

    Steady protocol (`run_steady`): trial t compares true score i with false
    score (i - shift_t) mod T — jnp.roll's direction; gms_tpu's docstring
    says (i + shift_t), its code rolls the other way — with shift_{t+1} =
    (higher_t mod T) + 1 chained on the device (every trial is a real
    execution, one read-back at the end). Each pairing is an equally valid
    AUC estimator; trials agree to ~sqrt(p(1-p)/T).
    """

    def __init__(self, g_true: CSRGraph, g_train: CSRGraph,
                 g_test: CSRGraph, num_trials: int, *,
                 metric: str = "jaccard", seed: int = 0, device="cuda"):
        dev = resolve(device)
        sim._metric_id("AUCPlan", metric)
        self.num_trials = num_trials
        self.metric = metric
        test_und = g_test.undirected_edge_array()
        if len(test_und) == 0:
            raise ValueError("empty test graph")
        rng = np.random.default_rng(seed)
        true_e = test_und[rng.integers(0, len(test_und), size=num_trials)]
        false_e = _sample_non_edges_fast(g_true, num_trials, seed=seed + 1,
                                         forbid=g_test)
        self.true_edges = true_e          # introspection / tests
        self.false_edges = false_e
        self._tables = _train_tables(g_train, dev)
        self._split = _PairSplit(np.concatenate([true_e, false_e]),
                                 self._tables)
        self._scores = torch.empty(2 * num_trials, dtype=torch.float32,
                                   device=dev)
        self.device = dev
        self.steady_counts = None         # (higher, equal) of run_steady's trials

    def counts(self, shift: int, trials: int) -> np.ndarray:
        """int32[trials, 2] (higher, equal) of `trials` chained trials from
        `shift`, one read-back at the end."""
        return self._counts_with(shift, trials, _score_into, auc_count)

    def _counts_with(self, shift: int, trials: int, score_into, count
                     ) -> np.ndarray:
        """counts() with the scorer and the counter given: the reference
        checks pass _score_into_plain and auc_count_plain."""
        s = torch.tensor([shift], dtype=torch.int32, device=self.device)
        out = torch.zeros((trials, 2), dtype=torch.int32, device=self.device)
        for t in range(trials):
            score_into(self._scores, self._tables, self._split, self.metric)
            count(self._scores, s, out[t])
        return out.cpu().numpy()

    def run(self, shift: int = 0) -> float:
        h, eq = (int(x) for x in self.counts(shift, 1)[0])
        return (h + 0.5 * eq) / self.num_trials

    def run_steady(self, trials: int = 8):
        """(auc_of_last_trial, seconds/trial): a first call from shift 0,
        then the timed call from shift 1 (host clock to its read-back);
        pairings rotate via the count-chained shift."""
        self.counts(0, trials)
        t0 = time.perf_counter()
        counts = self.counts(1, trials)
        dt = (time.perf_counter() - t0) / trials
        self.steady_counts = counts
        aucs = (counts[:, 0] + 0.5 * counts[:, 1]) / self.num_trials
        assert aucs.max() - aucs.min() < 0.05, aucs
        return float(aucs[-1]), dt


# ---------------------------------------------------------------------------
# K21 tile_topq and the top-q ranking
# ---------------------------------------------------------------------------

def topq_csr(g: CSRGraph, dev):
    """K21's two CSRs of g on `dev`: (indptr int64, indices int32) with each
    row sorted and no entry twice, and the transpose of that (row x: the v
    with x in N(v)) — the same tensors when g is undirected, whose CSR is
    symmetric. The common neighbours of (u, v) are then the wedges u - x - v
    with x in row u and v in row x of the transpose, gms_tpu's |N(u) ∩ N(v)|
    over out-neighbours also on a directed graph or one built with
    dedup=False."""
    n = g.num_nodes
    indptr = torch.from_numpy(np.ascontiguousarray(g.indptr, np.int64)).to(dev)
    rows = torch.repeat_interleave(torch.arange(n, device=dev),
                                   indptr[1:] - indptr[:-1])
    key = torch.unique(rows * n + torch.from_numpy(
        np.ascontiguousarray(g.indices, np.int64)).to(dev))

    def from_keys(k):
        ptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        ptr[1:] = torch.cumsum(torch.bincount(k // n, minlength=n), 0)
        return ptr, (k % n).to(torch.int32)

    csr = from_keys(key)
    if not g.directed():
        return csr, csr
    return csr, from_keys(torch.sort((key % n) * n + key // n).values)


def strip_table(indptr, indices, n: int):
    """int64[n, ceil(n / STRIP) + 1]: entry [x, c] is the first position of
    row x in `indices` whose neighbour is at least c * STRIP, the last column
    indptr[x + 1] — K21's strip ranges of the transpose's rows (rows sorted
    ascending), built with torch ops on the rows' device."""
    dev = indices.device
    cols = -(-n // STRIP)
    deg = indptr[1:n + 1] - indptr[:n]
    rows = torch.repeat_interleave(torch.arange(n, device=dev), deg)
    key = rows * cols + indices.long() // STRIP
    per = torch.bincount(key, minlength=n * cols).view(n, cols)
    table = torch.empty((n, cols + 1), dtype=torch.int64, device=dev)
    table[:, 0] = indptr[:n]
    table[:, 1:] = indptr[:n, None] + torch.cumsum(per, 1)
    return table


def _topq_units(nu: int, v_base: int, nv: int):
    """(units, u-tiles, first chunk) of a tile_topq launch: 32 u-rows ×
    STRIP-vertex chunks, the chunks those that [v_base, v_base + nv)
    touches."""
    n_ut = -(-nu // _TU)
    c0 = v_base // STRIP
    c1 = -(-(v_base + nv) // STRIP)
    return n_ut * max(0, c1 - c0), n_ut, c0


def _merge_candidates(s, u, v, q: int, block: int, n_pad: int):
    """The first q of candidates (scores, u, v) by the key (-score,
    ⌊v/block⌋, u, v); a candidate's (u, v) is unique."""
    if s.numel() == 0:
        return s, u, v
    sec = ((v.long() // block) * n_pad + u.long()) * n_pad + v.long()
    order = torch.argsort(sec)
    order = order[torch.argsort(-s[order], stable=True)][:q]
    return s[order], u[order], v[order]


def _check_topq(name, indptr, indices, tptr, tidx, deg_p, *, u_base, nu,
                v_base, nv, n, block, q, metric, wcol, strips):
    _kernels.check_tensor(name, "indptr", indptr, 1, torch.int64)
    _kernels.check_tensor(name, "indices", indices, 1)
    _kernels.check_tensor(name, "tptr", tptr, 1, torch.int64)
    _kernels.check_tensor(name, "tidx", tidx, 1)
    _kernels.check_tensor(name, "deg_p", deg_p, 1)
    if indptr.shape[0] != n + 1 or tptr.shape[0] != n + 1:
        raise ValueError(f"{name}: indptr and tptr have {indptr.shape[0]} "
                         f"and {tptr.shape[0]} entries for {n} rows")
    if (min(u_base, nu, v_base, nv) < 0 or max(u_base + nu, v_base + nv, n)
            > deg_p.shape[0]):
        raise ValueError(f"{name}: rows [{u_base}, {u_base + nu}) and "
                         f"[{v_base}, {v_base + nv}) of {n} for "
                         f"{deg_p.shape[0]} degrees")
    if block < 1 or v_base % block or q < 1:
        raise ValueError(f"{name}: block {block}, v_base {v_base}, q {q}")
    extra = [tptr, tidx]
    if strips is not None:
        _kernels.check_tensor(name, "strips", strips, 2, torch.int64)
        if tuple(strips.shape) != (n, -(-n // STRIP) + 1):
            raise ValueError(f"{name}: strips {tuple(strips.shape)} for {n} "
                             f"rows")
        extra.append(strips)
    if metric in sim.WEIGHTED:
        _kernels.check_tensor(name, "wcol", wcol, 1, torch.float32)
        if wcol.shape[0] < n:
            raise ValueError(f"{name}: wcol has {wcol.shape[0]} entries")
        extra.append(wcol)
    return extra


def _dense_rows(indptr, indices, start: int, stop: int, width: int):
    """float32 0/1 [stop - start, width]: CSR rows [start, stop), the rows
    past the CSR's end empty."""
    n = indptr.shape[0] - 1
    a, b = min(start, n), min(stop, n)
    dev = indices.device
    out = torch.zeros((stop - start, width), dtype=torch.float32, device=dev)
    deg = indptr[a + 1:b + 1] - indptr[a:b]
    rows = torch.repeat_interleave(torch.arange(b - a, device=dev), deg)
    out[rows, indices[int(indptr[a]):int(indptr[b])].long()] = 1.0
    return out


def ascending_sums(indptr, indices, tptr, tidx, wcol, u0: int, u1: int,
                   v0: int, v1: int):
    """float32[u1 - u0, v1 - v0]: Σ wcol[x] over the common neighbours x of
    (u, v), added in ascending x one float32 addition at a time from 0 — the
    order of K21's AA/RA sums. The wedges u - x - v (x in row u of the CSR,
    v in row x of its transpose tptr, tidx; see topq_csr) come in (u, x)
    order, a stable sort by (u, v) keeps x ascending within a pair, and
    round r adds every pair's r-th weight."""
    dev = indices.device
    n = indptr.shape[0] - 1
    nv = v1 - v0
    out = torch.zeros((u1 - u0) * nv, dtype=torch.float32, device=dev)
    a, b = min(u0, n), min(u1, n)
    lo = int(indptr[a])
    item_u = torch.repeat_interleave(torch.arange(a, b, device=dev),
                                     indptr[a + 1:b + 1] - indptr[a:b])
    item_x = indices[lo:int(indptr[b])].long()
    fan = tptr[item_x + 1] - tptr[item_x]
    ends = torch.cumsum(fan, 0)
    keys, xs = [], []
    i0 = 0
    while i0 < item_x.numel():  # items whose wedges fit the budget
        base = int(ends[i0 - 1]) if i0 else 0
        i1 = max(i0 + 1, int(torch.searchsorted(ends, base + _PLAIN_BUDGET,
                                                right=True)))
        f = fan[i0:i1]
        item = torch.repeat_interleave(torch.arange(i1 - i0, device=dev), f)
        first = torch.cumsum(f, 0) - f
        pos = (tptr[item_x[i0:i1]][item]
               + torch.arange(item.numel(), device=dev) - first[item])
        v = tidx[pos].long()
        keep = (v >= v0) & (v < v1)
        item = item[keep]
        keys.append((item_u[i0:i1][item] - u0) * nv + v[keep] - v0)
        xs.append(item_x[i0:i1][item])
        i0 = i1
    if not keys:
        return out.view(u1 - u0, nv)
    key, x = torch.cat(keys), torch.cat(xs)
    order = torch.argsort(key, stable=True)
    key, x = key[order], x[order]
    idx = torch.arange(key.numel(), device=dev)
    start = torch.ones_like(key, dtype=torch.bool)
    start[1:] = key[1:] != key[:-1]
    rank = idx - torch.cummax(torch.where(start, idx, 0), 0).values
    by_rank = torch.argsort(rank, stable=True)
    bounds = torch.cumsum(torch.bincount(rank), 0).tolist()
    r0 = 0
    for r1 in bounds:  # each round's pairs are distinct
        sel = by_rank[r0:r1]
        k = key[sel]
        out[k] = out[k] + wcol[x[sel]]
        r0 = r1
    return out.view(u1 - u0, nv)


def tile_topq_plain(indptr, indices, tptr, tidx, deg_p, *, u_base: int,
                    nu: int, v_base: int, nv: int, n: int, block: int,
                    q: int, metric: str, wcol=None, strips=None):
    """Plain version of tile_topq: gms_tpu's strip loop — dense rows from
    the CSR, float32 matmul counts (AA/RA: ascending_sums, the kernel's
    order), the masks, and a running top-q whose ties keep the earlier
    strip, then (u, v). `strips` only speeds the kernel: unused here."""
    dev = indices.device
    width = deg_p.shape[0]
    Ud = _dense_rows(indptr, indices, u_base, u_base + nu, width)
    u_ids = torch.arange(u_base, u_base + nu, device=dev)
    du = deg_p[u_base:u_base + nu]
    sums = (ascending_sums(indptr, indices, tptr, tidx, wcol, u_base,
                           u_base + nu, v_base, v_base + nv)
            if metric in sim.WEIGHTED else None)
    best = (torch.zeros(0, device=dev), torch.zeros(0, dtype=torch.int32,
            device=dev), torch.zeros(0, dtype=torch.int32, device=dev))
    for sb in range(0, nv, block):
        v0, vn = v_base + sb, min(block, nv - sb)
        v_ids = torch.arange(v0, v0 + vn, device=dev)
        if sums is not None:
            score = sums[:, sb:sb + vn]
        else:
            Vd = _dense_rows(indptr, indices, v0, v0 + vn, width)
            score = sim.dense_scores(metric, Ud, Vd, du, deg_p[v0:v0 + vn])
        edge = Ud[:, v0:v0 + vn] > 0
        valid = ((v_ids[None, :] > u_ids[:, None]) & (v_ids < n)[None, :]
                 & (u_ids < n)[:, None] & ~edge & ~torch.isnan(score))
        flat = torch.where(valid, score, -torch.inf).reshape(-1)
        live = flat > -torch.inf
        k = min(q, int(live.sum()))
        if k == 0:
            continue
        sel = torch.nonzero((flat >= torch.topk(flat, k).values[-1]) & live
                            ).reshape(-1)
        s = torch.cat([best[0], flat[sel]])
        u = torch.cat([best[1], u_ids[sel // vn].to(torch.int32)])
        v = torch.cat([best[2], v_ids[sel % vn].to(torch.int32)])
        order = torch.argsort(-s, stable=True)[:q]
        best = (s[order], u[order], v[order])
    return best


def tile_topq(indptr, indices, tptr, tidx, deg_p, *, u_base: int, nu: int,
              v_base: int, nv: int, n: int, block: int, q: int, metric: str,
              wcol=None, strips=None):
    """The best q non-edges (u, v), u in [u_base, u_base + nu), v in
    [v_base, v_base + nv) (v_base a strip start), v > u, both < n, by the
    key (-score, ⌊v/block⌋, u, v): (scores float32[q'], u int32[q'], v
    int32[q']) in that order, q' <= q (gms_tpu link_prediction.py:471's
    one u-block over those strips).

    indptr int64[n + 1], indices int32: the graph's CSR, each row sorted
    ascending with no entry twice; tptr, tidx: its transpose, the same
    (topq_csr builds both; a row with an entry twice would count a wedge
    twice); deg_p int32 with an entry for every row named; wcol float32 (at
    least n) the column weights for AA/RA; strips the strip_table of the
    transpose, or None (the kernel then finds each row's range by binary
    search)."""
    name = "tile_topq"
    mid = sim._metric_id(name, metric)
    kw = dict(u_base=u_base, nu=nu, v_base=v_base, nv=nv, n=n, block=block,
              q=q, metric=metric, wcol=wcol, strips=strips)
    extra = _check_topq(name, indptr, indices, tptr, tidx, deg_p, **kw)
    if not _kernels.on_cuda(name, indptr, indices, deg_p, *extra):
        return tile_topq_plain(indptr, indices, tptr, tidx, deg_p, **kw)
    dev = indices.device
    n_units, n_ut, c0 = _topq_units(nu, v_base, nv)
    ctas = max(1, min(n_units, _kernels.sm_count(dev.index)))
    out_s = torch.empty(ctas * q, dtype=torch.float32, device=dev)
    out_u = torch.empty(ctas * q, dtype=torch.int32, device=dev)
    out_v = torch.empty(ctas * q, dtype=torch.int32, device=dev)
    out_n = torch.zeros(ctas, dtype=torch.int32, device=dev)
    if n_units and n:
        work = torch.zeros(1, dtype=torch.int32, device=dev)
        scratch = torch.empty(ctas * 2 * q * 3, dtype=torch.int32,
                              device=dev)
        _kernels.launch(
            "tile_scores", "tile_topq", indptr, indices, tptr, tidx, strips,
            0 if strips is None else strips.shape[1], deg_p,
            wcol if metric in sim.WEIGHTED else None, n, u_base, nu, v_base,
            nv, block, mid, q, n_units, n_ut, c0, ctas, work, scratch, out_s,
            out_u, out_v, out_n)
        LAUNCHES[name] += 1
    # the CTAs' unused slots sort last; one read-back trims them
    live = (torch.arange(q, device=dev)[None, :] < out_n[:, None]).reshape(-1)
    s, u, v = _merge_candidates(
        torch.where(live, out_s, -torch.inf), torch.where(live, out_u, 0),
        torch.where(live, out_v, 0), q, block, deg_p.shape[0])
    m = min(q, int(out_n.sum()))
    return s[:m], u[:m], v[:m]


def _link_prediction(g, q_best, metric, block, device, topq):
    """link_prediction_similarity with the tile scorer `topq` given."""
    dev = resolve(device)
    sim._metric_id("link_prediction_similarity", metric)
    n = g.num_nodes
    if n == 0 or q_best < 1:
        return np.zeros((0, 2), np.int32), np.zeros(0, np.float32)
    block = min(block, round_up(n, 128))
    n_pad = round_up(n, block)
    deg_np = np.zeros(n_pad, np.int32)
    deg_np[:n] = g.degrees
    deg_p = torch.from_numpy(deg_np).to(dev)
    wcol = (sim.column_weights(deg_p, metric, n_pad)
            if metric in sim.WEIGHTED else None)
    (indptr, indices), (tptr, tidx) = topq_csr(g, dev)
    strips = (strip_table(tptr, tidx, n)
              if n * (-(-n // STRIP) + 1) * 8 <= STRIP_TABLE_BYTES else None)
    cands = [topq(indptr, indices, tptr, tidx, deg_p, u_base=start,
                  nu=block, v_base=start, nv=n_pad - start, n=n, block=block,
                  q=q_best, metric=metric, wcol=wcol, strips=strips)
             for start in range(0, n, block)]
    scores = np.concatenate([c[0].cpu().numpy() for c in cands])
    u = np.concatenate([c[1].cpu().numpy() for c in cands])
    v = np.concatenate([c[2].cpu().numpy() for c in cands])
    order = np.lexsort((v, u, -scores))[:q_best]
    return (np.stack([u[order], v[order]], axis=1).astype(np.int32),
            scores[order].astype(np.float32))


def link_prediction_similarity(
    g: CSRGraph, q_best: int, *, metric: str = "jaccard", block: int = 2048,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Top-q non-edges by similarity (link_prediction.h:42-101).

    Returns (edges int32[q', 2] with u < v, scores float32[q']) sorted by
    score descending, ties by (u, v) ascending, from the union of each
    u-block's best q by the key (-score, ⌊v/block⌋, u, v) — gms_tpu's
    strip-by-strip selection, which keeps the incumbent on a tie, so with
    ties at the q-th score the result is not the lexicographic top-q. q' <=
    q_best drops never-scored and NaN slots like the reference's resize
    (:84-92). Common neighbours are out-neighbours, each counted once, as in
    gms_tpu, also on a directed graph (topq_csr). K21 reads the CSR and its
    transpose; each row's range in a chunk of v comes from the strip table
    when it takes at most STRIP_TABLE_BYTES, else from a binary search.
    """
    return _link_prediction(g, q_best, metric, block, device, tile_topq)


def _link_prediction_similarity_plain(
    g: CSRGraph, q_best: int, *, metric: str = "jaccard", block: int = 2048,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """link_prediction_similarity through the plain versions alone
    (tile_topq_plain), on `device`: the reference the kernel is held to."""
    return _link_prediction(g, q_best, metric, block, device,
                            tile_topq_plain)
