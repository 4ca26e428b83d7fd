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
v-strips and keeps each CTA's best q by gms_tpu's key. For CPU tensors each
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
from gms_tpu_torch.algorithms import triangle_count as tc
from gms_tpu_torch.device import resolve
from gms_tpu_torch.graphs.csr import CSRGraph, _csr_from_sorted_pairs
from gms_tpu_torch.graphs.tiles import PaddedGraph, round_up

# Kernel launches, counted only where a CUDA kernel launches.
LAUNCHES = {"auc_count": 0, "tile_topq": 0}

HUB_THRESHOLD = 512          # rows with deg > this get id-space bitmaps
# link_prediction_similarity uses the whole-graph [n_pad, n_pad/32] bitmap
# when it takes at most this many bytes, else per-block rows built on the
# device from the padded rows (gms_tpu's threshold, link_prediction.py:598)
PACKED_BYTES = 1 << 31
# CTAs a tile_topq launch aims for: several on each of an H100's 132 SMs
_TOPQ_CTAS = 132 * 8
_TILE = 64                   # tile_topq's pairs per CTA side
_MAX_Q = _TILE * _TILE       # tile_topq's largest q


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

def _topq_grid(nu: int, nv: int, block: int):
    """(tiles a strip, v-tiles, v-tiles a CTA, u-tiles, CTAs along v) of a
    tile_topq launch over nu rows and nv vertices from a strip start."""
    tps = -(-block // _TILE)
    n_vtiles = -(-nv // block) * tps
    ut = -(-nu // _TILE)
    ctas_v = max(1, min(n_vtiles, -(-_TOPQ_CTAS // ut)))
    group = -(-n_vtiles // ctas_v)
    return tps, n_vtiles, group, ut, -(-n_vtiles // group)


def _merge_candidates(s, u, v, q: int, block: int, n_pad: int):
    """The first q of candidates (scores, u, v) by the key (-score,
    ⌊v/block⌋, u, v); a candidate's (u, v) is unique."""
    if s.numel() == 0:
        return s, u, v
    sec = ((v.long() // block) * n_pad + u.long()) * n_pad + v.long()
    order = torch.argsort(sec)
    order = order[torch.argsort(-s[order], stable=True)][:q]
    return s[order], u[order], v[order]


def _check_topq(name, u_words, v_words, deg_p, v_base, block, q, metric,
                wcol):
    _kernels.check_tensor(name, "u_words", u_words, 2)
    _kernels.check_tensor(name, "v_words", v_words, 2)
    _kernels.check_tensor(name, "deg_p", deg_p, 1)
    n_pad = deg_p.shape[0]
    if v_words.shape[1] != u_words.shape[1] or 32 * u_words.shape[1] < n_pad:
        raise ValueError(f"{name}: rows of {u_words.shape[1]} and "
                         f"{v_words.shape[1]} words for {n_pad} vertices")
    if block < 1 or v_base % block or q < 1:
        raise ValueError(f"{name}: block {block}, v_base {v_base}, q {q}")
    if metric in sim.WEIGHTED:
        _kernels.check_tensor(name, "wcol", wcol, 1, torch.float32)
        if wcol.shape[0] != 32 * u_words.shape[1]:
            raise ValueError(f"{name}: wcol has {wcol.shape[0]} entries")
        return [wcol]
    return []


def tile_topq_plain(u_words, v_words, deg_p, *, u_base: int, v_base: int,
                    n: int, block: int, q: int, metric: str, wcol=None):
    """Plain version of tile_topq: gms_tpu's strip loop — unpacked rows,
    float32 matmuls, the masks, and a running top-q whose ties keep the
    earlier strip, then (u, v)."""
    Ud = sim.unpack_rows(u_words)
    nu = u_words.shape[0]
    u_ids = torch.arange(u_base, u_base + nu, device=u_words.device)
    du = deg_p[u_base:u_base + nu]
    dev = u_words.device
    best = (torch.zeros(0, device=dev), torch.zeros(0, dtype=torch.int32,
            device=dev), torch.zeros(0, dtype=torch.int32, device=dev))
    for sb in range(0, v_words.shape[0], block):
        Vd = sim.unpack_rows(v_words[sb:sb + block])
        v0, nv = v_base + sb, Vd.shape[0]
        v_ids = torch.arange(v0, v0 + nv, device=dev)
        score = sim.dense_scores(metric, Ud, Vd, du, deg_p[v0:v0 + nv], wcol)
        edge = Ud[:, v0:v0 + nv] > 0
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
        u = torch.cat([best[1], u_ids[sel // nv].to(torch.int32)])
        v = torch.cat([best[2], v_ids[sel % nv].to(torch.int32)])
        order = torch.argsort(-s, stable=True)[:q]
        best = (s[order], u[order], v[order])
    return best


def tile_topq(u_words, v_words, deg_p, *, u_base: int, v_base: int, n: int,
              block: int, q: int, metric: str, wcol=None):
    """The best q non-edges (u, v), u in the block of rows u_words
    (int32[nu, W] bitmap rows of u_base ...), v in v_words (rows of v_base
    ..., a strip start), v > u, both < n, by the key (-score, ⌊v/block⌋, u,
    v): (scores float32[q'], u int32[q'], v int32[q']) in that order, q' <= q
    (gms_tpu link_prediction.py:471's one u-block over those strips).
    deg_p: int32[n_pad]; wcol: float32[32W] column weights for AA/RA. On
    CUDA, q <= 4096."""
    name = "tile_topq"
    mid = sim._metric_id(name, metric)
    extra = _check_topq(name, u_words, v_words, deg_p, v_base, block, q,
                        metric, wcol)
    if not _kernels.on_cuda(name, u_words, v_words, deg_p, *extra):
        return tile_topq_plain(u_words, v_words, deg_p, u_base=u_base,
                               v_base=v_base, n=n, block=block, q=q,
                               metric=metric, wcol=wcol)
    if q > _MAX_Q:
        raise ValueError(f"{name}: q {q} > {_MAX_Q}, the kernel's limit")
    nu, W = u_words.shape
    nv = v_words.shape[0]
    tps, n_vtiles, group, ut, ctas_v = _topq_grid(nu, nv, block)
    dev = u_words.device
    ctas = ut * ctas_v
    out_s = torch.empty(ctas * q, dtype=torch.float32, device=dev)
    out_u = torch.empty(ctas * q, dtype=torch.int32, device=dev)
    out_v = torch.empty(ctas * q, dtype=torch.int32, device=dev)
    out_n = torch.zeros(ctas, dtype=torch.int32, device=dev)
    if nu and nv:
        _kernels.launch("tile_scores", "tile_topq", u_words, nu, v_words, nv,
                        W, deg_p, n, u_base, v_base, block,
                        wcol if metric in sim.WEIGHTED else None, mid, q, tps,
                        n_vtiles, group, ctas_v, out_s, out_u, out_v, out_n)
        LAUNCHES[name] += 1
    keep = (torch.arange(q, device=dev)[None, :] < out_n[:, None]).reshape(-1)
    return _merge_candidates(out_s[keep], out_u[keep], out_v[keep], q, block,
                             deg_p.shape[0])


def _host_bitmap(g: CSRGraph, n_pad: int) -> np.ndarray:
    """uint32[n_pad, n_pad/32] id-space bitmap rows, as gms_tpu builds them."""
    n = g.num_nodes
    bm = np.zeros((n_pad, n_pad // 32), np.uint32)
    u = np.repeat(np.arange(n, dtype=np.int64), g.degrees.astype(np.int64))
    v = g.indices.astype(np.int64)
    np.bitwise_or.at(bm, (u, v >> 5), np.uint32(1) << (v & 31).astype(np.uint32))
    return bm


def _link_prediction(g, q_best, metric, block, device, topq, build_rows):
    """link_prediction_similarity with the tile scorer `topq` and the
    per-block row builder `build_rows` given."""
    dev = resolve(device)
    sim._metric_id("link_prediction_similarity", metric)
    n = g.num_nodes
    if n == 0 or q_best < 1:
        return np.zeros((0, 2), np.int32), np.zeros(0, np.float32)
    block = min(block, round_up(n, 128))
    n_pad = round_up(n, block)
    W = n_pad // 32
    deg_np = np.zeros(n_pad, np.int32)
    deg_np[:n] = g.degrees
    deg_p = torch.from_numpy(deg_np).to(dev)
    wcol = (sim.column_weights(deg_p, metric, 32 * W)
            if metric in sim.WEIGHTED else None)

    def best(u_rows, v_rows, u_base, v_base):
        return topq(u_rows, v_rows, deg_p, u_base=u_base, v_base=v_base, n=n,
                    block=block, q=q_best, metric=metric, wcol=wcol)

    cands = []
    if n_pad * W * 4 <= PACKED_BYTES:
        bm = torch.from_numpy(_host_bitmap(g, n_pad).view(np.int32)).to(dev)
        for start in range(0, n, block):
            # v-strips below the u-block can never satisfy v > u
            cands.append(best(bm[start:start + block], bm[start:], start,
                              start))
    else:
        # bitmap rows of each u-block and v-strip built on the device from
        # the padded rows (K3): the neighbour ids map to themselves, the
        # SENTINEL clip slot past the row's bits
        pg = PaddedGraph.from_csr(g, device=dev)
        hub_id = torch.arange(pg.v_pad + 1, dtype=torch.int32, device=dev)
        hub_id[pg.v_pad] = n_pad

        def rows(base):
            ids = torch.arange(base, base + block, dtype=torch.int32,
                               device=dev)
            return build_rows(pg.nbr, hub_id, ids, hub_words=W)

        for start in range(0, n, block):
            u_rows = rows(start)
            parts = [best(u_rows, rows(vb), start, vb)
                     for vb in range(start, n_pad, block)]
            cands.append(_merge_candidates(
                *(torch.cat(x) for x in zip(*parts)), q_best, block, n_pad))
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
    (:84-92). Rows come from the whole-graph bitmap when it takes at most
    PACKED_BYTES, else from per-block rows built on the device.
    """
    return _link_prediction(g, q_best, metric, block, device, tile_topq,
                            tc.build_hub_rows)


def _link_prediction_similarity_plain(
    g: CSRGraph, q_best: int, *, metric: str = "jaccard", block: int = 2048,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """link_prediction_similarity through the plain versions alone
    (tile_topq_plain, build_hub_rows_plain), on `device`: the reference the
    kernels are held to."""
    return _link_prediction(g, q_best, metric, block, device,
                            tile_topq_plain, tc.build_hub_rows_plain)
