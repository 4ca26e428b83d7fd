"""The port's algorithms/link_prediction.py: the mirror of
tests/test_similarity.py's link-prediction tests on the plain versions, and
the port against gms_tpu on the same numpy inputs — the host sampling array
for array, AUC counts exactly (Jaccard and CN scores are bit-equal), the
top-q edges and scores exactly, a tie-decided case included, on both of the
top-q's row layouts."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gms_tpu.algorithms import link_prediction as jlp
from gms_tpu.io.builder import build_csr as jbuild_csr

from gms_tpu_torch import convert
from gms_tpu_torch.algorithms import link_prediction as lp
from gms_tpu_torch.algorithms import similarity as vs
from gms_tpu_torch.io.builder import build_csr
from gms_tpu_torch.io.generators import generate_rmat_el

from conftest import random_graph

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the mirror of tests/test_similarity.py (plain versions, device="cpu")
# ---------------------------------------------------------------------------

def test_train_test_split():
    g = build_csr(random_graph(50, 0.2, 4), num_nodes=50)
    m = g.num_edges_undirected
    train, test = lp.extract_random_test_edges(g, m // 5, seed=1)
    assert test.num_edges_undirected == m // 5
    assert train.num_edges_undirected == m - m // 5
    n = g.num_nodes
    kt = set(lp._edge_key(train.undirected_edge_array(), n).tolist())
    ks = set(lp._edge_key(test.undirected_edge_array(), n).tolist())
    kg = set(lp._edge_key(g.undirected_edge_array(), n).tolist())
    assert kt.isdisjoint(ks) and (kt | ks) == kg


def test_sample_non_edges_are_non_edges():
    g = build_csr(random_graph(30, 0.3, 5), num_nodes=30)
    ne = lp.sample_non_edges(g, 100, seed=2)
    keys = set(lp._edge_key(g.undirected_edge_array(), 30).tolist())
    assert all(k not in keys for k in lp._edge_key(np.sort(ne, 1), 30).tolist())
    assert (ne[:, 0] != ne[:, 1]).all()


def test_precision_recall():
    g = build_csr(np.array([[0, 1], [1, 2], [2, 3]], dtype=np.int64),
                  num_nodes=4)
    pred = np.array([[0, 1], [0, 3]])
    p, r = lp.score_precision_recall(pred, g)
    assert p == 0.5 and r == pytest.approx(1 / 3)


def test_auc_perfect_predictor():
    el = []
    for blk in (range(0, 8), range(8, 16)):
        blk = list(blk)
        el += [[a, b] for i, a in enumerate(blk) for b in blk[i + 1:]]
    g = build_csr(np.array(el, dtype=np.int64), num_nodes=16)
    train, test = lp.extract_random_test_edges(g, 6, seed=3)
    auc = lp.score_auc(g, train, test, 400, metric="common_neighbors", seed=4,
                       device="cpu")
    assert auc > 0.9


def test_add_false_links_count():
    g = build_csr(random_graph(40, 0.25, 6), num_nodes=40)
    train, test = lp.extract_random_test_edges(g, 10, seed=5)
    mutated = lp.add_false_links(train, 5, test, seed=6)
    assert mutated.num_edges_undirected == train.num_edges_undirected


def test_topq_matches_bruteforce():
    n = 25
    g = build_csr(random_graph(n, 0.3, 7), num_nodes=n)
    q = 10
    edges, scores = lp.link_prediction_similarity(
        g, q, metric="common_neighbors", device="cpu")
    cand = [(u, v) for u in range(n) for v in range(u + 1, n)
            if v not in set(g.out_neigh(u).tolist())]
    want = vs.vertex_similarity_oracle(g, np.array(cand), "common_neighbors")
    top = np.sort(want)[::-1][:q]
    np.testing.assert_allclose(np.sort(scores)[::-1], top.astype(np.float32))


def test_topq_blockwise_multiblock_all_metrics():
    n = 300
    g = build_csr(random_graph(n, 0.04, 11), num_nodes=n)
    q = 15
    nbrs = [set(g.out_neigh(u).tolist()) for u in range(n)]
    cand = np.array([(u, v) for u in range(n) for v in range(u + 1, n)
                     if v not in nbrs[u]])
    for metric in ("jaccard", "common_neighbors", "adamic_adar", "resource",
                   "preferential_attachment"):
        edges, scores = lp.link_prediction_similarity(
            g, q, metric=metric, block=128, device="cpu")
        want = vs.vertex_similarity_oracle(g, cand, metric)
        top = np.sort(want)[::-1][:q]
        np.testing.assert_allclose(np.sort(scores)[::-1],
                                   top.astype(np.float32), rtol=2e-5)
        assert (edges[:, 0] < edges[:, 1]).all()
        assert all(int(v) not in nbrs[int(u)] for u, v in edges)


def test_auc_plan_matches_oracle_pairing():
    g = build_csr(random_graph(120, 0.12, seed=9), num_nodes=120)
    train, test = lp.extract_random_test_edges(g, 60, seed=1)
    for metric in ("jaccard", "common_neighbors", "adamic_adar", "overlap"):
        plan = lp.AUCPlan(g, train, test, 300, metric=metric, seed=2,
                          device="cpu")
        auc = plan.run()
        st = vs.vertex_similarity_oracle(
            train, plan.true_edges, metric).astype(np.float32)
        sf = vs.vertex_similarity_oracle(
            train, plan.false_edges, metric).astype(np.float32)
        want = (np.sum(st > sf) + 0.5 * np.sum(st == sf)) / 300
        assert abs(auc - want) < 1e-6, metric
        auc2, _dt = plan.run_steady(3)
        assert abs(auc2 - want) < 0.1


# ---------------------------------------------------------------------------
# the port against gms_tpu on the same inputs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def split():
    """RMAT-10 from both packages and bench.py's kind of split."""
    el = generate_rmat_el(10, 16, seed=27491095)
    g, jg = build_csr(el, num_nodes=1024), jbuild_csr(el, num_nodes=1024)
    train, test = lp.extract_random_test_edges(g, 400, seed=1)
    jtrain, jtest = jlp.extract_random_test_edges(jg, 400, seed=1)
    return g, jg, train, test, jtrain, jtest


def test_host_sampling_equals_gms_tpu(split):
    g, jg, train, test, jtrain, jtest = split
    for a, b in ((train, jtrain), (test, jtest)):
        assert np.array_equal(a.indptr, b.indptr)
        assert np.array_equal(a.indices, b.indices)
    assert np.array_equal(lp.sample_non_edges(g, 500, seed=3, forbid=test),
                          jlp.sample_non_edges(jg, 500, seed=3, forbid=jtest))
    assert np.array_equal(
        lp._sample_non_edges_fast(g, 3000, seed=4, forbid=test),
        jlp._sample_non_edges_fast(jg, 3000, seed=4, forbid=jtest))
    a = lp.add_false_links(train, 50, test, seed=7)
    b = jlp.add_false_links(jtrain, 50, jtest, seed=7)
    assert np.array_equal(a.indptr, b.indptr)
    assert np.array_equal(a.indices, b.indices)
    p = np.array([[0, 1], [3, 2], [5, 9]])
    assert lp.score_precision_recall(p, g) == jlp.score_precision_recall(p, jg)


@pytest.mark.parametrize("metric", ["jaccard", "common_neighbors"])
def test_score_auc_equals_gms_tpu(split, metric):
    g, jg, train, test, jtrain, jtest = split
    assert lp.score_auc(g, train, test, 1000, metric=metric,
                        device="cpu") == jlp.score_auc(
        jg, jtrain, jtest, 1000, metric=metric)


def test_auc_plan_equals_gms_tpu(split):
    """true_edges, false_edges, run(0) and the 4 chained (higher, equal) of
    the steady program from shift 1, at RMAT-10 with 2,000 samples. The
    steady program's first trial from shift 0 is gms_tpu's run(0), so one
    compile of it serves both."""
    g, jg, train, test, jtrain, jtest = split
    jplan = jlp.AUCPlan(jg, jtrain, jtest, 2000, metric="jaccard", seed=2)
    plan = lp.AUCPlan(g, train, test, 2000, metric="jaccard", seed=2,
                      device="cpu")
    assert np.array_equal(plan.true_edges, jplan.true_edges)
    assert np.array_equal(plan.false_edges, jplan.false_edges)
    steady = jplan._make_steady(4)
    first = np.asarray(steady(*jplan._args, jnp.int32(0)))
    assert plan.run(0) == (first[0, 0] + 0.5 * first[0, 1]) / 2000
    assert np.array_equal(plan.counts(0, 4), first)
    want = np.asarray(steady(*jplan._args, jnp.int32(1)))
    assert np.array_equal(plan.counts(1, 4), want)
    auc, _ = plan.run_steady(4)
    assert np.array_equal(plan.steady_counts, want)
    assert auc == (want[-1, 0] + 0.5 * want[-1, 1]) / 2000


def test_auc_count_rolls_as_jnp_roll():
    rng = np.random.default_rng(0)
    T = 50
    scores = rng.integers(0, 4, 2 * T).astype(np.float32)
    scores[[3, 60]] = np.nan
    for s in (0, 1, 7, T):
        st, sf = scores[:T], np.asarray(jnp.roll(jnp.asarray(scores[T:]), s))
        shift = torch.tensor([s], dtype=torch.int32)
        counts = torch.zeros(2, dtype=torch.int32)
        lp.auc_count(torch.from_numpy(scores), shift, counts)
        h, e = int(np.sum(st > sf)), int(np.sum(st == sf))
        assert counts.tolist() == [h, e]
        assert int(shift[0]) == h % T + 1


def _hub_graph():
    """Random graph plus a vertex adjacent to 600 others: one hub (deg >
    512) on gms_tpu's tables."""
    n = 800
    el = random_graph(n, 0.01, 21)
    hub = np.stack([np.full(600, 5), np.arange(100, 700)], axis=1)
    return np.concatenate([el, hub]).astype(np.int64), n


def test_scorer_from_converted_tables_equals_gms_tpu():
    el, n = _hub_graph()
    g, jg = build_csr(el, num_nodes=n), jbuild_csr(el, num_nodes=n)
    train, test = lp.extract_random_test_edges(g, 200, seed=1)
    jtrain, _ = jlp.extract_random_test_edges(jg, 200, seed=1)
    jpg, jdeg1, (bm, hub_idx, vw, hub_t) = jlp._train_tables(jtrain)
    tables = convert.train_tables_from_numpy(
        np.asarray(jpg.nbr), np.asarray(jpg.deg), np.asarray(bm),
        np.asarray(hub_idx), vw, hub_t, device="cpu")
    # the port's own tables equal the converted ones
    own = lp._train_tables(train, "cpu")
    assert torch.equal(own.pg.nbr, tables.pg.nbr)
    assert torch.equal(own.deg1, tables.deg1)
    assert torch.equal(own.bm_flat, tables.bm_flat)
    assert torch.equal(own.hub_idx, tables.hub_idx)
    assert own.vw == tables.vw == vw and hub_t == lp.HUB_THRESHOLD
    with pytest.raises(ValueError, match="hub_t"):
        convert.train_tables_from_numpy(
            np.asarray(jpg.nbr), np.asarray(jpg.deg), np.asarray(bm),
            np.asarray(hub_idx), vw, hub_t + 1, device="cpu")
    rng = np.random.default_rng(3)
    edges = np.concatenate([
        rng.integers(0, n, (300, 2)),
        np.stack([np.full(100, 5), rng.integers(0, n, 100)], axis=1),
        np.stack([rng.integers(0, n, 100), np.full(100, 5)], axis=1)]
    ).astype(np.int32)
    for metric in ("jaccard", "adamic_adar"):
        want = jlp._train_scorer(jtrain, metric)(edges)
        got = lp._pair_scores_np(tables, edges, metric)
        if metric == "jaccard":
            assert np.array_equal(got.view(np.int32), want.view(np.int32))
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("metric", list(vs.METRICS))
def test_link_prediction_similarity_equals_gms_tpu(split, metric):
    g, jg, train, test, jtrain, jtest = split
    want_e, want_s = jlp.link_prediction_similarity(jtrain, 40, metric=metric,
                                                    block=256)
    got_e, got_s = lp.link_prediction_similarity(train, 40, metric=metric,
                                                 block=256, device="cpu")
    assert np.array_equal(got_e, want_e)
    if metric in vs.WEIGHTED:
        np.testing.assert_allclose(got_s, want_s, rtol=1e-5)
    else:
        assert np.array_equal(got_s.view(np.int32), want_s.view(np.int32))


@pytest.fixture(scope="module")
def rmat11_topq():
    """gms_tpu's top-30 under Jaccard at RMAT-11, block 128: ties at the 30th
    score are decided by the strip order."""
    el = generate_rmat_el(11, 16, seed=27491095)
    g, jg = build_csr(el, num_nodes=2048), jbuild_csr(el, num_nodes=2048)
    return g, jlp.link_prediction_similarity(jg, 30, metric="jaccard",
                                             block=128)


@pytest.mark.parametrize("table", [True, False])
def test_topq_tie_rule_equals_gms_tpu(rmat11_topq, table, monkeypatch):
    g, (want_e, want_s) = rmat11_topq
    if not table:  # each row's range by binary search
        monkeypatch.setattr(lp, "STRIP_TABLE_BYTES", 0)
    got_e, got_s = lp.link_prediction_similarity(g, 30, metric="jaccard",
                                                 block=128, device="cpu")
    assert np.array_equal(got_e, want_e) and np.array_equal(got_s, want_s)
    # the lexicographic top-30 differs: the keyed rule decided the ties
    iso = np.nonzero(g.degrees == 0)[0]
    lex = [(int(u), int(v)) for u in iso for v in iso if u < v][:30]
    assert (want_s == 1.0).all() and [tuple(e) for e in want_e] != lex


def test_tile_topq_grid_and_merge():
    """K21's units cover every (32 u-rows, 1,024-vertex chunk) of a launch,
    and the u-block merge sorts by (-score, strip, u, v) and keeps q."""
    for nu, v_base, nv, want in ((2048, 0, 65536, (64 * 64, 64, 0)),
                                 (128, 128, 256, (4, 4, 0)),
                                 (100, 1000, 300, (8, 4, 0)),
                                 (96, 2048, 96, (3, 3, 2))):
        assert lp._topq_units(nu, v_base, nv) == want
    s = torch.tensor([1.0, 2.0, 1.0, 1.0, 2.0])
    u = torch.tensor([3, 5, 1, 2, 0], dtype=torch.int32)
    v = torch.tensor([300, 9, 10, 11, 200], dtype=torch.int32)
    ms, mu, mv = lp._merge_candidates(s, u, v, 4, 100, 512)
    assert ms.tolist() == [2.0, 2.0, 1.0, 1.0]
    assert list(zip(mu.tolist(), mv.tolist())) == [(5, 9), (0, 200), (1, 10),
                                                   (2, 11)]


# ---------------------------------------------------------------------------
# K21's layout and arithmetic, and q above what a CTA's shared memory holds
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rmat9_big_q():
    """RMAT-9, gms_tpu's top-5,000 under Jaccard and AA (block 128)."""
    el = generate_rmat_el(9, 16, seed=3)
    g, jg = build_csr(el, num_nodes=512), jbuild_csr(el, num_nodes=512)
    return g, {m: jlp.link_prediction_similarity(jg, 5000, metric=m,
                                                 block=128)
               for m in ("jaccard", "adamic_adar")}


@pytest.mark.parametrize("table", [True, False])
@pytest.mark.parametrize("metric", ["jaccard", "adamic_adar"])
def test_topq_q_above_4096_equals_gms_tpu(rmat9_big_q, metric, table,
                                          monkeypatch):
    g, want = rmat9_big_q
    want_e, want_s = want[metric]
    assert len(want_e) == 5000
    if not table:
        monkeypatch.setattr(lp, "STRIP_TABLE_BYTES", 0)
    got_e, got_s = lp.link_prediction_similarity(g, 5000, metric=metric,
                                                 block=128, device="cpu")
    assert np.array_equal(got_e, want_e)
    if metric in vs.WEIGHTED:
        np.testing.assert_allclose(got_s, want_s, rtol=1e-5)
    else:
        assert np.array_equal(got_s.view(np.int32), want_s.view(np.int32))


@pytest.fixture(scope="module")
def rmat9_directed():
    """RMAT-9 built directed (symmetrize=False) and with repeated entries
    (dedup=False), gms_tpu's top-5,000 of each under Jaccard and AA."""
    el = generate_rmat_el(9, 16, seed=3)
    out = {}
    for kind, kw in (("directed", {"symmetrize": False}),
                     ("repeated", {"dedup": False})):
        g = build_csr(el, num_nodes=512, **kw)
        jg = jbuild_csr(el, num_nodes=512, **kw)
        out[kind] = g, {m: jlp.link_prediction_similarity(
            jg, 5000, metric=m, block=128) for m in ("jaccard", "adamic_adar")}
    return out


@pytest.mark.parametrize("kind", ["directed", "repeated"])
@pytest.mark.parametrize("metric", ["jaccard", "adamic_adar"])
def test_topq_directed_and_repeated_rows_equal_gms_tpu(rmat9_directed, kind,
                                                       metric):
    """Common neighbours are out-neighbours counted once, as gms_tpu's row
    product: on a directed graph the wedges u - x - v walk the transpose for
    v, and a repeated entry counts once (topq_csr)."""
    g, want = rmat9_directed[kind]
    assert g.directed() == (kind == "directed")
    want_e, want_s = want[metric]
    got_e, got_s = lp.link_prediction_similarity(g, 5000, metric=metric,
                                                 block=128, device="cpu")
    n = g.num_nodes
    if metric == "jaccard":
        assert np.array_equal(got_e, want_e)
        assert np.array_equal(got_s.view(np.int32), want_s.view(np.int32))
        # the wedges K21 walks count |N(u) ∩ N(v)|, each x once
        (ip, ix), (tp, tx) = lp.topq_csr(g, "cpu")
        c = lp.ascending_sums(ip, ix, tp, tx, torch.ones(n), 0, n, 0,
                              n).numpy()
        A = np.zeros((n, n), np.float32)
        A[np.repeat(np.arange(n), g.degrees), g.indices] = 1.0
        assert np.array_equal(c, A @ A.T)
        return
    # AA: gms_tpu's float32 product and the ascending sums may differ in a
    # score's last bit, which reorders pairs of all but equal score: the
    # same pairs, each pair's score within rtol 1e-5
    got_k = got_e[:, 0].astype(np.int64) * n + got_e[:, 1]
    want_k = want_e[:, 0].astype(np.int64) * n + want_e[:, 1]
    assert np.array_equal(np.sort(got_k), np.sort(want_k))
    np.testing.assert_allclose(got_s[np.argsort(got_k)],
                               want_s[np.argsort(want_k)], rtol=1e-5)
    assert (got_s[:-1] >= got_s[1:]).all()  # +inf first (a deg-1 x)


def test_strip_table_equals_numpy_from_bitmap():
    """strip_table built by its torch ops on the CPU: entry [x, c] is
    indptr[x] plus the set bits of row x's id-space bitmap below c·1024."""
    n = 3000
    g = build_csr(generate_rmat_el(12, 8, seed=5)[:20000] % n, num_nodes=n)
    indptr = torch.from_numpy(g.indptr.astype(np.int64))
    table = lp.strip_table(indptr, torch.from_numpy(g.indices), n).numpy()
    cols = -(-n // lp.STRIP)
    assert table.shape == (n, cols + 1)
    words = lp.STRIP // 32
    bm = np.zeros((n, cols * words), np.uint32)
    u = np.repeat(np.arange(n), g.degrees)
    v = g.indices.astype(np.int64)
    np.bitwise_or.at(bm, (u, v >> 5), np.uint32(1) << (v & 31).astype(
        np.uint32))
    bits = np.unpackbits(bm.view(np.uint8), axis=1, bitorder="little")
    per = bits.reshape(n, cols, lp.STRIP).sum(axis=2)
    want = g.indptr[:n, None] + np.concatenate(
        [np.zeros((n, 1), np.int64), np.cumsum(per, axis=1)], axis=1)
    assert np.array_equal(table, want)
    assert np.array_equal(table[:, -1], g.indptr[1:])


@pytest.mark.parametrize("metric", ["adamic_adar", "resource"])
def test_ascending_sums_replay_float32(metric):
    """K21's AA/RA order: a numpy float32 replay adding each pair's common
    neighbours' weights in ascending id, one rounding an addition, gives
    ascending_sums' bits (deg-1 neighbours' +inf included)."""
    g = build_csr(generate_rmat_el(9, 16, seed=7), num_nodes=512)
    n = g.num_nodes
    deg = torch.from_numpy(g.degrees.astype(np.int32))
    w = vs.column_weights(deg, metric, n)
    indptr = torch.from_numpy(g.indptr.astype(np.int64))
    indices = torch.from_numpy(g.indices)
    got = lp.ascending_sums(indptr, indices, indptr, indices, w, 64, 192,
                            100, 400).numpy()
    wn = w.numpy()
    nbrs = [g.out_neigh(x) for x in range(n)]
    want = np.zeros((128, 300), np.float32)
    for i, u in enumerate(range(64, 192)):
        for j, v in enumerate(range(100, 400)):
            s = np.float32(0.0)
            for x in np.intersect1d(nbrs[u], nbrs[v]):
                s = np.float32(s + wn[x])
            want[i, j] = s
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert np.isinf(want).any() == (metric == "adamic_adar")
