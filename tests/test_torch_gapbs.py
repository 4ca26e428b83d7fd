"""The port's algorithms/gapbs.py: the mirror of tests/test_gapbs.py on the
plain versions (device="cpu"), the port against gms_tpu on the same graphs
(the random_graph fixtures, RMAT-8 and RMAT-10, the 300-vertex path) and
one step of each plain version against the matching gms_tpu body on the
same state.

Exact: BFS (both ways, every form), bfs_kbit, CC and SSSP (unit, weighted,
KbitWeightedGraph) — integers. PageRank is held at rtol 1e-5 and BC at rtol
1e-4: their float32 sums run in another order than XLA's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gms_tpu.algorithms import gapbs as jgapbs
from gms_tpu.graphs import compressed as jcp
from gms_tpu.graphs.tiles import PaddedGraph as JPaddedGraph, SENTINEL
from gms_tpu.io.builder import build_csr as jbuild_csr

from gms_tpu_torch.algorithms import gapbs
from gms_tpu_torch.graphs import compressed as cp
from gms_tpu_torch.graphs.tiles import PaddedGraph
from gms_tpu_torch.io.builder import build_csr
from gms_tpu_torch.io.generators import generate_rmat_el

from conftest import random_graph

torch.set_num_threads(1)

CPU = {"device": "cpu"}
SEED = 27491095
_INF = int(np.iinfo(np.int32).max)


def _edge_lists():
    lists = [(random_graph(60, 0.08, s), 60) for s in range(2)]
    # a disconnected graph: two blocks plus isolated vertices
    lists.append((np.concatenate([random_graph(20, 0.3, 7),
                                  random_graph(20, 0.3, 8) + 20]), 45))
    return lists


def _both(el, n):
    return build_csr(el, num_nodes=n), jbuild_csr(el, num_nodes=n)


@pytest.fixture(scope="module")
def graphs():
    return [build_csr(el, num_nodes=n) for el, n in _edge_lists()]


@pytest.fixture(scope="module")
def pairs():
    cases = _edge_lists()
    cases.append((generate_rmat_el(8, 16, seed=SEED), 256))
    cases.append((generate_rmat_el(10, 16, seed=SEED), 1024))
    path = np.stack([np.arange(299), np.arange(1, 300)], axis=1)
    cases.append((path.astype(np.int64), 300))
    return [_both(el, n) for el, n in cases]


def _sym_weights(g, seed):
    """Random symmetric weights in 1..9, per CSR slot."""
    rng = np.random.default_rng(seed)
    e = g.edge_array()
    key = {(min(a, b), max(a, b)): None for a, b in e}
    sym = {k: int(rng.integers(1, 10)) for k in key}
    return np.array([sym[(min(a, b), max(a, b))] for a, b in e], np.int32)


def _reps(g):
    return {"kbit": cp.KbitGraph.from_csr(g, **CPU),
            "hybrid": cp.HybridGraph.from_csr(g, **CPU),
            "bucketed": cp.KbitGraphBucketed.from_csr(g, **CPU),
            "padded": PaddedGraph.from_csr(g, **CPU)}


def _jreps(jg):
    return {"kbit": jcp.KbitGraph.from_csr(jg),
            "hybrid": jcp.HybridGraph.from_csr(jg),
            "bucketed": jcp.KbitGraphBucketed.from_csr(jg),
            "padded": JPaddedGraph.from_csr(jg)}


# ---------------------------------------------------------------------------
# the mirror of tests/test_gapbs.py (plain versions, device="cpu")
# ---------------------------------------------------------------------------

def test_bfs(graphs):
    for g in graphs:
        got = gapbs.bfs(g, 0, **CPU)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, gapbs.bfs_oracle(g, 0))


def test_cc(graphs):
    for g in graphs:
        np.testing.assert_array_equal(gapbs.connected_components(g, **CPU),
                                      gapbs.cc_oracle(g))


def test_sssp_unit_equals_bfs(graphs):
    for g in graphs:
        got = gapbs.sssp(g, 0, **CPU)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, gapbs.bfs_oracle(g, 0))


def test_sssp_weighted(graphs):
    for i, g in enumerate(graphs):
        w = _sym_weights(g, i)
        np.testing.assert_array_equal(gapbs.sssp(g, 0, w, **CPU),
                                      gapbs.sssp_oracle(g, 0, w))


def test_pagerank(graphs):
    for g in graphs:
        got = gapbs.pagerank(g, iters=15, **CPU)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, gapbs.pagerank_oracle(g, iters=15),
                                   rtol=1e-4, atol=1e-7)


def test_bc_star():
    el = np.array([[0, i] for i in range(1, 6)], dtype=np.int64)
    g = build_csr(el, num_nodes=6)
    bc = gapbs.betweenness_centrality(g, normalize=False, **CPU)
    assert bc[0] > 0
    assert np.allclose(bc[1:], 0)


def test_bc_path():
    g = build_csr(np.array([[0, 1], [1, 2]], dtype=np.int64), num_nodes=3)
    bc = gapbs.betweenness_centrality(g, normalize=False, **CPU)
    assert bc[1] == pytest.approx(2.0)
    assert bc[0] == bc[2] == 0


def test_bc_vs_bruteforce(graphs):
    g = graphs[0]
    n = g.num_nodes
    want = np.zeros(n)
    for s in range(n):
        dist = gapbs.bfs_oracle(g, s)
        order = np.argsort(dist)
        sigma = np.zeros(n)
        sigma[s] = 1
        for v in order:
            if dist[v] <= 0:
                continue
            for w in g.out_neigh(v):
                if dist[w] == dist[v] - 1:
                    sigma[v] += sigma[w]
        delta = np.zeros(n)
        for v in order[::-1]:
            if dist[v] < 0:
                continue
            for w in g.out_neigh(v):
                if dist[w] == dist[v] + 1 and sigma[w] > 0:
                    delta[v] += sigma[v] / sigma[w] * (1 + delta[w])
        delta[s] = 0
        want += delta
    got = gapbs.betweenness_centrality(g, normalize=False, **CPU)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_bfs_over_compressed_reps(graphs):
    for g in graphs:
        want = gapbs.bfs_oracle(g, 0)
        for name, rep in _reps(g).items():
            np.testing.assert_array_equal(gapbs.bfs(rep, 0, **CPU), want,
                                          err_msg=name)
        np.testing.assert_array_equal(
            gapbs.bfs(g, 0, direction_optimizing=False, **CPU), want)


def test_bfs_kbit_from_packed(graphs):
    for g in graphs:
        kg = cp.KbitGraph.from_csr(g, **CPU)
        np.testing.assert_array_equal(gapbs.bfs_kbit(kg, 0, **CPU),
                                      gapbs.bfs_oracle(g, 0))


def test_cc_pr_sssp_over_compressed(graphs):
    g = graphs[0]
    reps = _reps(g)
    np.testing.assert_array_equal(
        gapbs.connected_components(reps["kbit"], **CPU), gapbs.cc_oracle(g))
    np.testing.assert_allclose(
        gapbs.pagerank(reps["hybrid"], iters=10, **CPU),
        gapbs.pagerank_oracle(g, iters=10), rtol=1e-5)
    np.testing.assert_array_equal(gapbs.sssp(reps["kbit"], 0, **CPU),
                                  gapbs.bfs_oracle(g, 0))


def test_tc_over_compressed(graphs):
    from gms_tpu_torch.algorithms.triangle_count import (
        triangle_count, triangle_count_oracle)

    for g in graphs[:2]:
        want = triangle_count_oracle(g)
        for name, rep in _reps(g).items():
            if name != "padded":
                assert triangle_count(rep, **CPU) == want, name


def test_bfs_direction_optimizing_high_diameter():
    n = 300
    el = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    g = build_csr(el, num_nodes=n)
    np.testing.assert_array_equal(gapbs.bfs(g, 0, **CPU),
                                  gapbs.bfs_oracle(g, 0))
    # every level of the path has one vertex: all push
    assert gapbs.STEPS["bfs"] == ["push"] * n


# ---------------------------------------------------------------------------
# the port against gms_tpu, whole calls
# ---------------------------------------------------------------------------

def test_bfs_equals_gms_tpu(pairs):
    for g, jg in pairs:
        for source in (0, g.num_nodes - 1):
            for dopt in (True, False):
                want = jgapbs.bfs(jg, source, direction_optimizing=dopt)
                got = gapbs.bfs(g, source, direction_optimizing=dopt, **CPU)
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)


def test_bfs_forms_and_kbit_equal_gms_tpu(pairs):
    for g, jg in pairs[2:5]:
        want = jgapbs.bfs(jg, 0)
        for (name, rep), jrep in zip(_reps(g).items(), _jreps(jg).values()):
            np.testing.assert_array_equal(gapbs.bfs(rep, 0, **CPU),
                                          jgapbs.bfs(jrep, 0), err_msg=name)
            np.testing.assert_array_equal(gapbs.bfs(rep, 0, **CPU), want)
        for k in (None, 13, 17, 32):
            kg = cp.KbitGraph.from_csr(g, k=k, **CPU)
            jkg = jcp.KbitGraph.from_csr(jg, k=k)
            np.testing.assert_array_equal(gapbs.bfs_kbit(kg, 0, **CPU),
                                          jgapbs.bfs_kbit(jkg, 0))


def test_cc_and_sssp_equal_gms_tpu(pairs):
    for i, (g, jg) in enumerate(pairs):
        np.testing.assert_array_equal(gapbs.connected_components(g, **CPU),
                                      jgapbs.connected_components(jg))
        got = gapbs.sssp(g, 0, **CPU)
        want = jgapbs.sssp(jg, 0)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        w = _sym_weights(g, i)
        np.testing.assert_array_equal(gapbs.sssp(g, 0, w, **CPU),
                                      jgapbs.sssp(jg, 0, w))
        # the CSR's own per-slot weights when weights is None
        gw = build_csr(np.zeros((0, 2), np.int64), num_nodes=1)
        gw.__init__(g.indptr, g.indices, weights=w)
        np.testing.assert_array_equal(gapbs.sssp(gw, 0, **CPU),
                                      jgapbs.sssp(jg, 0, w))


def test_cc_and_sssp_over_forms_equal_gms_tpu(pairs):
    g, jg = pairs[3]
    for (name, rep), jrep in zip(_reps(g).items(), _jreps(jg).values()):
        np.testing.assert_array_equal(
            gapbs.connected_components(rep, **CPU),
            jgapbs.connected_components(jrep), err_msg=name)
        np.testing.assert_array_equal(gapbs.sssp(rep, 0, **CPU),
                                      jgapbs.sssp(jrep, 0), err_msg=name)
        with pytest.raises(ValueError, match="CSRGraph"):
            gapbs.sssp(rep, 0, np.ones(g.num_edges, np.int32), **CPU)
    w = _sym_weights(g, 5)
    kw = cp.KbitWeightedGraph.from_csr(g, w, **CPU)
    jkw = jcp.KbitWeightedGraph.from_csr(jg, w)
    np.testing.assert_array_equal(gapbs.sssp(kw, 0, **CPU),
                                  jgapbs.sssp(jkw, 0))
    with pytest.raises(ValueError, match="own weights"):
        gapbs.sssp(kw, 0, w, **CPU)
    with pytest.raises(TypeError):
        gapbs.bfs(kw, 0, **CPU)


def test_pagerank_equals_gms_tpu(pairs):
    for g, jg in pairs:
        for iters in (1, 20):
            np.testing.assert_allclose(gapbs.pagerank(g, iters=iters, **CPU),
                                       jgapbs.pagerank(jg, iters=iters),
                                       rtol=1e-5, atol=0)
    g, jg = pairs[3]
    want = gapbs.pagerank(g, iters=5, **CPU)
    for (name, rep), jrep in zip(_reps(g).items(), _jreps(jg).values()):
        got = gapbs.pagerank(rep, iters=5, **CPU)
        np.testing.assert_array_equal(got, want, err_msg=name)
        if name != "hybrid":
            np.testing.assert_allclose(got, jgapbs.pagerank(jrep, iters=5),
                                       rtol=1e-5, atol=0, err_msg=name)


def test_pagerank_of_hybrid_rows_follows_the_oracle(pairs):
    """gms_tpu's _prep gives a HybridGraph its k-bit part's degrees (0 on
    the bitmap rows), so its PageRank there departs from the oracle; the
    port uses the rows' own degrees and equals the oracle."""
    g, jg = pairs[4]
    h, jh = cp.HybridGraph.from_csr(g, **CPU), jcp.HybridGraph.from_csr(jg)
    assert len(h.bitmap_vids) > 0
    want = gapbs.pagerank_oracle(g, iters=5)
    np.testing.assert_allclose(gapbs.pagerank(h, iters=5, **CPU), want,
                               rtol=1e-5)
    assert not np.allclose(jgapbs.pagerank(jh, iters=5), want, rtol=1e-2)


def test_bc_equals_gms_tpu(pairs):
    for g, jg in (pairs[0], pairs[2], pairs[3]):
        np.testing.assert_allclose(
            gapbs.betweenness_centrality(g, **CPU),
            jgapbs.betweenness_centrality(jg), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(
            gapbs.betweenness_centrality(g, normalize=False, **CPU),
            jgapbs.betweenness_centrality(jg, normalize=False), rtol=1e-4)
    g, jg = pairs[4]
    for kw in ({"num_samples": 16, "seed": 3}, {"sources": [5, 0, 77]}):
        np.testing.assert_allclose(
            gapbs.betweenness_centrality(g, normalize=False, **kw, **CPU),
            jgapbs.betweenness_centrality(jg, normalize=False, **kw),
            rtol=1e-4)
    assert gapbs.bc_max_depth(g, **CPU) == min(
        g.num_nodes, max(4, 2 * jgapbs._diameter_bound(jg)))


def test_empty_and_bad_inputs():
    g = build_csr(np.zeros((0, 2), dtype=np.int64), num_nodes=0)
    assert gapbs.bfs(g, 0, **CPU).shape == (0,)
    assert gapbs.connected_components(g, **CPU).shape == (0,)
    assert gapbs.sssp(g, 0, **CPU).shape == (0,)
    assert gapbs.pagerank(g, **CPU).shape == (0,)
    assert gapbs.betweenness_centrality(g, **CPU).shape == (0,)
    g = build_csr(np.array([[0, 1]], dtype=np.int64), num_nodes=3)
    with pytest.raises(ValueError, match="source"):
        gapbs.bfs(g, 3, **CPU)
    with pytest.raises(TypeError):
        gapbs.bfs(object(), 0, **CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            gapbs.bfs(g, 0)


# ---------------------------------------------------------------------------
# one step of each plain version against the matching gms_tpu body
# ---------------------------------------------------------------------------

def _state(g, source=0, levels=2):
    """dist after `levels` BFS levels from source (INF beyond), as both."""
    d = gapbs.bfs_oracle(g, source)
    dist = np.where((d < 0) | (d > levels), _INF, d).astype(np.int32)
    return dist


def _csr(g):
    return (torch.from_numpy(g.indptr), torch.from_numpy(g.indices))


@pytest.fixture(scope="module")
def rmat10(pairs):
    return pairs[4]


def test_pull_and_push_steps_equal_gms_tpu(rmat10):
    g, jg = rmat10
    indptr, indices = _csr(g)
    pg = JPaddedGraph.from_csr(jg)
    nbr = np.asarray(pg.nbr)
    V, n = nbr.shape[0], g.num_nodes
    for it in (0, 1, 2):
        dist = _state(g, levels=it)
        frontier = np.zeros(V, bool)
        frontier[:n] = dist == it
        jd = np.full(V, _INF, np.int32)
        jd[:n] = dist
        # gms_tpu's pull body (_bfs_dense) and push scatter (_bfs_dopt)
        nf = frontier[np.clip(nbr, 0, V - 1)] & (nbr != SENTINEL)
        reach = nf.any(axis=1) & (jd == _INF)
        want = np.where(reach, it + 1, jd)[:n]
        got = torch.from_numpy(dist.copy())
        cnt = gapbs.bfs_pull_plain(indptr, indices, got, it)
        np.testing.assert_array_equal(got.numpy(), want)
        assert int(cnt) == int(reach.sum())
        ids, fc = gapbs.frontier_ids_plain(torch.from_numpy(dist), it)
        assert sorted(ids[:int(fc)].tolist()) == np.nonzero(
            dist == it)[0].tolist()
        got = torch.from_numpy(dist.copy())
        nxt, nc = gapbs.bfs_push_plain(indptr, indices, ids, int(fc), got, it)
        np.testing.assert_array_equal(got.numpy(), want)
        assert sorted(nxt[:int(nc)].tolist()) == np.nonzero(
            want == it + 1)[0].tolist()


def test_kbit_pull_step_equals_gms_tpu(rmat10):
    g, jg = rmat10
    n = g.num_nodes
    for k in (None, 13, 32):
        kg = cp.KbitGraph.from_csr(g, k=k, **CPU)
        dist = _state(g, levels=1)
        got = torch.from_numpy(dist.copy())
        gapbs.bfs_kbit_pull_plain(kg.packed, kg.deg, got, 1, k=kg.k,
                                  d_pad=kg.d_pad)
        want = torch.from_numpy(dist.copy())
        gapbs.bfs_pull_plain(*_csr(g), want, 1)
        assert torch.equal(got, want)
        assert (got.numpy() == 2).sum() > 0 and n == got.numel()


def test_min_steps_equal_gms_tpu(rmat10):
    g, jg = rmat10
    indptr, indices = _csr(g)
    pg = JPaddedGraph.from_csr(jg)
    nbr = np.asarray(pg.nbr)
    V, n = nbr.shape[0], g.num_nodes
    valid = nbr != SENTINEL
    rng = np.random.default_rng(1)
    labels = rng.permutation(V).astype(np.int32)
    nl = np.where(valid, labels[np.clip(nbr, 0, V - 1)], _INF)
    want = np.minimum(labels, nl.min(axis=1))[:n]
    got, changed = gapbs.cc_step_plain(indptr, indices,
                                       torch.from_numpy(labels[:n].copy()))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(changed) == 1
    w = _sym_weights(g, 2)
    big = gapbs.BIG
    d = np.where(rng.random(V) < 0.3, rng.integers(0, 50, V), big)
    wp = np.zeros(nbr.shape, np.int64)
    deg = g.degrees.astype(np.int64)
    wp[np.repeat(np.arange(n), deg),
       np.arange(g.num_edges) - np.repeat(g.indptr[:-1], deg)] = w
    cand = np.where(valid, d[np.clip(nbr, 0, V - 1)] + wp, big)
    want = np.minimum(d, cand.min(axis=1))[:n]
    for weights in (torch.from_numpy(w), None):
        got, _ = gapbs.sssp_step_plain(indptr, indices, weights,
                                       torch.from_numpy(d[:n].copy()))
        if weights is not None:
            np.testing.assert_array_equal(got.numpy(), want)
    unit = np.where(valid, d[np.clip(nbr, 0, V - 1)] + 1, big)
    np.testing.assert_array_equal(got.numpy(),
                                  np.minimum(d, unit.min(axis=1))[:n])


def test_pagerank_step_equals_gms_tpu(rmat10):
    g, jg = rmat10
    n = g.num_nodes
    indptr, indices = _csr(g)
    # one iteration of gms_tpu's _pagerank from its start state
    want = np.asarray(jgapbs._pagerank(*_jprep(jg), jnp.int32(n),
                                       iters=1))[:n]
    got = gapbs._pagerank(indptr, indices,
                          torch.from_numpy(g.degrees.astype(np.int32)), n, 1,
                          0.85, gapbs.pr_pull_plain)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    # the base, rounded once from float64, as gms_tpu rounds it
    base = np.float32(np.float32(1.0 - 0.85) / np.float32(n))
    assert float(got.min()) >= float(base)


def _jprep(jg):
    nbr, deg, _ = jgapbs._prep(jg)
    return nbr, deg


def test_bc_steps_equal_gms_tpu_one_source(rmat10):
    g, jg = rmat10
    n = g.num_nodes
    indptr, indices = _csr(g)
    nbr, _ = _jprep(jg)
    max_depth = gapbs.bc_max_depth(g, **CPU)
    for source in (0, 17):
        want = np.asarray(jgapbs._bc_one_source(
            nbr, jnp.int32(source), max_depth=max_depth))[:n]
        total = gapbs._bc_total(indptr, indices, n,
                                np.array([source], np.int32), max_depth,
                                gapbs.bc_forward_plain,
                                gapbs.bc_backward_plain)
        np.testing.assert_allclose(total.numpy(), want, rtol=1e-4,
                                   atol=1e-5)
        # the forward state after every step: gms_tpu's dist and sigma
        lvl, seen, sigma, _ = gapbs.bc_state(n, [source], max_depth, "cpu")
        d = gapbs.bfs_oracle(g, source)
        for it in range(max_depth):
            gapbs.bc_forward_plain(indptr, indices, lvl, seen, sigma, it)
            np.testing.assert_array_equal(
                gapbs.bc_dist(lvl, 1)[0].numpy(),
                np.where((d < 0) | (d > it + 1), _INF, d))
        assert float(sigma[source, 0]) == 1.0
        assert not sigma[:, 1:].any()


# ---------------------------------------------------------------------------
# K34's batch state: one bit a source, batches of up to BC_BATCH
# ---------------------------------------------------------------------------

def _bc_graph(kind):
    """(g, jg, sources) of a BC case: RMAT-10 with isolated vertices (a
    source among them has no neighbours); the disconnected graph whose
    path is cut at max_depth; a star whose hub row is longer than SEGMENT
    (three segments), its leaves joined in a ring and to an RMAT-7 block."""
    if kind == "rmat":
        n = 1024 + 6
        el = generate_rmat_el(10, 16, seed=SEED)
    elif kind == "disconnected":
        path = np.stack([np.arange(39), np.arange(1, 40)], axis=1)
        el, n = np.concatenate([random_graph(12, 0.5, 1), path + 12]), 52
    else:
        leaves = 1200
        ring = np.stack([np.arange(1, leaves + 1),
                         np.arange(2, leaves + 2) % leaves + 1], axis=1)
        block = generate_rmat_el(7, 8, seed=3) + leaves + 1
        join = np.stack([np.arange(1, leaves + 1, 7),
                         leaves + 1 + np.arange(0, leaves, 7) % 128], axis=1)
        el = np.concatenate([np.stack([np.zeros(leaves, np.int64),
                                       np.arange(1, leaves + 1)], axis=1),
                             ring, block, join])
        n = leaves + 1 + 128
    return _both(el.astype(np.int64), n)


def _bc_sources(g, B):
    """B sources (repeats where B > n), the first without neighbours where
    the graph has such a vertex."""
    rng = np.random.default_rng(B)
    src = rng.permutation(np.resize(np.arange(g.num_nodes), max(B, 1)))[:B]
    empty = np.nonzero(g.degrees == 0)[0]
    if len(empty):
        src[0] = empty[0]
    return src.astype(np.int32)


def _bc_checked(g, src, max_depth):
    """_bc_total on the plain steps, every forward step's dist (bc_dist)
    held to the BFS oracle cut at that step."""
    n = g.num_nodes
    indptr, indices = _csr(g)
    hops = {int(s): gapbs.bfs_oracle(g, int(s)) for s in set(src.tolist())}
    total = torch.zeros(n, dtype=torch.float32)
    for b0 in range(0, len(src), gapbs.BC_BATCH):
        sb = src[b0:b0 + gapbs.BC_BATCH]
        d = np.stack([hops[int(s)] for s in sb])
        lvl, seen, sigma, delta = gapbs.bc_state(n, sb, max_depth, "cpu")
        for it in range(max_depth):
            gapbs.bc_forward_plain(indptr, indices, lvl, seen, sigma, it)
            np.testing.assert_array_equal(
                gapbs.bc_dist(lvl, len(sb)).numpy(),
                np.where((d < 0) | (d > it + 1), _INF, d))
        for it in range(max_depth - 1, -1, -1):
            gapbs.bc_backward_plain(indptr, indices, lvl, sigma, delta, it,
                                    total)
    return total.numpy()


@pytest.mark.parametrize("B", [1, 63, 64, 65])
def test_bc_batches_equal_gms_tpu(B):
    """B sources (65: two batches, the second of one bit) on RMAT-10 with
    a source without neighbours: each step's dist against the oracle, the
    sum against gms_tpu's _bc_batched and the port's call."""
    g, jg = _bc_graph("rmat")
    src = _bc_sources(g, B)
    want = jgapbs.betweenness_centrality(jg, sources=src, normalize=False)
    got = _bc_checked(g, src, gapbs.bc_max_depth(g, **CPU))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got, gapbs.betweenness_centrality(
        g, sources=src, normalize=False, **CPU))


@pytest.mark.parametrize("kind", ["disconnected", "star"])
def test_bc_batches_cut_and_wide_rows_equal_gms_tpu(kind):
    """65 sources on the graph cut at max_depth (every vertex a source, some
    twice) and on the star with a hub row of three segments."""
    g, jg = _bc_graph(kind)
    src = _bc_sources(g, 65)
    md = gapbs.bc_max_depth(g, **CPU)
    if kind == "disconnected":
        assert md < 39
    else:
        from gms_tpu_torch.graphs.row_schedule import SEGMENT
        assert g.degrees.max() > 2 * SEGMENT
    got = _bc_checked(g, src, md)
    np.testing.assert_allclose(
        got, jgapbs.betweenness_centrality(jg, sources=src,
                                           normalize=False),
        rtol=1e-4, atol=1e-5)


def test_bc_state_rejects_bad_batches():
    with pytest.raises(ValueError, match="sources"):
        gapbs.bc_state(70, np.arange(65), 4, "cpu")
    with pytest.raises(ValueError, match="sources"):
        gapbs.bc_state(70, [], 4, "cpu")
    with pytest.raises(ValueError, match="outside"):
        gapbs.bc_state(70, [70], 4, "cpu")
    lvl, seen, sigma, delta = gapbs.bc_state(70, [3, 3, 69], 4, "cpu")
    assert int(lvl[0, 3]) == 3 and int(lvl[0, 69]) == 4
    assert int(seen[0]) == ~7 and int(seen[3]) == ~4
    indptr, indices = torch.zeros(71, dtype=torch.int64), torch.zeros(
        0, dtype=torch.int32)
    with pytest.raises(ValueError, match="step"):
        gapbs.bc_forward(indptr, indices, lvl, seen, sigma, 4)
    with pytest.raises(ValueError, match="sigma"):
        gapbs.bc_forward(indptr, indices, lvl, seen, sigma[:, :32], 0)
    total = torch.zeros(70)
    with pytest.raises(ValueError, match="delta"):
        gapbs.bc_backward(indptr, indices, lvl, sigma, delta[:69], 0, total)
    with pytest.raises(TypeError, match="lvl"):
        gapbs.bc_forward(indptr, indices, lvl.int(), seen, sigma, 0)


def _replay_bc_sums(g, terms):
    """K34's sums replayed on the CPU: for each (vertex, source), the terms
    of its row's entries (terms(v, j) -> float64[64], 0 where the entry
    adds nothing) added in row order within each span of the row schedule
    (a narrow row whole, else a segment of SEGMENT entries), a wide row's
    segment partials then added in segment order. float64[n, 64]."""
    from gms_tpu_torch.graphs import row_schedule as rs

    s = rs.build_row_schedule(torch.from_numpy(g.indptr))
    out = np.zeros((g.num_nodes, gapbs.BC_BATCH))
    spans = [(v, g.indptr[v], g.indptr[v + 1]) for v in s.narrow.tolist()]
    spans += [(v, lo, min(lo + rs.SEGMENT, g.indptr[v + 1]))
              for v, lo in zip(s.seg_row.tolist(), s.seg_start.tolist())]
    part = {}
    for v, lo, hi in spans:
        acc = np.zeros(gapbs.BC_BATCH)
        for j in range(lo, hi):
            acc = acc + terms(v, j)
        part.setdefault(v, []).append(acc)
    for v, parts in part.items():
        acc = np.zeros(gapbs.BC_BATCH)
        for p in parts:  # one span: 0 + p == p
            acc = acc + p
        out[v] = acc
    return out


def _replay_tree(d):
    """K34's row total: lane l's two deltas added, then a shuffle tree
    (xor 16, 8, 4, 2, 1) in float64; lane 0's value, float64[n]."""
    t = d[:, 0::2].astype(np.float64) + d[:, 1::2]
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        t = t + t[:, lanes ^ o]
    return t[:, 0]


def test_bc_sum_order_replay_gives_plain_bits():
    """On the star (its hub row three segments): every step of K34's
    forward and backward sums, replayed in the kernel's order, rounds to the
    plain version's float32 bits, and so does the row total's tree."""
    g, _ = _bc_graph("star")
    n = g.num_nodes
    indptr, indices = _csr(g)
    src = _bc_sources(g, 64)
    md = gapbs.bc_max_depth(g, **CPU)
    lvl, seen, sigma, delta = gapbs.bc_state(n, src, md, "cpu")
    col = g.indices.astype(np.int64)
    for it in range(md):
        need = ~gapbs._unpack64(seen).numpy()
        front = gapbs._unpack64(lvl[it]).numpy()
        sg = sigma.numpy().astype(np.float64)
        s = _replay_bc_sums(g, lambda v, j: np.where(
            need[v] & front[col[j]], sg[col[j]], 0.0))
        gapbs.bc_forward_plain(indptr, indices, lvl, seen, sigma, it)
        new = need & (s > 0)
        np.testing.assert_array_equal(sigma.numpy()[new],
                                      s[new].astype(np.float32))
    total = torch.zeros(n, dtype=torch.float32)
    want_total = np.zeros(n, dtype=np.float32)
    for it in range(md - 1, -1, -1):
        at = gapbs._unpack64(lvl[it]).numpy()
        succ = gapbs._unpack64(lvl[it + 1]).numpy()
        sg, dl = sigma.numpy(), delta.numpy().copy()

        def term(v, j):
            w = col[j]
            hit = succ[w] & at[v] & (sg[w] > 0)
            q = (sg[v] / np.maximum(sg[w], np.float32(1e-30))) * (
                np.float32(1) + dl[w])
            return np.where(hit, q.astype(np.float64), 0.0)

        acc = _replay_bc_sums(g, term).astype(np.float32)
        gapbs.bc_backward_plain(indptr, indices, lvl, sigma, delta, it, total)
        np.testing.assert_array_equal(delta.numpy()[at], acc[at])
        if it > 0:
            rows = _replay_tree(np.where(at, acc, np.float32(0)))
            want_total = want_total + rows.astype(np.float32)
    assert total.numpy().any()
    np.testing.assert_array_equal(total.numpy(), want_total)


def test_disconnected_depth_cut_like_gms_tpu():
    """_diameter_bound looks at vertex 0's component only: BC of a deeper
    component is cut at max_depth levels, in both packages alike."""
    short = random_graph(12, 0.5, 1)
    n_path = 40
    path = np.stack([np.arange(n_path - 1), np.arange(1, n_path)], axis=1)
    el = np.concatenate([short, path + 12]).astype(np.int64)
    g, jg = _both(el, 12 + n_path)
    md = gapbs.bc_max_depth(g, **CPU)
    assert md < n_path - 1
    np.testing.assert_allclose(
        gapbs.betweenness_centrality(g, normalize=False, **CPU),
        jgapbs.betweenness_centrality(jg, normalize=False), rtol=1e-4)
