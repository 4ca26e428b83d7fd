"""The port's algorithms/subgraph_iso.py: the mirror of
tests/test_subgraph_iso.py on the plain versions (device="cpu"), the plain
versions of K26 (feasible) and K27 (emit) against gms_tpu's _feasible and
_emit on the same numpy inputs, and the port's subgraph_isomorphism against
gms_tpu's row for row, order included. Exact throughout: every value is an
integer."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gms_tpu.algorithms import subgraph_iso as jsi
from gms_tpu.graphs.tiles import PaddedGraph as JPaddedGraph
from gms_tpu.io.builder import build_csr as jbuild_csr

from gms_tpu_torch.algorithms import subgraph_iso as si
from gms_tpu_torch.algorithms.k_clique import _bucket
from gms_tpu_torch.graphs.tiles import SENTINEL
from gms_tpu_torch.io.builder import build_csr
from gms_tpu_torch.io.generators import generate_rmat_el

from conftest import random_graph

torch.set_num_threads(1)

SEED = 27491095


def G(el, n=None):
    return build_csr(np.asarray(el, dtype=np.int64), num_nodes=n)


TRIANGLE = G([[0, 1], [1, 2], [0, 2]])
PATH3 = G([[0, 1], [1, 2]])
SQUARE = G([[0, 1], [1, 2], [2, 3], [3, 0]])


def find(g, pat, **kw):
    return si.subgraph_isomorphism(g, pat, device="cpu", **kw)


def count_all(g, pat, induced):
    return len(find(g, pat, induced=induced, limit=None))


# --- the mirror of tests/test_subgraph_iso.py -------------------------------

@pytest.mark.parametrize("induced", [False, True])
@pytest.mark.parametrize("pat", [TRIANGLE, PATH3, SQUARE])
def test_vs_oracle_random(pat, induced):
    g = build_csr(random_graph(20, 0.25, 1), num_nodes=20)
    got = find(g, pat, induced=induced, limit=None)
    want = si.subgraph_isomorphism_oracle(g, pat, induced=induced)
    assert {tuple(r) for r in got.tolist()} == set(want)


def test_find_first_valid():
    g = build_csr(random_graph(30, 0.3, 2), num_nodes=30)
    res = find(g, TRIANGLE, limit=1)
    assert res.shape == (1, 3)
    assert si.verify_mapping(g, TRIANGLE, res[0])


def test_no_match():
    g = G([[0, 1], [1, 2]], n=3)  # path has no triangle
    assert count_all(g, TRIANGLE, False) == 0


def test_induced_vs_noninduced():
    # K4 contains C4 as a (non-induced) subgraph but not as induced
    n = 4
    src, dst = np.nonzero(np.triu(np.ones((n, n), dtype=bool), 1))
    k4 = build_csr(np.stack([src, dst], axis=1).astype(np.int64))
    assert count_all(k4, SQUARE, False) > 0
    assert count_all(k4, SQUARE, True) == 0


def test_pattern_larger_than_target():
    g = G([[0, 1]], n=2)
    assert count_all(g, TRIANGLE, False) == 0


def test_automorphism_count():
    # triangle in triangle: 3! = 6 mappings
    assert count_all(TRIANGLE, TRIANGLE, False) == 6


def test_disconnected_pattern():
    pat = G([[0, 1], [2, 3]], n=4)  # two disjoint edges
    g = G([[0, 1], [2, 3], [1, 2]], n=4)
    got = find(g, pat, induced=False, limit=None)
    want = si.subgraph_isomorphism_oracle(g, pat, induced=False)
    assert {tuple(r) for r in got.tolist()} == set(want)


def test_limit_stops_early():
    g = build_csr(random_graph(40, 0.4, 3), num_nodes=40)
    res = find(g, TRIANGLE, limit=5, root_chunk=4)
    assert len(res) == 5
    for row in res:
        assert si.verify_mapping(g, TRIANGLE, row)


PATH5 = G([[0, 1], [1, 2], [2, 3], [3, 4]])
STAR5 = G([[0, 1], [0, 2], [0, 3], [0, 4]])
DIAMOND = G([[0, 1], [0, 2], [1, 2], [1, 3], [2, 3]])
CYCLE6 = G([[0, 1], [1, 2], [2, 3], [3, 4], [4, 5], [5, 0]])


@pytest.mark.parametrize("induced", [False, True])
@pytest.mark.parametrize("pat", [PATH5, STAR5, DIAMOND, CYCLE6])
def test_big_patterns_vs_oracle(pat, induced):
    g = build_csr(random_graph(60, 0.12, 5), num_nodes=60)
    got = find(g, pat, induced=induced, limit=None)
    want = si.subgraph_isomorphism_oracle(g, pat, induced=induced)
    assert {tuple(r) for r in got.tolist()} == set(want)


def test_item_budget_invariance_large_graph():
    # a tiny item_budget forces many LIFO slices; results must not change
    g = build_csr(random_graph(1000, 0.008, 9), num_nodes=1000)
    big = find(g, PATH5, limit=None, item_budget=1 << 18)
    small = find(g, PATH5, limit=None, item_budget=1 << 10)
    # the row sets (4.4 million rows), each row one int64 key in base 1000
    key = 1000 ** np.arange(5, dtype=np.int64)
    bs = np.unique(big.astype(np.int64) @ key)
    ss = np.unique(small.astype(np.int64) @ key)
    assert len(bs) == len(big) and np.array_equal(bs, ss) and len(bs) > 100
    for row in big[:20]:
        assert si.verify_mapping(g, PATH5, row)


def test_find_first_under_tiny_budget():
    g = build_csr(random_graph(300, 0.05, 4), num_nodes=300)
    res = find(g, DIAMOND, limit=1, item_budget=1 << 9)
    assert res.shape[0] == 1
    assert si.verify_mapping(g, DIAMOND, res[0])


def test_find_first_device_path_matches_hybrid():
    """host_budget=0 pins the device search; both paths find a valid
    mapping whenever one exists."""
    g = build_csr(random_graph(60, 0.15, seed=21), num_nodes=60)
    for pat, induced in ((TRIANGLE, False), (DIAMOND, True), (PATH5, True)):
        hyb = find(g, pat, induced=induced, limit=1)
        dev = find(g, pat, induced=induced, limit=1, host_budget=0)
        assert len(hyb) == len(dev)
        for r in (*hyb, *dev):
            assert si.verify_mapping(g, pat, r, induced=induced)


def test_host_budget_exhaustion_falls_through():
    """A 1-step budget exhausts at once and the device search still finds
    the mapping."""
    g = build_csr(random_graph(40, 0.3, seed=22), num_nodes=40)
    res = find(g, TRIANGLE, limit=1, host_budget=1)
    assert len(res) == 1
    assert si.verify_mapping(g, TRIANGLE, res[0])


# --- K26 and K27's plain versions against gms_tpu's programs -----------------

def _level_inputs(seed, *, connected):
    """One level's inputs on a 60-vertex random graph, as numpy: items M
    (P = 5, d = 3, some rows dead), their candidates, the padded rows, deg1
    and the id-space bitmap."""
    rng = np.random.default_rng(seed)
    g = jbuild_csr(random_graph(60, 0.2, seed), num_nodes=60)
    pg = JPaddedGraph.from_csr(g)
    nbr = np.asarray(pg.nbr)
    deg1 = np.concatenate([np.asarray(pg.deg), [0]]).astype(np.int32)
    N, P, d = 37, 5, 3
    M = np.full((N, P), -1, np.int32)
    M[:, :d] = rng.integers(0, 60, (N, d))
    M[rng.random(N) < 0.2, 0] = -1
    if connected:
        cand = nbr[np.clip(M[:, 0], 0, nbr.shape[0] - 1)]
    else:
        blk = max(256, nbr.shape[1])
        ids = np.full(blk, SENTINEL, np.int32)
        ids[:60] = np.arange(60)
        cand = np.broadcast_to(ids, (N, blk)).copy()
    vw = (60 + 31) // 32
    bmp = np.zeros((60, vw), np.uint32)
    uu = np.repeat(np.arange(60), g.degrees.astype(np.int64))
    vv = g.indices.astype(np.int64)
    np.bitwise_or.at(bmp, (uu, vv >> 5),
                     np.uint32(1) << (vv & 31).astype(np.uint32))
    return M, cand, nbr, deg1, bmp


def _t(a):
    a = np.array(a)  # an owned, writable copy
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


@pytest.mark.parametrize("connected,use_bmp,induced", [
    (True, True, False), (True, True, True), (True, False, False),
    (True, False, True), (False, True, True), (False, False, True)])
def test_feasible_plain_equals_gms_tpu(connected, use_bmp, induced):
    M, cand, nbr, deg1, bmp = _level_inputs(3, connected=connected)
    if not use_bmp:
        bmp = np.zeros((1, 1), np.uint32)
    parents, nonparents = ((0, 2), (1,)) if connected else ((), (0, 1, 2))
    want = np.asarray(jsi._feasible(
        jnp.asarray(M), jnp.asarray(cand), jnp.asarray(nbr),
        jnp.asarray(deg1), jnp.asarray(bmp), jnp.int32(3), d=3,
        parents=parents, nonparents=nonparents, induced=induced))
    ok, count = si.feasible(_t(M), _t(cand), _t(nbr), _t(deg1), _t(bmp), 3,
                            d=3, parents=parents, nonparents=nonparents,
                            induced=induced)
    assert ok.dtype == torch.bool and count.dtype == torch.int64
    np.testing.assert_array_equal(ok.numpy(), want)
    assert int(count) == int(want.sum()) > 0
    assert si.LAUNCHES == {"vf2_feasible": 0, "vf2_emit": 0}


@pytest.mark.parametrize("cap", ["bucket", 5, "beyond"])
def test_emit_plain_equals_gms_tpu(cap):
    M, cand, nbr, deg1, bmp = _level_inputs(4, connected=True)
    ok = np.random.default_rng(5).random(cand.shape) < 0.05
    ok &= cand != SENTINEL
    nc = int(ok.sum())
    cap = {"bucket": _bucket(nc), 5: 5, "beyond": ok.size + 17}[cap]
    want, want_n = jsi._emit(jnp.asarray(M), jnp.asarray(cand),
                             jnp.asarray(ok), d=3, cap=cap)
    got, n_out = si.emit(_t(M), _t(cand), torch.from_numpy(ok), d=3, cap=cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert n_out.tolist() == [int(want_n)] == [nc]


def test_wrappers_reject_bad_inputs():
    M, cand, nbr, deg1, bmp = (_t(a) for a in _level_inputs(6,
                                                            connected=True))
    with pytest.raises(ValueError, match="level"):
        si.feasible(M, cand, nbr, deg1, bmp, 1, d=5, parents=(0,),
                    nonparents=(), induced=False)
    with pytest.raises(ValueError, match="must lie"):
        si.feasible(M, cand, nbr, deg1, bmp, 1, d=2, parents=(2,),
                    nonparents=(), induced=False)
    with pytest.raises(TypeError):
        si.feasible(M.long(), cand, nbr, deg1, bmp, 1, d=2, parents=(0,),
                    nonparents=(), induced=False)
    with pytest.raises(ValueError, match="rows for"):
        si.feasible(M[:3], cand, nbr, deg1, bmp, 1, d=2, parents=(0,),
                    nonparents=(), induced=False)
    with pytest.raises(TypeError):
        si.emit(M, cand, cand, d=2, cap=8)
    with pytest.raises(ValueError, match="do not match"):
        si.emit(M, cand[:, :5].contiguous(),
                torch.zeros(cand.shape, dtype=torch.bool),
                d=2, cap=8)


# --- the port's search against gms_tpu's, row for row ------------------------

def _both(el, n):
    return build_csr(el, num_nodes=n), jbuild_csr(el, num_nodes=n)


@pytest.mark.parametrize("scale", [8, 10])
def test_find_first_equals_gms_tpu_rmat(scale):
    """bench.py's vf2 round at small scale: induced, limit=1, k4, p4 and c5,
    hybrid and device mode, gms_tpu's first mapping."""
    g, jg = _both(generate_rmat_el(scale, 16, seed=SEED), 1 << scale)
    for pedges in si.VF2_PATTERNS.values():
        pe = np.array(pedges, dtype=np.int64)
        for hb in (200_000, 0):
            got = find(g, build_csr(pe), induced=True, limit=1,
                       host_budget=hb)
            want = jsi.subgraph_isomorphism(jg, jbuild_csr(pe), induced=True,
                                            limit=1, host_budget=hb)
            np.testing.assert_array_equal(got, want)
            assert si.verify_mapping(g, build_csr(pe), got[0], induced=True)


@pytest.mark.parametrize("pname,induced", [("k4", True), ("p4", True),
                                           ("p4", False), ("c5", True)])
def test_enumeration_equals_gms_tpu(pname, induced):
    """limit=None, rows in gms_tpu's order: a random graph and RMAT-8 at
    average degree 4 (c5: RMAT-6), a small item_budget cutting slices."""
    pe = np.array(si.VF2_PATTERNS[pname], dtype=np.int64)
    scale = 6 if pname == "c5" else 8
    cases = [_both(random_graph(40, 0.2, 7), 40),
             _both(generate_rmat_el(scale, 4, seed=SEED), 1 << scale)]
    for g, jg in cases:
        got = find(g, build_csr(pe), induced=induced, limit=None,
                   item_budget=1 << 12)
        want = jsi.subgraph_isomorphism(jg, jbuild_csr(pe), induced=induced,
                                        limit=None, item_budget=1 << 12)
        assert len(got) > 0
        np.testing.assert_array_equal(got, want)


def test_disconnected_and_limit_equal_gms_tpu():
    el = random_graph(30, 0.15, 8)
    g, jg = _both(el, 30)
    pe = np.array([[0, 1], [2, 3]], dtype=np.int64)
    for limit in (None, 7):
        got = find(g, G(pe, 4), limit=limit, root_chunk=8)
        want = jsi.subgraph_isomorphism(jg, jbuild_csr(pe, num_nodes=4),
                                        limit=limit, root_chunk=8)
        np.testing.assert_array_equal(got, want)
