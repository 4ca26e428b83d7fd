"""Vertex orderings of the PyTorch port against gms_tpu's.

Every comparison is exact: ranks, core numbers and degeneracies are
integers, and the ADG boundaries draw from the same numpy generator.
gms_tpu peels with its native C++ runtime when it is built; its ranks may
differ from the numpy loop's on ties, so the rank is compared against
gms_tpu's numpy peel, and the core numbers against both.

The device ADG runs here on its plain round (device="cpu"): "avg" and "min"
equal gms_tpu's device and host versions rank for rank; the sampled
boundaries draw jax.random's numbers from gms_tpu's keys
(gms_tpu_torch/prng.py), so they equal gms_tpu's device ranks too, and are
held to the verifier as well. The ordered collections mirror
tests/test_preprocessing.py.
"""

import numpy as np
import pytest

import torch

from gms_tpu import native
from gms_tpu.io.builder import build_csr as jbuild_csr
from gms_tpu.preprocessing import degeneracy as jdg
from gms_tpu.preprocessing import ordered_collection as joc

from gms_tpu_torch.io.builder import build_csr
from gms_tpu_torch.io.generators import generate_rmat_el
from gms_tpu_torch.preprocessing import degeneracy as dg
from gms_tpu_torch.preprocessing import ordered_collection as oc

from conftest import random_graph

torch.set_num_threads(1)


def _edge_lists():
    lists = {f"random{s}": (random_graph(80, 0.1, s), 80) for s in range(3)}
    lists["dense"] = (random_graph(40, 0.5, 7), 40)
    lists["rmat8"] = (generate_rmat_el(8, 16, seed=27491095), 256)
    lists["rmat9"] = (generate_rmat_el(9, 8, seed=5), 512)
    lists["empty"] = (np.zeros((0, 2), dtype=np.int64), 6)
    return lists


EDGE_LISTS = _edge_lists()


@pytest.fixture(params=sorted(EDGE_LISTS))
def pair(request):
    el, n = EDGE_LISTS[request.param]
    return build_csr(el, num_nodes=n), jbuild_csr(el, num_nodes=n)


def test_peel_equals_numpy_peel(pair, monkeypatch):
    g, jg = pair
    monkeypatch.setattr(native, "degeneracy_peel", lambda *a: None)
    rank, core, k = dg._degeneracy_peel(g)
    jrank, jcore, jk = jdg._degeneracy_peel(jg)
    assert k == jk
    np.testing.assert_array_equal(rank, jrank)
    np.testing.assert_array_equal(core, jcore)
    assert rank.dtype == np.int32 and core.dtype == np.int32


def test_core_numbers_equal_native_peel(pair):
    g, jg = pair
    np.testing.assert_array_equal(dg.core_numbers(g), jdg.core_numbers(jg))
    rank, k = dg.degeneracy_ordering_rank(g)
    assert k == jdg.degeneracy_ordering_rank(jg)[1]
    assert dg.verify_degeneracy_order(g, rank)
    assert jdg.verify_degeneracy_order(jg, rank)


@pytest.mark.parametrize("boundary", sorted(dg.BOUNDARY_FUNCTIONS))
@pytest.mark.parametrize("eps", [0.1, 0.01])
def test_adg_rank_equals_gms_tpu(pair, boundary, eps):
    g, jg = pair
    rank = dg.adg_ordering_rank(g, eps, boundary=boundary, seed=11)
    want = jdg.adg_ordering_rank(jg, eps, boundary=boundary, seed=11)
    np.testing.assert_array_equal(rank, want)
    assert dg.verify_approx_degeneracy_order(g, rank, eps)


def test_rank_helpers_and_verifiers(pair):
    g, jg = pair
    rng = np.random.default_rng(3)
    deg_rank = dg.degree_ordering_rank(g)
    np.testing.assert_array_equal(deg_rank, jdg.degree_ordering_rank(jg))
    assert dg.verify_degree_monotone(g, deg_rank)
    perm = rng.permutation(g.num_nodes).astype(np.int32)
    np.testing.assert_array_equal(dg.order_to_rank(perm),
                                  jdg.order_to_rank(perm))
    np.testing.assert_array_equal(dg.rank_to_order(dg.order_to_rank(perm)),
                                  perm)
    for rank in (deg_rank, perm, dg.degeneracy_ordering_rank(g)[0]):
        assert dg.evaluate_ordering(g, rank) == jdg.evaluate_ordering(jg, rank)
        assert (dg.verify_degeneracy_order(g, rank)
                == jdg.verify_degeneracy_order(jg, rank))
        assert (dg.verify_degree_monotone(g, rank)
                == jdg.verify_degree_monotone(jg, rank))
        for eps in (0.1, 0.5):
            assert (dg.verify_approx_degeneracy_order(g, rank, eps)
                    == jdg.verify_approx_degeneracy_order(jg, rank, eps))
    assert not dg.verify_approx_degeneracy_order(g, np.zeros_like(perm), 0.1) \
        or g.num_nodes <= 1


# ---------------------------------------------------------------------------
# device ADG, triangle-count ordering
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("boundary", ["avg", "min"])
def test_adg_device_equals_gms_tpu_device_and_host(pair, boundary):
    g, jg = pair
    for eps in (0.01, 0.1, 0.5):
        rank = dg.adg_ordering_rank_device(g, eps, boundary, device="cpu")
        assert rank.dtype == np.int32
        np.testing.assert_array_equal(
            rank, dg.adg_ordering_rank(g, eps, boundary=boundary))
        np.testing.assert_array_equal(
            rank, jdg.adg_ordering_rank(jg, eps, boundary=boundary))
        np.testing.assert_array_equal(
            rank, jdg.adg_ordering_rank_device(jg, eps, boundary=boundary))


@pytest.mark.parametrize("seed", range(3))
def test_adg_device_matches_host_random(seed):
    """As tests/test_preprocessing.py's device-against-host case."""
    el = random_graph(70, 0.15, seed)
    g, jg = build_csr(el, num_nodes=70), jbuild_csr(el, num_nodes=70)
    for boundary in ("avg", "min"):
        for eps in (0.1, 0.5):
            rank = dg.adg_ordering_rank_device(g, eps, boundary, device="cpu")
            np.testing.assert_array_equal(
                rank, jdg.adg_ordering_rank(jg, eps, boundary=boundary))


@pytest.mark.parametrize("boundary", ["prob_min", "prob_median"])
def test_adg_device_prob_boundaries(boundary):
    for seed in range(2):
        el = random_graph(70, 0.15, seed)
        g, jg = build_csr(el, num_nodes=70), jbuild_csr(el, num_nodes=70)
        r1 = dg.adg_ordering_rank_device(g, 0.1, boundary, seed=3,
                                         device="cpu")
        r2 = dg.adg_ordering_rank_device(g, 0.1, boundary, seed=3,
                                         device="cpu")
        np.testing.assert_array_equal(r1, r2)
        np.testing.assert_array_equal(r1, jdg.adg_ordering_rank_device(
            jg, 0.1, boundary, seed=3))
        assert sorted(r1.tolist()) == list(range(70))
        assert dg.verify_approx_degeneracy_order(g, r1, 0.1)
    el = generate_rmat_el(12, 16, seed=27491095)
    g, jg = build_csr(el, num_nodes=4096), jbuild_csr(el, num_nodes=4096)
    r1 = dg.adg_ordering_rank_device(g, 0.1, boundary, seed=5, device="cpu")
    np.testing.assert_array_equal(r1, jdg.adg_ordering_rank_device(
        jg, 0.1, boundary, seed=5))
    assert dg.verify_approx_degeneracy_order(g, r1, 0.1)
    assert not np.array_equal(r1, dg.adg_ordering_rank_device(
        g, 0.1, boundary, seed=6, device="cpu"))


def test_adg_round_plain_guard_and_pull():
    """One round by hand: a path 0-1-2-3 and a triangle 4-5-6, with 0 and 3
    already peeled. avg over the alive degrees (1, 1, 2, 2, 2) is 1.6, so
    (1 + 0.1) * 8 / 5 = 1.76 peels 1 and 2; at eps -0.9 the bound
    0.1 * 1.6 peels nothing and the guard peels the minimum degree."""
    g = build_csr(np.array([[0, 1], [1, 2], [2, 3], [4, 5], [5, 6], [4, 6]]))
    indptr, indices = torch.from_numpy(g.indptr), torch.from_numpy(g.indices)
    start = torch.tensor([0, 1, 1, 0, 2, 2, 2])
    alive0 = torch.tensor([False, True, True, False, True, True, True])
    for eps, peeled, deg_after in ((0.1, [1, 2], [0, 1, 1, 0, 2, 2, 2]),
                                   (-0.9, [1, 2], [0, 1, 1, 0, 2, 2, 2])):
        deg, alive = start.clone(), alive0.clone()
        peel = dg.adg_round(indptr, indices, deg, alive, boundary="avg",
                            eps=eps)
        assert torch.nonzero(peel)[:, 0].tolist() == peeled
        assert deg.tolist() == deg_after
        assert alive.tolist() == [False, False, False, False, True, True,
                                  True]
    deg, alive = start.clone(), alive0.clone()
    peel = dg.adg_round(indptr, indices, deg, alive, boundary="prob_min",
                        eps=0.1, bound=2.0)
    assert peel.tolist() == alive0.tolist() and not alive.any()
    with pytest.raises(ValueError, match="needs `bound`"):
        dg.adg_round(indptr, indices, deg, alive, boundary="prob_median",
                     eps=0.1)
    with pytest.raises(TypeError):
        dg.adg_round(indptr, indices.long(), deg, alive, boundary="avg",
                     eps=0.1)
    with pytest.raises(ValueError, match="unknown boundary"):
        dg.adg_round(indptr, indices, deg, alive, boundary="median", eps=0.1)
    with pytest.raises(ValueError, match="unknown device ADG boundary"):
        dg.adg_ordering_rank_device(g, 0.1, "median", device="cpu")


def test_triangle_count_ordering_equals_gms_tpu(pair):
    g, jg = pair
    rank = dg.triangle_count_ordering_rank(g, device="cpu")
    np.testing.assert_array_equal(rank, jdg.triangle_count_ordering_rank(jg))
    assert sorted(rank.tolist()) == list(range(g.num_nodes))


# ---------------------------------------------------------------------------
# ordered collections (Danisch peel), as tests/test_preprocessing.py
# ---------------------------------------------------------------------------

def test_tracking_collections_unit():
    vals = np.array([5, 1, 4, 1, 3], np.int64)
    for cls in (oc.TrackingHeap, oc.TrackingBubblingArray):
        c = cls(vals)
        assert len(c) == 5
        assert all(c.index(k) != -1 for k in range(5))
        c.decrease_key(0)          # 5 -> 4
        c.decrease_key(0)          # 4 -> 3
        assert c.value(0) == 3
        got = [c.pop_head() for _ in range(5)]
        assert sorted(k for k, _ in got) == [0, 1, 2, 3, 4]
        vs = [v for _, v in got]
        assert vs == sorted(vs)
        assert dict(got)[0] == 3
        assert c.index(got[0][0]) == -1 and len(c) == 0
        with pytest.raises(KeyError):
            c.decrease_key(got[0][0])


@pytest.mark.parametrize("collection", ["heap", "bubble"])
def test_danisch_degeneracy_equals_gms_tpu(collection, pair):
    g, jg = pair
    rank, core = oc.degeneracy_ordering_rank_danisch(g, collection=collection)
    jrank, jcore = joc.degeneracy_ordering_rank_danisch(
        jg, collection=collection)
    np.testing.assert_array_equal(rank, jrank)
    assert core == jcore == dg.degeneracy_ordering_rank(g)[1]
    assert dg.verify_degeneracy_order(g, rank)
    with pytest.raises(ValueError, match="unknown collection"):
        oc.degeneracy_ordering_rank_danisch(g, collection="list")


def _k17_replay(indptr, indices, deg, alive, *, boundary, eps, bound=None,
                thread_row=16, piece=512):
    """csrc/adg_round.cu's round replayed in numpy, phase by phase: the
    stats, the mask, the work list of a staying row's pieces of at most
    `piece` entries, each piece's count of peeled entries subtracted from
    deg, and the thread pass (alive, rows of at most `thread_row`
    entries). Returns (peel, deg, alive)."""
    deg, alive = deg.copy(), alive.copy()
    live = deg[alive]
    s, m, c = int(live.sum()), int(live.min()), int(alive.sum())
    b = bound
    if boundary == "avg":
        b = (1.0 + eps) * float(s) / float(c)
    elif boundary == "min":
        b = (2.0 + eps) * float(m)
    thr = b if float(m) <= b else float(m)
    peels = alive & (deg.astype(np.float64) <= thr)
    lens = np.diff(indptr)
    items = [(v, q) for v in np.flatnonzero(alive & ~peels &
                                            (lens > thread_row))
             for q in range(-(-int(lens[v]) // piece))]
    for v, q in items:
        a, e = int(indptr[v]), int(indptr[v + 1])
        s0 = a + q * piece
        deg[v] -= int(peels[indices[s0:min(s0 + piece, e)]].sum())
    for v in np.flatnonzero(alive):
        if peels[v]:
            alive[v] = False
        elif lens[v] <= thread_row:
            deg[v] -= int(peels[indices[indptr[v]:indptr[v + 1]]].sum())
    return peels, deg, alive


@pytest.mark.parametrize("boundary,eps", [("avg", 0.1), ("min", 0.5),
                                          ("avg", -0.5)])
def test_k17_replay_equals_the_plain_round(boundary, eps):
    """K17's pieces and thread rows give the plain round's state, every
    round, on RMAT-10 plus a vertex joined to all 1,024 others: a row of
    two pieces of 512 entries, or of sixteen of 64 (and more rows of
    several pieces)."""
    el = generate_rmat_el(10, 16, seed=27491095)
    star = np.stack([np.full(1024, 1024), np.arange(1024)], 1)
    g = build_csr(np.concatenate([el, star.astype(el.dtype)]), num_nodes=1025)
    indptr, indices = torch.from_numpy(g.indptr), torch.from_numpy(g.indices)
    for piece in (512, 64):
        deg = torch.from_numpy(g.degrees.astype(np.int64))
        alive = torch.ones(g.num_nodes, dtype=torch.bool)
        rounds = 0
        while bool(alive.any()):
            want = _k17_replay(g.indptr, g.indices, deg.numpy(),
                               alive.numpy(), boundary=boundary, eps=eps,
                               piece=piece)
            peel = dg.adg_round_plain(indptr, indices, deg, alive,
                                      boundary=boundary, eps=eps)
            assert np.array_equal(peel.numpy(), want[0])
            assert np.array_equal(deg.numpy(), want[1])
            assert np.array_equal(alive.numpy(), want[2])
            rounds += 1
        assert rounds >= 2
