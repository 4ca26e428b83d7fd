"""Vertex orderings of the PyTorch port against gms_tpu's.

Every comparison is exact: ranks, core numbers and degeneracies are
integers, and the ADG boundaries draw from the same numpy generator.
gms_tpu peels with its native C++ runtime when it is built; its ranks may
differ from the numpy loop's on ties, so the rank is compared against
gms_tpu's numpy peel, and the core numbers against both.
"""

import numpy as np
import pytest

from gms_tpu import native
from gms_tpu.io.builder import build_csr as jbuild_csr
from gms_tpu.preprocessing import degeneracy as jdg

from gms_tpu_torch.io.builder import build_csr
from gms_tpu_torch.io.generators import generate_rmat_el
from gms_tpu_torch.preprocessing import degeneracy as dg

from conftest import random_graph


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
