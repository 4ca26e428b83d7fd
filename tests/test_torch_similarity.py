"""The port's algorithms/similarity.py: the mirror of tests/test_similarity.py's
similarity tests on the plain versions, and the port against gms_tpu on the
same numpy inputs — every score bit for bit for Jaccard, overlap, CN, TN and
PA (one IEEE operation on exact integer counts), to rtol 1e-5 for AA and RA
(float32 weights summed in another order than XLA's, the tolerance
tests/test_similarity.py holds gms_tpu to its oracle by)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gms_tpu.algorithms import similarity as jsim
from gms_tpu.graphs.tiles import PaddedGraph as JPaddedGraph
from gms_tpu.graphs.tiles import round_up
from gms_tpu.io.builder import build_csr as jbuild_csr

from gms_tpu_torch.algorithms import link_prediction as lp
from gms_tpu_torch.algorithms import similarity as vs
from gms_tpu_torch.graphs.tiles import PaddedGraph
from gms_tpu_torch.io.builder import build_csr
from gms_tpu_torch.io.generators import generate_rmat_el

from conftest import random_graph

torch.set_num_threads(1)

ALL_METRICS = list(vs.METRICS)


def make_pairs(n, count, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, size=(count, 2)).astype(np.int32)


def assert_scores(got, want, metric):
    """Bit for bit (NaN where NaN) for the count metrics, rtol 1e-5 for
    AA/RA."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if metric in vs.WEIGHTED:
        np.testing.assert_allclose(got, want, rtol=1e-5, equal_nan=True)
        return
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan), metric
    assert np.array_equal(got[~nan].view(np.int32),
                          want[~nan].view(np.int32)), metric


# ---------------------------------------------------------------------------
# the mirror of tests/test_similarity.py (plain versions, device="cpu")
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ALL_METRICS)
def test_pair_scores_vs_oracle(metric):
    g = build_csr(random_graph(40, 0.2, 1), num_nodes=40)
    pairs = make_pairs(40, 200, 2)
    got = vs.vertex_similarity(g, pairs, metric, device="cpu")
    want = vs.vertex_similarity_oracle(g, pairs, metric)
    np.testing.assert_allclose(got, want.astype(np.float32), rtol=1e-5,
                               equal_nan=True)


def test_jaccard_reference_quirks():
    # both-empty -> 1.0 (vertex_similarity.h:31-33)
    g = build_csr(np.array([[0, 1]], dtype=np.int64), num_nodes=4)
    got = vs.vertex_similarity(g, np.array([[2, 3]]), "jaccard", device="cpu")
    assert got[0] == 1.0
    # denominator includes +c, not -c: N(0)={1}, N(1)={0} -> c=0 -> 0.0
    got = vs.vertex_similarity(g, np.array([[0, 1]]), "jaccard", device="cpu")
    assert got[0] == 0.0


def test_adamic_adar_deg1_inf():
    # deg(w)==1 -> 1/log(1) = +inf, matching C++ (vertex_similarity.h:100-103)
    g = build_csr(np.array([[0, 2], [1, 2]], dtype=np.int64), num_nodes=3)
    got = vs.vertex_similarity(g, np.array([[2, 2]]), "adamic_adar",
                               device="cpu")
    assert np.isinf(got[0])


@pytest.mark.parametrize("metric", ALL_METRICS)
def test_all_pairs_matches_pair_scores(metric):
    n = 30
    g = build_csr(random_graph(n, 0.25, 3), num_nodes=n)
    dense = np.zeros((n, round_up(n, 128)), dtype=np.float32)
    e = g.edge_array()
    dense[e[:, 0], e[:, 1]] = 1.0
    adj = torch.from_numpy(dense).to(torch.bfloat16)
    deg = torch.from_numpy(g.degrees)
    s = vs.all_pairs_scores(adj, deg, adj, deg, metric=metric).numpy()[:, :n]
    pairs = np.stack(np.meshgrid(np.arange(n), np.arange(n), indexing="ij"),
                     axis=-1).reshape(-1, 2)
    want = vs.vertex_similarity_oracle(g, pairs, metric).reshape(n, n)
    np.testing.assert_allclose(s, want.astype(np.float32), rtol=1e-4,
                               atol=1e-6, equal_nan=True)


# ---------------------------------------------------------------------------
# the port against gms_tpu on the same inputs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rmat():
    """RMAT-10 from both packages (equal CSR), padded, and pairs that hit
    every clip rule: negative ids, ids past V_pad, self-pairs, isolated
    vertices."""
    el = generate_rmat_el(10, 16, seed=27491095)
    g, jg = build_csr(el, num_nodes=1024), jbuild_csr(el, num_nodes=1024)
    assert np.array_equal(g.indices, jg.indices)
    pg, jpg = PaddedGraph.from_csr(g, device="cpu"), JPaddedGraph.from_csr(jg)
    nbr = np.asarray(jpg.nbr)
    assert np.array_equal(pg.nbr.numpy(), nbr)
    pairs = make_pairs(1024, 600, 5)
    iso = np.nonzero(g.degrees == 0)[0][:4]
    pairs = np.concatenate([pairs, [[-3, 5], [7, 5000], [9, 9], [2000, -1]],
                            np.stack([iso, iso[::-1]], axis=1)]).astype(np.int32)
    return g, jg, pg, jpg, nbr, pairs


@pytest.mark.parametrize("metric", ALL_METRICS)
def test_pair_scores_equal_gms_tpu(rmat, metric):
    g, jg, pg, jpg, nbr, pairs = rmat
    deg1 = vs._deg_lookup(pg)
    jdeg1 = jsim._deg_lookup(jpg)
    assert np.array_equal(deg1.numpy(), np.asarray(jdeg1))
    want = np.asarray(jsim.pair_scores(jpg.nbr, jdeg1, jnp.asarray(pairs),
                                       metric=metric))
    got = vs.pair_scores(pg.nbr, deg1, torch.from_numpy(pairs), metric=metric)
    assert_scores(got.numpy(), want, metric)
    # narrower tables for each side, smaller-degree end first, as gms_tpu's
    # tiered scorer slices them
    deg = g.degrees
    p = pairs[(pairs >= 0).all(1) & (pairs < 1024).all(1)]
    p = np.where((deg[p[:, 0]] > deg[p[:, 1]])[:, None], p[:, ::-1], p)
    da, db = int(deg[p[:, 0]].max()), int(deg[p[:, 1]].max())
    want = np.asarray(jsim.pair_scores(
        jpg.nbr[:, :da], jdeg1, jnp.asarray(p), metric=metric,
        nbr_b=jpg.nbr[:, :db]))
    got = vs.pair_scores(pg.nbr[:, :da].contiguous(), deg1,
                         torch.from_numpy(np.ascontiguousarray(p)),
                         metric=metric, nbr_b=pg.nbr[:, :db].contiguous())
    assert_scores(got.numpy(), want, metric)


@pytest.mark.parametrize("method", ["compare", "searchsorted"])
def test_pair_scores_methods_and_out(rmat, method):
    g, jg, pg, jpg, nbr, pairs = rmat
    deg1 = vs._deg_lookup(pg)
    p = torch.from_numpy(pairs)
    want = vs.pair_scores(pg.nbr, deg1, p, metric="jaccard")
    got = vs.pair_scores(pg.nbr, deg1, p, metric="jaccard", method=method)
    assert torch.equal(got, want)
    # out/out_pos: scores land in pair order
    out = torch.full((len(pairs) + 3,), -1.0)
    pos = torch.from_numpy(np.random.default_rng(1).permutation(
        len(pairs) + 3)[:len(pairs)].astype(np.int32))
    vs.pair_scores(pg.nbr, deg1, p, metric="jaccard", out=out, out_pos=pos)
    assert torch.equal(out[pos.long()], want)
    assert int((out == -1.0).sum()) == 3


@pytest.mark.parametrize("metric", ALL_METRICS)
def test_pair_scores_hub_equal_gms_tpu(rmat, metric):
    g, jg, pg, jpg, nbr, pairs = rmat
    deg = pg.deg.numpy()
    bm, hub_idx, vw = lp._hub_bitmaps(g, deg, pg.v_pad, 20)
    hubs = np.nonzero(deg > 20)[0]
    assert 20 < len(hubs) < 1024
    rng = np.random.default_rng(6)
    hp = np.stack([rng.integers(-2, 1030, 400), rng.choice(hubs, 400)],
                  axis=1).astype(np.int32)
    deg1 = vs._deg_lookup(pg)
    want = np.asarray(jsim.pair_scores_hub(
        jpg.nbr, jsim._deg_lookup(jpg), jnp.asarray(bm.reshape(-1)),
        jnp.asarray(hub_idx), jnp.asarray(hp), metric=metric, vw=vw))
    got = vs.pair_scores_hub(
        pg.nbr, deg1, torch.from_numpy(bm.reshape(-1).view(np.int32)),
        torch.from_numpy(hub_idx), torch.from_numpy(hp), metric=metric, vw=vw)
    assert_scores(got.numpy(), want, metric)
    # a hub pair scores the same through the merge
    real = hp[(hp[:, 0] >= 0) & (hp[:, 0] < 1024)]
    merge = vs.pair_scores(pg.nbr, deg1, torch.from_numpy(real),
                           metric=metric).numpy()
    hub = vs.pair_scores_hub(
        pg.nbr, deg1, torch.from_numpy(bm.reshape(-1).view(np.int32)),
        torch.from_numpy(hub_idx), torch.from_numpy(real), metric=metric,
        vw=vw).numpy()
    assert_scores(hub, merge, metric)


@pytest.mark.parametrize("metric", ALL_METRICS)
def test_all_pairs_scores_equal_gms_tpu(rmat, metric):
    g, jg, pg, jpg, nbr, pairs = rmat
    n = 300
    sub = build_csr(random_graph(n, 0.05, 8), num_nodes=n)
    dense = np.zeros((n, round_up(n, 128)), np.float32)
    e = sub.edge_array()
    dense[e[:, 0], e[:, 1]] = 1.0
    blk = dense[37:37 + 90]
    deg = sub.degrees
    want = np.asarray(jsim.all_pairs_scores(
        jnp.asarray(blk, jnp.bfloat16), jnp.asarray(deg[37:127]),
        jnp.asarray(dense, jnp.bfloat16), jnp.asarray(deg), metric=metric))
    tdeg = torch.from_numpy(deg)
    got = vs.all_pairs_scores(torch.from_numpy(blk), tdeg[37:127],
                              torch.from_numpy(dense), tdeg, metric=metric)
    assert_scores(got.numpy(), want, metric)
    # K21's plain version, from packed words, equals the matmul form
    u, v = vs.pack_rows(torch.from_numpy(blk)), vs.pack_rows(
        torch.from_numpy(dense))
    wcol = (vs.column_weights(tdeg, metric, 32 * u.shape[1])
            if metric in vs.WEIGHTED else None)
    tile = vs.tile_all_pairs(u, v, tdeg[37:127].contiguous(), tdeg,
                             metric=metric, wcol=wcol)
    assert_scores(tile.numpy(), got.numpy(), metric)


def test_pack_and_column_weights():
    rng = np.random.default_rng(3)
    dense = torch.from_numpy((rng.random((5, 70)) < 0.3).astype(np.float32))
    words = vs.pack_rows(dense)
    assert words.shape == (5, 3) and words.dtype == torch.int32
    assert torch.equal(vs.unpack_rows(words, 70), dense)
    deg = torch.tensor([0, 1, 2, 5], dtype=torch.int32)
    aa = vs.column_weights(deg, "adamic_adar", 6)
    assert aa[0] == 0 and torch.isinf(aa[1]) and aa[4] == 0 and aa[5] == 0
    assert torch.allclose(aa[2:4], 1 / torch.log(torch.tensor([2.0, 5.0])))
    ra = vs.column_weights(deg, "resource", 3)
    assert ra.tolist() == [0.0, 1.0, 0.5]


def test_jaccard_standard_equal_gms_tpu(rmat):
    g, jg, pg, jpg, nbr, pairs = rmat
    p = pairs[(pairs >= 0).all(1) & (pairs < 1024).all(1)]
    want = np.asarray(jsim.jaccard_standard(jpg.nbr, jsim._deg_lookup(jpg),
                                            jnp.asarray(p)))
    got = vs.jaccard_standard(pg.nbr, vs._deg_lookup(pg), torch.from_numpy(p))
    assert_scores(got.numpy(), want, "jaccard")


def test_vertex_similarity_oracle_equals_gms_tpu(rmat):
    g, jg, pg, jpg, nbr, pairs = rmat
    p = pairs[:100]
    for metric in ALL_METRICS:
        assert np.array_equal(vs.vertex_similarity_oracle(g, p, metric),
                              jsim.vertex_similarity_oracle(jg, p, metric),
                              equal_nan=True)
