"""The port's graphs/compressed.py and graphs/permuters.py: the mirror of
tests/test_compressed.py on the plain versions (device="cpu"), and the port
against gms_tpu on the same inputs — packed words and degrees, the k-bit
decode (K28's plain version) at k in {8, 13, 16, 17, 24, 32}, the varint
payloads, the hybrid and bucketed decodes, the permutations and the triangle
counts of every compressed form — all exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gms_tpu.algorithms.triangle_count import triangle_count as jtriangle_count
from gms_tpu.graphs import compressed as jcp
from gms_tpu.graphs import permuters as jpermuters
from gms_tpu.io.builder import build_csr as jbuild_csr

from gms_tpu_torch import convert
from gms_tpu_torch.algorithms import triangle_count as tc
from gms_tpu_torch.graphs import compressed as cp
from gms_tpu_torch.graphs import permuters
from gms_tpu_torch.graphs.tiles import PaddedGraph, SENTINEL
from gms_tpu_torch.io.builder import build_csr
from gms_tpu_torch.io.generators import generate_rmat_el

from conftest import random_graph

torch.set_num_threads(1)

CPU = {"device": "cpu"}

EDGE_LISTS = (
    (random_graph(50, 0.15, 0), 50),
    (generate_rmat_el(8, 6, seed=1), 256),
    (np.zeros((0, 2), dtype=np.int64), 5),
)


@pytest.fixture(scope="module")
def graphs():
    return [build_csr(el, num_nodes=n) for el, n in EDGE_LISTS]


@pytest.fixture(scope="module")
def jgraphs():
    return [jbuild_csr(el, num_nodes=n) for el, n in EDGE_LISTS]


def padded_rows(g):
    return PaddedGraph.from_csr(g, **CPU).nbr.numpy()


def words(t):
    """uint32 view of an int32 word tensor."""
    return t.numpy().view(np.uint32)


# --- the mirror of tests/test_compressed.py ---------------------------------

def test_kbit_roundtrip(graphs):
    for g in graphs:
        kg = cp.KbitGraph.from_csr(g, **CPU)
        got = kg.nbr.numpy()
        want = padded_rows(g)
        np.testing.assert_array_equal(got[:, : want.shape[1]], want)
        assert kg.bits_per_edge() > 0


def test_kbit_row_gather(graphs):
    g = graphs[1]
    kg = cp.KbitGraph.from_csr(g, **CPU)
    vids = torch.tensor([0, 3, 17, 255], dtype=torch.int32)
    got = kg.rows(vids).numpy()
    want = padded_rows(g)[np.array([0, 3, 17, 255])]
    np.testing.assert_array_equal(got[:, : want.shape[1]], want)


def test_kbit_footprint_smaller():
    g = build_csr(generate_rmat_el(8, 6, seed=2), num_nodes=256)
    kg = cp.KbitGraph.from_csr(g, **CPU)
    # 8-bit ids vs 32-bit: packed must be < half the padded int32 layout
    assert kg.bits_per_edge() < 32 * padded_rows(g).size / g.num_edges / 2


def test_kbit_bucketed_roundtrip(graphs):
    for g in graphs[:2]:
        kb = cp.KbitGraphBucketed.from_csr(g, **CPU)
        got = kb.decode_all()
        want = padded_rows(g)
        n = g.num_nodes
        np.testing.assert_array_equal(got[:n, : want.shape[1]], want[:n])
        assert (want[n:] == SENTINEL).all()


def test_varint_roundtrip(graphs):
    for g in graphs:
        data = cp.varint_encode_graph(g)
        g2 = cp.varint_decode_graph(data)
        assert g2 == g
        assert len(data["payload"]) < max(4 * g.num_edges, 1) or g.num_edges == 0


def test_varint_word_roundtrip(graphs):
    for g in graphs:
        data = cp.varint_encode_graph_words(g)
        g2 = cp.varint_decode_graph_words(data)
        assert g2 == g
        assert len(data["payload"]) % 4 == 0
        # every gap fits one 31-bit word on these graphs: one word/token
        assert len(data["payload"]) == 4 * g.num_edges


def test_varint_word_wide_ids():
    el = np.array([[0, 1], [0, 2], [1, 2]], dtype=np.int64)
    g = build_csr(el, num_nodes=3)
    for enc, dec in ((cp.varint_encode_graph, cp.varint_decode_graph),
                     (cp.varint_encode_graph_words,
                      cp.varint_decode_graph_words)):
        assert dec(enc(g)) == g


HUB_EL = np.array([[0, i] for i in range(1, 200)]
                  + [[i, i + 1] for i in range(1, 199)], dtype=np.int64)


def test_hybrid_roundtrip():
    g = build_csr(HUB_EL, num_nodes=200)
    h = cp.HybridGraph.from_csr(g, **CPU)
    assert len(h.bitmap_vids) >= 1  # the hub went dense
    got = h.decode_all()
    want = padded_rows(g)
    np.testing.assert_array_equal(got[: want.shape[0], : want.shape[1]], want)


@pytest.mark.parametrize("variant", permuters.VARIANTS)
def test_permuters_are_permutations(variant, graphs, jgraphs):
    g = graphs[0]
    pm = permuters.permutation_map(g, variant, seed=3)
    assert sorted(pm.tolist()) == list(range(g.num_nodes))
    g2 = permuters.apply_permutation(g, variant, seed=3)
    assert g2.num_edges == g.num_edges
    assert sorted(g2.degrees.tolist()) == sorted(g.degrees.tolist())
    # gms_tpu's permutation, entry for entry, at two seeds
    for seed in (0, 3):
        np.testing.assert_array_equal(
            permuters.permutation_map(g, variant, seed=seed),
            jpermuters.permutation_map(jgraphs[0], variant, seed=seed))


def test_gap_bfs_improves_gaps():
    g = build_csr(generate_rmat_el(9, 4, seed=4), num_nodes=512)
    g_rand = permuters.apply_permutation(g, "random", seed=5)
    before = permuters.average_gap_bits(g_rand)
    after = permuters.average_gap_bits(
        permuters.apply_permutation(g_rand, "gap_bfs"))
    assert after < before


def test_kernels_run_on_compressed():
    """Compressed graphs are drop-in inputs for set kernels (decode path)."""
    from gms_tpu_torch.sets import ops

    g = build_csr(random_graph(40, 0.3, 6), num_nodes=40)
    kg = cp.KbitGraph.from_csr(g, **CPU)
    nbr = kg.nbr
    e = g.edge_array()
    e = e[e[:, 0] < e[:, 1]]
    a = nbr[torch.from_numpy(e[:, 0]).long()]
    b = nbr[torch.from_numpy(e[:, 1]).long()]
    total = int(ops.intersect_count(a, b).sum())
    assert total // 3 == tc.triangle_count_oracle(g)


def test_rcm_and_barycenter_reduce_gaps():
    g = build_csr(generate_rmat_el(9, 6, seed=11), num_nodes=512)
    g_rand = permuters.apply_permutation(g, "random", seed=5)
    base = permuters.average_gap_bits(g_rand)
    for variant in ("gap_bfs", "rcm", "gap_barycenter"):
        after = permuters.average_gap_bits(
            permuters.apply_permutation(g_rand, variant))
        assert after < base, (variant, after, base)


def test_permuters_are_bijections():
    g = build_csr(random_graph(50, 0.2, 3), num_nodes=50)
    for variant in permuters.VARIANTS:
        p = permuters.permutation_map(g, variant, seed=1)
        assert sorted(p.tolist()) == list(range(50)), variant


def test_triangle_count_dense_bitmap():
    for seed in range(3):
        g = build_csr(random_graph(90, 0.25, seed), num_nodes=90)
        assert (tc.triangle_count_dense(g, chunk=64, **CPU)
                == tc.triangle_count_oracle(g))


def _weighted_case():
    g = build_csr(random_graph(80, 0.08, seed=9), num_nodes=80)
    rng = np.random.default_rng(4)
    e = g.edge_array()
    key = {(min(a, b), max(a, b)): None for a, b in e}
    sym = {k: int(rng.integers(1, 17)) for k in key}
    w = np.array([sym[(min(a, b), max(a, b))] for a, b in e], np.int32)
    return g, w


def test_kbit_weighted_roundtrip_and_sssp():
    """tests/test_compressed.py's test of the same name: the round trip,
    then SSSP straight from the packed planes against the oracle and
    gms_tpu."""
    from gms_tpu.algorithms import gapbs as jgapbs
    from gms_tpu_torch.algorithms import gapbs

    g, w = _weighted_case()
    kg = cp.KbitWeightedGraph.from_csr(g, w, **CPU)
    rows = kg.nbr.numpy()[: g.num_nodes]
    wr = kg.weight_rows().numpy()[: g.num_nodes]
    deg = g.degrees
    for v in (0, 7, 33, 79):
        d = int(deg[v])
        assert (rows[v, :d] == g.out_neigh(v)).all()
        lo = int(g.indptr[v])
        assert (wr[v, :d] == w[lo : lo + d]).all()
    padded_bits = 2 * 32 * rows.size
    packed_bits = 32 * (kg.ids.packed.numel() + kg.wplane.numel())
    assert packed_bits < padded_bits / 2
    # gms_tpu's planes and weight rows, word for word
    jg = jbuild_csr(random_graph(80, 0.08, seed=9), num_nodes=80)
    jkg = jcp.KbitWeightedGraph.from_csr(jg, w)
    np.testing.assert_array_equal(words(kg.wplane), np.asarray(jkg.wplane))
    np.testing.assert_array_equal(kg.weight_rows().numpy(),
                                  np.asarray(jkg.weight_rows()))
    got = gapbs.sssp(kg, 0, **CPU)
    np.testing.assert_array_equal(got, gapbs.sssp_oracle(g, 0, w))
    np.testing.assert_array_equal(got, jgapbs.sssp(jkg, 0))


# --- the port against gms_tpu ------------------------------------------------

@pytest.mark.parametrize("k", [None, 9, 13, 17, 32])
def test_kbit_words_equal_gms_tpu(graphs, jgraphs, k):
    for g, jg in zip(graphs, jgraphs):
        kg = cp.KbitGraph.from_csr(g, k=k, **CPU)
        jkg = jcp.KbitGraph.from_csr(jg, k=k)
        assert (kg.k, kg.d_pad) == (jkg.k, jkg.d_pad)
        np.testing.assert_array_equal(words(kg.packed), np.asarray(jkg.packed))
        np.testing.assert_array_equal(kg.deg.numpy(), np.asarray(jkg.deg))
        np.testing.assert_array_equal(kg.nbr.numpy(), np.asarray(jkg.nbr))


@pytest.mark.parametrize("k", [8, 13, 16, 17, 24, 32])
def test_kbit_decode_rows_plain_equals_gms_tpu(k):
    """Random words (every lane, s == 0 and cross-word lanes, k = 32's full
    mask), random degrees and ids, some out of range (clipped)."""
    rng = np.random.default_rng(k)
    V, d_pad = 37, 96
    W = (d_pad * k + 31) // 32 + int(k % 2)
    packed = rng.integers(0, 1 << 32, (V, W), dtype=np.uint64).astype(np.uint32)
    deg = rng.integers(0, d_pad + 1, V).astype(np.int32)
    deg[:3] = (0, d_pad, 1)
    vids = rng.integers(-5, V + 5, 300).astype(np.int32)
    want = np.asarray(jcp.kbit_decode_rows(
        jnp.asarray(packed), jnp.asarray(deg), jnp.asarray(vids), k=k,
        d_pad=d_pad))
    got = cp.kbit_decode_rows(torch.from_numpy(packed.view(np.int32)),
                              torch.from_numpy(deg), torch.from_numpy(vids),
                              k=k, d_pad=d_pad)
    np.testing.assert_array_equal(got.numpy(), want)
    assert cp.LAUNCHES["kbit_decode_rows"] == 0


def test_kbit_decode_rows_rejects_bad_inputs():
    p, deg, v = (torch.zeros((4, 3), dtype=torch.int32),
                 torch.zeros(4, dtype=torch.int32),
                 torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="k must be"):
        cp.kbit_decode_rows(p, deg, v, k=33, d_pad=2)
    with pytest.raises(ValueError, match="do not fit"):
        cp.kbit_decode_rows(p, deg, v, k=8, d_pad=13)
    with pytest.raises(ValueError, match="deg has"):
        cp.kbit_decode_rows(p, deg[:3], v, k=8, d_pad=12)
    with pytest.raises(TypeError):
        cp.kbit_decode_rows(p.long(), deg, v, k=8, d_pad=12)


def test_varint_bytes_equal_gms_tpu(graphs, jgraphs):
    wide = np.array([[0, 1], [0, 2], [1, 2]], dtype=np.int64)
    pairs = [*zip(graphs, jgraphs),
             (build_csr(wide, num_nodes=3), jbuild_csr(wide, num_nodes=3))]
    for g, jg in pairs:
        for enc, jenc in ((cp.varint_encode_graph, jcp.varint_encode_graph),
                          (cp.varint_encode_graph_words,
                           jcp.varint_encode_graph_words)):
            got, want = enc(g), jenc(jg)
            assert got["payload"] == want["payload"]
            np.testing.assert_array_equal(got["offsets"], want["offsets"])
            assert {k: v for k, v in got.items()
                    if k not in ("payload", "offsets")} == {
                k: v for k, v in want.items()
                if k not in ("payload", "offsets")}


def test_bucketed_and_hybrid_equal_gms_tpu(graphs, jgraphs):
    cases = [*zip(graphs[:2], jgraphs[:2]),
             (build_csr(HUB_EL, num_nodes=200), jbuild_csr(HUB_EL,
                                                           num_nodes=200))]
    for g, jg in cases:
        kb, jkb = (cp.KbitGraphBucketed.from_csr(g, **CPU),
                   jcp.KbitGraphBucketed.from_csr(jg))
        assert sorted(kb.parts) == sorted(jkb.parts)
        for kbits, (part, vids) in kb.parts.items():
            jpart, jvids = jkb.parts[kbits]
            np.testing.assert_array_equal(vids, jvids)
            np.testing.assert_array_equal(words(part.packed),
                                          np.asarray(jpart.packed))
        np.testing.assert_array_equal(kb.decode_all(), jkb.decode_all())
        assert kb.bits_per_edge() == jkb.bits_per_edge()
        h, jh = cp.HybridGraph.from_csr(g, **CPU), jcp.HybridGraph.from_csr(jg)
        np.testing.assert_array_equal(h.bitmap_vids.numpy(),
                                      np.asarray(jh.bitmap_vids))
        np.testing.assert_array_equal(words(h.bitmap_rows),
                                      np.asarray(jh.bitmap_rows))
        np.testing.assert_array_equal(words(h.kbit.packed),
                                      np.asarray(jh.kbit.packed))
        np.testing.assert_array_equal(h.decode_all(), jh.decode_all())
        assert h.bits_per_edge() == jh.bits_per_edge()


def test_triangle_count_of_compressed_forms_equals_gms_tpu():
    el = generate_rmat_el(9, 16, seed=27491095)
    g, jg = build_csr(el, num_nodes=512), jbuild_csr(el, num_nodes=512)
    want = tc.triangle_count_oracle(g)
    for make, jmake in ((cp.KbitGraph.from_csr, jcp.KbitGraph.from_csr),
                        (cp.KbitGraphBucketed.from_csr,
                         jcp.KbitGraphBucketed.from_csr),
                        (cp.HybridGraph.from_csr, jcp.HybridGraph.from_csr)):
        rep = make(g, **CPU)
        assert cp.as_csr(rep) == g
        assert tc.triangle_count(rep, **CPU) == want
        assert jtriangle_count(jmake(jg)) == want
    with pytest.raises(TypeError, match="unsupported"):
        cp.as_csr(object())


def test_kbit_from_numpy(jgraphs):
    jg = jgraphs[1]
    jkg = jcp.KbitGraph.from_csr(jg)
    kg = convert.kbit_from_numpy(np.asarray(jkg.packed), np.asarray(jkg.deg),
                                 jkg.k, jkg.d_pad, jkg.num_nodes,
                                 jkg.num_edges, **CPU)
    assert isinstance(kg, cp.KbitGraph) and kg.packed.dtype == torch.int32
    np.testing.assert_array_equal(kg.nbr.numpy(), np.asarray(jkg.nbr))
    assert kg.bits_per_edge() == jkg.bits_per_edge()
    with pytest.raises(ValueError, match="do not fit"):
        convert.kbit_from_numpy(np.asarray(jkg.packed), np.asarray(jkg.deg),
                                jkg.k, 10 * jkg.d_pad, jkg.num_nodes,
                                jkg.num_edges, **CPU)
