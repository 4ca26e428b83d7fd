"""Bitmap layout and bitmap set algebra of the PyTorch port against gms_tpu.

* BitmapGraph.from_csr: the same bits as gms_tpu's BitmapGraph;
* convert.bitmap_from_numpy carries gms_tpu's words across;
* every function of sets/bitmap_ops.py against gms_tpu's and against Python
  set oracles, mirroring tests/test_sets.py's TestBitmapRows.

All comparisons are exact (bit words and integer counts). The CUDA kernel of
the counts (csrc/bitmap_count.cu) is held against these plain versions on
the card by chip_smoke.py and test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gms_tpu.graphs.bitmap import BitmapGraph as JBitmapGraph
from gms_tpu.io.builder import build_csr as jbuild_csr
from gms_tpu.sets import bitmap_ops as jbo

import gms_tpu_torch
from gms_tpu_torch.convert import bitmap_from_numpy
from gms_tpu_torch.graphs.bitmap import BitmapGraph
from gms_tpu_torch.graphs.tiles import SENTINEL
from gms_tpu_torch.io.builder import build_csr
from gms_tpu_torch.io.generators import generate_rmat_el
from gms_tpu_torch.sets import bitmap_ops as bo

from conftest import random_graph

torch.set_num_threads(1)

WORDS = 8  # universe 200 < 256 bits, as tests/test_sets.py


def _sets(seed, num=32, universe=200, max_len=40):
    """Pairs of sets: the edge cases of tests/test_sets.py, then random."""
    rng = np.random.default_rng(seed)
    cases = [(np.array([], np.int64), np.array([], np.int64)),
             (np.array([], np.int64), np.arange(10)),
             (np.arange(10), np.arange(10)),
             (np.arange(0, 20, 2), np.arange(1, 21, 2))]
    while len(cases) < num:
        cases.append(tuple(np.unique(rng.integers(0, universe,
                                                  rng.integers(0, max_len)))
                           for _ in range(2)))
    return cases


def _pad(sets, width=64):
    out = np.full((len(sets), width), SENTINEL, dtype=np.int32)
    for i, s in enumerate(sets):
        out[i, :len(s)] = np.sort(s)
    return out


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.fixture(params=[0, 1], scope="module")
def rows(request):
    """(port a, port b, gms_tpu a, gms_tpu b, python set pairs)."""
    cases = _sets(request.param)
    ia, ib = _pad([a for a, _ in cases]), _pad([b for _, b in cases])
    a = bo.from_ids(torch.from_numpy(ia), WORDS)
    b = bo.from_ids(torch.from_numpy(ib), WORDS)
    ja = jbo.from_ids(jnp.asarray(ia), WORDS)
    jb = jbo.from_ids(jnp.asarray(ib), WORDS)
    return a, b, ja, jb, [(set(x.tolist()), set(y.tolist())) for x, y in cases]


def test_from_ids_equals_gms_tpu(rows):
    a, b, ja, jb, _ = rows
    assert a.dtype == torch.int32 and a.shape == (32, WORDS)
    assert np.array_equal(_u32(a), np.asarray(ja))
    assert np.array_equal(_u32(b), np.asarray(jb))
    # ids whose word lies past the width are dropped, and a sorted row's
    # repeats set their bit once, as in gms_tpu
    ids = np.array([[3, 40, 255, 300, SENTINEL],
                    [3, 3, 7, 7, 7]], dtype=np.int32)
    got = _u32(bo.from_ids(torch.from_numpy(ids), 2))
    assert np.array_equal(got, np.asarray(jbo.from_ids(jnp.asarray(ids), 2)))
    assert got[1].tolist() == [(1 << 3) | (1 << 7), 0]


def test_counts_equal_gms_tpu_and_sets(rows):
    a, b, ja, jb, oracle = rows
    pairs = [
        (bo.cardinality(a), jbo.cardinality(ja), [len(x) for x, _ in oracle]),
        (bo.intersect_count(a, b), jbo.intersect_count(ja, jb),
         [len(x & y) for x, y in oracle]),
        (bo.union_count(a, b), jbo.union_count(ja, jb),
         [len(x | y) for x, y in oracle]),
        (bo.difference_count(a, b), jbo.difference_count(ja, jb),
         [len(x - y) for x, y in oracle]),
    ]
    for got, want, sets in pairs:
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert got.tolist() == sets
    assert np.array_equal(bo.popcount(a).numpy(), np.asarray(jbo.popcount(ja)))
    # the counts take any leading shape, as gms_tpu's sum over the last axis
    assert torch.equal(bo.intersect_count(a.view(4, 8, WORDS),
                                          b.view(4, 8, WORDS)).reshape(-1),
                       bo.intersect_count(a, b))


def test_word_ops_equal_gms_tpu(rows):
    a, b, ja, jb, _ = rows
    for fn in ("intersect", "union", "difference"):
        got = getattr(bo, fn)(a, b)
        assert np.array_equal(_u32(got), np.asarray(getattr(jbo, fn)(ja, jb)))


def test_to_ids_roundtrip(rows):
    a, _, ja, _, oracle = rows
    back = bo.to_ids(a, 64)
    assert np.array_equal(back.numpy(), np.asarray(jbo.to_ids(ja, 64)))
    for row, (x, _) in zip(back.numpy(), oracle):
        assert set(row[row != SENTINEL].tolist()) == x


def test_contains_add_remove(rows):
    a, _, ja, _, oracle = rows
    rng = np.random.default_rng(5)
    x = rng.integers(0, 32 * WORDS, len(oracle)).astype(np.int32)
    x[::3] = 7
    x[1] = 31  # the sign bit of an int32 word
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    got = bo.contains(a, tx)
    assert np.array_equal(got.numpy(), np.asarray(jbo.contains(ja, jx)))
    assert got.tolist() == [int(v) in s for v, (s, _) in zip(x, oracle)]
    for fn, op in (("add", set.union), ("remove", set.difference)):
        out = getattr(bo, fn)(a, tx)
        assert np.array_equal(_u32(out), np.asarray(getattr(jbo, fn)(ja, jx)))
        assert bo.cardinality(out).tolist() == [
            len(op(s, {int(v)})) for v, (s, _) in zip(x, oracle)]


def test_rows_count_rejects_bad_inputs():
    a = torch.zeros((3, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown op"):
        bo.rows_count(a, a, op="xor")
    with pytest.raises(TypeError):
        bo.rows_count(a.long(), op="card")
    with pytest.raises(ValueError, match="shapes differ"):
        bo.rows_count(a, a[:2], op="and")
    with pytest.raises(ValueError, match="contiguous"):
        bo.rows_count(a.T, op="card")


def _graph_pairs():
    out = []
    for seed in (0, 1):
        el = random_graph(90, 0.25, seed)
        out.append((build_csr(el, num_nodes=90), jbuild_csr(el, num_nodes=90)))
    el = generate_rmat_el(9, 16, seed=7)
    out.append((build_csr(el, num_nodes=512), jbuild_csr(el, num_nodes=512)))
    return out


def test_bitmap_graph_equals_gms_tpu(fixture_edge_lists):
    pairs = _graph_pairs() + [(build_csr(el), jbuild_csr(el))
                              for el in fixture_edge_lists.values()]
    for g, jg in pairs:
        bg = BitmapGraph.from_csr(g, device="cpu")
        jbg = JBitmapGraph.from_csr(jg)
        assert (bg.v_pad, bg.w_pad) == (jbg.v_pad, jbg.w_pad)
        assert (bg.num_nodes, bg.num_edges) == (jbg.num_nodes, jbg.num_edges)
        assert bg.words.dtype == torch.int32
        assert np.array_equal(_u32(bg.words), np.asarray(jbg.words))
        vids = np.array([0, g.num_nodes - 1, 3], dtype=np.int32)
        assert np.array_equal(_u32(bg.rows(torch.from_numpy(vids))),
                              np.asarray(jbg.rows(jnp.asarray(vids))))
        # each row's popcount is the vertex's degree
        assert np.array_equal(bo.cardinality(bg.words)[:g.num_nodes].numpy(),
                              g.degrees)
    assert gms_tpu_torch.BitmapGraph is BitmapGraph


def test_bitmap_from_numpy_roundtrip():
    for g, jg in _graph_pairs():
        jbg = JBitmapGraph.from_csr(jg)
        bg = bitmap_from_numpy(np.asarray(jbg.words), device="cpu",
                               num_nodes=jbg.num_nodes)
        assert np.array_equal(_u32(bg.words), np.asarray(jbg.words))
        assert (bg.num_nodes, bg.num_edges) == (jg.num_nodes, jg.num_edges)
        # the carried words are an owned copy
        bg.words.zero_()
        assert np.asarray(jbg.words).any()
