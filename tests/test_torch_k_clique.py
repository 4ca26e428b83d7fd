"""k-clique counting in the PyTorch port against gms_tpu and the oracles.

* plan_tier_chunks arrays against gms_tpu's;
* each kernel's plain PyTorch version (what the wrapper runs on CPU
  tensors) against its gms_tpu jax program on the same inputs, carried
  across by convert.py: build_local_adj, kclique_dense_chunk (k=3..5) and
  kc_fused_chunk (k=6..8, against gms_tpu's total when it finished without
  overflow);
* kclique_count(device="cpu") against gms_tpu's kclique_count and both
  oracles; the bench CLI.

Every comparison is exact: all results are integers. Plan arrays are
compared under one rank, gms_tpu's (its native peel may order ties unlike
the port's numpy peel). The CUDA kernels themselves are held against these
plain versions on the card by chip_smoke.py and by the `cuda`-marked tests
of test_torch_kernels.py.
"""

import os
import subprocess
import sys
from math import comb
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gms_tpu.algorithms import k_clique as jkc
from gms_tpu.graphs.tiles import PaddedGraph as JPaddedGraph
from gms_tpu.io.builder import build_csr as jbuild_csr
from gms_tpu.preprocessing import degeneracy as jdg
from gms_tpu.preprocessing import orient as jorient

from gms_tpu_torch.algorithms import k_clique as kc
from gms_tpu_torch.convert import padded_from_numpy, tensor_from_numpy
from gms_tpu_torch.graphs.tiles import SENTINEL
from gms_tpu_torch.io.builder import build_csr
from gms_tpu_torch.io.generators import generate_rmat_el

from conftest import random_graph

torch.set_num_threads(1)

SEED = 27491095


def complete_graph_el(n):
    src, dst = np.nonzero(np.triu(np.ones((n, n), dtype=bool), 1))
    return np.stack([src, dst], axis=1).astype(np.int64)


def both(el, n):
    return build_csr(el, num_nodes=n), jbuild_csr(el, num_nodes=n)


def rmat(scale, deg=16, seed=SEED):
    return both(generate_rmat_el(scale, deg, seed=seed), 1 << scale)


def jax_plan(jg, k, root_chunk=kc.DEFAULT_ROOT_CHUNK):
    """gms_tpu's planning of kclique_count: (jax PaddedGraph, [(chunk, ww)])."""
    rank, _ = jdg.degeneracy_ordering_rank(jg)
    dag = jorient.orient(jg, rank)
    jpg = JPaddedGraph.from_csr(dag, lane=32)
    deg = np.asarray(dag.degrees)
    roots = np.nonzero(deg >= k - 1)[0].astype(np.int32)
    chunks = list(jkc.plan_tier_chunks(deg, roots, np.int32(jpg.v_pad),
                                       root_chunk=root_chunk))
    return jpg, chunks


def as_bits(t):
    return t.numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("root_chunk,budget", [(1024, 1 << 25), (8, 1 << 25),
                                               (4096, 1 << 14)])
def test_plan_tier_chunks_equal(root_chunk, budget):
    rng = np.random.default_rng(root_chunk)
    deg = np.concatenate([rng.integers(0, 40, 900), rng.integers(0, 700, 60)])
    roots = np.nonzero(deg >= 4)[0].astype(np.int32)
    got = list(kc.plan_tier_chunks(deg, roots, np.int32(999),
                                   root_chunk=root_chunk,
                                   mem_budget_words=budget))
    want = list(jkc.plan_tier_chunks(deg, roots, np.int32(999),
                                      root_chunk=root_chunk,
                                      mem_budget_words=budget))
    assert len(got) == len(want) > 1
    for (c, ww), (jc, jww) in zip(got, want):
        assert ww == jww and c.dtype == jc.dtype
        np.testing.assert_array_equal(c, jc)


def test_plan_chunks_equal_gms_tpu_plan():
    g, jg = rmat(10)
    rank, _ = jdg.degeneracy_ordering_rank(jg)
    pg, chunks = kc.plan_chunks(g, 5, device="cpu", rank=rank)
    jpg, jchunks = jax_plan(jg, 5)
    np.testing.assert_array_equal(pg.nbr.numpy(), np.asarray(jpg.nbr))
    assert [ww for _, ww in chunks] == [ww for _, ww in jchunks]
    for (c, _), (jc, _) in zip(chunks, jchunks):
        np.testing.assert_array_equal(c.numpy(), jc)


# ---------------------------------------------------------------------------
# K4 build_local_adj
# ---------------------------------------------------------------------------

def _check_local_adj(jpg, roots, ww):
    want_adj, want_s0 = jkc.build_local_adj(jpg.nbr, jnp.asarray(roots),
                                            w_words=ww)
    pg = padded_from_numpy(np.asarray(jpg.nbr), device="cpu")
    r = tensor_from_numpy(roots, device="cpu")
    before = dict(kc.LAUNCHES)
    adj, s0 = kc.build_local_adj(pg.nbr, r, w_words=ww)
    assert kc.LAUNCHES == before  # CPU tensors: the plain version, no launch
    assert adj.dtype == torch.int32 and adj.shape == (len(roots), 32 * ww, ww)
    np.testing.assert_array_equal(as_bits(adj), np.asarray(want_adj))
    np.testing.assert_array_equal(as_bits(s0), np.asarray(want_s0))
    return adj


@pytest.mark.parametrize("ww", [1, 2, 4])
def test_build_local_adj_equals_gms_tpu(ww):
    # D_pad is 64 here: ww=1 is W < D (wider roots are cut to W slots, as
    # in gms_tpu), ww=4 is W > D (the root row is SENTINEL-padded)
    _, jg = rmat(10)
    jpg, chunks = jax_plan(jg, 4)
    assert jpg.d_pad == 64
    chunk = chunks[-1][0]
    rng = np.random.default_rng(ww)
    roots = np.concatenate([
        chunk[:40], rng.integers(0, jg.num_nodes, 40),
        [jpg.v_pad, jpg.v_pad + 7, -3]]).astype(np.int32)  # pad ids clip
    adj = _check_local_adj(jpg, roots, ww)
    assert adj.any() and not adj[-3:-1].any()


def test_build_local_adj_plain_needs_no_sorted_rows():
    # gms_tpu's compare branch does not care about the order within a row;
    # nor does the plain version (the CUDA kernel does, see its docstring)
    _, jg = rmat(9)
    jpg, chunks = jax_plan(jg, 4)
    rng = np.random.default_rng(9)
    nbr = np.asarray(jpg.nbr).copy()
    for row in nbr:
        rng.shuffle(row)
    roots = np.concatenate([chunks[-1][0][:60], [jpg.v_pad]]).astype(np.int32)
    want_adj, want_s0 = jkc.build_local_adj(jnp.asarray(nbr),
                                            jnp.asarray(roots), w_words=2)
    adj, s0 = kc.build_local_adj_plain(torch.from_numpy(nbr),
                                       torch.from_numpy(roots), w_words=2)
    np.testing.assert_array_equal(as_bits(adj), np.asarray(want_adj))
    np.testing.assert_array_equal(as_bits(s0), np.asarray(want_s0))
    assert adj.any()


def test_build_local_adj_searchsorted_branch():
    # gms_tpu switches to its searchsorted scan when W*D > 2^18 and
    # C*W*D > 2^27 (k_clique.py:113). Its cheapest such shape keeps W small
    # and D just past 2^18/W: W=128, D=2080 (one hub of out-degree 2080
    # ranked first, so no root gathers its row), C=512.
    hub = np.stack([np.zeros(2080, np.int64), np.arange(1, 2081)], 1)
    el = np.concatenate([hub, random_graph(300, 0.2, 1) + 1])
    _, jg = both(el, 2081)
    rank = np.argsort(np.argsort(-jg.degrees, kind="stable")).astype(np.int32)
    dag = jorient.orient(jg, rank)
    jpg = JPaddedGraph.from_csr(dag, lane=32)
    assert jpg.d_pad == 2080
    ww, C = 4, 512
    assert 32 * ww * jpg.d_pad > 1 << 18 and C * 32 * ww * jpg.d_pad > 1 << 27
    roots = np.arange(1, C + 1, dtype=np.int32)
    roots[-1] = jpg.v_pad
    assert _check_local_adj(jpg, roots, ww).any()


# ---------------------------------------------------------------------------
# K5 kclique_dense_chunk, K6 kc_fused_chunk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [3, 4, 5])
def test_kclique_dense_chunk_equals_gms_tpu(k):
    _, jg = rmat(10)
    jpg, chunks = jax_plan(jg, k)
    pg = padded_from_numpy(np.asarray(jpg.nbr), device="cpu")
    total = 0
    for chunk, ww in chunks:
        W = 32 * ww
        group = int(np.gcd(max(1, (1 << 24) // W ** 3), len(chunk)))
        want = int(jkc.kclique_dense_chunk(jpg.nbr, jnp.asarray(chunk),
                                           w_words=ww, k=k, group=group,
                                           i_block=W))
        got = kc.kclique_dense_chunk(pg.nbr, tensor_from_numpy(
            chunk, device="cpu"), w_words=ww, k=k)
        assert got.dtype == torch.int64 and int(got) == want
        total += want
    assert total == jkc.kclique_count(jg, k)


def _jax_fused(jpg, chunk, ww, k):
    """gms_tpu's kc_fused_chunk with kclique_count's plan for the tier;
    its total, once the stack ran out without overflow."""
    W = 32 * ww
    if W <= 128:
        b = pc = max(W, min(32768, (1 << 24) // (W * W)))
    else:
        b = 8192
        pc = max(W, min(2 * b, (1 << 25) // (W * ww)))
    cap = max(len(chunk), (1 << 23) // (ww + 1))
    dummy = (jnp.zeros((1, 1), jnp.uint32), jnp.int32(0), jnp.int64(0))
    sc, _ = jkc.kc_fused_chunk(jpg.nbr, jnp.asarray(chunk), dummy, w_words=ww,
                               k=k, cap=cap, batch=b, push_cap=pc,
                               iter_budget=1 << 30, resume=False)
    total, ovf, done = (int(x) for x in np.asarray(sc)[:3])
    assert done and not ovf
    return total


@pytest.mark.parametrize("k", [6, 7, 8])
def test_kc_fused_chunk_equals_gms_tpu(k):
    _, jg = rmat(8)
    jpg, chunks = jax_plan(jg, k)
    pg = padded_from_numpy(np.asarray(jpg.nbr), device="cpu")
    # each tier of the plan, and the first chunk again at W = 256, which
    # takes gms_tpu's rem==3 branch (W > 128) instead of its rem==4 one
    runs = chunks + [(chunks[0][0], 8)]
    total = 0
    for i, (chunk, ww) in enumerate(runs):
        want = _jax_fused(jpg, chunk, ww, k)
        got = kc.kc_fused_chunk(pg.nbr, tensor_from_numpy(chunk, device="cpu"),
                                w_words=ww, k=k)
        assert got.dtype == torch.int64 and int(got) == want, (ww, k)
        total += want if i < len(chunks) else 0
    assert total == jkc.kclique_count(jg, k)


def test_kc_stack_count_refuses_small_k():
    adj = torch.zeros((2, 32, 1), dtype=torch.int32)
    s0 = torch.zeros((2, 1), dtype=torch.int32)
    for k in (3, 4):
        with pytest.raises(ValueError, match="k must be >= 5"):
            kc.kc_stack_count(adj, s0, k=k)
    with pytest.raises(ValueError, match="k must be 3, 4 or 5"):
        kc.kclique_dense_count(adj, k=6)


def test_kc_stack_count_equals_dense_count_at_k5():
    g, _ = rmat(9)
    pg, chunks = kc.plan_chunks(g, 5, device="cpu")
    for chunk, ww in chunks:
        adj, s0 = kc.build_local_adj(pg.nbr, chunk, w_words=ww)
        stats = {}
        want = int(kc.kclique_dense_count(adj, k=5))
        assert int(kc.kc_stack_count_plain(adj, s0, k=5, stats=stats)) == want
        assert stats["word_ops"] > 0


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

def test_fixtures(fixture_edge_lists, fixture_graphs):
    for name, el in fixture_edge_lists.items():
        g = build_csr(el)
        for k in (3, 4, 5, 6):
            want = jkc.kclique_count(fixture_graphs[name], k)
            assert kc.kclique_count(g, k, device="cpu") == want, (name, k)
            assert kc.kclique_count_oracle(g, k) == want, (name, k)


@pytest.mark.parametrize("k", range(1, 9))
def test_complete_graph(k):
    g = build_csr(complete_graph_el(7))
    assert kc.kclique_count(g, k, device="cpu") == comb(7, k)
    assert kc.kclique_count_oracle(g, k) == comb(7, k)


@pytest.mark.parametrize("seed", [0, 1])
def test_random_graphs(seed):
    g, jg = both(random_graph(60, 0.25, seed), 60)
    for k in (3, 4, 5, 6, 7):
        want = jkc.kclique_count_oracle(jg, k)
        assert kc.kclique_count(g, k, device="cpu") == want, k
        assert kc.kclique_count_oracle(g, k) == want, k


@pytest.mark.parametrize("scale,deg,seed", [(8, 6, 5), (8, 16, SEED),
                                            (9, 16, SEED)])
def test_rmat(scale, deg, seed):
    g, jg = rmat(scale, deg, seed)
    for k in (3, 5, 6, 8):
        want = jkc.kclique_count(jg, k)
        assert kc.kclique_count(g, k, device="cpu") == want, k
        assert kc.kclique_count_oracle(g, k) == want, k


def test_small_root_chunk_and_rank():
    g, jg = both(random_graph(50, 0.3, 3), 50)
    for k in (4, 6):
        want = jkc.kclique_count_oracle(jg, k)
        assert kc.kclique_count(g, k, device="cpu", root_chunk=8) == want
    # the count does not depend on the ordering
    rank = np.random.default_rng(0).permutation(50).astype(np.int32)
    assert kc.kclique_count(g, 5, device="cpu", rank=rank) == \
        jkc.kclique_count(jg, 5, rank=rank)


def test_empty_and_small():
    g = build_csr(np.zeros((0, 2), dtype=np.int64), num_nodes=5)
    assert kc.kclique_count(g, 3, device="cpu") == 0
    assert kc.kclique_count(g, 1, device="cpu") == 5
    g = build_csr(complete_graph_el(4))
    assert kc.kclique_count(g, 5, device="cpu") == 0
    assert kc.kclique_count(g, 7, device="cpu") == 0
    with pytest.raises(ValueError):
        kc.kclique_count(g, 0, device="cpu")


def test_bench_cli_prints_verified_rows():
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-m", "gms_tpu_torch.bench.k_clique", "-g",
         "kronecker", "8", "-n", "1", "-v", "--device", "cpu", "-p",
         "clique-size=5"], cwd=root, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=str(root)))
    assert out.returncode == 0, out.stderr
    rows = [ln.split() for ln in out.stdout.splitlines()
            if ln.startswith("@@@")]
    assert [r[-1] for r in rows] == [
        "kclique-k5-degeneracy-cpu", "kclique-k5-adg-eps0.1-cpu",
        "kclique-k5-adg-eps0.01-cpu"]
    assert all(r[2] == "verified" for r in rows)
    counts = {ln.split()[2] for ln in out.stdout.splitlines()
              if ln.startswith("@@# kclique5_count")}
    assert counts == {"83683"}  # RMAT-8 deg 16, seed 27491095


def test_bit_words_round_trip():
    rng = np.random.default_rng(1)
    words = rng.integers(0, 1 << 32, size=(5, 3), dtype=np.uint64)
    words = words.astype(np.uint32)
    t = tensor_from_numpy(words, device="cpu")
    assert t.dtype == torch.int32
    bits = kc.unpack_bits(t)
    want = np.unpackbits(words.view(np.uint8).reshape(5, 3, 4),
                         axis=-1, bitorder="little").reshape(5, 96)
    np.testing.assert_array_equal(bits.numpy(), want.astype(bool))
    assert torch.equal(kc.pack_bits(bits), t)


def test_padded_from_numpy_keeps_layout():
    g, jg = rmat(8)
    rank, _ = jdg.degeneracy_ordering_rank(jg)
    jpg = JPaddedGraph.from_csr(jorient.orient(jg, rank), lane=32)
    pg = padded_from_numpy(np.asarray(jpg.nbr), device="cpu",
                           num_nodes=jg.num_nodes)
    np.testing.assert_array_equal(pg.nbr.numpy(), np.asarray(jpg.nbr))
    np.testing.assert_array_equal(pg.deg.numpy(), np.asarray(jpg.deg))
    assert pg.num_edges == int((np.asarray(jpg.nbr) != SENTINEL).sum())
