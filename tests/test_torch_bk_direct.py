"""The direct=True Bron–Kerbosch variant of the port against gms_tpu and the
oracle.

* init_items (K35 on CPU tensors) against gms_tpu's, word for word, and the
  degree-tiered root chunks (k_clique.plan_tier_chunks) against gms_tpu's
  _plan_root_chunks;
* bk_count_chunk_plain's per-chunk totals against gms_tpu's bk_count_chunk
  (with bk_count_async's capacity plan) on RMAT-8, chunk by chunk;
* bron_kerbosch(direct=True), plain and with hub_threshold=6, against
  gms_tpu's and bron_kerbosch_simple: test_direct_variant_matches_oracle
  and test_hub_and_direct_split_agree of tests/test_bron_kerbosch.py;
* bk_count_async's retry, which only a path shorter than the core bound
  enters, and its round-robin over two CPU "devices".

Every comparison is exact. Arrays that depend on the order are compared
under one rank, gms_tpu's. The CUDA kernels are held against these plain
versions on the card by chip_smoke.py (phase 52) and by the `cuda`-marked
tests of test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gms_tpu.algorithms import bron_kerbosch as jbk
from gms_tpu.graphs.tiles import PaddedGraph as JPaddedGraph
from gms_tpu.io.builder import build_csr as jbuild_csr
from gms_tpu.preprocessing import degeneracy as jdg

from gms_tpu_torch.algorithms import bron_kerbosch as bk
from gms_tpu_torch.algorithms.k_clique import plan_tier_chunks
from gms_tpu_torch.convert import tensor_from_numpy
from gms_tpu_torch.graphs.tiles import PaddedGraph
from gms_tpu_torch.io.builder import build_csr
from gms_tpu_torch.io.generators import generate_rmat_el

from conftest import random_graph

torch.set_num_threads(1)

SEED = 27491095
INT32_MAX = np.iinfo(np.int32).max


def both(el, n):
    return build_csr(el, num_nodes=n), jbuild_csr(el, num_nodes=n)


def t(a):
    return tensor_from_numpy(a, device="cpu")


class Direct:
    """gms_tpu's inputs of the direct path under its degeneracy rank: the
    undirected graph padded at lane 32, rank_pad, core_bound and the root
    chunks of _plan_root_chunks."""

    def __init__(self, jg, root_chunk=64):
        rank, _ = jdg.degeneracy_ordering_rank(jg)
        self.rank = np.asarray(rank)
        self.jpg = JPaddedGraph.from_csr(jg, lane=32)
        n = jg.num_nodes
        self.rank_pad = np.full(self.jpg.v_pad + 1, INT32_MAX, np.int32)
        self.rank_pad[:n] = self.rank
        e = jg.edge_array()
        higher = self.rank[e[:, 1]] > self.rank[e[:, 0]]
        self.core_bound = int(np.bincount(e[:, 0][higher], minlength=n)
                              .max(initial=1))
        self.chunks = list(jbk._plan_root_chunks(
            np.asarray(jg.degrees), np.arange(n, dtype=np.int32), root_chunk,
            np.int32(self.jpg.v_pad)))
        self.totals = [self.count_chunk(c, ww) for c, ww in self.chunks]

    def count_chunk(self, chunk, ww):
        """gms_tpu's bk_count_chunk with bk_count_async's plan."""
        W = 32 * ww
        fan = min(W, self.core_bound)
        depth = fan + 2
        items_max = max((1 << 22) // ww, len(chunk) + depth * fan)
        batch = max(1, min(64, (items_max - len(chunk)) // (depth * fan)))
        cap = min(len(chunk) + depth * batch * fan, items_max)
        ch = jnp.asarray(chunk)
        total, ovf = jbk.bk_count_chunk(
            self.jpg.nbr, jnp.asarray(self.rank_pad), ch,
            ch != jnp.int32(self.jpg.v_pad), w_words=ww, cap=cap, batch=batch)
        return int(total), bool(ovf)


@pytest.fixture(scope="module")
def rmat8():
    g, jg = both(generate_rmat_el(8, 16, seed=SEED), 256)
    return g, jg, Direct(jg)


def port_nbr(g):
    return PaddedGraph.from_csr(g, device="cpu", lane=32).nbr


def test_plan_root_chunks_equal(rmat8):
    g, _, jd = rmat8
    pad = np.int32(jd.jpg.v_pad)
    got = list(plan_tier_chunks(g.degrees, np.arange(256, dtype=np.int32),
                                pad, root_chunk=64))
    assert len(got) == len(jd.chunks) > 1
    for (c, ww), (jc, jww) in zip(got, jd.chunks):
        assert ww == jww and np.array_equal(c, jc)
    assert port_nbr(g).numpy().tolist() == np.asarray(jd.jpg.nbr).tolist()


@pytest.mark.parametrize("wider", [False, True])
def test_init_items_equal_gms_tpu(rmat8, wider):
    g, _, jd = rmat8
    nbr = port_nbr(g)
    for chunk, ww in jd.chunks:
        ww = 2 * ww if wider else ww
        chunk = chunk.copy()
        chunk[-2:] = (jd.jpg.v_pad + 3, -1)  # ids past the guard row clip
        jc, jf = jbk.init_items(jd.jpg.nbr, jnp.asarray(jd.rank_pad),
                                jnp.asarray(chunk), w_words=ww)
        c, f = bk.init_items(nbr, t(jd.rank_pad), t(chunk), w_words=ww)
        assert np.array_equal(c.numpy().view(np.uint32), np.asarray(jc))
        assert np.array_equal(f.numpy().view(np.uint32), np.asarray(jf))


def test_bk_count_chunk_totals_equal_gms_tpu(rmat8):
    g, jg, jd = rmat8
    nbr, rank_pad = port_nbr(g), t(jd.rank_pad)
    totals = []
    for chunk, ww in jd.chunks:
        ch = t(chunk)
        live = ch != nbr.shape[0]
        depth = min(32 * ww, jd.core_bound) + 2
        got, ovf = bk.bk_count_chunk_plain(nbr, rank_pad, ch, live,
                                           w_words=ww, depth=depth)
        want, jovf = jd.totals[len(totals)]
        assert (int(got), bool(ovf)) == (want, jovf) == (want, False)
        # the wrapper takes the plain version on CPU tensors
        assert int(bk.bk_count_chunk(nbr, rank_pad, ch, live, w_words=ww,
                                     depth=depth)[0]) == want
        totals.append(want)
    assert sum(totals) == jbk.bron_kerbosch(jg, rank=jd.rank)


def test_direct_stack_counts_ops_and_overflow(rmat8):
    g, _, jd = rmat8
    nbr, rank_pad = port_nbr(g), t(jd.rank_pad)
    univs = []
    for chunk, ww in jd.chunks:
        ch = t(chunk)
        adj, _ = bk.build_local_adj(nbr, ch, w_words=ww)
        univs.append((adj, *bk.init_items(nbr, rank_pad, ch, w_words=ww),
                      ch != nbr.shape[0]))
    # the chunk with the most maximal cliques
    adj, cand, fini, live = max(univs, key=lambda u: int(
        bk.bk_direct_stack(*u)[0]))
    stats = {}
    n, ovf = bk.bk_direct_stack(adj, cand, fini, live)
    assert int(n) > 0 and not ovf
    assert int(bk.bk_direct_stack_plain(adj, cand, fini, live,
                                        stats=stats)[0]) == int(n)
    with pytest.raises(ValueError, match="kernel's counters"):
        bk.bk_direct_stack(adj, cand, fini, live, stats={})
    assert stats["popc_ops"] > 0 and stats["bit_ops"] > stats["popc_ops"]
    n2, ovf2 = bk.bk_direct_stack(adj, cand, fini, live, depth=2)
    assert int(n2) == int(n) and bool(ovf2)


@pytest.mark.parametrize("n,p,seed", [(80, 0.2, 7), (150, 0.1, 8)])
def test_direct_variant_matches_oracle(n, p, seed):
    g, jg = both(random_graph(n, p, seed=seed), n)
    want = len(jbk.bron_kerbosch_simple(jg))
    assert bk.bron_kerbosch(g, device="cpu", direct=True) == want
    assert bk.bron_kerbosch(g, device="cpu", direct=True,
                            hub_threshold=6) == want
    assert jbk.bron_kerbosch(jg, direct=True, hub_threshold=6) == want


def test_hub_and_direct_split_agree():
    # some roots through each path (threshold between min and max degree)
    g, jg = both(random_graph(150, 0.15, seed=6), 150)
    want = len(jbk.bron_kerbosch_simple(jg))
    thr = int(np.median(g.degrees))
    assert jbk.bron_kerbosch(jg, hub_threshold=thr) == want
    for direct in (False, True):
        assert bk.bron_kerbosch(g, device="cpu", hub_threshold=thr,
                                direct=direct) == want


def test_bk_count_async_retry_and_devices(rmat8, monkeypatch):
    g, _, jd = rmat8
    nbr, rank_pad = port_nbr(g), t(jd.rank_pad)
    want = sum(n for n, _ in jd.totals)
    assert bk.bk_count_async(nbr, rank_pad, jd.chunks,
                             core_bound=jd.core_bound) == want
    # a bound below the graph's, jobs round-robin over two "devices":
    # overflowed chunks split, single roots deepen, and the count stays
    # exact
    calls = []
    count_chunk = bk.bk_count_chunk
    monkeypatch.setattr(bk, "bk_count_chunk", lambda *a, **kw: (
        calls.append(kw["depth"]), count_chunk(*a, **kw))[1])
    assert bk.bk_count_async(nbr, rank_pad, jd.chunks, ["cpu", "cpu"],
                             core_bound=jd.core_bound // 3) == want
    assert len(calls) > len(jd.chunks) and max(calls) > min(calls)
