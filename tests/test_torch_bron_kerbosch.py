"""Bron–Kerbosch in the PyTorch port against gms_tpu and the oracles.

* host planning (_lower_neighbor_csr, _indeg_sub_chunks, the jobs and their
  cover widths) against gms_tpu's arrays;
* each kernel's plain PyTorch version (what the wrapper runs on CPU
  tensors) against its gms_tpu jax program on the same inputs, carried
  across by convert.py: hub_cover_bits (gms_tpu's _gather_wlists +
  _hub_cover_bits), symmetrize_bits, bk_stack_machine (count, and the
  emitted rows as sorted sets) and decode_clique_members;
* bron_kerbosch(device="cpu") against gms_tpu's bron_kerbosch and
  bron_kerbosch_simple, as counts and as sets of cliques, mirroring
  tests/test_bron_kerbosch.py case for case, except test_direct_variant_
  matches_oracle and test_hub_and_direct_split_agree, whose port
  counterparts are in test_torch_bk_direct.py, and the two cases whose
  subjects have no counterpart in the port: test_resume_segments_equal_
  counts (the depth-first kernel has no iter_budget segments) and
  test_band_compact_both_paths (no band-sort compaction). The hub_threshold
  of test_hub_path_matches_oracle selects the direct variant's roots, which
  its direct=False calls do not take; its three graphs run on the fused
  path.

Every comparison is exact. Arrays that depend on the order are compared
under one rank, gms_tpu's. The CUDA kernels are held against these plain
versions on the card by chip_smoke.py and by the `cuda`-marked tests of
test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gms_tpu.algorithms import bron_kerbosch as jbk
from gms_tpu.algorithms import k_clique as jkc
from gms_tpu.graphs.tiles import PaddedGraph as JPaddedGraph
from gms_tpu.io.builder import build_csr as jbuild_csr
from gms_tpu.preprocessing import degeneracy as jdg
from gms_tpu.preprocessing import orient as jorient

from gms_tpu_torch.algorithms import bron_kerbosch as bk
from gms_tpu_torch.convert import padded_from_numpy, tensor_from_numpy
from gms_tpu_torch.io.builder import build_csr
from gms_tpu_torch.io.generators import generate_rmat_el

from conftest import random_graph

torch.set_num_threads(1)

SEED = 27491095
ORDERINGS = ["degeneracy", "adg", "degree", "id"]


def both(el, n):
    return build_csr(el, num_nodes=n), jbuild_csr(el, num_nodes=n)


def rmat(scale, deg=16, seed=SEED):
    return both(generate_rmat_el(scale, deg, seed=seed), 1 << scale)


def complete_graph_el(n):
    src, dst = np.nonzero(np.triu(np.ones((n, n), dtype=bool), 1))
    return np.stack([src, dst], axis=1).astype(np.int64)


def t(a):
    return tensor_from_numpy(a, device="cpu")


def bits(x):
    return x.numpy().view(np.uint32)


def row_set(rows):
    return sorted(map(tuple, np.asarray(rows).view(np.uint32).tolist()))


class JaxPlan:
    """gms_tpu's planning of _bk_fused under `rank`: its padded DAG, lower
    CSR and [(chunk, WW, IN)] jobs."""

    def __init__(self, jg, rank, roots=None, root_chunk=bk.DEFAULT_ROOT_CHUNK):
        self.rank = rank
        dag = jorient.orient(jg, rank)
        self.jpg = JPaddedGraph.from_csr(dag, lane=32)
        self.lo_indptr, self.lo_cols = jbk._lower_neighbor_csr(jg, rank)
        indeg = (self.lo_indptr[1:] - self.lo_indptr[:-1]).astype(np.int32)
        pad_id = np.int32(self.jpg.v_pad)
        if roots is None:
            roots = np.arange(jg.num_nodes, dtype=np.int32)
        self.jobs = []
        for tchunk, ww in jbk._plan_root_chunks(np.asarray(dag.degrees), roots,
                                                root_chunk, pad_id):
            for chunk in jbk._indeg_sub_chunks(tchunk, ww, indeg, pad_id):
                real = chunk[chunk != pad_id]
                mx = int(indeg[real].max(initial=1)) if len(real) else 1
                IN = max(32, 1 << int(np.ceil(np.log2(max(mx, 1)))))
                self.jobs.append((chunk, ww, IN))

    def cover(self, chunk, ww, IN):
        C, W = len(chunk), 32 * ww
        IB = max(1, min(IN, (1 << 27) // max(C * W * self.jpg.d_pad, 1)))
        IB = 1 << int(np.log2(IB))
        ch = jnp.asarray(chunk)
        wl = jbk._gather_wlists(jnp.asarray(self.lo_indptr),
                                jnp.asarray(self.lo_cols), ch, in_width=IN)
        return jbk._hub_cover_bits(self.jpg.nbr, ch, wl, w_words=ww,
                                   i_block=IB)

    def universe(self, chunk, ww, IN):
        """gms_tpu's (adj, S0, live0, M, wvalid) of a job."""
        ch = jnp.asarray(chunk)
        adj, s0 = jkc.build_local_adj(self.jpg.nbr, ch, w_words=ww)
        adj = jbk._symmetrize_bits(adj, w_words=ww)
        M, wvalid = self.cover(chunk, ww, IN)
        return adj, s0, ch != jnp.int32(self.jpg.v_pad), M, wvalid

    def stack_machine(self, univ, ww, IN):
        """gms_tpu's bk_stack_machine in emit mode with _bk_fused's plan:
        (count, OUT[:op])."""
        C, W = univ[0].shape[0], 32 * ww
        batch = 4096 if W >= 128 else 1024
        push_cap = max(W, 2 * batch)
        dummy = (jnp.zeros((1, 1), jnp.uint32), jnp.int32(0),
                 jnp.zeros((1, 1), jnp.uint32), jnp.int32(0), jnp.int64(0))
        sc, state = jbk.bk_stack_machine(
            *univ, dummy, w_words=ww, cap=max(C, (1 << 23) // (3 * ww + 1)),
            batch=batch, push_cap=push_cap,
            leaf_cap=max(push_cap, (1 << 22) // (ww + 1)), in_block=IN,
            out_cap=1 << 17, iter_budget=1 << 30, resume=False)
        total, ovf, done = (int(x) for x in np.asarray(sc)[:3])
        assert done and not ovf
        return total, np.asarray(state[2])[:int(state[3])]


def port_plan(g, jp):
    return bk.BKPlan(g, jp.rank, np.arange(g.num_nodes, dtype=np.int32),
                     device="cpu")


@pytest.fixture(scope="module")
def rmat9():
    g, jg = rmat(9)
    rank, _ = jdg.degeneracy_ordering_rank(jg)
    return g, jg, JaxPlan(jg, np.asarray(rank))


# ---------------------------------------------------------------------------
# host planning
# ---------------------------------------------------------------------------

def test_lower_neighbor_csr_equal(fixture_edge_lists, fixture_graphs, rmat9):
    g, jg, jp = rmat9
    cases = [(g, jg, jp.rank)]
    for name, el in fixture_edge_lists.items():
        jfg = fixture_graphs[name]
        cases.append((build_csr(el), jfg,
                      np.asarray(jdg.degeneracy_ordering_rank(jfg)[0])))
    cases.append((*both(np.zeros((0, 2), np.int64), 4),
                  np.arange(4, dtype=np.int32)))
    for pg, pjg, rank in cases:
        for got, want in zip(bk._lower_neighbor_csr(pg, rank),
                             jbk._lower_neighbor_csr(pjg, rank)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ww,budget", [(1, 1 << 24), (4, 1 << 24),
                                       (2, 1 << 14)])
def test_indeg_sub_chunks_equal(ww, budget):
    rng = np.random.default_rng(ww)
    indeg = np.concatenate([rng.integers(0, 40, 3000),
                            rng.integers(0, 5000, 40)]).astype(np.int32)
    pad = np.int32(4000)
    chunk = np.concatenate([rng.permutation(3040)[:2500],
                            np.full(596, pad)]).astype(np.int32)
    got = list(bk._indeg_sub_chunks(chunk, ww, indeg, pad, budget))
    want = list(jbk._indeg_sub_chunks(chunk, ww, indeg, pad, budget))
    assert len(got) == len(want) > 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_plan_equals_gms_tpu(rmat9):
    g, jg, jp = rmat9
    plan = port_plan(g, jp)
    np.testing.assert_array_equal(plan.padded.nbr.numpy(),
                                  np.asarray(jp.jpg.nbr))
    np.testing.assert_array_equal(plan.lo_cols.numpy(), jp.lo_cols)
    assert [(ww, IN) for _, ww, IN in plan.jobs] == \
        [(ww, IN) for _, ww, IN in jp.jobs]
    for (c, _, _), (jc, _, _) in zip(plan.jobs, jp.jobs):
        np.testing.assert_array_equal(c.numpy(), jc)
    assert max(IN for _, _, IN in plan.jobs) > 32


# ---------------------------------------------------------------------------
# K8 hub_cover_bits, K7 symmetrize_bits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ww", [1, 4])
def test_hub_cover_bits_equals_gms_tpu(rmat9, ww):
    g, jg, jp = rmat9
    pg = padded_from_numpy(np.asarray(jp.jpg.nbr), device="cpu")
    # the widest job's roots (IN > 32), a few others, and pad ids
    chunk, _, IN = max(jp.jobs, key=lambda j: j[2])
    rng = np.random.default_rng(ww)
    roots = np.concatenate([chunk[:20], rng.integers(0, g.num_nodes, 40),
                            [jp.jpg.v_pad, jp.jpg.v_pad + 3]]).astype(np.int32)
    assert IN > 32
    want_m, want_v = jp.cover(roots, ww, IN)
    before = dict(bk.LAUNCHES)
    m, v = bk.hub_cover_bits(pg.nbr, t(jp.lo_indptr), t(jp.lo_cols), t(roots),
                             in_width=IN, w_words=ww)
    assert bk.LAUNCHES == before  # CPU tensors: the plain version
    assert m.dtype == torch.int32 and m.shape == (len(roots), IN, ww)
    np.testing.assert_array_equal(bits(m), np.asarray(want_m))
    np.testing.assert_array_equal(v.numpy(), np.asarray(want_v))
    assert m.any() and v[:20].any() and not v[-2:].any()


@pytest.mark.parametrize("ww", [1, 2, 8])
def test_symmetrize_bits_equals_gms_tpu(ww):
    rng = np.random.default_rng(ww)
    C, W = 5, 32 * ww
    dense = np.triu(rng.random((C, W, W)) < 0.2, 1)
    words = np.packbits(dense.reshape(-1, 8), bitorder="little")
    adj = words.view(np.uint32).reshape(C, W, ww)
    want = np.asarray(jbk._symmetrize_bits(jnp.asarray(adj), w_words=ww))
    got = bk.symmetrize_bits(t(adj))
    np.testing.assert_array_equal(bits(got), want)
    assert (want != adj).any()


# ---------------------------------------------------------------------------
# K9 bk_stack_machine, K10 decode_clique_members
# ---------------------------------------------------------------------------

def test_bk_stack_machine_and_decode_equal_gms_tpu(rmat9):
    g, jg, jp = rmat9
    pg = padded_from_numpy(np.asarray(jp.jpg.nbr), device="cpu")
    # the widest cover's job, again at twice its width, and the narrowest
    wide = max(jp.jobs, key=lambda j: j[2])
    narrow = min(jp.jobs, key=lambda j: j[2])
    assert wide[2] > narrow[2] == 32
    total = 0
    for chunk, ww, IN in (wide, (wide[0], 2 * wide[1], wide[2]), narrow):
        univ = jp.universe(chunk, ww, IN)
        want, want_out = jp.stack_machine(univ, ww, IN)
        adj, s0, live0, M, wvalid = (t(np.asarray(a)) for a in univ)
        got = bk.bk_stack_machine(adj, s0, live0, M, wvalid)
        assert got.dtype == torch.int64 and int(got) == want
        n, out = bk.bk_stack_machine(adj, s0, live0, M, wvalid, emit=True)
        assert int(n) == want and out.shape == (want, ww + 1)
        assert row_set(out.numpy()) == row_set(want_out)
        gid, mem = bk.decode_clique_members(pg.nbr, t(chunk), out)
        jgid, jmem = jbk.decode_clique_members(
            jp.jpg.nbr, jnp.asarray(chunk), jnp.asarray(out.numpy()))
        np.testing.assert_array_equal(gid.numpy(), np.asarray(jgid))
        np.testing.assert_array_equal(mem.numpy(), np.asarray(jmem))
        total += want
    assert total > 0


def test_bk_stack_machine_counts_ops():
    g, jg = rmat(8)
    rank = np.asarray(jdg.degeneracy_ordering_rank(jg)[0])
    plan = port_plan(g, JaxPlan(jg, rank))
    stats = {}
    for chunk, ww, IN in plan.jobs:
        adj, s0 = bk.build_local_adj(plan.padded.nbr, chunk, w_words=ww)
        adj = bk.symmetrize_bits(adj)
        M, wv = bk.hub_cover_bits(plan.padded.nbr, plan.lo_indptr,
                                  plan.lo_cols, chunk, in_width=IN,
                                  w_words=ww)
        live0 = chunk != plan.padded.v_pad
        n = bk.bk_stack_machine_plain(adj, s0, live0, M, wv, stats=stats)
        assert int(n) == int(bk.bk_stack_machine(adj, s0, live0, M, wv))
    assert stats["bit_ops"] > stats["popc_ops"] > 0


def test_walk_stats_reads_the_fourth_line():
    # K9's and K36's control words: aux, items, most items, warps, then the
    # cycles by part (csrc/bk_walk.cuh's Ctl)
    ctl = torch.zeros(64, dtype=torch.int64)
    ctl[48:52 + 3 + len(bk.WALK_PARTS)] = torch.arange(1, 13)
    stats = {}
    bk._walk_stats(ctl, stats)
    assert stats == {"items": 2, "max_items": 3, "warps": 4,
                     "cycles": dict(zip(bk.WALK_PARTS, range(5, 10))),
                     "steps": 10, "nodes": 11, "deep_steps": 12}


def test_stats_on_the_cpu_are_the_plain_counts():
    g, jg = rmat(8)
    rank = np.asarray(jdg.degeneracy_ordering_rank(jg)[0])
    plan = port_plan(g, JaxPlan(jg, rank))
    chunk, ww, IN = plan.jobs[-1]
    adj, s0 = bk.build_local_adj(plan.padded.nbr, chunk, w_words=ww)
    univ = (bk.symmetrize_bits(adj), s0, chunk != plan.padded.v_pad,
            *bk.hub_cover_bits(plan.padded.nbr, plan.lo_indptr, plan.lo_cols,
                               chunk, in_width=IN, w_words=ww))
    # the wrapper's stats= are the kernel's counters: on the CPU it raises,
    # and the plain version counts the tree
    got = {}
    with pytest.raises(ValueError, match="kernel's counters"):
        bk.bk_stack_machine(*univ, stats={})
    assert int(bk.bk_stack_machine(*univ)) == int(
        bk.bk_stack_machine_plain(*univ, stats=got))
    assert set(got) == {"popc_ops", "bit_ops", "popc_need", "child_ops",
                        "cover_ops"}
    # the function's own need is at most the plain tree's count
    assert 0 < got["popc_need"] <= got["popc_ops"]
    assert 0 <= got["cover_ops"] < got["bit_ops"]
    assert 0 < got["child_ops"] < got["bit_ops"]


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_k9_bound_counts_only_what_it_reads():
    # K9's bytes (chip_smoke.py's bk_stack_bytes) count the live roots'
    # rows only: a dead root adds its live0 byte, invalid cover rows past a
    # root's in-degree add only the wvalid bytes that mark them so
    g, jg = rmat(8)
    rank = np.asarray(jdg.degeneracy_ordering_rank(jg)[0])
    plan = port_plan(g, JaxPlan(jg, rank))
    chunk, ww, IN = plan.jobs[-1]
    adj, s0 = bk.build_local_adj(plan.padded.nbr, chunk, w_words=ww)
    univ = (bk.symmetrize_bits(adj), s0, chunk != plan.padded.v_pad,
            *bk.hub_cover_bits(plan.padded.nbr, plan.lo_indptr, plan.lo_cols,
                               chunk, in_width=IN, w_words=ww))
    nbytes = _chip_smoke().bk_stack_bytes
    n = nbytes(*univ)
    assert 0 < n < sum(t.numel() * t.element_size() for t in univ) + 8
    adj, s0, live, m, v = univ
    live_n = int(live.sum())
    dead = (torch.cat([adj, adj[:1]]), torch.cat([s0, s0[:1]]),
            torch.cat([live, live.new_zeros(1)]), torch.cat([m, m[:1]]),
            torch.cat([v, v[:1]]))
    assert nbytes(*dead) == n + 1
    pad = (adj, s0, live, torch.cat([m, m.new_full((m.shape[0], 32, ww),
                                                   -1)], 1),
           torch.cat([v, v.new_zeros((v.shape[0], 32))], 1))
    assert nbytes(*pad) == n + 32 * live_n
    # a slot added to a live root's S0 adds its adj row, WW words
    b = int(live.nonzero()[0, 0])
    bits = np.unpackbits(s0[b].numpy().view(np.uint8), bitorder="little")
    j = int(np.flatnonzero(bits == 0)[0])
    bits[j] = 1
    more = s0.clone()
    more[b] = torch.from_numpy(np.packbits(bits, bitorder="little").view(
        np.int32).copy())
    assert nbytes(adj, more, live, m, v) == n + 4 * ww


def test_profiler_reader_names_kernels_bare():
    from gms_tpu_torch.bench.profiling import BK_GROUPS, bare_kernel

    assert bare_kernel("void (anonymous namespace)::bk_stack_kernel<4, "
                       "false>(WalkArgs)") == "bk_stack_kernel"
    assert bare_kernel("void at::native::(anonymous namespace)::"
                       "fill_kernel(int)") == "fill_kernel"
    assert bare_kernel("Memset (Device)") == "Memset (Device)"
    assert bare_kernel("Memcpy HtoD (Pageable -> Device)").startswith(
        "Memcpy")
    assert BK_GROUPS["K9"][0] == "bk_stack_kernel"
    assert BK_GROUPS["K36"][0] == "bk_direct_kernel"


def test_wrappers_reject_bad_inputs():
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32)  # noqa: E731
    b = lambda *s: torch.zeros(s, dtype=torch.bool)  # noqa: E731
    with pytest.raises(ValueError, match="32\\*WW"):
        bk.symmetrize_bits(i32(2, 16, 1))
    with pytest.raises(ValueError, match="does not match"):
        bk.bk_stack_machine(i32(2, 32, 1), i32(3, 1), b(2), i32(2, 32, 1),
                            b(2, 32))
    with pytest.raises(TypeError, match="live0"):
        bk.bk_stack_machine(i32(2, 32, 1), i32(2, 1), i32(2), i32(2, 32, 1),
                            b(2, 32))
    with pytest.raises(TypeError, match="wvalid"):
        bk.bk_stack_machine(i32(2, 32, 1), i32(2, 1), b(2), i32(2, 32, 1),
                            b(2, 16))
    with pytest.raises(ValueError, match="in_width"):
        bk.hub_cover_bits(i32(8, 4), i32(3), i32(2), i32(2), in_width=0,
                          w_words=1)
    with pytest.raises(ValueError, match="WW\\+1"):
        bk.decode_clique_members(i32(8, 4), i32(2), i32(3, 1))


# ---------------------------------------------------------------------------
# end to end, as tests/test_bron_kerbosch.py
# ---------------------------------------------------------------------------

def check_graph(g, jg, ordering="degeneracy"):
    want = set(jbk.bron_kerbosch_simple(jg))
    count, got = bk.bron_kerbosch(g, device="cpu", ordering=ordering,
                                  collect=True)
    jcount, jgot = jbk.bron_kerbosch(jg, ordering=ordering, collect=True)
    assert count == jcount == len(want)
    got_set = set(got)
    assert got_set == set(jgot) == want
    assert set(bk.bron_kerbosch_simple(g)) == want
    for c in got_set:
        assert bk.is_clique(g, c) and bk.is_maximal(g, c)


@pytest.mark.parametrize("ordering", ORDERINGS)
def test_fixtures(fixture_edge_lists, fixture_graphs, ordering):
    for name, el in fixture_edge_lists.items():
        check_graph(build_csr(el), fixture_graphs[name], ordering)


def test_triangle_plus_isolated():
    g, jg = both(np.array([[0, 1], [1, 2], [0, 2]], dtype=np.int64), 5)
    count, got = bk.bron_kerbosch(g, device="cpu", collect=True)
    assert set(got) == {frozenset({0, 1, 2}), frozenset({3}), frozenset({4})}
    assert count == 3 == jbk.bron_kerbosch(jg)


@pytest.mark.parametrize("n,p,seed", [(10, 0.4, 0), (50, 0.15, 1),
                                      (100, 0.08, 2)])
def test_random_graphs(n, p, seed):
    check_graph(*both(random_graph(n, p, seed), n))


def test_count_only_matches_collect():
    g, jg = both(random_graph(40, 0.3, 7), 40)
    count, got = bk.bron_kerbosch(g, device="cpu", collect=True)
    assert bk.bron_kerbosch(g, device="cpu") == count == len(got) == \
        jbk.bron_kerbosch(jg)


def test_small_root_chunk():
    g, jg = both(random_graph(30, 0.3, 9), 30)
    want = len(jbk.bron_kerbosch_simple(jg))
    assert bk.bron_kerbosch(g, device="cpu", root_chunk=4) == want == \
        jbk.bron_kerbosch(jg, root_chunk=4)


def test_empty_and_edgeless():
    g0, jg0 = both(np.zeros((0, 2), dtype=np.int64), 0)
    assert bk.bron_kerbosch(g0, device="cpu") == 0 == jbk.bron_kerbosch(jg0)
    assert bk.bron_kerbosch(g0, device="cpu", collect=True) == (0, [])
    g1, jg1 = both(np.zeros((0, 2), dtype=np.int64), 3)
    count, got = bk.bron_kerbosch(g1, device="cpu", collect=True)
    assert count == 3 and set(got) == {frozenset({v}) for v in range(3)}
    assert (count, set(got)) == (lambda r: (r[0], set(r[1])))(
        jbk.bron_kerbosch(jg1, collect=True))


def test_hub_path_graphs_match_oracle():
    for n, p, seed in ((60, 0.25, 3), (120, 0.12, 4), (200, 0.08, 5)):
        g, jg = both(random_graph(n, p, seed=seed), n)
        want = jbk.bron_kerbosch_simple(jg)
        assert bk.bron_kerbosch(g, device="cpu") == len(want) == \
            jbk.bron_kerbosch(jg)
        cnt, cl = bk.bron_kerbosch(g, device="cpu", collect=True)
        assert cnt == len(want) and set(cl) == set(want)


@pytest.mark.parametrize("scale", [8, 9])
def test_rmat_sink_streams_every_clique(scale):
    g, jg = rmat(scale)
    want = jbk.bron_kerbosch(jg)
    rows = []

    def sink(gid, members):
        assert gid.dtype == members.dtype == np.int32
        assert members.shape == (len(gid), members.shape[1])
        rows.append(len(gid))
        for l in range(0, len(gid), 97):  # a sample of the rows
            clique = {int(gid[l]), *members[l][members[l] >= 0].tolist()}
            assert bk.is_clique(g, clique)

    count, cl = bk.bron_kerbosch(g, device="cpu", collect=True, sink=sink)
    assert cl is None and sum(rows) == count == want
    assert bk.bron_kerbosch(g, device="cpu") == want


def test_complete_graph_has_a_w256_root():
    n = 130  # root 0 has out-degree 129: a W = 256 tier
    g, jg = both(complete_graph_el(n), n)
    rank = np.arange(n, dtype=np.int32)
    plan = bk.BKPlan(g, rank, np.arange(n, dtype=np.int32), device="cpu")
    assert max(ww for _, ww, _ in plan.jobs) == 8
    # the one maximal clique is rooted at 0, the W = 256 root; one call
    # counts and collects it (bron_kerbosch_simple, without a pivot, takes
    # 2^n steps here)
    first = np.zeros(1, np.int32)
    count, got = bk.bron_kerbosch(g, device="cpu", rank=rank, roots=first,
                                  collect=True)
    assert count == 1 == jbk.bron_kerbosch(jg, rank=rank, roots=first)
    assert got == [frozenset(range(n))]


def test_disjoint_roots_sum_to_the_whole():
    g, jg = rmat(8)
    want = jbk.bron_kerbosch(jg)
    parts = np.array_split(np.random.default_rng(0).permutation(g.num_nodes)
                           .astype(np.int32), 3)
    got = [bk.bron_kerbosch(g, device="cpu", roots=p) for p in parts]
    assert sum(got) == want and all(x > 0 for x in got)
    assert got[0] == jbk.bron_kerbosch(jg, roots=parts[0])


def test_direct_and_devices_are_not_ported():
    """(The name dates from when direct=True raised.) bron_kerbosch takes
    no devices=, as gms_tpu's: the fan-out is _bk_fused(devices=) and
    parallel/multi.py. direct=True counts, and with collect=True it takes
    the fused path, as gms_tpu's `if not direct or collect`."""
    g = build_csr(np.array([[0, 1]], dtype=np.int64))
    with pytest.raises(TypeError, match="devices"):
        bk.bron_kerbosch(g, device="cpu", devices=["cpu", "cpu"])
    assert bk.bron_kerbosch(g, device="cpu", direct=True) == 1
    g = build_csr(random_graph(40, 0.3, 5), num_nodes=40)
    want = set(bk.bron_kerbosch_simple(g))
    for threshold in (1024, 4):
        count, got = bk.bron_kerbosch(g, device="cpu", direct=True,
                                      collect=True, hub_threshold=threshold)
        assert count == len(want) and set(got) == want
    with pytest.raises(ValueError, match="ordering"):
        bk.bron_kerbosch(g, device="cpu", ordering="random")
