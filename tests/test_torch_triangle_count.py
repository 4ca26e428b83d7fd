"""Triangle counting in the PyTorch port against gms_tpu and the oracles.

* each kernel's plain PyTorch version (what the wrapper runs on CPU tensors)
  against its gms_tpu jax program on identical seeded inputs;
* TrianglePlan(device="cpu") against gms_tpu's TrianglePlan (plan arrays
  element for element) and against triangle_count_oracle;
* plan_from_numpy on gms_tpu's plan arrays;
* per-vertex counts (count_dag_edges_per_vertex, triangle_count_per_vertex)
  and the dense-bitmap count (count_hub_edges, triangle_count_dense) against
  gms_tpu's and the oracles.

Every comparison is exact: all results are integers. The CUDA kernels
themselves are held against these plain versions on the card by
chip_smoke.py and by the `cuda`-marked tests of test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gms_tpu.algorithms import triangle_count as jtc
from gms_tpu.graphs.tiles import PaddedGraph as JPaddedGraph
from gms_tpu.io.builder import build_csr as jbuild_csr

from gms_tpu_torch.algorithms import triangle_count as tc
from gms_tpu_torch.convert import plan_from_numpy
from gms_tpu_torch.graphs.tiles import SENTINEL, PaddedGraph
from gms_tpu_torch.io.builder import build_csr
from gms_tpu_torch.io.generators import generate_rmat_el
from gms_tpu_torch.preprocessing import orient

from conftest import random_graph

torch.set_num_threads(1)


def sorted_columns(rng, width, n, universe):
    """int32[width, n]: column e sorted, distinct, SENTINEL tail."""
    out = np.full((width, n), SENTINEL, dtype=np.int32)
    for e in range(n):
        k = int(rng.integers(0, width + 1))
        out[:k, e] = np.sort(rng.choice(universe, size=k, replace=False))
    return out


def words(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)


def as_i32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def oriented_padded(n=60, p=0.3, seed=4):
    el = random_graph(n, p, seed)
    g = build_csr(el, num_nodes=n)
    dag = orient.orient(g, orient.degree_rank(g))
    return (PaddedGraph.from_csr(dag, device="cpu"),
            JPaddedGraph.from_csr(dag), dag)


# ---------------------------------------------------------------------------
# plain versions against gms_tpu's programs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wa,wb,E,chunk", [(16, 16, 256, 64), (16, 64, 512, 128),
                                          (64, 64, 384, 384), (5, 3, 96, 32)])
def test_count_tier_mat_plain_vs_jax(wa, wb, E, chunk):
    rng = np.random.default_rng(wa * 1000 + E)
    a = sorted_columns(rng, wa, E, 3 * wb)
    b = sorted_columns(rng, wb, E, 3 * wb)
    a[:, -5:] = SENTINEL  # padding edges: all-SENTINEL columns
    b[:, -5:] = SENTINEL
    want = int(jtc.count_tier_mat(jnp.asarray(a), jnp.asarray(b),
                                  jnp.int32(0), chunk=chunk))
    got = tc.count_tier_mat_plain(torch.from_numpy(a), torch.from_numpy(b),
                                  chunk=chunk)
    assert got.dtype == torch.int64 and int(got) == want
    # the wrapper takes the plain version for CPU tensors, without a launch
    before = dict(tc.LAUNCHES)
    assert int(tc.count_tier_mat(torch.from_numpy(a), torch.from_numpy(b))) == want
    assert tc.LAUNCHES == before


@pytest.mark.parametrize("G,K,W,chunk", [(64, 16, 16, 16), (32, 64, 5, 8),
                                         (16, 16, 40, 16)])
def test_count_hub_groups_mat_plain_vs_jax(G, K, W, chunk):
    rng = np.random.default_rng(G + K + W)
    b = words(rng, (G, W))
    a = words(rng, (G, K, W))
    want = int(jtc.count_hub_groups_mat(jnp.asarray(b), jnp.asarray(a),
                                        jnp.int32(0), chunk=chunk))
    assert int(tc.count_hub_groups_mat_plain(as_i32(b), as_i32(a),
                                             chunk=chunk)) == want
    assert int(tc.count_hub_groups_mat(as_i32(b), as_i32(a))) == want


@pytest.mark.parametrize("seed", [0, 1])
def test_build_hub_rows_plain_vs_jax(seed):
    pg, jpg, dag = oriented_padded(seed=seed)
    rng = np.random.default_rng(seed)
    n_hub = 40
    hw = -(-n_hub // 32)
    hub_id = np.full(pg.v_pad + 1, 32 * hw, dtype=np.int32)
    hub_vids = rng.choice(dag.num_nodes, size=n_hub, replace=False)
    hub_id[hub_vids] = rng.permutation(n_hub).astype(np.int32)
    wide = rng.choice(dag.num_nodes, size=25, replace=False).astype(np.int32)
    wide[-1] = pg.v_pad + 3  # clips to the all-SENTINEL guard row
    want = np.asarray(jtc.build_hub_rows(jpg.nbr, jnp.asarray(hub_id),
                                         jnp.asarray(wide), hub_words=hw))
    got = tc.build_hub_rows_plain(pg.nbr, torch.from_numpy(hub_id),
                                  torch.from_numpy(wide), hub_words=hw)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert want.any()
    assert np.array_equal(
        tc.build_hub_rows(pg.nbr, torch.from_numpy(hub_id),
                          torch.from_numpy(wide), hub_words=hw).numpy(),
        got.numpy())
    # the out= form TrianglePlan takes: gms_tpu's rows, then a zero guard row
    out = torch.full((len(wide) + 1, hw), -1, dtype=torch.int32)
    tc.build_hub_rows(pg.nbr, torch.from_numpy(hub_id),
                      torch.from_numpy(wide), hub_words=hw, out=out)
    assert np.array_equal(out.numpy().view(np.uint32),
                          np.concatenate([want, np.zeros((1, hw), want.dtype)]))


@pytest.mark.parametrize("method", ["compare", "searchsorted"])
@pytest.mark.parametrize("widths", [None, "tiers"])
def test_count_dag_edges_plain_vs_jax(method, widths):
    pg, jpg, dag = oriented_padded(n=80, p=0.25, seed=9)
    edges = dag.edge_array()
    parts = ({(None, None): edges} if widths is None else
             tc.partition_edges_2d(edges, np.asarray(dag.degrees),
                                   tc._tier_widths(pg.d_pad, (4, 8))))
    total = 0
    for (wa, wb), part in parts.items():
        e, v = tc._pad_edges(part, 64)
        want = int(jtc.count_dag_edges(jpg.nbr, jnp.asarray(e), jnp.asarray(v),
                                       chunk=64, method=method,
                                       width_a=wa, width_b=wb))
        got = tc.count_dag_edges_plain(pg.nbr, torch.from_numpy(e),
                                       torch.from_numpy(v), chunk=64,
                                       method=method, width_a=wa, width_b=wb)
        assert int(got) == want
        assert int(tc.count_dag_edges(pg.nbr, torch.from_numpy(e),
                                      torch.from_numpy(v), chunk=64,
                                      method=method, width_a=wa,
                                      width_b=wb)) == want
        total += want
    assert total == tc.triangle_count_oracle(build_csr(
        random_graph(80, 0.25, 9), num_nodes=80))


@pytest.mark.parametrize("N,HW,G,K,width,chunk", [(30, 6, 48, 16, 4, 16),
                                                  (50, 3, 16, 64, 3, 8)])
def test_count_hub_groups_plain_vs_jax(N, HW, G, K, width, chunk):
    rng = np.random.default_rng(N * G)
    rows = words(rng, (N + 1, HW))
    rows[-1] = 0  # guard row
    b_ids = rng.integers(0, N + 1, G).astype(np.int32)
    nbrs = rng.integers(0, N + 1, (G, K)).astype(np.int32)
    nbrs[:, -3:] = N  # guard slots
    want = int(jtc.count_hub_groups(jnp.asarray(rows), jnp.asarray(b_ids),
                                    jnp.asarray(nbrs), chunk=chunk,
                                    width=width, k=K))
    args = (as_i32(rows), torch.from_numpy(b_ids), torch.from_numpy(nbrs))
    assert int(tc.count_hub_groups_plain(*args, chunk=chunk, width=width,
                                         k=K)) == want
    assert int(tc.count_hub_groups(*args, chunk=chunk, width=width,
                                   k=K)) == want


def test_popcount32_matches_numpy():
    rng = np.random.default_rng(1)
    w = words(rng, 4096)
    w[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    want = np.unpackbits(w.view(np.uint8)).reshape(-1, 32).sum(axis=1)
    assert np.array_equal(tc.popcount32(as_i32(w)).numpy(), want)


# ---------------------------------------------------------------------------
# the plan against gms_tpu's plan and the oracle
# ---------------------------------------------------------------------------

def jax_state(jp):
    hub = jp.hub is not None
    return {
        "nbr": np.asarray(jp.padded.nbr),
        "num_nodes": jp.padded.num_nodes,
        "num_edges_undirected": jp.num_edges_undirected,
        "method": jp.method,
        "tiers": [(wa, wb, c, np.asarray(e), np.asarray(v))
                  for wa, wb, c, e, v in jp.tiers],
        "hub": ([(w, k, gc, np.asarray(b), np.asarray(n))
                 for w, k, gc, b, n in jp.hub] if hub else None),
        "hub_rows": np.asarray(jp.hub_rows) if hub else None,
        "tiers_mat": (None if jp.tiers_mat is None else
                      [(cm, np.asarray(a), np.asarray(b))
                       for cm, a, b in jp.tiers_mat]),
        "hub_mat": (None if jp.hub_mat is None else
                    [(gc, np.asarray(b), np.asarray(a))
                     for gc, b, a in jp.hub_mat]),
    }


def assert_same_plan(plan, state):
    def eq(x, y):
        if isinstance(x, torch.Tensor):
            y = np.asarray(y)
            x = x.numpy().view(y.dtype)
            assert x.shape == y.shape and np.array_equal(x, y)
        else:
            assert x == y

    assert np.array_equal(plan.padded.nbr.numpy(), state["nbr"])
    for key in ("tiers", "hub", "tiers_mat", "hub_mat"):
        mine, theirs = getattr(plan, key), state[key]
        assert (mine is None) == (theirs is None), key
        assert len(mine or []) == len(theirs or []), key
        for m, t in zip(mine or [], theirs or []):
            for x, y in zip(m, t):
                eq(x, y)
    if state["hub_rows"] is None:
        assert plan.hub_rows is None
    else:
        eq(plan.hub_rows, state["hub_rows"])
    assert plan.traffic_bytes() == sum(
        v.size * (wa + wb) * 4 for wa, wb, _, _, v in state["tiers"]) + sum(
        (b.size + n.size) * w * 4 for w, _, _, b, n in state["hub"] or [])


PLAN_GRAPHS = ["fixtures", "random0", "random1", "rmat9"]


@pytest.fixture(scope="module")
def port_fixtures(fixture_edge_lists):
    """The tests/testGraphs fixtures built by the port's builder."""
    return {k: build_csr(v) for k, v in fixture_edge_lists.items()}


def plan_graphs(which, port_fixtures):
    if which == "fixtures":
        return list(port_fixtures.values())
    if which.startswith("random"):
        seed = int(which[-1])
        return [build_csr(random_graph(120, 0.25, seed), num_nodes=120)]
    return [build_csr(generate_rmat_el(9, 16, seed=5), num_nodes=512)]


@pytest.mark.parametrize("materialize", [True, False])
@pytest.mark.parametrize("hub_threshold", [2, 8, 20, None])
@pytest.mark.parametrize("which", PLAN_GRAPHS)
def test_plan_vs_gms_tpu_and_oracle(which, hub_threshold, materialize,
                                    port_fixtures):
    for g in plan_graphs(which, port_fixtures):
        want = tc.triangle_count_oracle(g)
        plan = tc.TrianglePlan(g, device="cpu", hub_threshold=hub_threshold,
                               materialize=materialize)
        assert plan.run() == want
        jg = jbuild_csr(g.edge_array(), num_nodes=g.num_nodes)
        jp = jtc.TrianglePlan(jg, hub_threshold=hub_threshold,
                              materialize=materialize)
        assert_same_plan(plan, jax_state(jp))


@pytest.mark.parametrize("method", ["compare", "searchsorted"])
def test_plan_methods_and_id_rank(method):
    g = build_csr(random_graph(80, 0.2, seed=5), num_nodes=80)
    want = tc.triangle_count_oracle(g)
    for mat in (True, False):
        assert tc.TrianglePlan(g, device="cpu", method=method,
                               materialize=mat).run() == want
        plan = tc.TrianglePlan(g, device="cpu", rank=orient.id_rank(g),
                               method=method, materialize=mat)
        assert plan.hub is None  # the hub path needs degree orientation
        assert plan.run() == want
    assert tc.triangle_count(g, device="cpu", method=method, chunk=128) == want
    jp = jtc.TrianglePlan(jbuild_csr(g.edge_array(), num_nodes=80),
                          rank=orient.id_rank(g), method=method)
    assert jp.run() == want
    assert_same_plan(tc.TrianglePlan(g, device="cpu", rank=orient.id_rank(g),
                                     method=method), jax_state(jp))


@pytest.mark.parametrize("materialize", [True, False])
def test_plan_from_numpy(materialize):
    g = build_csr(generate_rmat_el(10, 16, seed=3), num_nodes=1024)
    jp = jtc.TrianglePlan(jbuild_csr(g.edge_array(), num_nodes=1024),
                          hub_threshold=8, materialize=materialize)
    want = jp.run()
    assert want == tc.triangle_count_oracle(g)
    plan = plan_from_numpy(jax_state(jp), device="cpu")
    assert plan.run() == want
    assert plan.traffic_bytes() == jp.traffic_bytes()
    assert plan.hub_rows.dtype == torch.int32


@pytest.mark.parametrize("entry", ["count_tier_mat", "count_dag_edges",
                                   "count_dag_edges_per_vertex",
                                   "plan_from_numpy"])
def test_paranoid_rejects_unsorted_rows(entry, monkeypatch):
    pg, jpg, dag = oriented_padded()
    nbr = pg.nbr.numpy().copy()
    v = int(np.argmax(pg.deg.numpy()))
    nbr[v, :2] = nbr[v, 1::-1]
    edges = torch.tensor([[v, v]], dtype=torch.int32)
    valid = torch.ones(1, dtype=torch.int32)
    calls = {
        "count_tier_mat": lambda: tc.count_tier_mat(
            torch.from_numpy(nbr[[v]].T.copy()),
            torch.from_numpy(nbr[[0]].T.copy())),
        "count_dag_edges": lambda: tc.count_dag_edges(
            torch.from_numpy(nbr), edges, valid),
        "count_dag_edges_per_vertex": lambda: tc.count_dag_edges_per_vertex(
            torch.from_numpy(nbr), edges, valid, num_segments=nbr.shape[0]),
        "plan_from_numpy": lambda: plan_from_numpy(
            {"nbr": nbr, "tiers": []}, device="cpu"),
    }
    calls[entry]()                           # unchecked by default
    monkeypatch.setenv("GMS_TPU_PARANOID", "1")
    with pytest.raises(AssertionError, match="not strictly sorted"):
        calls[entry]()


def test_golden_fixtures_and_steady(port_fixtures):
    for name, want in {"micro": 0, "triangles_1": 1, "triangles_3": 3}.items():
        assert tc.triangle_count(port_fixtures[name], device="cpu",
                                 chunk=64) == want
    plan = tc.TrianglePlan(port_fixtures["triangles_3"], device="cpu")
    count, seconds = plan.run_steady(3)
    assert count == 3 and seconds > 0


def test_empty_graph_counts_zero():
    g = build_csr(np.zeros((0, 2), dtype=np.int64), num_nodes=5)
    for mat in (True, False):
        assert tc.TrianglePlan(g, device="cpu", materialize=mat).run() == 0


def test_compressed_inputs_not_ported():
    with pytest.raises(TypeError):
        tc.triangle_count(object(), device="cpu")


def test_oracles_match_gms_tpu(port_fixtures, fixture_graphs):
    for name, g in port_fixtures.items():
        jg = fixture_graphs[name]
        assert tc.triangle_count_oracle(g) == jtc.triangle_count_oracle(jg)
        assert np.array_equal(tc.triangle_count_per_vertex_oracle(g),
                              jtc.triangle_count_per_vertex_oracle(jg))


def test_materialized_tier_counts_every_edge():
    """A tier whose plan chunk is not a multiple of its stream chunk (widths
    (16, 384): 10922 vs 4096). Every one of its edges must be counted;
    gms_tpu's materialized program steps E // chunk whole chunks and drops
    the tail there, so the port is held to the oracle and to gms_tpu's
    gather mode instead."""
    rng = np.random.default_rng(0)
    hubs, targets = 30, np.arange(30, 2030)
    edges = [(h, t) for h in range(hubs)
             for t in rng.choice(targets, 300, replace=False)]
    edges += [(t, u) for t in targets
              for u in rng.choice(targets, 6, replace=False) if u != t]
    el = np.array(edges)
    g = build_csr(el)
    plan = tc.TrianglePlan(g, device="cpu", rank=orient.id_rank(g),
                           materialize=True)
    tier = {(wa, wb): c for wa, wb, c, _, _ in plan.tiers}
    assert tier[(16, 384)] == 10922
    want = tc.triangle_count_oracle(g)
    assert plan.run() == want
    jg = jbuild_csr(el)
    assert jtc.TrianglePlan(jg, rank=orient.id_rank(jg),
                            materialize=False).run() == want


# ---------------------------------------------------------------------------
# per-vertex and dense-bitmap counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["compare", "searchsorted"])
@pytest.mark.parametrize("widths", [None, "tiers"])
def test_count_dag_edges_per_vertex_plain_vs_jax(method, widths):
    pg, jpg, dag = oriented_padded(n=80, p=0.25, seed=9)
    edges = dag.edge_array()
    parts = ({(None, None): edges} if widths is None else
             tc.partition_edges_2d(edges, np.asarray(dag.degrees),
                                   tc._tier_widths(pg.d_pad, (4, 8))))
    total = np.zeros(pg.v_pad, dtype=np.int64)
    acc = torch.zeros(pg.v_pad, dtype=torch.int64)   # added into by out=
    for (wa, wb), part in parts.items():
        e, v = tc._pad_edges(part, 64)
        # the weights a caller may give: >1 scales the ends' counts but not
        # the witnesses', <=0 counts nothing
        weighted = v.copy()
        weighted[:4] = (2, -1, 0, 3)
        for val in (v, weighted):
            want = np.asarray(jtc.count_dag_edges_per_vertex(
                jpg.nbr, jnp.asarray(e), jnp.asarray(val), chunk=64,
                num_segments=pg.v_pad, method=method, width_a=wa,
                width_b=wb))
            args = (pg.nbr, torch.from_numpy(e), torch.from_numpy(val))
            kw = dict(num_segments=pg.v_pad, chunk=64, method=method,
                      width_a=wa, width_b=wb)
            got = tc.count_dag_edges_per_vertex_plain(*args, **kw)
            assert got.dtype == torch.int64
            assert np.array_equal(got.numpy(), want)
            before = dict(tc.LAUNCHES)
            assert np.array_equal(
                tc.count_dag_edges_per_vertex(*args, **kw).numpy(), want)
            assert tc.LAUNCHES == before
            if val is v:
                total += want
                assert tc.count_dag_edges_per_vertex(*args, **kw,
                                                     out=acc) is acc
    assert np.array_equal(acc.numpy(), total)
    with pytest.raises(ValueError, match="out"):
        tc.count_dag_edges_per_vertex(
            pg.nbr, torch.from_numpy(e), torch.from_numpy(v),
            num_segments=pg.v_pad, out=acc[:-1].clone())
    assert np.array_equal(total[:dag.num_nodes],
                          tc.triangle_count_per_vertex_oracle(build_csr(
                              random_graph(80, 0.25, 9), num_nodes=80)))


def _per_vertex_pair(nbr, e, v, wa=None, wb=None):
    """(the plain version's counts, gms_tpu's) on the same padded rows nbr
    (int32 numpy), at the chunk, method and segments with which
    test_count_dag_edges_per_vertex_plain_vs_jax compiles gms_tpu's
    program."""
    want = np.asarray(jtc.count_dag_edges_per_vertex(
        jnp.asarray(nbr), jnp.asarray(e), jnp.asarray(v), chunk=64,
        num_segments=nbr.shape[0], method="compare", width_a=wa, width_b=wb))
    got = tc.count_dag_edges_per_vertex_plain(
        torch.from_numpy(nbr), torch.from_numpy(e), torch.from_numpy(v),
        num_segments=nbr.shape[0], chunk=64, width_a=wa, width_b=wb)
    return got.numpy(), want


def test_count_dag_edges_per_vertex_in_any_edge_order():
    # each tier's edges permuted: the same counts as in the planner's order
    rng = np.random.default_rng(5)
    pg, _, dag = oriented_padded(n=80, p=0.25, seed=9)
    nbr = pg.nbr.numpy()
    parts = tc.partition_edges_2d(dag.edge_array(), np.asarray(dag.degrees),
                                  tc._tier_widths(pg.d_pad, (4, 8)))
    total = np.zeros(pg.v_pad, dtype=np.int64)
    for (wa, wb), part in parts.items():
        e, v = tc._pad_edges(part, 64)
        ep, vp = tc._pad_edges(part[rng.permutation(len(part))], 64)
        got, want = _per_vertex_pair(nbr, ep, vp, wa, wb)
        assert np.array_equal(got, want)
        assert np.array_equal(got, _per_vertex_pair(nbr, e, v, wa, wb)[0])
        total += got
    assert np.array_equal(total[:dag.num_nodes],
                          tc.triangle_count_per_vertex_oracle(build_csr(
                              random_graph(80, 0.25, 9), num_nodes=80)))


def test_count_dag_edges_per_vertex_one_hub_witness():
    # a book of triangles: every row holds the hub (the last id) and a few
    # higher ids, so the hub is the witness of every edge between two pages;
    # the table and edge count of test_count_dag_edges_per_vertex_plain_vs_jax
    rng = np.random.default_rng(6)
    pg, _, dag = oriented_padded(n=80, p=0.25, seed=9)
    V, D = pg.nbr.shape
    hub = 79
    nbr = np.full((V, D), int(SENTINEL), dtype=np.int32)
    for i in range(hub):
        up = np.arange(i + 1, hub)
        k = min(len(up), int(rng.integers(0, D - 1)), 6)
        nbr[i, :k + 1] = np.sort(np.append(rng.choice(up, k, replace=False),
                                           hub))
    ids = np.arange(V)[:, None].repeat(D, 1)
    edges = np.stack([ids[nbr != SENTINEL], nbr[nbr != SENTINEL]], 1)
    edges = edges.astype(np.int32)
    e, v = tc._pad_edges(dag.edge_array(), 64)
    assert len(edges) <= len(e)
    e[:] = 0
    v[:] = 0
    e[:len(edges)], v[:len(edges)] = edges, 1
    got, want = _per_vertex_pair(nbr, e, v)
    assert np.array_equal(got, want)
    # the hub's row is empty, so its count is one a page edge
    assert got[hub] == int((edges[:, 1] != hub).sum()) > 0


PER_VERTEX_GRAPHS = ["fixtures", "random0", "random1", "rmat8", "rmat9",
                     "rmat10"]


def per_vertex_graphs(which, port_fixtures):
    if which.startswith("rmat"):
        s = int(which[4:])
        return [build_csr(generate_rmat_el(s, 16, seed=s), num_nodes=1 << s)]
    return plan_graphs(which, port_fixtures)


@pytest.mark.parametrize("tiers", [tc.DEFAULT_TIERS, (2, 4, 8, 16)])
@pytest.mark.parametrize("which", PER_VERTEX_GRAPHS)
def test_per_vertex_vs_gms_tpu_and_oracle(which, tiers, port_fixtures):
    for g in per_vertex_graphs(which, port_fixtures):
        got = tc.triangle_count_per_vertex(g, device="cpu", tiers=tiers)
        assert got.dtype == np.int64 and got.shape == (g.num_nodes,)
        assert np.array_equal(got, tc.triangle_count_per_vertex_oracle(g))
        assert got.sum() == 3 * tc.triangle_count_oracle(g)
        jg = jbuild_csr(g.edge_array(), num_nodes=g.num_nodes)
        assert np.array_equal(got, jtc.triangle_count_per_vertex(
            jg, tiers=tiers))
    if which.startswith("rmat") and len(tiers) == 4:
        # the small tiers give every (wa, wb) pair of the five widths
        pg, parts = tc.plan_per_vertex(g, device="cpu", tiers=tiers)
        assert len(parts) == 15 and pg.d_pad > 16


def test_plan_per_vertex_arrays():
    g = build_csr(generate_rmat_el(9, 16, seed=9), num_nodes=512)
    pg, parts = tc.plan_per_vertex(g, device="cpu", chunk=256)
    dag = orient.orient(g, orient.degree_rank(g))
    assert np.array_equal(pg.nbr.numpy(), np.asarray(
        JPaddedGraph.from_csr(dag).nbr))
    want = tc.partition_edges_2d(dag.edge_array(), np.asarray(dag.degrees),
                                 tc._tier_widths(pg.d_pad, tc.DEFAULT_TIERS))
    assert [(wa, wb) for wa, wb, *_ in parts] == list(want)
    for (wa, wb, c, e, v), part in zip(parts, want.values()):
        assert c == 256 and e.shape[0] % 256 == 0
        assert np.array_equal(e.numpy()[:len(part)], part)
        assert int(v.sum()) == len(part)


@pytest.mark.parametrize("row_of", [False, True])
@pytest.mark.parametrize("width", [None, 3])
def test_count_hub_edges_plain_vs_jax(row_of, width):
    rng = np.random.default_rng(17 + 2 * row_of + (width or 0))
    N, HW, E, chunk = 40, 7, 256, 64
    rows = words(rng, (N, HW))
    rows[-1] = 0
    if row_of:
        ro = rng.integers(0, N, 61).astype(np.int32)
        ro[-1] = N  # the clip slot: past the last row, clips to it
        edges = rng.integers(0, 61, (E, 2)).astype(np.int32)
        edges[:5] = [[70, 3], [-2, 5], [60, 60], [0, 61], [12, 100]]
    else:
        ro = None
        edges = rng.integers(0, N, (E, 2)).astype(np.int32)
        edges[:3] = [[N + 4, 1], [-1, 2], [7, N]]  # ids clip into range
    valid = (rng.random(E) < 0.8).astype(np.int32)
    want = int(jtc.count_hub_edges(
        jnp.asarray(rows), None if ro is None else jnp.asarray(ro),
        jnp.asarray(edges), jnp.asarray(valid), chunk=chunk, width=width))
    args = (as_i32(rows), None if ro is None else torch.from_numpy(ro),
            torch.from_numpy(edges), torch.from_numpy(valid))
    got = tc.count_hub_edges_plain(*args, chunk=chunk, width=width)
    assert got.dtype == torch.int64 and int(got) == want > 0
    assert int(tc.count_hub_edges(*args, chunk=chunk, width=width)) == want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_triangle_count_dense_vs_gms_tpu(seed):
    """As tests/test_compressed.py's dense case, against gms_tpu too."""
    g = build_csr(random_graph(90, 0.25, seed), num_nodes=90)
    want = tc.triangle_count_oracle(g)
    assert tc.triangle_count_dense(g, device="cpu", chunk=64) == want
    assert tc.triangle_count_dense(g, device="cpu") == want
    jg = jbuild_csr(g.edge_array(), num_nodes=90)
    assert jtc.triangle_count_dense(jg, chunk=64) == want
    assert tc.TrianglePlan(g, device="cpu").run() == want


def test_triangle_count_dense_rmat_and_fixtures(port_fixtures):
    g = build_csr(generate_rmat_el(10, 16, seed=2), num_nodes=1024)
    assert tc.triangle_count_dense(g, device="cpu") == \
        tc.TrianglePlan(g, device="cpu").run()
    for name, want in {"micro": 0, "triangles_1": 1, "triangles_3": 3}.items():
        assert tc.triangle_count_dense(port_fixtures[name], device="cpu",
                                       chunk=64) == want


# K15's design (csrc/bitmap_count.cu edge_runs_kernel) replayed in numpy:
# tiles of edges, runs of one source row, the tile's runs' non-zero words
# staged once a run (at most K15_PAIRS a tile), the other row read only at
# those words, the word loop above the threshold
K15_TILE, K15_PAIRS = 256, 2048


def replay_hub_edges(rows, row_of, edges, valid, width=None):
    """(count_hub_edges as edge_runs_kernel computes it, runs staged, dense
    runs); rows uint32[N, HW] numpy."""
    n, hw = rows.shape
    w = min(width or hw, hw)
    e = edges.astype(np.int64)
    if row_of is not None:
        e = row_of[np.clip(e, 0, len(row_of) - 1)].astype(np.int64)
    e = np.clip(e, 0, n - 1)
    key = np.where(valid != 0, e[:, 0], -1)
    total = staged = dense = 0
    for t0 in range(0, len(key), K15_TILE):
        k = key[t0:t0 + K15_TILE]
        head = (k >= 0) & np.r_[True, k[1:] != k[:-1]]
        starts = [*np.nonzero(head)[0], len(k)]
        end = 0                                 # the tile's pairs so far
        for s, t in zip(starts, starts[1:]):
            a = rows[k[s], :w]
            at = np.nonzero(a)[0]
            end += len(at)
            big = 2 * len(at) > w or end > K15_PAIRS
            staged, dense = staged + 1, dense + big
            for p in range(s, t):
                if k[p] != k[s]:
                    continue
                b = rows[e[t0 + p, 1], :w]
                both = a & b if big else a[at] & b[at]
                total += int(np.bitwise_count(both).sum()) * int(valid[t0 + p])
    return total, staged, dense


@pytest.mark.parametrize("kind", ["csr", "shuffled", "row_of", "width",
                                  "width4", "dense", "tile", "wide"])
def test_hub_edge_runs_replay_equals_gms_tpu(kind):
    from test_torch_kernels import _hub_edge_case

    rows, row_of, edges, valid, width = _hub_edge_case(kind)
    got, staged, dense = replay_hub_edges(rows, row_of, edges, valid, width)
    want = int(jtc.count_hub_edges(
        jnp.asarray(rows), None if row_of is None else jnp.asarray(row_of),
        jnp.asarray(edges), jnp.asarray(valid), chunk=256, width=width))
    plain = tc.count_hub_edges_plain(
        as_i32(rows), None if row_of is None else torch.from_numpy(row_of),
        torch.from_numpy(edges), torch.from_numpy(valid), chunk=256,
        width=width)
    assert got == int(plain) == want > 0
    # runs share their row's staging unless the edges are shuffled; the
    # word loop takes dense rows and the runs past a tile's staged pairs
    # (shuffled tiles may overflow them)
    assert staged < (0.5 if kind != "shuffled" else 1.01) * len(edges)
    if kind != "shuffled":
        assert (dense > 0) == (kind in ("dense", "wide"))


def test_triangle_count_dense_replayed_equals_gms_tpu(monkeypatch):
    """triangle_count_dense with K15's design replayed, against gms_tpu's
    dense count and the oracle on RMAT-10."""
    def replayed(rows, row_of, edges, valid, *, chunk, width=None):
        got, _, _ = replay_hub_edges(
            rows.numpy().view(np.uint32), None, edges.numpy(),
            valid.numpy(), width)
        return torch.tensor(got, dtype=torch.int64)

    el = generate_rmat_el(10, 16, seed=27491095)
    g = build_csr(el, num_nodes=1024)
    want = jtc.triangle_count_dense(jbuild_csr(el, num_nodes=1024))
    monkeypatch.setattr(tc, "count_hub_edges", replayed)
    assert tc.triangle_count_dense(g, device="cpu") == want == \
        tc.triangle_count_oracle(g)



def replay_hub_groups(rows, b_ids, nbrs, width, live=None):
    """K2's reads (csrc/hub_popcount.cu) over one (W, K) set: a group's head
    chunks (16 bytes where the width and the row stride are multiples of
    4 words, else words), only its non-zero chunks, and only the slots it
    reads (gather: not on the guard row, the last, when that row's prefix
    is zero; stream, given `live`: slots below live[g]). Returns (the sum,
    the partner words read)."""
    guard = rows.shape[0] - 1
    v = 4 if width % 4 == 0 and rows.shape[1] % 4 == 0 else 1
    head = rows[b_ids.long(), :width].reshape(len(b_ids), width // v, v)
    nz = (head != 0).any(2)                                  # [G, chunks]
    if live is None:
        read = ~((nbrs == guard) & bool((rows[guard, :width] == 0).all()))
    else:
        read = torch.arange(nbrs.shape[1])[None, :] < live.long()[:, None]
    total, words_read = 0, 0
    for g in torch.nonzero(nz.any(1)).flatten().tolist():
        at = torch.nonzero(nz[g]).flatten()
        part = rows[nbrs[g][read[g]].long(), :width].reshape(-1, width // v, v)
        part = part[:, at]                                   # the read chunks
        total += int(tc.popcount32(part & head[g, at][None]).sum())
        words_read += part.numel()
    return total, words_read


@pytest.mark.parametrize("hub_threshold", [8, 65])
def test_hub_groups_gated_replay_equals_gms_tpu(hub_threshold):
    """On RMAT-12's plan: K2's head-gated, guard-skipping reads give
    count_hub_groups_plain's and gms_tpu's count_hub_groups' sum for every
    (W, K) set, in gather mode and in stream mode with the plan's live
    counts; the slots past a live count are guard rows, and the gated reads
    take fewer partner words than the plain version's."""
    g = build_csr(generate_rmat_el(12, 16, seed=27491095), num_nodes=1 << 12)
    plan = tc.TrianglePlan(g, device="cpu", hub_threshold=hub_threshold,
                           materialize=True)
    assert plan.hub and len(plan.hub) == len(plan.hub_mat)
    rows = plan.hub_rows
    guard = rows.shape[0] - 1
    jrows = jnp.asarray(rows.numpy().view(np.uint32))
    gated = plain_words = 0
    for (w, k, gc, b_ids, nbrs), (_, b_mat, a_mat, live) in zip(plan.hub,
                                                                 plan.hub_mat):
        want = int(tc.count_hub_groups_plain(rows, b_ids, nbrs, chunk=gc,
                                             width=w, k=k))
        assert want == int(jtc.count_hub_groups(
            jrows, jnp.asarray(b_ids.numpy()), jnp.asarray(nbrs.numpy()),
            chunk=gc, width=w, k=k))
        got, words_read = replay_hub_groups(rows, b_ids, nbrs, w)
        assert got == want
        gated += words_read
        plain_words += nbrs.numel() * w
        # stream: the plan's live counts end each group's non-guard slots
        past = torch.arange(k)[None, :] >= live.long()[:, None]
        assert bool((nbrs[past] == guard).all())
        some = live > 0
        assert bool((nbrs[some, live[some].long() - 1] != guard).all())
        assert live.dtype == torch.int32 and int(live.max()) <= k
        got, _ = replay_hub_groups(rows, b_ids, nbrs, w, live)
        assert got == want
        assert int(tc.count_hub_groups_mat(b_mat, a_mat, live=live)) == want
    assert plan.run() == tc.triangle_count_oracle(g)
    assert 0 < gated < plain_words


def test_hub_groups_mat_live_checked(monkeypatch):
    """count_hub_groups_mat takes live counts of int32[G]; under
    GMS_TPU_PARANOID=1 a non-zero slot past its live count is refused."""
    b = torch.ones((2, 4), dtype=torch.int32)
    a = torch.ones((2, 3, 4), dtype=torch.int32)
    with pytest.raises(TypeError, match="live"):
        tc.count_hub_groups_mat(b, a, live=torch.ones(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="live counts"):
        tc.count_hub_groups_mat(b, a, live=torch.ones(3, dtype=torch.int32))
    live = torch.tensor([3, 1], dtype=torch.int32)
    assert int(tc.count_hub_groups_mat(b, a, live=live)) == 2 * 3 * 4
    monkeypatch.setenv("GMS_TPU_PARANOID", "1")
    with pytest.raises(ValueError, match="live count"):
        tc.count_hub_groups_mat(b, a, live=live)
    a[1, 1:] = 0
    assert int(tc.count_hub_groups_mat(b, a, live=live)) == 16


def test_trial_adds_every_launch_into_one_total():
    """The trial's four wrappers add their sums into a given `out` (one
    running total a trial, in both modes) and return it; an `out` of
    another dtype or shape is refused."""
    g = build_csr(generate_rmat_el(9, 16, seed=5), num_nodes=512)
    want = tc.triangle_count_oracle(g)
    for mat in (True, False):
        plan = tc.TrianglePlan(g, device="cpu", hub_threshold=8,
                               materialize=mat)
        assert plan.hub and plan.run() == want
    total = torch.zeros((), dtype=torch.int64)
    res = plan.run_async(out=total)
    assert all(r is total for r in res) and int(total) == want
    assert int(sum(plan.run_async())) == want
    w, k, gc, b, n = plan.hub[0]
    one = tc.count_hub_groups(plan.hub_rows, b, n, chunk=gc, width=w, k=k)
    acc = torch.tensor(5, dtype=torch.int64)
    assert tc.count_hub_groups(plan.hub_rows, b, n, chunk=gc, width=w, k=k,
                               out=acc) is acc
    assert int(acc) == 5 + int(one)
    for bad in (torch.zeros(1, dtype=torch.int64),
                torch.zeros((), dtype=torch.int32)):
        with pytest.raises(TypeError, match="out"):
            tc.count_hub_groups(plan.hub_rows, b, n, chunk=gc, width=w, k=k,
                                out=bad)
