"""The port's sharded plans (gms_tpu_torch/parallel/sharding.py) against
gms_tpu's on its virtual CPU mesh and against the host oracles.

* K39's plain version (member_pack_plain): the ring-built local adjacency
  and cover bitsets of every root, the N visiting shards folded in one
  process (N = 1, 2, 4), equal gms_tpu's build_local_adj and
  _hub_cover_bits bit for bit, on RMAT-9 and two random graphs;
* K40's plain version (count_dag_edges_cross) against gms_tpu's
  sets.ops.intersect_count summed over the same row pairs;
* kc_stack_machine and kclique_count_chunk against gms_tpu's at k = 3..7;
* the host layouts (_hash_owner_layout, the triangle plan's edge buckets,
  roots_pad, BK's ltable, the table, edge and id-map bytes and both
  shard_work_models) equal gms_tpu's at N = 1, 2, 4;
* tests/test_sharding.py's nine tests (subset meshes and table-bytes shrink
  checks included) at world size 1 and in one spawned gloo world of 2 and
  one of 4 ranks (parallel/world.py), each rank's counts against the
  oracles, and on RMAT-8 against gms_tpu's own plans on its mesh of the
  same N;
* dryrun_multichip(2) on the CPU.

Counts are exact. The spawned ranks import this module to find their
function, so jax, gms_tpu and conftest (which imports jax) are imported
only inside the fixtures and tests that use them: a rank starts with torch
and the port.
"""

import numpy as np
import pytest
import torch

from gms_tpu_torch.algorithms import k_clique as kc
from gms_tpu_torch.algorithms import triangle_count as tc
from gms_tpu_torch.graphs.tiles import SENTINEL
from gms_tpu_torch.io.builder import build_csr
from gms_tpu_torch.io.generators import generate_rmat_el
from gms_tpu_torch.parallel import dryrun, sharding, world
from gms_tpu_torch.preprocessing import degeneracy, orient

torch.set_num_threads(1)

SIZES = (1, 2, 4)
CPU = torch.device("cpu")


def _rmat(scale, seed):
    return generate_rmat_el(scale, 8, seed=seed), 1 << scale


def _graphs():
    """The edge lists of tests/test_sharding.py's cases (its RMAT-10 ones
    and the rest as there), and RMAT-8 for gms_tpu's own plans."""
    from conftest import random_graph

    return {
        "tc100": (random_graph(100, 0.15, seed=11), None),
        "tc60": (random_graph(60, 0.3, seed=12), None),
        "rmat9_5": _rmat(9, 5), "rmat10_5": _rmat(10, 5),
        "rmat10_7": _rmat(10, 7), "rmat9_7": _rmat(9, 7),
        "rmat9_9": _rmat(9, 9), "rmat8": _rmat(8, 5),
        "tcr": [(random_graph(n, p, seed=s), None)
                for n, p, s in ((50, 0.3, 1), (111, 0.1, 2), (200, 0.05, 3))],
        "bkr": [(random_graph(n, p, seed=s), None)
                for n, p, s in ((40, 0.3, 1), (90, 0.12, 2), (150, 0.05, 3))],
    }


def _build(el, n, build=build_csr):
    return build(el, num_nodes=n) if n else build(el)


def _plans8(g, mesh, pkg):
    """The five plans on RMAT-8, as gms_tpu's dry run calls them."""
    return [pkg.VertexShardedTrianglePlan(g, mesh, chunk=64).run(),
            pkg.ShardedTrianglePlan(g, mesh, hub_threshold=8).run(),
            pkg.VertexShardedKCliquePlan(g, mesh, k=4, root_chunk=16).run(),
            pkg.VertexShardedKCliquePlan(g, mesh, k=6, root_chunk=16).run(),
            pkg.VertexShardedBKPlan(g, mesh, root_chunk=16,
                                    batch=64).run()]


def _answers(mesh, cases):
    """Every plan of the port on `mesh`, as plain Python."""
    g = {k: _build(*v) for k, v in cases.items() if k not in ("tcr", "bkr")}
    out = {"tc100": sharding.sharded_triangle_count(g["tc100"], mesh,
                                                    chunk=64)}
    subs = [sharding.make_mesh(n, devices=mesh.device) for n in SIZES
            if n <= mesh.size]
    out["tc60"] = [sharding.sharded_triangle_count(g["tc60"], s, chunk=32)
                   for s in subs if s is not None]
    for key, thr in (("rmat9_5", 8), ("rmat10_5", 65)):
        p = sharding.ShardedTrianglePlan(g[key], mesh, hub_threshold=thr)
        # the steady trials on the smaller graph only (plain compares)
        steady = p.run_steady(trials=3)[0] if thr == 8 else p.run()
        out["tuned_" + key] = (p.run(), steady,
                               p.shard_work_model().tolist())
    out["vstc"] = sharding.VertexShardedTrianglePlan(
        g["rmat10_5"], mesh, chunk=64).run()
    out["vstc_steady"] = sharding.VertexShardedTrianglePlan(
        g["rmat9_5"], mesh, chunk=64).run_steady(trials=2)[0]
    out["vstc_random"] = [sharding.VertexShardedTrianglePlan(
        _build(*c), mesh, chunk=32).run() for c in cases["tcr"]]
    out["kc"] = [sharding.VertexShardedKCliquePlan(g["rmat10_7"], mesh,
                                                   k=k).run()
                 for k in (3, 4, 5)]
    out["kc67"] = [sharding.VertexShardedKCliquePlan(g["rmat9_7"], mesh,
                                                     k=k).run()
                   for k in (6, 7)]
    out["bk"] = sharding.VertexShardedBKPlan(g["rmat9_9"], mesh).run()
    out["bk_random"] = [sharding.VertexShardedBKPlan(
        _build(*c), mesh, root_chunk=32, batch=64).run()
        for c in cases["bkr"]]
    out["rmat8"] = _plans8(g["rmat8"], mesh, sharding)
    out["bytes"] = _table_bytes(g, mesh)
    one = sharding.make_mesh(1, devices=mesh.device)
    if one is not None:
        out["bytes_one"] = _table_bytes(g, one)
    out["staged"] = dict(mesh.staged)
    return out


def _table_bytes(g, mesh):
    """table_bytes_per_device of the three vertex-sharded plans (their
    constructors make no collective call)."""
    return [sharding.VertexShardedTrianglePlan(
                g["rmat10_5"], mesh, chunk=64).table_bytes_per_device,
            sharding.VertexShardedKCliquePlan(
                g["rmat10_7"], mesh, k=3).table_bytes_per_device,
            sharding.VertexShardedKCliquePlan(
                g["rmat9_7"], mesh, k=6).table_bytes_per_device,
            sharding.VertexShardedBKPlan(
                g["rmat9_9"], mesh).table_bytes_per_device]


def _rank_answers(mesh, cases):
    """A spawned rank's run (world.spawn_world pickles it by name)."""
    torch.set_num_threads(1)
    return mesh.rank, mesh.size, _answers(mesh, cases)


@pytest.fixture(scope="module")
def cases():
    return _graphs()


@pytest.fixture(scope="module")
def want(cases):
    """The oracles' counts, and gms_tpu's plans on RMAT-8 at each N."""
    from gms_tpu.algorithms import bron_kerbosch as jbk
    from gms_tpu.algorithms import k_clique as jkc
    from gms_tpu.algorithms import triangle_count as jtc
    from gms_tpu.io.builder import build_csr as jbuild
    from gms_tpu.parallel import sharding as jsh

    g = {k: _build(*v, build=jbuild) for k, v in cases.items()
         if k not in ("tcr", "bkr")}
    out = {"tc100": jtc.triangle_count_oracle(g["tc100"]),
           "tc60": jtc.triangle_count_oracle(g["tc60"]),
           "rmat9_5": jtc.triangle_count_oracle(g["rmat9_5"]),
           "rmat10_5": jtc.triangle_count_oracle(g["rmat10_5"]),
           "vstc_random": [jtc.triangle_count_oracle(_build(*c, build=jbuild))
                           for c in cases["tcr"]],
           "kc": [jkc.kclique_count_oracle(g["rmat10_7"], k)
                  for k in (3, 4, 5)],
           "kc67": [jkc.kclique_count_oracle(g["rmat9_7"], k)
                    for k in (6, 7)],
           "bk": len(jbk.bron_kerbosch_simple(g["rmat9_9"])),
           "bk_random": [len(jbk.bron_kerbosch_simple(_build(*c,
                                                             build=jbuild)))
                         for c in cases["bkr"]]}
    out["rmat8"] = {n: _plans8(g["rmat8"], jsh.make_mesh(n), jsh)
                    for n in SIZES}
    g8 = g["rmat8"]
    tri = jtc.triangle_count_oracle(g8)
    oracle = [tri, tri, jkc.kclique_count_oracle(g8, 4),
              jkc.kclique_count_oracle(g8, 6),
              len(jbk.bron_kerbosch_simple(g8))]
    assert all(v == oracle for v in out["rmat8"].values())
    return out


def _assert_answers(got, want, size):
    assert got["tc100"] == want["tc100"]
    assert got["tc60"] and set(got["tc60"]) == {want["tc60"]}
    for key in ("rmat9_5", "rmat10_5"):
        run, steady, work = got["tuned_" + key]
        assert run == steady == want[key]
        assert len(work) == size and sum(work) > 0
    assert got["vstc"] == want["rmat10_5"]
    assert got["vstc_steady"] == want["rmat9_5"]
    for key in ("vstc_random", "kc", "kc67", "bk", "bk_random"):
        assert got[key] == want[key], key
    assert got["rmat8"] == want["rmat8"][size]
    if size > 1:
        assert got["staged"] == {"all_reduce": 0, "all_gather": 0,
                                 "send_recv": 0}  # CPU tensors


def _assert_shrinks(got, size):
    """gms_tpu's shrink checks (test_sharding.py:60-147): a device's table
    at N against the table of a mesh of one."""
    mine, whole = got["bytes"], got["bytes_one"]
    if size == 1:
        assert mine == whole
        return
    for m, w in zip(mine, whole):
        assert m <= w / (1.8 if size == 2 else size / 2)


# ---------------------------------------------------------------------------
# the plans: world size 1, and spawned gloo worlds of 2 and 4
# ---------------------------------------------------------------------------

def test_world_of_one(cases, want):
    mesh = sharding.make_mesh(devices="cpu")
    assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)
    got = _answers(mesh, cases)
    _assert_answers(got, want, 1)
    _assert_shrinks(got, 1)


@pytest.mark.parametrize("size", [2, 4])
def test_gloo_world(cases, want, size):
    ranks = world.spawn_world(_rank_answers, size, cases, backend="gloo",
                              devices="cpu")
    assert [(r, s) for r, s, _ in ranks] == [(r, size) for r in range(size)]
    for rank, _, got in ranks:
        _assert_answers(got, want, size)
        assert ("bytes_one" in got) == (rank == 0)
    _assert_shrinks(ranks[0][2], size)


@pytest.mark.parametrize("n", [2, 4])
def test_ring_hops_between_rotations(monkeypatch, n):
    """A ring pass makes N-1 hops, none after its last rotation. With the
    hops played in one process from the whole table (each returns the shard
    one owner on), the N ranks' partial counts of each ring plan sum to the
    oracle's."""
    from gms_tpu_torch.algorithms import bron_kerbosch as bk

    g = _build(*_rmat(8, 5))
    kinds = (
        (lambda m: sharding.VertexShardedTrianglePlan(g, m, chunk=64),
         orient.degree_rank(g), 128, tc.triangle_count_oracle(g)),
        (lambda m: sharding.VertexShardedKCliquePlan(g, m, k=4,
                                                     root_chunk=16),
         degeneracy.degeneracy_ordering_rank(g)[0], 32,
         kc.kclique_count_oracle(g, 4)),
        (lambda m: sharding.VertexShardedBKPlan(g, m, root_chunk=16),
         degeneracy.degeneracy_ordering_rank(g)[0], 32,
         len(bk.bron_kerbosch_simple(g))))
    monkeypatch.setattr(sharding, "psum", lambda t, mesh: t)
    for make, rank, lane, oracle in kinds:
        nbr = sharding._host_nbr(orient.orient(g, rank), lane=lane)
        shards = list(torch.from_numpy(sharding._hash_owner_layout(nbr, n)[0]))
        total = 0
        for d in range(n):
            plan = make(sharding.Mesh(None, d, n, CPU))
            hops = []

            def hop(t, mesh, d=d):
                s = next((i for i, x in enumerate(shards)
                          if x.data_ptr() == t.data_ptr()), d)
                hops.append(s)
                return shards[(s + 1) % n]

            monkeypatch.setattr(sharding, "ppermute", hop)
            passes = (1 if isinstance(plan, sharding.VertexShardedTrianglePlan)
                      else len(plan._chunks()))
            total += int(plan._count().reshape(-1)[0])
            assert hops == [(d + t) % n for t in range(n - 1)] * passes
        assert total == oracle > 0


def test_dryrun_multichip_on_the_cpu():
    ranks = dryrun.dryrun_multichip(2, devices="cpu")
    assert len(ranks) == 2 and ranks[0]["triangles"] == 464
    assert {k: v for k, v in ranks[0].items()
            if k not in ("table_bytes", "staged")} == \
        {k: v for k, v in ranks[1].items() if k != "staged"}
    for mine, whole in ranks[0]["table_bytes"].values():
        assert mine < whole


# ---------------------------------------------------------------------------
# host layouts against gms_tpu's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", SIZES)
def test_host_layouts_equal_gms_tpu(cases, n):
    from gms_tpu.io.builder import build_csr as jbuild
    from gms_tpu.parallel import sharding as jsh

    el, nn = cases["rmat9_5"]
    g, jg = build_csr(el, num_nodes=nn), jbuild(el, num_nodes=nn)
    jmesh = jsh.make_mesh(n)
    mesh = sharding.Mesh(None, 0, n, CPU)   # the layouts need no group
    dag = orient.orient(g, orient.degree_rank(g))
    nbr = sharding._host_nbr(dag)
    mine, theirs = sharding._hash_owner_layout(nbr, n), \
        jsh._hash_owner_layout(nbr, n)
    for a, b in zip(mine[:3], theirs[:3]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert mine[3] == theirs[3]

    jp = jsh.VertexShardedTrianglePlan(jg, jmesh, chunk=64)
    p = sharding.VertexShardedTrianglePlan(g, mesh, chunk=64)
    eb, vb, model = sharding._edge_buckets(
        dag.edge_array(), mine[1], mine[2], n, 64, nbr.shape[1])
    assert np.array_equal(eb, np.asarray(jp._args[1]))
    assert np.array_equal(vb, np.asarray(jp._args[2]))
    assert np.array_equal(model, jp.shard_work_model())
    assert np.array_equal(p.shard_work_model(), jp.shard_work_model())
    assert (p.table_bytes_per_device, p.edge_bytes_per_device) == \
        (jp.table_bytes_per_device, jp.edge_bytes_per_device)
    assert np.array_equal(p._own.numpy(), np.asarray(jp._args[0])[0])

    for k in (4, 6):
        jk = jsh.VertexShardedKCliquePlan(jg, jmesh, k=k, root_chunk=16)
        pk = sharding.VertexShardedKCliquePlan(g, mesh, k=k, root_chunk=16)
        assert np.array_equal(pk._roots.numpy(), np.asarray(jk._args[1])[0])
        assert (pk.table_bytes_per_device, pk.idmap_bytes_per_device) == \
            (jk.table_bytes_per_device, jk.idmap_bytes_per_device)
    jb = jsh.VertexShardedBKPlan(jg, jmesh, root_chunk=16)
    for d in range(n):
        pb = sharding.VertexShardedBKPlan(g, sharding.Mesh(None, d, n, CPU),
                                          root_chunk=16)
        assert np.array_equal(pb._own.numpy(), np.asarray(jb._args[0])[d])
        assert np.array_equal(pb._lown.numpy(), np.asarray(jb._args[1])[d])
        assert np.array_equal(pb._roots.numpy(), np.asarray(jb._args[2])[d])
    assert (pb.table_bytes_per_device, pb.idmap_bytes_per_device) == \
        (jb.table_bytes_per_device, jb.idmap_bytes_per_device)

    jt = jsh.ShardedTrianglePlan(jg, jmesh, hub_threshold=8)
    pt = sharding.ShardedTrianglePlan(g, mesh, hub_threshold=8)
    assert np.array_equal(pt.shard_work_model(), jt.shard_work_model())
    for mine_t, theirs_t in zip(pt.tiers, jt.tiers):
        assert mine_t[:3] == theirs_t[:3]
        assert np.array_equal(mine_t[3], np.asarray(theirs_t[3]))
        assert np.array_equal(mine_t[4], np.asarray(theirs_t[4]))
    assert len(pt.hubs) == len(jt.hubs) > 0


# ---------------------------------------------------------------------------
# K39 and K40's plain versions, kc_stack_machine
# ---------------------------------------------------------------------------

def _universe_graphs():
    from conftest import random_graph

    return {"rmat9": _rmat(9, 3), "g80": (random_graph(80, 0.2, seed=4), 80),
            "g130": (random_graph(130, 0.08, seed=5), 130)}


@pytest.fixture(scope="module")
def universes():
    """gms_tpu's local adjacency, candidates and cover bitsets of every
    vertex of each graph (build_local_adj, _hub_cover_bits), and the port's
    graph, rank and ring table width."""
    import jax.numpy as jnp
    from gms_tpu.algorithms import bron_kerbosch as jbk
    from gms_tpu.algorithms import k_clique as jkc
    from gms_tpu.graphs.tiles import PaddedGraph as JPaddedGraph
    from gms_tpu.io.builder import build_csr as jbuild

    out = {}
    for name, (el, n) in _universe_graphs().items():
        g, jg = build_csr(el, num_nodes=n), jbuild(el, num_nodes=n)
        rank, _ = degeneracy.degeneracy_ordering_rank(g)
        jpg = JPaddedGraph.from_csr(orient.orient(jg, rank), lane=32)
        ww = jpg.nbr.shape[1] // 32
        roots = jnp.arange(n, dtype=jnp.int32)
        adj, s0 = jkc.build_local_adj(jpg.nbr, roots, w_words=ww)
        lo_indptr, lo_cols = jbk._lower_neighbor_csr(jg, rank)
        indeg = np.diff(lo_indptr)
        inp = -(-max(int(indeg.max(initial=1)), 1) // 32) * 32
        wl = jbk._gather_wlists(jnp.asarray(lo_indptr), jnp.asarray(lo_cols),
                                roots, in_width=inp)
        M, _ = jbk._hub_cover_bits(jpg.nbr, roots, wl, w_words=ww,
                                   i_block=32)
        out[name] = (g, rank, np.asarray(adj), np.asarray(s0), np.asarray(M))
    return out


def _ring_built(plan, table, rc, lower=None):
    """One chunk's universe on rank plan.mesh.rank, the N visiting shards
    taken from the whole `table` (and `lower`, BK's lower-neighbour table)
    in one process: (live, adj, S0[, M])."""
    N, me = plan.n_devices, plan.mesh.rank
    live, q, valid, owner, locs, adj = plan._universe(rc)
    packs = [(owner, locs, valid, adj)]
    if lower is not None:
        _, wl = plan._root_rows(rc, plan._lown)
        w_owner, w_locs = plan._lookup(wl)
        M = torch.zeros((q.shape[0], wl.shape[1], plan.w_words),
                        dtype=torch.int32)
        packs.append((w_owner, w_locs, wl != int(SENTINEL), M))
    for t in range(N):
        vis = torch.from_numpy(table[(me + t) % N])
        for o, lc, v, out in packs:
            kc.member_pack(q, vis, lc, v & (o == (me + t) % N), out)
    return (live, adj, kc.pack_bits(valid)) + (() if lower is None else (M,))


@pytest.mark.parametrize("n", SIZES)
def test_ring_built_universes_equal_gms_tpu(universes, n):
    for name, (g, rank, adj, s0, M) in universes.items():
        seen = 0
        for d in range(n):
            plan = sharding.VertexShardedBKPlan(
                g, sharding.Mesh(None, d, n, CPU), rank=rank, root_chunk=32)
            nbr = sharding._host_nbr(orient.orient(g, rank), lane=32)
            table, owner, loc, vs = sharding._hash_owner_layout(nbr, n)
            lower, _ = sharding._lower_table(g, rank, owner, loc, n, vs,
                                             nbr.shape[0])
            for rc in plan._chunks():
                live, a, s, m = _ring_built(plan, table, rc, lower)
                ids = rc[live].long().numpy()
                assert not a[~live].any() and not m[~live].any()
                a, s, m = (x[live].numpy().view(np.uint32) for x in (a, s, m))
                assert np.array_equal(a, adj[ids]), (name, n, d)
                assert np.array_equal(s, s0[ids]), (name, n, d)
                assert np.array_equal(m, M[ids]), (name, n, d)
                seen += len(ids)
        assert seen == g.num_nodes


def test_count_dag_edges_cross_plain_equals_intersect_count():
    import jax.numpy as jnp
    from gms_tpu.sets import ops as jops

    rng = np.random.default_rng(7)

    def rows(V, D):
        out = np.full((V, D), SENTINEL, np.int32)
        for v in range(V):
            k = int(rng.integers(0, D + 1))
            out[v, :k] = np.sort(rng.choice(300, size=k, replace=False))
        return out

    a, b = rows(50, 40), rows(70, 24)
    E = 600
    edges = np.stack([rng.integers(0, 50, E), rng.integers(0, 70, E)],
                     1).astype(np.int32)
    valid = (rng.random(E) < 0.8).astype(np.int32)
    for wa, wb, method in ((None, None, "compare"), (16, 24, "compare"),
                           (40, 8, "auto")):
        ja, jb = a[:, :wa or 40], b[:, :wb or 24]
        cnt = jops.intersect_count(jnp.asarray(ja[edges[:, 0]]),
                                   jnp.asarray(jb[edges[:, 1]]))
        want = int(np.sum(np.asarray(cnt, np.int64) * valid))
        got = tc.count_dag_edges_cross(
            *(torch.from_numpy(x) for x in (a, b, edges, valid)),
            chunk=128, method=method, width_a=wa, width_b=wb)
        assert int(got) == want > 0


def test_kc_stack_machine_equals_gms_tpu(universes):
    import jax.numpy as jnp
    from gms_tpu.algorithms import k_clique as jkc
    from gms_tpu.graphs.tiles import PaddedGraph as JPaddedGraph
    from gms_tpu.io.builder import build_csr as jbuild

    g, rank, *_ = universes["rmat9"]
    n = 2
    plan = sharding.VertexShardedKCliquePlan(
        g, sharding.Mesh(None, 1, n, CPU), k=3, rank=rank, root_chunk=64)
    nbr = sharding._host_nbr(orient.orient(g, rank), lane=32)
    table = sharding._hash_owner_layout(nbr, n)[0]
    rc = plan._chunks()[0].clone()
    rc[-5:] = -1                          # pad roots: adj = 0, S0 = 0
    _, adj, s0 = _ring_built(plan, table, rc)
    ww = plan.w_words
    chunk = torch.where(rc >= 0, rc, plan.v_pad)
    el, nn = _universe_graphs()["rmat9"]
    jnbr = JPaddedGraph.from_csr(orient.orient(jbuild(el, num_nodes=nn),
                                               rank), lane=32).nbr
    dummy = (jnp.zeros((1, 1), jnp.uint32), jnp.int32(0), jnp.int64(0))
    for k in range(3, 8):
        tot, ovf, done, st = jkc.kc_stack_machine(
            jnp.asarray(adj.numpy().view(np.uint32)),
            jnp.asarray(s0.numpy().view(np.uint32)), dummy, w_words=ww, k=k,
            cap=1 << 12, batch=64)
        assert not bool(ovf) and bool(done)
        got = kc.kc_stack_machine(adj, s0, k=k, cap=1 << 12, batch=64)
        assert got[1:] == (False, True, None)
        assert int(got[0]) == int(tot) > 0, k
        jtot = jkc.kclique_count_chunk(
            jnbr, jnp.asarray(chunk.numpy()), dummy, w_words=ww, k=k,
            cap=1 << 12, batch=64)[0]
        mine = kc.kclique_count_chunk(torch.from_numpy(nbr), chunk,
                                      w_words=ww, k=k)
        assert int(mine[0]) == int(jtot) == int(tot), k
    with pytest.raises(ValueError, match="w_words"):
        kc.kc_stack_machine(adj, s0, k=5, w_words=ww + 1)
