"""The port's multi-device layer (gms_tpu_torch/parallel/) against gms_tpu's
on its 8-device virtual CPU mesh and against the oracles.

* expand_level_plain and total_popcount_plain (K37, K38 on CPU tensors)
  against gms_tpu's jax programs, bit for bit, with cap above and below the
  child count;
* sharded_kclique_count (k = 3, 4, 5 on RMAT-8, and the overflow retry on
  K24 with root_chunk_per_shard=1), device_parallel_map,
  sharded_bron_kerbosch_count over two CPU "devices", sharded_pair_scores
  (Jaccard, bit for bit) and sharded_triangle_count, mirroring
  tests/test_multi.py and the first two tests of tests/test_sharding.py, at
  world size 1;
* the same functions in one spawned gloo world of 2 and one of 4 ranks
  (parallel/world.py), each rank's answers against gms_tpu's.

Counts are exact; so are the Jaccard scores, one IEEE division of exact
integers on both sides.

The spawned ranks import this module to find their function, so jax,
gms_tpu and conftest (which imports jax) are imported only inside the
fixtures and tests that use them: a rank starts with torch and the port.
"""

from math import comb

import numpy as np
import pytest
import torch

from gms_tpu_torch.algorithms import k_clique as kc
from gms_tpu_torch.algorithms.similarity import _deg_lookup
from gms_tpu_torch.graphs.tiles import PaddedGraph
from gms_tpu_torch.io.builder import build_csr
from gms_tpu_torch.io.generators import generate_rmat_el
from gms_tpu_torch.parallel import multi, sharding, world

torch.set_num_threads(1)

KS = (3, 4, 5)
N_PAIRS = 8 * 16


def _graphs():
    """The edge lists of the cases: RMAT-8 (k-cliques), K24 (overflow),
    G(60, 0.2) (BK), G(100, 0.15) and G(60, 0.3) (triangles), G(40, 0.3)
    and its pairs (scores)."""
    from conftest import random_graph

    src, dst = np.nonzero(np.triu(np.ones((24, 24), dtype=bool), 1))
    pairs = np.random.default_rng(0).integers(0, 40, size=(N_PAIRS, 2))
    return {"rmat8": (generate_rmat_el(8, 6, seed=1), 256),
            "k24": (np.stack([src, dst], axis=1).astype(np.int64), 24),
            "bk": (random_graph(60, 0.2, 2), 60),
            "tc": (random_graph(100, 0.15, seed=11), None),
            "tc_small": (random_graph(60, 0.3, seed=12), None),
            "scores": (random_graph(40, 0.3, 3), 40),
            "pairs": (pairs.astype(np.int32), None)}


def _port(el, n):
    return build_csr(el, num_nodes=n) if n else build_csr(el)


def _answers(mesh, cases, devices):
    """Every sharded function of the port on `mesh`, as plain Python."""
    g = {k: _port(*v) for k, v in cases.items() if k != "pairs"}
    out = {"kclique": [multi.sharded_kclique_count(
        g["rmat8"], k, mesh, root_chunk_per_shard=16) for k in KS]}
    out["k24"] = multi.sharded_kclique_count(g["k24"], 5, mesh,
                                             root_chunk_per_shard=1)
    out["tc"] = sharding.sharded_triangle_count(g["tc"], mesh, chunk=64)
    out["tc_small"] = sharding.sharded_triangle_count(g["tc_small"], mesh,
                                                      chunk=32)
    pg = PaddedGraph.from_csr(g["scores"], device=mesh.device)
    pairs = torch.from_numpy(cases["pairs"][0]).to(mesh.device)
    fn = multi.sharded_pair_scores(mesh, metric="jaccard")
    out["scores"] = fn(pg.nbr, _deg_lookup(pg), pairs).cpu().numpy()
    out["bk"] = multi.sharded_bron_kerbosch_count(g["bk"], devices,
                                                  root_chunk=8)
    out["map"] = [int(t) for t in multi.device_parallel_map(
        lambda n, d: torch.arange(n, device=d).sum(), [3, 5, 7], devices)]
    return out


def _rank_answers(mesh, cases):
    """A spawned rank's run (world.spawn_world pickles it by name)."""
    torch.set_num_threads(1)
    got = _answers(mesh, cases, ["cpu", "cpu"])
    assert mesh.staged == {"all_reduce": 0, "all_gather": 0,
                           "send_recv": 0}  # CPU tensors
    return mesh.rank, mesh.size, got


@pytest.fixture(scope="module")
def cases():
    return _graphs()


@pytest.fixture(scope="module")
def want(cases):
    """gms_tpu's answers on its 8-device mesh, and the oracles'."""
    import jax
    import jax.numpy as jnp
    from gms_tpu.algorithms import bron_kerbosch as jbk
    from gms_tpu.algorithms import k_clique as jkc
    from gms_tpu.algorithms import similarity as jvs
    from gms_tpu.algorithms import triangle_count as jtc
    from gms_tpu.graphs.tiles import PaddedGraph as JPaddedGraph
    from gms_tpu.io.builder import build_csr as jbuild_csr
    from gms_tpu.parallel import multi as jmulti
    from gms_tpu.parallel import sharding as jsharding

    jg = {k: jbuild_csr(el, num_nodes=n) if n else jbuild_csr(el)
          for k, (el, n) in cases.items() if k != "pairs"}
    mesh = jsharding.make_mesh()
    assert len(mesh.devices) == 8
    out = {"kclique": [jmulti.sharded_kclique_count(
        jg["rmat8"], k, mesh, root_chunk_per_shard=16) for k in KS]}
    assert out["kclique"] == [jkc.kclique_count_oracle(jg["rmat8"], k)
                              for k in KS]
    out["k24"] = jmulti.sharded_kclique_count(jg["k24"], 5, mesh,
                                              root_chunk_per_shard=1)
    assert out["k24"] == comb(24, 5)
    out["tc"] = jsharding.sharded_triangle_count(jg["tc"], mesh, chunk=64)
    out["tc_small"] = [jsharding.sharded_triangle_count(
        jg["tc_small"], jsharding.make_mesh(n), chunk=32) for n in (1, 2, 4)]
    assert out["tc"] == jtc.triangle_count_oracle(jg["tc"])
    pg = JPaddedGraph.from_csr(jg["scores"])
    fn = jmulti.sharded_pair_scores(mesh, metric="jaccard")
    out["scores"] = np.asarray(fn(pg.nbr, jvs._deg_lookup(pg),
                                  jnp.asarray(cases["pairs"][0])))
    out["bk"] = jmulti.sharded_bron_kerbosch_count(jg["bk"], jax.devices(),
                                                   root_chunk=8)
    assert out["bk"] == len(jbk.bron_kerbosch_simple(jg["bk"]))
    out["map"] = [int(h) for h in jmulti.device_parallel_map(
        lambda n, d: jax.device_put(jnp.arange(n), d).sum(), [3, 5, 7])]
    return out


@pytest.fixture(scope="module")
def mesh():
    return sharding.make_mesh(devices="cpu")


def _assert_answers(got, want):
    assert got["kclique"] == want["kclique"]
    assert got["k24"] == want["k24"] == comb(24, 5)
    assert got["tc"] == want["tc"]
    assert [got["tc_small"]] * 3 == want["tc_small"]
    assert got["scores"].dtype == np.float32
    assert got["scores"].view(np.int32).tolist() == \
        want["scores"].view(np.int32).tolist()
    assert got["bk"] == want["bk"]
    assert got["map"] == want["map"] == [3, 10, 21]


def test_expand_level_plain_equals_gms_tpu():
    import jax.numpy as jnp
    from gms_tpu.algorithms import k_clique as jkc

    rng = np.random.default_rng(0)
    for ww, n, c in ((1, 300, 5), (3, 120, 2)):
        W = 32 * ww
        adj = rng.integers(0, 2**32, (c, W, ww), dtype=np.uint32)
        adj &= rng.integers(0, 2**32, (c, W, ww), dtype=np.uint32)
        s = rng.integers(0, 2**32, (n, ww), dtype=np.uint32)
        s &= rng.integers(0, 2**32, (n, ww), dtype=np.uint32)
        s[::4] = 0
        r = rng.integers(0, c, n).astype(np.int32)
        jout = jkc.expand_level(jnp.asarray(s), jnp.asarray(r),
                                jnp.asarray(adj), cap=1, need=0)
        total = int(jout[2])
        for cap, need in ((total + 100, 2), (total // 3, 2), (0, 3),
                          (total, 0)):
            jS, jR, jn, jp = jkc.expand_level(
                jnp.asarray(s), jnp.asarray(r), jnp.asarray(adj), cap=cap,
                need=need)
            S, R, nc, pc = kc.expand_level(
                torch.from_numpy(s.view(np.int32)), torch.from_numpy(r),
                torch.from_numpy(adj.view(np.int32)), cap=cap, need=need)
            assert np.array_equal(S.numpy().view(np.uint32), np.asarray(jS))
            assert np.array_equal(R.numpy(), np.asarray(jR))
            assert (int(nc), int(pc)) == (int(jn), int(jp))
            assert (int(nc) > cap) == (cap < total // 2)


def test_total_popcount_plain_equals_gms_tpu():
    import jax.numpy as jnp
    from gms_tpu.algorithms import k_clique as jkc

    rng = np.random.default_rng(1)
    for shape in ((0, 3), (1,), (257, 5)):
        x = rng.integers(0, 2**32, shape, dtype=np.uint32)
        got = kc.total_popcount(torch.from_numpy(x.view(np.int32)))
        assert int(got) == int(jkc.total_popcount(jnp.asarray(x)))


def test_world_of_one_equals_gms_tpu(mesh, cases, want):
    assert (mesh.rank, mesh.size, mesh.group) == (0, 1, None)
    stats = {}
    g = _port(*cases["k24"])
    assert multi.sharded_kclique_count(g, 5, mesh, root_chunk_per_shard=1,
                                       stats=stats) == comb(24, 5)
    assert stats["chunks"] == 20 and stats["doublings"] > 0
    _assert_answers(_answers(mesh, cases, ["cpu", "cpu"]), want)


def test_small_k_and_empty_graphs(mesh):
    g = _port(*_graphs()["tc_small"])
    assert multi.sharded_kclique_count(g, 1, mesh) == g.num_nodes
    assert multi.sharded_kclique_count(g, 2, mesh) == g.num_edges_undirected
    assert multi.sharded_kclique_count(build_csr(np.array([[0, 1]])), 3,
                                       mesh) == 0
    empty = build_csr(np.zeros((0, 2), np.int64), num_nodes=0)
    assert multi.sharded_bron_kerbosch_count(empty, ["cpu"]) == 0


def test_make_mesh_checks():
    one = sharding.make_mesh(devices="cpu")
    assert (one.group, one.rank, one.size) == (None, 0, 1)
    with pytest.raises(ValueError, match="1 ranks"):
        sharding.make_mesh(devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="evenly"):
        sharding.shard_rows(torch.zeros(3), sharding.Mesh(None, 0, 2, "cpu"))
    assert sharding.make_mesh(devices=["cpu"]).device == torch.device("cpu")
    if not torch.cuda.is_available():
        for call in (sharding.make_mesh, lambda: multi.device_parallel_map(
                lambda j, d: j, [1]), lambda: multi.sharded_bron_kerbosch_count(
                    _port(*_graphs()["bk"]))):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()


@pytest.mark.parametrize("size", [2, 4])
def test_gloo_world_equals_gms_tpu(cases, want, size):
    ranks = world.spawn_world(_rank_answers, size, cases, backend="gloo",
                              devices="cpu")
    assert [(r, s) for r, s, _ in ranks] == [(r, size) for r in range(size)]
    for _, _, got in ranks:
        _assert_answers(got, want)


@pytest.mark.parametrize("scale", [8, 9])
def test_expand_level_live_count_equals_gms_tpu(scale):
    """K37's live count on the levels of a k=5 expansion of RMAT-8 and
    RMAT-9 roots: with and without n_live, each level equals gms_tpu's
    expand_level (S_out, R_out, n_children, pcs), at a cap up to four times
    the survivors (the next level's rows mostly zero, as after cap
    doublings; gms_tpu's takes at most N·W) and at a cap below them."""
    import jax.numpy as jnp
    from gms_tpu.algorithms import k_clique as jkc
    from gms_tpu_torch.preprocessing import degeneracy, orient

    g = build_csr(generate_rmat_el(scale, 16, seed=27491095),
                  num_nodes=1 << scale)
    rank, _ = degeneracy.degeneracy_ordering_rank(g)
    dag = orient.orient(g, rank)
    pg = PaddedGraph.from_csr(dag, device="cpu", lane=32)
    ww = pg.d_pad // 32
    roots = np.nonzero(np.asarray(dag.degrees) >= 4)[0][:64]
    adj, S = kc.build_local_adj(
        pg.nbr, torch.from_numpy(roots.astype(np.int32)), w_words=ww)
    R = torch.arange(len(roots), dtype=torch.int32)
    jadj = jnp.asarray(adj.numpy().view(np.uint32))
    n = None
    for need in (3, 2, 1):
        total = int(kc.expand_level(S, R, adj, cap=0, need=need,
                                    n_live=n)[2])
        assert total > 3
        big = min(4 * total, S.shape[0] * 32 * ww)
        for cap in (big, total // 3):
            jS, jR, jn, jp = jkc.expand_level(
                jnp.asarray(S.numpy().view(np.uint32)), jnp.asarray(R.numpy()),
                jadj, cap=cap, need=need)
            for live in (None, n):
                got = kc.expand_level(S, R, adj, cap=cap, need=need,
                                      n_live=live)
                assert np.array_equal(got[0].numpy().view(np.uint32),
                                      np.asarray(jS))
                assert np.array_equal(got[1].numpy(), np.asarray(jR))
                assert (int(got[2]), int(got[3])) == (int(jn), int(jp))
        live_rows = (S != 0).any(1).nonzero().reshape(-1)
        assert n is None or int(live_rows.max()) < int(n) < S.shape[0] // 2
        S, R, n, _ = kc.expand_level(S, R, adj, cap=big, need=need,
                                     n_live=n)


@pytest.mark.parametrize("k", [4, 5, 6])
def test_sharded_kclique_doublings_equal_gms_tpu(mesh, cases, k,
                                                 monkeypatch):
    """sharded_kclique_count at world size 1, the levels handed their live
    counts, against gms_tpu's on a one-device mesh and the oracle, with as
    many runs: each chunk once plus its cap doublings; the port builds each
    chunk's local adjacency once, before its doublings."""
    from gms_tpu.algorithms import k_clique as jkc
    from gms_tpu.io.builder import build_csr as jbuild_csr
    from gms_tpu.parallel import multi as jmulti
    from gms_tpu.parallel import sharding as jsharding

    el, n = cases["rmat8"]
    runs = []
    step = jmulti._sharded_kclique_step

    def counted(*args, **kw):
        runs.append(kw["caps"])
        return step(*args, **kw)

    monkeypatch.setattr(jmulti, "_sharded_kclique_step", counted)
    builds = []
    build = multi.build_local_adj
    monkeypatch.setattr(multi, "build_local_adj", lambda *a, **kw: (
        builds.append(kw["w_words"]), build(*a, **kw))[1])
    jg = jbuild_csr(el, num_nodes=n)
    want = jmulti.sharded_kclique_count(jg, k, jsharding.make_mesh(1),
                                        root_chunk_per_shard=8)
    assert want == jkc.kclique_count_oracle(jg, k)
    stats = {}
    got = multi.sharded_kclique_count(_port(el, n), k, mesh,
                                      root_chunk_per_shard=8, stats=stats)
    assert got == want
    first = sum(c == runs[0] for c in runs)  # each chunk's first run
    assert (stats["chunks"], stats["doublings"]) == (first, len(runs) - first)
    assert (stats["doublings"] > 0) == (k > 4)
    assert len(builds) == stats["chunks"]
