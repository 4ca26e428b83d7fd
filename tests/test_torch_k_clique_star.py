"""k-clique-star listing in the PyTorch port against gms_tpu and the oracle.

* host planning (the padded undirected graph, rank_pad and gms_tpu's job
  list, :446-464) against gms_tpu's arrays;
* each kernel's plain PyTorch version (what the wrapper runs on CPU
  tensors) against its gms_tpu jax program on the same inputs, carried
  across by convert.py (tensor_from_numpy and padded_from_numpy suffice for
  nbr, rank_pad and a job's chunk): build_local_univ in both of gms_tpu's
  branches, star_stack's count against star_fused_chunk's scalars for
  k = 2 ... 6 and its emitted rows against gms_tpu's OUT rows as sorted
  sets, decode_star_rows;
* kclique_star_list(device="cpu") against gms_tpu's kclique_star_list and
  the oracle, mirroring tests/test_k_clique_star.py case for case, and the
  identity star_total(k) = (k+1) · #K_{k+1} (the star of a k-clique is the
  set of vertices that extend it to a (k+1)-clique).

Every comparison is exact (integers and bit words, tolerance 0). Arrays
that depend on the order are compared under one rank, gms_tpu's. The CUDA
kernels are held against these plain versions on the card by chip_smoke.py
and by the `cuda`-marked tests of test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gms_tpu.algorithms import k_clique as jkc
from gms_tpu.algorithms import k_clique_star as jks
from gms_tpu.graphs.tiles import PaddedGraph as JPaddedGraph
from gms_tpu.io.builder import build_csr as jbuild_csr
from gms_tpu.preprocessing import degeneracy as jdg

from gms_tpu_torch.algorithms import k_clique as kc
from gms_tpu_torch.algorithms import k_clique_star as ks
from gms_tpu_torch.convert import padded_from_numpy, tensor_from_numpy
from gms_tpu_torch.graphs.tiles import SENTINEL
from gms_tpu_torch.io.builder import build_csr
from gms_tpu_torch.io.generators import generate_rmat_el

from conftest import random_graph

torch.set_num_threads(1)

SEED = 27491095
INT32_MAX = np.iinfo(np.int32).max


def both(el, n=None):
    return build_csr(el, num_nodes=n), jbuild_csr(el, num_nodes=n)


def rmat(scale, deg=16, seed=SEED):
    return both(generate_rmat_el(scale, deg, seed=seed), 1 << scale)


def complete_graph_el(n):
    src, dst = np.nonzero(np.triu(np.ones((n, n), dtype=bool), 1))
    return np.stack([src, dst], axis=1).astype(np.int64)


def canon(pairs):
    return sorted((tuple(sorted(c)), tuple(sorted(s))) for c, s in pairs)


def t(a):
    return tensor_from_numpy(a, device="cpu")


def bits(x):
    return x.numpy().view(np.uint32)


def row_set(rows):
    return sorted(map(tuple, np.asarray(rows).view(np.uint32).tolist()))


class JaxStar:
    """gms_tpu's planning of kclique_star_list under `rank` (:404-464): its
    padded undirected graph, rank_pad and [(chunk, WW)] jobs."""

    def __init__(self, jg, k, rank, root_chunk=ks.DEFAULT_ROOT_CHUNK):
        self.jpg = JPaddedGraph.from_csr(jg, lane=32)
        self.rank_pad = np.full(self.jpg.v_pad + 1, INT32_MAX, np.int32)
        self.rank_pad[:jg.num_nodes] = rank
        deg_all = np.asarray(jg.degrees)
        roots_all = np.nonzero(deg_all >= k - 1)[0].astype(np.int32)
        pad_id = np.int32(self.jpg.v_pad)
        D = self.jpg.d_pad
        self.jobs = []
        for tchunk, ww in jkc.plan_tier_chunks(
                deg_all, roots_all, pad_id, root_chunk=root_chunk,
                mem_budget_words=1 << 24):
            csub = max(4, min(len(tchunk), (1 << 27) // max(32 * ww * D, 1)))
            csub = 1 << int(np.log2(csub))
            for s in range(0, len(tchunk), csub):
                sub = np.ascontiguousarray(tchunk[s:s + csub])
                if not np.all(sub == pad_id):
                    self.jobs.append((sub, ww))

    def univ(self, chunk, ww):
        return jks.build_local_univ(self.jpg.nbr, jnp.asarray(self.rank_pad),
                                    jnp.asarray(chunk), w_words=ww)

    def fused(self, chunk, ww, k, emit=False):
        """gms_tpu's star_fused_chunk with kclique_star_list's plan (:415-
        426): ((n_cliques, star_total), OUT[:op] or None)."""
        C, W = len(chunk), 32 * ww
        batch = 4096 if W >= 128 else 1024
        push_cap = max(W, min(2 * batch, (1 << 25) // max(W * ww, 1)))
        dummy = (jnp.zeros((1, 1), jnp.uint32), jnp.int32(0),
                 jnp.zeros((1, 1), jnp.uint32), jnp.int32(0), jnp.int64(0),
                 jnp.int64(0))
        sc, state = jks.star_fused_chunk(
            self.jpg.nbr, jnp.asarray(self.rank_pad), jnp.asarray(chunk),
            dummy, w_words=ww, k=k, cap=max(C, (1 << 23) // (3 * ww + 1)),
            batch=batch, push_cap=push_cap, out_cap=(1 << 17) if emit else 0,
            iter_budget=1 << 30, resume=False)
        sc = np.asarray(sc)
        assert sc[3] and not sc[2]  # done, no overflow
        out = np.asarray(state[2])[:int(state[3])] if emit else None
        return (int(sc[0]), int(sc[1])), out


def jax_star(jg, k, rank=None, **kw):
    if rank is None:
        rank = np.asarray(jdg.degeneracy_ordering_rank(jg)[0])
    return JaxStar(jg, k, rank, **kw)


@pytest.fixture(scope="module")
def rmat8():
    # chunks of 256 roots keep gms_tpu's compiles and dense compares small
    g, jg = rmat(8)
    return g, jg, jax_star(jg, 3, root_chunk=256)


# ---------------------------------------------------------------------------
# host planning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,root_chunk", [(3, ks.DEFAULT_ROOT_CHUNK), (5, 64)])
def test_plan_equals_gms_tpu(rmat8, k, root_chunk):
    g, jg, _ = rmat8
    js = jax_star(jg, k, root_chunk=root_chunk)
    pg, rank_pad, jobs = ks.plan_star_jobs(
        g, k, device="cpu", rank=js.rank_pad[:g.num_nodes],
        root_chunk=root_chunk)
    np.testing.assert_array_equal(pg.nbr.numpy(), np.asarray(js.jpg.nbr))
    np.testing.assert_array_equal(rank_pad.numpy(), js.rank_pad)
    assert [ww for _, ww in jobs] == [ww for _, ww in js.jobs]
    for (c, _), (jc, _) in zip(jobs, js.jobs):
        np.testing.assert_array_equal(c.numpy(), jc)
    assert len({ww for _, ww in jobs}) >= 3


def test_default_rank_is_the_degeneracy_rank(rmat8):
    g, jg, js = rmat8
    _, rank_pad, jobs = ks.plan_star_jobs(g, 3, device="cpu")
    np.testing.assert_array_equal(rank_pad.numpy(), js.rank_pad)
    assert len(jobs) == len(js.jobs)


# ---------------------------------------------------------------------------
# K11 build_local_univ
# ---------------------------------------------------------------------------

def _dense_branch(C, W, D):
    return W * D <= 1 << 18 or C * W * D <= 1 << 27  # gms_tpu's :82


def _check_univ(nbr, rank_pad, roots, ww, want):
    before = dict(ks.LAUNCHES)
    got = ks.build_local_univ(t(nbr), t(rank_pad), t(roots), w_words=ww)
    assert ks.LAUNCHES == before  # CPU tensors: the plain version
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(bits(g), np.asarray(w))
    return got


def test_build_local_univ_dense_branch(rmat8):
    g, jg, js = rmat8
    nbr = np.asarray(js.jpg.nbr)
    # the two narrowest jobs (their shapes are compiled once for the emit
    # test too), the widest (W = 256 > D = 192: SENTINEL slots past D), and
    # pad/negative roots at the first job's shape
    cases = [js.jobs[0], js.jobs[1], js.jobs[-1]]
    assert 32 * js.jobs[-1][1] > nbr.shape[1]
    rng = np.random.default_rng(1)
    cases.append((np.concatenate([
        rng.integers(0, g.num_nodes, len(js.jobs[0][0]) - 2),
        [js.jpg.v_pad, -3]]).astype(np.int32), js.jobs[0][1]))
    for roots, ww in cases:
        assert _dense_branch(len(roots), 32 * ww, nbr.shape[1])
        got = _check_univ(nbr, js.rank_pad, roots, ww,
                          js.univ(roots, ww))
        assert got[0].any() and got[1].any() and got[2].any()


def test_build_local_univ_searchsorted_branch():
    # W·D > 2^18 and C·W·D > 2^27: gms_tpu's W-step searchsorted scan
    rng = np.random.default_rng(7)
    V, D, n, C, ww = 704, 4224, 700, 512, 2
    nbr = np.full((V, D), SENTINEL, np.int32)
    for v in range(n):
        k = int(rng.integers(0, 100))
        nbr[v, :k] = np.sort(rng.choice(n, size=k, replace=False))
    rank_pad = np.full(V + 1, INT32_MAX, np.int32)
    rank_pad[:n] = rng.permutation(n)
    roots = rng.integers(0, n, C).astype(np.int32)
    roots[-2:] = (V, -1)
    assert not _dense_branch(C, 32 * ww, D)
    want = jks.build_local_univ(jnp.asarray(nbr), jnp.asarray(rank_pad),
                                jnp.asarray(roots), w_words=ww)
    got = _check_univ(nbr, rank_pad, roots, ww, want)
    assert got[1].any() and not got[0][-2].any()  # the pad root


# ---------------------------------------------------------------------------
# K12 star_stack, K13 decode_star_rows
# ---------------------------------------------------------------------------

def _port_univ(js, chunk, ww):
    return (*(t(np.asarray(a)) for a in js.univ(chunk, ww)),
            t(chunk != js.jpg.v_pad))


@pytest.mark.parametrize("k", [2, 3, 4, 5, 6])
def test_star_stack_count_equals_star_fused_chunk(k):
    g, jg = both(random_graph(40, 0.5, 4), 40)  # 28 6-cliques, W = 32
    js = jax_star(jg, k)
    (chunk, ww), = js.jobs
    want, _ = js.fused(chunk, ww, k)
    before = dict(ks.LAUNCHES)
    got = ks.star_stack(*_port_univ(js, chunk, ww), k=k)
    assert ks.LAUNCHES == before
    assert got.dtype == torch.int64 and tuple(got.tolist()) == want
    assert want[0] > 0
    # the whole path on the port's own universe
    pg = padded_from_numpy(np.asarray(js.jpg.nbr), device="cpu")
    fused = ks.star_fused_chunk(pg.nbr, t(js.rank_pad), t(chunk),
                                w_words=ww, k=k)
    assert tuple(fused.tolist()) == want


def test_emitted_rows_and_decode_equal_gms_tpu(rmat8):
    g, jg, js = rmat8
    pg = padded_from_numpy(np.asarray(js.jpg.nbr), device="cpu")
    total = 0
    for chunk, ww in js.jobs[:2]:
        (n, star), want_out = js.fused(chunk, ww, 3, emit=True)
        counts, out = ks.star_stack(*_port_univ(js, chunk, ww), k=3,
                                    emit=True)
        assert tuple(counts.tolist()) == (n, star)
        assert out.dtype == torch.int32 and out.shape == (n, 2 * ww + 1)
        assert row_set(out.numpy()) == row_set(want_out)
        gid, members, stars = ks.decode_star_rows(pg.nbr, t(chunk), out)
        jgid, jmem, jstar = jks.decode_star_rows(
            js.jpg.nbr, jnp.asarray(chunk), jnp.asarray(out.numpy()))
        for a, b in ((gid, jgid), (members, jmem), (stars, jstar)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        total += n
    assert total > 0


def test_decode_star_rows_clips_like_gms_tpu(rmat8):
    g, jg, js = rmat8
    rng = np.random.default_rng(3)
    for ww in (1, 3):
        chunk = rng.integers(0, g.num_nodes, 40).astype(np.int32)
        chunk[-2:] = (js.jpg.v_pad, -5)
        words = rng.integers(0, 1 << 32, (300, 2 * ww + 1), dtype=np.uint64)
        out = words.astype(np.uint32)
        out[:, 2 * ww] = rng.integers(-3, 45, 300).astype(np.int32).view(
            np.uint32)  # root-local ids clip
        got = ks.decode_star_rows(t(np.asarray(js.jpg.nbr)), t(chunk), t(out))
        want = jks.decode_star_rows(js.jpg.nbr, jnp.asarray(chunk),
                                    jnp.asarray(out))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert (got[1] >= 0).any() and (got[2] == -1).any()


def test_decode_star_rows_runs_of_roots_past_d_like_gms_tpu(rmat8):
    """Rows whose roots repeat in runs, as star_stack emits them, at W = 256
    above D = 192 (the root's slots past D read as SENTINEL)."""
    g, jg, js = rmat8
    rng = np.random.default_rng(5)
    ww, L = 8, 300
    assert 32 * ww > js.jpg.d_pad
    chunk = np.argsort(-np.asarray(jg.degrees))[:40].astype(np.int32)
    chunk[-2:] = (js.jpg.v_pad, -5)
    out = rng.integers(0, 1 << 32, (L, 2 * ww + 1),
                       dtype=np.uint64).astype(np.uint32)
    runs = np.repeat(rng.integers(-3, 45, L), rng.integers(1, 9, L))[:L]
    out[:, 2 * ww] = runs.astype(np.int32).view(np.uint32)
    got = ks.decode_star_rows(t(np.asarray(js.jpg.nbr)), t(chunk), t(out))
    want = jks.decode_star_rows(js.jpg.nbr, jnp.asarray(chunk),
                                jnp.asarray(out))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (np.diff(runs) == 0).sum() > L // 2
    assert (got[1] >= 0).any() and (got[2][:, js.jpg.d_pad:] == -1).all()


def test_star_stack_counts_ops():
    # k = 2: a popcount per live root and one per leaf, a bitwise operation
    # per leaf; k = 3 adds 2 bitwise and 1 popcount per child node, the
    # S0 bits of the roots searched (a word each, WW words)
    g = build_csr(random_graph(40, 0.5, 4), num_nodes=40)
    pg, rank_pad, ((chunk, ww),) = ks.plan_star_jobs(g, 2, device="cpu")
    univ = ks.build_local_univ(pg.nbr, rank_pad, chunk, w_words=ww)
    live = chunk != pg.v_pad
    s0_size = kc.popcount32(univ[2]).sum(1)
    for k in (2, 3):
        stats = {}
        n_cl = int(ks.star_stack_plain(*univ, live, k=k, stats=stats)[0])
        kept = live & (s0_size >= k - 1)
        children = 0 if k == 2 else int(s0_size[kept].sum())
        assert stats["popc_ops"] == (int(live.sum()) + children + n_cl) * ww
        assert stats["bit_ops"] == (2 * children + n_cl) * ww
        assert n_cl > 0 and (k == 2 or children > 0)


def test_wrappers_reject_bad_inputs():
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32)  # noqa: E731
    live = torch.ones(2, dtype=torch.bool)
    with pytest.raises(ValueError, match="w_words"):
        ks.build_local_univ(i32(8, 4), i32(9), i32(2), w_words=0)
    with pytest.raises(TypeError, match="rank_pad"):
        ks.build_local_univ(i32(8, 4), i32(9).long(), i32(2), w_words=1)
    with pytest.raises(ValueError, match="empty"):
        ks.build_local_univ(i32(8, 4), i32(0), i32(2), w_words=1)
    with pytest.raises(ValueError, match="32\\*WW"):
        ks.star_stack(i32(2, 16, 1), i32(2, 16, 1), i32(2, 1), i32(2, 1),
                      live, k=3)
    with pytest.raises(ValueError, match="does not match"):
        ks.star_stack(i32(2, 32, 1), i32(2, 64, 2), i32(2, 1), i32(2, 1),
                      live, k=3)
    with pytest.raises(ValueError, match="does not match"):
        ks.star_stack(i32(2, 32, 1), i32(2, 32, 1), i32(2, 1), i32(3, 1),
                      live, k=3)
    with pytest.raises(TypeError, match="live0"):
        ks.star_stack(i32(2, 32, 1), i32(2, 32, 1), i32(2, 1), i32(2, 1),
                      i32(2), k=3)
    with pytest.raises(ValueError, match="k must be >= 2"):
        ks.star_stack(i32(2, 32, 1), i32(2, 32, 1), i32(2, 1), i32(2, 1),
                      live, k=1)
    with pytest.raises(ValueError, match="2WW\\+1"):
        ks.decode_star_rows(i32(8, 4), i32(2), i32(3, 2))
    with pytest.raises(ValueError, match="contiguous"):
        ks.decode_star_rows(i32(8, 4), i32(2), i32(3, 6)[:, :3])


# ---------------------------------------------------------------------------
# end to end, as tests/test_k_clique_star.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [2, 3, 4])
def test_vs_oracle_random(k):
    g, jg = both(random_graph(30, 0.3, 1), 30)
    got = ks.kclique_star_list(g, k, device="cpu")
    want = ks.kclique_star_oracle(g, k)
    assert canon(got) == canon(want) == canon(jks.kclique_star_oracle(jg, k))
    assert canon(jks.kclique_star_list(jg, k)) == canon(want)
    for clique, star in got:
        assert ks.is_valid_star(g, clique, star)


def test_fixtures_k3(fixture_edge_lists, fixture_graphs):
    for name, el in fixture_edge_lists.items():
        g, jg = build_csr(el), fixture_graphs[name]
        got = ks.kclique_star_list(g, 3, device="cpu")
        want = ks.kclique_star_oracle(g, 3)
        assert canon(got) == canon(want), name
        assert canon(jks.kclique_star_list(jg, 3)) == canon(want), name


def test_count_mode_matches_list():
    g, jg = both(random_graph(25, 0.35, 2), 25)
    lst = ks.kclique_star_list(g, 3, device="cpu")
    n, total = ks.kclique_star_list(g, 3, device="cpu", mode="count")
    assert n == len(lst) and total == sum(len(s) for _, s in lst)
    assert (n, total) == jks.kclique_star_list(jg, 3, mode="count")


def test_k4_star_contents():
    # K5: every 4-subset is a 4-clique whose star is the remaining vertex
    g, jg = both(complete_graph_el(5))
    got = ks.kclique_star_list(g, 4, device="cpu")
    assert len(got) == 5
    for clique, star in got:
        assert star == frozenset(range(5)) - clique
    assert canon(got) == canon(jks.kclique_star_list(jg, 4))


def test_small_chunk():
    g, jg = both(random_graph(20, 0.4, 3), 20)
    got = ks.kclique_star_list(g, 3, device="cpu", root_chunk=4)
    want = ks.kclique_star_oracle(g, 3)
    assert canon(got) == canon(want)
    assert canon(jks.kclique_star_list(jg, 3, root_chunk=4)) == canon(want)


@pytest.mark.parametrize("k", [3, 4])
def test_star_total_is_k_plus_1_times_the_k_plus_1_cliques(rmat8, k):
    g, jg, _ = rmat8
    n, total = ks.kclique_star_list(g, k, device="cpu", mode="count")
    assert n == kc.kclique_count(g, k, device="cpu")
    assert total == (k + 1) * kc.kclique_count(g, k + 1, device="cpu")
    assert total > n > 0


def test_rank_argument_and_edge_cases(rmat8):
    g, jg, _ = rmat8
    want = ks.kclique_star_list(g, 4, device="cpu", mode="count")
    ident = np.arange(g.num_nodes, dtype=np.int32)
    assert ks.kclique_star_list(g, 4, device="cpu", rank=ident,
                                mode="count") == want
    g0, _ = both(np.zeros((0, 2), np.int64), 0)
    assert ks.kclique_star_list(g0, 3, device="cpu") == []
    assert ks.kclique_star_list(g0, 3, device="cpu", mode="count") == (0, 0)
    with pytest.raises(ValueError, match="k must be >= 2"):
        ks.kclique_star_list(g, 1, device="cpu")
    with pytest.raises(ValueError, match="mode"):
        ks.kclique_star_list(g, 3, device="cpu", mode="enumerate")
