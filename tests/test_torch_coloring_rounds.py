"""One round of each of the port's five coloring programs against
gms_tpu's on identical arrays: the tiers carried across by
convert.tiers_from_numpy, the same state, and for the randomized rounds
gms_tpu's own jax.random draws fed to the port as its draws. Exact: every
value is an integer. Also _TierGraph's arrays against gms_tpu's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gms_tpu.algorithms import coloring as jc
from gms_tpu.graphs.tiles import PaddedGraph as JPaddedGraph
from gms_tpu.io.builder import build_csr as jbuild_csr

from gms_tpu_torch.algorithms import coloring as gc
from gms_tpu_torch.convert import tiers_from_numpy
from gms_tpu_torch.graphs.csr import _csr_from_sorted_pairs
from gms_tpu_torch.io.builder import build_csr
from gms_tpu_torch.io.generators import generate_rmat_el

torch.set_num_threads(1)

SEED = 27491095


def _both(el, n=None):
    return build_csr(el, num_nodes=n), jbuild_csr(el, num_nodes=n)


def _rmat(scale):
    return _both(generate_rmat_el(scale, 16, seed=SEED), 1 << scale)


def test_tier_graph_equals_gms_tpu():
    g, jg = _rmat(10)
    rng = np.random.default_rng(0)
    frontier = np.sort(rng.choice(g.num_nodes, 300, replace=False))
    for ids in (None, frontier):
        got = gc._TierGraph(g, ids=ids).tiers
        want = jc._TierGraph(jg, ids=ids).tiers
        assert len(got) == len(want)
        for (gi, gt), (wi, wt) in zip(got, want):
            assert gi.dtype == np.int32 and gt.dtype == np.int32
            assert np.array_equal(gi, np.asarray(wi))
            assert np.array_equal(gt, np.asarray(wt))
    # the dump slot n pads each bucket to a multiple of 8
    assert all((i[(i != g.num_nodes)].size <= i.size) and i.size % 8 == 0
               for i, _ in got)


def _state(g, jg, rounds, round_fn):
    """(numpy colors, jax colors, priorities, tiers, jax tiers) after
    `rounds` gms_tpu rounds from all-uncolored, random priorities."""
    n = g.num_nodes
    prio = gc.jp_priorities(g, "random", 0)
    jtiers = jc._TierGraph(jg).tiers
    jprio = jnp.asarray(prio.astype(np.uint32))
    jcol = jnp.concatenate([jnp.full(n, -1, jnp.int32),
                            jnp.zeros(1, jnp.int32)])
    for _ in range(rounds):
        jcol = round_fn(jcol, jprio, jtiers)
    tiers = tiers_from_numpy([(np.asarray(i), np.asarray(t))
                              for i, t in jtiers], device="cpu")
    return np.array(jcol), jcol, prio, jprio, tiers, jtiers


def test_jp_round_equals_gms_tpu_with_same_bucket_races():
    g, jg = _rmat(10)
    for rounds in (0, 1, 3):
        col, jcol, prio, jprio, tiers, jtiers = _state(
            g, jg, rounds, jc._jp_round_tiered)
        want = np.asarray(jc._jp_round_tiered(jcol, jprio, jtiers))
        t_col, t_pri = torch.from_numpy(col), torch.from_numpy(prio)
        for fn in (gc.jp_round, gc.jp_round_plain):
            got = fn(t_col, t_pri, tiers)
            assert np.array_equal(got.numpy(), want)
        assert np.array_equal(t_col.numpy(), col)   # the round is not in place
        # a same-bucket race: an edge (v, w), both uncolored at the start,
        # where w outranks v and wins this round — a commit in place would
        # let v see w colored and perhaps win where gms_tpu's v loses
        bucket = np.zeros(g.num_nodes + 1, np.int64)
        for t, (ids, _) in enumerate(tiers):
            bucket[ids.numpy()] = t
        e = g.edge_array()
        v, w = e[:, 0], e[:, 1]
        race = ((bucket[v] == bucket[w]) & (col[v] == -1) & (col[w] == -1)
                & (prio[w] > prio[v]) & (want[w] >= 0))
        assert race.sum() > 0


def test_spec_round_equals_gms_tpu():
    g, jg = _rmat(10)
    for rounds in (0, 1, 2):
        col, jcol, prio, jprio, tiers, jtiers = _state(
            g, jg, rounds, jc._spec_round_tiered)
        want = np.asarray(jc._spec_round_tiered(jcol, jprio, jtiers))
        for fn in (gc.spec_round, gc.spec_round_plain):
            got = fn(torch.from_numpy(col), torch.from_numpy(prio), tiers)
            assert np.array_equal(got.numpy(), want)


def test_johansson_round_fed_gms_tpu_draws():
    g, jg = _rmat(10)
    n = g.num_nodes
    tg = jc._TierGraph(jg)
    tiers = tiers_from_numpy([(np.asarray(i), np.asarray(t))
                              for i, t in tg.tiers], device="cpu")
    deg1 = np.concatenate([g.degrees + 1, [1]]).astype(np.int32)
    jdeg1 = jnp.asarray(deg1)
    jcol = jnp.concatenate([jnp.full(n, -1, jnp.int32),
                            jnp.zeros(1, jnp.int32)])
    for r in range(3):
        key = jax.random.fold_in(jax.random.key(5), r)
        # the draw gms_tpu's round makes with this key (coloring.py:133)
        w = np.array(jax.random.randint(key, (n + 1,), 0, jdeg1,
                                        dtype=jnp.int32))
        want = np.asarray(jc._johansson_round_tiered(jcol, jdeg1, key,
                                                     tg.tiers))
        col = np.array(jcol)
        for fn in (gc.johansson_round, gc.johansson_round_plain):
            got = fn(torch.from_numpy(col), torch.from_numpy(deg1),
                     torch.from_numpy(w), tiers)
            assert np.array_equal(got.numpy(), want)
        jcol = jnp.asarray(want)
    assert (np.asarray(jcol)[:n] >= 0).mean() > 0.5


@pytest.mark.parametrize("variant", ["barenboim", "elkin"])
def test_one_shot_round_fed_gms_tpu_draws(variant):
    g, jg = _rmat(9)
    n = g.num_nodes
    pg = JPaddedGraph.from_csr(jg)
    V = pg.v_pad
    delta = int(pg.deg.max())
    cw = jc._color_words(delta + 2)
    palette_deg = variant == "elkin"
    tiers = tiers_from_numpy([(np.asarray(i), np.asarray(t))
                              for i, t in jc._TierGraph(jg).tiers],
                             device="cpu")
    deg1 = np.concatenate([g.degrees + 1, [1]]).astype(np.int32)
    jcol = jnp.concatenate([jnp.full(n, -1, jnp.int32),
                            jnp.zeros(V - n, jnp.int32)])
    for r in range(3):
        key = jax.random.fold_in(jax.random.key(7), r)
        col = np.concatenate([np.asarray(jcol)[:n], [0]]).astype(np.int32)
        t_col = torch.from_numpy(col)
        # gms_tpu's draw (coloring.py:432): int64 randint with maxval
        # max(nfree, 1), i.e. two 64-bit words a vertex from split(key),
        # fed raw; the port reduces them once nfree is known
        k1, k2 = jax.random.split(key)
        w = torch.from_numpy(np.stack([
            np.asarray(jax.random.bits(k, (n + 1,), jnp.uint64)).view(np.int64)
            for k in (k1, k2)]))
        want = np.asarray(jc._one_shot_round(pg.nbr, pg.deg, jcol, key, cw=cw,
                                             palette_deg=palette_deg,
                                             delta=delta))
        for fn in (gc.one_shot_round, gc.one_shot_round_plain):
            got, _ = fn(t_col, torch.from_numpy(deg1), w, tiers,
                        palette_deg=palette_deg, delta=delta)
            assert np.array_equal(got.numpy()[:n], want[:n])
        jcol = jnp.asarray(want)
    assert (np.asarray(jcol)[:n] >= 0).mean() > 0.5


def test_component_labels_stop_at_gms_tpus_step():
    # a path whose ids are shuffled: its labels need ~n/2 Jacobi steps, so
    # a small limit stops far from the fixpoint, where an in-place step or a
    # union-find would give other labels
    rng = np.random.default_rng(11)
    n = 40
    p = rng.permutation(n)
    el = np.stack([p[:-1], p[1:]], axis=1)
    fg, jfg = _both(el, n)
    fpg = JPaddedGraph.from_csr(jfg)
    indptr = torch.from_numpy(fg.indptr)
    indices = torch.from_numpy(fg.indices)
    for limit in (0, 1, 3, 7, 64):
        want = np.asarray(jc._component_labels(fpg.nbr,
                                               jnp.int32(limit)))[:n]
        for fn in (gc.component_labels, gc.component_labels_plain):
            assert np.array_equal(fn(indptr, indices, limit).numpy(), want)
        if limit in (1, 3, 7):
            assert len(np.unique(want)) > 1            # not at the fixpoint
    assert (want == 0).all()                           # limit 64: converged
    # a graph of several components, through the friend CSR dense_sparse
    # builds
    both = np.concatenate([el[:15], el[20:]])
    both = np.concatenate([both, both[:, ::-1]]).astype(np.int32)
    both = both[np.lexsort((both[:, 1], both[:, 0]))]
    fg2 = _csr_from_sorted_pairs(both, n, directed=False)
    jfg2 = jbuild_csr(both, num_nodes=n)
    want = np.asarray(jc._component_labels(
        JPaddedGraph.from_csr(jfg2).nbr, jnp.int32(64)))[:n]
    got = gc.component_labels(torch.from_numpy(fg2.indptr),
                              torch.from_numpy(fg2.indices), 64)
    assert np.array_equal(got.numpy(), want)
    assert len(np.unique(want)) == 6   # two paths, four isolated


def _jp_run_agrees(col, prio, tiers, jtiers, n, limits):
    """jp_run_plain (and jp_run on the CPU) from state col against gms_tpu's
    _jp_run_tiered at each limit: the same colors, and as many rounds as
    gms_tpu runs — its colors at limit = rounds are these, at rounds - 1
    still hold an uncolored vertex, and fewer rounds than the limit leave
    none. Returns the rounds at each limit."""
    jprio = jnp.asarray(prio.astype(np.uint32))

    def gms(limit):
        return np.asarray(jc._jp_run_tiered(jnp.asarray(col), jprio, jtiers,
                                            limit=limit, n=n))

    out = []
    for limit in limits:
        want = gms(limit)
        got, rounds = gc.jp_run_plain(torch.from_numpy(col.copy()),
                                      torch.from_numpy(prio), tiers,
                                      limit=limit, n=n)
        assert np.array_equal(got.numpy(), want)
        again, r2 = gc.jp_run(torch.from_numpy(col.copy()),
                              torch.from_numpy(prio), tiers, limit=limit, n=n)
        assert np.array_equal(again.numpy(), want) and r2 == rounds
        assert 0 < rounds <= limit
        assert np.array_equal(gms(rounds), want)
        assert (gms(rounds - 1)[:n] == -1).any()
        if rounds < limit:
            assert not (want[:n] == -1).any()
        out.append(rounds)
    return out


def test_jp_run_equals_gms_tpu_dispatch():
    g, jg = _rmat(10)
    n = g.num_nodes
    col, _, prio, _, tiers, jtiers = _state(g, jg, 0, jc._jp_round_tiered)
    rounds = _jp_run_agrees(col, prio, tiers, jtiers, n, (1, 3, 64))
    # the first two stop at their limit, the frontier empties mid-dispatch
    assert rounds[:2] == [1, 3] and 3 < rounds[2] < 64
    # a dispatch from a state with every vertex colored runs no round
    done = gc.jp_run_plain(torch.from_numpy(col.copy()),
                           torch.from_numpy(prio), tiers, limit=64, n=n)[0]
    assert gc.jp_run_plain(done, torch.from_numpy(prio), tiers, limit=64,
                           n=n)[1] == 0


def test_jp_run_equals_gms_tpu_with_an_uncovered_vertex():
    """Tiers that leave an uncolored vertex out of every bucket: it stays
    uncolored, so both packages run every round up to the limit, the later
    ones with no bucket left to color."""
    g, jg = _rmat(10)
    n = g.num_nodes
    col, _, prio, _, tiers, jtiers = _state(g, jg, 0, jc._jp_round_tiered)
    ids = np.asarray(jtiers[0][0]).copy()
    assert ids[0] < n and col[ids[0]] == -1
    ids[0] = n                                 # the dump slot, colored 0
    jtiers = ((jnp.asarray(ids), jtiers[0][1]),) + tuple(jtiers[1:])
    tiers = [(torch.from_numpy(ids), tiers[0][1])] + list(tiers[1:])
    assert _jp_run_agrees(col, prio, tiers, jtiers, n, (1, 3, 64)) == [1, 3,
                                                                       64]


def test_jp_run_equals_gms_tpu_on_dense_sparse_last_stage(monkeypatch):
    """The state dense_sparse hands its strict JP stage (friend colors, the
    degree cap and the conflict reset applied), run by both packages."""
    g, jg = _rmat(8)
    n = g.num_nodes
    seen = []
    inner = gc.jp_run

    def record(colors, priority, tiers, **kw):
        seen.append((colors.clone(), priority.clone(), tiers, kw))
        return inner(colors, priority, tiers, **kw)

    monkeypatch.setattr(gc, "jp_run", record)
    out = gc.dense_sparse(g, friend_number=8, device="cpu")
    assert np.array_equal(out, jc.dense_sparse(jg, friend_number=8))
    col, prio, tiers, kw = seen[0]
    assert kw == {"limit": 64, "n": n}
    assert (col[:n] >= 0).any() and (col[:n] == -1).any()
    jtiers = jc._TierGraph(jg).tiers
    _jp_run_agrees(col.numpy(), prio.numpy(), tiers, jtiers, n, (64,))
