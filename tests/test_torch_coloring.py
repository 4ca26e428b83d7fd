"""The port's algorithms/coloring.py: the mirror of tests/test_coloring.py on
the plain versions (device="cpu"), and the port against gms_tpu on the same
numpy inputs — colors equal vertex for vertex for Jones–Plassmann (strict and
speculative, three priorities), dense_sparse, and Johansson and
Barenboim/Elkin, whose draws are jax.random's own (gms_tpu_torch/prng.py).
Exact throughout: every
value is an integer. tests/test_torch_coloring_rounds.py holds one round of
each device program against gms_tpu's."""

import numpy as np
import pytest
import torch

from gms_tpu.algorithms import coloring as jc
from gms_tpu.io.builder import build_csr as jbuild_csr

from gms_tpu_torch.algorithms import coloring as gc
from gms_tpu_torch.io.builder import build_csr
from gms_tpu_torch.io.generators import generate_rmat_el

from conftest import random_graph

torch.set_num_threads(1)

SEED = 27491095


@pytest.fixture(scope="module")
def port_fixtures(fixture_edge_lists):
    return {k: build_csr(v) for k, v in fixture_edge_lists.items()}


def _both(el, n=None):
    return build_csr(el, num_nodes=n), jbuild_csr(el, num_nodes=n)


def _rmat(scale):
    return _both(generate_rmat_el(scale, 16, seed=SEED), 1 << scale)


def check(g, colors):
    assert gc.verify_coloring(g, colors)
    assert gc.verify_delta_plus_one(g, colors)


def _cliquey():
    el = []
    for blk in (range(0, 8), range(6, 14)):
        blk = list(blk)
        el += [[a, b] for i, a in enumerate(blk) for b in blk[i + 1:]]
    el += [[14, 15], [15, 16], [16, 17]]
    return np.array(el, dtype=np.int64), 18


def _disjoint_cliques():
    el, base = [], 0
    for m in (12, 12, 10, 9):
        blk = list(range(base, base + m))
        el += [[a, b] for i, a in enumerate(blk) for b in blk[i + 1:]]
        base += m
    el += [[0, 12], [12, 24], [24, 34], [34, 41], [41, 42], [42, 0]]
    return np.array(el, dtype=np.int64), 43


# ---------------------------------------------------------------------------
# the mirror of tests/test_coloring.py (plain versions, device="cpu")
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("priority", ["random", "degree", "id"])
def test_jp_fixtures(port_fixtures, priority):
    for name, g in port_fixtures.items():
        colors = gc.jones_plassmann(g, priority=priority, device="cpu")
        check(g, colors)
        assert gc.verify_degree_bound(g, colors), name


@pytest.mark.parametrize("n,p,seed", [(50, 0.1, 0), (100, 0.05, 1),
                                      (64, 0.3, 2)])
def test_jp_random_graphs(n, p, seed):
    g, jg = _both(random_graph(n, p, seed), n)
    colors = gc.jones_plassmann(g, seed=seed, device="cpu")
    check(g, colors)
    assert np.array_equal(colors, jc.jones_plassmann(jg, seed=seed))


def test_johansson(port_fixtures, fixture_graphs):
    for name, g in port_fixtures.items():
        colors = gc.johansson(g, seed=3, device="cpu")
        assert colors.dtype == np.int32
        assert gc.verify_coloring(g, colors), name
        assert gc.verify_degree_bound(g, colors), name
        assert np.array_equal(colors, gc.johansson(g, seed=3, device="cpu"))
        assert np.array_equal(colors, jc.johansson(fixture_graphs[name],
                                                   seed=3)), name


def test_greedy_oracle_props():
    g, jg = _both(random_graph(40, 0.2, 4), 40)
    colors = gc.greedy_sequential(g)
    check(g, colors)
    assert gc.verify_degree_bound(g, colors)
    assert np.array_equal(colors, jc.greedy_sequential(jg))


def test_bipartite_two_colors():
    n = 16
    el = np.array([[i, (i + 1) % n] for i in range(n)], dtype=np.int64)
    g = build_csr(el, num_nodes=n)
    colors = gc.jones_plassmann(g, seed=5, device="cpu")
    check(g, colors)
    assert gc.unique_colors_count(colors) <= 3


def test_complete_graph_n_colors():
    n = 9
    src, dst = np.nonzero(np.triu(np.ones((n, n), dtype=bool), 1))
    g = build_csr(np.stack([src, dst], axis=1).astype(np.int64))
    colors = gc.jones_plassmann(g, seed=6, device="cpu")
    check(g, colors)
    assert gc.unique_colors_count(colors) == n


def test_isolated_vertices():
    g = build_csr(np.array([[0, 1]], dtype=np.int64), num_nodes=5)
    colors = gc.jones_plassmann(g, device="cpu")
    check(g, colors)
    assert (colors[2:] == 0).all()


def test_empty_graph():
    g = build_csr(np.zeros((0, 2), dtype=np.int64), num_nodes=0)
    for call in (gc.jones_plassmann, gc.johansson, gc.barenboim_elkin,
                 gc.dense_sparse):
        out = call(g, device="cpu")
        assert len(out) == 0 and out.dtype == np.int32


@pytest.mark.parametrize("variant", ["barenboim", "elkin"])
def test_barenboim_elkin(port_fixtures, fixture_graphs, variant):
    for name, g in port_fixtures.items():
        colors = gc.barenboim_elkin(g, variant=variant, seed=1, device="cpu")
        assert gc.verify_coloring(g, colors), name
        assert gc.verify_delta_plus_one(g, colors), name
        if variant == "elkin":
            assert gc.verify_degree_bound(g, colors), name
        assert np.array_equal(colors, jc.barenboim_elkin(
            fixture_graphs[name], variant=variant, seed=1)), name


def test_dense_sparse(port_fixtures, fixture_graphs):
    for name, g in port_fixtures.items():
        colors = gc.dense_sparse(g, seed=2, device="cpu")
        assert gc.verify_coloring(g, colors), name
        assert np.array_equal(colors, jc.dense_sparse(fixture_graphs[name],
                                                      seed=2)), name


def test_barenboim_elkin_random():
    for seed in range(2):
        g, jg = _both(random_graph(60, 0.15, seed), 60)
        for variant in ("barenboim", "elkin"):
            colors = gc.barenboim_elkin(g, variant=variant, seed=seed,
                                        device="cpu")
            assert gc.verify_coloring(g, colors)
            assert np.array_equal(colors, jc.barenboim_elkin(
                jg, variant=variant, seed=seed))


def test_dense_sparse_on_cliquey_graph():
    el, n = _cliquey()
    g, jg = _both(el, n)
    for kw in ({}, {"eps": 0.2}, {"friend_number": 6}):
        colors = gc.dense_sparse(g, device="cpu", **kw)
        assert gc.verify_coloring(g, colors)
        assert np.array_equal(colors, jc.dense_sparse(jg, **kw)), kw


def test_dense_sparse_components_trigger_and_quality():
    el, n = _disjoint_cliques()
    g, jg = _both(el, n)
    colors = gc.dense_sparse(g, eps=0.2, device="cpu")
    assert gc.verify_coloring(g, colors)
    jp = gc.jones_plassmann(g, seed=0, device="cpu")
    assert gc.unique_colors_count(colors) <= max(
        int(1.5 * gc.unique_colors_count(jp)), 13)
    assert np.array_equal(colors, jc.dense_sparse(jg, eps=0.2))
    colors2 = gc.dense_sparse(g, friend_number=6, device="cpu")
    assert gc.verify_coloring(g, colors2)
    assert np.array_equal(colors2, jc.dense_sparse(jg, friend_number=6))
    assert gc.ROUNDS["component_labels"] > 0   # the components fired


def test_speculative_jp_valid_and_bounded():
    for n, p, seed in ((40, 0.3, 1), (120, 0.1, 2), (300, 0.05, 3)):
        g, jg = _both(random_graph(n, p, seed=seed), n)
        colors = gc.jones_plassmann(g, speculative=True, seed=seed,
                                    device="cpu")
        assert gc.verify_coloring(g, colors)
        assert gc.verify_degree_bound(g, colors)
        assert np.array_equal(colors, jc.jones_plassmann(
            jg, speculative=True, seed=seed))


# ---------------------------------------------------------------------------
# the port against gms_tpu, whole runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("speculative", [False, True])
@pytest.mark.parametrize("priority", ["random", "degree", "id"])
def test_jp_equals_gms_tpu_on_fixtures(port_fixtures, fixture_graphs,
                                       speculative, priority):
    for name, g in port_fixtures.items():
        got = gc.jones_plassmann(g, priority=priority, speculative=speculative,
                                 seed=4, device="cpu")
        want = jc.jones_plassmann(fixture_graphs[name], priority=priority,
                                  speculative=speculative, seed=4)
        assert np.array_equal(got, want), name


@pytest.mark.parametrize("scale,speculative", [(10, False), (12, True)])
@pytest.mark.parametrize("priority", ["random", "degree", "id"])
def test_jp_equals_gms_tpu_on_rmat(scale, speculative, priority):
    g, jg = _rmat(scale)
    got = gc.jones_plassmann(g, priority=priority, speculative=speculative,
                             device="cpu")
    assert np.array_equal(got, jc.jones_plassmann(
        jg, priority=priority, speculative=speculative))
    assert gc.verify_coloring(g, got) and gc.verify_degree_bound(g, got)


@pytest.mark.parametrize("variant", ["johansson", "barenboim", "elkin"])
def test_randomized_equal_gms_tpu_on_rmat(variant):
    """The randomized colorings draw jax.random's numbers from gms_tpu's
    keys, so their colors equal gms_tpu's vertex for vertex."""
    g, jg = _rmat(10)
    for seed in (0, 7):
        if variant == "johansson":
            got = gc.johansson(g, seed=seed, device="cpu")
            want = jc.johansson(jg, seed=seed)
        else:
            got = gc.barenboim_elkin(g, variant=variant, seed=seed,
                                     device="cpu")
            want = jc.barenboim_elkin(jg, variant=variant, seed=seed)
        assert np.array_equal(got, want), seed
        assert gc.verify_coloring(g, got)


def test_jp_max_rounds_raises_like_gms_tpu():
    g, jg = _rmat(8)
    with pytest.raises(RuntimeError, match="failed to converge"):
        jc.jones_plassmann(jg, max_rounds=2)
    with pytest.raises(RuntimeError, match="failed to converge"):
        gc.jones_plassmann(g, max_rounds=2, device="cpu")
    assert gc.ROUNDS["jones_plassmann"] == 2


def test_dense_sparse_rmat_components_equal_gms_tpu():
    g, jg = _rmat(9)
    got = gc.dense_sparse(g, friend_number=8, device="cpu")
    assert gc.ROUNDS["component_labels"] > 0
    assert np.array_equal(got, jc.dense_sparse(jg, friend_number=8))


def _record(monkeypatch, fn: str) -> list:
    """Wrap the module's round function `fn` to record (inputs, keywords)
    before each call."""
    seen = []
    inner = getattr(gc, fn)

    def record(*state, **kw):
        seen.append((tuple(x.clone() if isinstance(x, torch.Tensor) else x
                           for x in state), kw))
        return inner(*state, **kw)

    monkeypatch.setattr(gc, fn, record)
    return seen


_ROUND_CASES = {
    "spec": ("spec_round", gc.spec_round_plain, "jones_plassmann",
             lambda g: gc.jones_plassmann(g, speculative=True, device="cpu")),
    # strict JP calls its dispatch function, jp_run, once a dispatch
    "strict": ("jp_run", lambda *a, **kw: gc.jp_run_plain(*a, **kw)[0],
               "jones_plassmann", lambda g: gc.jones_plassmann(g,
                                                               device="cpu")),
    "johansson": ("johansson_round", gc.johansson_round_plain, "johansson",
                  lambda g: gc.johansson(g, device="cpu")),
    "barenboim": ("one_shot_round",
                  lambda *a, **kw: gc.one_shot_round_plain(*a, **kw)[0],
                  "barenboim_elkin",
                  lambda g: gc.barenboim_elkin(g, device="cpu")),
    "components": ("component_step",
                   # the recorded keyword is the call's row schedule
                   lambda *a, schedule: gc.component_step_plain(*a)[0],
                   "component_labels",
                   lambda g: gc.dense_sparse(g, friend_number=8,
                                             device="cpu")),
}


@pytest.mark.parametrize("case", list(_ROUND_CASES))
def test_round_functions_see_each_round_start_state(case, monkeypatch):
    """Each entry point calls its round function, looked up in the module at
    each call, once a round on that round's start state (draws included)
    and only while a vertex is uncolored; each recorded state is the plain
    round of the one before. Strict JP calls jp_run so once a dispatch, and
    the dispatches' rounds sum to ROUNDS. chip_smoke.py records its kernel
    states so."""
    g, _ = _rmat(8)
    n = g.num_nodes
    fn, plain, key, call = _ROUND_CASES[case]
    seen = _record(monkeypatch, fn)
    out = call(g)
    assert gc.verify_coloring(g, out)
    if case == "strict":
        runs = [gc.jp_run_plain(*(x.clone() if isinstance(x, torch.Tensor)
                                  else x for x in a), **kw) for a, kw in seen]
        assert sum(r for _, r in runs) == gc.ROUNDS[key] >= len(seen) > 0
        assert np.array_equal(runs[-1][0][:n].numpy(), out)
    else:
        assert len(seen) == gc.ROUNDS[key] > 0
    at = 2 if case == "components" else 0
    states = [s[at] for s, _ in seen]
    if case == "components":
        assert torch.equal(states[0], torch.arange(n, dtype=torch.int32))
    else:
        assert (states[0][:n] == -1).all() and int(states[0][n]) == 0
        assert all((s[:n] == -1).any() for s in states)
    for (a, kw), b in zip(seen, states[1:]):
        assert torch.equal(plain(*a, **kw), b)
