"""Kernel wrappers and the kernel build of the PyTorch port.

Here on any host: the wrappers' checks of device, dtype, shape and
contiguity, and the build's staleness rule and its refusal without nvcc.
On a card (marker `cuda`, skipped elsewhere): every CUDA kernel against its
plain PyTorch version, exactly, at awkward widths. This file imports neither
jax nor gms_tpu, so on a machine without jax it runs with

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda
"""

import math
import os

import numpy as np
import pytest
import torch

from gms_tpu_torch import _kernels
from gms_tpu_torch.algorithms import bron_kerbosch as bk
from gms_tpu_torch.algorithms import coloring as gc
from gms_tpu_torch.algorithms import k_clique as kc
from gms_tpu_torch.algorithms import k_clique_star as ks
from gms_tpu_torch.algorithms import link_prediction as lp
from gms_tpu_torch.algorithms import similarity as vs
from gms_tpu_torch.algorithms import subgraph_iso as si
from gms_tpu_torch.algorithms import triangle_count as tc
from gms_tpu_torch.graphs import compressed as cp
from gms_tpu_torch.graphs.tiles import SENTINEL, PaddedGraph
from gms_tpu_torch.io.builder import build_csr
from gms_tpu_torch.io.generators import generate_rmat_el
from gms_tpu_torch.preprocessing import degeneracy
from gms_tpu_torch.sets import bitmap_ops as bo

torch.set_num_threads(1)


def _i32(*shape):
    return torch.zeros(shape, dtype=torch.int32)


def test_wrappers_reject_bad_inputs():
    with pytest.raises(TypeError):
        tc.count_tier_mat(_i32(4, 8).long(), _i32(4, 8))
    with pytest.raises(ValueError, match="contiguous"):
        tc.count_tier_mat(_i32(8, 4).T, _i32(4, 8))
    with pytest.raises(ValueError, match="edge counts"):
        tc.count_tier_mat(_i32(4, 8), _i32(4, 9))
    with pytest.raises(ValueError, match="does not match"):
        tc.count_hub_groups_mat(_i32(3, 5), _i32(3, 2, 4))
    with pytest.raises(TypeError):
        tc.count_hub_groups_mat(_i32(3, 5), _i32(3, 5))
    with pytest.raises(ValueError, match="is not"):
        tc.count_hub_groups(_i32(4, 2), _i32(3), _i32(3, 5), chunk=1,
                            width=2, k=4)
    with pytest.raises(ValueError, match="do not match"):
        tc.count_dag_edges(_i32(8, 4), _i32(5, 2), _i32(4))
    with pytest.raises(ValueError, match="V_pad"):
        tc.build_hub_rows(_i32(8, 4), _i32(8), _i32(2), hub_words=1)
    meta = torch.zeros((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tc.count_tier_mat(meta, meta)
    with pytest.raises(TypeError):
        kc.build_local_adj(_i32(8, 4), _i32(3).long(), w_words=1)
    with pytest.raises(ValueError, match="w_words"):
        kc.build_local_adj(_i32(8, 4), _i32(3), w_words=0)
    with pytest.raises(ValueError, match="32\\*WW"):
        kc.kclique_dense_count(_i32(2, 16, 1), k=4)
    with pytest.raises(ValueError, match="does not match"):
        kc.kc_stack_count(_i32(2, 32, 1), _i32(3, 1), k=6)
    with pytest.raises(ValueError, match="k must be >= 5"):
        kc.kc_stack_count(_i32(2, 32, 1), _i32(2, 1), k=4)
    with pytest.raises(TypeError):
        ks.build_local_univ(_i32(8, 4), _i32(9), _i32(3).long(), w_words=1)
    with pytest.raises(TypeError, match="live0"):
        ks.star_stack(_i32(2, 32, 1), _i32(2, 32, 1), _i32(2, 1), _i32(2, 1),
                      _i32(2), k=3)
    with pytest.raises(ValueError, match="2WW\\+1"):
        ks.decode_star_rows(_i32(8, 4), _i32(2), _i32(3, 4))
    with pytest.raises(ValueError, match="do not match"):
        tc.count_dag_edges_per_vertex(_i32(8, 4), _i32(5, 2), _i32(4),
                                      num_segments=8)
    with pytest.raises(TypeError):
        tc.count_hub_edges(_i32(8, 4), _i32(9).long(), _i32(5, 2), _i32(5),
                           chunk=4)
    with pytest.raises(ValueError, match="do not match"):
        tc.count_hub_edges(_i32(8, 4), None, _i32(5, 3), _i32(5), chunk=4)
    with pytest.raises(ValueError, match="shapes differ"):
        bo.rows_count(_i32(3, 4), _i32(3, 5), op="and")
    deg, alive = torch.zeros(4, dtype=torch.long), torch.ones(4, dtype=bool)
    with pytest.raises(ValueError, match="expected"):
        degeneracy.adg_round(torch.zeros(4, dtype=torch.long), _i32(0), deg,
                             alive, boundary="avg", eps=0.1)
    with pytest.raises(TypeError):
        degeneracy.adg_round(torch.zeros(5, dtype=torch.long), _i32(0),
                             deg.int(), alive, boundary="avg", eps=0.1)


def test_similarity_wrappers_reject_bad_inputs():
    nbr, deg1 = _i32(8, 4), _i32(9)
    with pytest.raises(ValueError, match="pairs must be"):
        vs.pair_scores(nbr, deg1, _i32(5, 3), metric="jaccard")
    with pytest.raises(ValueError, match="unknown metric"):
        vs.pair_scores(nbr, deg1, _i32(5, 2), metric="cosine")
    with pytest.raises(TypeError):
        vs.pair_scores(nbr.long(), deg1, _i32(5, 2), metric="jaccard")
    with pytest.raises(ValueError, match="out_pos needs out"):
        vs.pair_scores(nbr, deg1, _i32(5, 2), metric="jaccard",
                       out_pos=_i32(5))
    with pytest.raises(ValueError, match="no rows"):
        vs.pair_scores(_i32(0, 4), deg1, _i32(5, 2), metric="jaccard")
    with pytest.raises(ValueError, match="vw"):
        vs.pair_scores_hub(nbr, deg1, _i32(4), _i32(9), _i32(5, 2),
                           metric="jaccard", vw=0)
    with pytest.raises(ValueError, match="do not match"):
        vs.tile_all_pairs(_i32(4, 3), _i32(5, 2), _i32(4), _i32(5),
                          metric="jaccard")
    with pytest.raises(ValueError, match="32\\*W"):
        vs.tile_all_pairs(_i32(4, 2), _i32(5, 2), _i32(4), _i32(5),
                          metric="resource", wcol=torch.zeros(63))
    indptr = torch.zeros(5, dtype=torch.int64)
    with pytest.raises(ValueError, match="v_base"):
        lp.tile_topq(indptr, _i32(0), indptr, _i32(0), _i32(128), u_base=0,
                     nu=64, v_base=3, nv=64, n=4, block=64, q=5,
                     metric="jaccard")
    with pytest.raises(ValueError, match="strips"):
        lp.tile_topq(indptr, _i32(0), indptr, _i32(0), _i32(128), u_base=0,
                     nu=64, v_base=0, nv=64, n=4, block=64, q=5,
                     metric="jaccard",
                     strips=torch.zeros((4, 3), dtype=torch.int64))
    with pytest.raises(ValueError, match="2T"):
        lp.auc_count(torch.zeros(5), _i32(1), _i32(2))
    with pytest.raises(TypeError):
        lp.auc_count(torch.zeros(4, dtype=torch.float64), _i32(1), _i32(2))


def test_coloring_wrappers_reject_bad_inputs():
    ids, nbrt, st = _i32(8), _i32(8, 32), _i32(11)
    with pytest.raises(ValueError, match="does not match"):
        gc.jp_bucket(st, st, ids, _i32(7, 32))
    with pytest.raises(ValueError, match="state arrays"):
        gc.jp_bucket(st, _i32(12), ids, nbrt)
    with pytest.raises(TypeError):
        gc.spec_pick(st.long(), ids, nbrt, st)
    with pytest.raises(TypeError):
        gc.johansson_bucket(st, st, st, ids, nbrt.float(), st)
    with pytest.raises(ValueError, match="contiguous"):
        gc.one_shot_resolve(st, st, st, ids, _i32(32, 8).T, st)
    with pytest.raises(ValueError, match="indptr"):
        gc.component_step(torch.zeros(5, dtype=torch.long), _i32(3), _i32(5))
    with pytest.raises(TypeError):
        gc.component_step(_i32(6), _i32(3), _i32(5))


def test_coloring_wrappers_check_ids_when_paranoid(monkeypatch):
    st, ids = _i32(11), torch.full((8,), 10, dtype=torch.int32)
    nbrt = torch.full((8, 32), SENTINEL, dtype=torch.int32)
    nbrt[0, 0] = 10                      # the dump slot is no neighbour
    gc.jp_bucket(st.clone(), st, ids, nbrt)     # unchecked
    monkeypatch.setenv("GMS_TPU_PARANOID", "1")
    with pytest.raises(ValueError, match="outside"):
        gc.jp_bucket(st.clone(), st, ids, nbrt)
    nbrt[0, 0] = 3
    ids[1] = 11
    with pytest.raises(ValueError, match="outside"):
        gc.spec_clash(st, st, st, ids, nbrt, st.clone())


def test_pair_scores_check_sorted_rows_when_paranoid(monkeypatch):
    rows = torch.tensor([[1, 3, SENTINEL], [4, 2, SENTINEL],
                         [SENTINEL] * 3], dtype=torch.int32)
    deg1, pairs = _i32(4), _i32(2, 2)
    vs.pair_scores(rows, deg1, pairs, metric="jaccard")   # unchecked
    monkeypatch.setenv("GMS_TPU_PARANOID", "1")
    with pytest.raises(AssertionError, match="not strictly sorted"):
        vs.pair_scores(rows, deg1, pairs, metric="jaccard")
    with pytest.raises(AssertionError, match="not strictly sorted"):
        vs.pair_scores_hub(rows, deg1, _i32(1), _i32(4), pairs,
                           metric="jaccard", vw=1)


def test_hub_rows_check_the_row_contract_when_paranoid(monkeypatch):
    """K3 reads a row only up to the step of its first SENTINEL, so under
    GMS_TPU_PARANOID=1 a row with an entry after its SENTINEL is refused."""
    nbr = torch.tensor([[1, 3, SENTINEL, SENTINEL], [0, SENTINEL, 2, SENTINEL],
                        [SENTINEL] * 4], dtype=torch.int32)
    hub_id = torch.tensor([0, 1, 2, 32], dtype=torch.int32)
    wide = torch.tensor([0, 1], dtype=torch.int32)
    tc.build_hub_rows(nbr, hub_id, wide, hub_words=1)   # unchecked
    monkeypatch.setenv("GMS_TPU_PARANOID", "1")
    with pytest.raises(AssertionError, match="SENTINEL holes"):
        tc.build_hub_rows(nbr, hub_id, wide, hub_words=1)
    nbr[1] = torch.tensor([0, 2, SENTINEL, SENTINEL])
    out = torch.full((3, 1), -1, dtype=torch.int32)
    assert tc.build_hub_rows(nbr, hub_id, wide, hub_words=1, out=out) is out
    assert out[:, 0].tolist() == [0b10, 0b101, 0]
    with pytest.raises(ValueError, match="expected \\(3, 1\\)"):
        tc.build_hub_rows(nbr, hub_id, wide, hub_words=1, out=out[:2])


def test_every_source_has_a_binding():
    sources = {p.stem for p in _kernels.CSRC.glob("*.cu")}
    assert sources == set(_kernels.SIGNATURES)


def test_build_staleness(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(_kernels, "CSRC", csrc)
    monkeypatch.setattr(_kernels, "BUILD", build)
    (csrc / "k.cu").write_text("")
    (csrc / "h.cuh").write_text("")
    assert _kernels._stale("k")              # never built
    lib = build / "libk.so"
    lib.write_text("")
    os.utime(csrc / "k.cu", (1, 1))
    os.utime(csrc / "h.cuh", (1, 1))
    assert not _kernels._stale("k")
    os.utime(csrc / "h.cuh", None)           # a header newer than the library
    os.utime(lib, (2, 2))
    assert _kernels._stale("k")


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_kernels, "BUILD", tmp_path / "build")
    monkeypatch.setattr(_kernels.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.build()
    assert not (tmp_path / "build").exists()


def test_direct_bk_and_level_wrappers_reject_bad_inputs():
    live = torch.ones(2, dtype=torch.bool)
    with pytest.raises(TypeError):
        bk.init_items(_i32(8, 4), _i32(9), _i32(3).long(), w_words=1)
    with pytest.raises(ValueError, match="w_words"):
        bk.init_items(_i32(8, 4), _i32(9), _i32(3), w_words=0)
    with pytest.raises(ValueError, match="does not match"):
        bk.bk_direct_stack(_i32(2, 32, 1), _i32(3, 1), _i32(2, 1), live)
    with pytest.raises(TypeError, match="live0"):
        bk.bk_direct_stack(_i32(2, 32, 1), _i32(2, 1), _i32(2, 1), _i32(2))
    with pytest.raises(ValueError, match="depth"):
        bk.bk_direct_stack(_i32(2, 32, 1), _i32(2, 1), _i32(2, 1), live,
                           depth=0)
    with pytest.raises(ValueError, match="do not match"):
        kc.expand_level(_i32(5, 2), _i32(5), _i32(3, 32, 1), cap=4, need=1)
    with pytest.raises(ValueError, match="cap"):
        kc.expand_level(_i32(5, 1), _i32(5), _i32(3, 32, 1), cap=-1, need=1)
    with pytest.raises(TypeError):
        kc.total_popcount(_i32(5).long())


def test_launch_device_rule():
    cpu = torch.zeros(4, dtype=torch.int32)
    meta = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="not a CUDA device"):
        _kernels.launch_device("f", (cpu, 3, None))
    with pytest.raises(ValueError, match="on 2 devices"):
        _kernels.launch_device("f", (cpu, meta))
    with pytest.raises(ValueError, match="on 0 devices"):
        _kernels.launch_device("f", (3, None))
    flags = " ".join(_kernels.NVCC_FLAGS)
    assert "-include" in flags and flags.endswith("set_device.cuh")


def test_launch_sets_a_library_device_only_when_it_changes(monkeypatch):
    """launch calls gms_set_device in a library when this thread last set
    it to another device (or never), and always calls the entry."""
    calls = []

    class Lib:
        def gms_set_device(self, i):
            calls.append(("set", i))
            return 0

        def entry(self, *args):
            calls.append(("entry", args[-2]))
            return 0

    libs = {"a": Lib(), "b": Lib()}
    devs = iter([0, 0, 1, 1, 0, 0])
    monkeypatch.setattr(_kernels, "_load", libs.__getitem__)
    monkeypatch.setattr(_kernels, "launch_device",
                        lambda fn, args: torch.device("cuda", next(devs)))
    monkeypatch.setattr(_kernels, "current_stream", lambda dev: 0)
    monkeypatch.setattr(_kernels, "_SET", type(_kernels._SET)())
    for name, tag in (("a", 1), ("a", 2), ("a", 3), ("b", 4), ("b", 5),
                      ("a", 6)):
        _kernels.launch(name, "entry", tag)
    assert calls == [("set", 0), ("entry", 1), ("entry", 2), ("set", 1),
                     ("entry", 3), ("set", 1), ("entry", 4), ("set", 0),
                     ("entry", 5), ("set", 0), ("entry", 6)]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _sorted_columns(rng, width, n, universe):
    out = np.full((width, n), SENTINEL, dtype=np.int32)
    for e in range(n):
        k = int(rng.integers(0, width + 1))
        out[:k, e] = np.sort(rng.choice(universe, size=k, replace=False))
    return out


def _words(rng, shape):
    return torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=shape,
                                         dtype=np.int64).astype(np.int32))


def _launched(name, fn, launches=tc.LAUNCHES):
    before = launches[name]
    out = fn()
    assert launches[name] == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("wa,wb,E", [(16, 16, 1000), (3, 70, 257), (512, 512, 300)])
def test_tier_intersect_on_card(card, wa, wb, E):
    rng = np.random.default_rng(wa + wb + E)
    a = torch.from_numpy(_sorted_columns(rng, wa, E, 2 * wb)).to(card)
    b = torch.from_numpy(_sorted_columns(rng, wb, E, 2 * wb)).to(card)
    got = _launched("count_tier_mat", lambda: tc.count_tier_mat(a, b))
    assert int(got) == int(tc.count_tier_mat_plain(a, b, chunk=128))
    # gather mode over the same rows laid out as an adjacency
    d = max(wa, wb)
    nbr = torch.full((2 * E + 1, d), int(SENTINEL), dtype=torch.int32,
                     device=card)
    nbr[:E, :wa] = a.T
    nbr[E:2 * E, :wb] = b.T
    edges = torch.stack([torch.arange(E), torch.arange(E, 2 * E)], 1)
    edges = edges.to(torch.int32).to(card)
    valid = torch.ones(E, dtype=torch.int32, device=card)
    valid[-7:] = 0
    edges[-7:] = 0  # padding edges point at vertex 0 and add nothing
    got = _launched("count_dag_edges", lambda: tc.count_dag_edges(
        nbr, edges, valid, width_a=wa, width_b=wb))
    assert int(got) == int(tc.count_dag_edges_plain(
        nbr, edges, valid, chunk=64, width_a=wa, width_b=wb))


@pytest.mark.cuda
@pytest.mark.parametrize("G,K,W", [(50, 16, 16), (33, 64, 5), (7, 64, 532),
                                   (12, 16, 300)])
def test_hub_popcount_on_card(card, G, K, W):
    rng = np.random.default_rng(G * K + W)
    b = _words(rng, (G, W)).to(card)
    a = _words(rng, (G, K, W)).to(card)
    got = _launched("count_hub_groups_mat",
                    lambda: tc.count_hub_groups_mat(b, a))
    assert int(got) == int(tc.count_hub_groups_mat_plain(b, a, chunk=4))
    rows = _words(rng, (40, W + 3)).to(card)
    rows[-1] = 0
    b_ids = torch.from_numpy(rng.integers(0, 40, G).astype(np.int32)).to(card)
    nbrs = torch.from_numpy(rng.integers(0, 40, (G, K)).astype(np.int32)).to(card)
    got = _launched("count_hub_groups", lambda: tc.count_hub_groups(
        rows, b_ids, nbrs, chunk=8, width=W, k=K))
    assert int(got) == int(tc.count_hub_groups_plain(
        rows, b_ids, nbrs, chunk=8, width=W, k=K))


def _hub_groups(rng, W, hw, K, guard_zero=True):
    """A hub row table int32[60, hw] (the last row the guard, zero unless
    not guard_zero; rows 0, 1 and 2 non-zero nowhere, only in their first
    32-byte sector, only at word W - 1; the rest sparse) and groups in the
    plan's layout: pieces of K slots with guard tails of 1, 17 and 63 slots
    (those below K), full pieces, whole guard groups, and one piece with a
    guard slot inside. Returns (rows, b_ids, nbrs) on the host."""
    n = 60
    words = rng.integers(-(1 << 31), 1 << 31, (n, hw), dtype=np.int64)
    rows = np.where(rng.random((n, hw)) < 0.3, words, 0).astype(np.int32)
    rows[:3] = 0
    rows[1, :min(8, W)] = words[1, :min(8, W)] | 1
    rows[2, W - 1] = -7
    guard = n - 1
    rows[guard] = 0 if guard_zero else words[guard]
    tails = [t for t in (1, 17, 63) if t < K] + [0, 0, K, K]
    b_ids, nbrs = [], []
    for t in tails:
        for head in (0, 1, 2, int(rng.integers(3, guard))):
            slots = rng.integers(0, guard, K).astype(np.int32)
            slots[K - t:] = guard
            b_ids.append(guard if t == K else head)
            nbrs.append(slots)
    inner = rng.integers(0, guard, K).astype(np.int32)
    inner[K // 2] = guard
    b_ids.append(3)
    nbrs.append(inner)
    return rows, np.array(b_ids, np.int32), np.stack(nbrs)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [16, 64, 100])
@pytest.mark.parametrize("W,pad", [(4, 0), (4, 3), (5, 0), (5, 3), (16, 0),
                                   (16, 3), (300, 0), (300, 3), (532, 0),
                                   (532, 3), (1100, 0)])
def test_hub_popcount_gated_on_card(card, W, pad, K):
    """K2's head-gated reads against the plain versions: zero heads, heads
    non-zero only in their first sector or last word, guard tails and
    guard groups, 16-byte and word chunks (W or the stride not a multiple
    of 4), head windows (W = 1100, and 532 read by words), a guard slot
    inside a piece, K beyond one listing of slots (100)."""
    rng = np.random.default_rng(W * 7 + pad + K)
    rows, b_ids, nbrs = _hub_groups(rng, W, W + pad, K)
    rows_d = torch.from_numpy(rows).to(card)
    b_d = torch.from_numpy(b_ids).to(card)
    n_d = torch.from_numpy(nbrs).to(card)
    want = int(tc.count_hub_groups_plain(rows_d, b_d, n_d, chunk=8, width=W,
                                         k=K))
    got = _launched("count_hub_groups", lambda: tc.count_hub_groups(
        rows_d, b_d, n_d, chunk=8, width=W, k=K))
    assert int(got) == want
    # the stream entry on the same groups, pre-gathered, with the plan's
    # live counts (the last non-guard slot + 1) and without
    b_mat = rows_d[b_d.long(), :W].contiguous()
    a_mat = rows_d[n_d.long().reshape(-1), :W].reshape(-1, K, W).contiguous()
    slot = torch.arange(1, K + 1, dtype=torch.int32, device=card)
    live = torch.where(n_d != rows.shape[0] - 1, slot, 0).amax(1).to(
        torch.int32)
    assert int(tc.count_hub_groups_mat_plain(b_mat, a_mat)) == want
    for lv in (live, None):
        got = _launched("count_hub_groups_mat",
                        lambda: tc.count_hub_groups_mat(b_mat, a_mat, live=lv))
        assert int(got) == want


@pytest.mark.cuda
@pytest.mark.parametrize("W", [5, 16, 532])
def test_hub_popcount_nonzero_guard_row_on_card(card, W):
    """A table whose last row is not zero: its slots are read."""
    rng = np.random.default_rng(W)
    rows, b_ids, nbrs = _hub_groups(rng, W, W, 64, guard_zero=False)
    rows_d = torch.from_numpy(rows).to(card)
    b_d = torch.from_numpy(b_ids).to(card)
    n_d = torch.from_numpy(nbrs).to(card)
    want = tc.count_hub_groups_plain(rows_d, b_d, n_d, chunk=8, width=W, k=64)
    assert int(want) > 0
    assert int(tc.count_hub_groups(rows_d, b_d, n_d, chunk=8, width=W,
                                   k=64)) == int(want)


def _hub_case(rng, hw, *, V=200, D=128, n=150, nw=60, full=0,
              sentinel_hub=False):
    """build_hub_rows' inputs: rows 0..n-1 sorted over [0, n) with a
    SENTINEL tail (the first `full` of them filled to D, no SENTINEL), the
    rest all SENTINEL; hub ids spread over [0, 32*hw) (at most n hubs);
    hub_id[V_pad] a real hub's id with `sentinel_hub`, so that every
    SENTINEL slot sets its bit; nw wide ids, the last clipping to row
    V_pad - 1."""
    nbr = np.full((V, D), SENTINEL, dtype=np.int32)
    for v in range(n):
        k = D if v < full else int(rng.integers(0, min(D, n) + 1))
        nbr[v, :k] = np.sort(rng.choice(max(n, D), size=k, replace=False))
    hub_id = np.full(V + 1, 32 * hw, dtype=np.int32)
    n_hub = min(32 * hw, n)
    hub_id[rng.choice(n, size=n_hub, replace=False)] = rng.choice(
        32 * hw, size=n_hub, replace=False)
    if sentinel_hub:
        hub_id[V] = hub_id[int(np.flatnonzero(hub_id[:n] < 32 * hw)[0])]
    wide = rng.choice(n, size=nw, replace=False).astype(np.int32)
    if nw:
        wide[-1] = V + 5  # clips to the last row, all SENTINEL
    return nbr, hub_id, wide


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [1, 17, 133, 4100])
def test_hub_rows_on_card(card, hw):
    """hw = 17 starts rows off 16-byte boundaries; 4100 words is wider
    than a warp's slab of csrc/hub_rows.cu, so a row is three slabs."""
    rng = np.random.default_rng(hw)
    args = [torch.from_numpy(x).to(card) for x in _hub_case(rng, hw)]
    got = _launched("build_hub_rows",
                    lambda: tc.build_hub_rows(*args, hub_words=hw))
    assert torch.equal(got, tc.build_hub_rows_plain(*args, hub_words=hw))
    assert got.any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["sentinel_hub", "full_rows", "no_rows",
                                  "out", "out_no_rows", "out_slabs"])
def test_hub_rows_cases_on_card(card, case):
    """The SENTINEL clip on a real hub (every row with a SENTINEL slot sets
    its bit), rows filled to D_pad with no SENTINEL (D_pad 100, not a
    multiple of 32), Nw = 0, and the out= form over a buffer of -1: rows
    0..Nw-1 as without out=, the guard row zeroed, the buffer returned."""
    rng = np.random.default_rng(len(case))
    hw = 4100 if case == "out_slabs" else 5
    kw = {"sentinel_hub": dict(sentinel_hub=True),
          "full_rows": dict(D=100, full=150),
          "no_rows": dict(nw=0), "out_no_rows": dict(nw=0)}.get(case, {})
    nbr, hub_id, wide = (torch.from_numpy(x).to(card)
                         for x in _hub_case(rng, hw, **kw))
    want = tc.build_hub_rows_plain(nbr, hub_id, wide, hub_words=hw)
    if case.startswith("out"):
        buf = torch.full((wide.shape[0] + 1, hw), -1, dtype=torch.int32,
                         device=card)
        got = _launched("build_hub_rows", lambda: tc.build_hub_rows(
            nbr, hub_id, wide, hub_words=hw, out=buf))
        assert got is buf
        assert torch.equal(got[:-1], want) and not got[-1].any()
    else:
        got = _launched("build_hub_rows", lambda: tc.build_hub_rows(
            nbr, hub_id, wide, hub_words=hw))
        assert torch.equal(got, want) and got.shape == (wide.shape[0], hw)
    if case == "sentinel_hub":  # the SENTINEL slots add their bit
        dropped = hub_id.clone()
        dropped[-1] = 32 * hw
        assert not torch.equal(want, tc.build_hub_rows_plain(
            nbr, dropped, wide, hub_words=hw))


def _padded_rows(rng, V, D, n, max_len):
    """int32[V, D]: rows 0..n-1 strictly ascending over [0, n) with a
    SENTINEL tail, the rest all SENTINEL (the padded layout)."""
    nbr = np.full((V, D), SENTINEL, dtype=np.int32)
    for v in range(n):
        k = int(rng.integers(0, max_len + 1))
        nbr[v, :k] = np.sort(rng.choice(n, size=k, replace=False))
    return nbr


def _sparse_bits(rng, shape, p):
    """int32 words whose bits are set with probability p."""
    bits = rng.random((*shape[:-1], shape[-1] * 32)) < p
    words = np.packbits(bits.reshape(-1, 8), bitorder="little")
    return torch.from_numpy(words.view(np.int32).reshape(shape).copy())


@pytest.mark.cuda
@pytest.mark.parametrize("ww,D", [(1, 96), (3, 64), (32, 160)])
def test_local_adj_on_card(card, ww, D):
    # W < D, W > D and W = 1024 > D; roots include pad and negative ids
    rng = np.random.default_rng(ww * D)
    V, n = 300, 290
    nbr = torch.from_numpy(_padded_rows(rng, V, D, n, D)).to(card)
    roots = rng.integers(0, n, 70).astype(np.int32)
    roots[-3:] = (V, V + 11, -2)
    roots = torch.from_numpy(roots).to(card)
    adj, s0 = _launched("build_local_adj", lambda: kc.build_local_adj(
        nbr, roots, w_words=ww), kc.LAUNCHES)
    padj, ps0 = kc.build_local_adj_plain(nbr, roots, w_words=ww)
    assert torch.equal(adj, padj) and torch.equal(s0, ps0)
    assert adj.any()


def _full_row_nbr(rng, W):
    """Padded rows over [0, n), n = max(600, 2W), at D = W + 16 with a
    SENTINEL tail; rows 0-3 hold exactly W entries (their live prefix
    reaches the root's last slot), row 4 is all SENTINEL, the rest random
    lengths up to 96."""
    D, n = W + 16, max(600, 2 * W)
    nbr = _padded_rows(rng, n + 8, D, n, min(D, 96))
    for v in range(4):
        nbr[v] = SENTINEL
        nbr[v, :W] = np.sort(rng.choice(n, size=W, replace=False))
    nbr[4] = SENTINEL
    return nbr


@pytest.mark.cuda
@pytest.mark.parametrize("ww", [1, 2, 4, 8, 16, 64])
def test_local_adj_chunks_on_card(card, ww):
    """K4 bit for bit against plain on an RMAT chunk of its own width, on
    roots whose rows fill all W slots, on SENTINEL roots, and on the
    sharded count's chunk at one global W."""
    from gms_tpu_torch.preprocessing import orient

    W = 32 * ww
    rng = np.random.default_rng(ww)
    g = build_csr(generate_rmat_el(11, 16, seed=ww), num_nodes=1 << 11)
    rank, _ = degeneracy.degeneracy_ordering_rank(g)
    pg = PaddedGraph.from_csr(orient.orient(g, rank), device=card, lane=32)
    deg = pg.deg.cpu().numpy()
    tier = np.nonzero(deg <= W)[0]
    tier = tier[np.argsort(-deg[tier], kind="stable")][:200]   # the widest
    shard = np.nonzero(deg >= 4)[0][:256]
    cases = [(pg.nbr, np.concatenate([tier, [pg.v_pad, -1]]), ww),
             (pg.nbr, np.concatenate([shard, np.full(256 - len(shard),
                                                     pg.v_pad)]),
              pg.d_pad // 32)]
    full = torch.from_numpy(_full_row_nbr(rng, W)).to(card)
    cases.append((full, np.array([0, 4, 1, full.shape[0], 2, -7, 3, 5, 6]),
                  ww))
    for nbr, roots, w in cases:
        roots = torch.from_numpy(roots.astype(np.int32)).to(card)
        adj, s0 = _launched("build_local_adj", lambda: kc.build_local_adj(
            nbr, roots, w_words=w), kc.LAUNCHES)
        padj, ps0 = kc.build_local_adj_plain(nbr, roots, w_words=w)
        assert torch.equal(adj, padj) and torch.equal(s0, ps0)
        assert adj.any()


@pytest.mark.cuda
def test_local_adj_beyond_the_hash_width_on_card(card):
    """W = 8,320 (ww = 260): the binary-search variant, rows short."""
    rng = np.random.default_rng(3)
    nbr = torch.from_numpy(_padded_rows(rng, 300, 64, 290, 64)).to(card)
    roots = torch.from_numpy(np.array([5, 300, 17, -1, 250],
                                      np.int32)).to(card)
    adj, s0 = _launched("build_local_adj", lambda: kc.build_local_adj(
        nbr, roots, w_words=260), kc.LAUNCHES)
    padj, ps0 = kc.build_local_adj_plain(nbr, roots, w_words=260)
    assert torch.equal(adj, padj) and torch.equal(s0, ps0)
    assert adj.any()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 4, 5])
@pytest.mark.parametrize("C,ww,p", [(40, 1, 0.3), (9, 5, 0.1), (3, 32, 0.03),
                                    (2, 64, 0.03)])
def test_dense_count_on_card(card, k, C, ww, p):
    # ww=64 (W=2048) reads A from device memory, the others from shared
    # memory, ww=32 (128 KB) above the 48 KB default
    rng = np.random.default_rng(C * ww + k)
    adj = _sparse_bits(rng, (C, 32 * ww, ww), p).to(card)
    got = _launched("kclique_dense_count",
                    lambda: kc.kclique_dense_count(adj, k=k), kc.LAUNCHES)
    assert int(got) == int(kc.kclique_dense_count_plain(adj, k=k)) > 0


def _dense_chunk(rng, kind, ww):
    """A K5 chunk [C, 32*ww, ww]: random rows ("random"); one root with a
    clique on its first min(W, 40) local vertices and sparse rows among
    all-zero roots ("skewed"); or rows with one set bit each, most of them
    on one local vertex whose row holds only that bit ("single")."""
    W = 32 * ww
    C = 6
    if kind == "random":
        return _sparse_bits(rng, (C, W, ww), min(0.3, 2.0 / W ** 0.5))
    bits = np.zeros((C, W, W), bool)
    if kind == "skewed":
        q = min(W, 40)
        bits[2] = rng.random((W, W)) < 1.0 / W
        bits[2][:q, :q] |= np.triu(np.ones((q, q), bool), 1)
    else:
        c = int(rng.integers(0, W))
        hit = rng.random((C, W)) < 0.5
        col = np.where(hit, c, rng.integers(0, W, (C, W)))
        col[:, c] = c
        bits[np.arange(C)[:, None], np.arange(W)[None, :], col] = True
    return torch.from_numpy(np.packbits(bits, axis=-1, bitorder="little")
                            .view(np.int32).copy())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 4, 5])
@pytest.mark.parametrize("kind", ["random", "skewed", "single"])
@pytest.mark.parametrize("ww", [1, 2, 4, 8, 16, 32, 64])
def test_dense_count_widths_on_card(card, k, kind, ww):
    # ww <= 8 the kernel compiled per width, 16 and 32 the generic one on
    # the staged root, 64 on the root in device memory
    rng = np.random.default_rng(ww * 10 + k)
    adj = _dense_chunk(rng, kind, ww).to(card)
    got = _launched("kclique_dense_count",
                    lambda: kc.kclique_dense_count(adj, k=k), kc.LAUNCHES)
    want = kc.kclique_dense_count_plain(adj, k=k)
    assert int(got) == int(want) > 0
    # a chunk that is a view into a larger tensor
    got = kc.kclique_dense_count(torch.cat([adj, adj])[adj.shape[0]:], k=k)
    assert int(got) == int(want)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [5, 6, 8])
def test_stack_count_on_card(card, k):
    g = build_csr(generate_rmat_el(10, 16, seed=27491095), num_nodes=1024)
    pg, chunks = kc.plan_chunks(g, k, device=card, root_chunk=64)
    for chunk, ww in chunks[-3:]:
        for w in (ww, 2 * ww):  # the tier's width and a wider one
            adj, s0 = kc.build_local_adj(pg.nbr, chunk, w_words=w)
            got = _launched("kc_stack_count",
                            lambda: kc.kc_stack_count(adj, s0, k=k),
                            kc.LAUNCHES)
            assert int(got) == int(kc.kc_stack_count_plain(adj, s0, k=k))
    # random bits at W = 1024
    rng = np.random.default_rng(k)
    adj = _sparse_bits(rng, (3, 1024, 32), 0.02).to(card)
    s0 = _sparse_bits(rng, (3, 32), 0.3).to(card)
    got = _launched("kc_stack_count", lambda: kc.kc_stack_count(adj, s0, k=k),
                    kc.LAUNCHES)
    assert int(got) == int(kc.kc_stack_count_plain(adj, s0, k=k))


def _dag_chunk(card, rng, C, W, p, plant):
    """A chunk of C roots over W slots on the card: adj the upper-triangular
    bits of a random DAG (each i -> j, j > i, with probability p) and a
    clique of `plant` slots planted in every root; S0 every slot."""
    dense = np.triu(rng.random((C, W, W)) < p, 1)
    for c in range(C):
        s = np.sort(rng.choice(W, size=plant, replace=False))
        dense[c][np.ix_(s, s)] |= np.triu(np.ones((plant, plant), bool), 1)
    return _packed(card, dense), _packed(card, np.ones((C, W), bool))


@pytest.mark.cuda
@pytest.mark.parametrize("W", [32, 64, 96, 128])
@pytest.mark.parametrize("k", [5, 6, 7, 8, 9])
def test_stack_count_register_walk_on_card(card, k, W):
    """K6's register walk (W <= 128) against plain: RMAT-10's chunks built
    at width W, a random DAG with a clique of k + 2 planted in each root,
    and a chunk whose roots are all dead (|S0| < k - 1)."""
    g = build_csr(generate_rmat_el(10, 16, seed=27491095), num_nodes=1024)
    pg, chunks = kc.plan_chunks(g, k, device=card, root_chunk=128)
    cases = [kc.build_local_adj(pg.nbr, chunk, w_words=W // 32)
             for chunk, ww in chunks if ww <= W // 32]
    rng = np.random.default_rng(k * W)
    adj, s0 = _dag_chunk(card, rng, 24, W, 0.2, plant=k + 2)
    dead = s0.clone()
    dead[:, 1:] = 0
    dead[:, 0] &= (1 << (k - 2)) - 1
    cases += [(adj, s0), (adj, dead)]
    for a, s in cases:
        got = _launched("kc_stack_count", lambda: kc.kc_stack_count(
            a, s, k=k), kc.LAUNCHES)
        assert int(got) == int(kc.kc_stack_count_plain(a, s, k=k))
    assert int(got) == 0
    planted = int(kc.kc_stack_count(adj, s0, k=k))
    assert planted >= 24 * math.comb(k + 2, k - 1)


@pytest.mark.cuda
def test_stack_count_memory_walk_on_k132_on_card(card):
    """K6's memory walk (W = 256) on K_132's chunk, k = 6: C(132, 6)."""
    k132 = np.stack(np.nonzero(np.triu(np.ones((132, 132), bool), 1)), 1)
    g = build_csr(k132.astype(np.int64))
    pg, chunks = kc.plan_chunks(g, 6, device=card)
    assert any(ww == 8 for _, ww in chunks)
    total = 0
    for chunk, ww in chunks:
        adj, s0 = kc.build_local_adj(pg.nbr, chunk, w_words=ww)
        got = _launched("kc_stack_count", lambda: kc.kc_stack_count(
            adj, s0, k=6), kc.LAUNCHES)
        if ww == 8:
            assert int(got) == int(kc.kc_stack_count_plain(adj, s0, k=6))
        total += int(got)
    assert total == math.comb(132, 6)


@pytest.mark.cuda
@pytest.mark.parametrize("C,ww", [(40, 1), (9, 4), (3, 20), (2, 40)])
def test_symmetrize_on_card(card, C, ww):
    # rows in shared memory (ww=20 above the 48 KB default) and, at ww=40
    # (200 KB), read from device memory
    rng = np.random.default_rng(C * ww)
    adj = _sparse_bits(rng, (C, 32 * ww, ww), 0.05).to(card)
    got = _launched("symmetrize_bits", lambda: bk.symmetrize_bits(adj),
                    bk.LAUNCHES)
    assert torch.equal(got, bk.symmetrize_bits_plain(adj))
    assert not torch.equal(got, adj)


@pytest.mark.cuda
@pytest.mark.parametrize("ww,D,in_w", [(1, 96, 32), (4, 64, 128),
                                       (32, 160, 64)])
def test_hub_cover_on_card(card, ww, D, in_w):
    # lists longer and shorter than in_w; roots include pad and negative ids
    rng = np.random.default_rng(ww * D + in_w)
    V, n = 300, 290
    nbr = torch.from_numpy(_padded_rows(rng, V, D, n, D)).to(card)
    lens = rng.integers(0, in_w + 6, n)
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    cols = rng.integers(0, n, int(indptr[-1])).astype(np.int32)
    roots = rng.integers(0, n, 70).astype(np.int32)
    roots[-3:] = (V, V + 11, -2)
    args = [torch.from_numpy(x).to(card) for x in (indptr, cols, roots)]
    m, v = _launched("hub_cover_bits", lambda: bk.hub_cover_bits(
        nbr, *args, in_width=in_w, w_words=ww), bk.LAUNCHES)
    pm, pv = bk.hub_cover_bits_plain(nbr, *args, in_width=in_w, w_words=ww)
    assert torch.equal(m, pm) and torch.equal(v, pv)
    assert m.any() and v.any() and not v.all()


def _cover_inputs(rng, card, D, lens, roots, V=300, n=290):
    """K8's inputs: padded rows over [0, n), a lower-neighbour CSR whose
    vertex v lists lens[v] random ids (lens shorter than n padded with
    random counts up to 20), and `roots`, all on the card."""
    nbr = _padded_rows(rng, V, D, n, D)
    lens = np.concatenate([lens, rng.integers(0, 21, n - len(lens))])
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    cols = rng.integers(0, n, max(int(indptr[-1]), 1)).astype(np.int32)
    return [torch.from_numpy(x).to(card)
            for x in (nbr, indptr, cols, np.asarray(roots, np.int32))]


def _check_cover(nbr, indptr, cols, roots, in_w, ww):
    m, v = _launched("hub_cover_bits", lambda: bk.hub_cover_bits(
        nbr, indptr, cols, roots, in_width=in_w, w_words=ww), bk.LAUNCHES)
    pm, pv = bk.hub_cover_bits_plain(nbr, indptr, cols, roots,
                                     in_width=in_w, w_words=ww)
    assert torch.equal(m, pm) and torch.equal(v, pv)
    return m, v


@pytest.mark.cuda
@pytest.mark.parametrize("ww", [1, 4, 32])
def test_hub_cover_hub_job_on_card(card, ww):
    """RMAT-14's hub job shape: one root with 3,575 lower neighbours at
    IN = 4,096 among 255 pad roots (56 live slabs of 64, the rest zeros)."""
    rng = np.random.default_rng(ww + 7)
    hub, V = 5, 300
    lens = np.zeros(6, np.int64)
    lens[hub] = 3575
    roots = np.full(256, V, np.int32)
    roots[100] = hub
    args = _cover_inputs(rng, card, 96, lens, roots, V=V)
    m, v = _check_cover(*args, 4096, ww)
    assert int(v.sum()) == 3575 and bool(v[100, :3575].all())
    assert m[100].any() and not m[:100].any() and not m[101:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("ww,in_w,D", [(1, 137, 96), (4, 128, 64),
                                       (32, 192, 160), (260, 80, 64)])
def test_hub_cover_counts_and_roots_on_card(card, ww, in_w, D):
    """Counts of 0 and 1, one short of a 64-row slab and one past it, equal
    to and above IN; a negative root (vertex 0's list), pad roots at n, V
    and beyond, a root with an empty row; IN not a multiple of the slab
    (137: zeros by 4-byte stores; 80), W = 8,320 above the table's reach (a
    binary search)."""
    rng = np.random.default_rng(ww * in_w)
    V, n = 300, 290
    lens = np.array([in_w + 3, 0, 1, 63, 65, in_w, in_w - 1, 33, 5])
    roots = np.array([1, 2, 3, 4, 5, 6, 7, 0, -3, n, V, V + 11, 8, 2, 6],
                     np.int32)
    nbr, indptr, cols, r = _cover_inputs(rng, card, D, lens, roots, V, n)
    nbr[8] = SENTINEL  # root 8 lists 5 lower neighbours, its row is empty
    m, v = _check_cover(nbr, indptr, cols, r, in_w, ww)
    assert v.sum(1).tolist() == [0, 1, 63, 65, in_w, in_w - 1, 33, in_w,
                                 in_w, 0, 0, 0, 5, 1, in_w - 1]
    assert m.any() and not m[12].any()


def _bk_universe(plan, chunk, ww, in_w):
    nbr = plan.padded.nbr
    adj, s0 = kc.build_local_adj(nbr, chunk, w_words=ww)
    m, v = bk.hub_cover_bits(nbr, plan.lo_indptr, plan.lo_cols, chunk,
                             in_width=in_w, w_words=ww)
    return bk.symmetrize_bits(adj), s0, chunk != nbr.shape[0], m, v


def _rows(out):
    return sorted(map(tuple, out.cpu().tolist()))


def _check_stack(univ):
    got = _launched("bk_stack_machine", lambda: bk.bk_stack_machine(*univ),
                    bk.LAUNCHES)
    want, want_out = bk.bk_stack_machine_plain(*univ, emit=True)
    assert int(got) == int(want)
    n, out = bk.bk_stack_machine(*univ, emit=True)
    assert int(n) == int(want) and _rows(out) == _rows(want_out)
    return int(want)


@pytest.mark.cuda
def test_bk_stack_on_card(card):
    g = build_csr(generate_rmat_el(10, 16, seed=27491095), num_nodes=1024)
    rank, _ = degeneracy.degeneracy_ordering_rank(g)
    plan = bk.BKPlan(g, rank, np.arange(1024, dtype=np.int32), device=card,
                     root_chunk=64)
    counts = [_check_stack(_bk_universe(plan, *job)) for job in plan.jobs]
    assert sum(counts) == bk.bron_kerbosch(g, device="cpu", rank=rank)
    chunk, ww, in_w = plan.jobs[int(np.argmax(counts))]
    for w in (2 * ww, 8):  # wider: the paths move to device memory at 8
        _check_stack(_bk_universe(plan, chunk, w, in_w))
    # random symmetric bits at W = 256 with random covers
    rng = np.random.default_rng(3)
    dense = np.triu(rng.random((4, 256, 256)) < 0.3, 1)
    dense |= dense.transpose(0, 2, 1)
    pack = lambda b: torch.from_numpy(np.packbits(  # noqa: E731
        b, axis=-1, bitorder="little").view(np.int32).copy()).to(card)
    s0 = pack(rng.random((4, 256)) < 0.5)
    m = pack(rng.random((4, 64, 256)) < 0.6)
    v = torch.from_numpy(rng.random((4, 64)) < 0.3).to(card)
    live = torch.tensor([True, True, False, True], device=card)
    assert _check_stack((pack(dense), s0, live, m, v)) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("ww", [1, 2])
def test_bk_stack_wide_cover_on_card(card, ww):
    # IN = 2048: the leaf filter's second block of 32 words. Only rows
    # w >= 1024 are valid, so a filter that skipped them would accept every
    # leaf; with 8 valid rows some leaves are covered and some are not.
    rng = np.random.default_rng(ww)
    C, W, IN = 4, 32 * ww, 2048
    dense = np.triu(rng.random((C, W, W)) < 0.3, 1)
    dense |= dense.transpose(0, 2, 1)
    pack = lambda b: torch.from_numpy(np.packbits(  # noqa: E731
        b, axis=-1, bitorder="little").view(np.int32).copy()).to(card)
    s0 = pack(rng.random((C, W)) < 0.5)
    m = pack(rng.random((C, IN, W)) < 0.6)
    v = np.zeros((C, IN), bool)
    for c in range(C):
        v[c, 1024 + rng.choice(1024, 8, replace=False)] = True
    live = torch.ones(C, dtype=torch.bool, device=card)
    univ = (pack(dense), s0, live, m, torch.from_numpy(v).to(card))
    uncovered = bk.bk_stack_machine_plain(*univ[:4], torch.zeros_like(univ[4]))
    assert 0 < _check_stack(univ) < int(uncovered)


def _sym_bits(rng, C, W, p):
    dense = np.triu(rng.random((C, W, W)) < p, 1)
    return dense | dense.transpose(0, 2, 1)


def _packed(card, bits):
    return torch.from_numpy(np.packbits(
        bits, axis=-1, bitorder="little").view(np.int32).copy()).to(card)


# Universes that reach each placement of the walk (csrc/bk_walk.cuh): the
# register walk at W = 32, 64, 96 (three words) and 128, the memory walk at
# W = 256 to 1024. Their cliques have a
# few vertices, so their paths stay in shared memory:
# test_bk_walks_deep_paths_on_card plants cliques that reach the levels in
# device memory.
WALK_CASES = [(32, 0.5), (64, 0.35), (96, 0.3), (128, 0.25), (256, 0.1),
              (512, 0.05), (1024, 0.025)]


@pytest.mark.cuda
@pytest.mark.parametrize("W,p", WALK_CASES)
def test_bk_stack_walks_on_card(card, W, p):
    # root 0 dead; root 1 live with S0 = 0 and no valid cover row (the leaf
    # R = 0 counts), root 2 live with S0 = 0 and a valid row (covered); the
    # rest live, with a few valid rows that each cover 60 % of the slots,
    # so running covers empty part-way down the paths and some leaves are
    # covered. Count and emitted rows against plain.
    rng = np.random.default_rng(W)
    C, IN = 6, 64
    s0 = rng.random((C, W)) < 0.6
    s0[1:3] = False
    m = rng.random((C, IN, W)) < 0.6
    v = rng.random((C, IN)) < 0.1
    v[1], v[2, 0] = False, True
    live = torch.tensor([False] + [True] * (C - 1), device=card)
    univ = (_packed(card, _sym_bits(rng, C, W, p)), _packed(card, s0), live,
            _packed(card, m), torch.from_numpy(v).to(card))
    n = _check_stack(univ)
    uncovered = bk.bk_stack_machine_plain(*univ[:4], torch.zeros_like(univ[4]))
    assert 1 < n < int(uncovered)
    one = torch.zeros_like(live)
    one[2] = True  # root 2 alone: its leaf R = 0 is covered
    assert _check_stack((*univ[:2], one, *univ[3:])) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("W,p", [(2048, 0.008), (4096, 0.003)])
def test_bk_stack_wide_walks_on_card(card, W, p):
    # the memory walk at W = 2048 (the bit-sliced pivot's two words a lane)
    # and 4096 (the pivot on cand's nonzero words)
    rng = np.random.default_rng(W)
    C, IN = 2, 32
    s0 = rng.random((C, W)) < 0.5
    m = rng.random((C, IN, W)) < 0.9
    v = rng.random((C, IN)) < 0.2
    univ = (_packed(card, _sym_bits(rng, C, W, p)), _packed(card, s0),
            torch.ones(C, dtype=torch.bool, device=card), _packed(card, m),
            torch.from_numpy(v).to(card))
    assert _check_stack(univ) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("W,p", WALK_CASES + [(4096, 0.003)])
def test_bk_direct_walks_on_card(card, W, p):
    # root 0 dead, root 1 live with cand0 = fini0 = 0 (one clique), root 2
    # live with only fini0 (no item), the rest random disjoint cand0, fini0;
    # the count, and the overflow at depth 1 and 2, against plain
    rng = np.random.default_rng(W + 1)
    C = 6
    side = rng.random((C, W))
    cand, fini = side < 0.5, (side >= 0.5) & (side < 0.8)
    cand[1:3], fini[1] = False, False
    live = torch.tensor([False] + [True] * (C - 1), device=card)
    univ = (_packed(card, _sym_bits(rng, C, W, p)), _packed(card, cand),
            _packed(card, fini), live)
    n, ovf = _check_direct(univ)
    assert n > 1 and not ovf
    assert _check_direct(univ, depth=1)[1]
    _check_direct(univ, depth=2)
    stats = {}
    got, _ = bk.bk_direct_stack(*univ, stats=stats)
    assert int(got) == n and stats["items"] >= 1
    assert set(stats["cycles"]) == set(bk.WALK_PARTS)
    assert all(c >= 0 for c in stats["cycles"].values())


# (kernel, W, background edge share p, candidate share q, planted clique):
# each clique is deeper than the levels a warp keeps in shared memory (K9:
# 15 at W = 1024, 7 at 2048; K36: 21 at W = 1024, 4 at 4096), so its path
# reaches the levels in device memory
DEEP_CASES = [("stack", 1024, 0.025, 0.5, 24), ("stack", 2048, 0.008, 0.5, 24),
              ("direct", 1024, 0.025, 0.5, 30),
              ("direct", 4096, 0.003, 0.1, 24)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,W,p,q,size", DEEP_CASES)
def test_bk_walks_deep_paths_on_card(card, kind, W, p, q, size):
    # one live root of three holds a planted clique on `size` random slots,
    # all candidates; count (K9: and emitted rows) against plain, and the
    # walk's stats= show children formed on levels in device memory
    rng = np.random.default_rng(W + size)
    C = 3
    adj = _sym_bits(rng, C, W, p)
    clique = np.sort(rng.choice(W, size=size, replace=False))
    adj[1][np.ix_(clique, clique)] = True
    adj[1][clique, clique] = False
    side = rng.random((C, W))
    cand = side < q
    cand[1, clique] = True
    live = torch.ones(C, dtype=torch.bool, device=card)
    stats = {}
    if kind == "stack":
        IN = 32
        m = rng.random((C, IN, W)) < 0.6
        v = rng.random((C, IN)) < 0.1
        univ = (_packed(card, adj), _packed(card, cand), live,
                _packed(card, m), torch.from_numpy(v).to(card))
        n = _check_stack(univ)
        got = bk.bk_stack_machine(*univ, stats=stats)
    else:
        fini = (side >= q) & (side < q + 0.3)
        fini[1, clique] = False
        univ = (_packed(card, adj), _packed(card, cand), _packed(card, fini),
                live)
        n, ovf = _check_direct(univ)
        assert not ovf
        got, _ = bk.bk_direct_stack(*univ, stats=stats)
    assert int(got) == n > 0
    assert stats["deep_steps"] > 0


@pytest.mark.cuda
def test_bk_stack_stats_on_card(card):
    g = build_csr(generate_rmat_el(10, 16, seed=27491095), num_nodes=1024)
    rank, _ = degeneracy.degeneracy_ordering_rank(g)
    plan = bk.BKPlan(g, rank, np.arange(1024, dtype=np.int32), device=card)
    for job in plan.jobs:
        univ = _bk_universe(plan, *job)
        stats = {}
        n = bk.bk_stack_machine(*univ, stats=stats)
        assert int(n) == int(bk.bk_stack_machine_plain(*univ))
        assert 1 <= stats["max_items"] <= stats["items"]
        assert stats["warps"] >= 132 and sum(stats["cycles"].values()) > 0


@pytest.mark.cuda
def test_bron_kerbosch_on_card(card):
    for scale, ordering in ((9, "degeneracy"), (9, "degree"), (8, "id")):
        g = build_csr(generate_rmat_el(scale, 16, seed=27491095),
                      num_nodes=1 << scale)
        want, cl = bk.bron_kerbosch(g, device="cpu", ordering=ordering,
                                    collect=True)
        assert bk.bron_kerbosch(g, device=card, ordering=ordering) == want
        n, got = bk.bron_kerbosch(g, device=card, ordering=ordering,
                                  collect=True)
        assert n == want and set(got) == set(cl)
    k130 = np.stack(np.nonzero(np.triu(np.ones((130, 130), bool), 1)), 1)
    g = build_csr(k130.astype(np.int64))
    assert bk.bron_kerbosch(g, device=card, ordering="id",
                            collect=True) == (1, [frozenset(range(130))])


@pytest.mark.cuda
@pytest.mark.parametrize("ww,D", [(1, 96), (4, 64)])
def test_decode_on_card(card, ww, D):
    rng = np.random.default_rng(ww + D)
    V, n, C, L = 300, 290, 50, 500
    nbr = torch.from_numpy(_padded_rows(rng, V, D, n, D)).to(card)
    chunk = rng.integers(0, n, C).astype(np.int32)
    chunk[-2:] = (V, -4)
    out = _sparse_bits(rng, (L, ww + 1), 0.3).numpy()
    out[:, ww] = rng.integers(-3, C + 3, L)  # root-local ids clip
    args = [torch.from_numpy(x).to(card) for x in (chunk, out)]
    gid, mem = _launched("decode_clique_members",
                         lambda: bk.decode_clique_members(nbr, *args),
                         bk.LAUNCHES)
    pgid, pmem = bk.decode_clique_members_plain(nbr, *args)
    assert torch.equal(gid, pgid) and torch.equal(mem, pmem)
    assert (mem >= 0).any() and (mem == -1).any()


# k-clique-star: K11 build_local_univ, K12 star_stack, K13 decode_star_rows

@pytest.mark.cuda
@pytest.mark.parametrize("ww,D", [(1, 96), (3, 64), (64, 160)])
def test_star_univ_on_card(card, ww, D):
    # W < D, W > D and W = 2048; roots include pad and negative ids, and
    # rank_pad is shorter than V_pad + 1, so rank lookups clip
    rng = np.random.default_rng(ww * D + 1)
    V, n = 300, 290
    nbr = torch.from_numpy(_padded_rows(rng, V, D, n, D)).to(card)
    rank_pad = np.full(V - 5, np.iinfo(np.int32).max, dtype=np.int32)
    rank_pad[:n] = rng.permutation(n)
    roots = rng.integers(0, n, 70).astype(np.int32)
    roots[-3:] = (V, V + 11, -2)
    rank_pad, roots = (torch.from_numpy(x).to(card) for x in (rank_pad, roots))
    _check_univ(nbr, rank_pad, roots, ww)
    # mostly pad roots: 3 real ones in 64
    few = torch.full((64,), V, dtype=torch.int32, device=card)
    few[[5, 30, 63]] = roots[:3]
    _check_univ(nbr, rank_pad, few, ww)


def _check_univ(nbr, rank_pad, roots, ww):
    got = _launched("build_local_univ", lambda: ks.build_local_univ(
        nbr, rank_pad, roots, w_words=ww), ks.LAUNCHES)
    want = ks.build_local_univ_plain(nbr, rank_pad, roots, w_words=ww)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[1].any() and got[2].any()


@pytest.mark.cuda
@pytest.mark.parametrize("ww", [1, 2, 4, 8, 16, 32, 64])
def test_star_univ_widths_on_card(card, ww):
    """K11 bit for bit at W = 32 ... 2048: RMAT-12's k=4 job of that width
    (at W = 2048 one real root of 32), the same roots among pad roots, and
    roots whose rows fill all W slots under a random rank."""
    W = 32 * ww
    g = build_csr(generate_rmat_el(12, 16, seed=27491095), num_nodes=4096)
    pg, rank_pad, jobs = ks.plan_star_jobs(g, 4, device=card)
    chunk = next(c for c, w in jobs if w == ww)
    _check_univ(pg.nbr, rank_pad, chunk, ww)
    real = chunk[chunk != pg.v_pad][:3]
    padded = torch.full((256,), pg.v_pad, dtype=torch.int32, device=card)
    padded[[0, 100, 255][:real.numel()]] = real
    _check_univ(pg.nbr, rank_pad, padded, ww)
    rng = np.random.default_rng(ww)
    full = torch.from_numpy(_full_row_nbr(rng, W)).to(card)
    rank = torch.from_numpy(rng.permutation(full.shape[0]).astype(
        np.int32)).to(card)
    roots = torch.tensor([0, 4, 1, full.shape[0], 2, -7, 3, 5, 6],
                         dtype=torch.int32, device=card)
    _check_univ(full, rank, roots, ww)


@pytest.mark.cuda
def test_star_univ_beyond_the_hash_width_on_card(card):
    """W = 8,320 (ww = 260): the binary-search instance, rows short."""
    rng = np.random.default_rng(4)
    nbr = torch.from_numpy(_padded_rows(rng, 300, 64, 290, 64)).to(card)
    rank_pad = torch.from_numpy(rng.permutation(301).astype(np.int32)).to(card)
    roots = torch.from_numpy(np.array([5, 300, 17, -1, 250],
                                      np.int32)).to(card)
    _check_univ(nbr, rank_pad, roots, 260)


def _check_star(univ, k):
    """K12 against plain: the count, the emitted rows as sorted sets, the
    same rows in the same order on a second run, and the count pass's run
    table and leaves a run against star_runs_plain, each run's rows at its
    base under its own root."""
    got = _launched("star_stack", lambda: ks.star_stack(*univ, k=k),
                    ks.LAUNCHES)
    want, want_out = ks.star_stack_plain(*univ, k=k, emit=True)
    assert got.tolist() == want.tolist()
    counts, out = ks.star_stack(*univ, k=k, emit=True)
    assert counts.tolist() == want.tolist()
    assert torch.equal(_sorted_rows(out), _sorted_rows(want_out))
    assert torch.equal(ks.star_stack(*univ, k=k, emit=True)[1], out)
    ptable, pleaves = ks.star_runs_plain(*univ, k=k)
    for sizes in (False, True):  # the count pass of count and emit mode
        ctl, table, leaf_cnt = ks._count_pass(*univ, k, sizes=sizes)
        n_runs = int(ctl[2])
        assert torch.equal(table[:n_runs], ptable)
        assert torch.equal(leaf_cnt[:n_runs], pleaves)
        star = 0 if sizes else int(want[1])
        assert ctl[:2].tolist() == [int(want[0]), star]
    ww = univ[0].shape[2]
    owner = torch.repeat_interleave(ptable[:, 0], pleaves)
    assert torch.equal(out[:, 2 * ww], owner)
    return int(want[0])


def _sorted_rows(out):
    """The rows of out in lexicographic order, sorted on its device."""
    idx = torch.arange(out.shape[0], device=out.device)
    for c in reversed(range(out.shape[1])):
        idx = idx[torch.sort(out[idx, c], stable=True).indices]
    return out[idx]


@pytest.fixture(scope="module")
def star10():
    """RMAT-10's k-clique-star universes (chunks of 64 roots) by width."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = build_csr(generate_rmat_el(10, 16, seed=27491095), num_nodes=1024)
    pg, rank_pad, jobs = ks.plan_star_jobs(g, 2, device="cuda",
                                           root_chunk=64)
    return g, pg, rank_pad, jobs


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 3, 4, 5, 6])
@pytest.mark.parametrize("ww", [1, 2, 4, 8, 16, 32, 64])
def test_star_stack_widths_on_card(card, star10, k, ww):
    """K12 at W = 32 ... 2048 and k = 2 ... 6: RMAT-10's widest job that fits
    W, its universe built at W (the same tree in a wider universe)."""
    g, pg, rank_pad, jobs = star10
    chunk, w = max(((c, w) for c, w in jobs if w <= ww), key=lambda j: j[1])
    univ = (*ks.build_local_univ(pg.nbr, rank_pad, chunk, w_words=ww),
            chunk != pg.v_pad)
    _check_star(univ, k)


def _complete_univ(card, C, W):
    """C roots whose W locals form a complete graph, ranked in local order,
    S0 all of them; root 1 is not live. A live root has C(W, 2) items at
    depth 2, over W·RUN_ITEMS for W >= 64: its runs are longer than
    RUN_ITEMS."""
    full = ~np.eye(W, dtype=bool)
    dag = np.triu(full, 1)
    pack = lambda b: torch.from_numpy(np.packbits(  # noqa: E731
        np.broadcast_to(b, (C, *b.shape)), axis=-1,
        bitorder="little").view(np.int32).copy()).to(card)
    s0 = np.ones(W, dtype=bool)
    live = torch.from_numpy(np.arange(C) != 1).to(card)
    return pack(full), pack(dag), pack(s0), pack(s0), live


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 3, 4, 5, 6])
def test_star_stack_runs_longer_than_run_on_card(card, k):
    univ = _complete_univ(card, 3, 64)
    assert _check_star(univ, k) == 2 * math.comb(64, k - 1)
    if k >= 4:
        table, _ = ks.star_runs_plain(*univ, k=k)
        assert int(table[:, 3].max()) > ks.RUN_ITEMS


def _star_jobs(g, k, card, **kw):
    pg, rank_pad, jobs = ks.plan_star_jobs(g, k, device=card, **kw)
    for chunk, ww in jobs:
        yield chunk, ww, lambda w, c=chunk: (*ks.build_local_univ(
            pg.nbr, rank_pad, c, w_words=w), c != pg.v_pad)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 3, 4, 5, 6])
def test_star_stack_on_card(card, k):
    g = build_csr(generate_rmat_el(10, 16, seed=27491095), num_nodes=1024)
    jobs = list(_star_jobs(g, k, card, root_chunk=64))
    counts = [_check_star(univ(ww), k) for _, ww, univ in jobs]
    assert sum(counts) == kc.kclique_count(g, k, device=card) > 0
    _, ww, univ = jobs[int(np.argmax(counts))]
    _check_star(univ(2 * ww), k)  # a wider universe, the same tree
    # random bits at W = 2048 (any bits define a tree), with a 12-clique
    # planted among each root's candidates so that every k has cliques
    rng = np.random.default_rng(k)
    C, W = 3, 2048
    full = np.triu(rng.random((C, W, W)) < 0.03, 1)
    i0 = rng.random((C, W)) < 0.7
    s0 = i0 & (rng.random((C, W)) < 0.5)
    for c in range(C):
        planted = rng.choice(W, 12, replace=False)
        full[c][np.ix_(planted, planted)] = True
        s0[c, planted] = i0[c, planted] = True
    full |= full.transpose(0, 2, 1)
    full[:, np.arange(W), np.arange(W)] = False
    rank = rng.permutation(W)
    dag = full & (rank[None, None, :] > rank[None, :, None])
    pack = lambda b: torch.from_numpy(np.packbits(  # noqa: E731
        b, axis=-1, bitorder="little").view(np.int32).copy()).to(card)
    live = torch.tensor([True, False, True], device=card)
    assert _check_star((pack(full), pack(dag), pack(s0), pack(i0), live),
                       k) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 3, 4])
def test_star_stack_w2048_job_on_card(card, k):
    # RMAT-12's hub tier: one real root of degree 1,289 in a W = 2048 job
    g = build_csr(generate_rmat_el(12, 16, seed=27491095), num_nodes=4096)
    chunk, ww, univ = list(_star_jobs(g, k, card))[-1]
    assert 32 * ww == 2048
    assert _check_star(univ(ww), k) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("ww,D", [(1, 96), (4, 64), (64, 160)])
def test_star_decode_on_card(card, ww, D):
    rng = np.random.default_rng(ww + D)
    V, n, C, L = 300, 290, 50, 400
    nbr = torch.from_numpy(_padded_rows(rng, V, D, n, D)).to(card)
    chunk = rng.integers(0, n, C).astype(np.int32)
    chunk[-2:] = (V, -4)
    out = _sparse_bits(rng, (L, 2 * ww + 1), 0.3).numpy()
    out[:, 2 * ww] = rng.integers(-3, C + 3, L)  # root-local ids clip
    args = [torch.from_numpy(x).to(card) for x in (chunk, out)]
    got = _launched("decode_star_rows",
                    lambda: ks.decode_star_rows(nbr, *args), ks.LAUNCHES)
    want = ks.decode_star_rows_plain(nbr, *args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (got[1] >= 0).any() and (got[2] >= 0).any()
    assert (got[2] == -1).any()


def _decode_inputs(rng, card, ww, D, L, blocks, view):
    """Padded rows at D (a view whose data starts 4 bytes past an aligned
    address when `view`), 50 chunk slots (a pad and a negative id among
    them) and L emitted rows of `blocks` bit blocks whose root-local index
    words run in groups of up to 7 equal ids, some clipping below 0 and
    past C."""
    V, n, C = 300, 290, 50
    rows = torch.from_numpy(_padded_rows(rng, V, D, n, D)).to(card)
    if view:
        flat = torch.empty(V * D + 1, dtype=torch.int32, device=card)
        flat[1:] = rows.reshape(-1)
        rows = flat[1:].view(V, D)
    chunk = rng.integers(0, n, C).astype(np.int32)
    chunk[-2:] = (V, -4)
    out = _sparse_bits(rng, (max(L, 1), blocks * ww + 1), 0.3).numpy()[:L]
    runs = np.repeat(rng.integers(-3, C + 3, L), rng.integers(1, 8, L))
    out[:, blocks * ww] = runs[:L]
    return rows, torch.from_numpy(chunk).to(card), torch.from_numpy(
        np.ascontiguousarray(out)).to(card)


# (ww, D): D below, equal to and above W, and D % 4 != 0 (scalar loads)
DECODE_SHAPES = [(1, 30), (1, 32), (2, 96), (2, 70), (8, 256), (8, 250),
                 (64, 160)]


@pytest.mark.cuda
@pytest.mark.parametrize("ww,D", DECODE_SHAPES)
@pytest.mark.parametrize("L", [0, 1, 997])
def test_star_decode_shapes_on_card(card, ww, D, L):
    rng = np.random.default_rng(ww * D + L)
    for view in (False, True):
        nbr, chunk, out = _decode_inputs(rng, card, ww, D, L, 2, view)
        got = _launched("decode_star_rows", lambda: ks.decode_star_rows(
            nbr, chunk, out), ks.LAUNCHES)
        want = ks.decode_star_rows_plain(nbr, chunk, out)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert got[1].shape == (L, 32 * ww)
        if L > 1:
            assert (got[1] >= 0).any() and (got[2] == -1).any()


@pytest.mark.cuda
@pytest.mark.parametrize("ww,D", DECODE_SHAPES)
@pytest.mark.parametrize("L", [0, 1, 997])
def test_decode_shapes_on_card(card, ww, D, L):
    rng = np.random.default_rng(ww * D + L + 1)
    for view in (False, True):
        nbr, chunk, out = _decode_inputs(rng, card, ww, D, L, 1, view)
        gid, mem = _launched("decode_clique_members",
                             lambda: bk.decode_clique_members(nbr, chunk,
                                                              out),
                             bk.LAUNCHES)
        pgid, pmem = bk.decode_clique_members_plain(nbr, chunk, out)
        assert torch.equal(gid, pgid) and torch.equal(mem, pmem)
        if L > 1:
            assert (mem >= 0).any() and (mem == -1).any()


@pytest.mark.cuda
def test_kclique_star_list_on_card(card):
    g = build_csr(generate_rmat_el(9, 16, seed=27491095), num_nodes=512)
    for k in (2, 3, 4, 5):
        want = ks.kclique_star_list(g, k, device="cpu", mode="count")
        assert ks.kclique_star_list(g, k, device=card, mode="count") == want
    got = ks.kclique_star_list(g, 3, device=card)
    assert set(got) == set(ks.kclique_star_list(g, 3, device="cpu"))
    k5 = build_csr(np.stack(np.nonzero(np.triu(np.ones((5, 5), bool), 1)),
                            1).astype(np.int64))
    got = ks.kclique_star_list(k5, 4, device=card)
    assert len(got) == 5 and set(got) == set(ks.kclique_star_oracle(k5, 4))


# per-vertex and dense triangles, bitmap counts, ADG: K14 count_dag_edges_per_
# vertex, K15 count_hub_edges, K16 bitmap_rows_count, K17 adg_round

@pytest.mark.cuda
@pytest.mark.parametrize("wa,wb,D", [(16, 16, 128), (3, 70, 128),
                                     (512, 512, 512)])
def test_per_vertex_on_card(card, wa, wb, D):
    # edges with weights 0, 1, 2 and -1, a few ids past num_segments
    rng = np.random.default_rng(wa * wb + D)
    V, n, E = 700, 690, 3000
    nbr = torch.from_numpy(_padded_rows(rng, V, D, n, max(wa, wb))).to(card)
    edges = rng.integers(0, n, (E, 2)).astype(np.int32)
    valid = rng.choice([0, 1, 1, 1, 2, -1], E).astype(np.int32)
    args = [nbr] + [torch.from_numpy(x).to(card) for x in (edges, valid)]
    for segs in (V, 500):
        kw = dict(num_segments=segs, width_a=wa, width_b=wb)
        got = _launched("count_dag_edges_per_vertex",
                        lambda: tc.count_dag_edges_per_vertex(*args, **kw))
        want = tc.count_dag_edges_per_vertex_plain(*args, chunk=512, **kw)
        assert torch.equal(got, want) and int(want.sum()) > 0
        # out= adds into what is there
        acc = _launched("count_dag_edges_per_vertex",
                        lambda: tc.count_dag_edges_per_vertex(
                            *args, **kw, out=want.clone()))
        assert torch.equal(acc, 2 * want)


# every tier shape the planner makes at RMAT-18 (widths 16, 64, 256, 512),
# odd widths, and the wider row first
K14_SHAPES = [(16, 16), (16, 64), (16, 256), (16, 512), (64, 64), (64, 256),
              (64, 512), (256, 256), (256, 512), (512, 512), (3, 70), (70, 3)]


def _k14_case(rng, case, wa, wb):
    """(nbr, edges, valid) of a K14 case: V = 700 rows over ids < 690 at
    width D = max(wa, wb), sorted with a SENTINEL tail. "random": rows of
    random length, edges in random order; "one_row": every edge on one
    a-row; "hub": id 689 in every row (the witness of every edge);
    "full": every row at full width D (no SENTINEL). Hub rows hold at
    most min(wa, wb) entries, so that both slices keep the hub."""
    V, n, E = 700, 690, 3000
    D = max(wa, wb)
    if case == "full":
        nbr = np.stack([np.sort(rng.choice(n, D, replace=False))
                        for _ in range(V)]).astype(np.int32)
    else:
        nbr = _padded_rows(rng, V, D, n, D)
    if case == "hub":
        for row in nbr[:n - 1]:
            live = row[row != SENTINEL]
            k = min(len(live), min(wa, wb) - 1)
            keep = np.sort(np.append(live[live != n - 1][:k], n - 1))
            row[:] = SENTINEL
            row[:len(keep)] = keep
    edges = rng.integers(0, n, (E, 2)).astype(np.int32)
    if case == "one_row":
        edges[:, 0] = int(rng.integers(0, n))
    valid = rng.choice([0, 1, 1, 1, 2, -1], E).astype(np.int32)
    return nbr, edges, valid


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "one_row", "hub", "full"])
@pytest.mark.parametrize("wa,wb", K14_SHAPES)
def test_per_vertex_tiers_on_card(card, wa, wb, case):
    rng = np.random.default_rng(wa * 1000 + wb)
    nbr, edges, valid = _k14_case(rng, case, wa, wb)
    args = [torch.from_numpy(x).to(card) for x in (nbr, edges, valid)]
    for segs in (400, 700):  # ids past num_segments are dropped
        kw = dict(num_segments=segs, width_a=wa, width_b=wb)
        got = _launched("count_dag_edges_per_vertex",
                        lambda: tc.count_dag_edges_per_vertex(*args, **kw))
        want = tc.count_dag_edges_per_vertex_plain(*args, chunk=256, **kw)
        assert torch.equal(got, want) and int(want.sum()) > 0
        acc = tc.count_dag_edges_per_vertex(*args, **kw, out=want.clone())
        assert torch.equal(acc, 2 * want)
    if case == "hub" and min(wa, wb) > 1:
        # the hub witnesses every counted edge whose rows both hold it
        both = (valid > 0) & (edges != 689).all(1)
        assert int(got[689]) >= int(both.sum()) > 0


def _k14_wide_case(rng, case, wa, wb):
    """(nbr, edges, valid) of a K14 case whose wider row outgrows its
    group's share of the staged rows (G = 32: 512 entries, G = 16: 256,
    G = 8: 128), so that the group stages it in pieces, with E = 50,000
    edges, so that every group of the grid walks several. Rows as
    _k14_case's over ids < D + 50; "hub": id 0 in every live row, the
    first entry of each (the witness of every edge)."""
    D = max(wa, wb)
    n, E = D + 50, 50_000
    V = n + 10
    if case == "full":
        nbr = np.full((V, D), SENTINEL, dtype=np.int32)
        nbr[:n] = np.stack([np.sort(rng.choice(n, D, replace=False))
                            for _ in range(n)])
    else:
        nbr = _padded_rows(rng, V, D, n, D)
    if case == "hub":
        for row in nbr[:n]:
            live = row[(row != SENTINEL) & (row != 0)][:D - 1]
            row[:] = SENTINEL
            row[:len(live) + 1] = np.append(0, live)
    edges = rng.integers(0, n, (E, 2)).astype(np.int32)
    valid = rng.choice([0, 1, 1, 1, 2, -1], E).astype(np.int32)
    return nbr, edges, valid


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "hub", "full"])
@pytest.mark.parametrize("wa,wb", [(64, 1024), (32, 2048), (2048, 32),
                                   (16, 600), (8, 300)])
def test_per_vertex_wide_rows_on_card(card, wa, wb, case):
    rng = np.random.default_rng(wa * 10_000 + wb)
    nbr, edges, valid = _k14_wide_case(rng, case, wa, wb)
    args = [torch.from_numpy(x).to(card) for x in (nbr, edges, valid)]
    for segs in (nbr.shape[0] // 2, nbr.shape[0]):
        kw = dict(num_segments=segs, width_a=wa, width_b=wb)
        got = _launched("count_dag_edges_per_vertex",
                        lambda: tc.count_dag_edges_per_vertex(*args, **kw))
        want = tc.count_dag_edges_per_vertex_plain(*args, chunk=256, **kw)
        assert torch.equal(got, want) and int(want.sum()) > 0
        acc = tc.count_dag_edges_per_vertex(*args, **kw, out=want.clone())
        assert torch.equal(acc, 2 * want)
    if case == "hub":
        # id 0, in every row, witnesses every counted edge
        assert int(got[0]) >= int((valid > 0).sum()) > 0


@pytest.mark.cuda
def test_triangle_count_per_vertex_on_card(card):
    g = build_csr(generate_rmat_el(11, 16, seed=27491095), num_nodes=2048)
    want = tc.triangle_count_per_vertex(g, device="cpu")
    before = tc.LAUNCHES["count_dag_edges_per_vertex"]
    got = tc.triangle_count_per_vertex(g, device=card)
    _, parts = tc.plan_per_vertex(g, device="cpu")
    assert tc.LAUNCHES["count_dag_edges_per_vertex"] == before + len(parts)
    assert np.array_equal(got, want)
    got = tc.triangle_count_per_vertex(g, device=card, tiers=(2, 4, 8, 16))
    assert np.array_equal(got, want)
    assert np.array_equal(degeneracy.triangle_count_ordering_rank(g, device=card),
                          degeneracy.triangle_count_ordering_rank(g, device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("hw,width,row_of", [(64, None, False), (7, 5, False),
                                             (130, 128, True), (9, None, True)])
def test_hub_edges_on_card(card, hw, width, row_of):
    # 16-byte loads at hw=64 and hw=130/width=128, word loads otherwise;
    # edge and row ids clip into range
    rng = np.random.default_rng(hw + (width or 0))
    N, E = 120, 5000
    rows = _words(rng, (N, hw)).to(card)
    ro = (torch.from_numpy(rng.integers(-2, N + 3, 200).astype(np.int32))
          .to(card) if row_of else None)
    edges = torch.from_numpy(rng.integers(-3, (200 if row_of else N) + 3,
                                          (E, 2)).astype(np.int32)).to(card)
    valid = torch.from_numpy(rng.choice([0, 1, 1, 2], E).astype(np.int32)
                             ).to(card)
    got = _launched("count_hub_edges", lambda: tc.count_hub_edges(
        rows, ro, edges, valid, chunk=256, width=width))
    want = tc.count_hub_edges_plain(rows, ro, edges, valid, chunk=256,
                                    width=width)
    assert int(got) == int(want) > 0
    # an unaligned view of the table takes the word loads
    got = tc.count_hub_edges(rows[1:], ro, edges, valid, chunk=256,
                             width=width)
    assert int(got) == int(tc.count_hub_edges_plain(
        rows[1:], ro, edges, valid, chunk=256, width=width))


def _hub_edge_case(kind, seed=5):
    """count_hub_edges inputs as numpy: (rows uint32[N, HW], row_of or None,
    edges, valid, width). Sparse rows (fewer bits than HW / 3), edges in runs of one
    source row (CSR order) with valid in {0, 1, 2}. "shuffled": the same
    edges in random order; "row_of": vertex ids through a row table (ids
    clip); "width": a 37-word prefix of 70-word rows (word loads), and
    "width4" a 64-word prefix of 68-word rows (16-byte loads); "dense":
    sources whose non-zero words are above half of the width; "tile": one
    source's run of 600 edges across two tile boundaries; "wide": 4,096-word
    rows, and in the first tile two sources with 1,500 non-zero words each
    (below half of the width): the first run's pairs fit the tile's 2,048,
    the second's do not (the word loop).
    The edges are padded to a multiple of 256 with valid 0."""
    rng = np.random.default_rng(seed)
    N, HW, width = 600, 64, None
    if kind == "width":
        HW, width = 70, 37
    elif kind == "width4":
        HW, width = 68, 64
    elif kind == "wide":
        N, HW = 200, 4096
    rows = np.zeros((N, HW), np.uint32)
    for r in range(N):
        bits = rng.choice(32 * HW, int(rng.integers(0, min(300, HW // 3))),
                          replace=False)
        np.bitwise_or.at(rows[r], bits >> 5, np.uint32(1) << (bits & 31)
                         .astype(np.uint32))
    if kind == "dense":
        rows[::7] = rng.integers(0, 1 << 32, (len(rows[::7]), HW),
                                 dtype=np.uint64).astype(np.uint32)
    if kind == "wide":
        for r in (3, 4):
            rows[r] = 0
            rows[r, rng.choice(HW, 1500, replace=False)] = rng.integers(
                1, 1 << 32, 1500, dtype=np.uint64).astype(np.uint32)
    src = np.repeat(np.arange(N), rng.integers(0, 25, N))
    if kind == "wide":
        src = np.concatenate([np.full(30, 3), np.full(30, 4), src])
    if kind == "tile":
        src = np.concatenate([src[:100], np.full(600, 9), src[100:]])
    edges = np.stack([src, rng.integers(0, N, len(src))], 1).astype(np.int32)
    valid = rng.choice([0, 1, 1, 1, 2], len(src)).astype(np.int32)
    row_of = None
    if kind == "shuffled":
        perm = rng.permutation(len(src))
        edges, valid = edges[perm], valid[perm]
    elif kind == "row_of":
        V = 900
        row_of = rng.integers(0, N, V + 1).astype(np.int32)
        row_of[-1] = N + 3                      # clips to the last row
        edges = rng.integers(-2, V + 4, (len(src), 2)).astype(np.int32)
        edges = edges[np.argsort(row_of[np.clip(edges[:, 0], 0, V)],
                                 kind="stable")]
    pad = -len(edges) % 256                     # chunks of 256, valid 0
    edges = np.concatenate([edges, np.zeros((pad, 2), np.int32)])
    valid = np.concatenate([valid, np.zeros(pad, np.int32)])
    return rows, row_of, edges, valid, width


HUB_EDGE_KINDS = ["csr", "shuffled", "row_of", "width", "width4", "dense",
                  "tile", "wide"]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", HUB_EDGE_KINDS)
def test_hub_edge_runs_on_card(card, kind):
    rows, row_of, edges, valid, width = _hub_edge_case(kind)
    args = (torch.from_numpy(rows.view(np.int32)).to(card),
            None if row_of is None else torch.from_numpy(row_of).to(card),
            torch.from_numpy(edges).to(card), torch.from_numpy(valid).to(card))
    got = _launched("count_hub_edges", lambda: tc.count_hub_edges(
        *args, chunk=256, width=width))
    want = tc.count_hub_edges_plain(*args, chunk=256, width=width)
    assert int(got) == int(want) > 0


@pytest.mark.cuda
def test_triangle_count_dense_on_card(card):
    for scale in (9, 11):
        g = build_csr(generate_rmat_el(scale, 16, seed=27491095),
                      num_nodes=1 << scale)
        want = tc.TrianglePlan(g, device="cpu").run()
        assert _launched("count_hub_edges", lambda: tc.triangle_count_dense(
            g, device=card)) == want


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(50, 5), (333, 64), (7, 2048), (4, 6, 12)])
def test_bitmap_rows_count_on_card(card, shape):
    rng = np.random.default_rng(sum(shape))
    a, b = _words(rng, shape).to(card), _words(rng, shape).to(card)
    for op in ("card", "and", "or", "andnot"):
        got = _launched("bitmap_rows_count",
                        lambda: bo.rows_count(a, b, op=op), bo.LAUNCHES)
        assert torch.equal(got, bo.rows_count_plain(a, b, op=op))
    # rows v and v+1 of one table: b is a view one row in
    t = _words(rng, (shape[0] + 1, shape[-1])).to(card)
    assert torch.equal(bo.intersect_count(t[:-1], t[1:]),
                       bo.rows_count_plain(t[:-1], t[1:], op="and"))


def _adg_state(g, card, rounds):
    """The device ADG state after `rounds` rounds of "min" at eps 0.1."""
    indptr = torch.from_numpy(g.indptr).to(card)
    indices = torch.from_numpy(g.indices).to(card)
    deg = torch.from_numpy(g.degrees.astype(np.int64)).to(card)
    alive = torch.ones(g.num_nodes, dtype=torch.bool, device=card)
    for _ in range(rounds):
        degeneracy.adg_round_plain(indptr, indices, deg, alive,
                                   boundary="min", eps=0.1)
    return indptr, indices, deg, alive


@pytest.mark.cuda
@pytest.mark.parametrize("rounds", [0, 2])
def test_adg_round_on_card(card, rounds):
    g = build_csr(generate_rmat_el(12, 16, seed=27491095), num_nodes=4096)
    indptr, indices, deg, alive = _adg_state(g, card, rounds)
    for boundary, eps, bound in (("avg", 0.1, None), ("min", 0.01, None),
                                 ("min", 0.5, None), ("prob_min", 0.1, 9.0),
                                 ("prob_median", 0.1, -1.0)):
        kd, ka, pd, pa = deg.clone(), alive.clone(), deg.clone(), alive.clone()
        kw = dict(boundary=boundary, eps=eps, bound=bound)
        peel = _launched("adg_round", lambda: degeneracy.adg_round(
            indptr, indices, kd, ka, **kw), degeneracy.LAUNCHES)
        want = degeneracy.adg_round_plain(indptr, indices, pd, pa, **kw)
        assert torch.equal(peel, want) and want.any()
        assert torch.equal(kd, pd) and torch.equal(ka, pa)


@pytest.mark.cuda
def test_adg_round_on_card_long_row(card):
    """RMAT-12 plus a vertex joined to all 4,096 others, a row of more than
    1,024 entries that K17 cuts into pieces across warps: every round, from
    the first until that vertex peels, held against the plain version."""
    el = generate_rmat_el(12, 16, seed=27491095)
    star = np.stack([np.full(4096, 4096), np.arange(4096)], 1)
    g = build_csr(np.concatenate([el, star.astype(el.dtype)]), num_nodes=4097)
    assert g.degrees[4096] == 4096
    for boundary, eps in (("avg", 0.1), ("min", 0.5), ("avg", -0.5)):
        indptr, indices, deg, alive = _adg_state(g, card, 0)
        rounds = 0
        while bool(alive[4096]):
            kd, ka = deg.clone(), alive.clone()
            peel = _launched("adg_round", lambda: degeneracy.adg_round(
                indptr, indices, kd, ka, boundary=boundary, eps=eps),
                degeneracy.LAUNCHES)
            want = degeneracy.adg_round_plain(indptr, indices, deg, alive,
                                              boundary=boundary, eps=eps)
            assert torch.equal(peel, want)
            assert torch.equal(kd, deg) and torch.equal(ka, alive)
            rounds += 1
        assert rounds >= 2


@pytest.mark.cuda
def test_adg_ordering_rank_device_on_card(card):
    g = build_csr(generate_rmat_el(12, 16, seed=27491095), num_nodes=4096)
    for boundary in ("avg", "min"):
        for eps in (0.01, 0.5):
            got = degeneracy.adg_ordering_rank_device(g, eps, boundary,
                                                      device=card)
            assert np.array_equal(got, degeneracy.adg_ordering_rank(
                g, eps, boundary))
    for boundary in ("prob_min", "prob_median"):
        got = degeneracy.adg_ordering_rank_device(g, 0.1, boundary, seed=4,
                                                  device=card)
        assert np.array_equal(got, degeneracy.adg_ordering_rank_device(
            g, 0.1, boundary, seed=4, device="cpu"))
        assert degeneracy.verify_approx_degeneracy_order(g, got, 0.1)


def _assert_scores(got, want, metric):
    """Kernel against plain: bit for bit (NaN where NaN) for the count
    metrics; rtol 1e-5 for AA/RA, whose float32 sums run in another order."""
    got, want = got.cpu().numpy(), want.cpu().numpy()
    if metric in vs.WEIGHTED:
        np.testing.assert_allclose(got, want, rtol=1e-5, equal_nan=True)
        return
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32))


def _hub_rmat(card, scale=11):
    g = build_csr(generate_rmat_el(scale, 16, seed=27491095),
                  num_nodes=1 << scale)
    pg = PaddedGraph.from_csr(g, device=card)
    return g, pg, vs._deg_lookup(pg)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", vs.METRICS)
def test_pair_scores_on_card(card, metric):
    g, pg, deg1 = _hub_rmat(card)
    n = g.num_nodes
    rng = np.random.default_rng(len(metric))
    top = np.argsort(-g.degrees)[:20]
    pairs = np.concatenate([
        rng.integers(0, n, (3000, 2)),
        np.stack([rng.integers(0, n, 500), rng.choice(top, 500)], axis=1),
        np.stack([top, top], axis=1), [[-4, 7], [3, n + 50], [0, 0]]])
    p = torch.from_numpy(pairs.astype(np.int32)).to(card)
    got = _launched("pair_scores", lambda: vs.pair_scores(
        pg.nbr, deg1, p, metric=metric), vs.LAUNCHES)
    _assert_scores(got, vs.pair_scores_plain(pg.nbr, deg1, p, metric=metric),
                   metric)
    # a narrower v-side table, and scores placed through out_pos
    nb = pg.nbr[:, :64].contiguous()
    want = vs.pair_scores_plain(pg.nbr, deg1, p, metric=metric, nbr_b=nb)
    out = torch.full((p.shape[0] + 5,), -7.0, device=card)
    pos = torch.from_numpy(rng.permutation(p.shape[0] + 5)[:p.shape[0]]
                           .astype(np.int32)).to(card)
    vs.pair_scores(pg.nbr, deg1, p, metric=metric, nbr_b=nb, out=out,
                   out_pos=pos)
    _assert_scores(out[pos.long()], want, metric)
    assert int((out == -7.0).sum()) == 5
    # hub bitmaps (deg > 40) against the merge on the same pairs
    deg = pg.deg.cpu().numpy()
    bm, hub_idx, vw = lp._hub_bitmaps(g, deg, pg.v_pad, 40)
    bm = torch.from_numpy(bm.reshape(-1).view(np.int32)).to(card)
    hub_idx = torch.from_numpy(hub_idx).to(card)
    hp = p[torch.from_numpy(deg[pairs[:, 1].clip(0, pg.v_pad - 1)] > 40)
           .to(card)]
    got = _launched("pair_scores_hub", lambda: vs.pair_scores_hub(
        pg.nbr, deg1, bm, hub_idx, hp, metric=metric, vw=vw), vs.LAUNCHES)
    _assert_scores(got, vs.pair_scores_hub_plain(
        pg.nbr, deg1, bm, hub_idx, hp, metric=metric, vw=vw), metric)
    _assert_scores(got, vs.pair_scores(pg.nbr, deg1, hp, metric=metric),
                   metric)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 1001, 70000])
def test_auc_count_on_card(card, T):
    rng = np.random.default_rng(T)
    scores = rng.integers(0, 6, 2 * T).astype(np.float32)
    scores[rng.integers(0, 2 * T, 3)] = np.nan
    for s in (0, 1, T, max(T - 3, 0)):
        sc = torch.from_numpy(scores).to(card)
        ks_, ps_ = (torch.tensor([s], dtype=torch.int32, device=card)
                    for _ in range(2))
        kc_ = torch.full((2,), 9, dtype=torch.int32, device=card)
        pc_ = torch.zeros(2, dtype=torch.int32, device=card)
        _launched("auc_count", lambda: lp.auc_count(sc, ks_, kc_),
                  lp.LAUNCHES)
        lp.auc_count_plain(sc, ps_, pc_)
        assert torch.equal(kc_, pc_) and torch.equal(ks_, ps_)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", vs.METRICS)
def test_tile_all_pairs_on_card(card, metric):
    rng = np.random.default_rng(7)
    C = 200
    adj = (rng.random((150, C)) < 0.08).astype(np.float32)
    deg = torch.from_numpy(adj.sum(1).astype(np.int32)).to(card)
    deg[3] = 1   # a deg-1 column: AA's +inf
    a = torch.from_numpy(adj).to(card)
    got = _launched("tile_all_pairs", lambda: vs.all_pairs_scores(
        a[10:80], deg[10:80], a, deg, metric=metric), vs.LAUNCHES)
    want = vs.all_pairs_scores_plain(a[10:80], deg[10:80], a, deg,
                                     metric=metric)
    _assert_scores(got, want, metric)


def _assert_weighted_topq(g, edges, scores, want_scores, metric, card):
    """AA and RA sum float32 weights in another order in the kernel, so
    their top-q may pick other pairs among near-ties: each returned pair is a
    non-edge u < v < n scoring as pair_scores_plain within rtol 1e-5, and
    the q-th score is not below the plain top-q's."""
    n = g.num_nodes
    assert len(edges) == len(want_scores)
    u, v = edges[:, 0].astype(np.int64), edges[:, 1].astype(np.int64)
    assert ((u < v) & (v < n)).all()
    und = g.undirected_edge_array().astype(np.int64)
    assert not np.isin(u * n + v, und[:, 0] * n + und[:, 1]).any()
    pg = PaddedGraph.from_csr(g, device=card)
    want = vs.pair_scores_plain(pg.nbr, vs._deg_lookup(pg),
                                torch.from_numpy(edges).to(card),
                                metric=metric).cpu().numpy()
    np.testing.assert_allclose(scores, want, rtol=1e-5, atol=0)
    assert scores[-1] >= want_scores[-1] * (1 - 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("metric,block,q", [
    ("jaccard", 128, 30), ("common_neighbors", 96, 100),
    ("adamic_adar", 256, 40), ("overlap", 2048, 7),
    ("preferential_attachment", 128, 300)])
def test_link_prediction_similarity_on_card(card, metric, block, q,
                                            monkeypatch):
    g = build_csr(generate_rmat_el(11, 16, seed=27491095), num_nodes=2048)
    lp.reset_launches()
    got_e, got_s = lp.link_prediction_similarity(g, q, metric=metric,
                                                 block=block, device=card)
    assert lp.LAUNCHES["tile_topq"] == -(-2048 // min(block, 2048))
    want_e, want_s = lp._link_prediction_similarity_plain(
        g, q, metric=metric, block=block, device=card)
    # AA and RA too: the kernel sums in the plain version's ascending order
    assert np.array_equal(got_e, want_e)
    assert np.array_equal(got_s.view(np.int32), want_s.view(np.int32))
    if metric in vs.WEIGHTED:
        # the CPU's log differs from the card's in the last bit of a weight
        _assert_weighted_topq(g, got_e, got_s, want_s, metric, card)
    else:
        cpu_e, cpu_s = lp.link_prediction_similarity(
            g, q, metric=metric, block=block, device="cpu")
        assert np.array_equal(got_e, cpu_e) and np.array_equal(got_s, cpu_s)
    # no strip table: each row's range by binary search
    monkeypatch.setattr(lp, "STRIP_TABLE_BYTES", 0)
    up_e, up_s = lp.link_prediction_similarity(g, q, metric=metric,
                                               block=block, device=card)
    assert np.array_equal(up_e, got_e) and np.array_equal(up_s, got_s)
    # a q above what one CTA's shared memory would hold
    big_e, big_s = lp.link_prediction_similarity(g, 5000, metric=metric,
                                                 device=card)
    want_e, want_s = lp._link_prediction_similarity_plain(
        g, 5000, metric=metric, device=card)
    assert np.array_equal(big_e, want_e) and np.array_equal(big_s, want_s)


@pytest.mark.cuda
@pytest.mark.parametrize("build", [{"symmetrize": False}, {"dedup": False}])
@pytest.mark.parametrize("metric", ["jaccard", "adamic_adar"])
def test_topq_directed_and_repeated_rows_on_card(card, build, metric):
    """K21 on a directed graph (the transpose walked for v) and on rows
    with an entry twice (counted once): pairs and score bits equal to the
    plain version's on the card, and for Jaccard to the CPU's."""
    g = build_csr(generate_rmat_el(11, 16, seed=5), num_nodes=2048, **build)
    lp.reset_launches()
    got_e, got_s = lp.link_prediction_similarity(g, 300, metric=metric,
                                                 block=256, device=card)
    assert lp.LAUNCHES["tile_topq"] == 8
    want_e, want_s = lp._link_prediction_similarity_plain(
        g, 300, metric=metric, block=256, device=card)
    assert np.array_equal(got_e, want_e)
    assert np.array_equal(got_s.view(np.int32), want_s.view(np.int32))
    if metric == "jaccard":
        cpu_e, cpu_s = lp.link_prediction_similarity(
            g, 300, metric=metric, block=256, device="cpu")
        assert np.array_equal(got_e, cpu_e) and np.array_equal(got_s, cpu_s)


@pytest.mark.cuda
def test_auc_plan_on_card(card):
    n = 800
    rng = np.random.default_rng(21)
    mask = np.triu(rng.random((n, n)) < 0.01, 1)
    el = np.concatenate([np.stack(np.nonzero(mask), axis=1),
                         np.stack([np.full(600, 5), np.arange(100, 700)],
                                  axis=1)])
    g = build_csr(el.astype(np.int64), num_nodes=n)
    train, test = lp.extract_random_test_edges(g, 200, seed=1)
    for metric in ("jaccard", "overlap", "adamic_adar"):
        plan = lp.AUCPlan(g, train, test, 3000, metric=metric, seed=2,
                          device=card)
        assert plan._split.hub[0].shape[0] > 0   # some pairs take K19
        vs.reset_launches()
        lp.reset_launches()
        got = plan.counts(1, 5)
        assert vs.LAUNCHES["pair_scores"] == vs.LAUNCHES["pair_scores_hub"] \
            == lp.LAUNCHES["auc_count"] == 5
        want = plan._counts_with(1, 5, lp._score_into_plain,
                                 lp.auc_count_plain)
        if metric == "adamic_adar":
            assert np.abs(got - want).max() <= 3
        else:
            assert np.array_equal(got, want)
            cpu = lp.AUCPlan(g, train, test, 3000, metric=metric, seed=2,
                             device="cpu")
            assert np.array_equal(got, cpu.counts(1, 5))


def _coloring_graph(seed):
    """RMAT-11 plus two hubs (degrees about 1,600 and 600, buckets 2,048
    and 1,024) and a 40-clique: every bucket width from 32 to 2,048, and
    same-bucket races everywhere."""
    rng = np.random.default_rng(seed)
    n = 2048
    el = [generate_rmat_el(11, 16, seed=27491095),
          np.stack([np.full(3000, 7), rng.choice(n, 3000)], axis=1),
          np.stack([np.full(700, 11), rng.choice(n, 700)], axis=1)]
    blk = rng.choice(n, 40, replace=False)
    el.append(np.array([[a, b] for i, a in enumerate(blk)
                        for b in blk[i + 1:]]))
    return build_csr(np.concatenate(el).astype(np.int64), num_nodes=n)


def _states(g, card, rounds=3):
    """Round-start colors of a speculative JP run from all-uncolored
    (plain), with its random priorities."""
    n = g.num_nodes
    prio = torch.from_numpy(gc.jp_priorities(g, "random", 1)).to(card)
    tiers = gc._TierGraph(g).to(card)
    col = gc._initial_colors(n, card)
    states = [col]
    for _ in range(rounds):
        col = gc.spec_round_plain(col, prio, tiers)
        states.append(col)
    return prio, tiers, states


def _wide_row_el(seed=27491095):
    """RMAT-10 plus a star: vertex 3 joined to 1,100 leaves among 2,048
    vertices, a row of more than 1,024 entries (the 2,048-wide bucket, a
    block a row in K24's rounds); (edge list, vertex count). The CPU tests
    of tests/test_torch_coloring_rounds.py hold the port to gms_tpu on the
    same graph."""
    n = 2048
    rng = np.random.default_rng(seed)
    leaves = rng.choice(np.delete(np.arange(n), 3), 1100, replace=False)
    el = np.concatenate([generate_rmat_el(10, 16, seed=seed),
                         np.stack([np.full(1100, 3), leaves], axis=1)])
    return el.astype(np.int64), n


@pytest.mark.cuda
def test_color_rounds_on_card(card):
    g = _coloring_graph(3)
    n = g.num_nodes
    prio, tiers, states = _states(g, card)
    assert [t.shape[1] for _, t in tiers][-1] == 2048
    deg1 = torch.from_numpy(np.concatenate([g.degrees + 1, [1]])
                            .astype(np.int32)).to(card)
    gen = torch.Generator(device=card)
    gen.manual_seed(5)
    j0, o0 = gc.LAUNCHES["color_johansson"], gc.LAUNCHES["color_one_shot"]
    for col in states:
        for ids, nbrt in tiers:
            got = _launched("color_jp", lambda: gc.jp_bucket(
                col.clone(), prio, ids, nbrt), gc.LAUNCHES)
            assert torch.equal(got, gc.jp_bucket_plain(col.clone(), prio,
                                                       ids, nbrt))
            pk = _launched("color_spec", lambda: gc.spec_pick(
                col, ids, nbrt, col.clone()), gc.LAUNCHES)
            assert torch.equal(pk, gc.spec_pick_plain(col, ids, nbrt,
                                                      col.clone()))
        assert torch.equal(gc.jp_round(col, prio, tiers),
                           gc.jp_round_plain(col, prio, tiers))
        assert torch.equal(gc.spec_round(col, prio, tiers),
                           gc.spec_round_plain(col, prio, tiers))
        draws = torch.randint(0, (1 << 31) - 1, (n + 1,), generator=gen,
                              device=card, dtype=torch.int32)
        assert torch.equal(gc.johansson_round(col, deg1, draws, tiers),
                           gc.johansson_round_plain(col, deg1, draws, tiers))
        # the one-shot's raw 64-bit words, any bit pattern
        draws = torch.randint(-(1 << 63), (1 << 63) - 1, (2, n + 1),
                              generator=gen, device=card, dtype=torch.int64)
        for palette_deg in (False, True):
            got = gc.one_shot_round(col, deg1, draws, tiers,
                                    palette_deg=palette_deg,
                                    delta=g.max_degree)
            want = gc.one_shot_round_plain(col, deg1, draws, tiers,
                                           palette_deg=palette_deg,
                                           delta=g.max_degree)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])
    # K24's launches a round, whatever the number of buckets: Johansson two
    # (pick words, round), the one-shot two (pick, resolve)
    assert gc.LAUNCHES["color_johansson"] - j0 == 2 * len(states)
    assert gc.LAUNCHES["color_one_shot"] - o0 == 2 * 2 * len(states)


@pytest.mark.cuda
def test_random_rounds_wide_rows_on_card(card):
    """johansson_round and one_shot_round (Barenboim and Elkin) against
    their plain versions on a graph with a row of 1,100 entries, on the
    first round and a later one, with the entry points' own draws; each a
    fixed number of launches a round."""
    from gms_tpu_torch import prng

    el, n = _wide_row_el()
    g = build_csr(el, num_nodes=n)
    tiers = gc._TierGraph(g).to(card)
    assert tiers[-1][1].shape[1] == 2048 and g.max_degree > 1024
    deg1 = torch.from_numpy(np.concatenate([g.degrees + 1, [1]])
                            .astype(np.int32)).to(card)
    key = prng.key(5, card)
    col = gc._initial_colors(n, card)
    for r in range(3):
        draws = gc.johansson_draws(key, r, deg1)
        before = gc.LAUNCHES["color_johansson"]
        got = gc.johansson_round(col, deg1, draws, tiers)
        assert gc.LAUNCHES["color_johansson"] - before == 2
        want = gc.johansson_round_plain(col, deg1, draws, tiers)
        assert torch.equal(got, want), r
        col = want
    assert (col[:n] == -1).any() and (col[:n] >= 0).any()
    for palette_deg in (False, True):
        col = gc._initial_colors(n, card)
        for r in range(3):
            draws = gc.one_shot_draws(key, r, n + 1)
            kw = dict(palette_deg=palette_deg, delta=g.max_degree)
            before = gc.LAUNCHES["color_one_shot"]
            got = gc.one_shot_round(col, deg1, draws, tiers, **kw)
            assert gc.LAUNCHES["color_one_shot"] - before == 2
            want = gc.one_shot_round_plain(col, deg1, draws, tiers, **kw)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1]), r
            col = want[0]
        assert (col[:n] >= 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("limit", [1, 3, 64])
@pytest.mark.parametrize("graph", ["rmat12", "wide"])
def test_jp_run_on_card(card, graph, limit):
    """K22's cooperative dispatch against jp_run_plain: colors and rounds,
    from all-uncolored and from a speculative round-start state, on the
    RMAT-12 tiers and on a graph whose widest bucket (2,048) takes a block
    a row."""
    g = (build_csr(generate_rmat_el(12, 16, seed=27491095),
                   num_nodes=1 << 12) if graph == "rmat12"
         else _coloring_graph(5))
    n = g.num_nodes
    prio, tiers, states = _states(g, card, rounds=2)
    assert graph == "rmat12" or tiers[-1][1].shape[1] == 2048
    for col in states[::2]:
        got, rounds = _launched("jp_run", lambda: gc.jp_run(
            col.clone(), prio, tiers, limit=limit, n=n), gc.LAUNCHES)
        want, wrounds = gc.jp_run_plain(col.clone(), prio, tiers,
                                        limit=limit, n=n)
        assert torch.equal(got, want)
        assert rounds.dtype == torch.int32 and int(rounds) == wrounds > 0
        assert wrounds == limit or not (want[:n] == -1).any()
    # every vertex colored: no round; no bucket: limit empty rounds
    done = gc.jp_run(gc.jp_run_plain(states[0].clone(), prio, tiers,
                                     limit=n, n=n)[0], prio, tiers,
                     limit=limit, n=n)
    assert int(done[1]) == 0
    empty = gc.jp_run(states[0].clone(), prio, [], limit=limit, n=n)
    assert int(empty[1]) == limit and torch.equal(empty[0], states[0])


@pytest.mark.cuda
@pytest.mark.parametrize("limit", [1, 3, 64])
def test_jp_run_uncovered_vertex_on_card(card, limit):
    """Tiers that leave an uncolored vertex out of every bucket: once the
    buckets have no uncolored row, jp_run counts the rounds to the limit as
    jp_run_plain runs them, and every block leaves the launch."""
    g = build_csr(generate_rmat_el(12, 16, seed=27491095), num_nodes=1 << 12)
    n = g.num_nodes
    prio, tiers, states = _states(g, card, rounds=2)
    ids = tiers[0][0].clone()
    assert int(ids[0]) < n and int(states[0][ids[0].long()]) == -1
    ids[0] = n                                 # the dump slot, colored 0
    tiers = [(ids, tiers[0][1])] + list(tiers[1:])
    got, rounds = _launched("jp_run", lambda: gc.jp_run(
        states[0].clone(), prio, tiers, limit=limit, n=n), gc.LAUNCHES)
    want, wrounds = gc.jp_run_plain(states[0].clone(), prio, tiers,
                                    limit=limit, n=n)
    assert torch.equal(got, want)
    assert int(rounds) == wrounds == limit and (want[:n] == -1).any()


@pytest.mark.cuda
@pytest.mark.parametrize("limit", [1, 64])
def test_spec_run_on_card(card, limit):
    """K23's cooperative dispatch against spec_run_plain, colors and rounds:
    from each round-start state of a speculative run over every vertex's
    tiers (the last bucket 2,048 wide: a block a row), from the second over
    its uncolored frontier's tiers, from a colored state (no round), with
    no bucket and with an uncolored vertex left out of every bucket (both
    to the limit)."""
    g = _coloring_graph(3)
    n = g.num_nodes
    prio, tiers, states = _states(g, card)
    assert tiers[-1][1].shape[1] == 2048
    frontier = gc._TierGraph(g, ids=np.nonzero(
        states[1][:n].cpu().numpy() == -1)[0]).to(card)
    ids = tiers[0][0].clone()
    assert int(states[0][ids[0].long()]) == -1
    ids[0] = n                                 # the dump slot, colored 0
    uncovered = [(ids, tiers[0][1])] + list(tiers[1:])
    done = gc.spec_run_plain(states[0].clone(), prio, tiers, limit=n,
                             n=n)[0]
    runs = [(col, tiers) for col in states] + [
        (states[1], frontier), (done, tiers), (states[0], []),
        (states[0], uncovered)]
    for col, tt in runs:
        got, rounds = _launched("spec_run", lambda: gc.spec_run(
            col.clone(), prio, tt, limit=limit, n=n), gc.LAUNCHES)
        want, wrounds = gc.spec_run_plain(col.clone(), prio, tt, limit=limit,
                                          n=n)
        assert torch.equal(got, want)
        assert rounds.dtype == torch.int32 and int(rounds) == wrounds
        assert wrounds == limit or not (want[:n] == -1).any()
    assert int(rounds) == limit and (want[:n] == -1).any()


@pytest.mark.cuda
@pytest.mark.parametrize("limit", [1, 3, 64])
def test_component_step_on_card(card, limit):
    rng = np.random.default_rng(limit)
    n = 3000
    p = rng.permutation(n)
    el = np.concatenate([np.stack([p[:-1], p[1:]], axis=1)[:2000],
                         rng.integers(0, n, (500, 2))])
    fg = build_csr(el.astype(np.int64), num_nodes=n)
    indptr = torch.from_numpy(fg.indptr).to(card)
    indices = torch.from_numpy(fg.indices).to(card)
    comp = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(card)
    nxt, changed = _launched("color_components", lambda: gc.component_step(
        indptr, indices, comp), gc.LAUNCHES)
    want, wchanged = gc.component_step_plain(indptr, indices, comp)
    assert torch.equal(nxt, want) and torch.equal(changed, wchanged)
    assert torch.equal(gc.component_labels(indptr, indices, limit),
                       gc.component_labels_plain(indptr, indices, limit))


def _star_csr(card, leaves=20_000, scale=9):
    """A star of `leaves` leaves (one row of 40 schedule segments) beside
    an RMAT graph and empty rows, on the card: (g, indptr, indices)."""
    rmat = generate_rmat_el(scale, 8, seed=5) + leaves + 1
    star = np.stack([np.zeros(leaves, np.int64),
                     np.arange(1, leaves + 1, dtype=np.int64)], axis=1)
    g = build_csr(np.concatenate([star, rmat]),
                  num_nodes=leaves + 1 + (1 << scale) + 5)
    return (g, torch.from_numpy(g.indptr).to(card),
            torch.from_numpy(g.indices).to(card))


@pytest.mark.cuda
def test_component_step_on_a_wide_row_on_card(card):
    from gms_tpu_torch.graphs.row_schedule import build_row_schedule

    g, indptr, indices = _star_csr(card)
    sched = build_row_schedule(indptr)
    assert sched.n_wide >= 1
    rng = np.random.default_rng(4)
    for _ in range(2):
        comp = torch.from_numpy(rng.permutation(g.num_nodes).astype(
            np.int32)).to(card)
        nxt, changed = _launched("color_components", lambda: gc.component_step(
            indptr, indices, comp, schedule=sched), gc.LAUNCHES)
        want = comp.clone().scatter_reduce_(
            0, torch.repeat_interleave(torch.arange(g.num_nodes, device=card),
                                       indptr.diff()),
            comp[indices.long()], "amin")
        assert torch.equal(nxt, want)
        assert int(changed) == int((want != comp).any())
    step, _ = gc.component_step(indptr, indices, nxt)
    assert torch.equal(step, gc.component_step_plain(indptr, indices, nxt)[0])


@pytest.mark.cuda
def test_coloring_entry_points_on_card(card):
    g = _coloring_graph(4)
    for speculative in (False, True):
        for priority in ("random", "degree", "id"):
            got = gc.jones_plassmann(g, priority=priority,
                                     speculative=speculative, device=card)
            assert np.array_equal(got, gc.jones_plassmann(
                g, priority=priority, speculative=speculative, device="cpu"))
    for fn in (6, 12):
        gc.reset_launches()
        got = gc.dense_sparse(g, friend_number=fn, device=card)
        assert gc.LAUNCHES["color_components"] > 0
        assert np.array_equal(got, gc.dense_sparse(g, friend_number=fn,
                                                   device="cpu"))
    c = gc.johansson(g, device=card)
    assert gc.verify_coloring(g, c) and gc.verify_degree_bound(g, c)
    assert np.array_equal(c, gc.johansson(g, device="cpu"))
    for variant in ("barenboim", "elkin"):
        c = gc.barenboim_elkin(g, variant=variant, device=card)
        assert gc.verify_coloring(g, c) and gc.verify_delta_plus_one(g, c)
        if variant == "elkin":
            assert gc.verify_degree_bound(g, c)
        assert np.array_equal(c, gc.barenboim_elkin(g, variant=variant,
                                                    device="cpu"))


# --- VF2 (K26, K27) and the k-bit decode (K28) --------------------------------

def _vf2_level(card, scale, use_bmp):
    """A level's inputs from the port's own search on RMAT `scale`: the
    items and candidates of c5's level 2 (induced), on `card`."""
    g = build_csr(generate_rmat_el(scale, 8, seed=3), num_nodes=1 << scale)
    pg = PaddedGraph.from_csr(g, device=card)
    deg1 = torch.cat([pg.deg, pg.deg.new_zeros(1)])
    bmp = (si._id_bitmap(g, card) if use_bmp
           else torch.zeros((1, 1), dtype=torch.int32, device=card))
    roots = torch.arange(0, 1 << scale, 3, dtype=torch.int32, device=card)
    M = torch.full((roots.numel(), 5), -1, dtype=torch.int32, device=card)
    M[:, 0] = roots
    M[::7, 0] = -1
    cand = pg.nbr.index_select(0, M[:, 0].long().clamp(0, pg.v_pad - 1))
    ok, _ = si.feasible_plain(M, cand, pg.nbr, deg1, bmp, 2, d=1,
                              parents=(0,), nonparents=(), induced=True)
    M2, _ = si.emit_plain(M, cand, ok, d=1, cap=int(ok.sum()))
    cand2 = pg.nbr.index_select(0, M2[:, 1].long())
    return M2, cand2, pg.nbr, deg1, bmp


@pytest.mark.cuda
@pytest.mark.parametrize("use_bmp", [True, False])
@pytest.mark.parametrize("induced", [True, False])
def test_vf2_feasible_on_card(card, use_bmp, induced):
    M, cand, nbr, deg1, bmp = _vf2_level(card, 10, use_bmp)
    for d, parents, nonparents in ((2, (1,), (0,)), (2, (0, 1), ())):
        ok, count = _launched("vf2_feasible", lambda: si.feasible(
            M, cand, nbr, deg1, bmp, 2, d=d, parents=parents,
            nonparents=nonparents, induced=induced), si.LAUNCHES)
        want, wcount = si.feasible_plain(M, cand, nbr, deg1, bmp, 2, d=d,
                                         parents=parents,
                                         nonparents=nonparents,
                                         induced=induced)
        assert torch.equal(ok, want) and torch.equal(count, wcount)
        assert int(count) > 0
    # a disconnected level: blocks of all ids
    ids = torch.full((256,), int(SENTINEL), dtype=torch.int32, device=card)
    ids[:200] = torch.arange(200, dtype=torch.int32, device=card)
    blk = ids.expand(M.shape[0], 256).contiguous()
    got = si.feasible(M, blk, nbr, deg1, bmp, 1, d=2, parents=(),
                      nonparents=(0, 1), induced=induced)
    want = si.feasible_plain(M, blk, nbr, deg1, bmp, 1, d=2, parents=(),
                             nonparents=(0, 1), induced=induced)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("cap", ["bucket", 7, "beyond", 0])
def test_vf2_emit_on_card(card, cap):
    M, cand, nbr, deg1, bmp = _vf2_level(card, 9, True)
    ok, count = si.feasible(M, cand, nbr, deg1, bmp, 2, d=2, parents=(1,),
                            nonparents=(0,), induced=True)
    nc = int(count)
    cap = {"bucket": kc._bucket(nc), 7: 7, "beyond": ok.numel() + 5,
           0: 0}[cap]
    out, n_out = _launched("vf2_emit", lambda: si.emit(M, cand, ok, d=2,
                                                   cap=cap), si.LAUNCHES)
    want, want_n = si.emit_plain(M, cand, ok, d=2, cap=cap)
    assert torch.equal(out, want) and torch.equal(n_out, want_n)
    assert int(n_out) == nc


@pytest.mark.cuda
def test_subgraph_isomorphism_on_card(card):
    g = build_csr(generate_rmat_el(9, 16, seed=27491095), num_nodes=512)
    for pedges in si.VF2_PATTERNS.values():
        p = build_csr(np.array(pedges, dtype=np.int64))
        si.reset_launches()
        hyb = si.subgraph_isomorphism(g, p, induced=True, device=card)
        assert si.LAUNCHES == {"vf2_feasible": 0, "vf2_emit": 0}
        dev = si.subgraph_isomorphism(g, p, induced=True, host_budget=0,
                                      device=card)
        assert si.LAUNCHES["vf2_feasible"] > 0 and si.LAUNCHES["vf2_emit"] > 0
        want = si.subgraph_isomorphism(g, p, induced=True, host_budget=0,
                                       device="cpu")
        assert np.array_equal(dev, want) and np.array_equal(hyb, want)
    small = build_csr(generate_rmat_el(7, 4, seed=1), num_nodes=128)
    p = build_csr(np.array(si.VF2_PATTERNS["p4"], dtype=np.int64))
    for budget in (1 << 18, 1 << 11):
        got = si.subgraph_isomorphism(small, p, limit=None,
                                      item_budget=budget, device=card)
        assert np.array_equal(got, si.subgraph_isomorphism(
            small, p, limit=None, item_budget=budget, device="cpu"))
    two = build_csr(np.array([[0, 1], [2, 3]], dtype=np.int64), num_nodes=4)
    assert np.array_equal(
        si.subgraph_isomorphism(small, two, limit=None, device=card),
        si.subgraph_isomorphism(small, two, limit=None, device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8, 13, 16, 17, 24, 31, 32])
def test_kbit_decode_rows_on_card(card, k):
    rng = np.random.default_rng(k)
    V, d_pad = 301, 200
    W = (d_pad * k + 31) // 32 + 1
    packed = torch.from_numpy(rng.integers(0, 1 << 32, (V, W), dtype=np.uint64)
                              .astype(np.uint32).view(np.int32)).to(card)
    deg = torch.from_numpy(rng.integers(0, d_pad + 1, V).astype(np.int32)
                           ).to(card)
    vids = torch.from_numpy(rng.integers(-9, V + 9, 5000).astype(np.int32)
                            ).to(card)
    got = _launched("kbit_decode_rows", lambda: cp.kbit_decode_rows(
        packed, deg, vids, k=k, d_pad=d_pad), cp.LAUNCHES)
    assert torch.equal(got, cp.kbit_decode_rows_plain(packed, deg, vids, k=k,
                                                      d_pad=d_pad))


@pytest.mark.cuda
def test_compressed_forms_on_card(card):
    g = build_csr(generate_rmat_el(10, 16, seed=27491095), num_nodes=1024)
    want_rows = PaddedGraph.from_csr(g, device="cpu").nbr
    want = tc.triangle_count_oracle(g)
    for make in (cp.KbitGraph.from_csr, cp.KbitGraphBucketed.from_csr,
                 cp.HybridGraph.from_csr):
        rep = make(g, device=card)
        assert cp.as_csr(rep) == g
        assert tc.triangle_count(rep, device=card) == want
    kg = cp.KbitGraph.from_csr(g, device=card)
    assert torch.equal(kg.nbr.cpu(), want_rows)
    w = np.arange(g.num_edges, dtype=np.int32) % 13 + 1
    kw = cp.KbitWeightedGraph.from_csr(g, w, device=card)
    assert torch.equal(kw.weight_rows().cpu(), cp.KbitWeightedGraph.from_csr(
        g, w, device="cpu").weight_rows())


# --- the GAPBS steps (K29-K34) -------------------------------------------------

def _gapbs_graph(card, scale=9, isolated=7):
    """RMAT `scale` plus isolated vertices (empty rows, degree 0) on the card:
    (g, indptr, indices)."""
    from gms_tpu_torch.algorithms import gapbs  # noqa: F401

    n = (1 << scale) + isolated
    g = build_csr(generate_rmat_el(scale, 8, seed=3), num_nodes=n)
    return (g, torch.from_numpy(g.indptr).to(card),
            torch.from_numpy(g.indices).to(card))


def _bfs_state(g, card, source, levels):
    from gms_tpu_torch.algorithms import gapbs

    d = gapbs.bfs_oracle(g, source)
    dist = np.where((d < 0) | (d > levels), gapbs.INF, d).astype(np.int32)
    return torch.from_numpy(dist).to(card)


@pytest.mark.cuda
@pytest.mark.parametrize("source", [0, "isolated"])
def test_bfs_steps_on_card(card, source):
    from gms_tpu_torch.algorithms import gapbs

    g, indptr, indices = _gapbs_graph(card)
    s = 0 if source == 0 else g.num_nodes - 1     # no neighbours
    for it in range(4):
        dist = _bfs_state(g, card, s, it)
        got, want = dist.clone(), dist.clone()
        c = _launched("bfs_pull", lambda: gapbs.bfs_pull(
            indptr, indices, got, it), gapbs.LAUNCHES)
        wc = gapbs.bfs_pull_plain(indptr, indices, want, it)
        assert torch.equal(got, want) and int(c) == int(wc)
        ids, fc = _launched("frontier_ids", lambda: gapbs.frontier_ids(
            dist, it), gapbs.LAUNCHES)
        wids, wfc = gapbs.frontier_ids_plain(dist, it)
        assert int(fc) == int(wfc)
        assert torch.equal(ids[:int(fc)].sort().values,
                           wids[:int(wfc)].sort().values)
        got, want = dist.clone(), dist.clone()
        nxt, nc = _launched("bfs_push", lambda: gapbs.bfs_push(
            indptr, indices, ids, int(fc), got, it), gapbs.LAUNCHES)
        wn, wnc = gapbs.bfs_push_plain(indptr, indices, wids, int(wfc), want,
                                       it)
        assert torch.equal(got, want) and int(nc) == int(wnc)
        assert torch.equal(nxt[:int(nc)].sort().values,
                           wn[:int(wnc)].sort().values)


def _push_case(kind, seed=11):
    """A push level's inputs as numpy: (el, n, ids, fcount, dist, it).
    "star": the centre of a 2,600-leaf star (six segments of 512 entries)
    alone in the frontier; "mixed": a frontier of 3,000 rows over three
    scan tiles of 1,024, empty, narrow (1-8 entries), middle (9-511), 512,
    513 and wide (1,500 and 2,600 entries) rows in random order, some of
    their neighbours already reached. ids run past fcount."""
    rng = np.random.default_rng(seed)
    if kind == "star":
        leaves = 2600
        el = np.stack([np.zeros(leaves, np.int64),
                       np.arange(1, leaves + 1, dtype=np.int64)], axis=1)
        n = leaves + 5
        front = np.array([0])
        dist = np.full(n, np.iinfo(np.int32).max, np.int32)
    else:
        n = 12_000
        front = rng.choice(n, 3000, replace=False)
        sizes = np.concatenate([
            np.zeros(400, np.int64), rng.integers(1, 9, 1500),
            rng.integers(9, 512, 1080), np.array([512] * 4 + [513] * 4
                                                 + [1500] * 6 + [2600] * 6)])
        rng.shuffle(sizes)
        el = np.concatenate([np.stack([np.full(d, v, np.int64),
                                       rng.choice(n, d, replace=False)], 1)
                             for v, d in zip(front, sizes) if d > 0])
        el = el[el[:, 0] != el[:, 1]]
        dist = np.where(rng.random(n) < 0.3, 1, np.iinfo(np.int32).max
                        ).astype(np.int32)
    it = 2
    dist[front] = it
    ids = np.concatenate([front, rng.integers(0, n, 7)]).astype(np.int32)
    return el, n, ids, len(front), dist, it


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["star", "mixed"])
def test_bfs_push_segments_on_card(card, kind):
    from gms_tpu_torch.algorithms import gapbs

    el, n, ids, fcount, dist, it = _push_case(kind)
    g = build_csr(el, num_nodes=n)
    indptr = torch.from_numpy(g.indptr).to(card)
    indices = torch.from_numpy(g.indices).to(card)
    ids = torch.from_numpy(ids).to(card)
    got = torch.from_numpy(dist).to(card)
    want = got.clone()
    nxt, nc = _launched("bfs_push", lambda: gapbs.bfs_push(
        indptr, indices, ids, fcount, got, it), gapbs.LAUNCHES)
    wn, wnc = gapbs.bfs_push_plain(indptr, indices, ids, fcount, want, it)
    assert torch.equal(got, want) and int(nc) == int(wnc) > 0
    assert torch.equal(nxt[:int(nc)].sort().values,
                       wn[:int(wnc)].sort().values)
    # the same level again reaches nothing new, nor does an empty frontier
    for fc in (fcount, 0):
        _, c2 = gapbs.bfs_push(indptr, indices, ids, fc, got, it)
        assert int(c2) == 0 and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 13, 17, 32])
def test_bfs_kbit_pull_on_card(card, k):
    from gms_tpu_torch.algorithms import gapbs

    g, indptr, indices = _gapbs_graph(card)
    n = g.num_nodes
    if k == 1:
        # 1-bit ids: a graph on vertices {0, 1} plus isolated ones
        g = build_csr(np.array([[0, 1]], dtype=np.int64), num_nodes=2)
        n = 2
    kg = cp.KbitGraph.from_csr(g, k=max(k, cp._bits_for(n)), device=card)
    for it in range(3):
        dist = _bfs_state(g, card, 0, it)
        got, want = dist.clone(), dist.clone()
        c = _launched("bfs_kbit_pull", lambda: gapbs.bfs_kbit_pull(
            kg.packed, kg.deg, got, it, k=kg.k, d_pad=kg.d_pad),
            gapbs.LAUNCHES)
        wc = gapbs.bfs_kbit_pull_plain(kg.packed, kg.deg, want, it, k=kg.k,
                                       d_pad=kg.d_pad)
        assert torch.equal(got, want) and int(c) == int(wc)
    assert np.array_equal(gapbs.bfs_kbit(kg, 0, device=card),
                          gapbs.bfs_oracle(g, 0).astype(np.int32))


@pytest.mark.cuda
def test_pr_pull_on_a_wide_row_on_card(card):
    from gms_tpu_torch.algorithms import gapbs
    from gms_tpu_torch.graphs.row_schedule import build_row_schedule

    g, indptr, indices = _star_csr(card)
    n = g.num_nodes
    sched = build_row_schedule(indptr)
    assert sched.n_wide >= 1
    rng = np.random.default_rng(6)
    deg = torch.from_numpy(g.degrees.astype(np.int32)).to(card)
    pr = torch.from_numpy(rng.random(n).astype(np.float32)).to(card)
    got = _launched("pr_pull", lambda: gapbs.pr_pull(
        indptr, indices, deg, pr, 1e-4, 0.85, schedule=sched),
        gapbs.LAUNCHES)
    torch.testing.assert_close(got, gapbs.pr_pull_plain(
        indptr, indices, deg, pr, 1e-4, 0.85), rtol=1e-5, atol=0)
    # the same bits on every run, the schedule built here or given
    assert torch.equal(got, gapbs.pr_pull(indptr, indices, deg, pr, 1e-4,
                                          0.85, schedule=sched))
    assert torch.equal(got, gapbs.pr_pull(indptr, indices, deg, pr, 1e-4,
                                          0.85))
    np.testing.assert_allclose(gapbs.pagerank(g, iters=5, device=card),
                               gapbs.pagerank(g, iters=5, device="cpu"),
                               rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_pr_and_min_steps_on_card(card):
    from gms_tpu_torch.algorithms import gapbs

    g, indptr, indices = _gapbs_graph(card)
    n = g.num_nodes
    rng = np.random.default_rng(2)
    deg = torch.from_numpy(g.degrees.astype(np.int32)).to(card)
    pr = torch.from_numpy(rng.random(n).astype(np.float32)).to(card)
    got = _launched("pr_pull", lambda: gapbs.pr_pull(
        indptr, indices, deg, pr, 1e-4, 0.85), gapbs.LAUNCHES)
    torch.testing.assert_close(got, gapbs.pr_pull_plain(
        indptr, indices, deg, pr, 1e-4, 0.85), rtol=1e-5, atol=0)
    cur = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(card)
    nxt, ch = _launched("cc_step", lambda: gapbs.cc_step(indptr, indices, cur),
                        gapbs.LAUNCHES)
    want, wch = gapbs.cc_step_plain(indptr, indices, cur)
    assert torch.equal(nxt, want) and torch.equal(ch, wch)
    d = np.where(rng.random(n) < 0.2, rng.integers(0, 30, n), gapbs.BIG)
    cur = torch.from_numpy(d).to(card)
    w = torch.from_numpy(rng.integers(1, 10, g.num_edges).astype(np.int32)
                         ).to(card)
    for weights in (w, None):
        nxt, ch = _launched("sssp_step", lambda: gapbs.sssp_step(
            indptr, indices, weights, cur), gapbs.LAUNCHES)
        want, wch = gapbs.sssp_step_plain(indptr, indices, weights, cur)
        assert torch.equal(nxt, want) and torch.equal(ch, wch)
    fixed = gapbs.cc_step(indptr, indices, torch.from_numpy(
        gapbs.cc_oracle(g).astype(np.int32)).to(card))
    assert int(fixed[1]) == 0


def _star_rows(card, leaves):
    """Stars of 300, 700 and `leaves` leaves (their hubs rows of one, two
    and ceil(leaves / 512) schedule segments) beside a path of 40 vertices
    (rows of at most two entries) and isolated vertices: (g, indptr,
    indices)."""
    el, nxt = [], 3
    for c, k in enumerate((300, 700, leaves)):
        el += [[c, leaf] for leaf in range(nxt, nxt + k)]
        nxt += k
    el += [[v, v + 1] for v in range(nxt, nxt + 39)]
    g = build_csr(np.array(el, np.int64), num_nodes=nxt + 45)
    return (g, torch.from_numpy(g.indptr).to(card),
            torch.from_numpy(g.indices).to(card))


@pytest.mark.cuda
@pytest.mark.parametrize("graph", ["stars", "path"])
def test_min_steps_on_the_schedule_on_card(card, graph):
    """K33 on the row schedule against plain: hub rows of 1, 2 and 3
    segments (the atomicMin fold), a graph of narrow rows only, CC and SSSP
    (weighted and unit), the schedule given or built; then a state where
    nothing moves, whose changed flag stays 0."""
    from gms_tpu_torch.algorithms import gapbs
    from gms_tpu_torch.graphs.row_schedule import build_row_schedule

    if graph == "stars":
        g, indptr, indices = _star_rows(card, 1300)
    else:
        n = 200
        el = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
        g = build_csr(el.astype(np.int64), num_nodes=n + 3)
        indptr = torch.from_numpy(g.indptr).to(card)
        indices = torch.from_numpy(g.indices).to(card)
    n = g.num_nodes
    sched = build_row_schedule(indptr)
    assert sched.n_wide == (2 if graph == "stars" else 0)
    assert sched.n_seg == (1 + 2 + 3 if graph == "stars" else 0)
    rng = np.random.default_rng(8)
    # symmetric weights, 1..9 a slot, as the sssp oracle reads them
    u = np.repeat(np.arange(n), g.degrees.astype(np.int64))
    w_host = (1 + ((u ^ g.indices) % 9)).astype(np.int32)
    w = torch.from_numpy(w_host).to(card)
    for schedule in (sched, None):
        cur = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(card)
        nxt, ch = _launched("cc_step", lambda: gapbs.cc_step(
            indptr, indices, cur, schedule=schedule), gapbs.LAUNCHES)
        want, wch = gapbs.cc_step_plain(indptr, indices, cur)
        assert torch.equal(nxt, want) and torch.equal(ch, wch)
        d = np.where(rng.random(n) < 0.3, rng.integers(0, 50, n), gapbs.BIG)
        cur = torch.from_numpy(d).to(card)
        for weights in (w, None):
            nxt, ch = _launched("sssp_step", lambda: gapbs.sssp_step(
                indptr, indices, weights, cur, schedule=schedule),
                gapbs.LAUNCHES)
            want, wch = gapbs.sssp_step_plain(indptr, indices, weights, cur)
            assert torch.equal(nxt, want) and torch.equal(ch, wch)
    # fixpoints: nothing moves
    labels = torch.from_numpy(gapbs.cc_oracle(g).astype(np.int32)).to(card)
    nxt, ch = gapbs.cc_step(indptr, indices, labels, schedule=sched)
    assert torch.equal(nxt, labels) and int(ch) == 0
    for weights, wh in ((w, w_host), (None, None)):
        dist = torch.from_numpy(gapbs.sssp(g, 0, wh, device=card)).to(card)
        dist = torch.where(dist < 0, gapbs.BIG, dist)
        nxt, ch = gapbs.sssp_step(indptr, indices, weights, dist,
                                  schedule=sched)
        assert torch.equal(nxt, dist) and int(ch) == 0
    np.testing.assert_array_equal(gapbs.connected_components(g, device=card),
                                  gapbs.cc_oracle(g))
    np.testing.assert_array_equal(gapbs.sssp(g, 0, w_host, device=card),
                                  gapbs.sssp_oracle(g, 0, w_host))


@pytest.mark.cuda
def test_bc_steps_on_card(card):
    from gms_tpu_torch.algorithms import gapbs

    g, indptr, indices = _gapbs_graph(card)
    n = g.num_nodes
    sources = np.array([0, 5, n - 1, 17], np.int32)   # n - 1: no neighbours
    depth = gapbs.bc_max_depth(g, device=card)
    before = gapbs.LAUNCHES["bc_forward"], gapbs.LAUNCHES["bc_backward"]
    got = gapbs._bc_total(indptr, indices, n, sources, depth)
    assert (gapbs.LAUNCHES["bc_forward"] - before[0]
            == gapbs.LAUNCHES["bc_backward"] - before[1] == depth)
    want = gapbs._bc_total(indptr, indices, n, sources, depth,
                           gapbs.bc_forward_plain, gapbs.bc_backward_plain)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    # the forward state exactly (sigma's sums are exact small integers here)
    lvl, seen, sigma, _ = gapbs.bc_state(n, [0, 5], depth, card)
    pl, ps, pg = lvl.clone(), seen.clone(), sigma.clone()
    for it in range(depth):
        gapbs.bc_forward(indptr, indices, lvl, seen, sigma, it)
        gapbs.bc_forward_plain(indptr, indices, pl, ps, pg, it)
    assert torch.equal(lvl, pl) and torch.equal(seen, ps)
    assert torch.equal(sigma, pg)
    assert torch.equal(gapbs.bc_dist(lvl, 2)[1].cpu(), torch.from_numpy(
        _bfs_state(g, card, 5, depth).cpu().numpy()))


def _bc_against_plain(card, g, indptr, indices, src, depth):
    """K34's steps against the plain ones from the same batch states: the
    forward state (lvl, seen, sigma) equal after every step, delta and the
    total within phase 48's tolerance. Returns the kernels' total."""
    from gms_tpu_torch.algorithms import gapbs
    from gms_tpu_torch.graphs.row_schedule import build_row_schedule

    n = g.num_nodes
    sched = build_row_schedule(indptr)
    total = torch.zeros(n, dtype=torch.float32, device=card)
    ptotal = torch.zeros_like(total)
    for b0 in range(0, len(src), gapbs.BC_BATCH):
        state = gapbs.bc_state(n, src[b0:b0 + gapbs.BC_BATCH], depth, card)
        lvl, seen, sigma, delta = state
        pl, ps, pg, pd = (t.clone() for t in state)
        for it in range(depth):
            _launched("bc_forward", lambda: gapbs.bc_forward(
                indptr, indices, lvl, seen, sigma, it, schedule=sched),
                gapbs.LAUNCHES)
            gapbs.bc_forward_plain(indptr, indices, pl, ps, pg, it)
            assert torch.equal(lvl, pl) and torch.equal(seen, ps)
            assert torch.equal(sigma, pg)
        for it in range(depth - 1, -1, -1):
            _launched("bc_backward", lambda: gapbs.bc_backward(
                indptr, indices, lvl, sigma, delta, it, total,
                schedule=sched), gapbs.LAUNCHES)
            gapbs.bc_backward_plain(indptr, indices, pl, pg, pd, it, ptotal)
        torch.testing.assert_close(delta, pd, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(total, ptotal, rtol=1e-4, atol=1e-5)
    return total


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["star", "rmat"])
@pytest.mark.parametrize("B", [1, 64, 65])
def test_bc_batches_on_card(card, kind, B):
    """K34 on the star of 20,000 leaves (a hub row of 40 segments) and on
    RMAT-10 with isolated vertices: B sources (65: a second batch of one),
    one of them a hub or without neighbours; the forward state bit for bit,
    and the same bits of the total on a second run."""
    from gms_tpu_torch.algorithms import gapbs

    if kind == "star":
        g, indptr, indices = _star_csr(card)
        first = 0
    else:
        g, indptr, indices = _gapbs_graph(card, scale=10)
        first = g.num_nodes - 1
    rng = np.random.default_rng(B)
    src = rng.choice(g.num_nodes, size=B, replace=False).astype(np.int32)
    # one source: a leaf of the star, vertex 0 of RMAT-10
    src[0] = first if B > 1 else int(kind == "star")
    depth = gapbs.bc_max_depth(g, device=card)
    got = _bc_against_plain(card, g, indptr, indices, src, depth)
    assert bool(got.any())
    again = gapbs._bc_total(indptr, indices, g.num_nodes, src, depth)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_gapbs_entry_points_on_card(card):
    from gms_tpu_torch.algorithms import gapbs

    g = build_csr(generate_rmat_el(10, 16, seed=27491095), num_nodes=1030)
    w = (np.arange(g.num_edges) % 7 + 1).astype(np.int32)
    for dopt in (True, False):
        assert np.array_equal(gapbs.bfs(g, 0, direction_optimizing=dopt,
                                        device=card),
                              gapbs.bfs(g, 0, direction_optimizing=dopt,
                                        device="cpu"))
    for make in (cp.KbitGraph.from_csr, cp.HybridGraph.from_csr,
                 cp.KbitGraphBucketed.from_csr):
        assert np.array_equal(gapbs.bfs(make(g, device=card), 0, device=card),
                              gapbs.bfs(g, 0, device="cpu"))
    assert np.array_equal(gapbs.connected_components(g, device=card),
                          gapbs.connected_components(g, device="cpu"))
    assert np.array_equal(gapbs.sssp(g, 0, w, device=card),
                          gapbs.sssp(g, 0, w, device="cpu"))
    kw = cp.KbitWeightedGraph.from_csr(g, w, device=card)
    assert np.array_equal(gapbs.sssp(kw, 0, device=card),
                          gapbs.sssp(g, 0, w, device="cpu"))
    np.testing.assert_allclose(gapbs.pagerank(g, device=card),
                               gapbs.pagerank(g, device="cpu"), rtol=1e-5)
    np.testing.assert_allclose(
        gapbs.betweenness_centrality(g, num_samples=40, device=card),
        gapbs.betweenness_centrality(g, num_samples=40, device="cpu"),
        rtol=1e-4, atol=1e-6)


# the direct Bron–Kerbosch variant (K35 init_items, K36 bk_direct_stack), the
# sharded k-clique levels (K37 expand_level, K38 total_popcount), and
# launches on a second card

@pytest.mark.cuda
@pytest.mark.parametrize("ww,D", [(1, 96), (3, 64), (32, 160)])
def test_init_items_on_card(card, ww, D):
    # W < D, W > D and W = 1024; roots include pad and negative ids, ranks a
    # permutation with the INT32_MAX tail gms_tpu gives rank_pad
    rng = np.random.default_rng(ww + D)
    V, n = 300, 290
    nbr = torch.from_numpy(_padded_rows(rng, V, D, n, D)).to(card)
    rank = np.full(V + 1, np.iinfo(np.int32).max, np.int32)
    rank[:n] = rng.permutation(n)
    roots = rng.integers(0, n, 70).astype(np.int32)
    roots[-3:] = (V, V + 11, -2)
    args = [torch.from_numpy(x).to(card) for x in (rank, roots)]
    cand, fini = _launched("init_items", lambda: bk.init_items(
        nbr, *args, w_words=ww), bk.LAUNCHES)
    pc, pf = bk.init_items_plain(nbr, *args, w_words=ww)
    assert torch.equal(cand, pc) and torch.equal(fini, pf)
    assert cand.any() and fini.any() and not (cand & fini).any()


def _direct_universe(nbr, rank_pad, chunk, ww):
    adj, _ = kc.build_local_adj(nbr, chunk, w_words=ww)
    cand, fini = bk.init_items(nbr, rank_pad, chunk, w_words=ww)
    return adj, cand, fini, chunk != nbr.shape[0]


def _check_direct(univ, depth=None):
    got, ovf = _launched("bk_direct_stack", lambda: bk.bk_direct_stack(
        *univ, depth=depth), bk.LAUNCHES)
    want, want_ovf = bk.bk_direct_stack_plain(*univ, depth=depth)
    assert bool(ovf) == bool(want_ovf)
    if not want_ovf:
        assert int(got) == int(want)
    return int(want), bool(ovf)


@pytest.mark.cuda
def test_bk_direct_stack_on_card(card):
    g = build_csr(generate_rmat_el(10, 16, seed=27491095), num_nodes=1024)
    rank, _ = degeneracy.degeneracy_ordering_rank(g)
    pg = PaddedGraph.from_csr(g, device=card, lane=32)
    rank_pad = np.full(pg.v_pad + 1, np.iinfo(np.int32).max, np.int32)
    rank_pad[:1024] = rank
    rank_pad = torch.from_numpy(rank_pad).to(card)
    roots = np.arange(1024, dtype=np.int32)
    chunks = [(torch.from_numpy(c).to(card), ww) for c, ww in
              kc.plan_tier_chunks(g.degrees, roots, pg.v_pad, root_chunk=128)]
    counts = [_check_direct(_direct_universe(pg.nbr, rank_pad, c, ww))[0]
              for c, ww in chunks]
    assert sum(counts) == bk.bron_kerbosch(g, device="cpu", rank=rank)
    chunk, ww = chunks[int(np.argmax(counts))]
    for w in (2 * ww, 8):  # wider: the paths move to device memory at 8
        univ = _direct_universe(pg.nbr, rank_pad, chunk, w)
        assert _check_direct(univ)[0] == max(counts)
    # paths too short: the kernel and the plain version report overflow
    univ = _direct_universe(pg.nbr, rank_pad, chunk, ww)
    assert _check_direct(univ, depth=2)[1]
    stats = {}
    bk.bk_direct_stack(*univ, stats=stats)
    assert stats["items"] >= 1 and 1 <= stats["max_items"] <= stats["items"]
    assert stats["warps"] >= 132
    # random symmetric bits at W = 256, random disjoint cand and fini
    rng = np.random.default_rng(5)
    dense = np.triu(rng.random((4, 256, 256)) < 0.3, 1)
    dense |= dense.transpose(0, 2, 1)
    pack = lambda b: torch.from_numpy(np.packbits(  # noqa: E731
        b, axis=-1, bitorder="little").view(np.int32).copy()).to(card)
    side = rng.random((4, 256))
    cand, fini = pack(side < 0.4), pack((side >= 0.4) & (side < 0.6))
    live = torch.tensor([True, True, False, True], device=card)
    assert _check_direct((pack(dense), cand, fini, live))[0] > 0


@pytest.mark.cuda
def test_bron_kerbosch_direct_on_card(card):
    g = build_csr(generate_rmat_el(9, 16, seed=27491095), num_nodes=512)
    want = bk.bron_kerbosch(g, device="cpu")
    bk.reset_launches()
    assert bk.bron_kerbosch(g, device=card, direct=True) == want
    assert bk.LAUNCHES["bk_direct_stack"] > 0
    assert bk.LAUNCHES["bk_stack_machine"] == 0  # no root above 1024
    assert bk.bron_kerbosch(g, device=card, direct=True,
                            hub_threshold=6) == want
    assert bk.LAUNCHES["bk_stack_machine"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("ww,N,cap,need", [
    (1, 5000, 100000, 2), (1, 5000, 777, 2), (3, 2100, 50, 0),
    (8, 300, 0, 3), (2, 4096, 9000, 1), (1, 400000, 3000000, 1)])
def test_expand_level_on_card(card, ww, N, cap, need):
    # from a few words a tile to 256 (the last case); cap above, below and
    # at 0
    rng = np.random.default_rng(ww * N + cap)
    C = 7
    adj = _sparse_bits(rng, (C, 32 * ww, ww), 0.3).to(card)
    S = _sparse_bits(rng, (N, ww), 0.2)
    S[::5] = 0
    S = S.to(card)
    R = torch.from_numpy(rng.integers(0, C, N).astype(np.int32)).to(card)
    got = _launched("expand_level", lambda: kc.expand_level(
        S, R, adj, cap=cap, need=need), kc.LAUNCHES)
    want = kc.expand_level_plain(S, R, adj, cap=cap, need=need)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[2]) > 0
    # only the rows below a live count (the rows past it left non-zero,
    # which the kernel must not read)
    live = torch.tensor(N // 3, dtype=torch.int64, device=card)
    got = _launched("expand_level", lambda: kc.expand_level(
        S, R, adj, cap=cap, need=need, n_live=live), kc.LAUNCHES)
    want = kc.expand_level_plain(S[:N // 3], R[:N // 3], adj, cap=cap,
                                 need=need)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(1, 0), (5, 1), (1027, 0), (1027, 3),
                                      (3_000_001, 0)])
def test_total_popcount_on_card(card, n, offset):
    # an offset of 1 or 3 words leaves the 16-byte loads unaligned
    rng = np.random.default_rng(n + offset)
    words = _sparse_bits(rng, (n + offset,), 0.5).to(card)[offset:]
    got = _launched("total_popcount", lambda: kc.total_popcount(words),
                    kc.LAUNCHES)
    assert int(got) == int(kc.total_popcount_plain(words)) > 0


@pytest.mark.cuda
def test_launch_on_a_second_card(card):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    second = torch.device("cuda", 1)
    rng = np.random.default_rng(1)
    nbr = torch.from_numpy(_padded_rows(rng, 300, 96, 290, 96)).to(second)
    roots = torch.from_numpy(rng.integers(0, 290, 70).astype(np.int32))
    adj, s0 = kc.build_local_adj(nbr, roots.to(second), w_words=2)
    assert adj.device == second
    want = kc.build_local_adj_plain(nbr.cpu(), roots, w_words=2)
    assert torch.equal(adj.cpu(), want[0]) and torch.equal(s0.cpu(), want[1])
    assert int(kc.total_popcount(adj)) == int(kc.total_popcount_plain(want[0]))
    with pytest.raises(ValueError, match="devices"):
        kc.build_local_adj(nbr, roots.to(card), w_words=2)
    # and back on the first card, in the same libraries
    adj0, s00 = kc.build_local_adj(nbr.to(card), roots.to(card), w_words=2)
    assert torch.equal(adj0.cpu(), want[0]) and torch.equal(s00.cpu(), want[1])
    assert int(kc.total_popcount(adj0)) == int(kc.total_popcount(adj))


@pytest.mark.cuda
def test_sharded_functions_on_card(card):
    from gms_tpu_torch.parallel import multi, sharding
    mesh = sharding.make_mesh()
    assert (mesh.size, mesh.device.type) == (1, "cuda")
    g = build_csr(generate_rmat_el(9, 16, seed=27491095), num_nodes=512)
    for k in (3, 5):
        kc.reset_launches()
        stats = {}
        assert multi.sharded_kclique_count(g, k, mesh, stats=stats) == \
            kc.kclique_count(g, k, device="cpu")
        runs = stats["chunks"] + stats["doublings"]
        assert kc.LAUNCHES["expand_level"] == (k - 2) * runs
        assert kc.LAUNCHES["total_popcount"] == runs
    assert sharding.sharded_triangle_count(g, mesh, chunk=64) == \
        tc.triangle_count(g, device="cpu")
    assert multi.sharded_bron_kerbosch_count(g, [card, card]) == \
        bk.bron_kerbosch(g, device="cpu")
    pg = PaddedGraph.from_csr(g, device=card)
    deg1 = torch.cat([pg.deg, pg.deg.new_zeros(1)])
    pairs = torch.from_numpy(np.random.default_rng(0).integers(
        0, 512, (1000, 2)).astype(np.int32)).to(card)
    got = multi.sharded_pair_scores(mesh, metric="jaccard")(pg.nbr, deg1,
                                                           pairs)
    assert torch.equal(got, vs.pair_scores(pg.nbr, deg1, pairs,
                                           metric="jaccard"))


def _rows_over(rng, V, D, universe, max_len):
    """int32[V, D]: every row a strictly ascending subset of [0, universe)
    of at most max_len elements with a SENTINEL tail."""
    nbr = np.full((V, D), SENTINEL, dtype=np.int32)
    for v in range(V):
        k = int(rng.integers(0, min(max_len, D) + 1))
        nbr[v, :k] = np.sort(rng.choice(universe, size=k, replace=False))
    return nbr


def test_ring_wrappers_reject_bad_inputs():
    bools = torch.zeros((2, 32), dtype=torch.bool)
    with pytest.raises(TypeError, match="sel"):
        kc.member_pack(_i32(2, 32), _i32(5, 8), _i32(2, 32), _i32(2, 32),
                       _i32(2, 32, 1))
    with pytest.raises(ValueError, match="do not match"):
        kc.member_pack(_i32(2, 32), _i32(5, 8), _i32(2, 32), bools,
                       _i32(2, 31, 1))
    with pytest.raises(ValueError, match="do not match"):
        kc.member_pack(_i32(2, 48), _i32(5, 8), _i32(2, 32), bools,
                       _i32(2, 32, 1))
    with pytest.raises(ValueError, match="do not match"):
        tc.count_dag_edges_cross(_i32(8, 4), _i32(6, 4), _i32(5, 2), _i32(4))
    with pytest.raises(TypeError):
        tc.count_dag_edges_cross(_i32(8, 4), _i32(6, 4).long(), _i32(5, 2),
                                 _i32(5))


@pytest.mark.cuda
@pytest.mark.parametrize("ww,D,L", [(1, 96, 32), (3, 64, 70), (8, 160, 256),
                                    (32, 4096, 1024), (64, 4096, 2048)])
def test_member_pack_on_card(card, ww, D, L):
    # q rows from one table, the visiting rows from another over the same
    # ids; about half the slots selected, out pre-filled so the OR shows.
    # At W >= 1,024 the q rows hold values below 3,000 and the visiting rows
    # up to 4,096 values below 8,192, so most of a visiting row lies past
    # its root's last live value
    rng = np.random.default_rng(ww * D + L)
    wide = ww >= 32
    C, W, Vs = (6 if wide else 37), 32 * ww, 300
    q = _rows_over(rng, C, W, 3000 if wide else 500, W)
    q[-3:] = SENTINEL                                   # pad roots
    vis = _rows_over(rng, Vs, D, 8192 if wide else 500, D)
    locs = rng.integers(-5, Vs + 5, (C, L)).astype(np.int32)
    sel = rng.random((C, L)) < 0.5
    if wide:
        sel[0, : L // 2] = False       # a dead slab: no selected slot
        assert (vis > q[:-3].max(where=q[:-3] != SENTINEL, initial=0)).any(
            where=vis != SENTINEL)
    out = _sparse_bits(rng, (C, L, ww), 0.05)
    args = [torch.from_numpy(a).to(card) for a in (q, vis, locs, sel)]
    want = kc.member_pack_plain(*args, out.to(card).clone())
    got = _launched("member_pack", lambda: kc.member_pack(
        *args, out.to(card).clone()), kc.LAUNCHES)
    assert torch.equal(got, want)
    assert not torch.equal(want.cpu(), out)
    # a chunk with no selected slot leaves out as it is
    none = torch.zeros_like(args[3])
    got = _launched("member_pack", lambda: kc.member_pack(
        *args[:3], none, out.to(card).clone()), kc.LAUNCHES)
    assert torch.equal(got.cpu(), out)


@pytest.mark.cuda
@pytest.mark.parametrize("da,db,wa,wb", [(96, 64, None, None),
                                         (128, 128, 40, 128),
                                         (32, 256, 32, 7)])
def test_count_dag_edges_cross_on_card(card, da, db, wa, wb):
    rng = np.random.default_rng(da + db)
    a = _rows_over(rng, 400, da, 900, da)
    b = _rows_over(rng, 300, db, 900, db)
    E = 5000
    edges = np.stack([rng.integers(0, 400, E), rng.integers(0, 300, E)],
                     1).astype(np.int32)
    valid = (rng.random(E) < 0.9).astype(np.int32)
    args = [torch.from_numpy(x).to(card) for x in (a, b, edges, valid)]
    got = _launched("count_dag_edges_cross", lambda: tc.count_dag_edges_cross(
        *args, width_a=wa, width_b=wb), tc.LAUNCHES)
    want = tc.count_dag_edges_cross_plain(*args, width_a=wa, width_b=wb)
    assert int(got) == int(want) > 0


def _skewed_edges(rng, Va, Vb, E):
    """int32[E', 2], int32[E']: owned row 5 with 600 edges (split over
    items), rows 6 and 7 with one and two, rows 8 and 9 with none, random
    edges elsewhere, and padding edges (valid 0, pointing at row 0); weights
    0 to 3."""
    rest = rng.integers(10, Va, E)
    own = np.concatenate([np.full(600, 5), [6, 7, 7], rest, np.zeros(50)])
    vis = np.concatenate([rng.integers(0, Vb, 603 + E), np.zeros(50)])
    valid = np.concatenate([rng.integers(1, 4, 603 + E), np.zeros(50)])
    perm = rng.permutation(len(own))
    return (np.stack([own, vis], 1)[perm].astype(np.int32),
            valid[perm].astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("da,db,wa,wb,ids", [(96, 64, None, None, 300),
                                             (128, 256, 40, 200, 800),
                                             (512, 130, None, 7, 1600),
                                             (1100, 64, 1030, None, 3300),
                                             (9000, 40, None, None, 27000),
                                             (200, 100, None, None, 900000)])
def test_tier_intersect_owned_skewed_on_card(card, da, db, wa, wb, ids):
    """K40 against plain: a hub row's edges over several items, rows with
    0, 1 and 2 edges, padding edges, sliced widths, two tables of other
    strides, owned rows of up to 9,000 slots in a bitmap of 2^18 ids and of
    a wider range by binary search, with the plan's schedule and
    without."""
    rng = np.random.default_rng(da + db)
    a = _rows_over(rng, 400, da, ids, da)
    b = _rows_over(rng, 300, db, ids, db)
    a[5, :da] = np.sort(rng.choice(ids, da, replace=False))
    a[9] = SENTINEL                      # an owned row with no entry
    b[:20, :db] = np.sort(rng.choice(ids, (20, db)), axis=1)
    b[:20] = np.where(np.diff(b[:20], axis=1, prepend=-1) == 0, SENTINEL,
                      b[:20])
    b[:20] = np.sort(b[:20], axis=1)
    b[20] = SENTINEL                     # a visiting row sharing the hub's
    b[20, :min(da, db)] = a[5, :min(da, db)]
    edges, valid = _skewed_edges(rng, 400, 300, 4000)
    args = [torch.from_numpy(x).to(card) for x in (a, b, edges, valid)]
    sched = tc.cross_schedule(args[2], args[3], tc.row_lengths(args[1]))
    assert int((sched.items[:, 0] == 5).sum()) == -(-600 // tc.CROSS_SPAN)
    want = tc.count_dag_edges_cross_plain(*args, width_a=wa, width_b=wb)
    for kw in ({"schedule": sched}, {}):
        got = _launched("count_dag_edges_cross",
                        lambda: tc.count_dag_edges_cross(
                            *args, width_a=wa, width_b=wb, **kw), tc.LAUNCHES)
        assert int(got) == int(want) > 0


@pytest.mark.cuda
def test_ring_plans_on_card(card):
    # world size 1 on the card against the plain versions on the CPU
    from gms_tpu_torch.parallel import sharding
    gpu, cpu = sharding.make_mesh(), sharding.make_mesh(devices="cpu")
    g = build_csr(generate_rmat_el(9, 16, seed=27491095), num_nodes=512)
    for make in (
            lambda m: sharding.VertexShardedTrianglePlan(g, m, chunk=64),
            lambda m: sharding.ShardedTrianglePlan(g, m, hub_threshold=8),
            lambda m: sharding.VertexShardedKCliquePlan(g, m, k=3),
            lambda m: sharding.VertexShardedKCliquePlan(g, m, k=5),
            lambda m: sharding.VertexShardedKCliquePlan(g, m, k=7),
            lambda m: sharding.VertexShardedBKPlan(g, m)):
        assert make(gpu).run() == make(cpu).run() > 0
