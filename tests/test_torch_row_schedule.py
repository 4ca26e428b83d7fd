"""The degree-balanced CSR row schedule (gms_tpu_torch/graphs/row_schedule.py)
that K32 (pr_pull), K25 (component_step) and K33 (cc_step, sssp_step) run
on.

On the CPU: the schedule covers each row exactly once, each wide row's
segments tile it exactly, and no warp walks more than the bound; the two
kernels' arithmetic replayed over the schedule (K32's float64 sums in the
kernel's own order: lane-strided, then a shuffle tree; partial minima)
against the plain versions; a schedule refused with another CSR; and
PageRank and the friend-graph component labels through the port
(device="cpu") against gms_tpu's. The graphs: a star of 20,000 leaves (one
row of 40 segments), a star of 2,000 leaves, rows of lengths at the class
edges (8, 9, 512, 513, 1,024, 1,025), RMAT-10 with isolated vertices (empty
rows), and n = 0. gms_tpu's programs pad every row to the widest, so its
padded star of 20,000 leaves would take 1.6 GB: that star is held to
gms_tpu's host PageRank oracle, the rest to its device programs. PageRank
is held at rtol 1e-5 (XLA sums in float32), the labels exactly. K33's step
is replayed launch by launch (init, narrow rows, segments, the atomicMin
fold of a wide row) against cc_step_plain and sssp_step_plain on RMAT-10
and on a star whose hub row is three segments, and, as the step of
connected_components and sssp, against gms_tpu's results and its number
of steps."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gms_tpu.algorithms import coloring as jc
from gms_tpu.algorithms import gapbs as jgapbs
from gms_tpu.graphs.tiles import SENTINEL
from gms_tpu.graphs.tiles import PaddedGraph as JPaddedGraph
from gms_tpu.io.builder import build_csr as jbuild_csr

from gms_tpu_torch.algorithms import coloring as gc
from gms_tpu_torch.algorithms import gapbs
from gms_tpu_torch.graphs import row_schedule as rs
from gms_tpu_torch.io.builder import build_csr
from gms_tpu_torch.io.generators import generate_rmat_el

torch.set_num_threads(1)

SEED = 27491095
CPU = {"device": "cpu"}


def _star(leaves):
    return np.stack([np.zeros(leaves, np.int64),
                     np.arange(1, leaves + 1, dtype=np.int64)], axis=1), \
        leaves + 1


def _edges():
    """Centres 0-5 with 8, 9, 512, 513, 1,024 and 1,025 leaves of their
    own, and a leaf pair joined."""
    el, nxt = [], 6
    for c, k in enumerate((8, 9, 512, 513, 1024, 1025)):
        el += [[c, leaf] for leaf in range(nxt, nxt + k)]
        nxt += k
    el.append([6, nxt - 1])
    return np.array(el, np.int64), nxt


_CASES = {
    "star20000": lambda: _star(20_000),
    "star2000": lambda: _star(2_000),
    "edges": _edges,
    "rmat10": lambda: (generate_rmat_el(10, 16, seed=SEED), 1024 + 9),
    "n0": lambda: (np.zeros((0, 2), np.int64), 0),
}
# gms_tpu's padded programs take these; star20000 goes to its oracle
_PADDED = ("star2000", "edges", "rmat10")


@pytest.fixture(scope="module")
def graphs():
    return {k: build_csr(*make()) for k, make in _CASES.items()}


def _sched(g):
    return rs.build_row_schedule(torch.from_numpy(g.indptr))


@pytest.mark.parametrize("case", list(_CASES))
def test_schedule_covers_each_row_once(graphs, case):
    g = graphs[case]
    s = _sched(g)
    deg = np.diff(g.indptr)
    narrow = s.narrow.numpy()
    seg_rows = np.unique(s.seg_row.numpy())
    both = np.concatenate([narrow, seg_rows])
    assert np.array_equal(np.sort(both), np.arange(g.num_nodes))
    assert (deg[narrow] <= rs.NARROW).all()
    assert (deg[seg_rows] > rs.NARROW).all()
    assert (np.diff(narrow) > 0).all()
    assert (np.diff(s.seg_row.numpy()) >= 0).all()
    assert s.n == g.num_nodes
    assert s.rows.dtype == torch.int32 and s.seg_start.dtype == torch.int64
    assert s.rows.numel() == s.n_narrow + s.n_seg + s.n_wide
    assert s.starts.numel() == s.n_seg + s.n_wide


@pytest.mark.parametrize("case", list(_CASES))
def test_segments_tile_each_row(graphs, case):
    g = graphs[case]
    s = _sched(g)
    ip = g.indptr
    seg_row, seg_start = s.seg_row.numpy(), s.seg_start.numpy()
    seg_end = np.minimum(seg_start + rs.SEGMENT, ip[seg_row + 1])
    assert (seg_end > seg_start).all()
    for v in np.unique(seg_row):
        mine = np.nonzero(seg_row == v)[0]
        assert (np.diff(mine) == 1).all()           # consecutive
        assert seg_start[mine[0]] == ip[v] and seg_end[mine[-1]] == ip[v + 1]
        assert (seg_start[mine[1:]] == seg_end[mine[:-1]]).all()
    _, _, entry = _pieces(torch.from_numpy(ip), s)
    assert np.array_equal(np.sort(entry.numpy()), np.arange(ip[-1]))
    deg = np.diff(ip)
    rows_of, first, count = np.unique(seg_row, return_index=True,
                                      return_counts=True)
    assert np.array_equal(count, -(-deg[rows_of] // rs.SEGMENT))
    wide = s.wide_row.numpy()
    assert np.array_equal(wide, np.nonzero(deg > rs.SEGMENT)[0])
    assert np.array_equal(wide, rows_of[count > 1]) and s.n_wide == wide.size
    assert np.array_equal(s.wide_seg.numpy(), first[count > 1])
    if case == "star20000":
        assert s.n_wide == 1 and (seg_row == 0).sum() == 40
    if case == "edges":                              # the class edges
        narrow = set(s.narrow.tolist())
        assert 0 in narrow and 1 not in narrow and 2 not in narrow
        assert list(wide) == [3, 4, 5]


@pytest.mark.parametrize("case", list(_CASES))
def test_no_warp_walks_more_than_the_bound(graphs, case):
    g = graphs[case]
    s = _sched(g)
    deg = np.diff(g.indptr)
    bound = max(32 * rs.NARROW, rs.SEGMENT)
    narrow = deg[s.narrow.numpy()]
    warps = np.add.reduceat(narrow, np.arange(0, narrow.size, 32)) \
        if narrow.size else np.zeros(0, np.int64)
    assert (warps <= bound).all()
    seg_end = np.minimum(s.seg_start.numpy() + rs.SEGMENT,
                         g.indptr[s.seg_row.numpy() + 1])
    assert (seg_end - s.seg_start.numpy() <= bound).all()


def _pieces(indptr, s):
    """The schedule's work items: the narrow rows (piece i = narrow row i),
    then the segments (piece n_narrow + k = segment k). Returns (the row of
    each piece, the piece of each entry walked, that entry's index)."""
    narrow = s.narrow.long()
    starts = torch.cat([indptr[narrow], s.seg_start])
    ends = torch.cat([indptr[narrow + 1],
                      torch.minimum(s.seg_start + rs.SEGMENT,
                                    indptr[s.seg_row.long() + 1])])
    lens = ends - starts
    piece = torch.repeat_interleave(torch.arange(lens.numel()), lens)
    offs = torch.cumsum(lens, 0) - lens
    entry = starts[piece] + torch.arange(piece.numel()) - offs[piece]
    return torch.cat([narrow, s.seg_row.long()]), piece, entry


def _lanes(x, width):
    """K32's sum of each row of x (float64, zero-padded to `width` columns,
    a multiple of 32): lane l adds entries l, l + 32, ... in order from
    0.0, then the shuffle tree adds lane l ^ o's sum at o = 16, 8, 4, 2, 1;
    lane 0's value. Adding a padding zero leaves a sum's bits as they are."""
    lanes = np.zeros((x.shape[0], 32))
    for t in range(width // 32):
        lanes = lanes + x[:, 32 * t:32 * t + 32]
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, np.arange(32) ^ o]
    return lanes[:, 0]


def _padded(values, starts, lens, width):
    """values[starts[i]:starts[i] + lens[i]] as row i of a float64 array of
    `width` columns, zero-padded."""
    out = np.zeros((len(starts), width))
    for i, (a, m) in enumerate(zip(starts, lens)):
        out[i, :m] = values[a:a + m]
    return out


def _replay_pull(indptr, indices, deg, pr, base, damp, s):
    """K32's arithmetic over the schedule, in its order: a narrow row summed
    in order, a segment and a wide row's partials by _lanes, all in float64
    from 0.0, each row rounded once to float32."""
    ip = indptr.numpy()
    contrib = (pr / deg.clamp(min=1).to(torch.float32)).double().numpy()
    gathered = contrib[indices.numpy().astype(np.int64)]
    sums = np.zeros(pr.numel())
    narrow = s.narrow.numpy().astype(np.int64)
    rows = _padded(gathered, ip[narrow], np.diff(ip)[narrow], rs.NARROW)
    acc = np.zeros(narrow.size)
    for j in range(rs.NARROW):
        acc = acc + rows[:, j]
    sums[narrow] = acc
    seg_row = s.seg_row.numpy().astype(np.int64)
    seg_start = s.seg_start.numpy()
    seg_len = np.minimum(seg_start + rs.SEGMENT, ip[seg_row + 1]) - seg_start
    part = _lanes(_padded(gathered, seg_start, seg_len, rs.SEGMENT),
                  rs.SEGMENT)
    one = np.diff(ip)[seg_row] <= rs.SEGMENT
    sums[seg_row[one]] = part[one]
    wide = s.wide_row.numpy().astype(np.int64)
    if wide.size:
        count = -(-np.diff(ip)[wide] // rs.SEGMENT)
        width = 32 * -(-int(count.max()) // 32)
        sums[wide] = _lanes(_padded(part, s.wide_seg.numpy(), count, width),
                            width)
    f32 = dict(dtype=torch.float32)
    return (torch.tensor(base, **f32)
            + torch.tensor(damp, **f32) * torch.from_numpy(sums).float())


def _replay_min(indptr, indices, comp, s):
    """K25's over the schedule: the min of a narrow row or a segment, then
    a row's min over its pieces and its own label (K25 folds a wide row's
    segments with atomicMin)."""
    rows, piece, entry = _pieces(indptr, s)
    part = torch.full((rows.numel(),), torch.iinfo(torch.int32).max,
                      dtype=torch.int32).scatter_reduce_(
        0, piece, comp[indices[entry].long()], "amin")
    return comp.clone().scatter_reduce_(0, rows, part, "amin")


@pytest.mark.parametrize("case", list(_CASES))
def test_schedule_replays_of_both_kernels_equal_plain(graphs, case):
    g = graphs[case]
    n = g.num_nodes
    s = _sched(g)
    rng = np.random.default_rng(3)
    indptr = torch.from_numpy(g.indptr)
    indices = torch.from_numpy(g.indices)
    deg = torch.from_numpy(g.degrees.astype(np.int32))
    pr = torch.from_numpy(rng.random(n).astype(np.float32))
    base = float(np.float32(0.15) / np.float32(max(n, 1)))
    damp = float(np.float32(0.85))
    torch.testing.assert_close(
        _replay_pull(indptr, indices, deg, pr, base, damp, s),
        gapbs.pr_pull_plain(indptr, indices, deg, pr, base, damp),
        rtol=1e-6, atol=0)
    comp = torch.from_numpy(rng.permutation(n).astype(np.int32))
    # component_step_plain pads every row to the widest: 5 s on the star of
    # 20,000 leaves, where cc_step_plain computes the same step by edges
    plain = (gapbs.cc_step_plain if case == "star20000"
             else gc.component_step_plain)
    want, changed = plain(indptr, indices, comp)
    got = _replay_min(indptr, indices, comp, s)
    assert torch.equal(got, want)
    assert int(changed) == int((got != comp).any())


@pytest.mark.parametrize("case", list(_CASES))
def test_pagerank_equals_gms_tpu(graphs, case):
    el, n = _CASES[case]()
    g = graphs[case]
    got = gapbs.pagerank(g, iters=5, **CPU)
    assert got.shape == (n,) and got.dtype == np.float32
    if n == 0:
        return
    jg = jbuild_csr(el, num_nodes=n)
    want = (jgapbs.pagerank(jg, iters=5) if case in _PADDED
            else jgapbs.pagerank_oracle(jg, iters=5))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("case", list(_PADDED) + ["n0"])
@pytest.mark.parametrize("limit", [1, 3, 64])
def test_component_labels_equal_gms_tpu(graphs, case, limit):
    el, n = _CASES[case]()
    g = graphs[case]
    # the labels start as the ids: relabel so the wide rows do not hold 0
    perm = np.random.default_rng(limit).permutation(n)
    el = perm[el] if len(el) else el
    g = build_csr(el, num_nodes=n)
    indptr = torch.from_numpy(g.indptr)
    indices = torch.from_numpy(g.indices)
    got = gc.component_labels(indptr, indices, limit).numpy()
    assert got.shape == (n,)
    if n == 0:
        return
    jg = jbuild_csr(el, num_nodes=n)
    want = np.asarray(jc._component_labels(JPaddedGraph.from_csr(jg).nbr,
                                           jnp.int32(limit)))[:n]
    assert np.array_equal(got, want)


def test_schedule_rejects_bad_inputs():
    with pytest.raises(TypeError, match="int64"):
        rs.build_row_schedule(torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError, match="int64"):
        rs.build_row_schedule(torch.zeros(0, dtype=torch.int64))
    indptr = torch.tensor([0, 2, 3])
    s = rs.build_row_schedule(indptr)
    assert s.indptr is indptr
    rs.check_schedule("f", s, indptr)
    with pytest.raises(ValueError, match="another indptr"):
        rs.check_schedule("f", s, torch.tensor([0, 1, 2, 3]))
    with pytest.raises(ValueError, match="another indptr"):
        rs.check_schedule("f", s, indptr.clone())
    with pytest.raises(TypeError, match="RowSchedule"):
        rs.check_schedule("f", object(), indptr)


def test_wrappers_refuse_another_csrs_schedule():
    """pr_pull and component_step check a given schedule on every device:
    one built from another CSR of as many rows is refused."""
    a = torch.tensor([0, 2, 3, 3], dtype=torch.int64)
    b = torch.tensor([0, 1, 2, 3], dtype=torch.int64)
    indices = torch.tensor([1, 2, 0], dtype=torch.int32)
    other = rs.build_row_schedule(b)
    deg = torch.tensor([2, 1, 0], dtype=torch.int32)
    pr = torch.full((3,), 1 / 3, dtype=torch.float32)
    comp = torch.arange(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="another indptr"):
        gapbs.pr_pull(a, indices, deg, pr, 0.05, 0.85, schedule=other)
    with pytest.raises(ValueError, match="another indptr"):
        gc.component_step(a, indices, comp, schedule=other)
    own = rs.build_row_schedule(a)
    assert torch.equal(
        gapbs.pr_pull(a, indices, deg, pr, 0.05, 0.85, schedule=own),
        gapbs.pr_pull_plain(a, indices, deg, pr, 0.05, 0.85))
    assert torch.equal(gc.component_step(a, indices, comp, schedule=own)[0],
                       gc.component_step_plain(a, indices, comp)[0])


def _min_cases():
    """RMAT-10 and a star whose hub row is three segments (1,300 leaves)
    beside the class-edge rows."""
    star, n = _star(1300)
    el, m = _edges()
    return {"rmat10": _CASES["rmat10"](),
            "star1300": (np.concatenate([star, el + n]), n + m)}


def _replay_k33(indptr, indices, cur, s, weights=None, sssp=False):
    """K33's step (csrc/min_step.cuh) over the schedule, launch by launch:
    the init launch (changed = 0, nxt[v] = cur[v] for each wide row); a
    narrow row a thread (its own value, then its candidates in order); a
    segment's min from the top value; a row of one segment written
    min(m, own); a wide row's segment folded into nxt[v] by atomicMin where
    m < own. Candidates: cur[w] (CC) or cur[w] + weight (SSSP, 1 without
    weights). Every row is written exactly once or folded."""
    top = torch.iinfo(cur.dtype).max
    cand = cur[indices.long()]
    if sssp:
        cand = cand + (1 if weights is None else weights.long())
    nxt = torch.full_like(cur, -1)               # no step gives -1
    wide = s.wide_row.long()
    nxt[wide] = cur[wide]
    rows, piece, entry = _pieces(indptr, s)
    m = torch.full((rows.numel(),), top, dtype=cur.dtype).scatter_reduce_(
        0, piece, cand[entry], "amin")
    own = cur[rows]
    narrow = torch.arange(rows.numel()) < s.n_narrow
    nxt[rows[narrow]] = torch.minimum(m[narrow], own[narrow])
    seg = ~narrow
    one = (indptr[rows + 1] - indptr[rows] <= rs.SEGMENT) & seg
    nxt[rows[one]] = torch.minimum(m[one], own[one])
    fold = seg & ~one & (m < own)
    nxt.scatter_reduce_(0, rows[fold], m[fold], "amin")
    moved = (narrow & (m < own)) | (seg & (m < own))
    assert not bool((nxt == -1).any())
    return nxt, moved.any().to(torch.int32).reshape(1)


@pytest.mark.parametrize("case", ["rmat10", "star1300"])
def test_k33_replay_equals_plain(case):
    el, n = _min_cases()[case]
    g = build_csr(el, num_nodes=n)
    s = _sched(g)
    if case == "star1300":
        assert s.n_wide == 4 and int((s.seg_row == 0).sum()) == 3
    indptr, indices = torch.from_numpy(g.indptr), torch.from_numpy(g.indices)
    rng = np.random.default_rng(5)
    u = np.repeat(np.arange(n), g.degrees.astype(np.int64))
    w = torch.from_numpy((1 + ((u ^ g.indices) % 9)).astype(np.int32))
    for _ in range(2):
        cur = torch.from_numpy(rng.permutation(n).astype(np.int32))
        want = gapbs.cc_step_plain(indptr, indices, cur)
        got = _replay_k33(indptr, indices, cur, s)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        d = np.where(rng.random(n) < 0.3, rng.integers(0, 40, n), gapbs.BIG)
        cur = torch.from_numpy(d.astype(np.int64))
        for weights in (w, None):
            want = gapbs.sssp_step_plain(indptr, indices, weights, cur)
            got = _replay_k33(indptr, indices, cur, s, weights, sssp=True)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
    # a state where nothing moves
    fixed = torch.from_numpy(gapbs.cc_oracle(g).astype(np.int32))
    nxt, changed = _replay_k33(indptr, indices, fixed, s)
    assert torch.equal(nxt, fixed) and int(changed) == 0


def _jax_steps(nbr, state, cand_of):
    """gms_tpu's while_loop(changed) on its padded rows, in numpy: steps
    until one changes nothing, the last included; (final state, steps)."""
    steps = 0
    while True:
        nxt = np.minimum(state, cand_of(state).min(axis=1))
        steps += 1
        if np.array_equal(nxt, state):
            return nxt, steps
        state = nxt


@pytest.mark.parametrize("case", ["rmat10", "star1300"])
def test_cc_and_sssp_on_the_schedule_equal_gms_tpu(case, monkeypatch):
    """connected_components and sssp build one row schedule a call and hand
    it to every step; with K33's replayed arithmetic as the step they give
    gms_tpu's labels and distances after gms_tpu's number of steps."""
    el, n = _min_cases()[case]
    g = build_csr(el, num_nodes=n)
    jg = jbuild_csr(el, num_nodes=n)
    seen = []

    def cc_step(indptr, indices, cur, *, schedule=None):
        seen.append(schedule)
        rs.check_schedule("cc_step", schedule, indptr)
        return _replay_k33(indptr, indices, cur, schedule)

    def sssp_step(indptr, indices, weights, cur, *, schedule=None):
        seen.append(schedule)
        rs.check_schedule("sssp_step", schedule, indptr)
        return _replay_k33(indptr, indices, cur, schedule, weights, True)

    monkeypatch.setattr(gapbs, "cc_step", cc_step)
    monkeypatch.setattr(gapbs, "sssp_step", sssp_step)
    nbr = np.asarray(JPaddedGraph.from_csr(jg).nbr)
    V = nbr.shape[0]
    valid = nbr != SENTINEL
    take = np.clip(nbr, 0, V - 1)
    got = gapbs.connected_components(g, **CPU)
    np.testing.assert_array_equal(got, jgapbs.connected_components(jg))
    _, steps = _jax_steps(nbr, np.arange(V, dtype=np.int64),
                          lambda s: np.where(valid, s[take], np.iinfo(
                              np.int32).max))
    assert gapbs.STEPS["cc"] == steps
    assert len(seen) == steps and all(x is seen[0] for x in seen)
    u = np.repeat(np.arange(n), g.degrees.astype(np.int64))
    w = (1 + ((u ^ g.indices) % 9)).astype(np.int32)
    wp = np.zeros(nbr.shape, np.int64)
    wp[u, np.arange(g.num_edges) - np.repeat(g.indptr[:-1],
                                               g.degrees.astype(np.int64))] = w
    for weights in (w, None):
        seen.clear()
        got = gapbs.sssp(g, 0, weights, **CPU)
        np.testing.assert_array_equal(got, jgapbs.sssp(jg, 0, weights))
        d0 = np.full(V, gapbs.BIG, np.int64)
        d0[0] = 0
        wt = wp if weights is not None else np.ones_like(wp)
        _, steps = _jax_steps(nbr, d0, lambda s: np.where(
            valid, s[take] + wt, gapbs.BIG))
        assert gapbs.STEPS["sssp"] == steps
        assert len(seen) == steps and all(x is seen[0] for x in seen)


def test_min_steps_refuse_another_csrs_schedule():
    """cc_step and sssp_step check a given schedule on every device."""
    a = torch.tensor([0, 2, 3, 3], dtype=torch.int64)
    b = torch.tensor([0, 1, 2, 3], dtype=torch.int64)
    indices = torch.tensor([1, 2, 0], dtype=torch.int32)
    other = rs.build_row_schedule(b)
    lab = torch.arange(3, dtype=torch.int32)
    dist = torch.tensor([0, gapbs.BIG, gapbs.BIG], dtype=torch.int64)
    w = torch.tensor([2, 3, 4], dtype=torch.int32)
    with pytest.raises(ValueError, match="another indptr"):
        gapbs.cc_step(a, indices, lab, schedule=other)
    with pytest.raises(ValueError, match="another indptr"):
        gapbs.sssp_step(a, indices, w, dist, schedule=other)
    with pytest.raises(TypeError, match="RowSchedule"):
        gapbs.sssp_step(a, indices, None, dist, schedule=object())
    own = rs.build_row_schedule(a)
    for got, want in (
            (gapbs.cc_step(a, indices, lab, schedule=own),
             gapbs.cc_step_plain(a, indices, lab)),
            (gapbs.sssp_step(a, indices, w, dist, schedule=own),
             gapbs.sssp_step_plain(a, indices, w, dist))):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
