"""Graph coloring — the port of gms_tpu/algorithms/coloring.py.

Role of gms/algorithms/non_set_based/coloring/: Jones–Plassmann (strict
local-maxima rounds and the speculative variant), Johansson's randomized
(deg+1)-coloring, Barenboim/Elkin's one-shot palette rounds, the
dense/sparse decomposition, the sequential greedy oracle and the verifiers
(coloring_common.h:28-205).

Every round runs over gms_tpu's degree tiers (`_TierGraph`, built in numpy
exactly as gms_tpu builds them): bucket t holds the vertices of degree in
(Dt/2, Dt] (Dt >= 32, a power of two) as ids int32[Vt] (padded to a
multiple of 8 with the dump id n) and their CSR rows nbrt int32[Vt, Dt]
with a SENTINEL tail. State arrays (colors, priorities, draws) carry one
dump slot at index n (colored 0, priority 0).

Five hand-written CUDA kernels carry the device programs; each wrapper runs
its plain version for CPU tensors, launches the kernel or raises for CUDA
tensors, and adds one to LAUNCHES[name] per launch:
  * `jp_run` (K22, csrc/color_jp.cu, LAUNCHES "jp_run"): a whole strict JP
    dispatch, up to `limit` rounds over every bucket while a vertex is
    uncolored (gms_tpu's _jp_run_tiered), in one cooperative launch; the
    strict dispatches of `jones_plassmann` and `dense_sparse` run it;
  * `jp_bucket` (K22, LAUNCHES "color_jp"): one strict JP round over a
    bucket, decide then commit (every read of the bucket-start colors), the
    same decide and commit as jp_run's: two CUDA launches, counted as one;
  * `spec_pick`, `spec_rank`, `spec_clash` (K23, csrc/color_spec.cu): the
    three passes of the speculative round, each into a fresh buffer;
  * `johansson_bucket` (K24, csrc/color_random.cu, LAUNCHES
    "color_johansson") and `one_shot_pick` + `one_shot_resolve` (K24,
    "color_one_shot"): the randomized rounds on explicit draws (Johansson's
    picks; the one-shot's two raw 64-bit words a vertex, reduced to a pick
    in the kernel once the free palette is counted);
  * `component_step` (K25, csrc/color_components.cu): one Jacobi min-label
    step on the friend graph of `dense_sparse`, over the degree-balanced
    row schedule of graphs/row_schedule.py (built once a call).
The wrappers other than jp_run take one bucket; the round functions
(`jp_round`, `spec_round`, `johansson_round`, `one_shot_round`,
`component_labels`) walk the buckets through them; their `*_plain` twins
walk them through the plain versions, on any device (`jp_run_plain`, the
round loop of `jp_round_plain`).

Johansson and Barenboim/Elkin draw gms_tpu's jax.random numbers from
gms_tpu's keys (gms_tpu_torch/prng.py, threefry bit for bit), so their
colors equal gms_tpu's vertex for vertex. The one-shot round works over the
tiers with a bitmask a row, where gms_tpu builds a [V, D_pad, cw] one-hot,
so it runs at sizes gms_tpu cannot.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

from gms_tpu_torch import _kernels, prng
from gms_tpu_torch.device import resolve
from gms_tpu_torch.graphs.csr import CSRGraph, _csr_from_sorted_pairs
from gms_tpu_torch.graphs.row_schedule import (RowSchedule,
                                               build_row_schedule,
                                               check_schedule)
from gms_tpu_torch.graphs.tiles import SENTINEL, round_up
from gms_tpu_torch.harness import checks

UNCOLORED = -1
# conflict-rank cap of the speculative round (gms_tpu coloring.py:46)
SPEC_RANK_CAP = 31

# Kernel launches, counted only where a CUDA kernel launches.
LAUNCHES = {"jp_run": 0, "color_jp": 0, "color_spec": 0,
            "color_johansson": 0, "color_one_shot": 0, "color_components": 0}
# rounds (JP, Johansson, Barenboim/Elkin) or steps (components) of the last
# call of each entry point
ROUNDS = {"jones_plassmann": 0, "johansson": 0, "barenboim_elkin": 0,
          "dense_sparse": 0, "component_labels": 0}

_SENT = int(SENTINEL)
# elements a plain version materialises at once
_PLAIN_BUDGET = 1 << 24


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _color_words(max_colors: int) -> int:
    return (max_colors + 31) // 32


class _TierGraph:
    """gms_tpu's degree-tiered adjacency (coloring.py:53-102), in numpy.

    `tiers` is a tuple of (ids_pad int32[Vt], nbrt int32[Vt, Dt]), equal to
    gms_tpu's arrays; `ids` restricts the rows to a frontier (re-tiering
    between dispatches), each vertex keeping its bucket by degree."""

    def __init__(self, g: CSRGraph, ids: np.ndarray | None = None):
        n = g.num_nodes
        deg = g.degrees
        indptr = g.indptr
        universe = (np.arange(n, dtype=np.int64) if ids is None
                    else np.asarray(ids, dtype=np.int64))
        order = universe[np.argsort(deg[universe], kind="stable")]
        sdeg = deg[order]
        m = len(order)
        tiers = []
        start = 0
        while start < m:
            d0 = int(sdeg[start])
            Dt = max(32, 1 << int(np.ceil(np.log2(max(d0, 1)))))
            stop = int(np.searchsorted(sdeg, Dt, side="right"))
            tids = order[start:stop].astype(np.int32)
            sel = deg[tids].astype(np.int64)
            Vt = round_up(len(tids), 8)
            nbrt = np.full((Vt, Dt), SENTINEL, np.int32)
            rows_i = np.repeat(np.arange(len(tids)), sel)
            col_o = (np.arange(sel.sum())
                     - np.repeat(np.cumsum(sel) - sel, sel))
            flat = np.repeat(indptr[tids], sel) + col_o
            nbrt[rows_i, col_o] = g.indices[flat]
            ids_pad = np.full(Vt, n, np.int32)
            ids_pad[: len(tids)] = tids
            tiers.append((ids_pad, nbrt))
            start = stop
        self.n = n
        self.tiers = tuple(tiers)

    def to(self, device="cuda") -> list:
        """The tiers as [(ids, nbrt)] int32 tensors on `device`."""
        dev = resolve(device)
        return [(torch.from_numpy(i).to(dev), torch.from_numpy(t).to(dev))
                for i, t in self.tiers]


# ---------------------------------------------------------------------------
# shared plain pieces
# ---------------------------------------------------------------------------

def _take_clip(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t[idx] with idx clipped into range (jnp.take's mode="clip")."""
    return t[idx.long().clamp(0, t.shape[0] - 1)]


def _used_sorted(ncol, valid, limit):
    """Each row's distinct committed neighbour colors below `limit` (an int
    or int64[R] per row), sorted ascending, the rest 2^40; and how many."""
    big = 1 << 40
    lim = limit if isinstance(limit, int) else limit.long()[:, None]
    c = ncol.long()
    s = torch.where(valid & (c >= 0) & (c < lim), c,
                    torch.full_like(c, big)).sort(dim=1).values
    dup = torch.zeros_like(s, dtype=torch.bool)
    dup[:, 1:] = (s[:, 1:] == s[:, :-1]) & (s[:, 1:] < big)
    s = torch.where(dup, torch.full_like(s, big), s).sort(dim=1).values
    return s, (s < big).sum(dim=1)


def _kth_from_sorted(s, k):
    """The k-th (0-based) color absent from each row's sorted distinct used
    colors s: k + #{i : s_i - i <= k} (s_i - i free colors lie below s_i)."""
    i = torch.arange(s.shape[1], device=s.device, dtype=torch.long)
    return k.long() + ((s - i) <= k.long()[:, None]).sum(dim=1)


def _pick(ncol, valid, k, cw: int):
    """gms_tpu's _pick_tiered: the k-th free color among 32*cw, 0 if none."""
    s, _ = _used_sorted(ncol, valid, 32 * cw)
    p = _kth_from_sorted(s, k)
    return torch.where(p < 32 * cw, p, torch.zeros_like(p)).to(torch.int32)


def _gather(state, ids, nbrt):
    """(own values, neighbour values) of a state array for a bucket."""
    return state[ids.long()], _take_clip(state, nbrt)


def _check_bucket(name, ids, nbrt, *state):
    _kernels.check_tensor(name, "ids", ids, 1)
    _kernels.check_tensor(name, "nbrt", nbrt, 2)
    if nbrt.shape[0] != ids.shape[0] or nbrt.shape[1] < 1:
        raise ValueError(f"{name}: nbrt {tuple(nbrt.shape)} does not match "
                         f"{ids.shape[0]} ids")
    n1 = state[0].shape[0]
    for i, t in enumerate(state):
        _kernels.check_tensor(name, f"state array {i}", t, 1)
        if t.shape[0] != n1:
            raise ValueError(f"{name}: state arrays of {n1} and "
                             f"{t.shape[0]} slots")
    if checks.paranoid():
        checks.validate_sorted_rows(nbrt, name=f"{name} nbrt")
        valid = nbrt[nbrt != _SENT]
        if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= n1) or \
                valid.numel() and (int(valid.min()) < 0
                                   or int(valid.max()) >= n1 - 1):
            raise ValueError(f"{name}: an id or neighbour outside the "
                             f"{n1} state slots")
    return _kernels.on_cuda(name, ids, nbrt, *state)


# ---------------------------------------------------------------------------
# K22: one strict JP round over a bucket
# ---------------------------------------------------------------------------

def jp_bucket_plain(colors, priority, ids, nbrt):
    """Plain version of jp_bucket (gms_tpu _jp_round_tiered's loop body)."""
    vcol, ncol = _gather(colors, ids, nbrt)
    vpri, npri = _gather(priority, ids, nbrt)
    valid = nbrt != _SENT
    rival = valid & (ncol == UNCOLORED) & (npri > vpri[:, None])
    wins = (vcol == UNCOLORED) & ~rival.any(dim=1)
    mex = _pick(ncol, valid, torch.zeros_like(vcol), _color_words(
        nbrt.shape[1] + 2))
    colors[ids.long()] = torch.where(wins, mex, vcol)
    return colors


def jp_bucket(colors, priority, ids, nbrt):
    """One strict JP round over one bucket, in place on colors int32[n + 1]:
    an uncolored row whose priority (int32[n + 1], strict >) beats every
    uncolored neighbour takes the mex of its committed neighbours' colors.
    Every read is of the bucket-start colors: a decide launch into scratch,
    then a commit launch, one LAUNCHES count together. Returns colors."""
    name = "jp_bucket"
    if not _check_bucket(name, ids, nbrt, colors, priority):
        return jp_bucket_plain(colors, priority, ids, nbrt)
    Vt, Dt = nbrt.shape
    dec = torch.empty(Vt, dtype=torch.int32, device=colors.device)
    _kernels.launch("color_jp", "color_jp", ids, nbrt, Vt, Dt, colors,
                    priority, _color_words(Dt + 2), dec)
    LAUNCHES["color_jp"] += 1
    return colors


def _jp_round(colors, priority, tiers, bucket):
    colors = colors.clone()
    for ids, nbrt in tiers:
        bucket(colors, priority, ids, nbrt)
    return colors


def jp_round(colors, priority, tiers):
    """One strict JP round (gms_tpu _jp_round_tiered, coloring.py:106): the
    buckets in ascending width, each seeing the earlier buckets' commits."""
    return _jp_round(colors, priority, tiers, jp_bucket)


def jp_round_plain(colors, priority, tiers):
    return _jp_round(colors, priority, tiers, jp_bucket_plain)


def jp_run_plain(colors, priority, tiers, *, limit: int, n: int):
    """Plain version of jp_run: up to `limit` jp_round_plain rounds while a
    vertex of [0, n) is uncolored, in place on colors; returns (colors, the
    rounds run)."""
    r = 0
    while r < limit and _any_uncolored(colors, n):
        for ids, nbrt in tiers:
            jp_bucket_plain(colors, priority, ids, nbrt)
        r += 1
    return colors, r


def jp_run(colors, priority, tiers, *, limit: int, n: int):
    """One strict JP dispatch, gms_tpu's _jp_run_tiered (coloring.py:272):
    up to `limit` rounds while a vertex of [0, n) is uncolored, each round
    the buckets (ids, nbrt) in ascending width, each seeing the earlier
    buckets' commits; in place on colors int32[n + 1]. Returns (colors,
    rounds): for CUDA tensors one cooperative launch, the rounds an int32[1]
    tensor on the card (read it back with the colors); for CPU tensors
    jp_run_plain, the rounds an int. The buckets' rows are distinct
    vertices, as _TierGraph builds them."""
    name = "jp_run"
    _kernels.check_tensor(name, "colors", colors, 1)
    cuda = _kernels.on_cuda(name, colors, priority)
    for ids, nbrt in tiers:
        _check_bucket(name, ids, nbrt, colors, priority)
    if not 0 <= n < colors.shape[0]:
        raise ValueError(f"{name}: n = {n} for {colors.shape[0]} state slots")
    if not cuda:
        return jp_run_plain(colors, priority, tiers, limit=limit, n=n)
    dev = colors.device
    table = torch.tensor([[ids.data_ptr(), nbrt.data_ptr(), *nbrt.shape]
                          for ids, nbrt in tiers] or [[0, 0, 0, 0]],
                         dtype=torch.int64).to(dev)
    words = torch.empty(colors.shape[0], dtype=torch.int64, device=dev)
    ctl = torch.zeros(5 + 4 * len(tiers), dtype=torch.int64, device=dev)
    _kernels.launch("color_jp", "color_jp_run", table, len(tiers), colors,
                    colors.shape[0], priority, n, int(limit),
                    max([nbrt.shape[1] for _, nbrt in tiers] + [1]), words,
                    ctl)
    LAUNCHES["jp_run"] += 1
    return colors, ctl[1:2].to(torch.int32)


# ---------------------------------------------------------------------------
# K23: the speculative round's three passes
# ---------------------------------------------------------------------------

def spec_pick_plain(colors, ids, nbrt, pick0):
    vcol, ncol = _gather(colors, ids, nbrt)
    mex = _pick(ncol, nbrt != _SENT, torch.zeros_like(vcol),
                _color_words(nbrt.shape[1] + 2))
    pick0[ids.long()] = torch.where(vcol == UNCOLORED, mex,
                                    torch.full_like(mex, -2))
    return pick0


def spec_rank_plain(colors, pick0, priority, ids, nbrt, tent):
    vcol, ncol = _gather(colors, ids, nbrt)
    vpk, npk = _gather(pick0, ids, nbrt)
    vpri, npri = _gather(priority, ids, nbrt)
    valid = nbrt != _SENT
    k = (valid & (npk == vpk[:, None]) & (npri > vpri[:, None])).sum(dim=1)
    pick = _pick(ncol, valid, k.clamp(max=SPEC_RANK_CAP),
                 _color_words(nbrt.shape[1] + 2))
    tent[ids.long()] = torch.where(vcol == UNCOLORED, pick, vcol)
    return tent


def spec_clash_plain(colors, tent, priority, ids, nbrt, out):
    vcol = colors[ids.long()]
    vten, nten = _gather(tent, ids, nbrt)
    vpri, npri = _gather(priority, ids, nbrt)
    lose = ((nbrt != _SENT) & (nten == vten[:, None])
            & (npri > vpri[:, None])).any(dim=1)
    out[ids.long()] = torch.where((vcol == UNCOLORED) & ~lose, vten, vcol)
    return out


def spec_pick(colors, ids, nbrt, pick0):
    """Pass 1 into pick0[ids]: the mex of the committed neighbours' colors
    for an uncolored row, -2 for a colored one."""
    name = "spec_pick"
    if not _check_bucket(name, ids, nbrt, colors, pick0):
        return spec_pick_plain(colors, ids, nbrt, pick0)
    Vt, Dt = nbrt.shape
    _kernels.launch("color_spec", "spec_pick", ids, nbrt, Vt, Dt, colors,
                    _color_words(Dt + 2), pick0)
    LAUNCHES["color_spec"] += 1
    return pick0


def spec_rank(colors, pick0, priority, ids, nbrt, tent):
    """Pass 2 into tent[ids]: k = #neighbours with the same pick0 and a
    strictly higher priority, capped at 31; the k-th free color."""
    name = "spec_rank"
    if not _check_bucket(name, ids, nbrt, colors, pick0, priority, tent):
        return spec_rank_plain(colors, pick0, priority, ids, nbrt, tent)
    Vt, Dt = nbrt.shape
    _kernels.launch("color_spec", "spec_rank", ids, nbrt, Vt, Dt, colors,
                    pick0, priority, _color_words(Dt + 2), tent)
    LAUNCHES["color_spec"] += 1
    return tent


def spec_clash(colors, tent, priority, ids, nbrt, out):
    """Pass 3 into out[ids]: an uncolored row keeps its tent unless a
    neighbour of strictly higher priority holds the same."""
    name = "spec_clash"
    if not _check_bucket(name, ids, nbrt, colors, tent, priority, out):
        return spec_clash_plain(colors, tent, priority, ids, nbrt, out)
    Vt, Dt = nbrt.shape
    _kernels.launch("color_spec", "spec_clash", ids, nbrt, Vt, Dt, colors,
                    tent, priority, out)
    LAUNCHES["color_spec"] += 1
    return out


def _spec_round(colors, priority, tiers, pick, rank, clash):
    pick0 = colors.clone()
    for ids, nbrt in tiers:
        pick(colors, ids, nbrt, pick0)
    tent = colors.clone()
    for ids, nbrt in tiers:
        rank(colors, pick0, priority, ids, nbrt, tent)
    out = colors.clone()
    for ids, nbrt in tiers:
        clash(colors, tent, priority, ids, nbrt, out)
    return out


def spec_round(colors, priority, tiers):
    """One speculative round (gms_tpu _spec_round_tiered, coloring.py:202)."""
    return _spec_round(colors, priority, tiers, spec_pick, spec_rank,
                       spec_clash)


def spec_round_plain(colors, priority, tiers):
    return _spec_round(colors, priority, tiers, spec_pick_plain,
                       spec_rank_plain, spec_clash_plain)


# ---------------------------------------------------------------------------
# K24: the randomized rounds on explicit draws
# ---------------------------------------------------------------------------

def _picks(colors, draws, mod, idx):
    """Johansson's pick at idx: the color when colored, else draw mod deg1."""
    c = _take_clip(colors, idx)
    return torch.where(c == UNCOLORED, torch.remainder(
        _take_clip(draws, idx), _take_clip(mod, idx)), c)


def johansson_bucket_plain(colors, deg1, draws, ids, nbrt, out):
    vcol = colors[ids.long()]
    vpick = _picks(colors, draws, deg1, ids)
    npick = _picks(colors, draws, deg1, nbrt)
    clash = ((nbrt != _SENT) & (npick == vpick[:, None])).any(dim=1)
    out[ids.long()] = torch.where((vcol == UNCOLORED) & ~clash, vpick, vcol)
    return out


def johansson_bucket(colors, deg1, draws, ids, nbrt, out):
    """One Johansson round over a bucket into out[ids]: an uncolored row
    picks draws mod deg1 (draws non-negative int32; johansson feeds
    gms_tpu's picks, already in [0, deg1)) and keeps it unless a neighbour
    holds or picked the same."""
    name = "johansson_bucket"
    if not _check_bucket(name, ids, nbrt, colors, deg1, draws, out):
        return johansson_bucket_plain(colors, deg1, draws, ids, nbrt, out)
    Vt, Dt = nbrt.shape
    _kernels.launch("color_random", "johansson", ids, nbrt, Vt, Dt, colors,
                    deg1, draws, out)
    LAUNCHES["color_johansson"] += 1
    return out


def _johansson_round(colors, deg1, draws, tiers, bucket):
    out = colors.clone()
    for ids, nbrt in tiers:
        bucket(colors, deg1, draws, ids, nbrt, out)
    return out


def johansson_round(colors, deg1, draws, tiers):
    """One Johansson round (gms_tpu _johansson_round_tiered, coloring.py:127)
    with the draws given: int32[n + 1], non-negative (`johansson_draws`)."""
    return _johansson_round(colors, deg1, draws, tiers, johansson_bucket)


def johansson_round_plain(colors, deg1, draws, tiers):
    return _johansson_round(colors, deg1, draws, tiers,
                            johansson_bucket_plain)


def one_shot_pick_plain(colors, deg1, draws, ids, nbrt, pick, nfree, *,
                        palette_deg: bool, delta: int):
    vcol, ncol = _gather(colors, ids, nbrt)
    limit = (deg1[ids.long()].long() if palette_deg
             else torch.full_like(vcol, delta + 1, dtype=torch.long))
    s, nused = _used_sorted(ncol, nbrt != _SENT, limit)
    nf = limit - nused
    r = prng.randint_from_bits(draws[:, ids.long()], 0, nf.clamp(min=1), 64)
    p = torch.where(nf > 0, _kth_from_sorted(s, r), torch.zeros_like(r))
    unc = vcol == UNCOLORED
    pick[ids.long()] = torch.where(unc, p.to(torch.int32), vcol)
    nfree[ids.long()] = torch.where(unc, nf, torch.zeros_like(nf)).to(
        torch.int32)
    return pick, nfree


def one_shot_resolve_plain(colors, pick, nfree, ids, nbrt, out):
    vcol, ncol = _gather(colors, ids, nbrt)
    vpick, npick = _gather(pick, ids, nbrt)
    lose = ((nbrt != _SENT) & (ncol == UNCOLORED) & (npick == vpick[:, None])
            & (nbrt > ids[:, None])).any(dim=1)
    ok = (vcol == UNCOLORED) & (nfree[ids.long()] > 0) & ~lose
    out[ids.long()] = torch.where(ok, vpick, vcol)
    return out


def one_shot_pick(colors, deg1, draws, ids, nbrt, pick, nfree, *,
                  palette_deg: bool, delta: int):
    """Barenboim/Elkin's pick over a bucket into pick[ids], nfree[ids]: the
    free palette ([0, deg1) for Elkin, [0, delta + 1) for Barenboim) less
    the committed neighbours' colors; r = jax's randint in [0, max(nfree,
    1)) of the row's two 64-bit words draws[:, v] (int64[2, n + 1],
    `one_shot_draws`); the r-th free color (0 when none). Colored rows:
    their color and nfree 0."""
    name = "one_shot_pick"
    _kernels.check_tensor(name, "draws", draws, 2, torch.int64)
    if draws.shape != (2, colors.shape[0]):
        raise ValueError(f"{name}: draws {tuple(draws.shape)} for "
                         f"{colors.shape[0]} state slots")
    cuda = _check_bucket(name, ids, nbrt, colors, deg1, pick, nfree)
    _kernels.on_cuda(name, ids, draws)      # raises on another device
    if not cuda:
        return one_shot_pick_plain(colors, deg1, draws, ids, nbrt, pick,
                                   nfree, palette_deg=palette_deg,
                                   delta=delta)
    Vt, Dt = nbrt.shape
    _kernels.launch("color_random", "one_shot_pick", ids, nbrt, Vt, Dt,
                    colors, deg1, draws, draws.shape[1], int(palette_deg),
                    int(delta),
                    _color_words((Dt if palette_deg else delta) + 2), pick,
                    nfree)
    LAUNCHES["color_one_shot"] += 1
    return pick, nfree


def one_shot_resolve(colors, pick, nfree, ids, nbrt, out):
    """The one-shot conflict rule over a bucket into out[ids]: an uncolored
    row keeps its pick when nfree > 0 and no uncolored neighbour of higher
    id picked the same."""
    name = "one_shot_resolve"
    if not _check_bucket(name, ids, nbrt, colors, pick, nfree, out):
        return one_shot_resolve_plain(colors, pick, nfree, ids, nbrt, out)
    Vt, Dt = nbrt.shape
    _kernels.launch("color_random", "one_shot_resolve", ids, nbrt, Vt, Dt,
                    colors, pick, nfree, out)
    LAUNCHES["color_one_shot"] += 1
    return out


def _one_shot_round(colors, deg1, draws, tiers, palette_deg, delta, pick_fn,
                    resolve_fn):
    pick = colors.clone()
    nfree = torch.zeros_like(colors)
    for ids, nbrt in tiers:
        pick_fn(colors, deg1, draws, ids, nbrt, pick, nfree,
                palette_deg=palette_deg, delta=delta)
    out = colors.clone()
    for ids, nbrt in tiers:
        resolve_fn(colors, pick, nfree, ids, nbrt, out)
    return out, nfree


def one_shot_round(colors, deg1, draws, tiers, *, palette_deg: bool,
                   delta: int):
    """One Barenboim/Elkin round (gms_tpu _one_shot_round, coloring.py:404)
    with the draws given (int64[2, n + 1], `one_shot_draws`); returns
    (colors, nfree)."""
    return _one_shot_round(colors, deg1, draws, tiers, palette_deg, delta,
                           one_shot_pick, one_shot_resolve)


def one_shot_round_plain(colors, deg1, draws, tiers, *, palette_deg: bool,
                         delta: int):
    return _one_shot_round(colors, deg1, draws, tiers, palette_deg, delta,
                           one_shot_pick_plain, one_shot_resolve_plain)


# ---------------------------------------------------------------------------
# K25: one Jacobi min-label step on the friend graph
# ---------------------------------------------------------------------------

def component_step_plain(indptr, indices, comp):
    """gms_tpu's step on padded friend rows: min of comp over each row, the
    empty slots n (above every label), rows a slice at a time."""
    n = comp.shape[0]
    deg = indptr[1:] - indptr[:-1]
    nxt = comp.clone()
    width = int(deg.max()) if n else 0
    if width:
        ext = torch.cat([comp, comp.new_full((1,), n)])
        step = max(1, _PLAIN_BUDGET // width)
        for s in range(0, n, step):
            d = deg[s:s + step]
            rows = torch.repeat_interleave(torch.arange(d.shape[0],
                                                        device=comp.device), d)
            col = (torch.arange(rows.shape[0], device=comp.device)
                   - torch.repeat_interleave(torch.cumsum(d, 0) - d, d))
            fnbr = torch.full((d.shape[0], width), n, dtype=torch.long,
                              device=comp.device)
            fnbr[rows, col] = indices[indptr[s]:indptr[s + d.shape[0]]].long()
            nxt[s:s + step] = torch.minimum(comp[s:s + step],
                                            ext[fnbr].min(dim=1).values)
    return nxt, (nxt != comp).any().to(torch.int32).reshape(1)


def component_step(indptr, indices, comp, *,
                   schedule: RowSchedule | None = None):
    """One step nxt[v] = min(comp[v], min over friends of comp) on the friend
    CSR (indptr int64[n + 1], indices int32); returns (nxt, changed
    int32[1]). `schedule` is the row schedule built from this indptr
    tensor (built here when None): a caller that steps builds it once."""
    name = "component_step"
    _kernels.check_tensor(name, "indptr", indptr, 1, torch.int64)
    _kernels.check_tensor(name, "indices", indices, 1)
    _kernels.check_tensor(name, "comp", comp, 1)
    n = comp.shape[0]
    if indptr.shape[0] != n + 1:
        raise ValueError(f"{name}: indptr has {indptr.shape[0]} entries for "
                         f"{n} vertices")
    if schedule is not None:
        check_schedule(name, schedule, indptr)
    if not _kernels.on_cuda(name, indptr, indices, comp):
        return component_step_plain(indptr, indices, comp)
    if schedule is None:
        schedule = build_row_schedule(indptr)
    nxt = torch.empty_like(comp)
    changed = torch.empty(1, dtype=torch.int32, device=comp.device)
    _kernels.launch("color_components", "component_step", indptr, indices,
                    n, comp, nxt, *schedule.launch_args(), changed)
    LAUNCHES["color_components"] += 1
    return nxt, changed


def _component_labels(indptr, indices, limit: int, step_fn):
    comp = torch.arange(indptr.shape[0] - 1, dtype=torch.int32,
                        device=indptr.device)
    r, changed = 0, True
    while changed and r < limit:
        comp, flag = step_fn(indptr, indices, comp)
        changed = bool(flag.item())
        r += 1
    ROUNDS["component_labels"] = r
    return comp


def component_labels(indptr, indices, limit: int):
    """Component labels of the friend CSR by synchronous min-label steps
    (gms_tpu _component_labels, coloring.py:486): until no label moves or
    `limit` steps, whichever comes first. One row schedule serves every
    step."""
    return _component_labels(indptr, indices, limit, functools.partial(
        component_step, schedule=build_row_schedule(indptr)))


def component_labels_plain(indptr, indices, limit: int):
    return _component_labels(indptr, indices, limit, component_step_plain)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _initial_colors(n: int, dev) -> torch.Tensor:
    colors = torch.full((n + 1,), UNCOLORED, dtype=torch.int32, device=dev)
    colors[n] = 0
    return colors


def _any_uncolored(colors, n: int) -> bool:
    return bool((colors[:n] == UNCOLORED).any())


def _run(round_fn, colors, n: int, limit: int, *args) -> tuple:
    """Up to `limit` rounds while a vertex is uncolored (gms_tpu's
    while_loop dispatch); returns (colors, rounds run)."""
    r = 0
    while r < limit and _any_uncolored(colors, n):
        colors = round_fn(colors, *args)
        r += 1
    return colors, r


def _dispatches(dispatch, colors, n: int, left: int, limit: int | None,
                counter: str, what: str) -> np.ndarray:
    """gms_tpu's host loop over its dispatches: dispatch(d, colors, unc)
    runs dispatch d and returns (colors, rounds), unc being the bool[n]
    uncolored mask read back after the previous dispatch (None before the
    first); rounds is an int, or jp_run's int32[1] on the card, read back
    with the colors. Returns the colors as numpy once every vertex is
    colored; raises once a dispatch leaves `left` or more uncolored, or
    after `limit` dispatches."""
    unc = None
    d = 0
    while limit is None or d < limit:
        colors, r = dispatch(d, colors, unc)
        if isinstance(r, torch.Tensor):
            both = torch.cat([colors[:n], r]).cpu().numpy()
            out, r = both[:n], int(both[n])
        else:
            out = colors[:n].cpu().numpy()
        ROUNDS[counter] += r
        unc = out == UNCOLORED
        now = int(unc.sum())
        if now == 0:
            return out
        if now >= left:
            break
        left = now
        d += 1
    raise RuntimeError(f"{what} failed to converge")


def jp_priorities(g: CSRGraph, priority: str, seed: int) -> np.ndarray:
    """gms_tpu's priorities as int32[n + 1]: perm + 1, the dump slot 0."""
    n = g.num_nodes
    if priority == "random":
        pr = np.random.default_rng(seed).permutation(n)
    elif priority == "degree":
        pr = np.argsort(np.lexsort((-np.arange(n), g.degrees)))
    elif priority == "id":
        pr = n - 1 - np.arange(n)
    else:
        raise ValueError(priority)
    pr1 = np.zeros(n + 1, np.int32)
    pr1[:n] = pr + 1
    return pr1


def jones_plassmann(g: CSRGraph, *, priority: str = "random", seed: int = 0,
                    max_rounds: int | None = None, speculative: bool = False,
                    device="cuda") -> np.ndarray:
    """Jones–Plassmann coloring; returns int32[n] colors (0-based), equal
    to gms_tpu's vertex for vertex.

    priority in {"random", "degree", "id"}; speculative=True runs the
    optimistic variant. Rounds run in dispatches of up to 64; after each the
    rows are re-tiered to the uncolored frontier, and a dispatch that colors
    nothing raises, as in gms_tpu."""
    dev = resolve(device)
    n = g.num_nodes
    ROUNDS["jones_plassmann"] = 0
    if n == 0:
        return np.zeros(0, np.int32)
    prio = torch.from_numpy(jp_priorities(g, priority, seed)).to(dev)
    budget = max_rounds or n

    def dispatch(d, colors, unc):
        # after the first dispatch, the rows of the uncolored frontier only
        tiers = _TierGraph(g, ids=None if unc is None
                           else np.nonzero(unc)[0]).to(dev)
        limit = min(budget - 64 * d, 64)
        if speculative:
            return _run(spec_round, colors, n, limit, prio, tiers)
        return jp_run(colors, prio, tiers, limit=limit, n=n)

    return _dispatches(dispatch, _initial_colors(n, dev), n, n,
                       -(-budget // 64), "jones_plassmann", "jones_plassmann")


def johansson_draws(key, r: int, deg1) -> torch.Tensor:
    """Round r's picks of gms_tpu's Johansson round (coloring.py:133):
    randint(fold_in(key, r), (n + 1,), 0, deg1, int32)."""
    return prng.randint(prng.fold_in(key, r), deg1.shape, 0, deg1,
                        torch.int32)


def one_shot_draws(key, r: int, n1: int) -> torch.Tensor:
    """Round r's two 64-bit words a vertex of gms_tpu's one-shot randint
    (coloring.py:432, int64 with x64 on): int64[2, n1]; the kernel reduces
    them into [0, max(nfree, 1)) as jax's randint does."""
    return prng.randint_bits(prng.fold_in(key, r), (n1,), 64)


def _counted(round_fn):
    """round_fn(r, ...) as a round function of _run: r counts its calls
    from 0 (gms_tpu's fold_in of the round counter)."""
    rounds = itertools.count()
    return lambda *args: round_fn(next(rounds), *args)


def johansson(g: CSRGraph, *, seed: int = 0, device="cuda") -> np.ndarray:
    """Johansson randomized (deg+1)-coloring; returns int32[n], equal to
    gms_tpu's. Dispatch d (of up to 64, of up to 128 rounds) keys its
    rounds jax.random.key(seed + 1000 d) folded with the round."""
    dev = resolve(device)
    n = g.num_nodes
    ROUNDS["johansson"] = 0
    if n == 0:
        return np.zeros(0, np.int32)
    tiers = _TierGraph(g).to(dev)
    deg1 = torch.from_numpy(np.concatenate([g.degrees + 1, [1]])
                            .astype(np.int32)).to(dev)

    def dispatch(d, colors, unc):
        key = prng.key(seed + 1000 * d, dev)
        return _run(_counted(lambda r, c, d1, t: johansson_round(
            c, d1, johansson_draws(key, r, d1), t)), colors, n, 128, deg1,
            tiers)

    return _dispatches(dispatch, _initial_colors(n, dev), n, n + 1, 64,
                       "johansson", "johansson")


def barenboim_elkin(g: CSRGraph, *, variant: str = "barenboim",
                    seed: int = 0, device="cuda") -> np.ndarray:
    """Barenboim / Elkin randomized palette coloring; returns int32[n].

    variant="barenboim": the global Δ+1 palette; "elkin": per-vertex deg+1
    palettes. Up to 64 (floor(log2(n + 2)) + 8) rounds, as gms_tpu, keyed
    jax.random.key(seed) folded with the round: equal to gms_tpu's."""
    dev = resolve(device)
    n = g.num_nodes
    ROUNDS["barenboim_elkin"] = 0
    if n == 0:
        return np.zeros(0, np.int32)
    tiers = _TierGraph(g).to(dev)
    colors = _initial_colors(n, dev)
    deg1 = torch.from_numpy(np.concatenate([g.degrees + 1, [1]])
                            .astype(np.int32)).to(dev)
    palette_deg = variant == "elkin"
    delta = g.max_degree
    key = prng.key(seed, dev)
    limit = 64 * (int(np.log2(n + 2)) + 8)
    colors, r = _run(_counted(lambda r, c, d, t: one_shot_round(
        c, d, one_shot_draws(key, r, n + 1), t, palette_deg=palette_deg,
        delta=delta)[0]), colors, n, limit, deg1, tiers)
    ROUNDS["barenboim_elkin"] = r
    out = colors[:n].cpu().numpy()
    if (out == UNCOLORED).any():
        raise RuntimeError(f"{variant} failed to converge")
    return out


def _common_neighbors(g: CSRGraph, pairs: np.ndarray, dev,
                      edge_chunk: int) -> np.ndarray:
    """|N(u) ∩ N(v)| of each pair through K18 (similarity.pair_scores,
    common_neighbors; exact below 2^24), on a padded table of the pairs'
    endpoints only."""
    from gms_tpu_torch.algorithms import similarity as vs

    ends = np.unique(pairs)
    deg = g.degrees[ends].astype(np.int64)
    width = round_up(max(int(deg.max()), 1), 128)
    nbr = np.full((len(ends) + 1, width), SENTINEL, np.int32)
    rows = np.repeat(np.arange(len(ends)), deg)
    col = np.arange(deg.sum()) - np.repeat(np.cumsum(deg) - deg, deg)
    nbr[rows, col] = g.indices[np.repeat(g.indptr[ends], deg) + col]
    deg1 = np.zeros(len(ends) + 2, np.int32)
    deg1[:len(ends)] = deg
    nbr_t = torch.from_numpy(nbr).to(dev)
    deg1_t = torch.from_numpy(deg1).to(dev)
    local = np.searchsorted(ends, pairs).astype(np.int32)
    out = []
    for s in range(0, len(local), edge_chunk):
        p = torch.from_numpy(local[s:s + edge_chunk]).to(dev)
        out.append(vs.pair_scores(nbr_t, deg1_t, p,
                                  metric="common_neighbors").cpu().numpy())
    return np.concatenate(out)


def dense_sparse(g: CSRGraph, *, eps: float = 0.2, seed: int = 0,
                 friend_number: int | None = None,
                 edge_chunk: int = 1 << 15, device="cuda") -> np.ndarray:
    """Dense/sparse decomposition coloring (coloring_dense_sparse.h), equal
    to gms_tpu's vertex for vertex: friend edges (both degrees and the
    common-neighbour count >= friendNumber = ceil((1 - eps)(Δ + 1)), counts
    by K18), dense vertices, components of the friend graph (K25), colors by
    rank within component (host), the degree cap and one conflict reset
    (torch over the edge list), then strict JP (K22) to the end."""
    dev = resolve(device)
    n = g.num_nodes
    ROUNDS["dense_sparse"] = 0
    if n == 0:
        return np.zeros(0, np.int32)
    deg = g.degrees
    delta = int(deg.max())
    fnum = (friend_number if friend_number is not None
            else max(2, int(np.ceil((1.0 - eps) * (delta + 1)))))

    # 1. friend edges
    und = g.undirected_edge_array()
    cand = und[(deg[und[:, 0]] >= fnum) & (deg[und[:, 1]] >= fnum)]
    fedges = cand
    if len(cand):
        fedges = cand[_common_neighbors(g, cand, dev, edge_chunk) >= fnum]
    # 2. dense vertices, and the friend edges between them
    fcount = (np.bincount(fedges.reshape(-1), minlength=n) if len(fedges)
              else np.zeros(n, np.int64))
    dense = fcount >= fnum
    if len(fedges):
        fedges = fedges[dense[fedges[:, 0]] & dense[fedges[:, 1]]]

    colors = np.full(n, UNCOLORED, np.int32)
    prio = jp_priorities(g, "random", seed)
    prio_t = torch.from_numpy(prio).to(dev)
    if len(fedges):
        # 3. components of the friend graph; 4. rank within component
        both = np.concatenate([fedges, fedges[:, ::-1]]).astype(np.int32)
        order = np.lexsort((both[:, 1], both[:, 0]))
        fg = _csr_from_sorted_pairs(both[order], n, directed=False)
        limit = 4 * int(np.ceil(np.log2(n + 2))) + 8
        comp = component_labels(torch.from_numpy(fg.indptr).to(dev),
                                torch.from_numpy(fg.indices).to(dev),
                                limit).cpu().numpy()
        dv = np.nonzero(dense)[0]
        o = np.lexsort((dv, comp[dv]))
        sd = dv[o]
        cd = comp[dv][o]
        starts = np.concatenate([[0], np.nonzero(np.diff(cd))[0] + 1])
        sizes = np.diff(np.concatenate([starts, [len(sd)]]))
        colors[sd] = (np.arange(len(sd))
                      - np.repeat(starts, sizes)).astype(np.int32)
        # the degree cap, then reset the lower-priority end of any
        # monochromatic edge
        colors[colors > deg] = UNCOLORED
    cj = torch.from_numpy(np.concatenate([colors, [0]]).astype(np.int32)
                          ).to(dev)
    if len(fedges):
        e = torch.from_numpy(g.edge_array()).to(dev).long()
        src, dst = e[:, 0], e[:, 1]
        cs = cj[src]
        mono = (cs >= 0) & (cs == cj[dst]) & (prio_t[dst] > prio_t[src])
        lose = torch.zeros(n + 1, dtype=torch.bool, device=dev)
        lose[src[mono]] = True
        cj = torch.where(lose, torch.full_like(cj, UNCOLORED), cj)
        del e, src, dst, cs, mono, lose
    # 5. strict JP to the end, over the whole graph's tiers
    tiers = _TierGraph(g).to(dev)
    return _dispatches(lambda d, c, unc: jp_run(c, prio_t, tiers, limit=64,
                                                n=n),
                       cj, n, n + 1, None, "dense_sparse", "dense_sparse")


def greedy_sequential(g: CSRGraph, order: np.ndarray | None = None
                      ) -> np.ndarray:
    """Host greedy in the given order (coloring_sequential.h role); oracle."""
    n = g.num_nodes
    colors = np.full(n, -1, np.int64)
    if order is None:
        order = np.arange(n)
    for v in order:
        used = {colors[w] for w in g.out_neigh(int(v))}
        c = 0
        while c in used:
            c += 1
        colors[v] = c
    return colors.astype(np.int32)


# ---------------------------------------------------------------------------
# verifiers (coloring_common.h:28-205)
# ---------------------------------------------------------------------------

def verify_coloring(g: CSRGraph, colors: np.ndarray) -> bool:
    """GCVerifierWeak: proper (no edge monochromatic) and all colored."""
    colors = np.asarray(colors)
    if (colors < 0).any():
        return False
    e = g.edge_array()
    return not np.any(colors[e[:, 0]] == colors[e[:, 1]])


def verify_degree_bound(g: CSRGraph, colors: np.ndarray) -> bool:
    """GCVerifierDegree: color(v) <= deg(v) for all v."""
    return bool(np.all(np.asarray(colors) <= g.degrees))


def verify_delta_plus_one(g: CSRGraph, colors: np.ndarray) -> bool:
    """GCVerifierDeltaPlusOne: #colors <= Δ+1."""
    return unique_colors_count(colors) <= g.max_degree + 1


def unique_colors_count(colors: np.ndarray) -> int:
    return int(len(np.unique(np.asarray(colors))))
