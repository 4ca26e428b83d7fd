#!/usr/bin/env python3
"""Smoke test of the PyTorch port (gms_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one card

Drives the port's two paths through the entry points a user calls —
triangle counting on RMAT scale 18 (average degree 16, seed 27491095, the
headline graph of bench.py) and k-clique counting on bench.py's three
k-clique graphs — and holds every hand-written CUDA kernel of those paths
against its plain PyTorch version on the card. Phases, each printing a line
and each failing the run (non-zero exit) if it fails:

  1. device and build: card name, power limit, nvcc build of csrc/*.cu;
  2. headline graph: generation and CSR build on the host;
  3. main path, with every launch counter set to 0 just before it: build
     TrianglePlan(g, device="cuda") (materialized) and run it, then the
     gather-mode plan (materialize=False) and run it; both must give the
     golden count 82,647,223, and every kernel must have launched;
  4. each kernel against its plain version on the plan's own arrays at the
     headline shapes, exactly (integers, tolerance 0), with CUDA-event times;
  5. steady-state trial time of both plans;
  6. small graph (RMAT scale 12) against the host oracle, at hub thresholds
     8, 65 and None, both modes;
  7. the triangle path's launches and the time so far;
  8. k-clique main path, with every k-clique launch counter set to 0 just
     before it: kclique_count(g, k, device="cuda") on the three k-clique
     graphs of bench.py (RMAT 16 k=5, RMAT 13 k=6, RMAT 12 k=8, average
     degree 16, seed 27491095), each against its golden count, after the
     exact degeneracy peel; every k-clique kernel must have launched;
  9. RMAT 16 k=5 again under the ADG ordering (eps 0.1): the same count;
 10. each k-clique kernel against its plain version, exactly, with
     CUDA-event times: build_local_adj and kclique_dense_count on every
     chunk of RMAT 16 k=5, kc_stack_count on every chunk of RMAT 13 k=6 and
     RMAT 12 k=8 and on the W=256 chunk of K_132 at k=6;
 11. small graphs against the host oracle: RMAT 10 at k=3..7, K_7 at
     k=1..8, and K_132 at k=6 against C(132, 6).

The line before the last is a JSON object describing every kernel; the last
is {"ok": true, "device": {...}}. Imports nothing of jax or gms_tpu.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import time

import numpy as np

import torch

GOLDEN = 82_647_223          # triangles, RMAT-18 deg 16 seed 27491095
SCALE, DEGREE, SEED = 18, 16, 27491095
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
# __popc results per clock per SM at compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instructions throughput table); the rate of
# an AND+popcount word operation, times the SMs and the SM clock
POPC_PER_CLOCK_PER_SM = 16
KERNEL_REPS, PLAIN_REPS, STEADY_TRIALS = 10, 3, 20
# k-clique graphs of bench.py: (RMAT scale, k, golden count of BENCH_r05)
KCLIQUE_RUNS = ((16, 5, 4_600_426_489), (13, 6, 681_595_966),
                (12, 8, 2_339_107_240))

# kernel -> (source, gms_tpu program it replaces)
KERNELS = {
    "count_tier_mat": ("gms_tpu_torch/csrc/tier_intersect.cu",
                       "gms_tpu/algorithms/triangle_count.py:383"),
    "count_hub_groups_mat": ("gms_tpu_torch/csrc/hub_popcount.cu",
                             "gms_tpu/algorithms/triangle_count.py:359"),
    "build_hub_rows": ("gms_tpu_torch/csrc/hub_rows.cu",
                       "gms_tpu/algorithms/triangle_count.py:219"),
    "count_dag_edges": ("gms_tpu_torch/csrc/tier_intersect.cu",
                        "gms_tpu/algorithms/triangle_count.py:99"),
    "count_hub_groups": ("gms_tpu_torch/csrc/hub_popcount.cu",
                         "gms_tpu/algorithms/triangle_count.py:239"),
    "build_local_adj": ("gms_tpu_torch/csrc/local_adj.cu",
                        "gms_tpu/algorithms/k_clique.py:82"),
    "kclique_dense_count": ("gms_tpu_torch/csrc/kclique_dense.cu",
                            "gms_tpu/algorithms/k_clique.py:548"),
    "kc_stack_count": ("gms_tpu_torch/csrc/kclique_stack.cu",
                       "gms_tpu/algorithms/k_clique.py:343"),
}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def card_line() -> str:
    return smi("name,power.limit")


def popcount_rate() -> float:
    """AND+popcount word operations per second of card 0 at its maximum SM
    clock."""
    mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return POPC_PER_CLOCK_PER_SM * sms * mhz * 1e6


class Timing:
    """Median CUDA-event time of a call, with L2 flushed before each rep:
    on the main path every operand stream is far larger than the 50 MB L2,
    so each launch finds its inputs cold."""

    def __init__(self):
        self.flush = torch.empty(1 << 26, dtype=torch.int32, device="cuda")

    def ms(self, fn, reps: int) -> float:
        """fn must have run once already (compare runs it to check it)."""
        times = []
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def max_abs_err(got, want) -> int:
    if isinstance(got, tuple):
        return max(max_abs_err(g, w) for g, w in zip(got, want))
    return int((got.long() - want.long()).abs().max())


def compare(timing, calls, *, ops_rate=None, plain_reps=PLAIN_REPS):
    """calls: [(label, kernel_fn, plain_fn, bytes[, ops])] of one kernel on
    one trial; prints one line per call. Both functions run once for the
    comparison, which warms them up for the timing.

    Returns (max_abs_err, kernel_ms, plain_ms, bound_ms, bound_by), each
    summed (the error maximised) over the calls. A call's bound is the larger
    of its bytes (the least it must move, see data_words) over 3.35 TB/s and
    its word operations over `ops_rate`; bound_by names the larger sum."""
    err, k_ms, p_ms, bound, by_ops, by_bytes = 0, 0.0, 0.0, 0.0, 0.0, 0.0
    for label, kernel, plain, nbytes, *ops in calls:
        got, want = kernel(), plain()
        diff = max_abs_err(got, want)
        kt = timing.ms(kernel, KERNEL_REPS)
        pt = timing.ms(plain, plain_reps)
        bt = nbytes / HBM_BYTES_PER_S * 1e3
        ot = ops[0] / ops_rate * 1e3 if ops else 0.0
        ops_note = f", {ops[0]} word ops -> {ot:.4f} ms" if ops else ""
        print(f"    {label}: max_abs_err {diff}, kernel {kt:.4f} ms, bound "
              f"{max(bt, ot):.4f} ms ({nbytes} bytes -> {bt:.4f} ms"
              f"{ops_note}), plain {pt:.4f} ms")
        err, k_ms, p_ms = max(err, diff), k_ms + kt, p_ms + pt
        bound += max(bt, ot)
        by_ops, by_bytes = by_ops + ot, by_bytes + bt
    return (err, k_ms, p_ms, bound,
            "operations" if by_ops > by_bytes else "bytes")


# Bytes of a kernel's bound: the words that carry data, each read once, plus
# the index arrays and the output. A sorted row carries data up to and
# including its first SENTINEL (the merge stops there), or to the full width
# when it fills it; padding edges and guard slots carry none. Every kernel
# does at most one 32-bit operation per word it reads, and 67e12 op/s (the
# data sheet's 32-bit rate outside the tensor cores) is 80 times 3.35e12 B/s
# over 4 B words, so bytes bound all five.

def data_words(deg, ids, width: int) -> int:
    """Data words of the rows `ids` (with repeats) sliced to `width`."""
    return int((deg[ids.long()].long() + 1).clamp(max=width).sum())


def distinct_data_words(deg, uses) -> int:
    """Data words of each distinct row once, at the widest of the widths it
    is used with; uses: [(ids, width)]."""
    ids = torch.cat([i.reshape(-1).long() for i, _ in uses])
    width = torch.cat([torch.full((i.numel(),), w, dtype=torch.long,
                                  device=ids.device) for i, w in uses])
    widest = torch.zeros(deg.numel(), dtype=torch.long, device=ids.device)
    widest.scatter_reduce_(0, ids, width, "amax")
    return int(torch.minimum(deg.long() + 1, widest).sum())


def distinct_rows(guard: int, *ids) -> int:
    """Distinct rows named by `ids`, the all-zero guard row left out."""
    rows = torch.unique(torch.cat([i.reshape(-1) for i in ids]))
    return int((rows != guard).sum())


def kernel_entry(name, launches, err, k_ms, p_ms, bound_ms, by) -> dict:
    """One kernel's entry of the kernels line. No single PyTorch call
    computes any of these functions, so there is no library time."""
    source, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": None}


def tiers(chunks, pad_id) -> str:
    """'W: chunks / real roots' of each tier width of a k-clique plan."""
    out = {}
    for chunk, ww in chunks:
        c, r = out.get(32 * ww, (0, 0))
        out[32 * ww] = (c + 1, r + int((chunk != pad_id).sum()))
    return " · ".join(f"{w}: {c} / {r}" for w, (c, r) in sorted(out.items()))


def local_adj_bytes(pg, chunk, ww) -> int:
    """K4's bytes: each distinct row it reads (the roots' and their
    neighbours'), up to and including its first SENTINEL, the roots, and the
    adj and S0 words written."""
    from gms_tpu_torch.graphs.tiles import SENTINEL
    nbr, v_pad = pg.nbr, pg.v_pad
    roots = chunk.long().clamp(0, v_pad - 1)
    r_nbr = nbr[roots, :min(32 * ww, nbr.shape[1])]
    rows = torch.cat([roots, r_nbr[r_nbr != SENTINEL].long()])
    words = data_words(pg.deg, torch.unique(rows), nbr.shape[1])
    c = chunk.numel()
    return (words + c + c * 32 * ww * ww + c * ww) * 4


def kclique_phases(timing, report) -> None:
    """Phases 8-11: the k-clique path (see the module docstring)."""
    from gms_tpu_torch.algorithms import k_clique as kc
    from gms_tpu_torch.io.builder import build_csr
    from gms_tpu_torch.io.generators import generate_rmat_el
    from gms_tpu_torch.preprocessing import degeneracy

    graphs = {}
    for scale, k, golden in KCLIQUE_RUNS:
        t0 = time.perf_counter()
        g = build_csr(generate_rmat_el(scale, DEGREE, seed=SEED),
                      num_nodes=1 << scale)
        graphs[scale] = g
        print(f"[8] graph RMAT {scale}: {g.num_nodes} nodes, "
              f"{g.num_edges_undirected} undirected edges, "
              f"{time.perf_counter() - t0:.2f} s")

    # [8] main path, counters from 0
    kc.reset_launches()
    ranks = {}
    for scale, k, golden in KCLIQUE_RUNS:
        g = graphs[scale]
        t0 = time.perf_counter()
        rank, degen = degeneracy.degeneracy_ordering_rank(g)
        peel_s = time.perf_counter() - t0
        ranks[scale] = rank
        before = dict(kc.LAUNCHES)
        t0 = time.perf_counter()
        count = kc.kclique_count(g, k, device="cuda", rank=rank)
        count_s = time.perf_counter() - t0
        used = {n: kc.LAUNCHES[n] - before[n] for n in before}
        print(f"[8] RMAT {scale} k={k}: count {count}, golden {golden}; "
              f"degeneracy {degen}; peel {peel_s:.3f} s; count {count_s:.4f} s"
              f" (synchronised); {count / count_s:.1f} cliques/s; "
              f"launches {used}")
        check(count == golden, f"RMAT {scale} k={k}: {count} != {golden}")
    launches = dict(kc.LAUNCHES)
    print(f"[8] k-clique main path launches: {launches}")
    check(all(n > 0 for n in launches.values()),
          f"a k-clique kernel of the path never launched: {launches}")
    plans = {}
    for scale, k, golden in KCLIQUE_RUNS:
        t0 = time.perf_counter()
        pg, chunks = kc.plan_chunks(graphs[scale], k, device="cuda",
                                    rank=ranks[scale])
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
        plans[scale] = (k, pg, chunks)
        print(f"    RMAT {scale} k={k}: host plan (orient, pad, tiers, copies "
              f"to the card) {plan_s:.4f} s; D_pad {pg.d_pad}, tiers (W: "
              f"chunks / real roots) {tiers(chunks, pg.v_pad)}")

    # [9] the ADG ordering gives the same count
    head, k_head, golden = KCLIQUE_RUNS[0]
    t0 = time.perf_counter()
    adg = degeneracy.adg_ordering_rank(graphs[head], 0.1)
    adg_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    count = kc.kclique_count(graphs[head], k_head, device="cuda", rank=adg)
    count_s = time.perf_counter() - t0
    pg, chunks = kc.plan_chunks(graphs[head], k_head, device="cuda", rank=adg)
    print(f"[9] RMAT {head} k={k_head} ADG eps 0.1: count {count}; ADG "
          f"{adg_s:.3f} s; count {count_s:.4f} s; max out-degree "
          f"{int(pg.deg.max())}, D_pad {pg.d_pad}; tiers "
          f"{tiers(chunks, pg.v_pad)}")
    check(count == golden, f"ADG-ordered RMAT {head}: {count} != {golden}")
    del pg, chunks

    # [10] each kernel against its plain version, exactly
    rate = popcount_rate()
    print(f"[10] popcount rate {rate:.4e} word ops/s "
          f"({POPC_PER_CLOCK_PER_SM}/clock/SM x "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs x"
          f" {smi('clocks.max.sm')})")
    # the dense run (k=5): its k=4 counts give K5's operations
    _, pg, chunks = plans[head]
    adjs = [kc.build_local_adj(pg.nbr, c, w_words=ww) for c, ww in chunks]
    k3 = [int(kc.kclique_dense_count(a, k=3)) for a, _ in adjs]
    k4 = [int(kc.kclique_dense_count(a, k=4)) for a, _ in adjs]
    calls = {
        "build_local_adj": [
            (f"RMAT {head} W={32 * ww} C={c.numel()}",
             lambda c=c, ww=ww: kc.build_local_adj(pg.nbr, c, w_words=ww),
             lambda c=c, ww=ww: kc.build_local_adj_plain(pg.nbr, c,
                                                         w_words=ww),
             local_adj_bytes(pg, c, ww))
            for c, ww in chunks],
        "kclique_dense_count": [
            (f"RMAT {head} k=5 W={a.shape[1]} C={a.shape[0]}",
             lambda a=a: kc.kclique_dense_count(a, k=5),
             lambda a=a: kc.kclique_dense_count_plain(a, k=5),
             a.numel() * 4 + 8, n4 * a.shape[2])
            for (a, _), n4 in zip(adjs, k4)],
    }
    print(f"    RMAT {head} per chunk: k=3 counts {k3}, k=4 counts {k4}")
    del adjs
    stack_calls = []
    k_132 = np.stack(np.nonzero(np.triu(np.ones((132, 132), bool), 1)), 1)
    g132 = build_csr(k_132.astype(np.int64))
    pg132, chunks132 = kc.plan_chunks(g132, 6, device="cuda")
    runs = [(f"RMAT {s}", plans[s]) for s, _, _ in KCLIQUE_RUNS[1:]]
    runs.append(("K_132", (6, pg132, [(c, ww) for c, ww in chunks132
                                      if ww == 8])))
    for label, (k, pg, chunks) in runs:
        for c, ww in chunks:
            adj, s0 = kc.build_local_adj(pg.nbr, c, w_words=ww)
            stats = {}
            kc.kc_stack_count_plain(adj, s0, k=k, stats=stats)
            stack_calls.append((
                f"{label} k={k} W={32 * ww} C={c.numel()}",
                lambda adj=adj, s0=s0, k=k: kc.kc_stack_count(adj, s0, k=k),
                lambda adj=adj, s0=s0, k=k: kc.kc_stack_count_plain(adj, s0,
                                                                    k=k),
                (adj.numel() + s0.numel()) * 4 + 8, stats["word_ops"]))
    n_main = sum(len(plans[s][2]) for s, _, _ in KCLIQUE_RUNS[1:])
    calls["kc_stack_count"] = stack_calls[:n_main]
    for name, kcalls in calls.items():
        err, k_ms, p_ms, bound_ms, by = compare(timing, kcalls, ops_rate=rate,
                                                plain_reps=1)
        print(f"[10] {name}: {len(kcalls)} launches, max_abs_err {err}, "
              f"kernel {k_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}), "
              f"plain {p_ms:.4f} ms")
        check(err == 0, f"{name} disagrees with its plain version by {err}")
        report.append(kernel_entry(name, launches[name], err, k_ms, p_ms,
                                   bound_ms, by))
    err, k_ms, p_ms, bound_ms, by = compare(timing, stack_calls[n_main:],
                                            ops_rate=rate, plain_reps=1)
    print(f"[10] kc_stack_count K_132 W=256 chunk: max_abs_err {err}, kernel "
          f"{k_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}), plain "
          f"{p_ms:.4f} ms")
    check(err == 0, f"kc_stack_count disagrees on K_132 by {err}")
    del calls, stack_calls, plans

    # [11] small graphs against the oracle
    small = build_csr(generate_rmat_el(10, DEGREE, seed=SEED),
                      num_nodes=1 << 10)
    for k in range(3, 8):
        want = kc.kclique_count_oracle(small, k)
        got = kc.kclique_count(small, k, device="cuda")
        check(got == want, f"RMAT 10 k={k}: {got} != oracle {want}")
    k7 = build_csr(np.stack(np.nonzero(np.triu(np.ones((7, 7), bool), 1)),
                            1).astype(np.int64))
    for k in range(1, 9):
        got = kc.kclique_count(k7, k, device="cuda")
        check(got == math.comb(7, k), f"K_7 k={k}: {got} != {math.comb(7, k)}")
    got = kc.kclique_count(g132, 6, device="cuda")
    check(got == math.comb(132, 6), f"K_132 k=6: {got} != C(132, 6)")
    print(f"[11] RMAT 10 k=3..7 equal the oracle; K_7 k=1..8 and K_132 k=6 "
          f"({got}) equal the binomials")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False); this smoke test runs only on a GPU")
    from gms_tpu_torch import _kernels
    from gms_tpu_torch.algorithms import triangle_count as tc
    from gms_tpu_torch.graphs.tiles import SENTINEL
    from gms_tpu_torch.io.builder import build_csr
    from gms_tpu_torch.io.generators import generate_rmat_el

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[1] device: {kind} | nvidia-smi: {card} | torch {torch.__version__}"
          f" cuda {torch.version.cuda} | devices {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    reports = _kernels.build()
    print(f"[1] build: {len(reports)} libraries in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    ptxas {name}: {line.strip()}")

    # [2] headline graph (host)
    t0 = time.perf_counter()
    g = build_csr(generate_rmat_el(SCALE, DEGREE, seed=SEED),
                  num_nodes=1 << SCALE)
    print(f"[2] graph: RMAT scale {SCALE} deg {DEGREE} seed {SEED}: "
          f"{g.num_nodes} nodes, {g.num_edges_undirected} undirected edges, "
          f"max degree {g.max_degree}, {time.perf_counter() - t0:.2f} s")

    # [3] main path through the user's entry points, counters from 0
    tc.reset_launches()
    t0 = time.perf_counter()
    plan = tc.TrianglePlan(g, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    count = plan.run()
    gplan = tc.TrianglePlan(g, device="cuda", materialize=False)
    gcount = gplan.run()
    launches = dict(tc.LAUNCHES)
    print(f"[3] main path: materialized plan built in {build_s:.2f} s, "
          f"count {count}; gather plan count {gcount}; golden {GOLDEN}; "
          f"launches {launches}")
    check(plan.tiers_mat is not None, "the headline plan is not materialized")
    check(count == GOLDEN, f"materialized count {count} != {GOLDEN}")
    check(gcount == GOLDEN, f"gather-mode count {gcount} != {GOLDEN}")
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the path never launched: {launches}")
    print(f"    D_pad {plan.padded.d_pad}, V_pad {plan.padded.v_pad}, "
          f"traffic_bytes {plan.traffic_bytes()}")
    for wa, wb, c, edges, valid in plan.tiers:
        print(f"    tier ({wa},{wb}): {int(valid.sum())} edges, padded "
              f"{valid.numel()}")
    for w, k, gc, b_ids, nbrs in plan.hub or []:
        print(f"    hub group (W={w},K={k}): {b_ids.numel()} groups")
    print(f"    hub rows {tuple(plan.hub_rows.shape)}")

    # [4] each kernel against its plain version, exactly, at these shapes
    timing = Timing()
    rows, nbr, deg = plan.hub_rows, plan.padded.nbr, plan.padded.deg
    guard = rows.shape[0] - 1
    wide = plan.wide_ids
    wide_rows = nbr[wide.long()]
    # hub_id entries K3 looks up: each distinct neighbour and the clip slot
    looked_up = (torch.unique(wide_rows[wide_rows != SENTINEL]).numel()
                 + int((wide_rows == SENTINEL).any()))
    del wide_rows
    gdeg, gguard = gplan.padded.deg, gplan.hub_rows.shape[0] - 1
    calls = {
        "count_tier_mat": [
            (f"({a.shape[0]},{b.shape[0]}) E={a.shape[1]}",
             lambda a=a, b=b: tc.count_tier_mat(a, b),
             lambda a=a, b=b, cm=cm: tc.count_tier_mat_plain(a, b, chunk=cm),
             (data_words(deg, e[v > 0, 0], wa)
              + data_words(deg, e[v > 0, 1], wb)) * 4 + 8)
            for (wa, wb, c, e, v), (cm, a, b) in zip(plan.tiers,
                                                      plan.tiers_mat)],
        "count_hub_groups_mat": [
            (f"(W={b.shape[1]},K={a.shape[1]}) G={b.shape[0]}",
             lambda a=a, b=b: tc.count_hub_groups_mat(b, a),
             lambda a=a, b=b, gc=gc: tc.count_hub_groups_mat_plain(
                 b, a, chunk=gc),
             int((b_ids != guard).sum() + (nbrs != guard).sum()) * w * 4 + 8)
            for (w, k, _, b_ids, nbrs), (gc, b, a) in zip(plan.hub,
                                                           plan.hub_mat)],
        "build_hub_rows": [
            (f"Nw={wide.numel()} hw={rows.shape[1]}",
             lambda: tc.build_hub_rows(nbr, plan.hub_id, wide,
                                       hub_words=rows.shape[1]),
             lambda: tc.build_hub_rows_plain(nbr, plan.hub_id, wide,
                                             hub_words=rows.shape[1]),
             (data_words(deg, wide, nbr.shape[1]) + wide.numel() + looked_up
              + wide.numel() * rows.shape[1]) * 4)],
        "count_dag_edges": [
            (f"({wa},{wb}) E={e.shape[0]}",
             lambda e=e, v=v, wa=wa, wb=wb: tc.count_dag_edges(
                gplan.padded.nbr, e, v, width_a=wa, width_b=wb),
             lambda e=e, v=v, wa=wa, wb=wb, c=c: tc.count_dag_edges_plain(
                 gplan.padded.nbr, e, v, chunk=c, width_a=wa, width_b=wb),
             (distinct_data_words(gdeg, [(e[v > 0, 0], wa), (e[v > 0, 1], wb)])
              + e.numel() + v.numel()) * 4 + 8)
            for wa, wb, c, e, v in gplan.tiers],
        "count_hub_groups": [
            (f"(W={w},K={k}) G={b.shape[0]}",
             lambda b=b, n=n, w=w, k=k, gc=gc: tc.count_hub_groups(
                gplan.hub_rows, b, n, chunk=gc, width=w, k=k),
             lambda b=b, n=n, w=w, k=k, gc=gc: tc.count_hub_groups_plain(
                 gplan.hub_rows, b, n, chunk=gc, width=w, k=k),
             (distinct_rows(gguard, b, n) * w + b.numel() + n.numel()) * 4 + 8)
            for w, k, gc, b, n in gplan.hub],
    }
    report, bounds = [], {}
    for name, kcalls in calls.items():
        err, k_ms, p_ms, bound_ms, by = compare(timing, kcalls)
        print(f"[4] {name}: {len(kcalls)} launches/trial, max_abs_err {err}, "
              f"kernel {k_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}), "
              f"plain {p_ms:.4f} ms")
        check(err == 0, f"{name} disagrees with its plain version by {err}")
        bounds[name] = bound_ms
        report.append(kernel_entry(name, launches[name], err, k_ms, p_ms,
                                   bound_ms, by))

    # [5] steady state
    for label, p, kernels in (
            ("materialized", plan, ("count_tier_mat", "count_hub_groups_mat")),
            ("gather", gplan, ("count_dag_edges", "count_hub_groups"))):
        cnt, dt = p.run_steady(STEADY_TRIALS)
        modelled_ms = p.traffic_bytes() / HBM_BYTES_PER_S * 1e3
        bound_ms = sum(bounds[k] for k in kernels)
        print(f"[5] steady {label}: count {cnt}, {dt * 1e3:.4f} ms/trial over "
              f"{STEADY_TRIALS} trials, {g.num_edges_undirected / dt:.1f} "
              f"edges/s, bound {bound_ms:.4f} ms (sum of the launches'), "
              f"traffic_bytes() at 3.35 TB/s {modelled_ms:.4f} ms")
        check(cnt == GOLDEN, f"steady {label} count {cnt} != {GOLDEN}")
    del plan, gplan, calls

    # [6] small graph against the host oracle
    small = build_csr(generate_rmat_el(12, 16, seed=SEED), num_nodes=1 << 12)
    want = tc.triangle_count_oracle(small)
    got = tc.triangle_count(small, device="cuda")
    check(got == want, f"RMAT-12 triangle_count {got} != oracle {want}")
    for t in (8, 65, None):
        for mat in (True, False):
            got = tc.TrianglePlan(small, device="cuda", hub_threshold=t,
                                  materialize=mat).run()
            check(got == want, f"RMAT-12 hub_threshold={t} materialize={mat}:"
                               f" {got} != oracle {want}")
    print(f"[6] RMAT-12 oracle {want}: triangle_count and hub thresholds "
          f"8/65/None in both modes agree")

    print(f"[7] launches on the main path: {launches}; total "
          f"{time.perf_counter() - t_start:.1f} s")
    kclique_phases(timing, report)
    print(f"[12] total {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card_line()}")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
