#!/usr/bin/env python3
"""Smoke test of the PyTorch port (gms_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one card

Drives the port's main path, triangle counting on RMAT scale 18 (average
degree 16, seed 27491095, the headline graph of bench.py), through the
entry points a user calls, and holds every hand-written CUDA kernel of that
path against its plain PyTorch version on the card. Phases, each printing a
line and each failing the run (non-zero exit) if it fails:

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
     8, 65 and None, both modes.

The line before the last is a JSON object describing every kernel; the last
is {"ok": true, "device": {...}}. Imports nothing of jax or gms_tpu.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import torch

GOLDEN = 82_647_223          # triangles, RMAT-18 deg 16 seed 27491095
SCALE, DEGREE, SEED = 18, 16, 27491095
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
KERNEL_REPS, PLAIN_REPS, STEADY_TRIALS = 10, 3, 20

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
}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


class Timing:
    """Median CUDA-event time of a call, with L2 flushed before each rep:
    on the main path every operand stream is far larger than the 50 MB L2,
    so each launch finds its inputs cold."""

    def __init__(self):
        self.flush = torch.empty(1 << 26, dtype=torch.int32, device="cuda")

    def ms(self, fn, reps: int) -> float:
        fn()
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


def compare(timing, calls):
    """calls: [(label, kernel_fn, plain_fn, bytes)] of one kernel on one
    trial; prints one line per call.

    Returns (max_abs_err, kernel_ms, plain_ms, bound_ms), each summed (the
    error maximised) over the calls. The bytes are the least the call must
    move (see data_words)."""
    err, k_ms, p_ms, bound = 0, 0.0, 0.0, 0.0
    for label, kernel, plain, nbytes in calls:
        got, want = kernel(), plain()
        diff = int((got.long() - want.long()).abs().max())
        kt, pt = timing.ms(kernel, KERNEL_REPS), timing.ms(plain, PLAIN_REPS)
        bt = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"    {label}: max_abs_err {diff}, kernel {kt:.4f} ms, bound "
              f"{bt:.4f} ms ({nbytes} bytes), plain {pt:.4f} ms")
        err, k_ms, p_ms, bound = max(err, diff), k_ms + kt, p_ms + pt, bound + bt
    return err, k_ms, p_ms, bound


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
        err, k_ms, p_ms, bound_ms = compare(timing, kcalls)
        print(f"[4] {name}: {len(kcalls)} launches/trial, max_abs_err {err}, "
              f"kernel {k_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes), "
              f"plain {p_ms:.4f} ms")
        check(err == 0, f"{name} disagrees with its plain version by {err}")
        bounds[name] = bound_ms
        source, replaces = KERNELS[name]
        report.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None})

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
    print(f"card: {card_line()}")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
