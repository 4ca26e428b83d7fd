"""K8 (hub_cover_bits), K13 (decode_star_rows), K11 (build_local_univ), K12
(star_stack) and K10 (decode_clique_members) on the card, over whole warm
calls; K4 beside K8.

K8 and K4 over one warm fused RMAT-14 `bron_kerbosch` count call
(chip_smoke.py's phase 12), K8 split by job, so that the hub jobs (one to a
few real roots padded to 256, IN up to 4,096) show; K4 also over the warm
RMAT-16 k=5 `kclique_count` call. K13 and K11 over the RMAT-12 k=4 emit
pass, every job's `star_fused_chunk(emit=True)` then `decode_star_rows`, as
phase 20 runs them, each split by job, K12 beside them, and both held job
by job as phase 22 holds them (--parts held). K10 over phase 14's RMAT-12
enumerate run (`bron_kerbosch(collect=True, sink=)`). The list call
`kclique_star_list(g, 4)` at RMAT-12 under torch.profiler (its device
time), then a full `gc.collect()` and the freeing of its pairs, each timed;
then, in a tree with `compact_star_rows`, its list-mode body once more
with each stage timed apart: the plan, the device work (emit and decode,
synchronised), the ids compacted on the card and copied, and the pairs
built (`star_pairs`). It holds some 4 M frozensets, tens of GB of host
memory; --parts picks the measurements.

Each call under torch.profiler (bench/profiling.py's profile_launches: the
kernel's device time and launches, each launch in launch order, the host
time and the device's idle share).

    python -m gms_tpu_torch.bench.cover_decode --label this [--parts emit,list]

To compare two checkouts on one card, run the other's package with this
script in turns: PYTHONPATH=<other checkout> python
gms_tpu_torch/bench/cover_decode.py --label other (its bench/profiling.py
must have profile_launches). Needs a card; prints the card's name and power
limit, the ptxas report of the libraries this call built, and one JSON
object last.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from gms_tpu_torch.bench.adj_jp import window
from gms_tpu_torch.bench.profiling import launch_split, profile_launches

SEED, DEGREE = 27491095, 16
BK_SCALE, BK_GOLDEN = 14, 165_402_717
BK_SMALL = 12
KC_SCALE, KC_K, KC_GOLDEN = 16, 5, 4_600_426_489
STAR_SCALE, STAR_K, STAR_GOLDEN = 12, 4, (4_077_953, 136_080_055)
# bare device-function names, the same in this tree and its parent
K4 = ("local_adj_kernel",)
K8 = ("cover_kernel",)
K10 = K13 = ("decode_rows_kernel",)
K11 = ("univ_kernel",)
# K12's count, stack and base scans, this tree's and the parent's
K12 = ("count_kernel", "root_offsets_kernel", "base_kernel", "stack_kernel")
LIBRARIES = ("bk_cover", "local_adj", "star_decode", "bk_decode",
             "star_univ", "star_stack")
# what --parts selects: K8 and K4 over the fused call, K4 over kclique_count,
# K10 over the enumerate run, K13 over the emit pass, K11 and K12 held job
# by job, the list call's split
PARTS = ("bk", "kc", "enum", "emit", "held", "list")
HELD_REPS = 10


def _rmat(scale):
    from gms_tpu_torch.io.builder import build_csr
    from gms_tpu_torch.io.generators import generate_rmat_el

    return build_csr(generate_rmat_el(scale, DEGREE, seed=SEED),
                     num_nodes=1 << scale)


def fused_bk(out: dict) -> None:
    """K8 by job and K4 over the warm fused RMAT-14 count call."""
    from gms_tpu_torch.algorithms import bron_kerbosch as bk
    from gms_tpu_torch.preprocessing import degeneracy

    g = _rmat(BK_SCALE)
    rank, _ = degeneracy.degeneracy_ordering_rank(g)

    def call():
        return bk.bron_kerbosch(g, device="cuda", rank=rank)

    if call() != BK_GOLDEN:
        raise SystemExit("bron_kerbosch: not the golden count")
    n, host_s, per, busy, seq = profile_launches(call)
    if n != BK_GOLDEN:
        raise SystemExit(f"profiled bron_kerbosch: {n}")
    tag = f"warm fused bron_kerbosch RMAT {BK_SCALE}:"
    run = window(tag, host_s, per, busy, {"K8": K8, "K4": K4})
    plan = bk.BKPlan(g, rank, np.arange(g.num_nodes, dtype=np.int32),
                     device="cuda")
    pad = plan.padded.v_pad
    jobs = [f"#{i} W={32 * ww} IN={in_w} real={int((c != pad).sum())}"
            for i, (c, ww, in_w) in enumerate(plan.jobs)]
    run["K8_by_job"] = launch_split(f"{tag} K8", seq, K8, jobs)
    out["fused_bk"] = run


def kclique_k4(out: dict) -> None:
    """K4 over the warm RMAT-16 k=5 kclique_count call."""
    from gms_tpu_torch.algorithms import k_clique as kc
    from gms_tpu_torch.preprocessing import degeneracy

    g = _rmat(KC_SCALE)
    rank, _ = degeneracy.degeneracy_ordering_rank(g)

    def call():
        return kc.kclique_count(g, KC_K, device="cuda", rank=rank)

    if call() != KC_GOLDEN:
        raise SystemExit("kclique_count: not the golden count")
    n, host_s, per, busy, _ = profile_launches(call)
    if n != KC_GOLDEN:
        raise SystemExit(f"profiled kclique_count: {n}")
    out["kclique_count"] = window(
        f"warm kclique_count RMAT {KC_SCALE} k={KC_K}:", host_s, per, busy,
        {"K4": K4})


def star_emit(out: dict, g, rank) -> None:
    """K13 by job over the RMAT-12 k=4 emit pass (phase 20's loop)."""
    from gms_tpu_torch.algorithms import k_clique_star as ks
    from gms_tpu_torch.algorithms.triangle_count import popcount32

    pg, rank_pad, jobs = ks.plan_star_jobs(g, STAR_K, device="cuda",
                                           rank=rank)

    def emit_pass():
        rows = stars = 0
        for chunk, ww in jobs:
            _, o = ks.star_fused_chunk(pg.nbr, rank_pad, chunk, w_words=ww,
                                       k=STAR_K, emit=True)
            gid, members, star_ids = ks.decode_star_rows(pg.nbr, chunk, o)
            stars += int(popcount32(o[:, ww:2 * ww]).sum())
            rows += o.shape[0]
            del o, gid, members, star_ids
        return rows, stars

    if emit_pass() != STAR_GOLDEN:
        raise SystemExit("star emit pass: not the golden sums")
    got, host_s, per, busy, seq = profile_launches(emit_pass)
    if got != STAR_GOLDEN:
        raise SystemExit(f"profiled star emit pass: {got}")
    tag = f"RMAT {STAR_SCALE} k={STAR_K} emit pass:"
    run = window(tag, host_s, per, busy, {"K13": K13, "K11": K11,
                                          "K12": K12})
    widths = [f"W={32 * ww}" for _, ww in jobs]
    run["K13_by_job"] = launch_split(f"{tag} K13", seq, K13, widths)
    run["K11_by_job"] = launch_split(f"{tag} K11", seq, K11, widths)
    out["star_emit"] = run


def star_held(out: dict, g, rank) -> None:
    """K11 and K12 held job by job over the RMAT-12 k=4 jobs, as
    chip_smoke.py's phase 22 times them: the median of HELD_REPS CUDA-event
    timings of one wrapper call, after a first call, with L2 flushed (a
    256 MB write) before each; K12 in count and in emit mode (the emit call
    includes its count pass and read-back)."""
    from gms_tpu_torch.algorithms import k_clique_star as ks

    pg, rank_pad, jobs = ks.plan_star_jobs(g, STAR_K, device="cuda",
                                           rank=rank)
    flush = torch.empty(1 << 26, dtype=torch.int32, device="cuda")

    def ms(fn):
        fn()
        times = []
        for _ in range(HELD_REPS):
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    held = {}
    for chunk, ww in jobs:
        univ = (*ks.build_local_univ(pg.nbr, rank_pad, chunk, w_words=ww),
                chunk != pg.v_pad)
        held[f"W={32 * ww}"] = {
            "K11": ms(lambda c=chunk, w=ww: ks.build_local_univ(
                pg.nbr, rank_pad, c, w_words=w)),
            "K12": ms(lambda u=univ: ks.star_stack(*u, k=STAR_K)),
            "K12_emit": ms(lambda u=univ: ks.star_stack(*u, k=STAR_K,
                                                        emit=True))}
    sums = {key: sum(h[key] for h in held.values())
            for key in ("K11", "K12", "K12_emit")}
    print(f"    held RMAT {STAR_SCALE} k={STAR_K} jobs (ms, median of "
          f"{HELD_REPS}, L2 flushed): " + "; ".join(
              f"{w} " + " ".join(f"{k} {v:.4f}" for k, v in h.items())
              for w, h in held.items()))
    print("    held over the jobs: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in sums.items()))
    out["star_held"] = {"jobs": held, "sums": sums}


def star_list(out: dict, g, rank) -> None:
    """The list call under torch.profiler, a full collection and the freeing
    of its pairs after it, then its body with each stage timed apart
    (kclique_star_list's list mode, k_clique_star.py)."""
    from gms_tpu_torch.algorithms import k_clique_star as ks

    def call():
        return ks.kclique_star_list(g, STAR_K, device="cuda", rank=rank)

    res, host_s, per, busy, _ = profile_launches(call)
    n_pairs = len(res)
    if n_pairs != STAR_GOLDEN[0]:
        raise SystemExit(f"list call: {n_pairs} pairs")
    run = window(f"list call RMAT {STAR_SCALE} k={STAR_K}:", host_s, per,
                 busy, {"K13": K13, "K11": K11, "K12": K12})
    t0 = time.perf_counter()
    gc.collect()
    t1 = time.perf_counter()
    del res
    run["after"] = {"gc_collect_s": t1 - t0,
                    "free_s": time.perf_counter() - t1}
    print("    after the call: " + ", ".join(
        f"{k} {v:.4f}" for k, v in run["after"].items()))
    out["star_list"] = run
    if not hasattr(ks, "compact_star_rows"):
        return

    t0 = time.perf_counter()
    pg, rank_pad, jobs = ks.plan_star_jobs(g, STAR_K, device="cuda",
                                           rank=rank)
    torch.cuda.synchronize()
    split = {"plan_s": time.perf_counter() - t0, "device_s": 0.0,
             "compact_s": 0.0, "pairs_s": 0.0}
    rows = []
    for chunk, ww in jobs:
        t0 = time.perf_counter()
        _, o = ks.star_fused_chunk(pg.nbr, rank_pad, chunk, w_words=ww,
                                   k=STAR_K, emit=True)
        if not o.shape[0]:
            continue
        dev = ks.decode_star_rows(pg.nbr, chunk, o)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rows.append(ks.compact_star_rows(*dev))
        split["device_s"] += t1 - t0
        split["compact_s"] += time.perf_counter() - t1
        del o, dev
    t0 = time.perf_counter()
    results = ks.star_pairs(rows)
    split["pairs_s"] = time.perf_counter() - t0
    if len(results) != STAR_GOLDEN[0]:
        raise SystemExit(f"the list body gave {len(results)} pairs")
    split["copy_bytes"] = sum(a.nbytes for r in rows for a in r)
    del results, rows
    print("    list body: " + ", ".join(
        f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in split.items()))
    run["split"] = split


def bk_enumerate(out: dict) -> None:
    """K10 over the RMAT-12 enumerate run streamed to a sink (phase 14)."""
    from gms_tpu_torch.algorithms import bron_kerbosch as bk
    from gms_tpu_torch.preprocessing import degeneracy

    g = _rmat(BK_SMALL)
    rank, _ = degeneracy.degeneracy_ordering_rank(g)
    want = bk.bron_kerbosch(g, device="cuda", rank=rank)

    def call():
        rows = [0]
        n, _ = bk.bron_kerbosch(g, device="cuda", rank=rank, collect=True,
                                sink=lambda gid, m: rows.__setitem__(
                                    0, rows[0] + len(gid)))
        return n, rows[0]

    if call() != (want, want):
        raise SystemExit("enumerate run: rows and count differ")
    got, host_s, per, busy, _ = profile_launches(call)
    if got != (want, want):
        raise SystemExit(f"profiled enumerate run: {got}")
    out["bk_enumerate"] = window(
        f"RMAT {BK_SMALL} enumerate run with sink=:", host_s, per, busy,
        {"K10": K10, "K8": K8})


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--label", default="")
    p.add_argument("--parts", default=",".join(PARTS),
                   help="comma-separated subset of " + ",".join(PARTS))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("cover_decode needs a CUDA device")

    import gms_tpu_torch
    from gms_tpu_torch import _kernels
    from gms_tpu_torch.preprocessing import degeneracy

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}; package {gms_tpu_torch.__file__}")
    built = _kernels.build()
    for name in LIBRARIES:
        if name in built:
            print(f"ptxas {name}:\n{built[name]}")
    out = {"label": args.label, "card": card}
    parts = args.parts.split(",")
    if "bk" in parts:
        fused_bk(out)
    if "kc" in parts:
        kclique_k4(out)
    if "enum" in parts:
        bk_enumerate(out)
    if {"emit", "held", "list"} & set(parts):
        g = _rmat(STAR_SCALE)
        rank, _ = degeneracy.degeneracy_ordering_rank(g)
        if "emit" in parts:
            star_emit(out, g, rank)
        if "held" in parts:
            star_held(out, g, rank)
        if "list" in parts:
            star_list(out, g, rank)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
