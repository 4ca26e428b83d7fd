#!/usr/bin/env python3
"""Smoke test of the PyTorch port (gms_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one card

Drives the port's paths through the entry points a user calls — triangle
counting on RMAT scale 18 (average degree 16, seed 27491095, the headline
graph of bench.py), k-clique counting on bench.py's three k-clique graphs,
maximal clique enumeration (Bron–Kerbosch) on its RMAT scale 14 graph,
k-clique-star counting on its RMAT scale 12 graph, per-vertex triangle
counts, the triangle-count ordering and the device ADG ordering on RMAT 18,
dense-bitmap triangles and bitmap set counts on RMAT 16, and vertex
similarity and link prediction (bench.py's lp_auc round: the sampled AUC
and the top-q ranking) on RMAT 16, and graph coloring (Jones–Plassmann,
Johansson, Barenboim/Elkin, dense/sparse) on RMAT 16 — and holds every
hand-written CUDA kernel of those paths against its plain PyTorch version on
the card. Phases, each
printing a line and each failing the run (non-zero exit) if it fails:

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
     k=1..8, and K_132 at k=6 against C(132, 6);
 12. Bron–Kerbosch main path, with every BK launch counter and K4's set to
     0 just before it: bron_kerbosch(g, device="cuda", rank=rank) on RMAT 14
     (average degree 16, seed 27491095, the graph of bench.py's maximal
     clique run) after the exact degeneracy peel, against the golden
     165,402,717; the host plan timed apart, the tiers and launches; K4,
     symmetrize_bits, hub_cover_bits and bk_stack_machine must have
     launched, and their entries in the kernels line carry these counts;
 13. RMAT 14 again under the ADG ordering (eps 0.1): the same count;
 14. enumerate mode, with the counters set to 0 again just before its run:
     sink= at RMAT 12 (the rows sum to the count mode's count, every BK
     kernel and K4 launched, decode_clique_members's entry carries this
     run's count, a seeded sample of 1,000 rows are cliques and maximal),
     and collect=True at RMAT 8 against bron_kerbosch_simple (which,
     without a pivot, takes a minute at RMAT 9);
 15. the RMAT 14 call's kernels job by job, with CUDA-event times and
     bounds: symmetrize_bits and hub_cover_bits against their plain
     versions on every job (their kernels-line times are these), and
     bk_stack_machine (count, and emit as sorted rows) on the jobs with
     IN >= 2048 and on the W=128 job with the most cliques up to
     BK_PLAIN_CLIQUES (the plain search would take minutes on the largest);
 16. each BK kernel against its plain version, exactly, with CUDA-event
     times, on every job of RMAT 12, whose enumerate run of phase 14 is
     part of the path. bk_stack_machine's kernels-line times are summed
     over every job of phases 15 and 16 it was held against plain on; its
     bound is the larger of bytes over 3.35 TB/s and its operations, the
     popcounts at 16 and the bitwise operations at 64 a clock per SM;
 17. k-clique-star main path, with the star launch counters set to 0 just
     before it: kclique_star_list(g, 4, device="cuda", rank=rank,
     mode="count") on RMAT 12 (average degree 16, seed 27491095, the graph
     of bench.py's k-clique-star run) after the exact degeneracy peel,
     against the golden 4,077,953 cliques and 136,080,055 star total; timed
     warm, after one untimed first call (whose time is printed beside), the
     host plan timed apart, the jobs and launches; build_local_univ and
     star_stack must have launched;
 18. RMAT 12 again under the ADG ordering (eps 0.1): the same two numbers;
 19. the identity star_total(k) = (k+1) · kclique_count(g, k+1) at RMAT 12
     for k = 3 and 4 (the star of a k-clique is the set of vertices that
     extend it to a (k+1)-clique);
 20. emit mode at RMAT 12 job by job on the device, with the counters set
     to 0 again just before it: star_fused_chunk(emit=True) and
     decode_star_rows on every job; the rows sum to 4,077,953 and their
     star popcounts to 136,080,055; in a seeded sample of 1,000 rows the
     clique is a clique and the star equals its common neighbourhood less
     the clique;
 21. list mode: 30-vertex random graphs at k = 2, 3, 4 against
     kclique_star_oracle, and RMAT 10 at k = 3 against the port's own
     device="cpu" run, as sets;
 22. each star kernel against its plain version, exactly, with CUDA-event
     times and bounds: build_local_univ and decode_star_rows on every RMAT
     12 job, star_stack (count, and emit as sorted rows) on every job too;
     its bound is the larger of its bytes over 3.35 TB/s (live0, the live
     roots' S0 and I0, and the two matrices' rows of the slots it searches)
     and its operations, as K9's;
 23. per-vertex main path, with the triangle launch counters set to 0 just
     before it: triangle_count_per_vertex(g, device="cuda") on phase 2's
     RMAT 18, timed to its read-back, the host plan timed apart; the counts
     sum to 3 x 82,647,223, a seeded sample of 1,000 vertices and the 10 of
     highest degree equal a host recount, and count_dag_edges_per_vertex
     launched once per tier;
 24. triangle_count_ordering_rank at RMAT 18: a permutation ordering the
     vertices by (per-vertex count, id);
 25. dense path, the counters set to 0 just before it: triangle_count_dense
     on RMAT 16 equals TrianglePlan's count; the bitmap's bytes
     (536,870,912) and host build time; count_hub_edges launched once;
 26. device ADG at RMAT 18, the ADG counter set to 0 just before each run:
     "avg" and "min" at eps 0.01, 0.1 and 0.5 equal the host
     adg_ordering_rank rank for rank; "prob_min" and "prob_median" give the
     same permutation twice for a seed and pass
     verify_approx_degeneracy_order at RMAT 14; each run's rounds (adg_round
     launches) and time; the main path is the "avg" eps 0.1 run, whose
     launches adg_round's entry in the kernels line carries;
 27. bitmap_ops on RMAT 16's bitmap rows, row v against row v+1, the
     counter set to 0 just before: the four counts keep |A∪B| =
     |A|+|B|-|A∩B| and |A∖B| = |A|-|A∩B|, and |A| is v's out-degree;
 28. each of those kernels against its plain version, exactly, with
     CUDA-event times and bounds: count_dag_edges_per_vertex on every RMAT
     18 tier, count_hub_edges on RMAT 16's dense edges (its operations, one
     AND+popcount a word, bound it), bitmap_rows_count on phase 27's rows
     (the two views of one table are read once: their bytes count once),
     adg_round on every round state of the main path's "avg" eps 0.1 run
     (times and bounds summed over its rounds);
 30. link-prediction main path on RMAT 16 (bench.py's lp_auc protocol: test
     split extract_random_test_edges(g, int(0.01 m), seed=1)), with the
     similarity and link-prediction counters set to 0 just before it:
     AUCPlan(g, train, test, 100,000, metric="jaccard", seed=2) then
     run_steady(8); its eight timed trials' (higher, equal) must be the
     golden LP_GOLDEN and the AUC 0.85176; the host plan, seconds a trial
     and the launches (pair_scores, pair_scores_hub and auc_count 8 each in
     the timed call, 8 in the first call) printed; run(0) equals the plain
     versions' counts;
 31. score_auc for the bench's five metrics under gms_tpu's bench protocol
     (test split seed 0, 100,000 samples): each AUC in [0, 1]; (higher,
     equal) equal to the plain versions' for Jaccard, overlap and CN, the
     AUC within 1e-4 for AA and RA;
 32. vertex_similarity for the seven metrics on RMAT 16: 100,000 uniform
     pairs and 100,000 with a hub end against the plain version (bit for
     bit, AA and RA within rtol 1e-5), a seeded 1,000 against the host
     oracle;
 33. the top-q ranking, bench.py's call, the counters set to 0 just before:
     link_prediction_similarity(train, 100, metric="jaccard") on phase 30's
     train graph must return the 100 pairs of isolated vertices that
     gms_tpu's keyed rule picks (keyed_isolated_topq), all of score 1.0; its
     time and tile_topq's launches (one a u-block);
 34. top-q counting against the plain version on the card (float32 matmuls,
     TF32 off): CN and AA at RMAT 14 (CN's pairs and scores exactly, AA's
     scores within rtol 1e-5), the seven metrics at RMAT 12 with block 512,
     and all_pairs_scores on RMAT 12's first 512 rows (its counter set to 0
     just before: one tile_all_pairs a metric);
 35. each new kernel against its plain version, with CUDA-event times, L2
     flushed, and bounds: pair_scores and pair_scores_hub on phase 30's
     pairs (Jaccard; bytes: the pairs, their deg entries, each distinct row
     to its first SENTINEL, K19's distinct bitmap words probed, the output),
     auc_count on phase 30's scores, tile_topq on RMAT 16's first u-block
     and on every u-block of RMAT 14 (CN), tile_all_pairs on phase 34's
     block; tile_topq and tile_all_pairs are bound by their AND+popcounts
     (one a word of each pair they must score: u < v < n for tile_topq,
     all for tile_all_pairs), and their library time is the float32
     torch.matmul of the same common counts;
 37. coloring main path on RMAT 16 (bench.py's coloring graph), with every
     coloring launch counter set to 0 just before it:
     jones_plassmann(g, speculative=True, priority="degree") must give 104
     colors and digest c7b066c1de1c6f34 (COLOR_GOLDEN, gms_tpu's on the CPU);
     the first call's time (its round-start states recorded by wrapping the
     module's spec_round for the call),
     the median of 3 warm calls and of 3 host tier builds with their copy,
     the rounds and launches; color_spec must have launched;
 38. the other deterministic variants at RMAT 16, the counters set to 0
     before each: speculative random, strict JP-LF (its jp_round states
     recorded), strict random and dense_sparse(g, seed=0), each against its
     digest; color_jp must have launched;
 39. dense_sparse on RMAT 14 with friend_number 32 (its friend components
     fire): 265 colors, digest dc688ce0f6f78322 (its component_step
     states recorded); color_components and K18 (pair_scores) must have
     launched;
 40. the randomized runs at RMAT 16, the counters set to 0 before each
     (their round states and draws recorded): johansson (proper, color <=
     deg), barenboim_elkin "barenboim" (proper, <= Δ+1 colors) and "elkin"
     (both bounds); each color count, time and launches; color_johansson
     and color_one_shot must have launched;
 41. each coloring kernel against its plain version, exactly, on the
     round-start states recorded in 37-40 — the first round and the last
     with an uncolored vertex, every bucket: color_jp on strict JP-LF's,
     color_spec (its three passes) on the main path's, color_johansson on
     Johansson's, color_one_shot (pick and resolve) on Barenboim's (and,
     off the kernels line, on Elkin's), color_components on phase 39's
     first and last label steps; CUDA-event times, L2 flushed, and bytes
     bounds of what each function needs (each row's id, own color and
     output; for an uncolored row its own words and, entry by entry, the
     index word and only the neighbour words whose condition holds, up to
     the entry that decides the row: bucket_bytes); color_components'
     library time is one scatter_reduce_ (amin) over the friend edge list
     a step, on the same two states. Each kernels-line entry takes its
     launches from the run whose states it times.

The line before the last is a JSON object describing every kernel; the last
is {"ok": true, "device": {...}}. Imports nothing of jax or gms_tpu.
"""

from __future__ import annotations

import contextlib
import hashlib
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
# Results per clock per SM at compute capability 9.0 (CUDA C++ Programming
# Guide, arithmetic instructions throughput table): __popc, the rate of an
# AND+popcount word operation, and 32-bit bitwise AND/OR/XOR
POPC_PER_CLOCK_PER_SM = 16
BITWISE_PER_CLOCK_PER_SM = 64
KERNEL_REPS, PLAIN_REPS, STEADY_TRIALS = 10, 3, 20
# k-clique graphs of bench.py: (RMAT scale, k, golden count of BENCH_r05)
KCLIQUE_RUNS = ((16, 5, 4_600_426_489), (13, 6, 681_595_966),
                (12, 8, 2_339_107_240))

# the kernels of the total triangle count (phase 3)
TC_PATH = ("count_tier_mat", "count_hub_groups_mat", "build_hub_rows",
           "count_dag_edges", "count_hub_groups")

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
    "symmetrize_bits": ("gms_tpu_torch/csrc/bk_symmetrize.cu",
                        "gms_tpu/algorithms/bron_kerbosch.py:406"),
    "hub_cover_bits": ("gms_tpu_torch/csrc/bk_cover.cu",
                       "gms_tpu/algorithms/bron_kerbosch.py:376"),
    "bk_stack_machine": ("gms_tpu_torch/csrc/bk_stack.cu",
                         "gms_tpu/algorithms/bron_kerbosch.py:550"),
    "decode_clique_members": ("gms_tpu_torch/csrc/bk_decode.cu",
                              "gms_tpu/algorithms/bron_kerbosch.py:832"),
    "build_local_univ": ("gms_tpu_torch/csrc/star_univ.cu",
                         "gms_tpu/algorithms/k_clique_star.py:54"),
    "star_stack": ("gms_tpu_torch/csrc/star_stack.cu",
                   "gms_tpu/algorithms/k_clique_star.py:137"),
    "decode_star_rows": ("gms_tpu_torch/csrc/star_decode.cu",
                         "gms_tpu/algorithms/k_clique_star.py:346"),
    "count_dag_edges_per_vertex": ("gms_tpu_torch/csrc/tier_intersect.cu",
                                   "gms_tpu/algorithms/triangle_count.py:129"),
    "count_hub_edges": ("gms_tpu_torch/csrc/bitmap_count.cu",
                        "gms_tpu/algorithms/triangle_count.py:184"),
    "bitmap_rows_count": ("gms_tpu_torch/csrc/bitmap_count.cu",
                          "gms_tpu/sets/bitmap_ops.py:22"),
    "adg_round": ("gms_tpu_torch/csrc/adg_round.cu",
                  "gms_tpu/preprocessing/degeneracy.py:178"),
    "pair_scores": ("gms_tpu_torch/csrc/pair_scores.cu",
                    "gms_tpu/algorithms/similarity.py:51"),
    "pair_scores_hub": ("gms_tpu_torch/csrc/pair_scores.cu",
                        "gms_tpu/algorithms/similarity.py:94"),
    "auc_count": ("gms_tpu_torch/csrc/auc_count.cu",
                  "gms_tpu/algorithms/link_prediction.py:208"),
    "tile_topq": ("gms_tpu_torch/csrc/tile_scores.cu",
                  "gms_tpu/algorithms/link_prediction.py:471"),
    "tile_all_pairs": ("gms_tpu_torch/csrc/tile_scores.cu",
                       "gms_tpu/algorithms/similarity.py:115"),
    "color_jp": ("gms_tpu_torch/csrc/color_jp.cu",
                 "gms_tpu/algorithms/coloring.py:106"),
    "color_spec": ("gms_tpu_torch/csrc/color_spec.cu",
                   "gms_tpu/algorithms/coloring.py:202"),
    "color_johansson": ("gms_tpu_torch/csrc/color_random.cu",
                        "gms_tpu/algorithms/coloring.py:127"),
    "color_one_shot": ("gms_tpu_torch/csrc/color_random.cu",
                       "gms_tpu/algorithms/coloring.py:404"),
    "color_components": ("gms_tpu_torch/csrc/color_components.cu",
                         "gms_tpu/algorithms/coloring.py:486"),
}
BK_GOLDEN = 165_402_717      # maximal cliques, RMAT-14 deg 16 (BENCH_r05)
BK_SCALE, BK_SMALL, BK_SAMPLE = 14, 12, 1000
# the plain K9 is held to the kernel on RMAT 14's W=128 job with the most
# cliques up to this many (the plain search takes minutes on the largest)
BK_PLAIN_CLIQUES = 1_000_000
# k-clique-stars at RMAT-12, k=4 (BENCH_extra.json): cliques, star total
STAR_SCALE, STAR_K, STAR_GOLDEN = 12, 4, (4_077_953, 136_080_055)
STAR_SAMPLE, STAR_SMALL = 1000, 10
# phases 23-28: per-vertex triangles at RMAT-18 (Σ = 3 x GOLDEN), dense
# bitmap triangles and bitmap_ops at RMAT-16, device ADG at RMAT-18 (the
# sampled boundaries verified at RMAT-14)
PV_SAMPLE, PV_TOP = 1000, 10
DENSE_SCALE, DENSE_BYTES = 16, 536_870_912
ADG_EPS, ADG_VERIFY_SCALE = (0.01, 0.1, 0.5), 14
ADG_MAIN = ("avg", 0.1)      # the device ADG run whose launches K17 reports
# phases 30-35: link prediction on RMAT-16 (bench.py's lp_auc round: test
# split seed 1, AUCPlan seed 2, Jaccard, 100,000 samples, run_steady(8));
# the (higher, equal) of run_steady's 8 timed trials, from shift 1, exact on
# any device (Jaccard scores are exact ratios, the sampling numpy)
LP_SCALE, LP_SAMPLES, LP_TRIALS = 16, 100_000, 8
LP_GOLDEN = ((81927, 6611), (81932, 6586), (81913, 6637), (81920, 6646),
             (81925, 6636), (81908, 6614), (81949, 6561), (81846, 6660))
LP_Q, LP_BLOCK = 100, 2048   # bench.py's top-q ranking call
LP_PAIRS, LP_ORACLE = 100_000, 1000
LP_COUNT_SCALE, LP_SMALL_SCALE, LP_SMALL_BLOCK = 14, 12, 512
LP_BENCH_METRICS = ("jaccard", "overlap", "adamic_adar", "resource",
                    "common_neighbors")
# phases 37-41: coloring on RMAT-16 (bench.py's coloring graph) and
# dense_sparse on RMAT-14 with friend_number 32; goldens (colors, digest:
# the first 16 hex digits of sha256 over the int32 colors) of gms_tpu on the
# CPU
COLOR_SCALE, COLOR_DS_SCALE, COLOR_DS_FRIENDS, COLOR_WARM = 16, 14, 32, 3
COLOR_GOLDEN = {
    "spec-lf": ({"speculative": True, "priority": "degree"}, 104,
                "c7b066c1de1c6f34"),
    "spec-random": ({"speculative": True}, 145, "373936d8668860a3"),
    "strict-lf": ({"priority": "degree"}, 82, "8c0f69ed106f236d"),
    "strict-random": ({"priority": "random"}, 111, "17b30d7e3092b7c3"),
}
COLOR_DS_GOLDEN = ((111, "17b30d7e3092b7c3"), (265, "dc688ce0f6f78322"))


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


def sm_rate(per_clock_per_sm: int) -> float:
    """Operations per second of card 0 at `per_clock_per_sm` results per
    clock per SM and its maximum SM clock."""
    mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return per_clock_per_sm * sms * mhz * 1e6


class Timing:
    """Median CUDA-event time of a call, with L2 flushed before each rep:
    on the main path every operand stream is far larger than the 50 MB L2,
    so each launch finds its inputs cold."""

    def __init__(self):
        self.flush = torch.empty(1 << 26, dtype=torch.int32, device="cuda")

    def ms(self, fn, reps: int, setup=None) -> float:
        """fn must have run once already (compare runs it to check it);
        setup(), untimed, runs before each rep."""
        times = []
        for _ in range(reps):
            if setup is not None:
                setup()
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


def compare(timing, calls, *, ops_rate=None, plain_reps=PLAIN_REPS,
            err_fn=max_abs_err):
    """calls: [(label, kernel_fn, plain_fn, bytes[, ops])] of one kernel on
    one trial; prints one line per call. Both functions run once for the
    comparison (err_fn of their outputs), which warms them up for the
    timing.

    Returns (max_abs_err, kernel_ms, plain_ms, bound_ms, bound_by), each
    summed (the error maximised) over the calls. A call's bound is the larger
    of its bytes (the least it must move, see data_words) over 3.35 TB/s and
    its word operations over `ops_rate`; bound_by names the larger sum."""
    err, k_ms, p_ms, bound, by_ops, by_bytes = 0, 0.0, 0.0, 0.0, 0.0, 0.0
    for label, kernel, plain, nbytes, *ops in calls:
        got, want = kernel(), plain()
        diff = err_fn(got, want)
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


def kernel_entry(name, launches, err, k_ms, p_ms, bound_ms, by,
                 library_ms=None) -> dict:
    """One kernel's entry of the kernels line. library_ms is the time of the
    one PyTorch call that computes the same function, where there is one
    (K21's common counts are a float32 matmul); no single call computes the
    others."""
    source, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": library_ms}


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
    rate = sm_rate(POPC_PER_CLOCK_PER_SM)
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


def bk_tiers(plan) -> str:
    """'W: jobs / real roots, IN lo-hi' of each tier width of a BK plan."""
    out = {}
    pad = plan.padded.v_pad
    for chunk, ww, in_w in plan.jobs:
        j, r, lo, hi = out.get(32 * ww, (0, 0, in_w, in_w))
        out[32 * ww] = (j + 1, r + int((chunk != pad).sum()), min(lo, in_w),
                        max(hi, in_w))
    return " · ".join(f"{w}: {j} / {r}, IN {lo}-{hi}"
                      for w, (j, r, lo, hi) in sorted(out.items()))


def cover_bytes(plan, chunk, ww, in_w) -> int:
    """K8's bytes: each distinct DAG row it reads (the roots' and their
    lower neighbours'), up to and including its first SENTINEL, the roots,
    their CSR entries, and M and wvalid written."""
    from gms_tpu_torch.algorithms import bron_kerbosch as bk
    wl = bk.gather_wlists(plan.lo_indptr, plan.lo_cols, chunk, in_width=in_w)
    v_pad = plan.padded.v_pad
    rows = torch.cat([chunk.long().clamp(0, v_pad - 1),
                      wl[wl != bk._SENT].long()])
    words = data_words(plan.padded.deg, torch.unique(rows),
                       plan.padded.d_pad)
    c = chunk.numel()
    return ((words + 3 * c + int((wl != bk._SENT).sum())
             + c * in_w * ww) * 4 + c * in_w)


def decode_bytes(plan, chunk, out) -> int:
    """K10's bytes: the rows read, gid and members written, and each distinct
    root row up to its first SENTINEL (at most W slots)."""
    ww = out.shape[1] - 1
    gid = chunk[out[:, ww].long().clamp(0, chunk.numel() - 1)]
    words = data_words(plan.padded.deg, torch.unique(gid), 32 * ww)
    return (out.numel() + out.shape[0] * (1 + 32 * ww) + words) * 4


def sorted_rows(out):
    """The rows of out in lexicographic order, sorted on its device: one
    stable sort per column, the last column first."""
    idx = torch.arange(out.shape[0], device=out.device)
    for c in reversed(range(out.shape[1])):
        idx = idx[torch.sort(out[idx, c], stable=True).indices]
    return out[idx]


def rows_err(got, want) -> int:
    """max_abs_err of two sets of rows (2^31 if their shapes differ)."""
    a, b = sorted_rows(got), sorted_rows(want)
    if a.shape != b.shape:
        return 1 << 31
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def search_compare(timing, label, kernel, plain, nbytes, rates):
    """Holds a search kernel (K9, K12) against one plain run on a job: its
    count and its emitted rows as sorted sets; prints a line. kernel(emit)
    returns the count, or (count, rows) with emit; plain(emit, stats) the
    same, and with stats it counts the tree's word operations by type,
    whose bound is the larger of the popcounts over `rates[0]` and the
    bitwise operations over `rates[1]` (different units). Returns
    (max_abs_err, kernel ms, emit ms, plain ms, bytes bound ms, operations
    bound ms, popcounts, bitwise operations)."""
    stats = {}
    want, want_out = plain(True, stats)
    got = kernel(False)
    n, out = kernel(True)
    diff = max(max_abs_err(got, want), max_abs_err(n, want),
               rows_err(out, want_out))
    kt = timing.ms(lambda: kernel(False), KERNEL_REPS)
    et = timing.ms(lambda: kernel(True), KERNEL_REPS)
    pt = timing.ms(lambda: plain(False, None), 1)
    bt = nbytes / HBM_BYTES_PER_S * 1e3
    ot = max(stats["popc_ops"] / rates[0], stats["bit_ops"] / rates[1]) * 1e3
    print(f"    {label}: count {want.tolist()}, max_abs_err {diff}, kernel "
          f"{kt:.4f} ms (emit {et:.4f} ms), bound {max(bt, ot):.4f} ms "
          f"({nbytes} bytes -> {bt:.4f} ms; {stats['popc_ops']} popcounts, "
          f"{stats['bit_ops']} bitwise ops -> {ot:.4f} ms), plain "
          f"{pt:.4f} ms")
    return diff, kt, et, pt, bt, ot, stats["popc_ops"], stats["bit_ops"]


def search_summary(results):
    """search_compare's results summed over jobs: (max_abs_err, kernel ms,
    emit ms, plain ms, popcounts, bitwise operations, bound ms, bound_by);
    each job's bound is the larger of its byte and operation times."""
    err = max(r[0] for r in results)
    k_ms, e_ms, p_ms, popc, bit = (sum(r[i] for r in results)
                                   for i in (1, 2, 3, 6, 7))
    bound = sum(max(r[4], r[5]) for r in results)
    by = ("operations" if sum(r[5] for r in results) >
          sum(r[4] for r in results) else "bytes")
    return err, k_ms, e_ms, p_ms, popc, bit, bound, by


def bk_compare(timing, label, univ, rates):
    """search_compare for K9 on a job's universe (adj, S0, live0, M,
    wvalid)."""
    from gms_tpu_torch.algorithms import bron_kerbosch as bk
    return search_compare(
        timing, label, lambda emit: bk.bk_stack_machine(*univ, emit=emit),
        lambda emit, stats: bk.bk_stack_machine_plain(*univ, emit=emit,
                                                      stats=stats),
        sum(t.numel() * t.element_size() for t in univ) + 8, rates)


def bk_jobs(plan):
    """[(label, chunk, ww, in_w, cover kwargs)] of a BK plan's jobs."""
    return [(f"W={32 * ww} IN={in_w} C={chunk.numel()}", chunk, ww, in_w,
             dict(in_width=in_w, w_words=ww)) for chunk, ww, in_w in plan.jobs]


def bk_calls(bk, plan, label, chunk, ww, in_w, cover, calls):
    """Appends a job's K7 and K8 calls to `calls`; returns its K9 universe
    (adj symmetrized, S0, live0, M, wvalid) and its K4 adj."""
    from gms_tpu_torch.algorithms import k_clique as kc
    nbr = plan.padded.nbr
    adj, s0 = kc.build_local_adj(nbr, chunk, w_words=ww)
    calls["symmetrize_bits"].append((
        label, lambda: bk.symmetrize_bits(adj),
        lambda: bk.symmetrize_bits_plain(adj), adj.numel() * 8))
    calls["hub_cover_bits"].append((
        label, lambda: bk.hub_cover_bits(nbr, plan.lo_indptr, plan.lo_cols,
                                         chunk, **cover),
        lambda: bk.hub_cover_bits_plain(nbr, plan.lo_indptr, plan.lo_cols,
                                        chunk, **cover),
        cover_bytes(plan, chunk, ww, in_w)))
    m, wv = bk.hub_cover_bits(nbr, plan.lo_indptr, plan.lo_cols, chunk,
                              **cover)
    return (bk.symmetrize_bits(adj), s0, chunk != nbr.shape[0], m, wv), adj


def bk_phases(timing, report) -> None:
    """Phases 12-16: the Bron-Kerbosch path (see the module docstring)."""
    from gms_tpu_torch.algorithms import bron_kerbosch as bk
    from gms_tpu_torch.algorithms import k_clique as kc
    from gms_tpu_torch.io.builder import build_csr
    from gms_tpu_torch.io.generators import generate_rmat_el
    from gms_tpu_torch.preprocessing import degeneracy

    def launches():
        return dict(bk.LAUNCHES,
                    build_local_adj=kc.LAUNCHES["build_local_adj"])

    t0 = time.perf_counter()
    g = build_csr(generate_rmat_el(BK_SCALE, DEGREE, seed=SEED),
                  num_nodes=1 << BK_SCALE)
    print(f"[12] graph RMAT {BK_SCALE}: {g.num_nodes} nodes, "
          f"{g.num_edges_undirected} undirected edges, "
          f"{int((g.degrees == 0).sum())} isolated, "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    rank, degen = degeneracy.degeneracy_ordering_rank(g)
    peel_s = time.perf_counter() - t0

    # [12] main path, counters from 0 (K4 is k_clique's build_local_adj)
    bk.reset_launches()
    kc.reset_launches()
    t0 = time.perf_counter()
    count = bk.bron_kerbosch(g, device="cuda", rank=rank)
    call_s = time.perf_counter() - t0
    main = launches()
    roots = np.arange(g.num_nodes, dtype=np.int32)
    t0 = time.perf_counter()
    plan = bk.BKPlan(g, rank, roots, device="cuda")
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    print(f"[12] RMAT {BK_SCALE} maximal cliques: count {count}, golden "
          f"{BK_GOLDEN}; degeneracy {degen}; peel {peel_s:.3f} s; call "
          f"{call_s:.4f} s (synchronised; host plan alone {plan_s:.4f} s: "
          f"orient, pad, lower CSR, sub-chunks, copies); "
          f"{count / call_s:.1f} cliques/s; launches {main}")
    print(f"    D_pad {plan.padded.d_pad}, max in-degree "
          f"{int(plan.indeg.max())}; tiers (W: jobs / real roots, IN) "
          f"{bk_tiers(plan)}")
    check(count == BK_GOLDEN, f"RMAT {BK_SCALE} BK: {count} != {BK_GOLDEN}")
    count_path = ("build_local_adj", "symmetrize_bits", "hub_cover_bits",
                  "bk_stack_machine")
    check(all(main[n] > 0 for n in count_path),
          f"a kernel of the BK count path never launched: {main}")
    del plan

    # [13] the ADG ordering gives the same count
    t0 = time.perf_counter()
    adg = degeneracy.adg_ordering_rank(g, 0.1)
    adg_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    count = bk.bron_kerbosch(g, device="cuda", rank=adg)
    call_s = time.perf_counter() - t0
    plan = bk.BKPlan(g, adg, roots, device="cuda")
    print(f"[13] RMAT {BK_SCALE} ADG eps 0.1: count {count}; ADG {adg_s:.3f} "
          f"s; call {call_s:.4f} s; {count / call_s:.1f} cliques/s; max "
          f"out-degree {int(plan.dag_deg.max())}; tiers {bk_tiers(plan)}")
    check(count == BK_GOLDEN, f"ADG-ordered RMAT {BK_SCALE}: {count} != "
                              f"{BK_GOLDEN}")
    del plan

    # [14] enumerate mode, counters from 0 just before its sink= run
    small = build_csr(generate_rmat_el(BK_SMALL, DEGREE, seed=SEED),
                      num_nodes=1 << BK_SMALL)
    srank, _ = degeneracy.degeneracy_ordering_rank(small)
    want = bk.bron_kerbosch(small, device="cuda", rank=srank)
    chunks = []
    bk.reset_launches()
    kc.reset_launches()
    t0 = time.perf_counter()
    n_emit, none = bk.bron_kerbosch(small, device="cuda", rank=srank,
                                    collect=True,
                                    sink=lambda g_, m_: chunks.append((g_, m_)))
    emit_s = time.perf_counter() - t0
    enum = launches()
    rows = sum(len(c[0]) for c in chunks)
    check(none is None and n_emit == want == rows,
          f"RMAT {BK_SMALL} sink: {rows} rows, count {n_emit} != {want}")
    check(all(n > 0 for n in enum.values()),
          f"a kernel of the BK enumerate path never launched: {enum}")
    nbrs = [set(small.out_neigh(v).tolist()) for v in range(small.num_nodes)]
    ends = np.cumsum([len(c[0]) for c in chunks])
    sample = np.random.default_rng(SEED).choice(rows, BK_SAMPLE,
                                                replace=False)
    for l in sample:
        j = int(np.searchsorted(ends, l, side="right"))
        gid, members = chunks[j]
        r = l - (ends[j - 1] if j else 0)
        clique = [int(gid[r]), *members[r][members[r] >= 0].tolist()]
        common = set.intersection(*(nbrs[v] for v in clique))
        check(all(b in nbrs[a] for i, a in enumerate(clique)
                  for b in clique[i + 1:]) and not common - set(clique),
              f"RMAT {BK_SMALL} row {l} is not a maximal clique: {clique}")
    tiny = build_csr(generate_rmat_el(8, DEGREE, seed=SEED), num_nodes=256)
    oracle = set(bk.bron_kerbosch_simple(tiny))
    n_tiny, cl = bk.bron_kerbosch(tiny, device="cuda", collect=True)
    check(n_tiny == len(oracle) and set(cl) == oracle,
          f"RMAT 8 collect: {n_tiny} cliques, oracle {len(oracle)}")
    print(f"[14] RMAT {BK_SMALL}: {n_emit} maximal cliques streamed to the "
          f"sink in {len(chunks)} jobs, {emit_s:.4f} s, launches {enum} "
          f"(bk_stack_machine: a count and an emit pass a job with rows); "
          f"{BK_SAMPLE} sampled rows are maximal cliques; RMAT 8 collect "
          f"equals bron_kerbosch_simple ({n_tiny})")

    # [15] the RMAT 14 call, job by job; K7 and K8 against their plain
    # versions on every job, K9 on the jobs with IN >= 2048 and on one W=128
    # job
    rates = (sm_rate(POPC_PER_CLOCK_PER_SM), sm_rate(BITWISE_PER_CLOCK_PER_SM))
    plan = bk.BKPlan(g, rank, roots, device="cuda")
    nbr = plan.padded.nbr
    calls = {"symmetrize_bits": [], "hub_cover_bits": []}
    k4_ms = k9_ms = 0.0
    k4_bytes = k9_bytes = total = 0
    jobs = []
    for label, chunk, ww, in_w, cover in bk_jobs(plan):
        univ, adj = bk_calls(bk, plan, label, chunk, ww, in_w, cover, calls)
        n = int(bk.bk_stack_machine(*univ))
        total += n
        k4_ms += timing.ms(lambda c=chunk, w=ww: (
            kc.build_local_adj(nbr, c, w_words=w)), 3)
        t9 = timing.ms(lambda u=univ: bk.bk_stack_machine(*u), 3)
        k9_ms += t9
        k4_bytes += local_adj_bytes(plan.padded, chunk, ww)
        k9_bytes += sum(t.numel() * t.element_size() for t in univ) + 8
        jobs.append((f"RMAT {BK_SCALE} {label}", ww, in_w, n, univ))
        if t9 > 10:
            print(f"    W={32 * ww} IN={in_w} real roots "
                  f"{int((chunk != nbr.shape[0]).sum())}: {n} cliques, "
                  f"bk_stack_machine {t9:.4f} ms")
    check(total == BK_GOLDEN, f"RMAT {BK_SCALE} job by job: {total}")
    entries = {}
    for name, kcalls in calls.items():
        entries[name] = compare(timing, kcalls, plain_reps=1)
        err, k_ms, p_ms, bound_ms, by = entries[name]
        print(f"[15] {name}: {len(kcalls)} jobs, max_abs_err {err}, kernel "
              f"{k_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}), plain "
              f"{p_ms:.4f} ms")
        check(err == 0, f"{name} disagrees with its plain version by {err}")
    w128 = [j for j in jobs if j[1] == 4 and 0 < j[3] <= BK_PLAIN_CLIQUES]
    check(bool(w128), f"RMAT {BK_SCALE} has no W=128 job the plain K9 takes")
    held = [j for j in jobs if j[2] >= 2048] + [max(w128, key=lambda j: j[3])]
    stack = [bk_compare(timing, label, univ, rates)
             for label, _, _, _, univ in held]
    print(f"[15] RMAT {BK_SCALE}, {len(jobs)} jobs, kernel ms summed "
          f"against bytes over 3.35 TB/s: build_local_adj {k4_ms:.4f} ms "
          f"(median of 3) vs {k4_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms; "
          + "; ".join(f"{n} {entries[n][1]:.4f} ms vs {entries[n][3]:.4f} ms"
                      for n in calls)
          + f"; bk_stack_machine {k9_ms:.4f} ms (median of 3) vs "
          f"{k9_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms; bk_stack_machine held "
          f"against its plain version on {len(held)} jobs (IN >= 2048, and "
          f"the W=128 job with the most cliques up to {BK_PLAIN_CLIQUES}), "
          f"max_abs_err {max(r[0] for r in stack)}")
    check(all(r[0] == 0 for r in stack),
          "bk_stack_machine disagrees with its plain version at RMAT "
          f"{BK_SCALE}")
    del plan, g, jobs, calls, held

    # [16] each kernel against its plain version, exactly, on RMAT 12
    plan = bk.BKPlan(small, srank, np.arange(small.num_nodes,
                                               dtype=np.int32), device="cuda")
    nbr = plan.padded.nbr
    print(f"[16] RMAT {BK_SMALL} plan: tiers {bk_tiers(plan)}")
    calls = {"symmetrize_bits": [], "hub_cover_bits": []}
    decode = []
    for label, chunk, ww, in_w, cover in bk_jobs(plan):
        univ, _ = bk_calls(bk, plan, label, chunk, ww, in_w, cover, calls)
        stack.append(bk_compare(timing, f"RMAT {BK_SMALL} {label}", univ,
                                   rates))
        _, out = bk.bk_stack_machine(*univ, emit=True)
        if not out.shape[0]:  # bron_kerbosch decodes only rows it has
            continue
        decode.append((
            f"{label} L={out.shape[0]}",
            lambda c=chunk, o=out: bk.decode_clique_members(nbr, c, o),
            lambda c=chunk, o=out: bk.decode_clique_members_plain(nbr, c, o),
            decode_bytes(plan, chunk, out)))
    # K7, K8: the main path's times (RMAT 14) and the larger error of both
    for name, kcalls in calls.items():
        err, k_ms, p_ms, bound_ms, by = compare(timing, kcalls)
        print(f"[16] {name}: {len(kcalls)} launches, max_abs_err {err}, "
              f"kernel {k_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}), "
              f"plain {p_ms:.4f} ms")
        check(err == 0, f"{name} disagrees with its plain version by {err}")
        main_err, *rest = entries[name]
        report.append(kernel_entry(name, main[name], max(err, main_err),
                                   *rest))
    # K9: summed over every job it was held against its plain version on
    err, k_ms, e_ms, p_ms, popc, bit, bound, by = search_summary(stack)
    print(f"[16] bk_stack_machine: {len(stack)} jobs held against the plain "
          f"version ({len(stack) - len(plan.jobs)} of RMAT {BK_SCALE}, "
          f"every job of RMAT {BK_SMALL}), max_abs_err {err} (count and "
          f"emitted rows), kernel {k_ms:.4f} ms (emit {e_ms:.4f} ms), bound "
          f"{bound:.4f} ms ({by}; {popc} popcounts, {bit} bitwise ops), "
          f"plain {p_ms:.4f} ms")
    check(err == 0, f"bk_stack_machine disagrees with its plain version by "
                    f"{err}")
    report.append(kernel_entry("bk_stack_machine", main["bk_stack_machine"],
                               err, k_ms, p_ms, bound, by))
    # K10: its path is enumerate mode's (RMAT 12)
    err, k_ms, p_ms, bound_ms, by = compare(timing, decode)
    print(f"[16] decode_clique_members: {len(decode)} launches, max_abs_err "
          f"{err}, kernel {k_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}), "
          f"plain {p_ms:.4f} ms")
    check(err == 0, f"decode_clique_members disagrees by {err}")
    report.append(kernel_entry("decode_clique_members",
                               enum["decode_clique_members"], err, k_ms,
                               p_ms, bound_ms, by))


def star_jobs_line(jobs, pad_id) -> str:
    """'W: slots / real roots' of each job of a k-clique-star plan."""
    return " · ".join(f"{32 * ww}: {c.numel()} / {int((c != pad_id).sum())}"
                      for c, ww in jobs)


def univ_bytes(pg, chunk, ww) -> int:
    """K11's bytes: each distinct row it reads (the roots' and their
    neighbours'), up to and including its first SENTINEL, the roots, the
    ranks of the roots and their slots, and the two matrices and two sets
    written."""
    from gms_tpu_torch.graphs.tiles import SENTINEL
    nbr, v_pad = pg.nbr, pg.v_pad
    roots = chunk.long().clamp(0, v_pad - 1)
    r_nbr = nbr[roots, :min(32 * ww, nbr.shape[1])]
    slots = r_nbr[r_nbr != SENTINEL].long()
    words = data_words(pg.deg, torch.unique(torch.cat([roots, slots])),
                       nbr.shape[1])
    ranks = torch.unique(torch.cat([chunk.long().clamp(0, v_pad), slots]))
    c = chunk.numel()
    return (words + c + ranks.numel() + 2 * c * 32 * ww * ww
            + 2 * c * ww) * 4


def star_stack_bytes(adj_full, adj_dag, s0, i0, live0, k) -> int:
    """K12's bytes in count mode: live0, the live roots' S0 and I0, the
    adj_full and adj_dag rows of each slot in S0 of the roots it searches
    (|S0| >= k-1; every node's S lies in S0, so no other row is read), and
    the two int64 totals written."""
    from gms_tpu_torch.algorithms.triangle_count import popcount32
    ww = s0.shape[1]
    size = popcount32(s0).sum(1)
    searched = live0 & (size >= k - 1)
    return (live0.numel() + 16 + 4 * 2 * ww * (int(live0.sum())
                                               + int(size[searched].sum())))


def star_decode_bytes(pg, chunk, out) -> int:
    """K13's bytes: the rows read, gid and both id blocks written, and each
    distinct root row up to its first SENTINEL (at most W slots)."""
    ww = (out.shape[1] - 1) // 2
    gid = chunk[out[:, 2 * ww].long().clamp(0, chunk.numel() - 1)]
    words = data_words(pg.deg, torch.unique(gid), 32 * ww)
    return (out.numel() + out.shape[0] * (1 + 64 * ww) + words) * 4


def star_phases(timing, report) -> None:
    """Phases 17-22: the k-clique-star path (see the module docstring)."""
    from gms_tpu_torch.algorithms import k_clique as kc
    from gms_tpu_torch.algorithms import k_clique_star as ks
    from gms_tpu_torch.algorithms.triangle_count import popcount32
    from gms_tpu_torch.io.builder import build_csr
    from gms_tpu_torch.io.generators import generate_rmat_el
    from gms_tpu_torch.preprocessing import degeneracy

    k = STAR_K
    t0 = time.perf_counter()
    g = build_csr(generate_rmat_el(STAR_SCALE, DEGREE, seed=SEED),
                  num_nodes=1 << STAR_SCALE)
    print(f"[17] graph RMAT {STAR_SCALE}: {g.num_nodes} nodes, "
          f"{g.num_edges_undirected} undirected edges, max degree "
          f"{g.max_degree}, {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    rank, degen = degeneracy.degeneracy_ordering_rank(g)
    peel_s = time.perf_counter() - t0

    # [17] main path: a first call (it loads the star kernels' modules and
    # sets their launch attributes), then the counters from 0 and the timed
    # call
    t0 = time.perf_counter()
    ks.kclique_star_list(g, k, device="cuda", rank=rank, mode="count")
    cold_s = time.perf_counter() - t0
    ks.reset_launches()
    t0 = time.perf_counter()
    got = ks.kclique_star_list(g, k, device="cuda", rank=rank, mode="count")
    call_s = time.perf_counter() - t0
    main = dict(ks.LAUNCHES)
    t0 = time.perf_counter()
    pg, rank_pad, jobs = ks.plan_star_jobs(g, k, device="cuda", rank=rank)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    print(f"[17] RMAT {STAR_SCALE} k={k} stars: (cliques, star total) {got}, "
          f"golden {STAR_GOLDEN}; degeneracy {degen}; peel {peel_s:.3f} s; "
          f"call {call_s:.4f} s (synchronised, warm; the first call "
          f"{cold_s:.4f} s; host plan alone {plan_s:.4f} s: pad, rank_pad, "
          f"tiers, sub-chunks, copies); {got[0] / call_s:.1f} cliques/s; "
          f"launches {main}")
    print(f"    D_pad {pg.d_pad}; {len(jobs)} jobs (W: slots / real roots) "
          f"{star_jobs_line(jobs, pg.v_pad)}")
    check(got == STAR_GOLDEN, f"RMAT {STAR_SCALE} k={k} stars: {got} != "
                              f"{STAR_GOLDEN}")
    check(main["build_local_univ"] > 0 and main["star_stack"] > 0,
          f"a kernel of the star count path never launched: {main}")

    # [18] the ADG ordering gives the same numbers
    t0 = time.perf_counter()
    adg = degeneracy.adg_ordering_rank(g, 0.1)
    adg_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = ks.kclique_star_list(g, k, device="cuda", rank=adg, mode="count")
    call_s = time.perf_counter() - t0
    print(f"[18] RMAT {STAR_SCALE} ADG eps 0.1: {got}; ADG {adg_s:.3f} s; "
          f"call {call_s:.4f} s; {got[0] / call_s:.1f} cliques/s")
    check(got == STAR_GOLDEN, f"ADG-ordered RMAT {STAR_SCALE} stars: {got}")

    # [19] star_total(k) = (k+1) · #K_{k+1}
    for kk in (3, 4):
        n, total = ks.kclique_star_list(g, kk, device="cuda", rank=rank,
                                        mode="count")
        nk = kc.kclique_count(g, kk, device="cuda", rank=rank)
        nk1 = kc.kclique_count(g, kk + 1, device="cuda", rank=rank)
        print(f"[19] k={kk}: {n} cliques (kclique_count {nk}), star total "
              f"{total} = {kk + 1} x {nk1}")
        check(n == nk and total == (kk + 1) * nk1,
              f"star identity fails at k={kk}: {n}, {total}; {nk}, {nk1}")

    # [20] emit mode job by job, counters from 0
    nbrs = [set(g.out_neigh(v).tolist()) for v in range(g.num_nodes)]
    sample = np.sort(np.random.default_rng(SEED).choice(
        STAR_GOLDEN[0], STAR_SAMPLE, replace=False))
    ks.reset_launches()
    rows = stars = 0
    picked = []
    t0 = time.perf_counter()
    for chunk, ww in jobs:
        _, out = ks.star_fused_chunk(pg.nbr, rank_pad, chunk, w_words=ww,
                                     k=k, emit=True)
        gid, members, star_ids = ks.decode_star_rows(pg.nbr, chunk, out)
        stars += int(popcount32(out[:, ww:2 * ww]).sum())
        mine = sample[(sample >= rows) & (sample < rows + out.shape[0])]
        idx = torch.from_numpy(mine - rows).cuda()
        picked += zip(gid[idx].tolist(), members[idx].tolist(),
                      star_ids[idx].tolist())
        rows += out.shape[0]
        del out, gid, members, star_ids
    torch.cuda.synchronize()
    emit_s = time.perf_counter() - t0
    enum = dict(ks.LAUNCHES)
    check((rows, stars) == STAR_GOLDEN,
          f"RMAT {STAR_SCALE} emit: {rows} rows, star popcounts {stars}")
    check(enum["decode_star_rows"] == len(jobs) and
          enum["build_local_univ"] == len(jobs),
          f"a star kernel of the emit path did not run on every job: {enum}")
    for gid, members, star_ids in picked:
        clique = [gid, *(m for m in members if m >= 0)]
        common = set.intersection(*(nbrs[v] for v in clique))
        check(all(b in nbrs[a] for i, a in enumerate(clique)
                  for b in clique[i + 1:])
              and {s for s in star_ids if s >= 0} == common - set(clique),
              f"RMAT {STAR_SCALE}: a sampled row is not a clique with its "
              f"star: {clique}")
    check(len(picked) == STAR_SAMPLE, f"sampled {len(picked)} rows")
    print(f"[20] RMAT {STAR_SCALE} emit: {rows} rows, star popcounts {stars} "
          f"in {len(jobs)} jobs, {emit_s:.4f} s (count pass, emit pass, "
          f"decode); launches {enum}; {STAR_SAMPLE} sampled rows are cliques "
          f"whose stars equal their common neighbourhoods")

    # [21] list mode against the oracle and the plain run
    for kk in (2, 3, 4):
        rg = np.triu(np.random.default_rng(kk).random((30, 30)) < 0.3, 1)
        rg = build_csr(np.stack(np.nonzero(rg), 1).astype(np.int64),
                       num_nodes=30)
        got = ks.kclique_star_list(rg, kk, device="cuda")
        want = ks.kclique_star_oracle(rg, kk)
        check(len(got) == len(want) and set(got) == set(want),
              f"random graph k={kk}: {len(got)} pairs, oracle {len(want)}")
    small = build_csr(generate_rmat_el(STAR_SMALL, DEGREE, seed=SEED),
                      num_nodes=1 << STAR_SMALL)
    got = ks.kclique_star_list(small, 3, device="cuda")
    t0 = time.perf_counter()
    want = ks.kclique_star_list(small, 3, device="cpu")
    cpu_s = time.perf_counter() - t0
    check(len(got) == len(want) and set(got) == set(want),
          f"RMAT {STAR_SMALL} k=3 list: {len(got)} pairs, plain {len(want)}")
    print(f"[21] random graphs k=2..4 equal the oracle; RMAT {STAR_SMALL} k=3 "
          f"list ({len(got)} pairs) equals the device='cpu' run "
          f"({cpu_s:.2f} s)")

    # [22] each kernel against its plain version, job by job
    rates = (sm_rate(POPC_PER_CLOCK_PER_SM), sm_rate(BITWISE_PER_CLOCK_PER_SM))
    nbr = pg.nbr
    univ_calls, decode_calls, stack = [], [], []
    for chunk, ww in jobs:
        label = f"W={32 * ww} C={chunk.numel()}"
        univ_calls.append((
            label,
            lambda c=chunk, w=ww: ks.build_local_univ(nbr, rank_pad, c,
                                                      w_words=w),
            lambda c=chunk, w=ww: ks.build_local_univ_plain(nbr, rank_pad, c,
                                                            w_words=w),
            univ_bytes(pg, chunk, ww)))
        univ = (*ks.build_local_univ(nbr, rank_pad, chunk, w_words=ww),
                chunk != pg.v_pad)
        stack.append(search_compare(
            timing, f"RMAT {STAR_SCALE} {label}",
            lambda emit, u=univ: ks.star_stack(*u, k=k, emit=emit),
            lambda emit, stats, u=univ: ks.star_stack_plain(
                *u, k=k, emit=emit, stats=stats),
            star_stack_bytes(*univ, k), rates))
        _, out = ks.star_stack(*univ, k=k, emit=True)
        decode_calls.append((
            f"{label} L={out.shape[0]}",
            lambda c=chunk, o=out: ks.decode_star_rows(nbr, c, o),
            lambda c=chunk, o=out: ks.decode_star_rows_plain(nbr, c, o),
            star_decode_bytes(pg, chunk, out)))
    for name, calls, launches in (("build_local_univ", univ_calls, main),
                                  ("decode_star_rows", decode_calls, enum)):
        err, k_ms, p_ms, bound_ms, by = compare(timing, calls, plain_reps=1)
        print(f"[22] {name}: {len(calls)} jobs, max_abs_err {err}, kernel "
              f"{k_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}), plain "
              f"{p_ms:.4f} ms")
        check(err == 0, f"{name} disagrees with its plain version by {err}")
        report.append(kernel_entry(name, launches[name], err, k_ms, p_ms,
                                   bound_ms, by))
        del calls[:]
    err, k_ms, e_ms, p_ms, popc, bit, bound, by = search_summary(stack)
    print(f"[22] star_stack: {len(stack)} of {len(jobs)} jobs held against the "
          f"plain version (count and emitted rows), max_abs_err {err}, "
          f"kernel {k_ms:.4f} ms (emit {e_ms:.4f} ms), bound {bound:.4f} ms "
          f"({by}; {popc} popcounts, {bit} bitwise ops), plain {p_ms:.4f} ms")
    check(err == 0, f"star_stack disagrees with its plain version by {err}")
    report.append(kernel_entry("star_stack", main["star_stack"], err, k_ms,
                               p_ms, bound, by))


def host_triangles_at(g, v) -> int:
    """Triangles at v, recounted on the host: Σ_{w∈N(v)} |N(v) ∩ N(w)| / 2."""
    nv = g.out_neigh(v)
    if not len(nv):
        return 0
    mark = np.zeros(g.num_nodes, dtype=bool)
    mark[nv] = True
    nn = np.concatenate([g.out_neigh(int(w)) for w in nv])
    return int(mark[nn].sum()) // 2


def distinct_bytes(*tensors) -> int:
    """Bytes of device memory the contiguous `tensors` cover together: views
    that overlap (phase 27's rows v and v+1) count once."""
    spans = sorted((t.data_ptr(), t.data_ptr() + t.numel() * t.element_size())
                   for t in tensors)
    total, end = 0, 0
    for lo, hi in spans:
        total += max(hi - max(lo, end), 0)
        end = max(end, hi)
    return total


def adg_bytes(g, alive, peel) -> int:
    """K17's bytes for one round: deg and alive read, peel and alive
    written, and for each vertex that stays alive (the pull walks it) its two
    indptr entries, its CSR row and its deg written."""
    walked = (alive & ~peel).cpu().numpy()
    row_words = int(g.degrees[walked].sum())
    n, w = g.num_nodes, int(walked.sum())
    return 8 * n + 3 * n + 16 * w + 4 * row_words + 8 * w


def vertex_phases(timing, report, g) -> None:
    """Phases 23-28: per-vertex and dense triangles, the device ADG and the
    bitmap counts (see the module docstring); g is phase 2's RMAT-18."""
    from gms_tpu_torch.algorithms import triangle_count as tc
    from gms_tpu_torch.graphs.bitmap import BitmapGraph
    from gms_tpu_torch.io.builder import build_csr
    from gms_tpu_torch.io.generators import generate_rmat_el
    from gms_tpu_torch.preprocessing import degeneracy, orient
    from gms_tpu_torch.sets import bitmap_ops as bo

    # [23] per-vertex main path, counters from 0
    t0 = time.perf_counter()
    pg, parts = tc.plan_per_vertex(g, device="cuda")
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    tc.reset_launches()
    t0 = time.perf_counter()
    pv = tc.triangle_count_per_vertex(g, device="cuda")
    call_s = time.perf_counter() - t0
    pv_launches = dict(tc.LAUNCHES)
    print(f"[23] RMAT {SCALE} per-vertex: Σ {int(pv.sum())} (3 x {GOLDEN} = "
          f"{3 * GOLDEN}); call {call_s:.4f} s (host clock to the read-back; "
          f"host plan alone {plan_s:.4f} s: orient, pad, 2-D tiers, copies); "
          f"max {int(pv.max())}; launches {pv_launches}")
    print(f"    D_pad {pg.d_pad}; {len(parts)} tiers (wa,wb): edges "
          + " · ".join(f"({wa},{wb}): {int(v.sum())}"
                       for wa, wb, _, _, v in parts))
    check(int(pv.sum()) == 3 * GOLDEN, f"per-vertex Σ {int(pv.sum())}")
    check(pv_launches["count_dag_edges_per_vertex"] == len(parts),
          f"K14 launched {pv_launches} for {len(parts)} tiers")
    top = np.argsort(-g.degrees, kind="stable")[:PV_TOP]
    rng = np.random.default_rng(SEED)
    sample = np.union1d(rng.choice(g.num_nodes, PV_SAMPLE, replace=False), top)
    t0 = time.perf_counter()
    bad = [int(v) for v in sample if pv[v] != host_triangles_at(g, int(v))]
    print(f"    {len(sample)} sampled vertices (the {PV_TOP} of highest "
          f"degree among them, {int(pv[top].sum())} triangle corners) equal "
          f"the host recount: {not bad} ({time.perf_counter() - t0:.2f} s)")
    check(not bad, f"per-vertex counts differ from the host at {bad[:10]}")

    # [24] the triangle-count ordering
    t0 = time.perf_counter()
    rank = degeneracy.triangle_count_ordering_rank(g, device="cuda")
    rank_s = time.perf_counter() - t0
    order = degeneracy.rank_to_order(rank)
    c = pv[order]
    check(np.array_equal(np.sort(rank), np.arange(g.num_nodes)),
          "the TC ordering is not a permutation")
    check(bool(np.all((np.diff(c) > 0) | ((np.diff(c) == 0)
                                          & (np.diff(order) > 0)))),
          "the TC ordering is not by (count, id)")
    print(f"[24] triangle_count_ordering_rank: a permutation by (count, id), "
          f"{rank_s:.4f} s")

    # [25] dense-bitmap triangles at RMAT 16, counters from 0
    g16 = build_csr(generate_rmat_el(DENSE_SCALE, DEGREE, seed=SEED),
                    num_nodes=1 << DENSE_SCALE)
    want = tc.TrianglePlan(g16, device="cuda").run()
    dag = orient.orient(g16, orient.degree_rank(g16))
    t0 = time.perf_counter()
    bg = BitmapGraph.from_csr(dag, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    tc.reset_launches()
    t0 = time.perf_counter()
    got = tc.triangle_count_dense(g16, device="cuda")
    dense_s = time.perf_counter() - t0
    dense_launches = dict(tc.LAUNCHES)
    nbytes = bg.words.numel() * 4
    print(f"[25] RMAT {DENSE_SCALE} dense: {got}, TrianglePlan {want}; bitmap "
          f"{tuple(bg.words.shape)} {nbytes} bytes, host build and copy "
          f"{build_s:.4f} s; call {dense_s:.4f} s (host clock, the bitmap "
          f"build included); {dag.num_edges} DAG edges; launches "
          f"{dense_launches}")
    check(got == want, f"dense count {got} != TrianglePlan's {want}")
    check(nbytes == DENSE_BYTES, f"bitmap bytes {nbytes}")
    check(dense_launches["count_hub_edges"] == 1,
          f"K15 launched {dense_launches}")

    # [26] the device ADG at RMAT 18, the counter set to 0 just before each
    # run; the main path's run is ADG_MAIN's
    for boundary in ("avg", "min"):
        for eps in ADG_EPS:
            degeneracy.reset_launches()
            t0 = time.perf_counter()
            r = degeneracy.adg_ordering_rank_device(g, eps, boundary,
                                                    device="cuda")
            dev_s = time.perf_counter() - t0
            rounds = degeneracy.LAUNCHES["adg_round"]
            if (boundary, eps) == ADG_MAIN:
                adg_launches = dict(degeneracy.LAUNCHES)
            t0 = time.perf_counter()
            h = degeneracy.adg_ordering_rank(g, eps, boundary)
            host_s = time.perf_counter() - t0
            print(f"[26] ADG {boundary} eps {eps}: {rounds} rounds, device "
                  f"{dev_s:.4f} s, host {host_s:.4f} s, equal "
                  f"{np.array_equal(r, h)}")
            check(np.array_equal(r, h),
                  f"device ADG {boundary} eps {eps} differs from the host's")
    g14 = build_csr(generate_rmat_el(ADG_VERIFY_SCALE, DEGREE, seed=SEED),
                    num_nodes=1 << ADG_VERIFY_SCALE)
    for boundary in ("prob_min", "prob_median"):
        degeneracy.reset_launches()
        t0 = time.perf_counter()
        r1 = degeneracy.adg_ordering_rank_device(g, 0.1, boundary, seed=SEED,
                                                 device="cuda")
        dev_s = time.perf_counter() - t0
        rounds = degeneracy.LAUNCHES["adg_round"]
        r2 = degeneracy.adg_ordering_rank_device(g, 0.1, boundary, seed=SEED,
                                                 device="cuda")
        r14 = degeneracy.adg_ordering_rank_device(g14, 0.1, boundary,
                                                  seed=SEED, device="cuda")
        ok = degeneracy.verify_approx_degeneracy_order(g14, r14, 0.1)
        print(f"[26] ADG {boundary} eps 0.1 seed {SEED}: {rounds} rounds, "
              f"device {dev_s:.4f} s; the same rank twice "
              f"{np.array_equal(r1, r2)}; a permutation "
              f"{np.array_equal(np.sort(r1), np.arange(g.num_nodes))}; RMAT "
              f"{ADG_VERIFY_SCALE} passes the verifier {ok}")
        check(np.array_equal(r1, r2) and ok and np.array_equal(
            np.sort(r1), np.arange(g.num_nodes)), f"device ADG {boundary}")
    print(f"[26] main path ({ADG_MAIN[0]} eps {ADG_MAIN[1]}) launches "
          f"{adg_launches}")
    check(adg_launches["adg_round"] > 0, f"K17 {adg_launches}")

    # [27] bitmap counts on RMAT 16's rows, row v against row v+1
    a, b = bg.words[:-1], bg.words[1:]
    bo.reset_launches()
    counts = {"card_a": bo.cardinality(a), "card_b": bo.cardinality(b),
              "and": bo.intersect_count(a, b), "or": bo.union_count(a, b),
              "andnot": bo.difference_count(a, b)}
    bm_launches = dict(bo.LAUNCHES)
    ca, cb, i, u, d = (counts[k].long() for k in counts)
    deg16 = torch.zeros(bg.v_pad, dtype=torch.int64, device="cuda")
    deg16[:dag.num_nodes] = torch.from_numpy(dag.degrees.astype(np.int64))
    deg16 = deg16[:-1]
    ok = (torch.equal(u, ca + cb - i) and torch.equal(d, ca - i)
          and torch.equal(ca, deg16) and bool((i <= torch.minimum(ca, cb)).all()))
    print(f"[27] bitmap_ops on {a.shape[0]} row pairs: Σ |A| {int(ca.sum())}, "
          f"Σ |A∩B| {int(i.sum())}, Σ |A∪B| {int(u.sum())}, Σ |A∖B| "
          f"{int(d.sum())}; |A∪B| = |A|+|B|-|A∩B|, |A∖B| = |A|-|A∩B|, |A| = "
          f"out-degree: {ok}; launches {bm_launches}")
    check(ok, "bitmap_ops counts break the set identities")
    check(bm_launches["bitmap_rows_count"] == 5, f"K16 {bm_launches}")

    # [28] each kernel against its plain version, exactly
    rate = sm_rate(POPC_PER_CLOCK_PER_SM)
    k14 = [(f"({wa},{wb}) E={e.shape[0]}",
            lambda e=e, v=v, wa=wa, wb=wb: tc.count_dag_edges_per_vertex(
                pg.nbr, e, v, num_segments=pg.v_pad, width_a=wa, width_b=wb),
            lambda e=e, v=v, wa=wa, wb=wb, c=c:
                tc.count_dag_edges_per_vertex_plain(
                    pg.nbr, e, v, num_segments=pg.v_pad, chunk=c,
                    width_a=wa, width_b=wb),
            (distinct_data_words(pg.deg, [(e[v > 0, 0], wa), (e[v > 0, 1], wb)])
             + e.numel() + v.numel() + 2 * pg.v_pad) * 4)
           for wa, wb, c, e, v in parts]
    edges, valid = tc._pad_edges(dag.edge_array(), 1024)
    edges, valid = torch.from_numpy(edges).cuda(), torch.from_numpy(valid).cuda()
    W = bg.w_pad
    used = torch.unique(edges[valid > 0].reshape(-1)).numel()
    k15 = [(f"RMAT {DENSE_SCALE} E={int(valid.sum())} W={W}",
            lambda: tc.count_hub_edges(bg.words, None, edges, valid,
                                       chunk=1024),
            lambda: tc.count_hub_edges_plain(bg.words, None, edges, valid,
                                             chunk=1024),
            (used * W + edges.numel() + valid.numel()) * 4 + 8,
            int(valid.sum()) * W)]
    k16 = [(f"{op} B={a.shape[0]} W={W}",
            lambda op=op: bo.rows_count(a, b, op=op),
            lambda op=op: bo.rows_count_plain(a, b, op=op),
            distinct_bytes(a, *([] if op == "card" else [b]))
            + a.shape[0] * 4, a.numel())
           for op in ("card", "and", "or", "andnot")]
    for name, calls, launches in (
            ("count_dag_edges_per_vertex", k14, pv_launches),
            ("count_hub_edges", k15, dense_launches),
            ("bitmap_rows_count", k16, bm_launches)):
        err, k_ms, p_ms, bound_ms, by = compare(timing, calls, ops_rate=rate,
                                                plain_reps=1)
        print(f"[28] {name}: {len(calls)} launches, max_abs_err {err}, kernel "
              f"{k_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}), plain "
              f"{p_ms:.4f} ms")
        check(err == 0, f"{name} disagrees with its plain version by {err}")
        report.append(kernel_entry(name, launches[name], err, k_ms, p_ms,
                                   bound_ms, by))
    del bg, a, b, edges, valid
    # K17 on every round state of the main path's run (ADG_MAIN), so that
    # its times and bound cover the launches it reports; each rep restores
    # the round's state first, untimed
    boundary, eps = ADG_MAIN
    indptr = torch.from_numpy(g.indptr).cuda()
    indices = torch.from_numpy(g.indices).cuda()
    deg = torch.from_numpy(g.degrees.astype(np.int64)).cuda()
    alive = torch.ones(g.num_nodes, dtype=torch.bool, device="cuda")
    err, k_ms, p_ms, bound_ms, rnd = 0, 0.0, 0.0, 0.0, 0
    while bool(alive.any()):
        deg0, alive0 = deg.clone(), alive.clone()
        pd, pa = deg0.clone(), alive0.clone()

        def restore(d0=deg0, a0=alive0):
            deg.copy_(d0)
            alive.copy_(a0)

        def kernel():
            return degeneracy.adg_round(indptr, indices, deg, alive,
                                        boundary=boundary, eps=eps)

        def plain(d0=deg0, a0=alive0, pd=pd, pa=pa):
            pd.copy_(d0)
            pa.copy_(a0)
            return degeneracy.adg_round_plain(indptr, indices, pd, pa,
                                              boundary=boundary, eps=eps)

        kt = timing.ms(kernel, KERNEL_REPS, setup=restore)
        pt = timing.ms(plain, PLAIN_REPS)
        want = plain()
        restore()
        peel = kernel()          # leaves the next round's state in deg, alive
        diff = max(max_abs_err(peel, want), max_abs_err(deg, pd),
                   max_abs_err(alive, pa))
        nbytes = adg_bytes(g, alive0, want)
        bt = nbytes / HBM_BYTES_PER_S * 1e3
        rnd += 1
        print(f"    adg_round {boundary} eps {eps} round {rnd} "
              f"({int(alive0.sum())} alive, {int(want.sum())} peel): "
              f"max_abs_err {diff}, kernel {kt:.4f} ms, bound {bt:.4f} ms "
              f"({nbytes} bytes), plain {pt:.4f} ms (its state copy "
              f"included)")
        err, k_ms, p_ms, bound_ms = (max(err, diff), k_ms + kt, p_ms + pt,
                                     bound_ms + bt)
    print(f"[28] adg_round: the {rnd} rounds of {boundary} eps {eps}, "
          f"max_abs_err {err}, kernel {k_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"(bytes), plain {p_ms:.4f} ms")
    check(rnd == adg_launches["adg_round"],
          f"{rnd} round states, {adg_launches} on the main path")
    check(err == 0, f"adg_round disagrees with its plain version by {err}")
    report.append(kernel_entry("adg_round", adg_launches["adg_round"], err,
                               k_ms, p_ms, bound_ms, "bytes"))


def score_err(got, want) -> float:
    """Largest |got - want| of two float score arrays, NaN equal to NaN (0)
    and inf to inf; a NaN or inf against anything else is inf."""
    got, want = got.double(), want.double()
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    diff = torch.where(same, 0.0, (got - want).abs())
    return float(torch.nan_to_num(diff, nan=math.inf).max()) if diff.numel() \
        else 0.0


def topq_err(got, want) -> float:
    """tile_topq outputs (scores, u, v): the scores' error, inf if the pairs
    differ."""
    if got[0].shape != want[0].shape or not (
            torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])):
        return math.inf
    return score_err(got[0], want[0])


def scores_close(got, want, metric) -> bool:
    """Kernel against plain: bit for bit for the count metrics, rtol 1e-5
    for AA/RA (float32 weights summed in another order)."""
    if metric not in ("adamic_adar", "resource"):
        return score_err(got, want) == 0.0
    return bool(torch.allclose(got, want, rtol=1e-5, atol=0.0,
                               equal_nan=True))


def keyed_isolated_topq(g, q: int, block: int):
    """gms_tpu's top-q rule where the top scores are ties: the best q of
    each u-block by (strip of v, u, v) among the pairs of isolated vertices
    (Jaccard 1.0; any other pair scores at most 1/3), then the first q of
    their union by (u, v)."""
    iso = np.nonzero(g.degrees == 0)[0]
    n = g.num_nodes
    block = min(block, -(-n // 128) * 128)
    n_pad = -(-n // block) * block
    picks = []
    for start in range(0, n, block):
        us = iso[(iso >= start) & (iso < start + block)]
        got = []
        for vb in range(start, n_pad, block):
            if len(got) >= q or not len(us):
                break
            vs_ = iso[(iso >= vb) & (iso < vb + block)]
            uu, vv = np.meshgrid(us, vs_, indexing="ij")
            keep = vv > uu
            got.extend(zip(uu[keep].tolist(), vv[keep].tolist()))
        picks.extend(got[:q])
    return sorted(picks)[:q]


def probed_words(nbr, deg, pairs, hub_idx, vw, n_words) -> int:
    """Distinct hub bitmap words K19 tests for `pairs` (each u-row element's
    word of v's bitmap)."""
    seen = torch.zeros(n_words, dtype=torch.bool, device=nbr.device)
    for s in range(0, pairs.shape[0], 4096):
        p = pairs[s:s + 4096].long()
        w = int(deg[p[:, 0]].max())
        rows = nbr[p[:, 0], :max(w, 1)].long()
        h = hub_idx[p[:, 1]].long()
        ok = rows != 0x7FFFFFFF
        widx = h[:, None] * vw + (rows.clamp(0, 32 * vw - 1) >> 5)
        seen[widx[ok]] = True
    return int(seen.sum())


def nonzero_word_pairs(u_words, v_words, upper: bool) -> int:
    """AND+popcounts a tile call's function needs: over the (u, v) pairs it
    scores, the word columns where both rows' words are non-zero (a zero
    word adds nothing to any metric). With upper, u_words are the first rows
    of v_words (a u-block and the strips from its diagonal) and only v > u
    counts."""
    zu = (u_words != 0).long()
    zv = v_words != 0
    col = zv.sum(0, dtype=torch.int64)
    if not upper:
        return int((zu.sum(0) * col).sum())
    after = col[None, :] - torch.cumsum(zv[:zu.shape[0]].long(), 0)
    return int((zu * after).sum())


def topq_calls(lp, bm, deg_p, n: int, metric: str, label: str):
    """compare() calls of tile_topq on every u-block of
    link_prediction_similarity(block=LP_BLOCK, q=LP_Q) over the whole-graph
    bitmap `bm`: the u-block's rows against the strips from its diagonal.
    Bytes: those strips' rows (the u-block's among them), their degrees and
    the q candidates; operations: nonzero_word_pairs."""
    calls = []
    for start in range(0, n, LP_BLOCK):
        u, v = bm[start:start + LP_BLOCK], bm[start:]
        nu = u.shape[0]
        pairs = nu * (n - start) - nu * (nu + 1) // 2
        kw = dict(u_base=start, v_base=start, n=n, block=LP_BLOCK, q=LP_Q,
                  metric=metric)
        calls.append((
            f"{label} u-block {start // LP_BLOCK} ({pairs} pairs; the dense "
            f"design does {pairs * bm.shape[1]} AND+popcounts)",
            lambda u=u, v=v, kw=kw: lp.tile_topq(u, v, deg_p, **kw),
            lambda u=u, v=v, kw=kw: lp.tile_topq_plain(u, v, deg_p, **kw),
            (v.numel() + (n - start)) * 4 + LP_Q * 12,
            nonzero_word_pairs(u, v, upper=True)))
    return calls


def weighted_topq_fault(g, edges, scores, plain_scores, metric):
    """AA and RA sum float32 weights in another order in the kernel than in
    the plain version, so their top-q may pick other pairs among near-ties.
    Holds each pair the kernels returned to what it must be: u < v < n, not
    an edge, scoring as pair_scores_plain on that pair within rtol 1e-5, and
    the q-th score not below plain's q-th by more than that. Returns the
    first fault, or None."""
    from gms_tpu_torch.algorithms import similarity as vs
    from gms_tpu_torch.graphs.tiles import PaddedGraph

    n = g.num_nodes
    if len(edges) != len(plain_scores):
        return f"{len(edges)} pairs, plain {len(plain_scores)}"
    u, v = edges[:, 0].astype(np.int64), edges[:, 1].astype(np.int64)
    if not ((u < v) & (v < n)).all():
        return "a pair outside u < v < n"
    und = g.undirected_edge_array().astype(np.int64)
    if np.isin(u * n + v, und[:, 0] * n + und[:, 1]).any():
        return "an edge among the pairs"
    pg = PaddedGraph.from_csr(g, device="cuda")
    want = vs.pair_scores_plain(pg.nbr, vs._deg_lookup(pg),
                                torch.from_numpy(edges).cuda(),
                                metric=metric).cpu().numpy()
    if not np.allclose(scores, want, rtol=1e-5, atol=0.0):
        return "a score differs from pair_scores_plain's"
    if len(scores) and scores[-1] < plain_scores[-1] * (1 - 1e-5):
        return f"q-th score {scores[-1]} < plain's {plain_scores[-1]}"
    return None


def lp_phases(timing, report) -> None:
    """Phases 30-35: link prediction and vertex similarity (see the module
    docstring)."""
    from gms_tpu_torch.algorithms import link_prediction as lp
    from gms_tpu_torch.algorithms import similarity as vs
    from gms_tpu_torch.graphs.tiles import PaddedGraph
    from gms_tpu_torch.io.builder import build_csr
    from gms_tpu_torch.io.generators import generate_rmat_el

    t0 = time.perf_counter()
    g = build_csr(generate_rmat_el(LP_SCALE, DEGREE, seed=SEED),
                  num_nodes=1 << LP_SCALE)
    m = g.num_edges_undirected
    train, test = lp.extract_random_test_edges(g, int(0.01 * m), seed=1)
    print(f"[30] graph RMAT {LP_SCALE}: {g.num_nodes} nodes, {m} undirected "
          f"edges, max degree {g.max_degree}; test split {test.num_edges_undirected}"
          f" edges (seed 1); {time.perf_counter() - t0:.2f} s")

    # [30] AUC main path, counters from 0
    vs.reset_launches()
    lp.reset_launches()
    t0 = time.perf_counter()
    plan = lp.AUCPlan(g, train, test, LP_SAMPLES, metric="jaccard", seed=2,
                      device="cuda")
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    warm_t0 = time.perf_counter()
    auc, trial_s = plan.run_steady(LP_TRIALS)
    steady_s = time.perf_counter() - warm_t0
    auc_launches = {"pair_scores": vs.LAUNCHES["pair_scores"],
                    "pair_scores_hub": vs.LAUNCHES["pair_scores_hub"],
                    "auc_count": lp.LAUNCHES["auc_count"]}
    got = [tuple(int(x) for x in row) for row in plan.steady_counts]
    pn, _ = plan._split.merge
    ph, _ = plan._split.hub
    print(f"[30] AUCPlan RMAT {LP_SCALE} Jaccard T={LP_SAMPLES}: host plan "
          f"{plan_s:.4f} s (sampling, tables, split, copies); "
          f"{pn.shape[0]} K18 pairs, {ph.shape[0]} K19 (hub) pairs; "
          f"run_steady({LP_TRIALS}): AUC {auc}, {trial_s * 1e3:.4f} ms a "
          f"trial (host clock to the read-back), both calls {steady_s:.4f} s")
    print(f"    (higher, equal) of the timed trials {got}")
    print(f"    launches {auc_launches}: {LP_TRIALS} in the timed call plus "
          f"{LP_TRIALS} in the first call from shift 0, each")
    check(got == [tuple(x) for x in LP_GOLDEN],
          f"AUC trials {got} != {LP_GOLDEN}")
    check(abs(auc - 0.85176) < 1e-12, f"AUC {auc} != 0.85176")
    check(all(v == 2 * LP_TRIALS for v in auc_launches.values()),
          f"AUC launches {auc_launches}")
    k0 = plan.counts(0, 1)
    p0 = plan._counts_with(0, 1, lp._score_into_plain, lp.auc_count_plain)
    print(f"    run(0): kernels {k0[0].tolist()}, plain {p0[0].tolist()}")
    check(np.array_equal(k0, p0), f"run(0) {k0} != plain {p0}")

    # [31] score_auc, gms_tpu/bench/link_prediction.py's protocol
    train0, test0 = lp.extract_random_test_edges(g, max(1, int(m * 0.01)),
                                                 seed=0)
    # score_auc's own pairs (seed 0), scored by the kernels and by plain
    auc_true, auc_false = lp._auc_pairs(g, test0, LP_SAMPLES, 0)

    def auc_counts(metric, score_into):
        tables = lp._train_tables(train0, "cuda")
        st = lp._pair_scores_np(tables, auc_true, metric, score_into)
        sf = lp._pair_scores_np(tables, auc_false, metric, score_into)
        return int(np.sum(st > sf)), int(np.sum(st == sf))

    for metric in LP_BENCH_METRICS:
        t0 = time.perf_counter()
        auc_k = lp.score_auc(g, train0, test0, LP_SAMPLES, metric=metric,
                             device="cuda")
        call_s = time.perf_counter() - t0
        hk = auc_counts(metric, lp._score_into)
        hp = auc_counts(metric, lp._score_into_plain)
        check((hk[0] + 0.5 * hk[1]) / LP_SAMPLES == auc_k,
              f"score_auc {metric} {auc_k} is not its pairs' count {hk}")
        auc_p = (hp[0] + 0.5 * hp[1]) / LP_SAMPLES
        print(f"[31] score_auc {metric}: {auc_k} ({call_s:.4f} s, host clock, "
              f"sampling included); (higher, equal) kernels {hk}, plain {hp}")
        check(0.0 <= auc_k <= 1.0, f"score_auc {metric} {auc_k}")
        if metric in ("adamic_adar", "resource"):
            check(abs(auc_k - auc_p) <= 1e-4, f"{metric} AUC {auc_k} vs "
                  f"plain {auc_p}")
        else:
            check(hk == hp, f"{metric} counts {hk} != plain {hp}")
    del train0, test0, auc_true, auc_false

    # [32] vertex_similarity, all seven metrics
    rng = np.random.default_rng(SEED)
    hubs = np.nonzero(g.degrees > lp.HUB_THRESHOLD)[0]
    pairs = np.concatenate([
        rng.integers(0, g.num_nodes, (LP_PAIRS, 2)),
        np.stack([rng.integers(0, g.num_nodes, LP_PAIRS),
                  rng.choice(hubs, LP_PAIRS)], axis=1)]).astype(np.int32)
    pg = PaddedGraph.from_csr(g, device="cuda")
    deg1 = vs._deg_lookup(pg)
    tp = torch.from_numpy(pairs).cuda()
    sample = rng.choice(len(pairs), LP_ORACLE, replace=False)
    for metric in vs.METRICS:
        t0 = time.perf_counter()
        got = vs.vertex_similarity(g, pairs, metric, device="cuda")
        call_s = time.perf_counter() - t0
        plain = vs.pair_scores_plain(pg.nbr, deg1, tp, metric=metric)
        want = vs.vertex_similarity_oracle(g, pairs[sample], metric)
        ok_plain = scores_close(torch.from_numpy(got).cuda(), plain, metric)
        ok_oracle = np.allclose(got[sample], want.astype(np.float32),
                                rtol=1e-5, atol=0.0, equal_nan=True)
        print(f"[32] vertex_similarity {metric}: {len(pairs)} pairs "
              f"({LP_PAIRS} with a hub end) in {call_s:.4f} s (host clock, "
              f"padded build included); = plain {ok_plain}; {LP_ORACLE} = "
              f"oracle {ok_oracle}")
        check(ok_plain and ok_oracle, f"vertex_similarity {metric}")
    del pg, deg1, tp

    # [33] top-q ranking, bench.py's call, counters from 0
    lp.reset_launches()
    t0 = time.perf_counter()
    edges, scores = lp.link_prediction_similarity(train, LP_Q,
                                                  metric="jaccard",
                                                  device="cuda")
    rank_s = time.perf_counter() - t0
    rank_launches = dict(lp.LAUNCHES)
    want = keyed_isolated_topq(train, LP_Q, LP_BLOCK)
    got = [tuple(int(x) for x in e) for e in edges]
    us = sorted({u for u, _ in got})
    print(f"[33] link_prediction_similarity RMAT {LP_SCALE} train, q {LP_Q}, "
          f"Jaccard: {rank_s:.4f} s (host clock, bitmap build and copy "
          f"included); launches {rank_launches}; {len(got)} pairs, u in {us},"
          f" first {got[:1]}, last {got[-1:]}; = keyed rule "
          f"{got == want}; scores all 1.0 {bool((scores == 1.0).all())}")
    check(got == want, "top-q pairs differ from the keyed rule")
    check(bool((scores == 1.0).all()), "top-q scores are not all 1.0")
    check(rank_launches["tile_topq"] == -(-train.num_nodes // LP_BLOCK),
          f"K21 launches {rank_launches}")

    # [34] top-q counting against the plain version on the card
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on; the plain top-q must count in float32")
    g14 = build_csr(generate_rmat_el(LP_COUNT_SCALE, DEGREE, seed=SEED),
                    num_nodes=1 << LP_COUNT_SCALE)
    for metric in ("common_neighbors", "adamic_adar"):
        t0 = time.perf_counter()
        e_k, s_k = lp.link_prediction_similarity(g14, LP_Q, metric=metric,
                                                 device="cuda")
        k_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        e_p, s_p = lp._link_prediction_similarity_plain(g14, LP_Q,
                                                        metric=metric,
                                                        device="cuda")
        p_s = time.perf_counter() - t0
        same = np.array_equal(e_k, e_p) and np.array_equal(s_k, s_p)
        fault = (None if metric not in vs.WEIGHTED
                 else weighted_topq_fault(g14, e_k, s_k, s_p, metric))
        print(f"[34] RMAT {LP_COUNT_SCALE} top-{LP_Q} {metric}: kernels "
              f"{k_s:.4f} s, plain {p_s:.4f} s; pairs and scores equal "
              f"{same}; each pair checked (AA, RA) {fault or 'ok'}; best "
              f"{s_k[:3]}")
        check(same if metric == "common_neighbors" else fault is None,
              f"RMAT {LP_COUNT_SCALE} top-q {metric} differs from plain: "
              f"{fault}")
    g12 = build_csr(generate_rmat_el(LP_SMALL_SCALE, DEGREE, seed=SEED),
                    num_nodes=1 << LP_SMALL_SCALE)
    for metric in vs.METRICS:
        e_k, s_k = lp.link_prediction_similarity(
            g12, LP_Q, metric=metric, block=LP_SMALL_BLOCK, device="cuda")
        e_p, s_p = lp._link_prediction_similarity_plain(
            g12, LP_Q, metric=metric, block=LP_SMALL_BLOCK, device="cuda")
        if metric in vs.WEIGHTED:
            fault = weighted_topq_fault(g12, e_k, s_k, s_p, metric)
        else:
            same = np.array_equal(e_k, e_p) and np.array_equal(s_k, s_p)
            fault = None if same else "pairs or scores differ"
        check(fault is None, f"RMAT {LP_SMALL_SCALE} top-q {metric} differs "
              f"from plain: {fault}")
    print(f"[34] RMAT {LP_SMALL_SCALE} block {LP_SMALL_BLOCK}: the seven "
          f"metrics' top-{LP_Q} equal the plain version's (AA, RA: each pair "
          f"a non-edge u < v < n scoring as pair_scores_plain within rtol "
          f"1e-5, the q-th score not below plain's)")
    n12 = g12.num_nodes
    adj = torch.zeros((n12, n12), dtype=torch.float32, device="cuda")
    e12 = torch.from_numpy(g12.edge_array()).cuda().long()
    adj[e12[:, 0], e12[:, 1]] = 1.0
    d12 = torch.from_numpy(g12.degrees).cuda()
    blk, dblk = adj[:LP_SMALL_BLOCK], d12[:LP_SMALL_BLOCK]
    vs.reset_launches()
    for metric in vs.METRICS:
        got = vs.all_pairs_scores(blk, dblk, adj, d12, metric=metric)
        want = vs.all_pairs_scores_plain(blk, dblk, adj, d12, metric=metric)
        check(scores_close(got, want, metric),
              f"all_pairs_scores {metric} differs from plain")
    ap_launches = dict(vs.LAUNCHES)
    print(f"[34] all_pairs_scores, RMAT {LP_SMALL_SCALE}'s first "
          f"{LP_SMALL_BLOCK} rows x {n12}: the seven metrics equal the plain "
          f"version's; launches {ap_launches}")
    check(ap_launches["tile_all_pairs"] == len(vs.METRICS),
          f"tile_all_pairs launches {ap_launches}")

    # [35] each kernel against its plain version, CUDA-event times
    rate = sm_rate(POPC_PER_CLOCK_PER_SM)
    pgt, deg1t, bm, hub_idx, vw = plan._tables
    dev_deg = pgt.deg
    B2 = 2 * LP_SAMPLES

    def pair_bytes(p, uses):
        """pairs, their deg1 entries, the rows `uses` reads, the output."""
        ends = torch.unique(p.reshape(-1)).numel()
        return (p.numel() + ends + distinct_data_words(dev_deg, uses)
                + p.shape[0]) * 4

    k18 = [(f"K18 Jaccard, {pn.shape[0]} of phase 30's pairs",
            lambda: vs.pair_scores(pgt.nbr, deg1t, pn, metric="jaccard"),
            lambda: vs.pair_scores_plain(pgt.nbr, deg1t, pn, metric="jaccard"),
            pair_bytes(pn, [(pn[:, 0], pgt.d_pad), (pn[:, 1], pgt.d_pad)]))]
    probed = probed_words(pgt.nbr, dev_deg, ph, hub_idx, vw, bm.shape[0])
    k19 = [(f"K19 Jaccard, {ph.shape[0]} hub pairs of phase 30",
            lambda: vs.pair_scores_hub(pgt.nbr, deg1t, bm, hub_idx, ph,
                                       metric="jaccard", vw=vw),
            lambda: vs.pair_scores_hub_plain(pgt.nbr, deg1t, bm, hub_idx, ph,
                                             metric="jaccard", vw=vw),
            pair_bytes(ph, [(ph[:, 0], pgt.d_pad)])
            + (probed + torch.unique(ph[:, 1]).numel()) * 4)]
    sc = plan._scores.clone()
    shift = torch.ones(1, dtype=torch.int32, device="cuda")
    cnt = torch.zeros(2, dtype=torch.int32, device="cuda")
    pshift, pcnt = shift.clone(), cnt.clone()

    def k20():
        shift.fill_(1)
        lp.auc_count(sc, shift, cnt)
        return torch.cat([cnt, shift])

    def k20_plain():
        pshift.fill_(1)
        lp.auc_count_plain(sc, pshift, pcnt)
        return torch.cat([pcnt, pshift])

    k20c = [(f"K20 on phase 30's {B2} scores, shift 1", k20, k20_plain,
             B2 * 4 + 4 + 8 + 4)]
    for name, calls, launches in (("pair_scores", k18, auc_launches),
                                  ("pair_scores_hub", k19, auc_launches),
                                  ("auc_count", k20c, auc_launches)):
        err, k_ms, p_ms, bound_ms, by = compare(timing, calls, ops_rate=rate,
                                                err_fn=score_err)
        print(f"[35] {name}: max_abs_err {err}, kernel {k_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({by}), plain {p_ms:.4f} ms")
        check(err == 0, f"{name} disagrees with its plain version by {err}")
        report.append(kernel_entry(name, launches[name], err, k_ms, p_ms,
                                   bound_ms, by))
    del plan, pgt, deg1t, bm, hub_idx, pn, ph, sc

    # K21 tile_topq on every u-block of phase 33's call (bench.py's ranking
    # call at RMAT-16), then of the whole RMAT-14 CN call
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    bm16 = torch.from_numpy(lp._host_bitmap(train, train.num_nodes)
                            .view(np.int32)).cuda()
    deg16 = torch.from_numpy(train.degrees).cuda()
    t16 = topq_calls(lp, bm16, deg16, train.num_nodes, "jaccard",
                     f"tile_topq RMAT {LP_SCALE} Jaccard")
    err, k_ms, p_ms, bound_ms, by = compare(timing, t16, ops_rate=rate,
                                            err_fn=topq_err)
    check(err == 0, f"tile_topq disagrees with its plain version by {err}")
    # the library call: torch.matmul of each u-block's common counts
    dense16 = vs.unpack_rows(bm16)
    lib_ms = 0.0
    for start in range(0, train.num_nodes, LP_BLOCK):
        u, v = dense16[start:start + LP_BLOCK], dense16[start:]
        lib_ms += timing.ms(lambda u=u, v=v: torch.matmul(u, v.T), PLAIN_REPS)
    print(f"[35] tile_topq, phase 33's RMAT {LP_SCALE} call ({len(t16)} "
          f"launches): max_abs_err {err}, kernel {k_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({by}), plain {p_ms:.4f} ms, torch.matmul of "
          f"its common counts (float32, TF32 off) {lib_ms:.4f} ms")
    check(len(t16) == rank_launches["tile_topq"],
          f"{len(t16)} u-blocks timed, {rank_launches} on the main path")
    report.append(kernel_entry("tile_topq", rank_launches["tile_topq"], err,
                               k_ms, p_ms, bound_ms, by, library_ms=lib_ms))
    del bm16, deg16, dense16, u, v
    bm14 = torch.from_numpy(lp._host_bitmap(g14, g14.num_nodes)
                            .view(np.int32)).cuda()
    deg14 = torch.from_numpy(g14.degrees).cuda()
    t14 = topq_calls(lp, bm14, deg14, g14.num_nodes, "common_neighbors",
                     f"tile_topq RMAT {LP_COUNT_SCALE} CN")
    err, k_ms, p_ms, bound_ms, by = compare(timing, t14, ops_rate=rate,
                                            err_fn=topq_err)
    print(f"[35] tile_topq, the whole RMAT {LP_COUNT_SCALE} CN call "
          f"({len(t14)} launches): max_abs_err {err}, kernel {k_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({by}), plain {p_ms:.4f} ms")
    check(err == 0, f"tile_topq RMAT {LP_COUNT_SCALE} disagrees by {err}")
    del bm14

    # tile_all_pairs on phase 34's block, Jaccard
    ub, va = vs.pack_rows(blk), vs.pack_rows(adj)
    tap = [(f"tile_all_pairs RMAT {LP_SMALL_SCALE} {LP_SMALL_BLOCK} x {n12} "
            f"Jaccard",
            lambda: vs.tile_all_pairs(ub, va, dblk, d12, metric="jaccard"),
            lambda: vs.all_pairs_scores_plain(blk, dblk, adj, d12,
                                              metric="jaccard"),
            (ub.numel() + va.numel() + LP_SMALL_BLOCK + n12
             + LP_SMALL_BLOCK * n12) * 4,
            nonzero_word_pairs(ub, va, upper=False))]
    err, k_ms, p_ms, bound_ms, by = compare(timing, tap, ops_rate=rate,
                                            err_fn=score_err)
    lib_ms = timing.ms(lambda: torch.matmul(blk, adj.T), KERNEL_REPS)
    print(f"    (the dense design does {LP_SMALL_BLOCK * n12 * ub.shape[1]} "
          f"AND+popcounts, one for every word of every pair)")
    print(f"[35] tile_all_pairs: max_abs_err {err}, kernel {k_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({by}), plain {p_ms:.4f} ms, torch.matmul"
          f" of its common counts {lib_ms:.4f} ms")
    check(err == 0, f"tile_all_pairs disagrees with its plain version by {err}")
    report.append(kernel_entry("tile_all_pairs", ap_launches["tile_all_pairs"],
                               err, k_ms, p_ms, bound_ms, by,
                               library_ms=lib_ms))


def color_digest(colors) -> str:
    return hashlib.sha256(np.ascontiguousarray(
        colors, dtype=np.int32).tobytes()).hexdigest()[:16]


class RoundStates:
    """Records a coloring run's round-start states: inside the `with` block
    the coloring module's round function `fn` (the entry points call it only
    while a vertex is uncolored) is wrapped to copy its inputs before each
    call. Keeps the first and the last."""

    def __init__(self, gc, fn: str):
        self.gc, self.fn = gc, fn
        self.first = self.last = None
        self.rounds = 0

    def __enter__(self):
        inner = self.inner = getattr(self.gc, self.fn)

        def record(*state, **kw):
            snap = tuple(x.clone() if isinstance(x, torch.Tensor) else x
                         for x in state) + (kw,)
            if self.first is None:
                self.first = snap
            self.last = snap
            self.rounds += 1
            return inner(*state, **kw)

        setattr(self.gc, self.fn, record)
        return self

    def __exit__(self, *exc):
        setattr(self.gc, self.fn, self.inner)

    def both(self):
        """[(label, state)] of the first and the last round."""
        k = self.rounds
        return [(f"round 1 of {k}", self.first),
                (f"round {k} of {k}", self.last)]


def nbr_take(state, nbrt):
    """state[w] for each entry w of nbrt, the SENTINEL slots clipped."""
    return state[nbrt.long().clamp(max=state.shape[0] - 1)]


def bucket_bytes(ids, nbrt, colors, own, entry, stop=None, live=None,
                 writes=4) -> int:
    """The bytes a bucket launch's function needs. Every row: its id, its
    own color and `writes` bytes of output (int, or int64[Vt] a row). Each
    live row (by default the uncolored ones) also `own` bytes (int or
    int64[Vt]) and, over its row in order, `entry` bytes an entry
    (int64[Vt, Dt]: the index word and the neighbour's state words the
    function needs there, 0 where their condition fails) up to and
    including the first entry where `stop` holds (the row's answer is known
    there), else to the end of the row and its SENTINEL where Dt has room."""
    from gms_tpu_torch.graphs.tiles import SENTINEL
    n = colors.shape[0] - 1
    idl = ids.long()
    if live is None:
        live = (colors[idl] == -1) & (idl < n)
    valid = nbrt != SENTINEL
    entry = torch.where(valid, entry, torch.zeros_like(entry))
    ended = torch.ones_like(live)
    if stop is not None:
        hit = (stop & valid).long()
        entry = torch.where(torch.cumsum(hit, 1) - hit == 0, entry,
                            torch.zeros_like(entry))
        ended = hit.sum(1) == 0
    term = 4 * (ended & (valid.sum(1) < nbrt.shape[1])).long()
    per_live = own + entry.sum(1) + term
    out = (writes * ids.numel() if isinstance(writes, int)
           else int(writes.sum()))
    return 8 * ids.numel() + out + int(per_live[live].sum())


def color_compare(timing, calls):
    """calls: [(label, kernel, plain, bytes, setup)]. setup (or None)
    restores the kernel's buffer before each run, untimed; each function
    runs once for the comparison. Returns compare()'s tuple (bytes bound
    every call)."""
    err, k_ms, p_ms, bound = 0, 0.0, 0.0, 0.0
    for label, kernel, plain, nbytes, setup in calls:
        if setup is not None:
            setup()
        got, want = kernel(), plain()
        diff = max_abs_err(got, want)
        kt = timing.ms(kernel, KERNEL_REPS, setup=setup)
        pt = timing.ms(plain, PLAIN_REPS)
        bt = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"    {label}: max_abs_err {diff}, kernel {kt:.4f} ms, bound "
              f"{bt:.4f} ms ({nbytes} bytes), plain {pt:.4f} ms")
        err, k_ms, p_ms, bound = (max(err, diff), k_ms + kt, p_ms + pt,
                                  bound + bt)
    return err, k_ms, p_ms, bound, "bytes"


def jp_calls(gc, label, state):
    """color_jp on each bucket of a strict JP round-start state. Bytes, for
    an uncolored row: its priority; each entry's index word and color, and
    an uncolored neighbour's priority, up to the first rival (an uncolored
    neighbour of higher priority: the row loses); a write only for a row
    that wins (the colors are updated in place)."""
    from gms_tpu_torch.graphs.tiles import SENTINEL
    col, prio, tiers = state[:3]
    calls = []
    for ids, nbrt in tiers:
        idl = ids.long()
        unc_n = nbr_take(col, nbrt) == -1
        rival = unc_n & (nbr_take(prio, nbrt) > prio[idl][:, None])
        live = (col[idl] == -1) & (idl < col.shape[0] - 1)
        wins = live & ~(rival & (nbrt != SENTINEL)).any(1)
        nbytes = bucket_bytes(ids, nbrt, col, 4, 8 + 4 * unc_n.long(),
                              stop=rival, writes=4 * wins.long())
        kbuf, pbuf = col.clone(), col.clone()

        def plain(ids=ids, nbrt=nbrt, pbuf=pbuf):
            pbuf.copy_(col)
            return gc.jp_bucket_plain(pbuf, prio, ids, nbrt)

        calls.append((
            f"color_jp {label}, Dt {nbrt.shape[1]}, Vt {ids.numel()}",
            lambda ids=ids, nbrt=nbrt, kbuf=kbuf: gc.jp_bucket(
                kbuf, prio, ids, nbrt),
            plain, nbytes, lambda kbuf=kbuf: kbuf.copy_(col)))
    return calls


def spec_calls(gc, label, state):
    """The three passes on each bucket of a speculative round-start state.
    Bytes, for an uncolored row: pick, each entry's index word and color;
    rank, its own pick and priority, each entry's index word and color, an
    uncolored neighbour's pick, and the priority of one whose pick is the
    row's; clash, its own tent and priority, each entry's index word and
    tent, and the priority of one whose tent is the row's, up to the first
    such neighbour of higher priority (the row loses)."""
    col, prio, tiers = state[:3]
    pick0 = col.clone()
    for ids, nbrt in tiers:
        gc.spec_pick_plain(col, ids, nbrt, pick0)
    tent = col.clone()
    for ids, nbrt in tiers:
        gc.spec_rank_plain(col, pick0, prio, ids, nbrt, tent)
    calls = []
    for ids, nbrt in tiers:
        tag = f"{label}, Dt {nbrt.shape[1]}, Vt {ids.numel()}"
        idl = ids.long()
        unc_n = (nbr_take(col, nbrt) == -1).long()
        same_pk = (nbr_take(pick0, nbrt) == pick0[idl][:, None]).long()
        same_t = nbr_take(tent, nbrt) == tent[idl][:, None]
        higher = nbr_take(prio, nbrt) > prio[idl][:, None]
        bufs = [col.clone() for _ in range(6)]
        calls += [
            (f"spec_pick {tag}",
             lambda ids=ids, nbrt=nbrt, b=bufs[0]: gc.spec_pick(
                 col, ids, nbrt, b),
             lambda ids=ids, nbrt=nbrt, b=bufs[1]: gc.spec_pick_plain(
                 col, ids, nbrt, b),
             bucket_bytes(ids, nbrt, col, 0, torch.full_like(unc_n, 8)),
             None),
            (f"spec_rank {tag}",
             lambda ids=ids, nbrt=nbrt, b=bufs[2]: gc.spec_rank(
                 col, pick0, prio, ids, nbrt, b),
             lambda ids=ids, nbrt=nbrt, b=bufs[3]: gc.spec_rank_plain(
                 col, pick0, prio, ids, nbrt, b),
             bucket_bytes(ids, nbrt, col, 8,
                          8 + 4 * unc_n + 4 * unc_n * same_pk), None),
            (f"spec_clash {tag}",
             lambda ids=ids, nbrt=nbrt, b=bufs[4]: gc.spec_clash(
                 col, tent, prio, ids, nbrt, b),
             lambda ids=ids, nbrt=nbrt, b=bufs[5]: gc.spec_clash_plain(
                 col, tent, prio, ids, nbrt, b),
             bucket_bytes(ids, nbrt, col, 8, 8 + 4 * same_t.long(),
                          stop=same_t & higher), None)]
    return calls


def johansson_calls(gc, label, state):
    """johansson_bucket on each bucket of a Johansson round-start state,
    with that round's draws. Bytes, for an uncolored row: its draw and
    deg1; each entry's index word and color, and an uncolored neighbour's
    draw and deg1, up to the first neighbour whose pick is the row's."""
    col, deg1, draws, tiers = state[:4]
    calls = []
    for ids, nbrt in tiers:
        idl = ids.long()
        ncol = nbr_take(col, nbrt)
        npick = torch.where(ncol == -1, torch.remainder(
            nbr_take(draws, nbrt), nbr_take(deg1, nbrt)), ncol)
        vpick = torch.remainder(draws[idl], deg1[idl])
        kb, pb = col.clone(), col.clone()
        calls.append((
            f"color_johansson {label}, Dt {nbrt.shape[1]}, Vt {ids.numel()}",
            lambda ids=ids, nbrt=nbrt, b=kb: gc.johansson_bucket(
                col, deg1, draws, ids, nbrt, b),
            lambda ids=ids, nbrt=nbrt, b=pb: gc.johansson_bucket_plain(
                col, deg1, draws, ids, nbrt, b),
            bucket_bytes(ids, nbrt, col, 8, 8 + 8 * (ncol == -1).long(),
                         stop=npick == vpick[:, None]), None))
    return calls


def one_shot_calls(gc, label, state):
    """one_shot_pick and one_shot_resolve on each bucket of a Barenboim or
    Elkin round-start state, with that round's draws. Bytes, for an
    uncolored row: pick, its draw (and its deg1 for Elkin's palette), each
    entry's index word and color, two writes a row (pick and nfree);
    resolve, its nfree, and where nfree > 0 its pick and, over the entries
    w > v only, the index word, the color and an uncolored neighbour's
    pick, up to the first uncolored w > v with the row's pick."""
    col, deg1, draws, tiers, kw = state
    pick, nfree = col.clone(), torch.zeros_like(col)
    for ids, nbrt in tiers:
        gc.one_shot_pick_plain(col, deg1, draws, ids, nbrt, pick, nfree, **kw)
    calls = []
    for ids, nbrt in tiers:
        tag = f"{label}, Dt {nbrt.shape[1]}, Vt {ids.numel()}"
        idl = ids.long()
        unc_v = (col[idl] == -1) & (idl < col.shape[0] - 1)
        unc_n = (nbr_take(col, nbrt) == -1).long()
        above = (nbrt.long() > idl[:, None]).long()
        free = nfree[idl] > 0
        clash = (above * unc_n).bool() & (nbr_take(pick, nbrt)
                                          == pick[idl][:, None])
        kp, kn, pp, pn = col.clone(), col.clone(), col.clone(), col.clone()
        ko, po = col.clone(), col.clone()
        calls += [
            (f"one_shot_pick {tag}",
             lambda ids=ids, nbrt=nbrt, a=kp, b=kn: gc.one_shot_pick(
                 col, deg1, draws, ids, nbrt, a, b, **kw),
             lambda ids=ids, nbrt=nbrt, a=pp, b=pn: gc.one_shot_pick_plain(
                 col, deg1, draws, ids, nbrt, a, b, **kw),
             bucket_bytes(ids, nbrt, col, 8 if kw["palette_deg"] else 4,
                          torch.full_like(unc_n, 8), writes=8), None),
            (f"one_shot_resolve {tag}",
             lambda ids=ids, nbrt=nbrt, b=ko: gc.one_shot_resolve(
                 col, pick, nfree, ids, nbrt, b),
             lambda ids=ids, nbrt=nbrt, b=po: gc.one_shot_resolve_plain(
                 col, pick, nfree, ids, nbrt, b),
             bucket_bytes(ids, nbrt, col, 8, above * (8 + 4 * unc_n),
                          stop=clash, live=unc_v & free)
             + 4 * int((unc_v & ~free).sum()), None)]
    return calls


def component_calls(gc, label, state):
    indptr, indices, comp = state[:3]
    n, nnz = comp.numel(), indices.numel()
    return [(f"color_components {label}, n {n}, {nnz} friend entries",
             lambda: gc.component_step(indptr, indices, comp),
             lambda: gc.component_step_plain(indptr, indices, comp),
             8 * (n + 1) + 8 * nnz + 8 * n + 4, None)]


def coloring_phases(timing, report) -> None:
    """Phases 37-41: graph coloring (see the module docstring)."""
    from gms_tpu_torch.algorithms import coloring as gc
    from gms_tpu_torch.algorithms import similarity as vs
    from gms_tpu_torch.io.builder import build_csr
    from gms_tpu_torch.io.generators import generate_rmat_el

    t0 = time.perf_counter()
    g = build_csr(generate_rmat_el(COLOR_SCALE, DEGREE, seed=SEED),
                  num_nodes=1 << COLOR_SCALE)
    deg = g.degrees
    buckets = [(ids.size, t.shape[1]) for ids, t in gc._TierGraph(g).tiers]
    print(f"[37] graph RMAT {COLOR_SCALE}: {g.num_nodes} nodes "
          f"({int((deg == 0).sum())} isolated), {g.num_edges_undirected} "
          f"undirected edges, max degree {g.max_degree}; buckets (vertices, "
          f"width) {buckets}; {time.perf_counter() - t0:.2f} s")

    def held(graph, c, want_n, want_d, what):
        n_col, d = gc.unique_colors_count(c), color_digest(c)
        check(gc.verify_coloring(graph, c), f"{what}: not a proper coloring")
        if want_n is not None:
            check((n_col, d) == (want_n, want_d),
                  f"{what}: {n_col} colors, digest {d}; want {want_n}, "
                  f"{want_d}")
        return n_col, d

    # [37] main path: speculative JP-LF, counters from 0
    kw, want_n, want_d = COLOR_GOLDEN["spec-lf"]
    gc.reset_launches()
    t0 = time.perf_counter()
    with RoundStates(gc, "spec_round") as spec_states:
        c = gc.jones_plassmann(g, device="cuda", **kw)
    first_s = time.perf_counter() - t0
    main_launches = dict(gc.LAUNCHES)
    rounds = gc.ROUNDS["jones_plassmann"]
    n_col, d = held(g, c, want_n, want_d, "speculative JP-LF")
    check(gc.verify_degree_bound(g, c), "speculative JP-LF over deg(v)")
    warm = []
    for _ in range(COLOR_WARM):
        t0 = time.perf_counter()
        c = gc.jones_plassmann(g, device="cuda", **kw)
        warm.append(time.perf_counter() - t0)
        check(color_digest(c) == want_d, "a warm call's colors differ")
    tier_s = []
    for _ in range(COLOR_WARM):
        t0 = time.perf_counter()
        gc._TierGraph(g).to("cuda")
        torch.cuda.synchronize()
        tier_s.append(time.perf_counter() - t0)
    print(f"[37] main path jones_plassmann(g, speculative=True, "
          f"priority=\"degree\"): {n_col} colors, digest {d}; first call "
          f"(round states recorded) {first_s:.4f} s, median of {COLOR_WARM} warm calls "
          f"{statistics.median(warm):.4f} s, of which the host tier build "
          f"and its copy {statistics.median(tier_s):.4f} s (median of "
          f"{COLOR_WARM} apart); {rounds} rounds; launches {main_launches}")
    check(main_launches["color_spec"] > 0, "K23 never launched")

    # [38] the other deterministic variants, counters from 0 before each
    run_launches = {}
    strict_states = RoundStates(gc, "jp_round")
    for key in ("spec-random", "strict-lf", "strict-random"):
        kw, want_n, want_d = COLOR_GOLDEN[key]
        gc.reset_launches()
        t0 = time.perf_counter()
        with (strict_states if key == "strict-lf"
              else contextlib.nullcontext()):
            c = gc.jones_plassmann(g, device="cuda", **kw)
        dt = time.perf_counter() - t0
        run_launches[key] = dict(gc.LAUNCHES)
        n_col, d = held(g, c, want_n, want_d, key)
        print(f"[38] JP {key}: {n_col} colors, digest {d}, "
              f"{gc.ROUNDS['jones_plassmann']} rounds, {dt:.4f} s; launches "
              f"{run_launches[key]}")
    check(run_launches["strict-lf"]["color_jp"] > 0, "K22 never launched")
    gc.reset_launches()
    vs.reset_launches()
    t0 = time.perf_counter()
    c = gc.dense_sparse(g, seed=0, device="cuda")
    dt = time.perf_counter() - t0
    n_col, d = held(g, c, *COLOR_DS_GOLDEN[0], "dense_sparse RMAT 16")
    print(f"[38] dense_sparse(g, seed=0): {n_col} colors, digest {d}, "
          f"{gc.ROUNDS['dense_sparse']} JP rounds, {dt:.4f} s; launches "
          f"{dict(gc.LAUNCHES)}, pair_scores {vs.LAUNCHES['pair_scores']}")
    check(gc.LAUNCHES["color_jp"] > 0, "dense_sparse: K22 never launched")

    # [39] dense_sparse with its friend components firing
    g14 = build_csr(generate_rmat_el(COLOR_DS_SCALE, DEGREE, seed=SEED),
                    num_nodes=1 << COLOR_DS_SCALE)
    gc.reset_launches()
    vs.reset_launches()
    t0 = time.perf_counter()
    with RoundStates(gc, "component_step") as ds_states:
        c = gc.dense_sparse(g14, seed=0, friend_number=COLOR_DS_FRIENDS,
                            device="cuda")
    dt = time.perf_counter() - t0
    ds_launches = dict(gc.LAUNCHES)
    n_col, d = held(g14, c, *COLOR_DS_GOLDEN[1], "dense_sparse RMAT 14")
    print(f"[39] dense_sparse(RMAT {COLOR_DS_SCALE}, friend_number="
          f"{COLOR_DS_FRIENDS}): {n_col} colors, digest {d}, "
          f"{gc.ROUNDS['component_labels']} label steps, "
          f"{gc.ROUNDS['dense_sparse']} JP rounds, {dt:.4f} s; launches "
          f"{ds_launches}, pair_scores {vs.LAUNCHES['pair_scores']}")
    check(ds_launches["color_components"] > 0, "K25 never launched")
    check(vs.LAUNCHES["pair_scores"] > 0, "K18 never launched")

    # [40] the randomized runs, counters from 0 before each
    rand_states, rand_launches = {}, {}
    for label, call, fn, bound in (
            ("johansson", lambda: gc.johansson(g, device="cuda"),
             "johansson_round", gc.verify_degree_bound),
            ("barenboim", lambda: gc.barenboim_elkin(
                g, variant="barenboim", device="cuda"), "one_shot_round",
             gc.verify_delta_plus_one),
            ("elkin", lambda: gc.barenboim_elkin(
                g, variant="elkin", device="cuda"), "one_shot_round",
             gc.verify_degree_bound)):
        gc.reset_launches()
        t0 = time.perf_counter()
        with RoundStates(gc, fn) as rand_states[label]:
            c = call()
        dt = time.perf_counter() - t0
        rand_launches[label] = dict(gc.LAUNCHES)
        n_col, _ = held(g, c, None, None, label)
        check(bound(g, c) and gc.verify_delta_plus_one(g, c),
              f"{label} breaks its color bound")
        print(f"[40] {label}: {n_col} colors, rounds "
              f"{rand_states[label].rounds}, {dt:.4f} s; launches "
              f"{rand_launches[label]}")
    check(rand_launches["johansson"]["color_johansson"] > 0,
          "K24's johansson entry never launched")
    check(all(rand_launches[v]["color_one_shot"] > 0
              for v in ("barenboim", "elkin")), "K24's one-shot never launched")

    # [41] each kernel against its plain version on the recorded round-start
    # states (the round's own draws for K24): the first round and the last
    # with an uncolored vertex, every bucket. Each kernels-line entry takes
    # its launches and its times from one run.
    groups = {
        "color_jp": (run_launches["strict-lf"], [
            c for lab, st in strict_states.both()
            for c in jp_calls(gc, f"JP-LF {lab}", st)]),
        "color_spec": (main_launches, [
            c for lab, st in spec_states.both()
            for c in spec_calls(gc, f"spec JP-LF {lab}", st)]),
        "color_johansson": (rand_launches["johansson"], [
            c for lab, st in rand_states["johansson"].both()
            for c in johansson_calls(gc, f"Johansson {lab}", st)]),
        "color_one_shot": (rand_launches["barenboim"], [
            c for lab, st in rand_states["barenboim"].both()
            for c in one_shot_calls(gc, f"Barenboim {lab}", st)]),
        "color_components": (ds_launches, [
            c for lab, st in ds_states.both()
            for c in component_calls(gc, f"RMAT {COLOR_DS_SCALE}, label "
                                     f"step {lab.split()[1]}", st)]),
    }
    # Elkin's per-vertex palettes: held to plain too, not on the kernels line
    err, k_ms, p_ms, bound_ms, _ = color_compare(timing, [
        c for lab, st in rand_states["elkin"].both()
        for c in one_shot_calls(gc, f"Elkin {lab}", st)])
    print(f"[41] color_one_shot on Elkin's first and last round: max_abs_err "
          f"{err}, kernel {k_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes), "
          f"plain {p_ms:.4f} ms; its launches "
          f"{rand_launches['elkin']['color_one_shot']}")
    check(err == 0, f"color_one_shot (Elkin) disagrees with plain by {err}")
    for name, (launches, calls) in groups.items():
        err, k_ms, p_ms, bound_ms, by = color_compare(timing, calls)
        lib_ms = None
        if name == "color_components":
            # one scatter_reduce_ (amin) over the friend edge list computes
            # the same step; on the same two states as the kernel
            lib_ms = 0.0
            for _, (indptr, indices, comp, _) in ds_states.both():
                rows = torch.repeat_interleave(
                    torch.arange(comp.numel(), device="cuda"),
                    indptr[1:] - indptr[:-1])

                def lib(comp=comp, rows=rows, idx=indices.long()):
                    return comp.clone().scatter_reduce_(0, rows, comp[idx],
                                                        reduce="amin")

                check(torch.equal(lib(), gc.component_step(
                    indptr, indices, comp)[0]),
                    "scatter_reduce_ differs from K25")
                lib_ms += timing.ms(lib, KERNEL_REPS)
            print(f"    library scatter_reduce_ (amin) on both steps "
                  f"{lib_ms:.4f} ms")
        print(f"[41] {name}: {len(calls)} launches held, max_abs_err {err}, "
              f"kernel {k_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}), plain "
              f"{p_ms:.4f} ms; launches of its run {launches[name]}")
        check(err == 0, f"{name} disagrees with its plain version by {err}")
        report.append(kernel_entry(name, launches[name], err, k_ms, p_ms,
                                   bound_ms, by, library_ms=lib_ms))


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
    launches = {n: tc.LAUNCHES[n] for n in TC_PATH}
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
    print(f"[11] total so far {time.perf_counter() - t_start:.1f} s")
    bk_phases(timing, report)
    print(f"[16] total so far {time.perf_counter() - t_start:.1f} s")
    star_phases(timing, report)
    print(f"[22] total so far {time.perf_counter() - t_start:.1f} s")
    vertex_phases(timing, report, g)
    del g
    print(f"[29] total so far {time.perf_counter() - t_start:.1f} s")
    lp_phases(timing, report)
    print(f"[36] total so far {time.perf_counter() - t_start:.1f} s")
    coloring_phases(timing, report)
    print(f"[41] total {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card_line()}")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
