"""K5 (kclique_dense_count) and K14 (count_dag_edges_per_vertex) on the card,
over whole warm calls; K23, K24, K39 and K40 over theirs.

K5 over one warm RMAT-16 k=5 `kclique_count` call (chip_smoke.py's phase 8),
its device time split by chunk width W. K14 over one warm RMAT-18
`triangle_count_per_vertex` call (phase 23), split by tier (wa, wb), and the
same tiers through K1's gather entry (`count_dag_edges`: one thread an edge
merging the two rows, as the parent's K14 does, without the witness adds),
so that the gap between the two is what the parent's witness atomics cost.
K23 (`spec_*`) over a warm speculative JP-LF call and K24 over warm
`johansson` and `barenboim_elkin` calls at RMAT-16 (phases 37 and 39), for
the ranking of the next redesigns. K40 (count_dag_edges_cross) over one
warm RMAT-18 `VertexShardedTrianglePlan.run` at a world of one (phase 56's
call, no process group), and, where the package has K40's schedule
(cross_schedule), the kernel alone on that rotation by the schedule's span,
by torch.profiler's device time over HELD_PASSES launches. K39
(member_pack) over one warm `VertexShardedKCliquePlan.run` at RMAT-13 k=6
and one warm `VertexShardedBKPlan.run` at RMAT-12, both at a world of one
and built as phase 56 builds them (exact degeneracy ranks, root chunks of
512). K15 (count_hub_edges) over one warm RMAT-16 `triangle_count_dense`
call (phase 25) and held on its edges, K16 (bitmap_rows_count) held on
that bitmap's rows, row v against row v+1 (phase 27); K30 (bfs_push and
frontier_ids) over one warm RMAT-18 `bfs(g, 0)` call (phase 47), each
launch's device time, K29 (bfs_pull) beside it, and bfs_push held on each
push level's own state (phase 50's levels 0, 3 and 4), the state copied
before each pass. K2 (count_hub_groups_mat, count_hub_groups) over one
warm RMAT-18 `TrianglePlan.run()` in each mode (the default, materialized,
and `materialize=False`; phase 3's trial), split by (W, K) set, K1 beside
it (count_tier_mat, count_dag_edges: a trial launches K1 a tier, then K2 a
set, and the parent's kernels of both bear one name, so the trial's
launches are told apart by their order), and `run_steady(8)` by CUDA
events. K33 (cc_step, sssp_step) over one warm RMAT-18
`connected_components(g)` and one warm weighted `sssp(g, 0, w)` (phase
47's weights, 1 + ((u ^ v) % 9) a CSR slot), each launch's device time in
launch order. K1, K3, K25, K32 and K33 held as chip_smoke.py holds them
(--parts held). Each call under torch.profiler (the
kernel's device time and launches, each launch's device time in launch
order, read by bench/profiling.py's profile_launches, the host time and
the device's idle share) and, unprofiled, the best of 3. K17 (adg_round)
over one warm RMAT-18 `adg_ordering_rank_device(g, 0.1, "avg")` call (phase
26's main path), by kernel and by round (the parent's four launches a
round, init_stats, stats, mask and pull; this tree's one cooperative
launch), and held on each of the call's round states as chip_smoke.py's
phase 28 holds it, beside a wrapper call's host time (--parts adg). The
RMAT-18 hub table as each package's TrianglePlan builds it (K3 and, in the
parent, the zero-fill before it and the guard row's torch.cat after it;
this tree's build_hub_rows(out=) one launch) by device time and held, and
K3's device time over one whole plan build (--parts hub).

    python -m gms_tpu_torch.bench.dense_vertex --label this \
        [--parts kc,pv,color,ring,dense,bfs,tc,min,held,adg,hub]

To compare two checkouts on one card, run the other's package with this
script in turns: PYTHONPATH=<other checkout> python
gms_tpu_torch/bench/dense_vertex.py --label other. The other checkout's
bench/profiling.py must have profile_launches. Needs a card; prints the
card's name and power limit, the ptxas report of the two libraries where
this call built them, and one JSON object last.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from gms_tpu_torch.bench.adj_jp import best_s, window
from gms_tpu_torch.bench.profiling import launch_split, profile_launches

SEED, DEGREE = 27491095, 16
KC_SCALE, KC_K, KC_GOLDEN = 16, 5, 4_600_426_489
TC_GOLDEN = 82_647_223
PV_SCALE, PV_SUM = 18, 3 * TC_GOLDEN
COLOR_SCALE = 16
# the device functions of each kernel, this tree's and the parent's
K5_KERNELS = ("rows_kernel", "rows_any_kernel", "popcount_kernel",
              "dense_kernel")
K14_KERNELS = ("vertex_kernel",)
K1_GATHER = ("gather_kernel",)
# K23: the parent's three passes, a launch a bucket; this tree's dispatch
# kernel (and the passes' one kernel, which no entry point runs)
K23_KERNELS = ("spec_pick_kernel", "spec_rank_kernel", "spec_clash_kernel",
               "spec_pass_kernel", "spec_run_kernel")
# K24: the parent's one-bucket kernels, this tree's round kernel (and its
# pick-word pass)
K24_KERNELS = ("johansson_kernel", "one_shot_pick_kernel",
               "one_shot_resolve_kernel", "round_kernel",
               "pick_words_kernel")
# K40: the parent's thread merge (K1's gather kernel over two tables), this
# tree's owned-row kernels
K40_KERNELS = ("gather_kernel", "owned_rows_kernel")
# K39 (csrc/ring_member.cu), the parent's and this tree's
K39_KERNELS = ("member_kernel",)
# the ring plans K39 serves (phase 56): (label, scale, k or None for BK,
# golden)
RING_K39 = (("VertexShardedKCliquePlan RMAT 13 k=6", 13, 6, 681_595_966),
            ("VertexShardedBKPlan RMAT 12", 12, None, 725_641))
RING_CHUNK = 512
K40_SPANS, K40_STAGES, HELD_PASSES = (32, 128), ("block", "bitmap", "bitmap_s8", "bitmap_s2", "bitmap_s1"), 10
# K15: the parent's warp an edge, this tree's runs; K16; K30: the push (this
# tree's offsets scan and segment push, the parent's warp a row) and the
# compaction; K29
K15_KERNELS = ("edge_kernel", "edge_runs_kernel")
K16_KERNELS = ("rows_kernel",)
K30_PUSH = ("push_offsets_kernel", "bfs_push_kernel")
K30_IDS = ("frontier_ids_kernel",)
K29_KERNELS = ("bfs_pull_kernel",)
DENSE_SCALE, DENSE_GOLDEN = 16, 15_613_640
BFS_SCALE, BFS_REACHED = 18, 173_898
# K1 and K2 in a triangle trial: the parent's K2 kernels bear K1's names
# (stream_kernel, gather_kernel), this tree's its own
TC_SCALE = 18
TC_TRIAL = ("stream_kernel", "gather_kernel", "hub_groups_kernel")
# K33: the parent's warp a vertex, this tree's init and row-schedule step
K33_KERNELS = ("cc_step_kernel", "sssp_step_kernel", "min_init_kernel",
               "min_step_kernel")
MIN_SCALE, MIN_COMPONENTS, MIN_SSSP = 18, 88_200, (23, 804_946)
# K17: the parent's four kernels a round, this tree's cooperative round; K3
K17_KERNELS = ("init_stats", "stats_kernel", "mask_kernel", "pull_kernel",
               "adg_round_kernel")
K3_KERNELS = ("hub_rows_kernel",)
ADG_SCALE, ADG_RUN = 18, (0.1, "avg")
PARTS = ("kc", "pv", "color", "ring", "dense", "bfs", "tc", "min", "held",
         "adg", "hub")


def held_k40(tc, own, eb, vb) -> dict:
    """K40 alone on a rotation by the schedule's span: device ms a launch
    (torch.profiler over HELD_PASSES launches), the items, the count."""
    from gms_tpu_torch.bench.profiling import profile_window

    out = {}
    lens = tc.row_lengths(own)
    for span in K40_SPANS:
        sched = tc.cross_schedule(eb, vb, lens, span=span)

        def passes(sched=sched):
            return [tc.count_dag_edges_cross(own, own, eb, vb, schedule=sched)
                    for _ in range(HELD_PASSES)]

        got = {int(x) for x in passes()}
        _, _, per, _ = profile_window(passes)
        ms = sum(per[k][0] for k in K40_KERNELS if k in per) / 1e3
        n = sum(per[k][1] for k in K40_KERNELS if k in per)
        key = f"span {span}"
        out[key] = {"ms": ms / max(n, 1), "launches": n,
                    "items": int(sched.items.shape[0]), "count": sorted(got)}
        print(f"    K40 held, {key}: {ms / max(n, 1):.4f} ms a launch ({n} "
              f"traced), {sched.items.shape[0]} items, count {sorted(got)}")
        if got != {TC_GOLDEN}:
            raise SystemExit(f"K40 {key}: {sorted(got)}")
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--label", default="")
    p.add_argument("--parts", default=",".join(PARTS),
                   help="of " + ",".join(PARTS))
    args = p.parse_args(argv)
    parts = args.parts.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("dense_vertex needs a CUDA device")

    import gms_tpu_torch
    from gms_tpu_torch import _kernels
    from gms_tpu_torch.algorithms import coloring as gc
    from gms_tpu_torch.algorithms import k_clique as kc
    from gms_tpu_torch.algorithms import triangle_count as tc
    from gms_tpu_torch.io.builder import build_csr
    from gms_tpu_torch.io.generators import generate_rmat_el
    from gms_tpu_torch.parallel import sharding
    from gms_tpu_torch.preprocessing import degeneracy

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}; package {gms_tpu_torch.__file__}")
    built = _kernels.build()
    for name in ("kclique_dense", "tier_intersect", "color_spec"):
        if name in built:
            print(f"ptxas {name}:\n{built[name]}")
    out = {"label": args.label, "card": card}
    if "kc" in parts:
        out["kclique_count"] = kc_part(kc, build_csr, generate_rmat_el,
                                       degeneracy)
    if "pv" in parts:
        out.update(pv_part(tc, build_csr, generate_rmat_el))
    if "color" in parts:
        out["coloring"] = color_part(gc, build_csr, generate_rmat_el)
    if "ring" in parts:
        out["vertex_sharded"] = ring_part(tc, sharding, build_csr,
                                          generate_rmat_el)
        out["ring_k39"] = k39_part(sharding, build_csr, generate_rmat_el,
                                   degeneracy)
    if "dense" in parts:
        out["dense"] = dense_part(tc, build_csr, generate_rmat_el)
    if "bfs" in parts:
        out["bfs"] = bfs_part(build_csr, generate_rmat_el)
    if "tc" in parts:
        out["tc"] = tc_part(tc, build_csr, generate_rmat_el)
    if "min" in parts:
        out["min"] = min_part(build_csr, generate_rmat_el)
    if "held" in parts:
        out["held"] = held_part(tc, build_csr, generate_rmat_el)
    if "adg" in parts:
        out["adg"] = adg_part(degeneracy, build_csr, generate_rmat_el)
    if "hub" in parts:
        out["hub"] = hub_part(tc, build_csr, generate_rmat_el)
    print(json.dumps(out))
    return out


def kc_part(kc, build_csr, generate_rmat_el, degeneracy) -> dict:
    """K5 over the warm kclique_count call, by chunk width."""
    g = build_csr(generate_rmat_el(KC_SCALE, DEGREE, seed=SEED),
                  num_nodes=1 << KC_SCALE)
    rank, _ = degeneracy.degeneracy_ordering_rank(g)

    def single():
        return kc.kclique_count(g, KC_K, device="cuda", rank=rank)

    if single() != KC_GOLDEN:
        raise SystemExit("kclique_count: not the golden count")
    n, host_s, per, busy, seq = profile_launches(single)
    if n != KC_GOLDEN:
        raise SystemExit(f"profiled kclique_count: {n}")
    tag = f"warm kclique_count RMAT {KC_SCALE} k={KC_K}:"
    run = window(tag, host_s, per, busy, {"K5": K5_KERNELS})
    _, chunks = kc.plan_chunks(g, KC_K, device="cuda", rank=rank)
    run["by_w"] = launch_split(f"{tag} K5", seq, K5_KERNELS,
                        [f"W={32 * ww}" for _, ww in chunks])
    run["best_s"] = best_s(single)
    print(f"    unprofiled best of 3 {run['best_s']:.4f} s")
    return run


def pv_part(tc, build_csr, generate_rmat_el) -> dict:
    """K14 over the warm per-vertex call, by tier; K1's gather on its
    tiers."""
    out = {}
    g = build_csr(generate_rmat_el(PV_SCALE, DEGREE, seed=SEED),
                  num_nodes=1 << PV_SCALE)

    def per_vertex():
        return tc.triangle_count_per_vertex(g, device="cuda")

    if int(per_vertex().sum()) != PV_SUM:
        raise SystemExit("triangle_count_per_vertex: not the golden sum")
    pv, host_s, per, busy, seq = profile_launches(per_vertex)
    if int(pv.sum()) != PV_SUM:
        raise SystemExit(f"profiled per-vertex call: Σ {int(pv.sum())}")
    tag = f"warm triangle_count_per_vertex RMAT {PV_SCALE}:"
    run = window(tag, host_s, per, busy, {"K14": K14_KERNELS})
    pg, parts = tc.plan_per_vertex(g, device="cuda")
    tiers = [f"({wa},{wb})" for wa, wb, *_ in parts]
    run["by_tier"] = launch_split(f"{tag} K14", seq, K14_KERNELS, tiers)
    run["best_s"] = best_s(per_vertex)
    print(f"    unprofiled best of 3 {run['best_s']:.4f} s")
    out["per_vertex"] = run

    def gather():
        return [tc.count_dag_edges(pg.nbr, e, v, chunk=c, width_a=wa,
                                   width_b=wb)
                for wa, wb, c, e, v in parts]

    want = sum(int(x) for x in gather())
    if 3 * want != PV_SUM:
        raise SystemExit(f"K1's gather on the per-vertex tiers: {want}")
    # two passes in the window, the second split by tier
    _, host_s, per, busy, seq = profile_launches(lambda: (gather(), gather()))
    tag = f"K1 gather, two passes over the {len(parts)} per-vertex tiers:"
    run = window(tag, host_s, per, busy, {"K1 gather": K1_GATHER})
    run["by_tier"] = launch_split(f"{tag} K1, the second pass", seq,
                                  K1_GATHER, tiers)
    out["k1_gather"] = run
    return out


def color_part(gc, build_csr, generate_rmat_el) -> dict:
    """K23 and K24 over their warm coloring calls; K24 held on the first
    and the last round of the warm Johansson and Barenboim calls."""
    g = build_csr(generate_rmat_el(COLOR_SCALE, DEGREE, seed=SEED),
                  num_nodes=1 << COLOR_SCALE)
    calls = {
        "speculative JP-LF": (lambda: gc.jones_plassmann(
            g, speculative=True, priority="degree", device="cuda"),
            {"K23": K23_KERNELS}, None),
        "johansson": (lambda: gc.johansson(g, device="cuda"),
                      {"K24": K24_KERNELS}, "johansson_round"),
        "barenboim": (lambda: gc.barenboim_elkin(g, variant="barenboim",
                                                 device="cuda"),
                      {"K24": K24_KERNELS}, "one_shot_round"),
    }
    out = {}
    for label, (fn, groups, round_fn) in calls.items():
        first = fn()
        if not gc.verify_coloring(g, np.asarray(first)):
            raise SystemExit(f"{label}: not a proper coloring")
        _, host_s, per, busy, _ = profile_launches(fn)
        run = window(f"warm {label} RMAT {COLOR_SCALE}:", host_s, per, busy,
                     groups)
        run["best_s"] = best_s(fn)
        print(f"    unprofiled best of 3 {run['best_s']:.4f} s")
        if round_fn is not None:
            run["held"] = held_rounds(gc, round_fn, fn, label)
        out[label] = run
    return out


def held_rounds(gc, round_fn, call, label) -> dict:
    """K24 held on the first and the last round-start state of one call of
    `call` (gc.<round_fn>'s inputs, copied as the call runs): the round
    entry against its plain version, then its K24 device ms and launches a
    round under torch.profiler over HELD_PASSES rounds."""
    from gms_tpu_torch.bench.profiling import profile_window

    inner = getattr(gc, round_fn)
    plain = getattr(gc, round_fn + "_plain")
    states = []

    def record(*args, **kw):
        snap = (tuple(a.clone() if isinstance(a, torch.Tensor) else a
                      for a in args), kw)
        states[1:] = [snap] if states else []
        if not states:
            states.append(snap)
        return inner(*args, **kw)

    setattr(gc, round_fn, record)
    try:
        call()
    finally:
        setattr(gc, round_fn, inner)
    out = {}
    for tag, (args, kw) in zip(("first", "last"), states):
        got, want = inner(*args, **kw), plain(*args, **kw)
        got, want = (got if isinstance(got, tuple) else (got,),
                     want if isinstance(want, tuple) else (want,))
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise SystemExit(f"{label} {round_fn}, {tag} round: not plain's")
        _, _, per, _ = profile_window(
            lambda: [inner(*args, **kw) for _ in range(HELD_PASSES)])
        ms = sum(per[k][0] for k in K24_KERNELS if k in per) / 1e3
        n = sum(per[k][1] for k in K24_KERNELS if k in per)
        out[tag] = {"ms": ms / HELD_PASSES, "launches": n / HELD_PASSES}
        print(f"    K24 held, {label} {tag} round ({len(args[3])} buckets): "
              f"{ms / HELD_PASSES:.4f} ms and {n / HELD_PASSES:g} launches a "
              f"round (device time over {HELD_PASSES} rounds), = plain")
    return out


def ring_part(tc, sharding, build_csr, generate_rmat_el) -> dict:
    """K40 over the warm RMAT-18 vertex-sharded run at a world of one; the
    kernel alone by span where the package has its schedule."""
    import time

    g = build_csr(generate_rmat_el(PV_SCALE, DEGREE, seed=SEED),
                  num_nodes=1 << PV_SCALE)
    t0 = time.perf_counter()
    plan = sharding.VertexShardedTrianglePlan(g, sharding.make_mesh())
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if plan.run() != TC_GOLDEN:
        raise SystemExit("VertexShardedTrianglePlan.run: not the golden count")
    got, host_s, per, busy, _ = profile_launches(plan.run)
    if got != TC_GOLDEN:
        raise SystemExit(f"profiled vertex-sharded run: {got}")
    run = window(f"warm VertexShardedTrianglePlan.run RMAT {PV_SCALE}, "
                 f"world of one:", host_s, per, busy, {"K40": K40_KERNELS})
    run["best_s"] = best_s(plan.run)
    run["build_s"] = build_s
    print(f"    unprofiled best of 3 {run['best_s']:.4f} s; plan built in "
          f"{build_s:.3f} s")
    if hasattr(tc, "cross_schedule"):
        run["held"] = held_k40(tc, plan._own, plan._eb[0], plan._vb[0])
    return run


def k39_part(sharding, build_csr, generate_rmat_el, degeneracy) -> dict:
    """K39 over the warm ring-streamed k-clique and BK runs at a world of
    one, and held on their (chunk, pack) calls."""
    out = {}
    for label, scale, k, golden in RING_K39:
        g = build_csr(generate_rmat_el(scale, DEGREE, seed=SEED),
                      num_nodes=1 << scale)
        rank, _ = degeneracy.degeneracy_ordering_rank(g)
        mesh = sharding.make_mesh()
        plan = (sharding.VertexShardedKCliquePlan(g, mesh, k=k, rank=rank,
                                                  root_chunk=RING_CHUNK)
                if k is not None else
                sharding.VertexShardedBKPlan(g, mesh, rank=rank,
                                             root_chunk=RING_CHUNK))
        if plan.run() != golden:
            raise SystemExit(f"{label}: not the golden count")
        got, host_s, per, busy, _ = profile_launches(plan.run)
        if got != golden:
            raise SystemExit(f"profiled {label}: {got}")
        run = window(f"warm {label}, world of one:", host_s, per, busy,
                     {"K39": K39_KERNELS})
        run["best_s"] = best_s(plan.run)
        print(f"    unprofiled best of 3 {run['best_s']:.4f} s")
        run["held"] = held_k39(plan, label)
        out[label] = run
        del plan
    return out


def held_k39(plan, label) -> dict:
    """K39 alone on a world-of-one plan's (chunk, pack) calls, as
    chip_smoke.py's phase 57 holds them: each against member_pack_plain,
    then its device ms and launches over HELD_PASSES passes of them all."""
    from gms_tpu_torch.algorithms import k_clique as kc
    from gms_tpu_torch.bench.profiling import profile_window
    from gms_tpu_torch.graphs.tiles import SENTINEL

    calls = []
    vis = plan._own
    for rc in plan._chunks():
        _live, q, valid, owner, locs, adj = plan._universe(rc)
        packs = [(owner, locs, valid, adj.shape[1])]
        if hasattr(plan, "_lown"):
            _, wl = plan._root_rows(rc, plan._lown)
            w_owner, w_locs = plan._lookup(wl)
            packs.append((w_owner, w_locs, wl != int(SENTINEL), wl.shape[1]))
        for own, lc, v, L in packs:
            sel = (v & (own == 0)).contiguous()
            o = torch.zeros((q.shape[0], L, plan.w_words), dtype=torch.int32,
                            device=q.device)
            calls.append((q, lc, sel, o))
    for q, lc, sel, o in calls:
        want = kc.member_pack_plain(q, vis, lc, sel, torch.zeros_like(o))
        if not torch.equal(kc.member_pack(q, vis, lc, sel, o), want):
            raise SystemExit(f"{label}: member_pack is not plain's")

    def passes():
        for _ in range(HELD_PASSES):
            for q, lc, sel, o in calls:
                kc.member_pack(q, vis, lc, sel, o)

    _, _, per, _ = profile_window(passes)
    ms = sum(per[k][0] for k in K39_KERNELS if k in per) / 1e3
    n = sum(per[k][1] for k in K39_KERNELS if k in per)
    print(f"    K39 held, {label}: {ms / HELD_PASSES:.4f} ms over its "
          f"{len(calls)} (chunk, pack) calls ({n / HELD_PASSES:g} launches a "
          f"pass, device time over {HELD_PASSES} passes), = plain")
    return {"ms": ms / HELD_PASSES, "calls": len(calls),
            "launches": n / HELD_PASSES}


def held(fn, names, passes=HELD_PASSES) -> tuple:
    """(device ms a pass, launches a pass) of `names` over `passes` calls of
    fn under torch.profiler."""
    from gms_tpu_torch.bench.profiling import profile_window

    _, _, per, _ = profile_window(lambda: [fn() for _ in range(passes)])
    ms = sum(per[k][0] for k in names if k in per) / 1e3
    n = sum(per[k][1] for k in names if k in per)
    return ms / passes, n / passes


def dense_part(tc, build_csr, generate_rmat_el) -> dict:
    """K15 over the warm dense count and held on its edges; K16 held on
    the bitmap's rows."""
    from gms_tpu_torch.graphs.bitmap import BitmapGraph
    from gms_tpu_torch.preprocessing import orient
    from gms_tpu_torch.sets import bitmap_ops as bo

    g = build_csr(generate_rmat_el(DENSE_SCALE, DEGREE, seed=SEED),
                  num_nodes=1 << DENSE_SCALE)

    def dense():
        return tc.triangle_count_dense(g, device="cuda")

    if dense() != DENSE_GOLDEN:
        raise SystemExit("triangle_count_dense: not the golden count")
    got, host_s, per, busy, seq = profile_launches(dense)
    if got != DENSE_GOLDEN:
        raise SystemExit(f"profiled triangle_count_dense: {got}")
    run = window(f"warm triangle_count_dense RMAT {DENSE_SCALE}:", host_s,
                 per, busy, {"K15": K15_KERNELS})
    run["best_s"] = best_s(dense)
    print(f"    unprofiled best of 3 {run['best_s']:.4f} s")
    dag = orient.orient(g, orient.degree_rank(g))
    bg = BitmapGraph.from_csr(dag, device="cuda")
    e, v = tc._pad_edges(dag.edge_array(), 1024)
    e, v = torch.from_numpy(e).cuda(), torch.from_numpy(v).cuda()
    k15 = int(tc.count_hub_edges(bg.words, None, e, v, chunk=1024))
    if k15 != DENSE_GOLDEN:
        raise SystemExit(f"count_hub_edges held: {k15}")
    ms, n = held(lambda: tc.count_hub_edges(bg.words, None, e, v, chunk=1024),
                 K15_KERNELS)
    run["held"] = {"ms": ms, "launches": n}
    print(f"    K15 held on the call's {int(v.sum())} edges: {ms:.4f} ms a "
          f"launch (device time over {HELD_PASSES})")
    a, b = bg.words[:-1], bg.words[1:]
    k16 = {}
    for op in ("card", "and", "or", "andnot"):
        if not torch.equal(bo.rows_count(a, b, op=op),
                           bo.rows_count_plain(a, b, op=op)):
            raise SystemExit(f"bitmap_rows_count {op}: not plain's")
        k16[op], _ = held(lambda op=op: bo.rows_count(a, b, op=op),
                          K16_KERNELS)
    run["k16_held"] = k16
    print(f"    K16 held on {a.shape[0]} row pairs, device ms a launch: "
          + ", ".join(f"{op} {ms:.4f}" for op, ms in k16.items()))
    return run


def bfs_part(build_csr, generate_rmat_el) -> dict:
    """K30 and K29 over the warm d-opt BFS call; bfs_push held on each push
    level's state."""
    from gms_tpu_torch.algorithms import gapbs as gb

    g = build_csr(generate_rmat_el(BFS_SCALE, DEGREE, seed=SEED),
                  num_nodes=1 << BFS_SCALE)

    def bfs():
        return gb.bfs(g, 0, device="cuda")

    hops = bfs()
    dirs = list(gb.STEPS["bfs"])
    if int((hops >= 0).sum()) != BFS_REACHED:
        raise SystemExit("bfs: not the golden reach")
    _, host_s, per, busy, seq = profile_launches(bfs)
    run = window(f"warm bfs(g, 0) RMAT {BFS_SCALE} {dirs}:", host_s, per,
                 busy, {"K30 push": K30_PUSH, "K30 frontier_ids": K30_IDS,
                        "K29": K29_KERNELS})
    pushes = [it for it, d in enumerate(dirs) if d == "push"]
    # the push kernel's launches in order, one a push level
    run["push_by_level"] = launch_split(
        "K30 bfs_push kernel", seq, ("bfs_push_kernel",),
        [f"level {it}" for it in pushes])
    run["best_s"] = best_s(bfs)
    print(f"    unprofiled best of 3 {run['best_s']:.4f} s")
    indptr, indices, _, n, _ = gb._prep(g, "cuda")
    dist = torch.from_numpy(np.where(hops < 0, gb.INF, hops).astype(
        np.int32)).cuda()
    levels = {}
    for it in pushes:
        st = torch.where(dist <= it, dist, gb.INF).to(torch.int32)
        ids, fc = gb.frontier_ids_plain(st, it)
        fc = int(fc)
        work = st.clone()

        def push(it=it, ids=ids, fc=fc, st=st, work=work):
            work.copy_(st)
            return gb.bfs_push(indptr, indices, ids, fc, work, it)

        nxt, c = push()
        want, wc = gb.bfs_push_plain(indptr, indices, ids, fc, st.clone(),
                                     it)
        if int(c) != int(wc) or not torch.equal(
                nxt[:int(c)].sort().values, want[:int(wc)].sort().values):
            raise SystemExit(f"bfs_push level {it}: not plain's")
        ms, k = held(push, K30_PUSH)
        levels[f"level {it}"] = {"frontier": fc, "ms": ms, "launches": k}
        print(f"    K30 push held, level {it} ({fc} frontier): {ms:.4f} ms "
              f"and {k:g} launches a level (device time over {HELD_PASSES})")
    run["held"] = levels
    return run


def tc_part(tc, build_csr, generate_rmat_el) -> dict:
    """K2 by (W, K) set and K1 over one warm trial in each mode; the steady
    trial by CUDA events."""
    g = build_csr(generate_rmat_el(TC_SCALE, DEGREE, seed=SEED),
                  num_nodes=1 << TC_SCALE)
    out = {}
    for mode, kw in (("materialized", {}), ("gather", {"materialize": False})):
        plan = tc.TrianglePlan(g, device="cuda", **kw)
        if plan.run() != TC_GOLDEN:
            raise SystemExit(f"TrianglePlan {mode}: not the golden count")
        got, host_s, per, busy, seq = profile_launches(plan.run)
        if got != TC_GOLDEN:
            raise SystemExit(f"profiled TrianglePlan {mode}: {got}")
        tag = f"warm TrianglePlan.run() RMAT {TC_SCALE} {mode}:"
        run = window(tag, host_s, per, busy, {"K1 and K2": TC_TRIAL})
        us = [t for n, t in seq if n in TC_TRIAL]
        n1, sets = len(plan.tiers), [f"W={w},K={k}" for w, k, *_ in plan.hub]
        if len(us) == n1 + len(sets):
            run["K1"] = {"ms": sum(us[:n1]) / 1e3, "launches": n1}
            run["K2"] = {"ms": sum(us[n1:]) / 1e3, "launches": len(sets)}
            run["K2_by_set"] = {k: t / 1e3 for k, t in zip(sets, us[n1:])}
            print(f"    {tag} K1 {run['K1']['ms']:.4f} ms over {n1}, K2 "
                  f"{run['K2']['ms']:.4f} ms over {len(sets)}; K2 by set: "
                  + "; ".join(f"{k} {t:.4f}"
                              for k, t in run["K2_by_set"].items()))
        else:
            print(f"    {tag} {len(us)} K1/K2 launches traced for "
                  f"{n1 + len(sets)}: not split")
        run["K2_held"] = held_k2(tc, plan)
        cnt, dt = plan.run_steady(8)
        if cnt != TC_GOLDEN:
            raise SystemExit(f"run_steady {mode}: {cnt}")
        run["steady_ms"] = dt * 1e3
        # the host's time to enqueue a trial (20 back to back, before the
        # synchronize): a steady trial is host-bound when it exceeds the
        # device's
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            plan._count()
        run["enqueue_ms"] = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        print(f"    {tag} run_steady(8) {dt * 1e3:.4f} ms a trial (CUDA "
              f"events); the host enqueues a trial in "
              f"{run['enqueue_ms']:.4f} ms")
        out[mode] = run
        del plan
    return out


def held_ms(fn, flush, reps: int = 10) -> float:
    """A call held as chip_smoke.py's Timing holds it: alone, L2 flushed,
    CUDA events, the median of `reps` (fn has run once already)."""
    import statistics

    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def held_k2(tc, plan) -> dict:
    """K2's launches of a trial held as chip_smoke.py's phase 4 holds them,
    summed; and the host's time a K2 wrapper call takes (200 calls of the
    first set's, nothing synchronised between them)."""
    if plan.hub_mat is not None:
        calls = [lambda x=x: tc.count_hub_groups_mat(
            x[1], x[2], **({"live": x[3]} if len(x) > 3 else {}))
            for x in plan.hub_mat]
    else:
        calls = [lambda w=w, k=k, b=b, n=n: tc.count_hub_groups(
            plan.hub_rows, b, n, chunk=1, width=w, k=k)
            for w, k, _, b, n in plan.hub]
    flush = torch.empty(1 << 26, dtype=torch.int32, device="cuda")
    total = 0.0
    for fn in calls:
        fn()
        total += held_ms(fn, flush)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        calls[0]()
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    print(f"    K2 held over the trial's {len(calls)} launches (each alone, "
          f"L2 flushed, CUDA events): {total:.4f} ms; a K2 wrapper call "
          f"takes {host_us:.1f} µs of host time")
    return {"ms": total, "launches": len(calls), "host_us": host_us}


def held_part(tc, build_csr, generate_rmat_el) -> dict:
    """K1, K3, K25, K32 and K33 held as chip_smoke.py holds them (phases 4,
    41 and 50), on the same inputs in every package: K1 on the RMAT-18
    plans' tiers, K3 on the plan's hub rows, K32 on PageRank's first
    iteration, K33 on CC's and weighted SSSP's first and last step, K25 on
    RMAT-14's CSR from labels = ids, each on its row schedule (K33's where
    the package's step takes one); ms summed over a kernel's calls."""
    import inspect

    from gms_tpu_torch.algorithms import coloring as gc
    from gms_tpu_torch.algorithms import gapbs as gb
    from gms_tpu_torch.graphs.row_schedule import build_row_schedule

    g = build_csr(generate_rmat_el(TC_SCALE, DEGREE, seed=SEED),
                  num_nodes=1 << TC_SCALE)
    plan = tc.TrianglePlan(g, device="cuda")
    gplan = tc.TrianglePlan(g, device="cuda", materialize=False)
    hw = plan.hub_rows.shape[1]
    calls = {
        "K1 count_tier_mat": [lambda a=a, b=b: tc.count_tier_mat(a, b)
                              for _, a, b in plan.tiers_mat],
        "K1 count_dag_edges": [
            lambda e=e, v=v, wa=wa, wb=wb: tc.count_dag_edges(
                gplan.padded.nbr, e, v, width_a=wa, width_b=wb)
            for wa, wb, _, e, v in gplan.tiers],
        "K3 build_hub_rows": [lambda: tc.build_hub_rows(
            plan.padded.nbr, plan.hub_id, plan.wide_ids, hub_words=hw)]}
    indptr, indices = gb._prep(g, "cuda")[:2]
    n = g.num_nodes
    sched = build_row_schedule(indptr)
    deg = torch.from_numpy(g.degrees.astype(np.int32)).cuda()
    pr0 = torch.full((n,), float(np.float32(1.0) / np.float32(n)),
                     device="cuda")
    base = float(np.float32(1.0 - 0.85) / np.float32(n))
    calls["K32 pr_pull"] = [lambda: gb.pr_pull(
        indptr, indices, deg, pr0, base, float(np.float32(0.85)),
        schedule=sched)]
    kw = ({"schedule": sched}
          if "schedule" in inspect.signature(gb.cc_step).parameters else {})
    u = np.repeat(np.arange(n), g.degrees.astype(np.int64))
    w = (1 + ((u ^ g.indices) % 9)).astype(np.int32)
    wt = torch.from_numpy(w).cuda()
    labels = torch.arange(n, dtype=torch.int32, device="cuda")
    cc_last = torch.from_numpy(gb.connected_components(g, device="cuda")).cuda()
    d0 = torch.full((n,), gb.BIG, dtype=torch.int64, device="cuda")
    d0[0] = 0
    d = gb.sssp(g, 0, w, device="cuda")
    d_last = torch.from_numpy(np.where(d < 0, gb.BIG, d)).cuda()
    calls["K33 cc_step"] = [lambda s=s: gb.cc_step(indptr, indices, s, **kw)
                            for s in (labels, cc_last)]
    calls["K33 sssp_step"] = [
        lambda s=s: gb.sssp_step(indptr, indices, wt, s, **kw)
        for s in (d0, d_last)]
    g14 = build_csr(generate_rmat_el(14, DEGREE, seed=SEED), num_nodes=1 << 14)
    ip14 = torch.from_numpy(g14.indptr).cuda()
    ix14 = torch.from_numpy(g14.indices).cuda()
    s14 = build_row_schedule(ip14)
    comp = torch.arange(1 << 14, dtype=torch.int32, device="cuda")
    calls["K25 component_step"] = [lambda: gc.component_step(
        ip14, ix14, comp, schedule=s14)]
    flush = torch.empty(1 << 26, dtype=torch.int32, device="cuda")
    out = {}
    for name, fns in calls.items():
        for fn in fns:
            fn()
        out[name] = sum(held_ms(fn, flush) for fn in fns)
        print(f"    held {name}: {out[name]:.4f} ms over {len(fns)} calls "
              f"(each alone, L2 flushed, CUDA events, median of 10)")
    return out


def min_part(build_csr, generate_rmat_el) -> dict:
    """K33 over the warm connected_components and weighted sssp calls, by
    launch; the best of 3."""
    from gms_tpu_torch.algorithms import gapbs as gb

    g = build_csr(generate_rmat_el(MIN_SCALE, DEGREE, seed=SEED),
                  num_nodes=1 << MIN_SCALE)
    u = np.repeat(np.arange(g.num_nodes), g.degrees.astype(np.int64))
    w = (1 + ((u ^ g.indices) % 9)).astype(np.int32)

    def check(label, got):
        if label == "connected_components":
            ok = len(np.unique(got)) == MIN_COMPONENTS
        else:
            ok = (int(got.max()), int(got[got >= 0].sum())) == MIN_SSSP
        if not ok:
            raise SystemExit(f"{label}: not the golden result")

    out = {}
    for label, fn, key in (
            ("connected_components",
             lambda: gb.connected_components(g, device="cuda"), "cc"),
            ("sssp weighted", lambda: gb.sssp(g, 0, w, device="cuda"),
             "sssp")):
        check(label, fn())
        got, host_s, per, busy, seq = profile_launches(fn)
        check(label, got)
        tag = f"warm {label} RMAT {MIN_SCALE} ({gb.STEPS[key]} steps):"
        run = window(tag, host_s, per, busy, {"K33": K33_KERNELS})
        run["by_launch"] = [t / 1e3 for n, t in seq if n in K33_KERNELS]
        print(f"    {tag} K33 by launch (device ms, in order): "
              + ", ".join(f"{t:.4f}" for t in run["by_launch"]))
        run["steps"] = gb.STEPS[key]
        run["best_s"] = best_s(fn)
        print(f"    unprofiled best of 3 {run['best_s']:.4f} s")
        out[key] = run
    return out


def adg_part(degeneracy, build_csr, generate_rmat_el) -> dict:
    """K17 over the warm RMAT-18 avg eps 0.1 call, by kernel and by round;
    held on each round state (restored before each rep, untimed; L2
    flushed; CUDA events, the median of 10); a wrapper call's host time
    (20 calls on the first state, each alone); the best of 3."""
    g = build_csr(generate_rmat_el(ADG_SCALE, DEGREE, seed=SEED),
                  num_nodes=1 << ADG_SCALE)
    eps, boundary = ADG_RUN
    want = degeneracy.adg_ordering_rank(g, eps, boundary)

    def call():
        return degeneracy.adg_ordering_rank_device(g, eps, boundary,
                                                   device="cuda")

    degeneracy.reset_launches()
    if not np.array_equal(call(), want):
        raise SystemExit("device ADG differs from the host's")
    rounds = degeneracy.LAUNCHES["adg_round"]
    got, host_s, per, busy, seq = profile_launches(call)
    if not np.array_equal(got, want):
        raise SystemExit("the profiled device ADG differs from the host's")
    tag = f"warm adg_ordering_rank_device RMAT {ADG_SCALE} {boundary} {eps}:"
    run = window(tag, host_s, per, busy, {"K17": K17_KERNELS})
    run["rounds"] = rounds
    run["by_kernel"] = {k: {"ms": per[k][0] / 1e3, "launches": per[k][1]}
                        for k in K17_KERNELS if k in per}
    us = [t for n, t in seq if n in K17_KERNELS]
    if rounds and len(us) % rounds == 0:
        a = len(us) // rounds
        run["by_round"] = [sum(us[i * a:(i + 1) * a]) / 1e3
                           for i in range(rounds)]
        print(f"    {tag} by kernel: " + "; ".join(
            f"{k} {v['ms']:.4f} ms x{v['launches']}"
            for k, v in run["by_kernel"].items()) + "; by round: "
            + ", ".join(f"{t:.4f}" for t in run["by_round"]))
    else:
        print(f"    {tag} {len(us)} K17 launches traced for {rounds} "
              f"rounds: not split")
    indptr = torch.from_numpy(g.indptr).cuda()
    indices = torch.from_numpy(g.indices).cuda()
    deg = torch.from_numpy(g.degrees.astype(np.int64)).cuda()
    alive = torch.ones(g.num_nodes, dtype=torch.bool, device="cuda")
    deg_start, alive_start = deg.clone(), alive.clone()

    def one_round():
        return degeneracy.adg_round(indptr, indices, deg, alive,
                                    boundary=boundary, eps=eps)

    flush = torch.empty(1 << 26, dtype=torch.int32, device="cuda")
    held = []
    while bool(alive.any()):
        d0, a0 = deg.clone(), alive.clone()
        times = []
        for _ in range(10):
            deg.copy_(d0)
            alive.copy_(a0)
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            one_round()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        held.append(float(np.median(times)))
        deg.copy_(d0)
        alive.copy_(a0)
        one_round()  # leaves the next round's state
    host_s = 0.0
    for _ in range(20):
        deg.copy_(deg_start)
        alive.copy_(alive_start)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_round()
        host_s += time.perf_counter() - t0
    run["host_us"] = host_s / 20 * 1e6
    torch.cuda.synchronize()
    run["held_by_round"] = held
    run["held_ms"] = sum(held)
    print(f"    K17 held on the {len(held)} round states (each alone, L2 "
          f"flushed, CUDA events, median of 10): {sum(held):.4f} ms ("
          + ", ".join(f"{t:.4f}" for t in held) + f"); a wrapper call takes "
          f"{run['host_us']:.1f} µs of host time")
    run["best_s"] = best_s(call)
    print(f"    unprofiled best of 3 {run['best_s']:.4f} s")
    return run


def hub_part(tc, build_csr, generate_rmat_el) -> dict:
    """The RMAT-18 hub table as the package's TrianglePlan builds it (with
    build_hub_rows(out=) where the package has it, else K3, then the guard
    row's torch.cat), on the gather plan's own arrays: its device time
    under torch.profiler (every device event of the window) and held
    (alone, L2 flushed, CUDA events, the median of 10); K3's device time
    over one whole TrianglePlan build."""
    import inspect

    from gms_tpu_torch.bench.profiling import profile_window

    g = build_csr(generate_rmat_el(TC_SCALE, DEGREE, seed=SEED),
                  num_nodes=1 << TC_SCALE)
    plan = tc.TrianglePlan(g, device="cuda", materialize=False)
    nbr, hub_id, wide = plan.padded.nbr, plan.hub_id, plan.wide_ids
    hw = plan.hub_rows.shape[1]
    has_out = "out" in inspect.signature(tc.build_hub_rows).parameters

    def table():
        if has_out:
            return tc.build_hub_rows(nbr, hub_id, wide, hub_words=hw,
                                     out=torch.empty((wide.shape[0] + 1, hw),
                                                     dtype=torch.int32,
                                                     device="cuda"))
        rows = tc.build_hub_rows(nbr, hub_id, wide, hub_words=hw)
        return torch.cat([rows, rows.new_zeros((1, hw))])

    if not torch.equal(table(), plan.hub_rows):
        raise SystemExit("the hub table differs from the plan's")
    _, host_s, per, busy = profile_window(table)
    tag = f"the RMAT {TC_SCALE} hub table ({wide.shape[0]} x {hw} words):"
    run = window(tag, host_s, per, busy, {"K3": K3_KERNELS})
    run["table_device_ms"] = busy / 1e3
    run["by_kernel"] = {k: {"ms": t / 1e3, "launches": n}
                        for k, (t, n) in per.items()}
    flush = torch.empty(1 << 26, dtype=torch.int32, device="cuda")
    table()
    run["table_held_ms"] = held_ms(table, flush)
    print(f"    {tag} device {busy / 1e3:.4f} ms over "
          f"{sum(n for _, n in per.values())} device events ("
          + "; ".join(f"{k[:40]} {t / 1e3:.4f} ms x{n}"
                      for k, (t, n) in per.items())
          + f"); held {run['table_held_ms']:.4f} ms")
    del plan
    built, host_s, per, busy = profile_window(
        lambda: tc.TrianglePlan(g, device="cuda", materialize=False))
    if bool(built.hub_rows[-1].any()):
        raise SystemExit("the plan's guard row is not zero")
    del built
    run["build"] = window(f"one TrianglePlan build RMAT {TC_SCALE} (gather):",
                          host_s, per, busy, {"K3": K3_KERNELS})
    return run


if __name__ == "__main__":
    main()
