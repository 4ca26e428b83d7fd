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
512). Each call under torch.profiler (the
kernel's device time and launches, each launch's device time in launch
order, read by bench/profiling.py's profile_launches, the host time and
the device's idle share) and, unprofiled, the best of 3.

    python -m gms_tpu_torch.bench.dense_vertex --label this [--parts kc,pv,color,ring]

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
PARTS = ("kc", "pv", "color", "ring")


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


if __name__ == "__main__":
    main()
