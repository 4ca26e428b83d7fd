"""K4 (build_local_adj) and K22 (color_jp) on the card, over whole warm calls.

K4 (and K37 beside it) over one warm RMAT-16 k=5 `sharded_kclique_count`
call at a world of one (no process group; chip_smoke.py's phase 53 runs it
over NCCL), over the warm RMAT-16 k=5 `kclique_count` and RMAT-14 fused
`bron_kerbosch` calls, and held: `kclique_count`'s chunks and the sharded
call's first chunk at its global width, each launched alone in passes of
HELD_PASSES. K22 over one warm strict JP-LF `jones_plassmann` call at
RMAT-16 (phase 38), its host tier builds timed inside the call, and, where
the package has jp_run, each dispatch's launch by CUDA events.
Each call and pass under torch.profiler: the kernel's device time and
launches, the host time and the device's idle share; each call also
unprofiled, the best of 3.

    python -m gms_tpu_torch.bench.adj_jp --label this

To compare two checkouts on one card, run the other's package with this
script in turns: PYTHONPATH=<other checkout> python
gms_tpu_torch/bench/adj_jp.py --label other. A checkout whose
csrc/local_adj.cu is another commit's, the rest this one's, tells the
kernel's share of a change from the sharded call's (which builds a chunk's
adjacency once). Needs a card; prints the card's name and power limit, the
ptxas report of the two libraries where this call built them, and one JSON
object last.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

SEED, DEGREE = 27491095, 16
KC_SCALE, KC_K, KC_GOLDEN = 16, 5, 4_600_426_489
BK_SCALE, BK_GOLDEN = 14, 165_402_717
JP_SCALE, JP_DIGEST = 16, "8c0f69ed106f236d"
ROOT_CHUNK = 256
HELD_PASSES = 10
# K37's device functions (csrc/kc_expand.cu)
K37 = ("expand_kernel", "clear_kernel")


def k4_names(per) -> tuple:
    return tuple(k for k in sorted(per) if k.startswith("local_adj"))


def k22_names(per) -> tuple:
    return tuple(k for k in sorted(per) if k.startswith("jp_"))


def window(tag, host_s, per, busy, groups) -> dict:
    from gms_tpu_torch.bench.profiling import window_lines

    sums = window_lines(tag, host_s, per, busy, groups)
    return {"host_s": host_s, "idle": 1 - busy / 1e6 / host_s,
            **{k: {"ms": ms, "launches": n} for k, (ms, n) in sums.items()}}


def best_s(fn, reps: int = 3) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return min(times)


def sharded_plan(g, k, rank):
    """(padded DAG, global W words, the chunks of ROOT_CHUNK roots, padded
    with the guard id) as sharded_kclique_count cuts them at a world of
    one."""
    from gms_tpu_torch.graphs.tiles import PaddedGraph
    from gms_tpu_torch.preprocessing import orient

    dag = orient.orient(g, rank)
    pg = PaddedGraph.from_csr(dag, device="cuda", lane=32)
    roots = np.nonzero(np.asarray(dag.degrees) >= k - 1)[0].astype(np.int32)
    chunks = []
    for s in range(0, len(roots), ROOT_CHUNK):
        c = roots[s:s + ROOT_CHUNK]
        c = np.concatenate([c, np.full(ROOT_CHUNK - len(c), pg.v_pad,
                                       np.int32)])
        chunks.append(torch.from_numpy(c).cuda())
    return pg, pg.d_pad // 32, chunks


def held_k4(tag, jobs) -> dict:
    """K4 launched alone on each (nbr, roots, w_words) of jobs, one warm
    pass and then HELD_PASSES under torch.profiler: its device ms a pass
    and its launches in the window."""
    from gms_tpu_torch.algorithms import k_clique as kc
    from gms_tpu_torch.bench.profiling import profile_window

    def one_pass():
        for nbr, roots, ww in jobs:
            kc.build_local_adj(nbr, roots, w_words=ww)

    one_pass()
    _, host_s, per, busy = profile_window(
        lambda: [one_pass() for _ in range(HELD_PASSES)])
    names = k4_names(per)
    ms = sum(per[k][0] for k in names) / 1e3 / HELD_PASSES
    n = sum(per[k][1] for k in names)
    print(f"    K4 held, {tag}: device {ms:.4f} ms a pass of {len(jobs)} "
          f"launches ({n} launches in {HELD_PASSES} passes traced); window "
          f"host {host_s:.4f} s, idle share {1 - busy / 1e6 / host_s:.4f}")
    return {"ms": ms, "launches": n, "passes": HELD_PASSES}


def jp_dispatches(gc, jp, digest) -> list:
    """K22's cooperative launch timed dispatch by dispatch (CUDA events
    around each jp_run of a warm strict JP-LF call): [(ms, rounds, buckets,
    rows)]."""
    inner, seen = gc.jp_run, []

    def timed(colors, priority, tiers, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got = inner(colors, priority, tiers, **kw)
        end.record()
        seen.append((start, end, got[1], len(tiers),
                     sum(int(i.shape[0]) for i, _ in tiers)))
        return got

    gc.jp_run = timed
    try:
        if digest(jp()) != JP_DIGEST:
            raise SystemExit("strict JP-LF by dispatch: other colors")
    finally:
        gc.jp_run = inner
    torch.cuda.synchronize()
    rows = [(s.elapsed_time(e), int(r), nb, nr) for s, e, r, nb, nr in seen]
    print(f"    K22 by dispatch (ms, rounds, buckets, rows): {rows}; "
          f"{sum(r[0] for r in rows):.4f} ms")
    return rows


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--label", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("adj_jp needs a CUDA device")

    import hashlib

    import gms_tpu_torch
    from gms_tpu_torch import _kernels
    from gms_tpu_torch.algorithms import bron_kerbosch as bk
    from gms_tpu_torch.algorithms import coloring as gc
    from gms_tpu_torch.algorithms import k_clique as kc
    from gms_tpu_torch.bench.profiling import profile_window
    from gms_tpu_torch.io.builder import build_csr
    from gms_tpu_torch.io.generators import generate_rmat_el
    from gms_tpu_torch.parallel import multi
    from gms_tpu_torch.preprocessing import degeneracy

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}; package {gms_tpu_torch.__file__}")
    built = _kernels.build()
    for name in ("local_adj", "color_jp"):
        if name in built:
            print(f"ptxas {name}:\n{built[name]}")
    out = {"label": args.label, "card": card}

    # K4: the sharded call, held chunks, kclique_count
    g = build_csr(generate_rmat_el(KC_SCALE, DEGREE, seed=SEED),
                  num_nodes=1 << KC_SCALE)
    rank, _ = degeneracy.degeneracy_ordering_rank(g)

    def sharded(stats=None):
        return multi.sharded_kclique_count(g, KC_K, rank=rank, stats=stats)

    stats = {}
    kc.reset_launches()
    if sharded(stats) != KC_GOLDEN:
        raise SystemExit("sharded call: not the golden count")
    first = dict(kc.LAUNCHES)
    n, host_s, per, busy = profile_window(sharded)
    if n != KC_GOLDEN:
        raise SystemExit(f"profiled sharded call: {n}")
    run = window(f"warm sharded RMAT {KC_SCALE} k={KC_K} call:", host_s,
                 per, busy, {"K4": k4_names(per), "K37": K37})
    run.update(stats=stats, launches=first, best_s=best_s(sharded))
    print(f"    stats {stats}; a call's launches {first}; unprofiled best "
          f"of 3 {run['best_s']:.4f} s")
    out["sharded"] = run

    pg, ww, chunks = sharded_plan(g, KC_K, rank)
    out["held_sharded_first_chunk"] = held_k4(
        f"the sharded call's first chunk (W={32 * ww}, C={ROOT_CHUNK})",
        [(pg.nbr, chunks[0], ww)])
    del pg, chunks
    kpg, kchunks = kc.plan_chunks(g, KC_K, device="cuda", rank=rank)
    out["held_kclique_chunks"] = held_k4(
        f"kclique_count's {len(kchunks)} chunks",
        [(kpg.nbr, c, cww) for c, cww in kchunks])
    del kpg, kchunks

    def single():
        return kc.kclique_count(g, KC_K, device="cuda", rank=rank)

    single()
    n, host_s, per, busy = profile_window(single)
    if n != KC_GOLDEN:
        raise SystemExit(f"kclique_count: {n}")
    out["kclique_count"] = window(
        f"warm kclique_count RMAT {KC_SCALE} k={KC_K}:", host_s, per, busy,
        {"K4": k4_names(per)})
    out["kclique_count"]["best_s"] = best_s(single)
    del g

    # K4 on the fused Bron-Kerbosch call
    g = build_csr(generate_rmat_el(BK_SCALE, DEGREE, seed=SEED),
                  num_nodes=1 << BK_SCALE)
    rank, _ = degeneracy.degeneracy_ordering_rank(g)

    def fused():
        return bk.bron_kerbosch(g, device="cuda", rank=rank)

    if fused() != BK_GOLDEN:
        raise SystemExit("fused BK: not the golden count")
    n, host_s, per, busy = profile_window(fused)
    if n != BK_GOLDEN:
        raise SystemExit(f"profiled fused BK: {n}")
    out["bk_fused"] = window(f"warm fused bron_kerbosch RMAT {BK_SCALE}:",
                             host_s, per, busy, {"K4": k4_names(per)})
    del g

    # K22 on strict JP-LF, the tier builds timed inside the call
    g = build_csr(generate_rmat_el(JP_SCALE, DEGREE, seed=SEED),
                  num_nodes=1 << JP_SCALE)
    tier_s = []
    plain_tiers = gc._TierGraph

    class TimedTiers(plain_tiers):
        def __init__(self, *a, **kw):
            t0 = time.perf_counter()
            super().__init__(*a, **kw)
            tier_s.append(time.perf_counter() - t0)

        def to(self, *a, **kw):
            t0 = time.perf_counter()
            out = super().to(*a, **kw)
            tier_s[-1] += time.perf_counter() - t0
            return out

    def jp():
        return gc.jones_plassmann(g, priority="degree", device="cuda")

    def digest(c):
        return hashlib.sha256(np.ascontiguousarray(
            c, dtype=np.int32).tobytes()).hexdigest()[:16]

    if digest(jp()) != JP_DIGEST:
        raise SystemExit("strict JP-LF: not gms_tpu's colors")
    gc.reset_launches()
    gc._TierGraph = TimedTiers
    try:
        c, host_s, per, busy = profile_window(jp)
    finally:
        gc._TierGraph = plain_tiers
    if digest(c) != JP_DIGEST:
        raise SystemExit("profiled strict JP-LF: not gms_tpu's colors")
    run = window(f"warm strict JP-LF RMAT {JP_SCALE}:", host_s, per, busy,
                 {"K22": k22_names(per)})
    run.update(rounds=gc.ROUNDS["jones_plassmann"], dispatches=len(tier_s),
               tier_build_s=sum(tier_s), launches=dict(gc.LAUNCHES),
               best_s=best_s(jp))
    print(f"    {run['rounds']} rounds in {run['dispatches']} dispatches; "
          f"host tier builds and copies {run['tier_build_s']:.4f} s inside "
          f"the call; launches {run['launches']}; unprofiled best of 3 "
          f"{run['best_s']:.4f} s")
    out["jp_lf"] = run
    if hasattr(gc, "jp_run"):
        out["jp_by_dispatch"] = jp_dispatches(gc, jp, digest)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
