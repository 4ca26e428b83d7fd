"""The Bron–Kerbosch walks on the card, whole: K9 (bk_stack_machine) over a
warm fused call and K36 (bk_direct_stack) over a warm direct=True call at
RMAT-14 (average degree 16, seed 27491095, chip_smoke.py's phases 12 and 51),
each under torch.profiler (device time, launches, the device's idle share
over the call), then every job alone: its time by CUDA events and its
stats= run (the items its warps took, the children formed, the pivots taken
and the warps' cycle split: walking, pivot, children, leaf filter,
waiting), and K36 on the heaviest root of each direct job with W >= 512,
alone.

    python -m gms_tpu_torch.bench.bk_walk --label this

To compare two checkouts on one card, run the other's package with this
script in turns: PYTHONPATH=<other checkout> python
gms_tpu_torch/bench/bk_walk.py --label other. Needs a card; prints the
card's name and power limit, the ptxas report of both libraries where this
call built them, and one JSON object last.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

SCALE, DEGREE, SEED = 14, 16, 27491095
GOLDEN = 165_402_717  # maximal cliques of RMAT-14


def window(tag, host_s, per, busy, group) -> dict:
    """Prints a window's lines (profiling.window_lines, BK_GROUPS) and
    returns the figures of one group ("K9" or "K36"): its device ms and
    launches, the walk kernel's ms, the host s and the idle share."""
    from gms_tpu_torch.bench.profiling import BK_GROUPS, window_lines

    sums = window_lines(tag, host_s, per, busy, BK_GROUPS)
    ms, n = sums[group]
    walk = BK_GROUPS[group][0]
    return {"host_s": host_s, "ms": ms, "launches": n,
            "walk_ms": per.get(walk, [0.0, 0])[0] / 1e3,
            "idle": 1 - busy / 1e6 / host_s}


def split(stats) -> dict:
    cyc = stats["cycles"]
    tot = max(1, sum(cyc.values()))
    return {k: round(v / tot, 4) for k, v in cyc.items()}


def event_ms(fn) -> float:
    """One call of fn timed by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def job_line(tag, stats, ms, **kw) -> dict:
    """Prints and returns a job's time and its stats= counters."""
    counts = {k: v for k, v in stats.items() if k != "cycles"}
    out = dict(kw, ms=ms, **counts, cycles=sum(stats["cycles"].values()),
               split=split(stats))
    print(f"{tag}: {ms:.4f} ms, " + ", ".join(
        f"{k} {v}" for k, v in out.items() if k not in ("ms", "split"))
        + f", split {out['split']}")
    return out


def heaviest_root(bk, univ, depth, ww) -> dict:
    """K36 on a job's root with the most cliques, alone (the rest of the
    chunk dead): its time by CUDA events (median of 3) and its stats= run.
    One root's tree spread over every warp of the card: the walk itself,
    without the mix of roots."""
    live = univ[3]
    best, most = -1, -1
    for b in live.nonzero()[:, 0].tolist():
        one = torch.zeros_like(live)
        one[b] = True
        n = int(bk.bk_direct_stack(*univ[:3], one, depth=depth)[0])
        if n > most:
            best, most = b, n
    one = torch.zeros_like(live)
    one[best] = True
    alone = (*univ[:3], one)
    st = {}
    c, _ = bk.bk_direct_stack(*alone, depth=depth, stats=st)
    ms = sorted(event_ms(lambda: bk.bk_direct_stack(*alone, depth=depth))
                for _ in range(3))[1]
    return job_line(f"K36 W={32 * ww} heaviest root alone", st, ms,
                    W=32 * ww, root=best, cliques=int(c))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--label", default="")
    p.add_argument("--scale", type=int, default=SCALE)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bk_walk needs a CUDA device")

    import gms_tpu_torch
    from gms_tpu_torch import _kernels
    from gms_tpu_torch.algorithms import bron_kerbosch as bk
    from gms_tpu_torch.algorithms import k_clique as kc
    from gms_tpu_torch.bench.profiling import profile_window
    from gms_tpu_torch.io.builder import build_csr
    from gms_tpu_torch.io.generators import generate_rmat_el
    from gms_tpu_torch.preprocessing import degeneracy

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}; package {gms_tpu_torch.__file__}")
    for name, report in _kernels.build().items():
        if name in ("bk_stack", "bk_direct"):
            print(f"ptxas {name}:\n{report}")
    g = build_csr(generate_rmat_el(args.scale, DEGREE, seed=SEED),
                  num_nodes=1 << args.scale)
    rank, _ = degeneracy.degeneracy_ordering_rank(g)
    out = {"label": args.label, "card": card}
    for key, kw in (("fused", {}), ("direct", {"direct": True})):
        first = bk.bron_kerbosch(g, device="cuda", rank=rank, **kw)
        n, host_s, per, busy = profile_window(
            lambda: bk.bron_kerbosch(g, device="cuda", rank=rank, **kw))
        if args.scale == SCALE and not (n == first == GOLDEN):
            raise SystemExit(f"{key} call: {n}, first {first} != {GOLDEN}")
        out[key] = window(f"warm {key} call, count {n}:", host_s, per, busy,
                          "K36" if key == "direct" else "K9")

    # every job's stats= run: items and the cycle split
    plan = bk.BKPlan(g, rank, np.arange(g.num_nodes, dtype=np.int32),
                     device="cuda")
    nbr = plan.padded.nbr
    total, jobs = 0, []
    for chunk, ww, in_w in plan.jobs:
        adj, s0 = kc.build_local_adj(nbr, chunk, w_words=ww)
        m, wv = bk.hub_cover_bits(nbr, plan.lo_indptr, plan.lo_cols, chunk,
                                  in_width=in_w, w_words=ww)
        univ = (bk.symmetrize_bits(adj), s0, chunk != nbr.shape[0], m, wv)
        st = {}
        c = int(bk.bk_stack_machine(*univ, stats=st))
        total += c
        ms = event_ms(lambda: bk.bk_stack_machine(*univ))
        jobs.append(job_line(f"K9 job W={32 * ww} IN={in_w}", st, ms,
                             W=32 * ww, IN=in_w, cliques=c))
    out["fused_jobs"] = jobs
    pg_jobs = []
    from gms_tpu_torch.graphs.tiles import PaddedGraph
    n = g.num_nodes
    pg = PaddedGraph.from_csr(g, device="cuda", lane=32)
    rank_pad = np.full(pg.v_pad + 1, np.iinfo(np.int32).max, np.int32)
    rank_pad[:n] = rank
    rank_pad = torch.from_numpy(rank_pad).cuda()
    e = g.edge_array()
    higher = rank[e[:, 1]] > rank[e[:, 0]]
    core = int(np.bincount(e[:, 0][higher], minlength=n).max(initial=1))
    roots = np.nonzero(g.degrees <= 1024)[0].astype(np.int32)
    heavy = []
    for chunk, ww in kc.plan_tier_chunks(g.degrees, roots, np.int32(pg.v_pad),
                                         root_chunk=bk.DEFAULT_ROOT_CHUNK):
        chunk = torch.from_numpy(chunk).cuda()
        adj, _ = kc.build_local_adj(pg.nbr, chunk, w_words=ww)
        cand, fini = bk.init_items(pg.nbr, rank_pad, chunk, w_words=ww)
        univ = (adj, cand, fini, chunk != pg.v_pad)
        depth = min(32 * ww, core) + 2
        st = {}
        c, ovf = bk.bk_direct_stack(*univ, depth=depth, stats=st)
        ms = event_ms(lambda: bk.bk_direct_stack(*univ, depth=depth))
        pg_jobs.append(job_line(f"K36 job W={32 * ww}", st, ms, W=32 * ww,
                                cliques=int(c), overflow=bool(ovf)))
        if ww >= 16:  # W >= 512: the root with the most cliques, alone
            heavy.append(heaviest_root(bk, univ, depth, ww))
    out["direct_jobs"] = pg_jobs
    out["direct_heaviest_roots"] = heavy
    out["fused_jobs_total"] = total
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
