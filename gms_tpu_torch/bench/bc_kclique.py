"""K34 (bc_forward, bc_backward) and K6 (kc_stack_count) on the card, whole.

K34 over one warm `betweenness_centrality(g, num_samples=64, seed=0)` call
at RMAT-18 (average degree 16, seed 27491095; chip_smoke.py's phase 48),
K6 over the warm `kclique_count` calls at RMAT-13 k=6 and RMAT-12 k=8
(degeneracy order; phase 8), each call under torch.profiler: the kernel's
device time and launches, the call's host time and the device's idle
share. Then each main-path chunk's K6 time alone by CUDA events (median of
3), with its width W and roots C.

    python -m gms_tpu_torch.bench.bc_kclique --label this

To compare two checkouts on one card, run the other's package with this
script in turns: PYTHONPATH=<other checkout> python
gms_tpu_torch/bench/bc_kclique.py --label other. Needs a card; prints the
card's name and power limit, the ptxas report of the two libraries where
this call built them, and one JSON object last.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

SEED, DEGREE = 27491095, 16
BC_SCALE, BC_SAMPLES = 18, 64
KC_RUNS = ((13, 6, 681_595_966), (12, 8, 2_339_107_240))
# K6's device functions besides its walk (the walk's name starts "stack_")
K6_AUX = ("count_kernel", "root_offsets_kernel")


def groups(per) -> dict:
    """The profiled window's K34 and K6 kernels by bare name."""
    names = sorted(per)
    return {
        "K34 forward": tuple(k for k in names if k.startswith("bc_forward")),
        "K34 backward": tuple(k for k in names
                              if k.startswith("bc_backward")),
        "K6": tuple(k for k in names
                    if k in K6_AUX or k.startswith("stack_")),
    }


def window(tag, host_s, per, busy) -> dict:
    from gms_tpu_torch.bench.profiling import window_lines

    sums = window_lines(tag, host_s, per, busy, groups(per))
    return {"host_s": host_s, "idle": 1 - busy / 1e6 / host_s,
            **{k: {"ms": ms, "launches": n} for k, (ms, n) in sums.items()}}


def event_ms(fn, reps: int = 3) -> float:
    """Median over reps calls of fn, each timed by CUDA events."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--label", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bc_kclique needs a CUDA device")

    import gms_tpu_torch
    from gms_tpu_torch import _kernels
    from gms_tpu_torch.algorithms import gapbs
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
    built = _kernels.build(["gapbs_bc", "kclique_stack", "gapbs_bfs",
                            "local_adj", "kclique_dense"])
    for name in ("gapbs_bc", "kclique_stack"):
        if name in built:
            print(f"ptxas {name}:\n{built[name]}")
    out = {"label": args.label, "card": card}

    g = build_csr(generate_rmat_el(BC_SCALE, DEGREE, seed=SEED),
                  num_nodes=1 << BC_SCALE)

    def bc():
        return gapbs.betweenness_centrality(g, num_samples=BC_SAMPLES,
                                            seed=0, device="cuda")

    first = bc()
    again, host_s, per, busy = profile_window(bc)
    out["bc"] = window(f"warm BC call at RMAT {BC_SCALE}, {BC_SAMPLES} "
                       f"sources:", host_s, per, busy)
    out["bc"]["same_bits"] = bool((again == first).all())
    print(f"    BC: the same bits on a second run: {out['bc']['same_bits']}")
    best = []
    for _ in range(3):
        t0 = time.perf_counter()
        bc()
        best.append(time.perf_counter() - t0)
    out["bc"]["host_unprofiled_s"] = min(best)
    del g

    out["kclique"] = []
    for scale, k, golden in KC_RUNS:
        g = build_csr(generate_rmat_el(scale, DEGREE, seed=SEED),
                      num_nodes=1 << scale)
        rank, _ = degeneracy.degeneracy_ordering_rank(g)

        def call():
            return kc.kclique_count(g, k, device="cuda", rank=rank)

        if call() != golden:
            raise SystemExit(f"RMAT {scale} k={k}: not {golden}")
        n, host_s, per, busy = profile_window(call)
        if n != golden:
            raise SystemExit(f"profiled RMAT {scale} k={k}: {n}")
        run = window(f"warm kclique_count RMAT {scale} k={k}:", host_s, per,
                     busy)
        pg, chunks = kc.plan_chunks(g, k, device="cuda", rank=rank)
        run["chunks"] = []
        for chunk, ww in chunks:
            adj, s0 = kc.build_local_adj(pg.nbr, chunk, w_words=ww)
            cliques = int(kc.kc_stack_count(adj, s0, k=k))
            ms = event_ms(lambda: kc.kc_stack_count(adj, s0, k=k))
            run["chunks"].append({"W": 32 * ww, "C": int(chunk.numel()),
                                  "cliques": cliques, "ms": ms})
            print(f"    RMAT {scale} k={k} chunk W={32 * ww} "
                  f"C={chunk.numel()}: K6 {ms:.4f} ms (CUDA events, median "
                  f"of 3), {cliques} cliques")
        out["kclique"].append(dict(run, scale=scale, k=k))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
