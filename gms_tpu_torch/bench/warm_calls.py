"""Warm call times of the launch-bound loops: the GAPBS calls at RMAT-18 and
the coloring round loops at RMAT-16 (average degree 16, seed 27491095, the
graphs of chip_smoke.py's phases 37 and 47), each the best of TRIALS after
one first call, host clock to the read-back. Each call launches tens
to hundreds of small kernels with a read-back a level or round, so what a
launch costs on the host shows here first; 1,000 launches of one small
kernel show it alone.

    python -m gms_tpu_torch.bench.warm_calls --label this

To compare two checkouts on one card, time the other checkout's package
(it must have algorithms/gapbs.py) with this script, in turns:

    PYTHONPATH=<other checkout> python gms_tpu_torch/bench/warm_calls.py \\
        --label other

Prints one JSON object: the label, the package's path, and seconds a call.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import time

import torch

GAPBS_SCALE, COLOR_SCALE, DEGREE, SEED = 18, 16, 16, 27491095
TRIALS = 5


def best_of(fn, trials: int, sync) -> float:
    """The least of `trials` host-clock times of fn(), after one untimed
    first call."""
    fn()
    sync()
    times = []
    for _ in range(trials):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
    return min(times)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--label", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import gms_tpu_torch
    from gms_tpu_torch.algorithms import coloring as gc
    from gms_tpu_torch.algorithms import gapbs as gb
    from gms_tpu_torch.io.builder import build_csr
    from gms_tpu_torch.io.generators import generate_rmat_el

    dev = args.device
    sync = (torch.cuda.synchronize if torch.device(dev).type == "cuda"
            else lambda: None)
    gg = build_csr(generate_rmat_el(GAPBS_SCALE, DEGREE, seed=SEED),
                   num_nodes=1 << GAPBS_SCALE)
    gcol = build_csr(generate_rmat_el(COLOR_SCALE, DEGREE, seed=SEED),
                     num_nodes=1 << COLOR_SCALE)
    # 1,000 launches of K33 on a 2-vertex graph: the host's cost a launch
    tiny = (torch.tensor([0, 1, 2], device=dev),
            torch.tensor([1, 0], dtype=torch.int32, device=dev),
            torch.tensor([0, 1], dtype=torch.int32, device=dev))

    # its row schedule built once, where this package's cc_step takes one
    once = ({"schedule": gb.build_row_schedule(tiny[0])}
            if "schedule" in inspect.signature(gb.cc_step).parameters else {})

    def launches():
        for _ in range(1000):
            gb.cc_step(*tiny, **once)

    calls = {
        "cc_step x 1000, 2 vertices": launches,
        "bfs": lambda: gb.bfs(gg, 0, device=dev),
        "bfs pull-only": lambda: gb.bfs(gg, 0, direction_optimizing=False,
                                        device=dev),
        "connected_components": lambda: gb.connected_components(
            gg, device=dev),
        "sssp unit": lambda: gb.sssp(gg, 0, device=dev),
        "pagerank": lambda: gb.pagerank(gg, iters=20, device=dev),
        "betweenness_centrality 64": lambda: gb.betweenness_centrality(
            gg, num_samples=64, seed=0, device=dev),
        "jones_plassmann speculative lf": lambda: gc.jones_plassmann(
            gcol, speculative=True, priority="degree", device=dev),
        "jones_plassmann strict lf": lambda: gc.jones_plassmann(
            gcol, priority="degree", device=dev),
        "johansson": lambda: gc.johansson(gcol, device=dev),
    }
    out = {"label": args.label,
           "package": os.path.dirname(gms_tpu_torch.__file__),
           "seconds": {name: best_of(fn, TRIALS, sync)
                       for name, fn in calls.items()}}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
