"""Triangle counting benchmark (role of triangle_count.cc:22-48) — the port
of gms_tpu/bench/triangle_count.py: the tiered total count, then the
per-vertex counts.

    python -m gms_tpu_torch.bench.triangle_count -g kronecker 16 -n 3 -v
"""

from __future__ import annotations

import numpy as np

from gms_tpu_torch.algorithms import triangle_count as tc
from gms_tpu_torch.harness import benchmark, cli


def main(argv=None):
    args, g = cli.Parser("triangle counting").parse_and_load(argv)

    def verify(g, result):
        return int(result) == tc.triangle_count_oracle(g)

    state = {}

    def build(g):
        state["plan"] = tc.TrianglePlan(g, device=args.device)
        return state["plan"]

    benchmark.benchmark_kernel_bk(
        args, g,
        build=build,
        kernel=lambda plan: plan.run(),
        verifier=verify if args.verify else None,
        labels=(f"tc-total-tiered-{args.device}",),
        # PAPIW analog: modeled operand traffic -> achieved GB/s
        counters=lambda r, s: {
            "tc_edges_per_sec": g.num_edges_undirected / s,
            "tc_model_gbps": state["plan"].traffic_bytes() / s / 1e9},
    )

    def pv_verify(g, result):
        return np.array_equal(result, tc.triangle_count_per_vertex_oracle(g))

    benchmark.benchmark_kernel(
        args, g, lambda g: tc.triangle_count_per_vertex(g, device=args.device),
        verifier=pv_verify if args.verify else None,
        labels=(f"tc-vertex-{args.device}",),
    )


if __name__ == "__main__":
    main()
