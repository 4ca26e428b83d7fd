"""Subgraph isomorphism benchmark (role of
vf2/parallel/subgraphiso_vf2_parallel.cpp:13-64 with --param pattern-file,
util/command_line.hpp:14-38) — the port of gms_tpu/bench/subgraph_iso.py:
find-first (limit=1) in hybrid mode, labelled vf2-first-<device>.

    python -m gms_tpu_torch.bench.subgraph_iso -g kronecker 14 -n 3 -v --device cuda
"""

from __future__ import annotations

import numpy as np

from gms_tpu_torch.algorithms import subgraph_iso as si
from gms_tpu_torch.harness import benchmark, cli
from gms_tpu_torch.io.builder import build_csr


def main(argv=None):
    p = (cli.Parser("subgraph isomorphism (VF2)")
         .add_param("pattern-file", "")
         .add_param("induced", 0))
    args, g = p.parse_and_load(argv)
    pat_file = args.params["pattern-file"]
    induced = bool(int(args.params["induced"]))
    if pat_file:
        from gms_tpu_torch.io.readers import read_graph

        pattern = read_graph(pat_file)
    else:  # default pattern: a triangle
        pattern = build_csr(np.array([[0, 1], [1, 2], [0, 2]], dtype=np.int64))

    def kern(g):
        return si.subgraph_isomorphism(g, pattern, induced=induced, limit=1,
                                       device=args.device)

    def verify(g, res):
        return len(res) == 0 or si.verify_mapping(g, pattern, res[0],
                                                  induced=induced)

    benchmark.benchmark_kernel(
        args, g, kern,
        verifier=verify if args.verify else None,
        labels=(f"vf2-first-{args.device}",))


if __name__ == "__main__":
    main()
