"""Maximal clique enumeration benchmark (role of
maximal_clique_enum_bron_kerbosch.cc:31-93: the BK-GMS-{ADG,DEG,DGR,SG}
suite) — the port of gms_tpu/bench/bron_kerbosch.py. Each label runs one
ordering; the ordering is computed inside each trial, as there.

    python -m gms_tpu_torch.bench.bron_kerbosch -g kronecker 14 -n 3 -v --device cuda
"""

from __future__ import annotations

from gms_tpu_torch.algorithms import bron_kerbosch as bk
from gms_tpu_torch.harness import benchmark, cli


def main(argv=None):
    args, g = cli.Parser("maximal clique enumeration").parse_and_load(argv)

    def verify(g, result):
        return int(result) == len(bk.bron_kerbosch_simple(g))

    for label, ordering in (
        ("BK-GMS-ADG", "adg"),
        ("BK-GMS-DEG", "degeneracy"),
        ("BK-GMS-DGR", "degree"),
        ("BK-GMS-SG", "id"),
    ):
        benchmark.benchmark_kernel(
            args, g,
            kernel=lambda g, o=ordering: bk.bron_kerbosch(
                g, device=args.device, ordering=o),
            verifier=verify if args.verify else None,
            labels=(f"{label}-{args.device}",),
            # PAPIW analog: derived throughput counters per trial
            counters=lambda r, s: {"bk_cliques": int(r),
                                   "bk_cliques_per_sec": int(r) / s},
        )


if __name__ == "__main__":
    main()
