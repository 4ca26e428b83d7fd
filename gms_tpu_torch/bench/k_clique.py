"""k-clique counting benchmark (role of k_clique_count_set_based.cc:27-47 and
k_clique_list_danisch_node_parallel.cc:12-51; --param clique-size, default
8) — the port of gms_tpu/bench/k_clique.py. Three runs, as there: the exact
degeneracy ordering, then ADG with eps 0.1 and 0.01, each timed per trial
as preprocessing.

    python -m gms_tpu_torch.bench.k_clique -g kronecker 12 -n 3 -v --device cuda
"""

from __future__ import annotations

from gms_tpu_torch.algorithms import k_clique
from gms_tpu_torch.harness import benchmark, cli
from gms_tpu_torch.preprocessing import degeneracy


def main(argv=None):
    p = cli.Parser("k-clique counting").add_param("clique-size", 8)
    args, g = p.parse_and_load(argv)
    k = int(args.params["clique-size"])

    def verify(g, result):
        return int(result) == k_clique.kclique_count_oracle(g, k)

    def count(g, rank):
        return k_clique.kclique_count(g, k, device=args.device, rank=rank)

    def counters(r, s):  # PAPIW analog: derived throughput per trial
        return {f"kclique{k}_count": int(r), f"kclique{k}_per_sec": int(r) / s}

    runs = [("degeneracy", lambda g: degeneracy.degeneracy_ordering_rank(g)[0])]
    # ADG preprocessing variant (the reference's epsilon sweep headline)
    runs += [(f"adg-eps{eps}",
              lambda g, e=eps: degeneracy.adg_ordering_rank(g, e))
             for eps in (0.1, 0.01)]
    for label, preprocess in runs:
        benchmark.benchmark_kernel_bk_pp(
            args, g,
            build=lambda g: g,
            preprocess=preprocess,
            kernel=count,
            verifier=verify if args.verify else None,
            labels=(f"kclique-k{k}-{label}-{args.device}",),
            counters=counters,
        )


if __name__ == "__main__":
    main()
