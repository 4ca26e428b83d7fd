"""k-clique-star listing benchmark (role of k_clique_star_list.cc; --param
clique-size, default 3) — the port of gms_tpu/bench/k_clique_star.py. Each
trial runs kclique_star_list in count mode; -v checks the count and the
star total against the brute-force oracle, which enumerates every k-subset
(small graphs only).

    python -m gms_tpu_torch.bench.k_clique_star -g kronecker 12 -n 3 --device cuda -p clique-size=4
"""

from __future__ import annotations

from gms_tpu_torch.algorithms import k_clique_star as kcs
from gms_tpu_torch.harness import benchmark, cli
from gms_tpu_torch.harness.printer import print_param


def main(argv=None):
    p = cli.Parser("k-clique-star listing").add_param("clique-size", 3)
    args, g = p.parse_and_load(argv)
    k = int(args.params["clique-size"])

    def kern(g):
        return kcs.kclique_star_list(g, k, device=args.device, mode="count")

    def verify(g, res):
        n, total = res
        print_param("kcs_cliques", n)
        print_param("kcs_star_total", total)
        want = kcs.kclique_star_oracle(g, k)
        return n == len(want) and total == sum(len(s) for _, s in want)

    benchmark.benchmark_kernel(
        args, g, kern,
        verifier=verify if args.verify else None,
        labels=(f"kcstar-k{k}-count-{args.device}",),
        # PAPIW analog: derived throughput counters per trial
        counters=lambda r, s: {"kcstar_cliques_per_sec": r[0] / s,
                               "kcstar_star_total": int(r[1])})


if __name__ == "__main__":
    main()
