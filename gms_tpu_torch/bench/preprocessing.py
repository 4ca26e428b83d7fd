"""Preprocessing benchmark (role of preprocessing.cc:17-122 and
preprocessing_approx_variants.cc: ordering suites + ADG epsilon/boundary
sweep with core-number accuracy stats) — the port of
gms_tpu/bench/preprocessing.py, with its labels. These orderings run on the
host in numpy, as in gms_tpu, so `--device` (the port's common flag) does
not change them; the device ADG is `degeneracy.adg_ordering_rank_device`.

    python -m gms_tpu_torch.bench.preprocessing -g kronecker 14 -n 3 -v
"""

from __future__ import annotations

from gms_tpu_torch.harness import benchmark, cli
from gms_tpu_torch.harness.printer import print_param
from gms_tpu_torch.preprocessing import degeneracy


def main(argv=None):
    args, g = cli.Parser("vertex-ordering preprocessing").parse_and_load(argv)

    benchmark.benchmark_kernel(
        args, g, lambda g: degeneracy.degree_ordering_rank(g),
        labels=("pp-degree",))
    benchmark.benchmark_kernel(
        args, g, lambda g: degeneracy.degeneracy_ordering_rank(g)[0],
        labels=("pp-degeneracy-exact",))

    for boundary in ("avg", "min", "prob_min", "prob_median"):
        for eps in (0.01, 0.1, 0.5):
            def kern(g, b=boundary, e=eps):
                return degeneracy.adg_ordering_rank(g, e, boundary=b)

            def verify(g, rank, e=eps):
                stats = degeneracy.evaluate_ordering(g, rank)
                print_param("adg_ratio", stats["ratio"])
                # 2(2+eps)-approximation bound of ADG (with slack for the
                # probabilistic boundary estimates)
                return stats["ratio"] <= 2 * (2.0 + e) + 1

            benchmark.benchmark_kernel(
                args, g, kern,
                verifier=verify if args.verify else None,
                labels=(f"pp-adg-{boundary}-eps{eps}",))


if __name__ == "__main__":
    main()
