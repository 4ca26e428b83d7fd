"""Link prediction benchmark (role of link_prediction.cc:80-101: AUC benches
for 5 metrics x test rates/false-link rates + a ranking bench;
--param samples=100000) — the port of gms_tpu/bench/link_prediction.py, with
its params and labels (which carry no device suffix there either).

    python -m gms_tpu_torch.bench.link_prediction -g kronecker 16 -n 3 --device cuda
"""

from __future__ import annotations

from gms_tpu_torch.algorithms import link_prediction as lp
from gms_tpu_torch.harness import benchmark, cli
from gms_tpu_torch.harness.printer import print_param


def main(argv=None):
    p = (cli.Parser("link prediction")
         .add_param("samples", 100000)
         .add_param("test-rate", 0.01)
         .add_param("false-rate", 0.0)
         .add_param("q-best", 100))
    args, g = p.parse_and_load(argv)
    samples = int(args.params["samples"])
    test_rate = float(args.params["test-rate"])
    false_rate = float(args.params["false-rate"])

    m = g.num_edges_undirected
    n_test = max(1, int(m * test_rate))
    train, test = lp.extract_random_test_edges(g, n_test, seed=0)
    if false_rate > 0:
        train = lp.add_false_links(train, int(m * false_rate), test)

    for metric in ("jaccard", "overlap", "adamic_adar", "resource",
                   "common_neighbors"):
        def kern(_g, metric=metric):
            return lp.score_auc(g, train, test, samples, metric=metric,
                                device=args.device)

        def verify(_g, auc):
            print_param(f"auc_{metric}", auc)
            return 0.0 <= auc <= 1.0

        benchmark.benchmark_kernel(
            args, g, kern,
            verifier=verify if args.verify else None,
            labels=(f"lp-auc-{metric}", samples))

    q = int(args.params["q-best"])
    benchmark.benchmark_kernel(
        args, g,
        lambda _g: lp.link_prediction_similarity(train, q, metric="jaccard",
                                                 device=args.device),
        labels=("lp-rank-jaccard", q))


if __name__ == "__main__":
    main()
