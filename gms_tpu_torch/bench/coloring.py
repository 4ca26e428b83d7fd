"""Graph coloring benchmark (role of coloring.cc:32-153: per-trial color
counts and validity across algorithm variants) — the port of
gms_tpu/bench/coloring.py, with its six variants and labels (which carry no
device suffix there either).

    python -m gms_tpu_torch.bench.coloring -g kronecker 16 -n 3 -v --device cuda
"""

from __future__ import annotations

from gms_tpu_torch.algorithms import coloring as gc
from gms_tpu_torch.harness import benchmark, cli
from gms_tpu_torch.harness.printer import print_param


def main(argv=None):
    args, g = cli.Parser("graph coloring").parse_and_load(argv)
    dev = args.device

    def make_verify(name):
        def verify(g, colors):
            print_param(f"colors_{name}", gc.unique_colors_count(colors))
            return (gc.verify_coloring(g, colors)
                    and gc.verify_delta_plus_one(g, colors))
        return verify

    for name, kern in (
        ("jp-spec", lambda g: gc.jones_plassmann(g, speculative=True,
                                                 device=dev)),
        ("jp-spec-lf", lambda g: gc.jones_plassmann(
            g, speculative=True, priority="degree", device=dev)),
        ("jp-random", lambda g: gc.jones_plassmann(g, priority="random",
                                                   device=dev)),
        ("jp-lf", lambda g: gc.jones_plassmann(g, priority="degree",
                                               device=dev)),
        ("johansson", lambda g: gc.johansson(g, device=dev)),
        ("greedy-seq", lambda g: gc.greedy_sequential(g)),
    ):
        benchmark.benchmark_kernel(
            args, g, kern,
            verifier=make_verify(name) if args.verify else None,
            labels=(f"coloring-{name}",))


if __name__ == "__main__":
    main()
