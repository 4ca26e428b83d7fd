"""Benchmark CLI — flag grammar preserved from the reference.

Role of gms/common/cli/ (cli.h:17-185 Parser, args.h:17-107 Args,
parameter.h:7-53 Param/ParamSpec, compat.h GapbsCompat) over clipp:
    [-v] [-t N] [-n trials] (-f FILE | -g {uniform,kronecker} SCALE [--deg D])
    [-p name=value]... [--device {cuda,cpu}]
`-t` (OpenMP thread count) is accepted for compatibility and ignored — the
device replaces host threading (SURVEY.md §2.13). `--device` (default cuda)
picks where the kernels run; cpu runs their plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np


@dataclasses.dataclass
class Args:
    verify: bool = False
    threads: int | None = None
    trials: int = 1
    file: str | None = None
    gen: str | None = None
    scale: int | None = None
    deg: int = 16
    params: dict = dataclasses.field(default_factory=dict)
    symmetrize: bool = True
    device: str = "cuda"

    def print(self, out=None):
        out = out or sys.stdout
        print("Benchmark configuration:", file=out)
        if self.file:
            print(f"  Input file: {self.file}", file=out)
        else:
            print(f"  Generator: {self.gen} scale {self.scale} deg {self.deg}",
                  file=out)
        print(f"  Trials: {self.trials}  Verify: {self.verify}  "
              f"Device: {self.device}", file=out)
        for k, v in self.params.items():
            print(f"  Param {k} = {v}", file=out)

    def load_graph(self):
        """Args::load_graph / GapbsCompat -> Builder::MakeGraph role."""
        from gms_tpu_torch.io.builder import build_csr
        from gms_tpu_torch.io.generators import generate_rmat_el, generate_uniform_el
        from gms_tpu_torch.io.readers import read_graph

        if self.file:
            return read_graph(self.file, symmetrize=self.symmetrize)
        n = 1 << self.scale
        if self.gen == "kronecker":
            el = generate_rmat_el(self.scale, self.deg)
        else:
            el = generate_uniform_el(self.scale, self.deg)
        return build_csr(el, num_nodes=n)


class Parser:
    """CLI::Parser role — common flags + registered -p params with defaults."""

    def __init__(self, description: str = ""):
        self._p = argparse.ArgumentParser(description=description)
        self._p.add_argument("-v", "--verify", action="store_true")
        self._p.add_argument("-t", "--threads", type=int, default=None)
        self._p.add_argument("-n", "--num-trials", type=int, default=1, dest="trials")
        self._p.add_argument("-f", "--file")
        self._p.add_argument("-g", "--gen", nargs="+", metavar=("KIND", "SCALE"))
        self._p.add_argument("--deg", type=int, default=16)
        self._p.add_argument("-p", "--param", action="append", default=[],
                             metavar="NAME=VALUE")
        self._p.add_argument("--device", choices=("cuda", "cpu"),
                             default="cuda")
        self._params: dict[str, object] = {}

    def add_param(self, name: str, default, help: str = ""):
        """Param registration (cli/parameter.h:7-53 role)."""
        self._params[name] = default
        return self

    def parse(self, argv=None) -> Args:
        ns = self._p.parse_args(argv)
        args = Args(verify=ns.verify, threads=ns.threads, trials=ns.trials,
                    file=ns.file, deg=ns.deg, device=ns.device)
        if ns.gen:
            if ns.file:
                self._p.error("-f and -g are mutually exclusive")
            if len(ns.gen) < 2 or ns.gen[0] not in ("uniform", "kronecker"):
                self._p.error("-g requires: (uniform|kronecker) SCALE")
            args.gen, args.scale = ns.gen[0], int(ns.gen[1])
        elif not ns.file:
            self._p.error("one of -f FILE or -g GEN SCALE is required")
        params = dict(self._params)
        for kv in ns.param:
            if "=" not in kv:
                self._p.error(f"bad -p {kv!r}: expected name=value")
            k, v = kv.split("=", 1)
            if k not in params:
                self._p.error(f"unknown param {k!r}; known: {sorted(params)}")
            params[k] = type(params[k])(v) if params[k] is not None else v
        args.params = params
        return args

    def parse_and_load(self, argv=None):
        """parse + Args::print + load (cli.h:157 parse_and_load role)."""
        args = self.parse(argv)
        args.print()
        g = args.load_graph()
        print(f"Graph has {g.num_nodes} nodes and {g.num_edges_undirected} "
              f"undirected edges")
        return args, g
