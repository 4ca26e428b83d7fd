"""Machine-readable stdout protocol.

Role of gms/common/printer.h:19-107 (`Printer`, prefix `@@@`) and
gapbs/util.h:96-123 (`PrintBenchmarkOutput`, prefixes `@@@` result rows,
`@@#` param values, `@##` info): space-separated rows a scraper collects
into CSV (scripts/collectData.bash:18-19). Preserved verbatim so existing
GMS tooling-style pipelines keep working against this framework.
"""

from __future__ import annotations

import sys

RESULT_PREFIX = "@@@"
PARAM_PREFIX = "@@#"
INFO_PREFIX = "@##"


class Printer:
    """Accumulate values; emit one `@@@ v1 v2 ...` row (printer.h role)."""

    def __init__(self, prefix: str = RESULT_PREFIX, out=None):
        self.prefix = prefix
        self.values: list[str] = []
        self.out = out or sys.stdout

    def enqueue(self, *vals) -> "Printer":
        for v in vals:
            self.values.append(_fmt(v))
        return self

    __lshift__ = enqueue

    def print(self):
        print(self.prefix + " " + " ".join(self.values), file=self.out, flush=True)
        self.values = []


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.5f}"
    return str(v)


def print_result_row(*vals, out=None):
    Printer(out=out).enqueue(*vals).print()


def print_param(name, value, out=None):
    print(f"{PARAM_PREFIX} {name} {_fmt(value)}", file=out or sys.stdout, flush=True)


def print_info(*vals, out=None):
    Printer(prefix=INFO_PREFIX, out=out).enqueue(*vals).print()
