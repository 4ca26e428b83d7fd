"""Benchmark runners — trial loops with per-phase timing + @@@ rows.

Role of gms/common/benchmark.h:
  * BenchmarkKernel   (:21,59)  — time N trials of kernel(graph)
  * BenchmarkKernelBk (:96)     — device-structure build timed separately
                                  ("GraphExec buildTime"), then N trials
  * BenchmarkKernelBkPP (:143)  — adds per-trial timed preprocessing
                                  producing an order/rank
  * BenchmarkKernelPP (:203)
and gms/common/pipeline.h:30-163 (Pipeline: member phases, each timed,
one @@@ row per trial). The port of gms_tpu/harness/benchmark.py.

Output protocol matches the reference: per-trial `Trial Time:` lines, a
machine row `@@@ trialTime [verifyMark verifyTime] [preprocTime] labels...`,
and `Average Time:` at the end (benchmark.h:33-52,188-195).
"""

from __future__ import annotations

import time

import numpy as np

from gms_tpu_torch.harness.printer import Printer, print_param
from gms_tpu_torch.harness.timers import Timer, _sync


def _trial_row(trial_time, *, verified=None, verify_time=None,
               preproc_time=None, labels=()):
    p = Printer()
    p.enqueue(trial_time)
    if verified is not None:
        p.enqueue("verified" if verified else "FAILED", verify_time)
    if preproc_time is not None:
        p.enqueue(preproc_time)
    p.enqueue(*labels)
    p.print()


def _counter_rows(counters, result, seconds):
    """PAPIW analog (common/papi/papiw.h:45-100 prints HW-counter values
    inline with benchmark output): derived per-trial throughput counters
    as `@@# <name> <value>` rows. `counters(result, seconds)` returns a
    {name: value} dict — typically items/sec and, when the kernel carries
    a traffic model, achieved GB/s."""
    if counters is None:
        return
    for name, value in counters(result, seconds).items():
        print_param(name, value)


def benchmark_kernel(args, g, kernel, verifier=None, labels=(), warmup=True,
                     counters=None):
    """Time args.trials runs of kernel(g); returns last result.

    warmup runs the kernel once untimed first so the kernels' first-use
    build (absent in the reference's C++ world) never pollutes trial 1.
    """
    if warmup:
        _sync(kernel(g))
    times, result = [], None
    for _ in range(args.trials):
        t = Timer()
        t.start()
        result = kernel(g)
        t.stop(sync_on=result)
        print(f"Trial Time:          {t.seconds:3.5f}")
        verified = vt = None
        if args.verify and verifier is not None:
            tv = Timer()
            tv.start()
            verified = verifier(g, result)
            vt = tv.stop()
            print(f"Verification Time:   {vt:3.5f}")
        _counter_rows(counters, result, t.seconds)
        _trial_row(t.seconds, verified=verified, verify_time=vt, labels=labels)
        times.append(t.seconds)
    print(f"Average Time:        {np.mean(times):3.5f}")
    return result


def benchmark_kernel_bk(args, g, build, kernel, verifier=None, labels=(),
                        warmup=True, counters=None):
    """Build device structure (timed once), then run trials on it."""
    t = Timer()
    t.start()
    built = build(g)
    t.stop(sync_on=getattr(built, "device", None))
    print(f"GraphExec buildTime: {t.seconds:3.5f}")
    if warmup:
        _sync(kernel(built))
    times, result = [], None
    for _ in range(args.trials):
        tt = Timer()
        tt.start()
        result = kernel(built)
        tt.stop(sync_on=result)
        print(f"Trial Time:          {tt.seconds:3.5f}")
        verified = vt = None
        if args.verify and verifier is not None:
            tv = Timer()
            tv.start()
            verified = verifier(g, result)
            vt = tv.stop()
            print(f"Verification Time:   {vt:3.5f}")
        _counter_rows(counters, result, tt.seconds)
        _trial_row(tt.seconds, verified=verified, verify_time=vt, labels=labels)
        times.append(tt.seconds)
    print(f"Average Time:        {np.mean(times):3.5f}")
    return result


def benchmark_kernel_bk_pp(args, g, build, preprocess, kernel,
                           verifier=None, labels=(), warmup=True,
                           counters=None):
    """BkPP: per-trial timed preprocessing producing an order/rank, then the
    kernel consuming it (benchmark.h:143-199)."""
    t = Timer()
    t.start()
    built = build(g)
    t.stop(sync_on=getattr(built, "device", None))
    print(f"GraphExec buildTime: {t.seconds:3.5f}")
    if warmup:
        _sync(kernel(built, preprocess(g)))
    times, result = [], None
    for _ in range(args.trials):
        tp = Timer()
        tp.start()
        order = preprocess(g)
        pt = tp.stop(sync_on=order)
        print(f"Preprocess Time:     {pt:3.5f}")
        tt = Timer()
        tt.start()
        result = kernel(built, order)
        tt.stop(sync_on=result)
        print(f"Trial Time:          {tt.seconds:3.5f}")
        verified = vt = None
        if args.verify and verifier is not None:
            tv = Timer()
            tv.start()
            verified = verifier(g, result)
            vt = tv.stop()
            print(f"Verification Time:   {vt:3.5f}")
        _counter_rows(counters, result, tt.seconds)
        _trial_row(tt.seconds, verified=verified, verify_time=vt,
                   preproc_time=pt, labels=labels)
        times.append(tt.seconds)
    print(f"Average Time:        {np.mean(times):3.5f}")
    return result


class Pipeline:
    """Multi-phase benchmark (pipeline.h:30-163 role): run named phase
    callables in order per trial, time each, emit one @@@ row per trial."""

    def __init__(self, args, labels=()):
        self.args = args
        self.labels = labels

    def run(self, *phases):
        """phases: (name, callable) pairs; each callable takes/returns a
        carry value (None initially)."""
        result = None
        for _ in range(self.args.trials):
            p = Printer()
            carry = None
            for name, fn in phases:
                t = Timer()
                t.start()
                carry = fn(carry)
                t.stop(sync_on=carry)
                print(f"{name + ':':21s}{t.seconds:3.5f}")
                p.enqueue(t.seconds)
            p.enqueue(*self.labels)
            p.print()
            result = carry
        return result
