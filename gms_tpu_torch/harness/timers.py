"""Wall-clock + phase timing + device profiling hooks — the port of
gms_tpu/harness/timers.py.

Role of the reference's Timer (gms/third_party/gapbs/timer.h:18-44),
DetailTimer (gms/common/detail_timer.h:13-35) and PAPIW
(gms/common/papi/papiw.h:45-100). The device profile is a torch.profiler
trace (ProfileScope).

Timing device work requires a synchronize at phase boundaries — the helpers
here synchronize the device of any CUDA tensor they are handed.
"""

from __future__ import annotations

import contextlib
import time

import torch


def _sync(value):
    """Wait for the device work behind `value` (a tensor or torch.device, or
    a list or tuple of them); anything else is already on the host."""
    if isinstance(value, torch.device):
        if value.type == "cuda":
            torch.cuda.synchronize(value)
    elif isinstance(value, torch.Tensor):
        if value.device.type == "cuda":
            torch.cuda.synchronize(value.device)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _sync(v)
    return value


class Timer:
    """start/stop wall-clock timer (gapbs/timer.h:18-44 role)."""

    def __init__(self):
        self._t0 = 0.0
        self.seconds = 0.0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync_on=None):
        if sync_on is not None:
            _sync(sync_on)
        self.seconds = time.perf_counter() - self._t0
        return self.seconds


class DetailTimer:
    """Named-phase timer (common/detail_timer.h:13-35 role): accumulates
    (name, seconds) pairs; print() emits reference-style labeled lines."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.phases: list[tuple[str, float]] = []
        self._t0 = time.perf_counter()

    def phase(self, name: str, sync_on=None):
        if sync_on is not None:
            _sync(sync_on)
        now = time.perf_counter()
        if self.enabled:
            self.phases.append((name, now - self._t0))
        self._t0 = now

    def print(self, out=None):
        import sys

        out = out or sys.stdout
        for name, secs in self.phases:
            print(f"{name + ':':21s}{secs:3.5f}", file=out)


@contextlib.contextmanager
def ProfileScope(logdir: str | None = None):
    """Device profiler trace (PAPIW START/STOP equivalent).

    with ProfileScope("traces/tc"): run_kernels()
    Writes a Chrome trace (trace.json) of CPU and, where present, CUDA
    activity into `logdir`; no-op when logdir is None.
    """
    if logdir is None:
        yield
        return
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def timed(label: str, sync_on=None, out=None):
    """Context manager printing `label: seconds` (PrintTime role,
    gapbs/util.h:31-33)."""
    import sys

    t0 = time.perf_counter()
    yield
    if sync_on is not None:
        _sync(sync_on)
    print(f"{label + ':':21s}{time.perf_counter() - t0:3.5f}",
          file=out or sys.stdout)
