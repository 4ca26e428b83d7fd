"""One reader of torch.profiler windows, shared by chip_smoke.py and the
bench scripts: a call's device time by bare kernel name, its launches and
the device's idle share over the call. Needs a card."""

from __future__ import annotations

import time

import torch

# the device functions of K9 and K36 (the root offsets' scan is shared)
K9_KERNELS = ("bk_stack_kernel", "bk_stack_root", "bk_stack_cover_t",
              "bk_stack_init")
K36_KERNELS = ("bk_direct_kernel", "bk_direct_root", "bk_direct_init")
BK_GROUPS = {"K9": K9_KERNELS, "K36": K36_KERNELS,
             "root offsets (K9, K36)": ("root_offsets_kernel",),
             "K4": ("local_adj_kernel",), "K7": ("symmetrize_kernel",),
             "K8": ("cover_kernel",), "K35": ("init_items_kernel",)}


def bare_kernel(key: str) -> str:
    """A device event's bare function name: namespaces, template arguments
    and parameters cut ('void (anonymous namespace)::f<true>(int)' -> 'f');
    memsets and copies keep their own names."""
    if key.startswith(("Memset", "Memcpy")):
        return key
    name = key.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("<", 1)[0].split("(", 1)[0].split("::")[-1].strip()


def profile_window(fn):
    """One call of fn under torch.profiler (CPU and CUDA activities), ended
    by a synchronize: (its result, host s, {bare kernel: [device µs,
    launches]}, device µs summed over every device event). The device's
    idle share over the window is 1 - busy / host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    per = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if t > 0:
            acc = per.setdefault(bare_kernel(e.key), [0.0, 0])
            acc[0] += t
            acc[1] += e.count
    return out, host_s, per, sum(t for t, _ in per.values())


def window_lines(tag: str, host_s, per, busy, groups) -> dict:
    """Prints a profiler window: each group's device ms and launches
    (groups: {label: bare kernel names}), the device's busy ms and idle
    share, and the eight costliest device events. Returns {label: (ms,
    launches)}."""
    sums = {}
    for label, names in groups.items():
        ms = sum(per[k][0] for k in names if k in per) / 1e3
        n = sum(per[k][1] for k in names if k in per)
        sums[label] = (ms, n)
        print(f"    {tag} {label}: device {ms:.4f} ms over {n} launches "
              f"({', '.join(names)})")
    print(f"    {tag} window: host {host_s:.4f} s, device busy "
          f"{busy / 1e3:.4f} ms, idle share {1 - busy / 1e6 / host_s:.4f}")
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:8]
    print(f"    {tag} costliest: " + "; ".join(
        f"{k[:40]} {t / 1e3:.4f} ms x{n}" for k, (t, n) in top))
    return sums
