"""One reader of torch.profiler windows, shared by chip_smoke.py and the
bench scripts: a call's device time by bare kernel name, its launches, the
device's idle share over the call and, where a script splits a kernel's
time by its launches, their order. Needs a card."""

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
# the device functions of the k-clique-star path (K13 and K10 share
# csrc/row_decode.cuh's decode_rows_kernel)
STAR_GROUPS = {"K11": ("univ_kernel",),
               "K12": ("count_kernel", "stack_kernel"),
               "K13": ("decode_rows_kernel",)}


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


def profile_launches(fn):
    """profile_window that also keeps the launch order: (fn's result, host
    s, {bare kernel: [device µs, launches]}, device µs of every device
    event, [(bare kernel, device µs)] in the order they ran)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    runs = sorted((e.time_range.start, bare_kernel(e.name),
                   e.time_range.elapsed_us()) for e in prof.events()
                  if e.device_type != DeviceType.CPU)
    per = {}
    for _, name, us in runs:
        acc = per.setdefault(name, [0.0, 0])
        acc[0] += us
        acc[1] += 1
    busy = sum(us for _, _, us in runs)
    return out, host_s, per, busy, [(n, us) for _, n, us in runs]


def launch_split(tag: str, seq, names, keys) -> dict | None:
    """The last len(keys) launches of `names` in `seq` (profile_launches'
    order), one for each of `keys`: prints and returns {key: {"ms",
    "launches"}}, device ms summed by key; None where fewer were traced
    (torch.profiler may drop a window's first launch)."""
    us = [t for n, t in seq if n in names][-len(keys):]
    if len(us) != len(keys):
        print(f"    {tag}: {len(us)} launches traced for {len(keys)}: "
              f"not split")
        return None
    out = {}
    for key, t in zip(keys, us):
        ms, n = out.get(key, (0.0, 0))
        out[key] = (ms + t / 1e3, n + 1)
    print(f"    {tag} by launch: " + "; ".join(
        f"{k} {ms:.4f} ms x{n}" for k, (ms, n) in out.items()))
    return {str(k): {"ms": ms, "launches": n} for k, (ms, n) in out.items()}


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
