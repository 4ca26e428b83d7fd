"""Build and bind the hand-written CUDA kernels under csrc/.

Each csrc/<name>.cu is compiled by nvcc for sm_90a (Hopper) into
_build/lib<name>.so with a plain C interface, loaded with ctypes. A library
is rebuilt when its source or a shared header is newer than it; all stale
sources compile in parallel, one nvcc each. A failed build raises with nvcc's
stderr. Nothing here runs at import: the first launch builds what it needs.

Every C entry takes device pointers, sizes and the CUDA stream, launches on
that stream without synchronising, and returns cudaGetLastError(); `launch`
raises if that is not 0.

Each library links its own static CUDA runtime, whose current device is
device 0 until told otherwise, for each host thread. csrc/set_device.cuh,
compiled into every library (nvcc's -include), adds the C entry
`gms_set_device`; `launch` calls it when the device of the tensor arguments
is not the one this thread last set in that library, so a kernel runs on
the card its tensors lie on, on that card's current stream.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-include", str(CSRC / "set_device.cuh"))

_P, _I, _L, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
_U, _F = ctypes.c_ulonglong, ctypes.c_float

# library -> {C function: argument types, the trailing stream included}
SIGNATURES = {
    "tier_intersect": {
        # a, b, wa, wb, E, out, stream
        "tier_intersect_stream": (_P, _P, _I, _I, _L, _P, _P),
        # nbr, d_pad, edges, valid, wa, wb, E, out, stream
        "tier_intersect_gather": (_P, _L, _P, _P, _I, _I, _L, _P, _P),
        # nbr, d_pad, edges, valid, wa, wb, E, out, len(out), stream
        "tier_intersect_vertex": (_P, _L, _P, _P, _I, _I, _L, _P, _L, _P),
        # nbr_a, da, nbr_b, db, items, n_items, vis, wt, vlen, wa, wb, out,
        # stream
        "tier_intersect_owned": (_P, _L, _P, _L, _P, _L, _P, _P, _P, _I, _I,
                                 _P, _P),
    },
    "hub_popcount": {
        # b, a, G, K, W, out, stream
        "hub_popcount_stream": (_P, _P, _L, _I, _I, _P, _P),
        # rows, hw, b_ids, nbrs, G, K, W, out, stream
        "hub_popcount_gather": (_P, _L, _P, _P, _L, _I, _I, _P, _P),
    },
    "hub_rows": {
        # nbr, v_pad, d_pad, hub_id, wide_ids, nw, hw, out, stream
        "build_hub_rows": (_P, _L, _I, _P, _P, _L, _I, _P, _P),
    },
    "local_adj": {
        # nbr, v_pad, d_pad, roots, C, w_words, adj, s0, stream
        "build_local_adj": (_P, _L, _I, _P, _L, _I, _P, _P, _P),
    },
    "kclique_dense": {
        # adj, C, w_words, k, out, stream
        "kclique_dense_count": (_P, _L, _I, _I, _P, _P),
    },
    "kclique_stack": {
        # adj, s0, C, w_words, k, root offsets, item offsets, out, stream
        "kc_stack_count": (_P, _P, _L, _I, _I, _P, _P, _P, _P),
    },
    "bk_symmetrize": {
        # adj, C, w_words, out, stream
        "symmetrize_bits": (_P, _L, _I, _P, _P),
    },
    "bk_cover": {
        # nbr, v_pad, d_pad, lo_indptr, n, lo_cols, n_cols, roots, C,
        # w_words, in_width, M, wvalid, stream
        "hub_cover_bits": (_P, _L, _I, _P, _L, _P, _L, _P, _L, _I, _I, _P,
                           _P, _P),
    },
    "bk_stack": {
        # adj, s0, live0, C, w_words, M, wvalid, in_width, root offsets,
        # root ext, transposed cover, control words, queue, ready flags,
        # queue capacity, out rows, out capacity, stats, total, stream
        "bk_stack": (_P, _P, _P, _L, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                     _L, _P, _L, _I, _P, _P),
    },
    "bk_decode": {
        # nbr, v_pad, d_pad, chunk, C, out, L, w_words, gid, members, stream
        "decode_clique_members": (_P, _L, _I, _P, _L, _P, _L, _I, _P, _P, _P),
    },
    "star_univ": {
        # nbr, v_pad, d_pad, rank_pad, len(rank_pad), roots, C, w_words,
        # adj_full, adj_dag, s0, i0, stream
        "build_local_univ": (_P, _L, _I, _P, _L, _P, _L, _I, _P, _P, _P, _P,
                             _P),
    },
    "star_stack": {
        # adj_full, adj_dag, s0, i0, live0, C, w_words, k, sizes only,
        # control words, item counts, run table, leaves a run, stream
        "star_stack_count": (_P, _P, _P, _P, _P, _L, _I, _I, _I, _P, _P, _P,
                             _P, _P),
        # adj_full, adj_dag, s0, i0, C, w_words, k, control words, run
        # table, leaves a run, runs, run bases, out rows, out capacity,
        # stream
        "star_stack_emit": (_P, _P, _P, _P, _L, _I, _I, _P, _P, _P, _L, _P,
                            _P, _L, _P),
    },
    "star_decode": {
        # nbr, v_pad, d_pad, chunk, C, out, L, w_words, gid, ids, stream
        "decode_star_rows": (_P, _L, _I, _P, _L, _P, _L, _I, _P, _P, _P),
    },
    "bitmap_count": {
        # rows, n_rows, hw, row_of (or null), len(row_of), edges, valid, E,
        # width, out, stream
        "bitmap_edge_count": (_P, _L, _L, _P, _L, _P, _P, _L, _I, _P, _P),
        # a, b, B, W, op, out, stream
        "bitmap_rows_count": (_P, _P, _L, _I, _I, _P, _P),
    },
    "adg_round": {
        # indptr, indices, n, deg, alive, peel, stats, mode, eps, bound,
        # stream
        "adg_round": (_P, _P, _L, _P, _P, _P, _P, _I, _D, _D, _P),
    },
    "pair_scores": {
        # nbr_a, va, wa, nbr_b, vb, wb, deg1, len(deg1), pairs, B, metric,
        # out_pos (or null), out, stream
        "pair_scores_merge": (_P, _L, _I, _P, _L, _I, _P, _L, _P, _L, _I, _P,
                              _P, _P),
        # nbr_a, va, wa, deg1, len(deg1), bm, len(bm), hub_idx, len(hub_idx),
        # vw, pairs, B, metric, out_pos (or null), out, stream
        "pair_scores_hub": (_P, _L, _I, _P, _L, _P, _L, _P, _L, _L, _P, _L, _I,
                            _P, _P, _P),
    },
    "auc_count": {
        # scores, T, shift, counts row, stream
        "auc_count": (_P, _L, _P, _P, _P),
    },
    "tile_scores": {
        # U, Bu, V, Vn, W, deg_u, deg_v, wcol (or null), metric, out, stream
        "tile_all_pairs": (_P, _L, _P, _L, _L, _P, _P, _P, _I, _P, _P),
        # indptr, indices, their transpose's, strips (or null), its columns,
        # deg_p, wcol (or null), n, u_base, nu, v_base, nv, block, metric, q,
        # units, u-tiles, first chunk, CTAs, work counter, scratch, out_s,
        # out_u, out_v, out_n, stream
        "tile_topq": (_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                      _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P),
    },
    "color_jp": {
        # ids, nbrt, Vt, Dt, colors, prio, cw, dec, stream
        "color_jp": (_P, _P, _L, _I, _P, _P, _I, _P, _P),
        # bucket table, buckets, colors, len(colors), prio, n, limit,
        # widest Dt, stamped words, ctl, stream
        "color_jp_run": (_P, _I, _P, _L, _P, _L, _I, _I, _P, _P, _P),
    },
    "color_spec": {
        # ids, nbrt, Vt, Dt, colors, pick0, stream
        "spec_pick": (_P, _P, _L, _I, _P, _P, _P),
        # ids, nbrt, Vt, Dt, colors, pick0, prio, tent, stream
        "spec_rank": (_P, _P, _L, _I, _P, _P, _P, _P, _P),
        # ids, nbrt, Vt, Dt, colors, tent, prio, out, stream
        "spec_clash": (_P, _P, _L, _I, _P, _P, _P, _P, _P),
        # bucket table, buckets, colors, scratch, len(colors), prio, n,
        # limit, widest Dt, ctl, stream
        "color_spec_run": (_P, _I, _P, _P, _L, _P, _L, _I, _I, _P, _P),
    },
    "color_random": {
        # ids, nbrt, Vt, Dt, colors, deg1, draws, out, stream
        "johansson": (_P, _P, _L, _I, _P, _P, _P, _P, _P),
        # ids, nbrt, Vt, Dt, colors, deg1, draws, n1, palette_deg, delta,
        # cw, pick, nfree, stream
        "one_shot_pick": (_P, _P, _L, _I, _P, _P, _P, _L, _I, _I, _I, _P, _P,
                          _P),
        # ids, nbrt, Vt, Dt, colors, pick, nfree, out, stream
        "one_shot_resolve": (_P, _P, _L, _I, _P, _P, _P, _P, _P),
        # bucket table, buckets, wide rows, narrow rows, colors, deg1,
        # draws, n1, pick words, out, stream
        "johansson_round": (_P, _I, _L, _L, _P, _P, _P, _L, _P, _P, _P),
        # bucket table, buckets, wide rows, narrow rows, colors, deg1,
        # draws, n1, palette_deg, delta, palette words (narrow, wide), pick,
        # nfree, out, stream
        "one_shot_round": (_P, _I, _L, _L, _P, _P, _P, _L, _I, _I, _I, _I,
                           _P, _P, _P, _P),
    },
    "color_components": {
        # indptr, indices, n, comp, nxt, the row schedule (rows, starts,
        # n_narrow, n_seg, n_wide, segment), changed, stream
        "component_step": (_P, _P, _L, _P, _P, _P, _P, _L, _L, _L, _I, _P,
                           _P),
    },
    "vf2_feasible": {
        # M, P, cand, N, Dc, nbr, v_pad, d_pad, deg1, len(deg1), bmp (or
        # null), V, vw, pdeg, d, parents mask, nonparents mask, induced, ok,
        # count, stream
        "vf2_feasible": (_P, _I, _P, _L, _I, _P, _L, _I, _P, _L, _P, _L, _L,
                         _I, _I, _U, _U, _I, _P, _P, _P),
    },
    "vf2_emit": {
        # M, P, cand, ok, N, Dc, d, cap, item counts, out, n_out, stream
        "vf2_emit": (_P, _I, _P, _P, _L, _I, _I, _L, _P, _P, _P, _P),
    },
    "kbit_decode": {
        # packed, v_pad, W, deg, vids, B, d_pad, k, out, stream
        "kbit_decode_rows": (_P, _L, _I, _P, _P, _L, _I, _I, _P, _P),
    },
    "gapbs_bfs": {
        # indptr, indices, n, dist, it, count, stream
        "bfs_pull": (_P, _P, _L, _P, _I, _P, _P),
        # dist, n, it, ids, count, stream
        "frontier_ids": (_P, _L, _I, _P, _P, _P),
        # indptr, indices, ids, fcount, dist, it, next ids, next count, stream
        "bfs_push": (_P, _P, _P, _L, _P, _I, _P, _P, _P),
    },
    "gapbs_kbit_bfs": {
        # packed, W, deg, n, k, dist, it, count, stream
        "bfs_kbit_pull": (_P, _I, _P, _L, _I, _P, _I, _P, _P),
    },
    "gapbs_pr": {
        # indptr, indices, n, deg, pr, base, damp, the row schedule (rows,
        # starts, n_narrow, n_seg, n_wide, segment), partial, contrib, out,
        # stream
        "pr_pull": (_P, _P, _L, _P, _P, _F, _F, _P, _P, _L, _L, _L, _I, _P,
                    _P, _P, _P),
    },
    "gapbs_min": {
        # indptr, indices, n, cur, nxt, changed, stream
        "cc_step": (_P, _P, _L, _P, _P, _P, _P),
        # indptr, indices, weights (or null), n, cur, nxt, changed, stream
        "sssp_step": (_P, _P, _P, _L, _P, _P, _P, _P),
    },
    "gapbs_bc": {
        # indptr, indices, n, lvl, seen, sigma, it, rows, starts, n_narrow,
        # n_seg, n_wide, segment, partial, stream
        "bc_forward": (_P, _P, _L, _P, _P, _P, _I, _P, _P, _L, _L, _L, _I,
                       _P, _P),
        # indptr, indices, n, lvl, sigma, delta, it, total, rows, starts,
        # n_narrow, n_seg, n_wide, segment, partial, stream
        "bc_backward": (_P, _P, _L, _P, _P, _P, _I, _P, _P, _P, _L, _L, _L,
                        _I, _P, _P),
    },
    "bk_init": {
        # nbr, v_pad, d_pad, rank_pad, len(rank_pad), roots, C, w_words,
        # cand, fini, stream
        "init_items": (_P, _L, _I, _P, _L, _P, _L, _I, _P, _P, _P),
    },
    "bk_direct": {
        # adj, cand0, fini0, live0, C, w_words, depth, root offsets, root
        # ext, control words, queue, ready flags, queue capacity, stats,
        # total, stream
        "bk_direct_stack": (_P, _P, _P, _P, _L, _I, _I, _P, _P, _P, _P, _P,
                            _L, _I, _P, _P),
    },
    "kc_expand": {
        # S, R, N, n_live (or null), adj, C, w_words, need, cap, grid,
        # tile status, S_out, R_out, n_children and child popcounts, stream
        "expand_level": (_P, _P, _L, _P, _P, _L, _I, _I, _L, _I, _P, _P, _P,
                         _P, _P),
    },
    "popcount_sum": {
        # words, n, out, stream
        "total_popcount": (_P, _L, _P, _P),
    },
    "ring_member": {
        # q, w_words, vis, Vs, d, locs, sel, C, L, out, stream
        "member_pack": (_P, _I, _P, _L, _I, _P, _P, _L, _I, _P, _P),
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}
# per host thread: library -> the device its runtime was last set to
_SET = threading.local()


def _library(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _library(name)
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    deps = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return any(d.stat().st_mtime > built for d in deps)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); "
                           "the CUDA kernels cannot be built")
    return path


def build(names=None) -> dict[str, str]:
    """Compile the stale kernel libraries in parallel.

    Returns {library: ptxas report} for each library compiled by this call.
    """
    names = [n for n in (names or SIGNATURES) if _stale(n)]
    if not names:
        return {}
    nvcc = _nvcc()
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        tmp = BUILD / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc failed on csrc/{name}.cu "
                          f"(exit {proc.returncode}):\n{out}{err}")
            continue
        os.replace(tmp, _library(name))
        reports[name] = out + err
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def _load(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_library(name)))
        for fn, argtypes in (*SIGNATURES[name].items(),
                             ("gms_set_device", (_I,)),
                             ("gms_window_open", (_P,))):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def launch_device(fn: str, args) -> torch.device:
    """The one CUDA device of the tensor arguments of a launch of `fn`;
    raises if they lie on several devices, or on none that is CUDA."""
    devices = {a.device for a in args if isinstance(a, torch.Tensor)}
    if len(devices) != 1:
        raise ValueError(f"{fn}: tensor arguments on {len(devices)} devices: "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type != "cuda":
        raise ValueError(f"{fn}: tensor arguments on {dev}, not a CUDA device")
    return dev


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device `index` (a persistent or
    card-filling grid's size)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def current_stream(index: int) -> int:
    """The raw cudaStream_t of card `index`'s current stream. Building a
    torch.cuda.Stream for it costs about as much host time as a small
    kernel's launch."""
    return torch._C._cuda_getCurrentRawStream(index)


def launch(name: str, fn: str, *args) -> None:
    """Call C entry `fn` of library `name` on the device of its tensor
    arguments, on that device's current CUDA stream.

    Tensor arguments pass as device pointers (None as a null pointer), ints
    and floats as themselves; the stream is appended. The library's runtime
    is set to the tensors' device first, where this thread last set it to
    another. Raises if the tensors lie on
    several devices, or if the launch reported a CUDA error.
    """
    # one pass over the arguments: a launch's host time is most of a small
    # kernel's, so the device check reads indices (get_device) and leaves
    # naming a fault to launch_device
    c_args, found = [], set()
    for a in args:
        if isinstance(a, torch.Tensor):
            found.add(a.get_device())
            c_args.append(a.data_ptr())
        else:
            c_args.append(a)
    index = (found.pop() if len(found) == 1 and min(found) >= 0
             else launch_device(fn, args).index)
    lib = _on_device(name, fn, index)
    err = getattr(lib, fn)(*c_args, current_stream(index))
    if err:
        raise RuntimeError(f"{fn}: CUDA error {err}")


def _on_device(name: str, fn: str, index: int) -> ctypes.CDLL:
    """Library `name`, its runtime set to card `index` where this thread
    last set it to another."""
    lib = _load(name)
    set_to = _SET.__dict__
    if set_to.get(name) != index:
        err = lib.gms_set_device(index)
        if err:
            raise RuntimeError(f"{fn}: cudaSetDevice({index}) failed, "
                               f"CUDA error {err}")
        set_to[name] = index
    return lib


def open_window(index: int) -> None:
    """An empty kernel (csrc/set_device.cuh's gms_window_open) from every
    library loaded so far, on card `index`'s current stream."""
    for name in list(_LIBS):
        err = _on_device(name, "gms_window_open", index).gms_window_open(
            current_stream(index))
        if err:
            raise RuntimeError(f"gms_window_open: CUDA error {err}")


# ---------------------------------------------------------------------------
# checks shared by the kernel wrappers
# ---------------------------------------------------------------------------

def on_cuda(name: str, *tensors: torch.Tensor) -> bool:
    """True if all tensors are on one CUDA device, False if all on the CPU."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices: {devices}")
    kind = devices.pop().type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device type {kind!r}")
    return kind == "cuda"


def check_tensor(name: str, what: str, t: torch.Tensor, ndim: int,
                 dtype=torch.int32) -> None:
    """Raise unless `t` has `dtype`, `ndim` dimensions and is contiguous."""
    if t.dtype != dtype or t.dim() != ndim:
        raise TypeError(f"{name}: {what} must be {str(dtype)[6:]} with {ndim} "
                        f"dims, got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")
