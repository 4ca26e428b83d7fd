"""Build and bind the hand-written CUDA kernels under csrc/.

Each csrc/<name>.cu is compiled by nvcc for sm_90a (Hopper) into
_build/lib<name>.so with a plain C interface, loaded with ctypes. A library
is rebuilt when its source or a shared header is newer than it; all stale
sources compile in parallel, one nvcc each. A failed build raises with nvcc's
stderr. Nothing here runs at import: the first launch builds what it needs.

Every C entry takes device pointers, sizes and the CUDA stream, launches on
that stream without synchronising, and returns cudaGetLastError(); `launch`
raises if that is not 0.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double

# library -> {C function: argument types, the trailing stream included}
SIGNATURES = {
    "tier_intersect": {
        # a, b, wa, wb, E, out, stream
        "tier_intersect_stream": (_P, _P, _I, _I, _L, _P, _P),
        # nbr, d_pad, edges, valid, wa, wb, E, out, stream
        "tier_intersect_gather": (_P, _L, _P, _P, _I, _I, _L, _P, _P),
        # nbr, d_pad, edges, valid, wa, wb, E, out, len(out), stream
        "tier_intersect_vertex": (_P, _L, _P, _P, _I, _I, _L, _P, _L, _P),
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
        # queue capacity, out rows, out capacity, total, stream
        "bk_stack": (_P, _P, _P, _L, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                     _L, _P, _L, _P, _P),
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
        # adj_full, adj_dag, s0, i0, live0, C, w_words, k, root offsets,
        # item offsets, out tail, out rows, out capacity, totals, stream
        "star_stack": (_P, _P, _P, _P, _P, _L, _I, _I, _P, _P, _P, _P, _L, _P,
                       _P),
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
        # U, nu, V, nv, W, deg_p, n, u_base, v_base, block, wcol (or null),
        # metric, q, tiles_per_strip, n_vtiles, group, ctas_v, out_s, out_u,
        # out_v, out_n, stream
        "tile_topq": (_P, _I, _P, _L, _L, _P, _L, _L, _L, _L, _P, _I, _I, _I,
                      _L, _L, _I, _P, _P, _P, _P, _P),
    },
    "color_jp": {
        # ids, nbrt, Vt, Dt, colors, prio, cw, dec, stream
        "color_jp": (_P, _P, _L, _I, _P, _P, _I, _P, _P),
    },
    "color_spec": {
        # ids, nbrt, Vt, Dt, colors, cw, pick0, stream
        "spec_pick": (_P, _P, _L, _I, _P, _I, _P, _P),
        # ids, nbrt, Vt, Dt, colors, pick0, prio, cw, tent, stream
        "spec_rank": (_P, _P, _L, _I, _P, _P, _P, _I, _P, _P),
        # ids, nbrt, Vt, Dt, colors, tent, prio, out, stream
        "spec_clash": (_P, _P, _L, _I, _P, _P, _P, _P, _P),
    },
    "color_random": {
        # ids, nbrt, Vt, Dt, colors, deg1, draws, out, stream
        "johansson": (_P, _P, _L, _I, _P, _P, _P, _P, _P),
        # ids, nbrt, Vt, Dt, colors, deg1, draws, palette_deg, delta, cw,
        # pick, nfree, stream
        "one_shot_pick": (_P, _P, _L, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P),
        # ids, nbrt, Vt, Dt, colors, pick, nfree, out, stream
        "one_shot_resolve": (_P, _P, _L, _I, _P, _P, _P, _P, _P),
    },
    "color_components": {
        # indptr, indices, n, comp, nxt, changed, stream
        "component_step": (_P, _P, _L, _P, _P, _P, _P),
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}


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
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def launch(name: str, fn: str, *args) -> None:
    """Call C entry `fn` of library `name` on the current CUDA stream.

    Tensor arguments pass as device pointers (None as a null pointer), ints
    and floats as themselves; the stream is appended. Raises if the launch
    reported a CUDA error.
    """
    c_args = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
              else a for a in args]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    err = getattr(_load(name), fn)(*c_args, stream)
    if err:
        raise RuntimeError(f"{fn}: CUDA error {err}")


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
