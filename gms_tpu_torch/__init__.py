"""gms_tpu_torch — the PyTorch and CUDA port of gms_tpu, for NVIDIA Hopper.

The package mirrors gms_tpu's layout and names (graphs/, io/, preprocessing/,
sets/, algorithms/, harness/, bench/), so each module's counterpart is easy to
find. gms_tpu stays the reference: the tests hold every port module against
its gms_tpu twin on the same inputs.

Rules the whole package keeps:
  * it imports torch and numpy, never jax and nothing of gms_tpu — the host
    numpy code it needs is copied here;
  * every entry point takes an explicit `device`, defaulting to "cuda". With
    no card that raises; a caller who wants the CPU asks for it;
  * each device program of gms_tpu on a ported path is a hand-written CUDA
    kernel under csrc/, built by _kernels.py with nvcc on first use. Its
    wrapper takes the kernel's plain PyTorch version only for CPU tensors,
    and launches the kernel or raises for CUDA tensors;
  * bit words are int32 tensors carrying the bits of gms_tpu's uint32 words,
    and counts are exact int64.
"""

__version__ = "0.1.0"

from gms_tpu_torch.graphs.csr import CSRGraph
from gms_tpu_torch.graphs.tiles import PaddedGraph
from gms_tpu_torch.graphs.bitmap import BitmapGraph

__all__ = [
    "CSRGraph",
    "PaddedGraph",
    "BitmapGraph",
    "read_graph",
    "build_csr",
    "triangle_count",
    "kclique_count",
    "bron_kerbosch",
    "kclique_star_list",
    "subgraph_isomorphism",
    "jones_plassmann",
    "vertex_similarity",
    "AUCPlan",
]

# lazy top-level conveniences, as gms_tpu's
_LAZY = {
    "read_graph": ("gms_tpu_torch.io.readers", "read_graph"),
    "build_csr": ("gms_tpu_torch.io.builder", "build_csr"),
    "triangle_count": ("gms_tpu_torch.algorithms.triangle_count",
                       "triangle_count"),
    "kclique_count": ("gms_tpu_torch.algorithms.k_clique", "kclique_count"),
    "bron_kerbosch": ("gms_tpu_torch.algorithms.bron_kerbosch",
                      "bron_kerbosch"),
    "kclique_star_list": ("gms_tpu_torch.algorithms.k_clique_star",
                          "kclique_star_list"),
    "subgraph_isomorphism": ("gms_tpu_torch.algorithms.subgraph_iso",
                             "subgraph_isomorphism"),
    "jones_plassmann": ("gms_tpu_torch.algorithms.coloring",
                        "jones_plassmann"),
    "vertex_similarity": ("gms_tpu_torch.algorithms.similarity",
                          "vertex_similarity"),
    "AUCPlan": ("gms_tpu_torch.algorithms.link_prediction", "AUCPlan"),
}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module 'gms_tpu_torch' has no attribute "
                             f"{name!r}")
    import importlib

    mod, attr = _LAZY[name]
    return getattr(importlib.import_module(mod), attr)
