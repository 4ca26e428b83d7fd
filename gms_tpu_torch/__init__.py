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

from gms_tpu_torch.graphs.bitmap import BitmapGraph

__all__ = ["BitmapGraph", "vertex_similarity", "AUCPlan", "jones_plassmann"]

# lazy top-level conveniences, as gms_tpu's
_LAZY = {
    "vertex_similarity": ("gms_tpu_torch.algorithms.similarity",
                          "vertex_similarity"),
    "AUCPlan": ("gms_tpu_torch.algorithms.link_prediction", "AUCPlan"),
    "jones_plassmann": ("gms_tpu_torch.algorithms.coloring",
                        "jones_plassmann"),
}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module 'gms_tpu_torch' has no attribute "
                             f"{name!r}")
    import importlib

    mod, attr = _LAZY[name]
    return getattr(importlib.import_module(mod), attr)
