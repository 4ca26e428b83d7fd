"""The port's mining algorithms, one module each (as gms_tpu/algorithms/).

Each entry point below is also importable from here, loaded on first use."""

_LAZY = {
    "triangle_count": "triangle_count",
    "kclique_count": "k_clique",
    "bron_kerbosch": "bron_kerbosch",
    "kclique_star_list": "k_clique_star",
    "vertex_similarity": "similarity",
    "AUCPlan": "link_prediction",
    "jones_plassmann": "coloring",
    "johansson": "coloring",
    "barenboim_elkin": "coloring",
    "dense_sparse": "coloring",
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module 'gms_tpu_torch.algorithms' has no "
                             f"attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(
        f"gms_tpu_torch.algorithms.{_LAZY[name]}"), name)
