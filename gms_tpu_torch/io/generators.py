"""Synthetic graph generators: uniform and Kronecker (RMAT).

Covers GAPBS `Generator` (reference gms/third_party/gapbs/generator.h:39-108):
  * MakeUniformEL — uniform random endpoints, deterministic per-block seeding
    (generator.h:55-70: one RNG seeded per fixed-size block so results are
    independent of thread count). Here: one numpy Philox stream per block.
  * MakeRMatEL — Kronecker/RMAT with (A,B,C) = (0.57, 0.19, 0.19)
    (generator.h:72-92), Graph500-style.
  * scale -> n = 2^scale nodes, m = n * avg_degree edges, default degree 16
    (gapbs/command_line.h uniform/kronecker handling).

A copy of gms_tpu/io/generators.py: the same seed gives the same edge list,
bit for bit, so both packages count on the same graphs.
"""

from __future__ import annotations

import numpy as np

from gms_tpu_torch.graphs.csr import CSRGraph
from gms_tpu_torch.io.builder import build_csr

_BLOCK = 1 << 18


def _blocked_streams(num_items: int, seed: int):
    """Yield (start, stop, rng) with one counter-based stream per block."""
    for start in range(0, num_items, _BLOCK):
        stop = min(start + _BLOCK, num_items)
        yield start, stop, np.random.Generator(np.random.Philox(key=seed + (start // _BLOCK)))


def generate_uniform_el(scale: int, avg_degree: int = 16, seed: int = 27491095) -> np.ndarray:
    """Uniform random edge list: 2^scale nodes, n*avg_degree edges."""
    n = 1 << scale
    m = n * avg_degree
    edges = np.empty((m, 2), dtype=np.int64)
    for start, stop, rng in _blocked_streams(m, seed):
        edges[start:stop] = rng.integers(0, n, size=(stop - start, 2))
    return edges


def generate_rmat_el(
    scale: int,
    avg_degree: int = 16,
    seed: int = 27491095,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
) -> np.ndarray:
    """RMAT/Kronecker edge list (Graph500 parameters, generator.h:72-92).

    Bit-recursive quadrant selection, vectorized over all edges per block:
    per bit level, draw two uniforms deciding the src/dst bit, with the dst
    bit's distribution conditioned on the src bit (standard RMAT noise form
    used by GAPBS/Graph500).
    """
    n = 1 << scale
    m = n * avg_degree
    edges = np.zeros((m, 2), dtype=np.int64)
    ab = a + b
    a_norm = a / ab
    c_norm = c / (1.0 - ab)
    for start, stop, rng in _blocked_streams(m, seed):
        cnt = stop - start
        src = np.zeros(cnt, dtype=np.int64)
        dst = np.zeros(cnt, dtype=np.int64)
        for _bit in range(scale):
            src <<= 1
            dst <<= 1
            r1 = rng.random(cnt)
            r2 = rng.random(cnt)
            src_bit = r1 > ab
            dst_bit = np.where(src_bit, r2 > c_norm, r2 > a_norm)
            src |= src_bit
            dst |= dst_bit
        edges[start:stop, 0] = src
        edges[start:stop, 1] = dst
    return edges


def generate_graph(
    kind: str, scale: int, avg_degree: int = 16, seed: int = 27491095
) -> CSRGraph:
    """`-g {uniform|kronecker} scale [--deg d]` entry point (cli.h grammar)."""
    if kind == "uniform":
        el = generate_uniform_el(scale, avg_degree, seed)
    elif kind in ("kronecker", "rmat"):
        el = generate_rmat_el(scale, avg_degree, seed)
    else:
        raise ValueError(f"unknown generator kind: {kind!r}")
    return build_csr(el, num_nodes=1 << scale, symmetrize=True)
