"""Sharded counting over torch.distributed — the port of the first part of
gms_tpu/parallel/sharding.py (:1-90): the mesh, the padded edge shards and
the edge-sharded triangle count.

gms_tpu runs one shard_map program over a 1-D device mesh: the adjacency
replicated, the edges split evenly along the work axis, the per-shard exact
counts summed by psum. Here a "mesh" is a torch.distributed group: each rank
is one shard and runs on its own device, every rank holds the replicated
tables and the whole padded edge array and counts its contiguous share (the
block shard_map's P(WORK_AXIS) gives device i), and psum is an all_reduce of
an int64 tensor. Without an initialised group the mesh is a world of one.
Every rank must make the same calls in the same order, as every device runs
the same program.

With the gloo backend, CUDA tensors are staged through the host for each
collective (`Mesh.staged` counts them); NCCL takes them on the card. NCCL takes
one rank per GPU, so two ranks on one card go over gloo.

The triangle count's device work is K1's gather entry (count_dag_edges,
csrc/tier_intersect.cu). The vertex-sharded plans that stream rows around a
ring (:93-694) are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from gms_tpu_torch.algorithms.triangle_count import count_dag_edges
from gms_tpu_torch.device import resolve
from gms_tpu_torch.graphs.tiles import PaddedGraph, round_up

WORK_AXIS = "work"


@dataclass
class Mesh:
    """One rank's view of a 1-D mesh (its axis is WORK_AXIS): the process
    group (None for a world of one), this rank, the world size, this rank's
    device, and the collectives whose CUDA tensors went through the host."""
    group: object
    rank: int
    size: int
    device: torch.device
    staged: dict = field(default_factory=lambda: {"all_reduce": 0,
                                                  "all_gather": 0})


def make_mesh(*, devices=None) -> Mesh:
    """The mesh of the default torch.distributed group, or a world of one
    when none is initialised.

    devices: one device for every rank (a string or torch.device), or a
    sequence with one per rank; default "cuda", rank r on card r mod the
    card count (raises without a card).
    """
    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
        rank, size = dist.get_rank(group), dist.get_world_size(group)
    else:
        group, rank, size = None, 0, 1
    if devices is None:
        resolve("cuda")  # raises without a card
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    elif isinstance(devices, (str, torch.device)):
        dev = resolve(devices)
    else:
        devices = list(devices)
        if len(devices) != size:
            raise ValueError(f"make_mesh: {len(devices)} devices for "
                             f"{size} ranks")
        dev = resolve(devices[rank])
    return Mesh(group, rank, size, dev)


def _staged(mesh: Mesh, t: torch.Tensor, what: str) -> bool:
    """Whether a collective on t must go through the host: gloo and CUDA."""
    stage = t.is_cuda and dist.get_backend(mesh.group) == "gloo"
    mesh.staged[what] += stage
    return stage


def psum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of t over the mesh's ranks (shard_map's psum): all_reduce
    SUM, in a new tensor on t's device (a world of one only copies)."""
    if mesh.group is None:
        return t.clone()
    stage = _staged(mesh, t, "all_reduce")
    out = t.cpu() if stage else t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
    return out.to(t.device) if stage else out


def all_gather(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's t (equal shapes), concatenated along dim 0 in rank
    order: the sharded output of a shard_map, gathered."""
    if mesh.group is None:
        return t
    stage = _staged(mesh, t, "all_gather")
    src = t.cpu() if stage else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts).to(t.device)


def shard_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous share of x's rows (x.shape[0] divisible by
    the world size), as shard_map's P(WORK_AXIS) splits an input."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split evenly over {mesh.size} "
                         "ranks")
    per = n // mesh.size
    return x[mesh.rank * per:(mesh.rank + 1) * per]


def pad_edges_sharded(edges: np.ndarray, chunk: int, n_shards: int):
    """Pad an edge array so it splits evenly into n_shards of
    chunk-multiples. gms_tpu's, unchanged."""
    e = len(edges)
    ep = round_up(max(e, 1), chunk * n_shards)
    out = np.zeros((ep, 2), dtype=np.int32)
    out[:e] = edges
    valid = np.zeros(ep, dtype=np.int32)
    valid[:e] = 1
    return out, valid


def sharded_edge_count_fn(mesh: Mesh, *, chunk: int, method: str = "auto"):
    """The multi-device Σ|N⁺(u)∩N⁺(v)| step: fn(nbr, edges, valid) -> int64
    0-d tensor, the sum over every rank's share. nbr is replicated; each rank
    holds the whole padded edges int32[E_pad, 2] and valid int32[E_pad]
    (E_pad a multiple of chunk × world size) and counts its contiguous share
    with count_dag_edges (K1's gather entry); `chunk` and `method` step its
    plain version."""

    def fn(nbr, edges, valid):
        e, v = shard_rows(edges, mesh), shard_rows(valid, mesh)
        if e.shape[0] % chunk:
            raise ValueError(f"a shard of {e.shape[0]} edges is not a "
                             f"multiple of chunk {chunk}")
        local = count_dag_edges(nbr, e.contiguous(), v.contiguous(),
                                chunk=chunk, method=method)
        return psum(local, mesh)

    return fn


def sharded_triangle_count(g, mesh: Mesh, *, rank=None, chunk: int = 1024,
                           method: str = "auto") -> int:
    """End-to-end multi-device triangle count of a host CSRGraph: orient by
    `rank` (default the degree rank), pad, shard the DAG edges over the
    mesh, count, all-reduce."""
    from gms_tpu_torch.preprocessing import orient

    if rank is None:
        rank = orient.degree_rank(g)
    dag = orient.orient(g, rank)
    pg = PaddedGraph.from_csr(dag, device=mesh.device)
    edges, valid = pad_edges_sharded(dag.edge_array(), chunk, mesh.size)
    fn = sharded_edge_count_fn(mesh, chunk=chunk, method=method)
    return int(fn(pg.nbr, torch.from_numpy(edges).to(mesh.device),
                  torch.from_numpy(valid).to(mesh.device)))
