"""Multi-device algorithm scaling beyond the edge-sharded triangle count —
the port of gms_tpu/parallel/multi.py.

Three patterns, as gms_tpu's:

  * `sharded_kclique_count` — root chunks split over the mesh's ranks: each
    rank builds its roots' local adjacency (K4) once a chunk, before the
    chunk's cap doublings (the adjacency does not depend on the caps;
    gms_tpu rebuilds it inside its jitted step), then expands them k-2 levels
    breadth-wise with fixed capacities (K37, expand_level; each level after
    the first walks only the previous level's survivors, their count handed
    over on the device) and sums the last level's popcounts (K38); the
    counts and the children dropped past the capacities are all-reduced. Every rank sees the same overflow, so all
    re-run the chunk with doubled capacities together (count-then-emit,
    distributed: an overflow is a re-run, never a wrong answer); the
    capacities start again for each chunk.
  * `device_parallel_map` — independent jobs round-robin over the devices of
    one process (PyTorch launches asynchronously, so the devices overlap),
    used for Bron–Kerbosch, whose chunks diverge in depth
    (`sharded_bron_kerbosch_count`, through bron_kerbosch._bk_fused).
  * `sharded_pair_scores` — pair batches split over the ranks, adjacency
    replicated: K18 (pair_scores) on this rank's pairs, then an all_gather
    into the full score vector.

A mesh is sharding.Mesh: a torch.distributed group and this rank's device,
or a world of one.
"""

from __future__ import annotations

import numpy as np
import torch

from gms_tpu_torch.algorithms.k_clique import (
    build_local_adj, expand_level, total_popcount)
from gms_tpu_torch.device import resolve
from gms_tpu_torch.graphs.csr import CSRGraph
from gms_tpu_torch.graphs.tiles import PaddedGraph
from gms_tpu_torch.parallel.sharding import (
    Mesh, all_gather, make_mesh, psum, shard_rows)
from gms_tpu_torch.preprocessing import degeneracy, orient

__all__ = [
    "sharded_kclique_count", "device_parallel_map", "sharded_pair_scores",
    "sharded_bron_kerbosch_count",
]


def _sharded_kclique_step(mesh: Mesh, adj, S, *, k: int, caps):
    """This rank's roots' local adjacency adj int32[C, W, WW] and S0
    int32[C, WW] (build_local_adj) -> int64[2]: (count, children dropped
    past the capacities), each summed over the mesh. gms_tpu's
    _sharded_kclique_step (:41) after its build_local_adj."""
    R = torch.arange(S.shape[0], dtype=torch.int32, device=S.device)
    overflow = torch.zeros((), dtype=torch.int64, device=S.device)
    remaining = k - 1
    n = None  # a level's rows past min(cap, n_children) are zero
    for cap in caps:
        S, R, n, _pcs = expand_level(S, R, adj, cap=cap, need=remaining - 1,
                                     n_live=n)
        overflow = overflow + (n - cap).clamp(min=0)
        remaining -= 1
    return psum(torch.stack([total_popcount(S), overflow]), mesh)


def sharded_kclique_count(
    g: CSRGraph, k: int, mesh: Mesh | None = None, *,
    rank: np.ndarray | None = None, root_chunk_per_shard: int = 256,
    stats: dict | None = None,
) -> int:
    """Exact k-clique count with roots sharded over the mesh (default
    make_mesh()). Every rank must call it with the same graph. With `stats`,
    adds stats["chunks"] and stats["doublings"], the chunks' re-runs."""
    if k < 3:
        from gms_tpu_torch.algorithms.k_clique import kclique_count

        return kclique_count(g, k, device=mesh.device if mesh else "cuda")
    mesh = mesh or make_mesh()
    n_shards = mesh.size
    if rank is None:
        rank, _ = degeneracy.degeneracy_ordering_rank(g)
    dag = orient.orient(g, rank)
    pg = PaddedGraph.from_csr(dag, device=mesh.device, lane=32)
    W, WW = pg.d_pad, pg.d_pad // 32
    deg = np.asarray(dag.degrees)
    roots = np.nonzero(deg >= k - 1)[0].astype(np.int32)
    if len(roots) == 0:
        return 0
    pad_id = np.int32(pg.v_pad)
    step = root_chunk_per_shard * n_shards
    total = doublings = chunks = 0
    for start in range(0, len(roots), step):
        chunk = roots[start:start + step]
        if len(chunk) < step:
            chunk = np.concatenate(
                [chunk, np.full(step - len(chunk), pad_id, np.int32)])
        mine = shard_rows(torch.from_numpy(chunk), mesh).to(mesh.device)
        # level-1 fan-out is bounded by chunk * W; later levels start at
        # the same bound and double on overflow
        caps = [max(256, root_chunk_per_shard * W)] * (k - 2)
        chunks += 1
        adj, S0 = build_local_adj(pg.nbr, mine, w_words=WW)
        while True:
            cnt, overflow = _sharded_kclique_step(
                mesh, adj, S0, k=k, caps=caps).tolist()
            if overflow == 0:
                total += cnt
                break
            caps = [c * 2 for c in caps]
            doublings += 1
    if stats is not None:
        stats["chunks"] = stats.get("chunks", 0) + chunks
        stats["doublings"] = stats.get("doublings", 0) + doublings
    return total


def _cuda_devices():
    resolve("cuda")  # raises without a card
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def device_parallel_map(fn, jobs, devices=None):
    """Run independent jobs round-robin over devices (default every card);
    returns their results once every device has finished.

    fn(job, device) places its inputs on `device` and returns its tensors
    (launches are asynchronous, so the devices overlap)."""
    devices = ([torch.device(d) for d in devices] if devices is not None
               else _cuda_devices())
    handles = [fn(job, devices[i % len(devices)])
               for i, job in enumerate(jobs)]
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    return handles


def sharded_bron_kerbosch_count(
    g: CSRGraph, mesh_devices=None, *, ordering: str = "degeneracy",
    root_chunk: int = 4096,
) -> int:
    """Maximal-clique count with root chunks fanned out over the devices
    of this process (default every card), round-robin, every chunk
    launched before any count is read back.

    BK's search depth diverges per chunk, so chunks are independent jobs,
    not one program over the mesh — the reference's dynamic OpenMP schedule
    lifted to devices. Each chunk runs the fused DAG-universe path (K8, K4,
    K7, K9), which cannot overflow.
    """
    from gms_tpu_torch.algorithms import bron_kerbosch as bk

    devices = (list(mesh_devices) if mesh_devices is not None
               else _cuda_devices())
    n = g.num_nodes
    if n == 0:
        return 0
    rank = bk.ordering_rank(g, ordering)
    roots = np.arange(n, dtype=np.int32)
    total, _ = bk._bk_fused(g, np.asarray(rank), roots, devices,
                            root_chunk=root_chunk)
    return total


def sharded_pair_scores(mesh: Mesh, *, metric: str):
    """Multi-device pair-similarity scorer: fn(nbr, deg1, pairs) -> the
    float32 score of every pair. nbr and deg1 are replicated on this rank's
    device; each rank holds all pairs int32[B, 2] (B divisible by the world
    size), scores its contiguous share with pair_scores (K18) and gathers
    the others'."""
    from gms_tpu_torch.algorithms.similarity import pair_scores

    def fn(nbr, deg1, pairs):
        mine = shard_rows(pairs, mesh).contiguous().to(nbr.device)
        return all_gather(pair_scores(nbr, deg1, mine, metric=metric), mesh)

    return fn
