"""Sharded counting over torch.distributed — the port of
gms_tpu/parallel/sharding.py: the mesh, the edge-sharded triangle count, the
tuned sharded triangle plan and the three ring-streamed vertex-sharded plans.

gms_tpu runs one shard_map program over a 1-D device mesh. Here a "mesh" is
a torch.distributed group (`make_mesh`): each rank is one shard and runs on
its own device, psum is an all_reduce of an int64 tensor, and `ppermute`,
one hop of the ring, is a send/recv pair. Without an initialised group the
mesh is a world of one. Every rank must make the same collective calls in
the same order, as every device runs the same program: each plan's `run` is
collective, its constructor (host layout, device copies) is not.

  * `sharded_triangle_count` — the DAG edges split evenly over the ranks,
    the adjacency replicated; K1's gather entry (count_dag_edges).
  * `ShardedTrianglePlan` — TrianglePlan's tier edges and hub groups dealt
    round-robin over the ranks; K1's and K2's gather entries on each share.
  * `VertexShardedTrianglePlan` — the adjacency itself hash-owner sharded
    (`_hash_owner_layout`); rotation t counts the edge bucket whose v-rows
    the visiting shard holds (K40, count_dag_edges_cross), and the visiting
    shard moves one hop between rotations (N - 1 hops).
  * `VertexShardedKCliquePlan` and `VertexShardedBKPlan` — per root chunk,
    N rotations fold the visiting shard's rows into the chunk's local
    adjacency (and BK's cover bitsets) as membership bits (K39,
    k_clique.member_pack), N - 1 hops; then the single-device counts
    finish: K38,
    K5 or K6 for k-cliques, K7 and K9 for BK.

With the gloo backend, CUDA tensors go through the host for each collective
and hop (`Mesh.staged` counts them); NCCL takes them on the card. NCCL takes
one rank per GPU, so two ranks on one card go over gloo.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from gms_tpu_torch.algorithms import bron_kerbosch as bk
from gms_tpu_torch.algorithms import k_clique as kc
from gms_tpu_torch.algorithms.triangle_count import (
    TrianglePlan, count_dag_edges, count_dag_edges_cross, count_hub_groups,
    cross_schedule, timed_trials)
from gms_tpu_torch.device import resolve
from gms_tpu_torch.graphs.tiles import PaddedGraph, SENTINEL, round_up
from gms_tpu_torch.preprocessing import degeneracy, orient

WORK_AXIS = "work"

_SENT = int(SENTINEL)

@dataclass
class Mesh:
    """One rank's view of a 1-D mesh (its axis is WORK_AXIS): the process
    group (None for a world of one), this rank, the mesh size, this rank's
    device, and the collectives and ring hops whose CUDA tensors went
    through the host."""
    group: object
    rank: int
    size: int
    device: torch.device
    staged: dict = field(default_factory=lambda: {
        "all_reduce": 0, "all_gather": 0, "send_recv": 0})


def make_mesh(n_devices: int | None = None, *, devices=None) -> Mesh | None:
    """The mesh of the first `n_devices` ranks of the default
    torch.distributed group (default all of them), or a world of one when
    none is initialised.

    With n_devices smaller than the world, every rank must call this, as
    the group is made collectively (dist.new_group; a mesh of one needs no
    group): ranks below n_devices get the mesh, the others None, and pass
    it to nothing. n_devices larger than the world raises.

    devices: one device for every rank of the mesh (a string or
    torch.device), or a sequence with one per rank; default "cuda", rank r
    on card r mod the card count (raises without a card).
    """
    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
        rank, size = dist.get_rank(group), dist.get_world_size(group)
    else:
        group, rank, size = None, 0, 1
    if n_devices is not None and n_devices != size:
        if not 1 <= n_devices <= size:
            raise ValueError(f"make_mesh: {n_devices} devices in a world of "
                             f"{size}")
        sub = (dist.new_group(list(range(n_devices))) if n_devices > 1
               else None)
        if rank >= n_devices:
            return None
        group, size = sub, n_devices
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
    if (dev.type == "cuda" and group is not None
            and dist.get_backend(group) == "nccl"):
        torch.cuda.set_device(dev)  # NCCL's send/recv need it
    return Mesh(group, rank, size, dev)


def _need_mesh(mesh, what: str) -> Mesh:
    if mesh is None:
        raise ValueError(f"{what}: this rank is outside the mesh "
                         "(make_mesh(n_devices) gave it None)")
    return mesh


def _staged(mesh: Mesh, t: torch.Tensor, what: str) -> bool:
    """Whether a collective on t must go through the host: gloo and CUDA."""
    stage = t.is_cuda and dist.get_backend(mesh.group) == "gloo"
    mesh.staged[what] += stage
    return stage


def psum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of t over the mesh's ranks (shard_map's psum): all_reduce
    SUM, in a new tensor on t's device (a world of one only copies)."""
    if mesh.size == 1:
        return t.clone()
    stage = _staged(mesh, t, "all_reduce")
    out = t.cpu() if stage else t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
    return out.to(t.device) if stage else out


def all_gather(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's t (equal shapes), concatenated along dim 0 in rank
    order: the sharded output of a shard_map, gathered."""
    if mesh.size == 1:
        return t
    stage = _staged(mesh, t, "all_gather")
    src = t.cpu() if stage else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts).to(t.device)


def ppermute(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """One hop of the ring, gms_tpu's ppermute with perm (i, i-1 mod N):
    rank i sends t to rank i-1 and returns, in a new tensor on t's device,
    what rank i+1 sent (every rank's t of one shape and type). Both are
    posted at once (a blocking send first deadlocks a ring under NCCL) into
    a second buffer, never into t. At N = 1 it returns t and makes no
    call."""
    if mesh.size == 1:
        return t
    stage = _staged(mesh, t, "send_recv")
    src = t.cpu() if stage else t.contiguous()
    buf = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, (mesh.rank - 1) % mesh.size,
                      group=mesh.group),
           dist.P2POp(dist.irecv, buf, (mesh.rank + 1) % mesh.size,
                      group=mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return buf.to(t.device) if stage else buf


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
    mesh = _need_mesh(mesh, "sharded_triangle_count")
    if rank is None:
        rank = orient.degree_rank(g)
    dag = orient.orient(g, rank)
    pg = PaddedGraph.from_csr(dag, device=mesh.device)
    edges, valid = pad_edges_sharded(dag.edge_array(), chunk, mesh.size)
    fn = sharded_edge_count_fn(mesh, chunk=chunk, method=method)
    return int(fn(pg.nbr, torch.from_numpy(edges).to(mesh.device),
                  torch.from_numpy(valid).to(mesh.device)))


# ---------------------------------------------------------------------------
# host layouts (numpy, gms_tpu's)
# ---------------------------------------------------------------------------

def _hash_owner_layout(nbr: np.ndarray, N: int):
    """Hash-owner shard layout shared by the memory-scaling plans:
    Fibonacci-hash each vertex id to an owner device (raw ids have biased
    low bits on RMAT graphs), compact each owner's rows into a common
    padded shard. Returns (table [N, Vs, D], owner_all, loc_all, Vs).
    gms_tpu's (sharding.py:251), unchanged: the hash is uint64 arithmetic,
    which stays in numpy."""
    V_pad, D = nbr.shape
    ids = np.arange(V_pad, dtype=np.uint64)
    hsh = (ids * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(32)
    owner_all = (hsh % np.uint64(N)).astype(np.int64)
    vorder = np.argsort(owner_all, kind="stable")
    counts_o = np.bincount(owner_all, minlength=N)
    starts_o = np.concatenate([[0], np.cumsum(counts_o)[:-1]])
    loc_all = np.empty(V_pad, np.int64)
    loc_all[vorder] = np.arange(V_pad) - np.repeat(starts_o, counts_o)
    Vs = round_up(int(counts_o.max(initial=1)), 8)
    table = np.full((N * Vs, D), np.int32(SENTINEL))
    table[owner_all * Vs + loc_all] = nbr
    return (table.reshape(N, Vs, D), owner_all.astype(np.int32),
            loc_all.astype(np.int32), Vs)


def _edge_buckets(edges: np.ndarray, owner_all, loc_all, N: int, chunk: int,
                  D: int):
    """The DAG edges of VertexShardedTrianglePlan in buckets (owner d,
    rotation t), each edge as (its row in d's shard, its other row in shard
    (d + t) mod N): (eb int32[N, N, E, 2], vb int32[N, N, E], the modelled
    gather bytes of each owner). gms_tpu's layout (sharding.py:142-184),
    unchanged: each owner-pair class alternates between its two owners."""
    owner_all = owner_all.astype(np.int64)
    loc_all = loc_all.astype(np.int64)
    u, v = edges[:, 0], edges[:, 1]
    ou, lu = owner_all[u], loc_all[u]
    ov, lv = owner_all[v], loc_all[v]
    amin, amax = np.minimum(ou, ov), np.maximum(ou, ov)
    key = amin * N + amax
    korder = np.argsort(key, kind="stable")
    ks = key[korder]
    kstarts = np.concatenate([[0], np.nonzero(np.diff(ks))[0] + 1]) \
        if len(ks) else np.zeros(0, np.int64)
    ksizes = np.diff(np.concatenate([kstarts, [len(ks)]])) \
        if len(ks) else np.zeros(0, np.int64)
    cc = np.arange(len(ks)) - np.repeat(kstarts, ksizes)
    pick_min = (cc % 2) == 0
    osu, osv = ou[korder], ov[korder]
    lsu, lsv = lu[korder], lv[korder]
    own = np.where(pick_min, np.minimum(osu, osv), np.maximum(osu, osv))
    u_owned = own == osu
    loc = np.where(u_owned, lsu, lsv)
    rem = np.where(u_owned, lsv, lsu)
    t_of = (np.where(u_owned, osv, osu) - own) % N
    counts = np.zeros((N, N), np.int64)
    np.add.at(counts, (own, t_of), 1)
    E = round_up(max(int(counts.max()), 1), chunk)
    eb = np.zeros((N, N, E, 2), np.int32)
    vb = np.zeros((N, N, E), np.int32)
    order = np.lexsort((t_of, own))
    sou, st = own[order], t_of[order]
    slu, slv = loc[order], rem[order]
    slot = np.arange(len(order)) - np.repeat(
        np.concatenate([[0], np.cumsum(counts.reshape(-1))[:-1]]),
        counts.reshape(-1))
    eb[sou, st, slot, 0] = slu
    eb[sou, st, slot, 1] = slv
    vb[sou, st, slot] = 1
    return eb, vb, (counts.sum(axis=1) * 2 * D * 4).astype(np.int64)


def _roots_pad(roots: np.ndarray, owner_all, N: int, root_chunk: int):
    """int32[N, Rp] each owner's roots, padded with -1 to a multiple of
    root_chunk: gms_tpu's roots_pad (sharding.py:340-348, :532-540)."""
    own_of_root = owner_all[roots]
    counts_r = np.bincount(own_of_root, minlength=N)
    Rp = round_up(int(counts_r.max(initial=1)), root_chunk)
    roots_pad = np.full((N, Rp), -1, np.int32)
    for d in range(N):
        mine = roots[own_of_root == d]
        roots_pad[d, : len(mine)] = mine
    return roots_pad


def _lower_table(g, rank, owner_all, loc_all, N: int, Vs: int, V_pad: int):
    """BK's lower-neighbour lists padded to INp (the widest, rounded up to
    32) and sharded like the DAG table: (ltable int32[N, Vs, INp], INp).
    gms_tpu's (sharding.py:325-338)."""
    lo_indptr, lo_cols = bk._lower_neighbor_csr(g, rank)
    indeg = (lo_indptr[1:] - lo_indptr[:-1]).astype(np.int64)
    INp = round_up(max(int(indeg.max(initial=1)), 1), 32)
    wl_all = np.full((V_pad, INp), np.int32(SENTINEL))
    E = int(indeg.sum())
    if E:
        rows_w = np.repeat(np.arange(g.num_nodes), indeg)
        cols_w = (np.arange(E)
                  - np.repeat(lo_indptr[:-1].astype(np.int64), indeg))
        wl_all[rows_w, cols_w] = lo_cols[:E]
    ltable = np.full((N, Vs, INp), np.int32(SENTINEL))
    ltable.reshape(N * Vs, INp)[
        owner_all.astype(np.int64) * Vs + loc_all] = wl_all
    return ltable, INp


def _host_nbr(dag, lane: int = 128) -> np.ndarray:
    """The padded rows of a DAG on the host (PaddedGraph's layout)."""
    return PaddedGraph.from_csr(dag, device="cpu", lane=lane).nbr.numpy()


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------

class VertexShardedTrianglePlan:
    """MEMORY-scaling multi-device triangle count: the adjacency table
    itself is sharded. gms_tpu's (sharding.py:93).

    Each rank owns the padded DAG rows of the vertices hashed to it
    (`_hash_owner_layout`); each DAG edge lives with one of its endpoints'
    owners, in the bucket of the rotation at which the other endpoint's
    shard visits. Rotation t counts bucket (me, t) with K40
    (count_dag_edges_cross: u's rows from the owned shard, v's from the
    visiting one), and the visiting shard moves one hop between rotations;
    N rotations (N - 1 hops: gms_tpu's scan also makes a last hop, which
    only brings the owned shard home and which nothing reads), then psum.
    Each bucket's K40 schedule (its valid edges by owned row, in work
    items: cross_schedule) is built once, on the device, with the plan.
    Per-device memory: two table shards (own + visiting), this rank's edge
    buckets and their schedules. `chunk` and `method` only shape K40's
    plain version. `run` and `run_steady` are collective.
    """

    def __init__(self, g, mesh: Mesh, *, rank=None, chunk: int = 1024,
                 method: str = "auto"):
        self.mesh = mesh = _need_mesh(mesh, "VertexShardedTrianglePlan")
        N = self.n_devices = mesh.size
        if rank is None:
            rank = orient.degree_rank(g)
        dag = orient.orient(g, rank)
        nbr = _host_nbr(dag)
        table, owner_all, loc_all, _Vs = _hash_owner_layout(nbr, N)
        self.num_edges_undirected = g.num_edges_undirected
        eb, vb, self._model_bytes = _edge_buckets(
            dag.edge_array(), owner_all, loc_all, N, chunk, nbr.shape[1])
        self.table_bytes_per_device = int(table.nbytes) // N
        self.edge_bytes_per_device = int(eb.nbytes + vb.nbytes) // N
        dev, me = mesh.device, mesh.rank
        self._own = torch.from_numpy(table[me]).to(dev)
        self._eb = torch.from_numpy(eb[me]).to(dev)           # [N, E, 2]
        self._vb = torch.from_numpy(vb[me]).to(dev)           # [N, E]
        # rotation t visits shard (me + t) mod N: its rows' live lengths
        lens = np.zeros(N * _Vs, np.int32)
        lens[owner_all.astype(np.int64) * _Vs + loc_all] = \
            (nbr != _SENT).sum(1)
        lens = lens.reshape(N, _Vs)
        self._sched = [cross_schedule(
            self._eb[t], self._vb[t],
            torch.from_numpy(lens[(me + t) % N]).to(dev)) for t in range(N)]
        self._chunk, self._method = chunk, method

    def _count(self) -> torch.Tensor:
        acc = torch.zeros((), dtype=torch.int64, device=self._own.device)
        vis = self._own
        for t in range(self.n_devices):
            if t:
                vis = ppermute(vis, self.mesh)
            acc = acc + count_dag_edges_cross(
                self._own, vis, self._eb[t], self._vb[t], chunk=self._chunk,
                method=self._method, schedule=self._sched[t])
        return psum(acc, self.mesh)

    def run(self) -> int:
        return int(self._count())

    def run_steady(self, trials: int = 4):
        """(count, seconds a trial) over `trials` runs after one untimed
        run: CUDA events on the card, the host clock on the CPU."""
        return timed_trials(self._count, self.mesh.device, trials)

    def shard_work_model(self) -> np.ndarray:
        """Modelled gather bytes of each owner's edges (balance
        diagnostic)."""
        return self._model_bytes


class _RingPlan:
    """What the ring-built plans share: the hash-owner sharded DAG table at
    lane 32 (W = D, the whole DAG's padded width), the replicated owner and
    local-id maps, this rank's padded roots, and the ring pass that folds
    each visiting shard into a chunk's bitsets."""

    def _layout(self, g, mesh, rank, roots_of, root_chunk: int):
        self.mesh = mesh
        N = self.n_devices = mesh.size
        if rank is None:
            rank, _ = degeneracy.degeneracy_ordering_rank(g)
        rank = np.asarray(rank)
        dag = orient.orient(g, rank)
        nbr = _host_nbr(dag, lane=32)
        self.v_pad, W = nbr.shape
        self.w_words = W // 32
        table, owner_all, loc_all, Vs = _hash_owner_layout(nbr, N)
        roots_pad = _roots_pad(roots_of(dag), owner_all, N, root_chunk)
        self.root_chunk = root_chunk
        self.idmap_bytes_per_device = int(owner_all.nbytes + loc_all.nbytes)
        dev, me = mesh.device, mesh.rank
        self._own = torch.from_numpy(table[me]).to(dev)
        self._roots = torch.from_numpy(roots_pad[me]).to(dev)
        self._owner = torch.from_numpy(owner_all).to(dev)
        self._loc = torch.from_numpy(loc_all).to(dev)
        self._vs = Vs
        return rank, table, owner_all, loc_all

    def _chunks(self):
        """This rank's root chunks, int32[root_chunk] (pad -1) each."""
        return self._roots.split(self.root_chunk)

    def _lookup(self, ids):
        """(owner, local row) of vertex ids int32[...] (SENTINEL clips to
        the guard row V_pad-1; the caller masks those)."""
        safe = ids.clamp(max=self.v_pad - 1).long()
        return self._owner[safe], self._loc[safe]

    def _root_rows(self, rc, table):
        """(live bool[C], rows int32[C, width]) of a chunk's roots in this
        rank's shard `table` (own DAG or lower-neighbour table), SENTINEL
        for pad roots."""
        live = rc >= 0
        rloc = self._loc[rc.clamp(min=0).long()].clamp(0, self._vs - 1)
        rows = torch.where(live[:, None], table[rloc.long()], _SENT)
        return live, rows

    def _ring(self, q, packs):
        """N rotations: at rotation t the visiting shard (owner (me+t) mod
        N) fills, in each (owner, locs, valid, out) of `packs`, the valid
        slots it owns (K39); it moves one hop between rotations."""
        N, me = self.n_devices, self.mesh.rank
        vis = self._own
        for t in range(N):
            if t:
                vis = ppermute(vis, self.mesh)
            for owner, locs, valid, out in packs:
                kc.member_pack(q, vis, locs,
                               valid & (owner == (me + t) % N), out)

    def _universe(self, rc):
        """A chunk's ring inputs: live bool[C], the root rows q int32[C,
        W], their validity bool[C, W], owners and local rows, and the local
        DAG adjacency int32[C, W, WW], zero until `_ring` fills it."""
        live, q = self._root_rows(rc, self._own)
        valid = q != _SENT
        owner, locs = self._lookup(q)
        W, WW = q.shape[1], self.w_words
        adj = torch.zeros((q.shape[0], W, WW), dtype=torch.int32,
                          device=q.device)
        return live, q, valid, owner, locs, adj

    def _built(self, rc):
        """A chunk's ring-built universe: (live bool[C], valid bool[C, W],
        adj int32[C, W, WW])."""
        live, q, valid, owner, locs, adj = self._universe(rc)
        self._ring(q, [(owner, locs, valid, adj)])
        return live, valid, adj


class VertexShardedKCliquePlan(_RingPlan):
    """MEMORY-scaling multi-device k-clique count (any k >= 3): gms_tpu's
    (sharding.py:483).

    The degeneracy-DAG table (lane 32) is hash-owner sharded as
    VertexShardedTrianglePlan's, and each rank counts the roots it owns
    (out-degree >= k-1), `root_chunk` at a time. A chunk's local adjacency
    needs its roots' out-neighbours' rows, which live on other shards: at
    rotation t the visiting shard ORs in the membership bits of the
    neighbours it owns (K39), then moves one hop; after N rotations adj
    [root_chunk, W, WW] is complete (W the whole DAG's padded width) and the
    single-device count finishes it: k = 3 Σ popcount (K38), k = 4, 5 K5,
    k >= 6 kc_stack_machine (K6). A ring pass a chunk, as gms_tpu's
    schedule, less its last hop home (N - 1 hops a chunk).
    The counts, and an overflow that is always 0 here, are all-reduced.
    `batch` and `stack_cap` sized gms_tpu's bounded stack and have no
    effect. `run` is collective.
    """

    def __init__(self, g, mesh: Mesh, *, k: int = 5, rank=None,
                 root_chunk: int = 64, batch: int = 128,
                 stack_cap: int = 1 << 15):
        if k < 3:
            raise ValueError("VertexShardedKCliquePlan needs k >= 3")
        mesh = _need_mesh(mesh, "VertexShardedKCliquePlan")
        _r, table, _o, _l = self._layout(
            g, mesh, rank, lambda dag: np.nonzero(
                np.asarray(dag.degrees) >= k - 1)[0].astype(np.int32),
            root_chunk)
        self.table_bytes_per_device = int(table.nbytes) // self.n_devices
        self._k = k

    def _count(self) -> torch.Tensor:
        k = self._k
        total = torch.zeros((), dtype=torch.int64, device=self._own.device)
        for rc in self._chunks():
            _live, valid, adj = self._built(rc)
            if k == 3:
                total = total + kc.total_popcount(adj)
            elif k <= 5:
                total = total + kc.kclique_dense_count(adj, k=k)
            else:
                cnt, _ovf, _done, _st = kc.kc_stack_machine(
                    adj, kc.pack_bits(valid), k=k)
                total = total + cnt
        overflow = torch.zeros_like(total)
        return psum(torch.stack([total, overflow]), self.mesh)

    def run(self) -> int:
        total, overflow = self._count().tolist()
        if overflow:
            raise RuntimeError("VertexShardedKCliquePlan overflow")
        return total


class VertexShardedBKPlan(_RingPlan):
    """MEMORY-scaling multi-device Bron–Kerbosch maximal-clique count:
    gms_tpu's (sharding.py:272).

    Both the degeneracy-DAG table and the padded lower-neighbour lists
    (`ltable`, INp wide: the widest list rounded up to 32) are hash-owner
    sharded; each rank counts the roots it owns, `root_chunk` at a time. Per
    chunk, N rotations of K39 fold the visiting shard into (a) the induced
    DAG adjacency over each root's row Q and (b) the cover bitsets M over
    its lower neighbours w_i (bit j: Q[j] in N⁺(w_i)), N - 1 hops; then
    K7 symmetrizes adj, S0 is Q's valid slots, and K9 (bk_stack_machine)
    counts with M as its leaf maximality filter. psum. `batch`, `stack_cap`
    and `leaf_cap` sized gms_tpu's bounded stack and leaf buffer, which K9
    has no counterpart of; they have no effect. `run` is collective.
    """

    def __init__(self, g, mesh: Mesh, *, rank=None, root_chunk: int = 64,
                 batch: int = 128, stack_cap: int = 1 << 15,
                 leaf_cap: int | None = None):
        mesh = _need_mesh(mesh, "VertexShardedBKPlan")
        rank, table, owner_all, loc_all = self._layout(
            g, mesh, rank,
            lambda dag: np.arange(g.num_nodes, dtype=np.int32), root_chunk)
        ltable, self.in_width = _lower_table(
            g, rank, owner_all, loc_all, self.n_devices, self._vs,
            self.v_pad)
        self.table_bytes_per_device = int(
            table.nbytes + ltable.nbytes) // self.n_devices
        self._lown = torch.from_numpy(ltable[mesh.rank]).to(mesh.device)

    def _built(self, rc):
        """A chunk's ring-built universe: (live, valid, adj) as the k-clique
        plan's, and the cover bitsets M int32[C, INp, WW] with their slots'
        validity wvalid bool[C, INp]."""
        live, q, valid, owner, locs, adj = self._universe(rc)
        _, wl = self._root_rows(rc, self._lown)
        wvalid = wl != _SENT
        w_owner, w_locs = self._lookup(wl)
        M = torch.zeros((q.shape[0], wl.shape[1], self.w_words),
                        dtype=torch.int32, device=q.device)
        self._ring(q, [(owner, locs, valid, adj),
                       (w_owner, w_locs, wvalid, M)])
        return live, valid, adj, M, wvalid

    def _count(self) -> torch.Tensor:
        total = torch.zeros((), dtype=torch.int64, device=self._own.device)
        for rc in self._chunks():
            live, valid, adj, M, wvalid = self._built(rc)
            total = total + bk.bk_stack_machine(
                bk.symmetrize_bits(adj), kc.pack_bits(valid), live, M,
                wvalid)
        return psum(total, self.mesh)

    def run(self) -> int:
        return int(self._count())


class ShardedTrianglePlan:
    """The TUNED TrianglePlan (2-D degree tiers + grouped hub-prefix
    bitmaps) over the mesh: gms_tpu's (sharding.py:694). The plan is built
    on this rank's device (gather mode); its tier edges and hub groups are
    dealt round-robin over the ranks (`deal`), and each rank runs K1's and
    K2's gather entries on its share, then psum. `tiers` and `hubs` hold
    the dealt host arrays of every rank, as gms_tpu's; on the device a rank
    keeps only its share, the padded rows `nbr` and the hub bitmaps
    (gms_tpu's `plan` attribute, whose tier and hub arrays would be a second
    copy of the undealt work, is not kept). gms_tpu's
    count-chained `shift` exists against its platform's memoized runs and
    has no counterpart. `run` and `run_steady` are collective.
    """

    def __init__(self, g, mesh: Mesh, *, rank=None, method: str = "compare",
                 hub_threshold: int | None = 65):
        self.mesh = mesh = _need_mesh(mesh, "ShardedTrianglePlan")
        n = mesh.size
        plan = TrianglePlan(g, device=mesh.device, rank=rank, method=method,
                            hub_threshold=hub_threshold, materialize=False)
        self.nbr = plan.padded.nbr
        self.num_edges_undirected = plan.num_edges_undirected
        self.method = method

        def deal(arr):
            """Items i, i+n, i+2n... to shard i (gms_tpu's deal, :717)."""
            order = np.concatenate([np.arange(i, len(arr), n)
                                    for i in range(n)])
            return arr[order]

        def mine(arr):
            return shard_rows(torch.from_numpy(arr), mesh).contiguous().to(
                mesh.device)

        self.tiers, self._tiers = [], []
        for wa, wb, c, edges, valid in plan.tiers:
            e, v = edges.cpu().numpy(), valid.cpu().numpy()
            ep = round_up(len(v), c * n)
            e2 = np.zeros((ep, 2), np.int32)
            e2[: len(v)] = e
            v2 = np.zeros(ep, np.int32)
            v2[: len(v)] = v
            e2, v2 = deal(e2), deal(v2)
            self.tiers.append((wa, wb, c, e2, v2))
            self._tiers.append((wa, wb, c, mine(e2), mine(v2)))
        self.hubs, self._hubs = [], []
        if plan.hub:
            guard = plan.hub_rows.shape[0] - 1
            for w, k, gc, b_ids, nbrs in plan.hub:
                b, nb = b_ids.cpu().numpy(), nbrs.cpu().numpy()
                gp = round_up(len(b), gc * n)
                b2 = np.full(gp, guard, np.int32)
                b2[: len(b)] = b
                n2 = np.full((gp, k), guard, np.int32)
                n2[: len(b)] = nb
                b2, n2 = deal(b2), deal(n2)
                self.hubs.append((w, k, gc, b2, n2))
                self._hubs.append((w, k, gc, mine(b2), mine(n2)))
        self.hub_rows = (plan.hub_rows if plan.hub else torch.zeros(
            (1, 1), dtype=torch.int32, device=mesh.device))

    def _count(self) -> torch.Tensor:
        nbr = self.nbr
        total = torch.zeros((), dtype=torch.int64, device=nbr.device)
        for wa, wb, c, e, v in self._tiers:
            total = total + count_dag_edges(nbr, e, v, chunk=c,
                                            method=self.method, width_a=wa,
                                            width_b=wb)
        for w, k, gc, b, nn in self._hubs:
            total = total + count_hub_groups(self.hub_rows, b, nn, chunk=gc,
                                             width=w, k=k)
        return psum(total, self.mesh)

    def run(self) -> int:
        return int(self._count())

    def run_steady(self, trials: int = 8):
        """(count, seconds a trial) over `trials` runs after one untimed
        run: CUDA events on the card, the host clock on the CPU; the counts
        must agree. gms_tpu's contract (:808)."""
        return timed_trials(self._count, self.mesh.device, trials)

    def shard_work_model(self) -> np.ndarray:
        """Modelled gather bytes per shard (work-balance diagnostic):
        gms_tpu's (:823)."""
        n = self.mesh.size
        work = np.zeros(n, dtype=np.int64)
        for wa, wb, c, edges, valid in self.tiers:
            work += valid.reshape(n, -1).sum(axis=1).astype(np.int64) \
                * (wa + wb) * 4
        if self.hubs:
            guard = self.hub_rows.shape[0] - 1
            for w, k, gc, b_ids, nbrs in self.hubs:
                work += (nbrs.reshape(n, -1) != guard).sum(axis=1).astype(
                    np.int64) * w * 4
        return work
