"""The multi-device dry run: every sharded path of parallel/ once, on a
world of n ranks, each count held to its host oracle — the twin of
gms_tpu's entry point __graft_entry__.dryrun_multichip.

    python -c "from gms_tpu_torch.parallel.dryrun import dryrun_multichip;
               print(dryrun_multichip(2))"          # two ranks, the card

On RMAT-7 (scale 7, average degree 4, seed 3, 128 nodes): the edge-sharded
triangle count and the tuned ShardedTrianglePlan (hub_threshold 8) against
triangle_count_oracle; sharded_kclique_count at k = 4 and
VertexShardedKCliquePlan at k = 4 and 6 against kclique_count_oracle;
VertexShardedBKPlan (root_chunk 16, batch 64) against bron_kerbosch_simple.
With n >= 2 the two vertex-sharded plans' table_bytes_per_device must shrink
against a mesh of one (make_mesh(1)), as gms_tpu's dry run checks.
"""

from __future__ import annotations

from gms_tpu_torch.parallel import multi, sharding, world

SCALE, DEGREE, SEED = 7, 4, 3


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {what}")


def _dryrun_rank(mesh) -> dict:
    """One rank's dry run (world.spawn_world pickles it by name)."""
    from gms_tpu_torch.algorithms.bron_kerbosch import bron_kerbosch_simple
    from gms_tpu_torch.algorithms.k_clique import kclique_count_oracle
    from gms_tpu_torch.algorithms.triangle_count import triangle_count_oracle
    from gms_tpu_torch.io.builder import build_csr
    from gms_tpu_torch.io.generators import generate_rmat_el

    n = mesh.size
    g = build_csr(generate_rmat_el(SCALE, DEGREE, seed=SEED),
                  num_nodes=1 << SCALE)
    got = {}
    want = triangle_count_oracle(g)
    got["triangles"] = sharding.sharded_triangle_count(g, mesh, chunk=64,
                                                       method="compare")
    _check(got["triangles"] == want,
           f"sharded count {got['triangles']} != oracle {want}")
    got["tuned"] = sharding.ShardedTrianglePlan(g, mesh, hub_threshold=8).run()
    _check(got["tuned"] == want, f"sharded plan {got['tuned']} != {want}")

    want4 = kclique_count_oracle(g, 4)
    got["k4"] = multi.sharded_kclique_count(g, 4, mesh,
                                            root_chunk_per_shard=8)
    _check(got["k4"] == want4, f"sharded 4-clique {got['k4']} != {want4}")
    vk = sharding.VertexShardedKCliquePlan(g, mesh, k=4, root_chunk=16)
    got["k4_ring"] = vk.run()
    _check(got["k4_ring"] == want4,
           f"memory-sharded 4-clique {got['k4_ring']} != {want4}")
    want6 = kclique_count_oracle(g, 6)
    got["k6_ring"] = sharding.VertexShardedKCliquePlan(
        g, mesh, k=6, root_chunk=16).run()
    _check(got["k6_ring"] == want6,
           f"memory-sharded 6-clique {got['k6_ring']} != {want6}")

    wantbk = len(bron_kerbosch_simple(g))
    bkp = sharding.VertexShardedBKPlan(g, mesh, root_chunk=16, batch=64)
    got["bk_ring"] = bkp.run()
    _check(got["bk_ring"] == wantbk,
           f"memory-sharded BK {got['bk_ring']} != {wantbk}")

    if n >= 2:  # the per-device tables must shrink with N
        one = sharding.make_mesh(1, devices=mesh.device)
        if one is not None:
            vk1 = sharding.VertexShardedKCliquePlan(g, one, k=4,
                                                    root_chunk=16)
            bk1 = sharding.VertexShardedBKPlan(g, one, root_chunk=16,
                                               batch=64)
            for what, mine, whole in (
                    ("k-clique", vk, vk1), ("BK", bkp, bk1)):
                _check(mine.table_bytes_per_device
                       <= whole.table_bytes_per_device // (n // 2),
                       f"{what} table bytes {mine.table_bytes_per_device} "
                       f"on {n} ranks against "
                       f"{whole.table_bytes_per_device} on one")
            got["table_bytes"] = {
                "k-clique": (vk.table_bytes_per_device,
                             vk1.table_bytes_per_device),
                "bk": (bkp.table_bytes_per_device,
                       bk1.table_bytes_per_device)}
    got["staged"] = dict(mesh.staged)
    return got


def dryrun_multichip(n: int, *, backend: str = "gloo", devices=None) -> list:
    """Run the dry run on n spawned ranks (world.spawn_world) and return
    each rank's counts, in rank order; raises if a count differs from its
    oracle. devices: make_mesh's (default the card: rank r on card r mod
    the card count; raises without one); "cpu" runs the plain versions."""
    return world.spawn_world(_dryrun_rank, n, backend=backend,
                             devices=devices)
