"""A local world: `size` processes on this host joined in one
torch.distributed group over 127.0.0.1, each running fn(mesh, *args).

gms_tpu tests its mesh programs on a virtual 8-device CPU mesh inside one
process; a torch.distributed group needs one process a rank, so the port's
multi-rank runs (the gloo tests, chip_smoke.py's two ranks on one card)
start them here. The group's store listens on 127.0.0.1, on a port the
kernel picks: nothing leaves the host.
"""

from __future__ import annotations

import queue as queue_mod

import torch.distributed as dist
import torch.multiprocessing as mp

from gms_tpu_torch.device import resolve
from gms_tpu_torch.parallel.sharding import make_mesh

# seconds a world may take to give its results, and each rank to exit after
TIMEOUT = 300


def local_store() -> dist.TCPStore:
    """A store listening on 127.0.0.1, on a port the kernel picks
    (`.port`)."""
    return dist.TCPStore("127.0.0.1", 0, is_master=True,
                         wait_for_workers=False)


def init_local(backend: str, rank: int = 0, size: int = 1,
               port: int | None = None) -> dist.TCPStore:
    """Join the group of `size` ranks whose store listens on
    127.0.0.1:port; with no port, open the store here (local_store) first.
    Returns the store."""
    store = (local_store() if port is None
             else dist.TCPStore("127.0.0.1", port, is_master=False))
    dist.init_process_group(backend, store=store, rank=rank, world_size=size)
    return store


def _rank_main(rank, size, port, backend, devices, inbox, results):
    try:
        fn, args = inbox.get(timeout=TIMEOUT)
        init_local(backend, rank, size, port)
        try:
            results.put((rank, fn(make_mesh(devices=devices), *args), None))
        finally:
            dist.destroy_process_group()
    except BaseException as e:  # the parent raises it
        results.put((rank, None, f"{type(e).__name__}: {e}"))
        raise


def spawn_world(fn, size: int, *args, backend: str = "gloo",
                devices=None) -> list:
    """Run fn(mesh, *args) on `size` spawned ranks (make_mesh(devices=
    devices) in each) and return their results in rank order. The default
    is make_mesh's: rank r on card r mod the card count; without a card
    every rank raises, and so does this call. fn and args must pickle (fn
    a module-level function). Every process is joined before it returns; a
    rank that fails, or a world that gives no result within TIMEOUT
    seconds, raises here."""
    if devices is None:
        resolve("cuda")  # without a card, raise before any rank starts
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    # fn and args go through a queue, whose feeder thread does not block:
    # as Process arguments they would fill the pipe of each rank in turn
    # while it imports, and the ranks would start one after another
    inbox = ctx.Queue()
    store = local_store()  # held open until every rank has joined and left
    procs = [ctx.Process(target=_rank_main,
                         args=(r, size, store.port, backend, devices, inbox,
                               results)) for r in range(size)]
    for p in procs:
        p.start()
    for _ in procs:
        inbox.put((fn, args))
    out, errors = [None] * size, []
    try:
        waited, pending = 0, size
        while pending and not errors:
            try:
                rank, value, err = results.get(timeout=1.0)
            except queue_mod.Empty:
                waited += 1
                if any(p.exitcode not in (None, 0) for p in procs):
                    errors.append("ranks ended with "
                                  f"{[p.exitcode for p in procs]}")
                elif waited > TIMEOUT:
                    errors.append(f"no result in {TIMEOUT} s")
                continue
            pending -= 1
            if err:
                errors.append(f"rank {rank}: {err}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=TIMEOUT if not errors else 10)
            if p.is_alive():
                p.terminate()
                p.join()
                errors.append(f"rank {procs.index(p)} did not exit")
    if errors:
        raise RuntimeError("spawn_world: " + "; ".join(errors))
    return out
