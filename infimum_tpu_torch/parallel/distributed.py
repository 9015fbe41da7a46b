"""Process groups over torch.distributed: one process per card.

Counterpart of `infimum_tpu/parallel/distributed.py`. The reference runs
one controller over a JAX mesh; here every rank is its own process, holds
its shard on its own device and meets the others in collectives: NCCL
across cards, gloo on the CPU (and across ranks that share a card, where
NCCL refuses two ranks on one card).

  - `initialize()` joins the group that torchrun's environment describes
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK) and returns
    False for a single process, as the reference does with JAX_*.
  - `proving_mesh()` names this rank, the world, its device and the group.
  - `host_shard(n)` is the rank's slice of a batch of n, and
    `global_array` puts its local shard on its device.
  - `spawn(fn, world_size, backend, device)` starts the ranks of one group
    on this host with the `spawn` start method (never `fork`: a child that
    touches CUDA after a fork fails), meeting at a store the launcher
    holds, and returns what each `fn(mesh, *args)` returned.
  - `all_gather`, `all_to_all`, `send` and `recv` are the collectives the
    sharded MSM, NTT and tree use. Under gloo a CUDA tensor is staged
    through host memory. Each adds the bytes it moves for this rank to
    the mesh's `sent` / `received`.

The backend is always the caller's explicit choice.
"""

from __future__ import annotations

import datetime
import os
import queue
import time
import traceback
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

# how long a rank waits to meet the others, and for any one collective:
# long enough for a card's first NCCL communicator, short enough that a
# rank that never comes fails the run within a few minutes
RENDEZVOUS_TIMEOUT_S = 120


@dataclass
class ProvingMesh:
    """One rank's view of a flat group of `world` processes."""

    rank: int
    world: int
    device: torch.device
    backend: str | None = None       # None: a single process, no group
    group: object = None
    sent: int = 0                    # bytes this rank's collectives sent
    received: int = 0                # ... and received

    def staged(self, t: torch.Tensor) -> bool:
        """Whether `t` goes through host memory: a CUDA tensor under gloo."""
        return self.backend == "gloo" and t.is_cuda

    def wire(self, t: torch.Tensor) -> torch.Tensor:
        """`t` as a collective takes it: contiguous, in host memory when
        staged."""
        return (t.cpu() if self.staged(t) else t).contiguous()


def _rank_device(device, local_rank: int) -> torch.device:
    """`device` with a bare "cuda" resolved to card `local_rank`; that
    card is made current before any CUDA work of the rank."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    return dev


def join_group(backend: str, world_size: int, rank: int, device="cuda",
               local_rank: int = 0, store=None) -> ProvingMesh:
    """Set this rank's device, then join the group of `world_size` ranks
    over `backend`: through `store` (a torch.distributed store) when given,
    else through the environment (MASTER_ADDR / MASTER_PORT, torchrun's)."""
    dev = _rank_device(device, local_rank)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("NCCL needs a card for every rank")
    extra = {"device_id": dev} if backend == "nccl" else {}
    meet = {"store": store} if store is not None else {"init_method": "env://"}
    dist.init_process_group(
        backend, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT_S), **meet,
        **extra)
    return ProvingMesh(rank, world_size, dev, backend, dist.group.WORLD)


def initialize(backend: str = "nccl") -> bool:
    """Join the group torchrun's environment describes; False, and no
    group, for a single process."""
    addr = os.environ.get("MASTER_ADDR")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if not addr or world <= 1:
        return False
    join_group(backend, world, int(os.environ["RANK"]),
               "cuda" if backend == "nccl" else "cpu",
               int(os.environ.get("LOCAL_RANK", "0")))
    return True


def proving_mesh(device="cuda") -> ProvingMesh:
    """This process's rank in the group (or a world of one without a
    group), on `device`: a bare "cuda" is card LOCAL_RANK, made current."""
    dev = _rank_device(device, int(os.environ.get("LOCAL_RANK", "0")))
    if not dist.is_initialized():
        return ProvingMesh(0, 1, dev)
    return ProvingMesh(dist.get_rank(), dist.get_world_size(), dev,
                       dist.get_backend(), dist.group.WORLD)


def host_shard(n: int, mesh: ProvingMesh) -> slice:
    """The [start, stop) slice of a batch of n that this rank holds (equal
    split by rank)."""
    if n % mesh.world:
        raise ValueError(f"batch {n} not divisible by {mesh.world} ranks")
    per = n // mesh.world
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def global_array(local_np, mesh: ProvingMesh) -> torch.Tensor:
    """This rank's shard of a global batch, on its device."""
    return torch.from_numpy(np.ascontiguousarray(local_np)).to(mesh.device)


# -- collectives ----------------------------------------------------------------

def all_gather(t: torch.Tensor, mesh: ProvingMesh) -> torch.Tensor:
    """(world, *t.shape): every rank's `t`, in rank order, on t's device."""
    if mesh.group is None:
        return t.unsqueeze(0)
    src = mesh.wire(t)
    parts = [torch.empty_like(src) for _ in range(mesh.world)]
    dist.all_gather(parts, src, group=mesh.group)
    moved = (mesh.world - 1) * src.numel() * src.element_size()
    mesh.sent += moved
    mesh.received += moved
    return torch.stack(parts).to(t.device)


def all_to_all(t: torch.Tensor, mesh: ProvingMesh) -> torch.Tensor:
    """Split dim 0 of `t` into `world` equal blocks and send block i to
    rank i; the result holds, as its block i, the block rank i sent here."""
    if t.shape[0] % mesh.world:
        raise ValueError(f"dim 0 of {tuple(t.shape)} does not split over "
                         f"{mesh.world} ranks")
    if mesh.group is None:
        return t
    src = mesh.wire(t)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.group)
    moved = (mesh.world - 1) * src.numel() * src.element_size() // mesh.world
    mesh.sent += moved
    mesh.received += moved
    return out.to(t.device)


def send(t: torch.Tensor, dst: int, mesh: ProvingMesh) -> None:
    src = mesh.wire(t)
    dist.send(src, dst, group=mesh.group)
    mesh.sent += src.numel() * src.element_size()


def recv(like: torch.Tensor, src: int, mesh: ProvingMesh) -> torch.Tensor:
    """A tensor shaped as `like`, received from rank `src`, on like's
    device."""
    buf = torch.empty(like.shape, dtype=like.dtype,
                      device="cpu" if mesh.staged(like) else like.device)
    dist.recv(buf, src, group=mesh.group)
    mesh.received += buf.numel() * buf.element_size()
    return buf.to(like.device)


def barrier(mesh: ProvingMesh) -> None:
    """All ranks meet, and this rank's card has finished its work."""
    if mesh.group is not None:
        dist.barrier(group=mesh.group)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


# -- launching the ranks of one group on this host -----------------------------------

def _store(port: int, world: int | None, master: bool):
    """The group's rendezvous store on this host: the launcher holds the
    server (on a port the system picks, so no other process can take it
    first) and each rank is a client."""
    return dist.TCPStore(
        "127.0.0.1", port, world, master,
        datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT_S),
        wait_for_workers=False)


def _rank_main(rank, fn, world, backend, device, port, results, args):
    """One spawned rank: its device, the group, `fn`, its result queued."""
    try:
        local = rank
        if torch.device(device).type == "cuda":
            cards = torch.cuda.device_count()
            if cards == 0:
                raise RuntimeError("no card for a CUDA rank")
            if backend == "nccl" and world > cards:
                raise RuntimeError(f"NCCL wants one card a rank: {world} "
                                   f"ranks, {cards} cards")
            local = rank % cards
        else:
            torch.set_num_threads(1)     # the ranks share the host's cores
        os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                          LOCAL_RANK=str(local))
        mesh = join_group(backend, world, rank, device, local,
                          _store(port, world, False))
        try:
            results.put((rank, True, fn(mesh, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn, world_size: int, backend: str, device="cuda", args=(),
          timeout_s: float = 600.0) -> list:
    """Run `fn(mesh, *args)` on `world_size` ranks, each a process started
    with the `spawn` method, joined in one group over `backend`; a bare
    "cuda" `device` puts rank r on card r mod the cards. `fn` must be
    importable by name (a module-level function). Returns each rank's
    result in rank order; raises with the ranks' tracebacks when any rank
    fails, dies or outlasts `timeout_s`, after ending every rank."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    store = _store(0, None, True)
    port = store.port
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, fn, world_size, backend, device, port,
                               results, args))
             for r in range(world_size)]
    for p in procs:
        p.start()
    done, failed = {}, {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(done) + len(failed) < world_size and not failed:
            left = deadline - time.monotonic()
            if left <= 0:
                failed["timeout"] = (f"{world_size - len(done)} of "
                                     f"{world_size} ranks still running after"
                                     f" {timeout_s} s")
                break
            try:
                rank, ok, value = results.get(timeout=min(left, 2.0))
            except queue.Empty:
                for r, p in enumerate(procs):
                    if r not in done and p.exitcode not in (None, 0):
                        failed[r] = f"rank {r} died, exit code {p.exitcode}"
                continue
            (done if ok else failed)[rank] = value
    finally:
        for p in procs:
            if p.is_alive() and failed:
                p.terminate()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    if failed:
        raise RuntimeError(f"{backend} world of {world_size} failed:\n"
                           + "\n".join(f"[{r}] {v}" for r, v in
                                       sorted(failed.items(), key=str)))
    return [done[r] for r in range(world_size)]
