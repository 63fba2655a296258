"""The warehouse's shard group: one process ("rank") per card under
``torch.distributed``, the port of ``repro/launch/mesh.py``'s
``make_shard_mesh``.

Where the reference lays a 1-D ``('shard',)`` mesh over the devices of
one program, the port runs one program per card and every rank calls
the same store methods with the same arguments, as ``shard_map``
replicates its ``P()`` inputs. A group of ``W`` ranks holds
``n_shards`` shards, ``n_shards`` a multiple of ``W``: rank ``r`` holds
shards ``[r * k, (r + 1) * k)``, ``k = n_shards / W``
(``make_shard_group``). ``W = n_shards`` is the reference's mesh, one
shard a device; a store given no group is the stacked store on one
device.

Collectives on CUDA tensors go through NCCL and on CPU tensors through
gloo; a store refuses a group whose backend does not fit its device
(``check_backend``), so a CUDA store never talks through gloo. Nothing
is automatic: a rank joins a group only through ``init_shard_group``,
whose ``timeout`` bounds every collective, and ``spawn_world`` runs a
world of ranks in child processes under a deadline after which it
terminates them and raises.

``all_gather_blocks`` is the one collective the warehouse needs: every
rank's blocks of fixed shapes, concatenated in rank order, so the
shards' pieces arrive in shard order and every rank merges them as the
stacked store does.

The helpers for ``make_production_mesh`` / ``make_host_mesh`` belong to
training across cards and are not here.
"""
from __future__ import annotations

import datetime
import os
import time
from typing import Callable, List, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve

TIMEOUT = datetime.timedelta(seconds=300)
# the backend a store's device talks through
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
# tensor blocks travel as bytes, each padded to this many so that every
# dtype's view of its block starts aligned
_ALIGN = 8

# what ``all_gather_blocks`` moved in this process: its calls, and the
# bytes each rank received (its own block included)
GATHERED = {"calls": 0, "bytes": 0}


def init_shard_group(device=None, *, init_method: str = "env://",
                     rank: int = None, world_size: int = None,
                     timeout: datetime.timedelta = TIMEOUT
                     ) -> torch.device:
    """Join this process to the default group and return its device.

    ``device`` ``None`` means CUDA (``repro_torch.device.resolve``: no
    card raises): the rank takes card ``LOCAL_RANK`` (set by
    ``torchrun``), else ``rank`` modulo the visible cards, and joins
    through NCCL. ``"cpu"``, asked for by name, joins through gloo.
    ``init_method`` is ``env://`` (``torchrun`` sets ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``), or e.g.
    ``file:///path`` or ``tcp://localhost:PORT`` with ``rank`` and
    ``world_size``. ``timeout`` bounds every collective of the group, so
    a rank that never arrives fails the others instead of hanging
    them."""
    dev = resolve(device)
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    kw = {} if world_size is None else {"rank": rank,
                                        "world_size": world_size}
    dist.init_process_group(BACKENDS[dev.type], init_method=init_method,
                            timeout=timeout, **kw)
    return dev


def check_backend(group, device: torch.device) -> None:
    """Raise ``ValueError`` unless ``group`` talks through the backend of
    ``device`` (NCCL for CUDA, gloo for the CPU), naming both."""
    backend = dist.get_backend(group)
    if backend != BACKENDS[device.type]:
        raise ValueError(f"a store on {device} needs a "
                         f"{BACKENDS[device.type]} group; this group's "
                         f"backend is {backend}")


def make_shard_group(n_shards: int, group=None) -> Tuple[object, range]:
    """``(group, shards)``: the group (the default group for ``None``) and
    the block of shards this rank holds, ``[r * k, (r + 1) * k)`` with
    ``k = n_shards / W``. Raises ``ValueError`` when ``n_shards`` is not
    a multiple of the group's size."""
    group = dist.group.WORLD if group is None else group
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if n_shards % world:
        raise ValueError(f"{n_shards} shards do not split over a group of "
                         f"{world} ranks")
    k = n_shards // world
    return group, range(rank * k, (rank + 1) * k)


def all_gather_blocks(blocks: Sequence[torch.Tensor], group
                      ) -> List[torch.Tensor]:
    """Every rank's ``blocks`` concatenated along dim 0 in rank order: a
    block of shape ``(k, ...)`` comes back ``(W * k, ...)``. Each block
    must have the same shape and dtype on every rank. All blocks travel
    in one ``all_gather`` of their bytes."""
    dev, world = blocks[0].device, dist.get_world_size(group)
    if not any(b.numel() for b in blocks):     # the same on every rank
        return [b.new_empty((world * b.shape[0],) + b.shape[1:])
                for b in blocks]
    flat, sizes = [], []
    for b in blocks:
        raw = b.contiguous().reshape(-1).view(torch.uint8)
        pad = -raw.numel() % _ALIGN
        flat.append(torch.nn.functional.pad(raw, (0, pad)) if pad else raw)
        sizes.append(raw.numel() + pad)
    send = torch.cat(flat)
    recv = [torch.empty_like(send) for _ in range(world)]
    dist.all_gather(recv, send, group=group)
    GATHERED["calls"] += 1
    GATHERED["bytes"] += world * send.numel()
    out = []
    for i, b in enumerate(blocks):
        lo = sum(sizes[:i])
        n = b.numel() * b.element_size()
        out.append(torch.cat([
            r[lo:lo + n].view(b.dtype).reshape(b.shape) for r in recv]))
    return out


def spawn_world(fn: Callable, nprocs: int, args: tuple = (), *,
                deadline: float = 600.0, poll: float = 0.5) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` spawned processes and wait
    for all of them. A rank that raises or exits non-zero terminates the
    others and raises here (``torch.multiprocessing``'s
    ``ProcessRaisedException`` / ``ProcessExitedException``); ranks
    still running after ``deadline`` seconds are killed and
    ``TimeoutError`` is raised. ``fn`` must be importable by name (spawn
    pickles it by reference)."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    end = time.monotonic() + deadline
    while not ctx.join(timeout=poll):
        if time.monotonic() > end:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join(timeout=10)
            raise TimeoutError(f"{nprocs} ranks still running after "
                               f"{deadline} s; killed")
