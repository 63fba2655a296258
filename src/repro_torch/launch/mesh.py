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

Training lays its ranks out as the reference lays devices: a
``MeshShape`` is the layout alone, the ranks in ``np.reshape`` order
over named axes (``("data", "model")`` or ``("pod", "data", "model")``),
usable without a world (the production meshes' specs are computed on
the CPU from ``production_shape``). A ``TrainMesh`` is a layout over
this world's ranks: this rank's device and place on it, and a group for
every set of axes larger than one rank (the port's counterpart of
``make_mesh_compat``'s mesh; the gathers of a spec entry such as
``("pod", "data")`` need a group over both axes, which a per-axis
``DeviceMesh`` does not give). An ``AccountMesh`` is a layout seen
from one rank with no world at all: the dry run's, whose collectives
only count. ``make_host_mesh`` lays the world out
as (world / model, model), ``make_production_mesh`` as the reference's
(16, 16) or (2, 16, 16); a mesh that needs more ranks than the world has
raises, naming both.
"""
from __future__ import annotations

import datetime
import itertools
import math
import os
import time
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

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
                     timeout: datetime.timedelta = TIMEOUT,
                     backend: str = None) -> torch.device:
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
    them. ``backend="gloo"`` asked for by name on the card carries CUDA
    tensors through the host: several ranks on one card, where NCCL
    refuses a card twice (a ``TrainMesh`` must then be given the same
    ``backend``)."""
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
    if backend not in (None, BACKENDS[dev.type], "gloo"):
        raise ValueError(f"a rank on {dev} joins through "
                         f"{BACKENDS[dev.type]} or gloo, not {backend}")
    dist.init_process_group(backend or BACKENDS[dev.type],
                            init_method=init_method, timeout=timeout, **kw)
    return dev


def check_backend(group, device: torch.device, backend: str = None
                  ) -> None:
    """Raise ``ValueError`` unless ``group`` talks through ``backend``
    (None: the backend of ``device``, NCCL for CUDA, gloo for the CPU),
    naming both."""
    want = backend or BACKENDS[device.type]
    got = dist.get_backend(group)
    if got != want:
        raise ValueError(f"a store on {device} needs a {want} group; this "
                         f"group's backend is {got}")


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


# ---------------------------------------------------------------------------
# training meshes
# ---------------------------------------------------------------------------
class MeshShape:
    """Ranks laid out over named axes: ``devices`` holds them in
    ``np.reshape`` order of ``shape`` (the ranks ``0 .. n - 1`` unless
    given), as the reference's ``Mesh`` holds devices. ``shape`` maps
    each axis name to its size, as ``Mesh.shape`` does."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices: Sequence[int] = None):
        shape, names = tuple(int(n) for n in shape), tuple(axis_names)
        if len(shape) != len(names):
            raise ValueError(f"a mesh of shape {shape} needs "
                             f"{len(shape)} axis names, not {names}")
        n = math.prod(shape)
        ranks = np.arange(n) if devices is None else np.asarray(devices)
        if ranks.size != n:
            raise ValueError(f"a {shape} mesh needs {n} ranks, not "
                             f"{ranks.size}")
        self.devices = ranks.reshape(shape)
        self.axis_names = names

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def axis_size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape[a] for a in axes)

    def ordered(self, axes: Sequence[str]) -> Tuple[str, ...]:
        """``axes`` as a tuple; raises unless in the mesh's axis order."""
        axes = tuple(axes)
        if [a for a in self.axis_names if a in axes] != list(axes):
            raise ValueError(f"axes {axes} are not in the mesh's order "
                             f"{self.axis_names}")
        return axes

    def coords(self, rank: int) -> Dict[str, int]:
        """The place of ``rank`` on the mesh, axis by axis."""
        at = np.argwhere(self.devices == rank)
        if not len(at):
            raise ValueError(f"rank {rank} is not on this mesh")
        return dict(zip(self.axis_names, (int(i) for i in at[0])))

    def __repr__(self):
        return (f"{type(self).__name__}({self.devices.shape}, "
                f"{self.axis_names})")


class TrainMesh(MeshShape):
    """A ``MeshShape`` over this world: ``device`` is this rank's
    (``None`` means CUDA, the card ``init_shard_group`` chose; ``"cpu"``
    asked for by name), ``rank`` its global rank. Every rank of the world
    must build it alike (each group is made by every rank); ``timeout``
    bounds every collective of its groups, as ``init_shard_group``'s
    bounds the world's. Raises ``ValueError`` when the layout needs more
    ranks than the world has, and when the world's backend does not fit
    the device (or is not ``backend``, asked for by name: gloo for
    several ranks on one card, ``init_shard_group``)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices: Sequence[int] = None, device=None,
                 timeout: datetime.timedelta = TIMEOUT,
                 backend: str = None):
        dev = resolve(device)
        super().__init__(shape, axis_names, devices)
        if not dist.is_initialized():
            raise RuntimeError("a training mesh needs a world: join one "
                               "first (init_shard_group)")
        world = dist.get_world_size()
        if self.size > world or int(self.devices.max()) >= world:
            raise ValueError(f"a {tuple(self.devices.shape)} mesh over "
                             f"{self.axis_names} needs {self.size} ranks; "
                             f"the world has {world}")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        check_backend(dist.group.WORLD, dev, backend)
        self.device = dev
        self.rank = dist.get_rank()
        self._at = (self.coords(self.rank)
                    if self.rank in self.devices else None)
        self._groups = {}
        names = self.axis_names
        for k in range(1, len(names) + 1):
            for axes in itertools.combinations(names, k):
                if self.axis_size(axes) == 1:
                    continue
                rest = [a for a in names if a not in axes]
                # one group per place on the other axes, ranks in
                # row-major order over ``axes``
                for fixed in itertools.product(
                        *(range(self.shape[a]) for a in rest)):
                    pick = tuple(
                        fixed[rest.index(a)] if a in rest else slice(None)
                        for a in names)
                    ranks = [int(r) for r in self.devices[pick].reshape(-1)]
                    if ranks != sorted(ranks):
                        raise ValueError(f"the ranks of a mesh must rise "
                                         f"along every axis: {ranks}")
                    g = dist.new_group(ranks, timeout=timeout)
                    if self.rank in ranks:
                        self._groups[axes] = g

    def group(self, axes: Sequence[str]):
        """This rank's group over ``axes`` (in the mesh's axis order), or
        None when they hold one rank."""
        axes = self.ordered(axes)
        if self.axis_size(axes) == 1:
            return None
        return self._groups[axes]

    def index(self, axes: Sequence[str]) -> int:
        """This rank's block along ``axes``: its coordinates over them,
        row-major (the first axis the slowest), as a ``PartitionSpec``
        entry of several axes numbers its blocks."""
        i = 0
        for a in axes:
            i = i * self.shape[a] + self._at[a]
        return i


class AccountMesh(MeshShape):
    """A ``MeshShape`` seen from one of its ranks without a world: the
    dry run's mesh (``launch/dryrun.py``). Its device is ``meta``, its
    groups are ``sharding.CountingGroup`` objects, so a step laid out on
    it runs on shapes alone: every collective moves nothing and returns a
    tensor of the shape it would return, and the step's byte counts grow
    as they would on ``rank``'s card."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices: Sequence[int] = None, rank: int = 0):
        super().__init__(shape, axis_names, devices)
        self.device = torch.device("meta")
        self.rank = rank
        self._at = self.coords(rank)

    def group(self, axes: Sequence[str]):
        from repro_torch.distribution.sharding import CountingGroup
        n = self.axis_size(self.ordered(axes))
        return None if n == 1 else CountingGroup(n)

    index = TrainMesh.index


def make_train_mesh(layout: MeshShape, device=None,
                    timeout: datetime.timedelta = TIMEOUT) -> TrainMesh:
    """``layout`` over this world (``TrainMesh``)."""
    return TrainMesh(layout.devices.shape, layout.axis_names,
                     layout.devices.reshape(-1), device, timeout)


def make_host_mesh(model_axis: int = 1, device=None,
                   timeout: datetime.timedelta = TIMEOUT) -> TrainMesh:
    """The world laid out as (world / model_axis, model_axis) over
    ``("data", "model")``. Raises ``ValueError`` when the world does not
    divide by ``model_axis`` (the reference's host mesh shrinks the model
    axis to the devices it finds instead)."""
    dev = resolve(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if model_axis < 1 or world % model_axis:
        raise ValueError(f"a world of {world} ranks does not divide by "
                         f"the model axis {model_axis}")
    return TrainMesh((world // model_axis, model_axis), ("data", "model"),
                     device=dev, timeout=timeout)


def production_shape(*, multi_pod: bool = False) -> MeshShape:
    """The reference's production layout: (16, 16) over ``("data",
    "model")``, or (2, 16, 16) over ``("pod", "data", "model")``."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False, device=None,
                         timeout: datetime.timedelta = TIMEOUT
                         ) -> TrainMesh:
    """``production_shape`` over this world (256 or 512 ranks)."""
    return make_train_mesh(production_shape(multi_pod=multi_pod), device,
                           timeout)
