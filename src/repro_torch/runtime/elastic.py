"""Elastic scaling: the port of ``repro/runtime/elastic.py``.

Training. Checkpoints are mesh-agnostic (the whole state, whichever
mesh wrote it), so recovery after losing cards is: lay the surviving
ranks out as a new mesh, derive its placements from the same logical
rules, and restore (``restore_elastic``). ``shrink_mesh`` picks the
largest (data' x model) grid that fits the survivors while keeping the
model axis (its degree is a property of the step; the data degree is
elastic). In the port a lost rank ends its world, so the survivors
restart as a new world (``torchrun``) and lay themselves out again;
``make_mesh_from`` and ``shrink_mesh`` give the layout (a
``launch.mesh.MeshShape``), ``launch.mesh.make_train_mesh`` puts it on
the world.

The warehouse: ``rebalance`` re-partitions a ``ShardedStore`` onto
another shard count (the reference's ``rebalance`` and
``_rebalance_kernel``).

The old shards' live rows, read shard-major (shard 0's rows in order,
then shard 1's, ...), are routed under the new count's ownership rule
``stream_id % s_new``: each new shard keeps its rows in that order at
rows 0, 1, .... Every new shard is sized for the whole store
(``_bucket_cap`` of its row count), as the reference sizes them, so the
row ids a TopK reports (``shard * cap + row``) are the reference's; it
costs ``s_new`` times the store's bytes.

A store spread over a ``torch.distributed`` group moves the same way:
one gather of the live rows over the old group (the reference
replicates them onto the new mesh), after which each rank of the new
group cuts its own block of new shards out of them. The new group may
differ from the old; ranks outside it get ``None``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve
from repro_torch.launch.mesh import MeshShape


def make_mesh_from(ranks: Sequence[int], model_axis: int,
                   pod_axis: int = 1) -> MeshShape:
    """``ranks`` laid out as (data, model), or (pod, data, model) when
    ``pod_axis`` > 1, data = n / (model * pod), the first ranks taken in
    ``np.reshape`` order. Raises ``ValueError`` when n does not divide by
    ``model_axis``."""
    n = len(ranks)
    if n % model_axis:
        raise ValueError(f"{n} devices not divisible by model={model_axis}")
    data_axis = n // (model_axis * pod_axis)
    if pod_axis > 1:
        shape, names = ((pod_axis, data_axis, model_axis),
                        ("pod", "data", "model"))
    else:
        shape, names = (data_axis, model_axis), ("data", "model")
    return MeshShape(shape, names,
                     list(ranks)[:pod_axis * data_axis * model_axis])


def shrink_mesh(old: MeshShape, surviving: Sequence[int]) -> MeshShape:
    """The largest elastic mesh on the survivors with ``old``'s model
    degree. Raises ``RuntimeError`` when they cannot hold one model
    shard."""
    model_axis = old.shape.get("model", 1)
    usable = (len(surviving) // model_axis) * model_axis
    if usable == 0:
        raise RuntimeError("not enough devices for one model shard")
    return make_mesh_from(list(surviving)[:usable], model_axis)


def restore_elastic(ckpt_dir: str, model, mesh, step=None):
    """``(state, step)``: the latest checkpoint (or ``step``) under
    ``ckpt_dir`` as this rank's blocks on ``mesh`` (a ``TrainMesh``), or
    ``(None, None)`` when there is none."""
    from repro_torch.checkpoint import ckpt as CK
    from repro_torch.runtime.steps import train_state_shardings
    step = CK.latest_step(ckpt_dir) if step is None else step
    if step is None:
        return None, None
    state = CK.restore(ckpt_dir, step, mesh=mesh,
                       shardings=train_state_shardings(model, mesh))
    return state, step


def _repartition(cols, n_rows_by_shard, s_new: int, cap_new: int,
                 keep: range = None):
    """New stacked (len(keep), cap_new, ...) columns of the new shards
    ``keep`` (all ``s_new`` by default) and every new shard's count: the
    old live rows, shard-major, each sent to shard ``stream_id % s_new``
    in that order."""
    keep = range(s_new) if keep is None else keep
    s_old, cap_old = cols["t"].shape[:2]
    dev = cols["t"].device
    live = (torch.arange(cap_old, device=dev)[None, :]
            < torch.as_tensor(n_rows_by_shard, device=dev)[:, None]
            ).reshape(-1)
    flat = {k: v.reshape((s_old * cap_old,) + v.shape[2:])
            for k, v in cols.items()}
    owner = torch.where(live, flat["stream_id"].long() % s_new, s_new)
    order = torch.argsort(owner, stable=True)     # by shard, then row order
    counts = torch.bincount(owner, minlength=s_new + 1)[:s_new].cpu() \
        .numpy().astype(np.int64)
    new = {k: torch.zeros((len(keep), cap_new) + v.shape[1:],
                          dtype=v.dtype, device=dev)
           for k, v in flat.items()}
    starts = np.concatenate([[0], np.cumsum(counts)])
    for j, s in enumerate(keep):
        idx = order[starts[s]:starts[s + 1]]
        for k, v in flat.items():
            new[k][j, :counts[s]] = v.index_select(0, idx)
    return new, counts


def rebalance(store, new_shards: int, *, device=None, group=None):
    """Re-partition a ``ShardedStore`` onto ``new_shards`` shards on
    ``device`` (``None`` means CUDA; it must be the store's device).
    Returns a NEW store; the input is untouched. Row payloads move bit
    for bit, so row sets and counts are exact and float aggregates match
    within the regrouping of a different shard count.

    Standing queries registered on ``store`` are registered again on
    the new store in handle order, subscriptions included (each group on
    the path it took), so existing handles stay valid against
    ``new_store.standing``; the registration backfills rebuild their
    state from the moved rows.

    On a store spread over a group this is a collective of the old
    group: its live rows are gathered onto every rank, and the new
    store spreads over ``group`` (``None``: the stacked store on every
    rank). ``new_shards`` must be a multiple of the new group's size
    (``ValueError``); a rank outside the new group (``dist.new_group``'s
    ``GroupMember.NON_GROUP_MEMBER``) takes part in the gather and gets
    ``None``."""
    from repro_torch.warehouse.standing import StandingQueries
    from repro_torch.warehouse.store import (ShardedStore, _bucket_cap,
                                             all_shards)
    assert new_shards >= 1
    assert isinstance(store, ShardedStore), "rebalance takes a ShardedStore"
    dev = resolve(device)
    if dev != store.device:
        raise ValueError(f"rebalance runs on {dev} and the store is on "
                         f"{store.device}")
    # every old shard's live rows on this rank (a gather on a group)
    cols = all_shards(store.columns, store.n_rows_by_shard, store.group)
    if group is dist.GroupMember.NON_GROUP_MEMBER:
        return None
    new = ShardedStore(out_dim=store.out_dim, n_shards=new_shards,
                       chunk_rows=store.chunk_rows, device=dev, group=group)
    # one shard could own every row: size each for the whole store
    cap_new = _bucket_cap(max(store.n_rows, 1), store.chunk_rows)
    new.columns, new.n_rows_by_shard = _repartition(
        cols, store.n_rows_by_shard, new_shards, cap_new, keep=new.shards)
    new.t_max = store.t_max
    old = store.standing
    if old is not None and len(old._queries):
        reg = StandingQueries(new)
        subs = {s.handle: s for s in old._subs.values()}
        for h in sorted(old._queries):
            q = old._queries[h]
            uk = old._group_of(q).use_kernel
            if h in subs:
                reg.subscribe(list(q.plan), subs[h].predicate,
                              name=subs[h].name, use_kernel=uk)
            else:
                reg.register(list(q.plan), name=q.name, use_kernel=uk)
    return new
