"""The warehouse's elastic move: ``rebalance`` re-partitions a
``ShardedStore`` onto another shard count (the port of
``repro/runtime/elastic.py``'s ``rebalance`` and ``_rebalance_kernel``).

The old shards' live rows, read shard-major (shard 0's rows in order,
then shard 1's, ...), are routed under the new count's ownership rule
``stream_id % s_new``: each new shard keeps its rows in that order at
rows 0, 1, .... Every new shard is sized for the whole store
(``_bucket_cap`` of its row count), as the reference sizes them, so the
row ids a TopK reports (``shard * cap + row``) are the reference's; it
costs ``s_new`` times the store's bytes.

The mesh helpers of the reference's module (``make_mesh_from``,
``shrink_mesh``, ``restore_elastic``) belong to training on JAX meshes
and are not ported here.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve


def _repartition(cols, n_rows_by_shard, s_new: int, cap_new: int):
    """New stacked (s_new, cap_new, ...) columns and per-shard counts:
    the old live rows, shard-major, each sent to shard ``stream_id %
    s_new`` in that order."""
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
    new = {k: torch.zeros((s_new, cap_new) + v.shape[1:], dtype=v.dtype,
                          device=dev) for k, v in flat.items()}
    start = 0
    for s, c in enumerate(counts):
        idx = order[start:start + c]
        for k, v in flat.items():
            new[k][s, :c] = v.index_select(0, idx)
        start += c
    return new, counts


def rebalance(store, new_shards: int, *, device=None):
    """Re-partition a ``ShardedStore`` onto ``new_shards`` shards on
    ``device`` (``None`` means CUDA; it must be the store's device).
    Returns a NEW store; the input is untouched. Row payloads move bit
    for bit, so row sets and counts are exact and float aggregates match
    within the regrouping of a different shard count.

    Standing queries registered on ``store`` are registered again on
    the new store in handle order, subscriptions included (each group on
    the path it took), so existing handles stay valid against
    ``new_store.standing``; the registration backfills rebuild their
    state from the moved rows."""
    from repro_torch.warehouse.standing import StandingQueries
    from repro_torch.warehouse.store import ShardedStore, _bucket_cap
    assert new_shards >= 1
    assert isinstance(store, ShardedStore), "rebalance takes a ShardedStore"
    dev = resolve(device)
    if dev != store.device:
        raise ValueError(f"rebalance runs on {dev} and the store is on "
                         f"{store.device}")
    # one shard could own every row: size each for the whole store
    cap_new = _bucket_cap(max(store.n_rows, 1), store.chunk_rows)
    cols, counts = _repartition(store.columns, store.n_rows_by_shard,
                                new_shards, cap_new)
    new = ShardedStore._from_parts(
        out_dim=store.out_dim, n_shards=new_shards,
        chunk_rows=store.chunk_rows, device=dev, columns=cols,
        n_rows_by_shard=counts, t_max=store.t_max)
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
