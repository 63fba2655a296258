"""Elastic serving pool on the PyTorch/CUDA port, the counterpart of
``examples/vetl_pool_scale.py``: admit -> overload shed -> alert ->
retire -> rebalance, on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/vetl_pool_scale_torch.py [--device cpu]

1. Fit a tiny Skyscraper and stand up a ``SkyscraperPool`` over a
   sharded warehouse sink. Admit a fleet of live streams with
   priorities: capacity grows on a power-of-two slot ladder, so admits
   inside a bucket allocate nothing.
2. Squeeze ``capacity_core_s`` (a plain attribute, read each tick) and
   watch priority-ordered shedding show up in the flight recorder and
   fire a standing-alert subscription.
3. Lift the squeeze, retire the low-priority streams, and rebalance the
   warehouse onto a different shard count: standing queries replay
   handle-stably.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse

import numpy as np

from repro_torch.core.api import Skyscraper, SkyscraperPool
from repro_torch.runtime.elastic import rebalance
from repro_torch.warehouse import (Filter, GroupBy, ShardedStore,
                                   StandingQueries, to_host)


def _proc(seg, knobs):
    return ("out", min(0.5 + 0.1 * knobs["q"], 1.0))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = args.device

    print("== 1. fit + admit a prioritized fleet ==")
    rng = np.random.default_rng(0)
    sky = Skyscraper(fps=2, segment_seconds=1.0, n_categories=2, seed=0,
                     device=dev)
    sky.set_resources(num_cores=4, buffer_gb=1.0, cloud_budget_core_s=0.0)
    sky.register_knob("q", [1, 2, 3])
    sky.fit([rng.random((3,)) for _ in range(12)], _proc)

    sink = ShardedStore(out_dim=len(sky.configs), n_shards=2,
                        chunk_rows=64, device=dev)
    reg = StandingQueries(sink)
    reg.subscribe([GroupBy("stream_id", "quality", agg="min",
                           num_groups=16)],
                  Filter("quality", "le", 0.0), name="shed-watch")

    pool = SkyscraperPool(sky, n_streams=2, priorities=[4.0, 4.0],
                          sink=sink, telemetry=True, device=dev)
    for sid, prio in [(2, 3.0), (3, 2.0), (4, 1.0), (5, 1.0)]:
        pool.admit(sid, priority=prio)
    print(f"   streams={pool.streams} slot capacity={pool.cap}")

    seg = np.zeros(3)
    pool.process([seg] * pool.V)           # unconstrained tick
    tel = pool.telemetry()
    demand = float(np.asarray(tel.counters["onprem_core_s"]).sum())
    print(f"   fleet demand {demand * 1e6:.2f}us core-s/tick "
          f"(the tiny demo proc), no shedding: "
          f"dropped={int(np.asarray(tel.counters['seg_dropped']).sum())}")

    print("== 2. overload: squeeze capacity, shed by priority ==")
    pool.capacity_core_s = demand * 0.5    # room for ~half the fleet
    for _ in range(3):
        statuses, _ = pool.process([seg] * pool.V)
    shed = {s["stream_id"]: s["shed"] for s in statuses}
    print(f"   shed by stream: {shed}")
    assert not shed[0] and not shed[1], "high priority must be kept"
    stats = pool.shed_stats()
    for sid in pool.streams:
        print(f"   stream {sid}: prio={stats[sid]['priority']:.1f} "
              f"shed {stats[sid]['dropped']}/{stats[sid]['segments']}")
    assert pool.alerts and pool.alerts[0].name == "shed-watch"
    print(f"   standing alert fired: {pool.alerts[0].name} on streams "
          f"{np.nonzero(np.asarray(pool.alerts[0].fired))[0].tolist()}")

    print("== 3. recover: lift the squeeze, retire, rebalance ==")
    pool.capacity_core_s = None
    for sid in (4, 5):
        pool.retire(sid)
    pool.process([seg] * pool.V)
    print(f"   fleet now {pool.streams}, rows in store: {sink.n_rows}")

    new_store = rebalance(sink, 4, device=dev)       # 2 shards -> 4
    print(f"   rebalanced {sink.n_shards} -> {new_store.n_shards} shards, "
          f"rows/shard {new_store.n_rows_by_shard.tolist()}")
    assert new_store.n_rows == sink.n_rows
    # standing queries replayed handle-stably on the new store
    table, mask = new_store.standing.answer(pool.alerts[0].handle)
    groups = to_host(table, mask)
    print(f"   shed-watch still answering post-rebalance: "
          f"{len(groups['quality'])} streams tracked")
    print("ok")
    return shed


if __name__ == "__main__":
    main()
