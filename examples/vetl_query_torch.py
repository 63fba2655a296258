"""End-to-end V-ETL on the PyTorch/CUDA port, the counterpart of
``examples/vetl_query.py``: Extract/Transform (the fused ingestion run)
-> **Load** (the device-resident columnar warehouse) -> queries, on the
card unless ``--device cpu``.

    PYTHONPATH=src python examples/vetl_query_torch.py [--device cpu] \
        [--days 1.0] [--fit-days 2.0] [--shard-days 0.05] \
        [--chunk-rows 8192]

A day of synthetic traffic video runs through the fused engine with a
``SegmentStore`` sink (the traces never leave the device on their way
into the store), then analyst questions run as plans::

    store = SegmentStore(out_dim=K)
    IG.run_skyscraper_fused(fitted, stream, sink=store, ...)
    table, mask = store.query((
        Filter("quality", "ge", 0.6),
        WindowAgg(window=150, value="quality", agg="mean",
                  num_windows=windows_for(store, 150)),
        TopK(5, by="quality"),
    ))

On the card each aggregating plan is one launch of the hand-written
kernel K1 (``kernels.warehouse_agg``), built once: re-running a plan
with new thresholds builds nothing and launches K1 once more. Older
chunks spill to an int8 cold tier, and the warehouse survives a process
restart through ``checkpoint/ckpt.py``.

The last section partitions rows by stream-id hash over a
``ShardedStore``'s stacked shards on one device and answers the same
plans through the per-shard partial (K1 once per shard) and merge.
"""
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse
import tempfile

import numpy as np

from repro_torch.configs.workloads import COVID
from repro_torch.core import ingest as IG
from repro_torch.core.offline import fit
from repro_torch.data.stream import generate
from repro_torch.kernels import build
from repro_torch.kernels import warehouse_agg as K1
from repro_torch.warehouse import (Filter, GroupBy, MultiGroupBy,
                                   SegmentStore, ShardedStore, TieredStore,
                                   TopK, WindowAgg, load_warehouse,
                                   save_warehouse, to_host, windows_for)


def _requery(store, plans, launches_each):
    """Run ``plans`` and check that no kernel library was built or
    loaded and that K1 launched ``launches_each`` times per plan (its
    wrapper counts launches on the card only; the CPU takes its plain
    version)."""
    libs, launches = len(build._LIBS), K1.LAUNCHES
    for plan in plans:
        store.query(plan)
    on_card = store.device.type == "cuda"
    want = len(plans) * launches_each if on_card else 0
    assert len(build._LIBS) == libs, "a kernel library was built!"
    assert K1.LAUNCHES - launches == want, (K1.LAUNCHES - launches, want)
    return want


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--days", type=float, default=1.0)
    ap.add_argument("--fit-days", type=float, default=2.0)
    ap.add_argument("--shard-days", type=float, default=0.05)
    ap.add_argument("--chunk-rows", type=int, default=8192,
                    help="the store's chunk, the cold tier's unit")
    args = ap.parse_args(argv)
    dev = args.device

    print(f"== offline phase (fit on {args.fit_days:g} days of historical "
          f"stream) ==")
    fitted = fit(COVID, n_cores=8, days_unlabeled=args.fit_days,
                 n_categories=4, device=dev)
    K = len(fitted.configs)
    print(f"K={K} Pareto configs")

    print(f"\n== Extract/Transform/LOAD: {args.days * 24:g}h through the "
          f"fused engine ==")
    stream = generate(COVID, days=args.days, seed=99)
    store = SegmentStore(out_dim=K, chunk_rows=args.chunk_rows, device=dev)
    res = IG.run_skyscraper_fused(fitted, stream, n_cores=8,
                                  cloud_budget_core_s=15_000.0,
                                  buffer_gb=4.0, plan_days=0.25 * args.days,
                                  sink=store, device=dev)
    print(f"run quality {res.quality_pct:.2f}%  ->  {store}")

    print("\n== query 1: worst five 5-min windows (mean quality), "
          "confident segments only ==")
    nw = windows_for(store, 150)
    plan = (Filter("quality", "ge", 0.05),
            WindowAgg(window=150, value="quality", agg="mean",
                      num_windows=nw),
            TopK(5, by="quality", largest=False))
    worst = to_host(*store.query(plan))
    for w, q in zip(worst["window"], worst["quality"]):
        print(f"   window {w:4d} ({w * 150 * 2 / 3600:5.2f}h): "
              f"mean quality {q:.3f}")

    print("\n== query 2: on-prem work per content category ==")
    spend = to_host(*store.query(
        (GroupBy("category", "on_core_s", agg="sum",
                 num_groups=fitted.centers.shape[0]),)))
    for c, s, n in zip(spend["category"], spend["on_core_s"],
                       spend["count"]):
        print(f"   category {c}: {s:9.1f} core-s over {int(n)} segments")

    print("\n== re-query with a new threshold: the same kernel ==")
    n = _requery(store, [(Filter("quality", "ge", thr),) + plan[1:]
                         for thr in (0.5, 0.9)], 1)
    print(f"   0 kernel builds, {n} K1 launches for 2 plans "
          f"({len(build._LIBS)} kernel libraries loaded)")

    print("\n== tiering: spill old chunks to the int8 cold tier ==")
    ts = TieredStore(store, seed=0, device=dev)
    spilled = ts.spill(keep_hot=store.n_rows // 4)
    print(f"   {ts} (spilled {spilled} rows, "
          f"max cold scale {ts.max_cold_scale():.2e})")
    cold_ans = to_host(*ts.query(plan))
    print(f"   same query across both tiers: windows "
          f"{cold_ans['window'].tolist()}")

    print("\n== persistence: the warehouse survives restart ==")
    path = os.path.join(tempfile.gettempdir(), "vetl_warehouse_torch.rsk")
    save_warehouse(path, ts)
    back = load_warehouse(path, device=dev)
    again = to_host(*back.query(plan))
    assert np.array_equal(again["window"], cold_ans["window"])
    assert np.array_equal(again["quality"], cold_ans["quality"])
    print(f"   restored {back} from {path}; answers identical")

    print("\n== sharded warehouse: 4 streams hashed over 4 shards ==")
    V = 4
    streams = [generate(COVID, days=args.shard_days, seed=10 + v)
               for v in range(V)]
    shard_store = ShardedStore(out_dim=K, n_shards=4, chunk_rows=2048,
                               device=dev)
    print("   (stacked shards on one device: the reference's 1-device "
          "semantics)")
    # the fused multi-stream run lands every stream's rows on its owner
    # shard without the traces leaving the device
    IG.run_skyscraper_multi([fitted] * V, streams, n_cores_each=8,
                            cloud_budget_core_s=4_000.0, plan_days=0.25,
                            sink=shard_store, device=dev)
    print(f"   {shard_store}")
    # per-shard partial (K1 on each shard) + merge + top-k
    nw4 = windows_for(shard_store, 150)
    splan = (Filter("quality", "ge", 0.05),
             WindowAgg(window=150, value="quality", agg="mean",
                       num_windows=nw4),
             TopK(5, by="quality", largest=False))
    worst4 = to_host(*shard_store.query(splan))
    for w, q in zip(worst4["window"], worst4["quality"]):
        print(f"   window {w:4d}: mean quality {q:.3f}")
    n = _requery(shard_store, [(Filter("quality", "ge", 0.5),) + splan[1:]],
                 shard_store.n_shards)
    print(f"   re-query with a new threshold: 0 kernel builds, {n} K1 "
          f"launches (one per shard)")
    # multi-key GroupBy: per (window x category) mean quality, fused
    # into one pass over the rows
    by_wc = to_host(*shard_store.query((
        MultiGroupBy(keys=("t", "category"), value="quality", agg="mean",
                     nums=(nw4, fitted.centers.shape[0]),
                     windows=(150, 0)),
        TopK(3, by="quality", largest=False))))
    for w, c, q in zip(by_wc["t"], by_wc["category"], by_wc["quality"]):
        print(f"   window {w:4d} x category {c}: mean quality {q:.3f}")

    print("\nOK: ingest -> store -> query -> spill -> restore -> shard "
          "all good.")
    return worst, worst4


if __name__ == "__main__":
    main()
