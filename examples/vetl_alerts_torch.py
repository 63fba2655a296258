"""Standing queries and alerts on the PyTorch/CUDA port, the counterpart
of ``examples/vetl_alerts.py``: register -> ingest -> alert fires ->
snapshot answers without a rescan, on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/vetl_alerts_torch.py [--device cpu]

1. Attach a ``StandingQueries`` registry to a warehouse store, register
   a batch of same-shape standing queries (their thresholds stack into
   one group's state) and subscribe a threshold alert.
2. Run fused V-ETL ingestion into the store: every ingest also folds
   the new rows into each standing query's accumulators (on the card
   through K1, one delta partial per query), no rescan, and
   ``RunResult.alerts`` carries the fired-alert masks.
3. Read O(result) snapshot answers and hold them against a full rescan
   by the plain-numpy oracle ``execute_ref``: bit for bit on the CPU;
   on the card K1 adds with atomics, so sums and means within 1e-5
   relative (counts and masks exactly). Then check the flight
   recorder's counters that account for all of it.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse

import numpy as np

from repro_torch.configs.workloads import COVID
from repro_torch.core import ingest as IG
from repro_torch.core.offline import fit
from repro_torch.data.stream import generate
from repro_torch.warehouse import (Filter, GroupBy, SegmentStore,
                                   StandingQueries, WindowAgg, execute_ref)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = args.device

    print("== 1. register standing queries on an empty store ==")
    fitted = fit(COVID, n_cores=8, days_unlabeled=2.0, n_categories=4,
                 seed=0, device=dev)
    store = SegmentStore(out_dim=len(fitted.configs), chunk_rows=1024,
                         device=dev)
    reg = StandingQueries(store)
    # same plan shape, different thresholds: one group, one state
    handles = {
        thr: reg.register(
            (Filter("quality", "ge", thr),
             GroupBy("category", "quality", agg="mean", num_groups=4)),
            name=f"mean-quality>={thr}")
        for thr in (0.0, 0.5, 0.9)
    }
    # alert: fire when any 64-segment window burns >40 core-seconds
    sid = reg.subscribe(
        (WindowAgg(window=64, value="on_core_s", agg="sum",
                   num_windows=16),),
        predicate=Filter("on_core_s", "gt", 40.0),
        name="hot-window")
    print(f"   {len(reg)} standing queries registered "
          f"(alert subscription {sid})")

    print("\n== 2. fused ingestion refreshes every query in the ingest ==")
    stream = generate(COVID, days=0.02, seed=7)
    tau = fitted.workload.segment_seconds
    res = IG.run_skyscraper_fused(
        fitted, stream, n_cores=8, cloud_budget_core_s=5_000.0,
        plan_days=64.5 * tau / 86400, forecast_mode="model", sink=store,
        device=dev)
    print(f"   ingested {store.n_rows} segments; quality "
          f"{res.quality_pct:.2f}%")
    for alert in res.alerts:             # polled right after the sink
        print(f"   alert {alert.name!r}: fired on {alert.n_fired} of "
              f"{alert.fired.shape[0]} windows")
        if alert.n_fired:
            hot = np.flatnonzero(alert.fired)
            print(f"     windows {hot.tolist()} burned "
                  f"{alert.table['on_core_s'][hot].round(1).tolist()} "
                  f"core-seconds")

    print("\n== 3. O(result) snapshots == full rescan, no rescan run ==")
    cols = store.host_rows()
    exact = store.device.type == "cpu"
    for thr, h in handles.items():
        table, mask = reg.answer(h)      # accumulator finalize only
        ref, rmask = execute_ref(
            cols, store.n_rows,
            (Filter("quality", "ge", thr),
             GroupBy("category", "quality", agg="mean", num_groups=4)))
        mask = mask.cpu().numpy()
        got = table["quality"].cpu().numpy()
        assert np.array_equal(mask, rmask)
        assert np.array_equal(table["count"].cpu().numpy(), ref["count"])
        if exact:
            assert np.array_equal(got, ref["quality"])
        else:
            np.testing.assert_allclose(got, ref["quality"], rtol=1e-5)
        means = got[mask].round(3)
        print(f"   quality>={thr}: per-category means {means.tolist()}")

    tel = store.telemetry()
    print(f"\n   store telemetry: {tel.summary()}")
    assert tel.standing_queries == len(reg)
    assert tel.standing_refreshes >= 1 and tel.alerts_checked >= 1
    print("\nOK: standing answers exact, alerts live, zero rescans.")
    return res.alerts


if __name__ == "__main__":
    main()
