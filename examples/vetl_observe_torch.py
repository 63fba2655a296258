"""Flight recorder and dispatch tracer on the PyTorch/CUDA port, the
counterpart of ``examples/vetl_observe.py``, on the card unless
``--device cpu``.

    PYTHONPATH=src python examples/vetl_observe_torch.py [--device cpu]

1. Fit a tiny Skyscraper on historical COVID stream, then run fused
   ingestion with ``telemetry=True``: the per-segment health counters
   (drops, buffer high-water mark, core-seconds, config switches) are
   carried beside the switcher's state on the device, bit-exact against
   the host mirror ``obs.telemetry_ref``.
2. Land the run in a SegmentStore sink and read the store-side
   counters: rows per shard, ingest-to-queryable lag, dispatch counts.
3. Trace the fused engines with the dispatch tracer
   (``repro_torch.obs``): wall-time spans, kernel-library and launch
   deltas, host synchronisations, a Chrome-trace JSON to drop into
   chrome://tracing or Perfetto.

The tracer over every engine, with the regression gate against a
baseline report, is one command::

    python -m repro_torch.obs --json OBS_NEW.json --compare OBS_TORCH.json
"""
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse

import numpy as np

from repro_torch.configs.workloads import COVID
from repro_torch.core import ingest as IG
from repro_torch.core.offline import fit
from repro_torch.data.stream import generate
from repro_torch.obs import validate_chrome_trace
from repro_torch.obs.trace import trace_all
from repro_torch.warehouse import Filter, SegmentStore, TopK


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = args.device

    print("== 1. fused ingestion with the on-device flight recorder ==")
    fitted = fit(COVID, n_cores=8, days_unlabeled=2.0, n_categories=4,
                 seed=0, device=dev)
    stream = generate(COVID, days=0.02, seed=7)
    store = SegmentStore(out_dim=len(fitted.configs), chunk_rows=512,
                         device=dev)
    tau = fitted.workload.segment_seconds
    res = IG.run_skyscraper_fused(
        fitted, stream, n_cores=8, cloud_budget_core_s=5_000.0,
        plan_days=64.5 * tau / 86400, forecast_mode="model",
        sink=store, telemetry=True, device=dev)
    tel = res.telemetry
    print(f"   quality {res.quality_pct:6.2f}%  over "
          f"{stream.n_segments} segments")
    print(f"   telemetry: {tel.summary()}")
    assert tel.segments == stream.n_segments
    # the counter also sees a first-segment switch away from the boot
    # config, which diff(k_trace) cannot
    switches = int((np.diff(res.k_trace) != 0).sum())
    assert switches <= tel.config_switches <= switches + 1

    print("\n== 2. warehouse-side counters (same store, zero probes) ==")
    table, mask = store.query((Filter("quality", "ge", 0.0),
                               TopK(5, by="on_core_s")))
    stel = store.telemetry()
    print(f"   store: {stel.summary()}")
    assert stel.n_rows == stream.n_segments
    assert stel.query_dispatches == 1
    # fused batch ingest: row t waited T-1-t ticks before queryable
    assert stel.lag_max_ticks == stream.n_segments - 1

    print("\n== 3. dispatch tracer over the fused engines ==")
    records, trace = trace_all(only="fused", reps=2, device=dev)
    for name, r in sorted(records.items()):
        if "skipped" in r:
            print(f"   {name:28s} SKIP ({r['skipped']})")
            continue
        print(f"   {name:28s} span={r['span_us']:9.1f}us "
              f"exec+{r['new_executables']} "
              f"recompile={r['recompiles']} "
              f"hostsync={r['host_transfers']}")
        assert r["recompiles"] == 0
    problems = validate_chrome_trace(trace)
    assert not problems, problems
    out = os.path.join(tempfile.gettempdir(), "vetl_trace_torch.json")
    with open(out, "w") as f:
        json.dump(trace, f)
    print(f"   wrote {len(trace['traceEvents'])} spans to {out}")
    print("   (open in chrome://tracing; gate a run with "
          "`python -m repro_torch.obs --compare OBS_TORCH.json`)")
    print("\nOK: flight recorder + dispatch tracer both healthy.")
    return records


if __name__ == "__main__":
    main()
