"""Figure-3 style end-to-end V-ETL run on the PyTorch/CUDA port, the
counterpart of ``examples/vetl_ingest.py``: 24 h of a synthetic traffic
stream on constrained hardware with buffering and cloud bursting, on
the card unless ``--device cpu``.

    PYTHONPATH=src python examples/vetl_ingest_torch.py [--device cpu] \
        [--days 1.0] [--fit-days 6.0]

``run_skyscraper_fused`` runs the whole online phase (forecast, LP
planning and reactive switching for every planning window) on the
device; only the finished traces come back to the host. Multi-stream
ingestion (paper App. D) is ``run_skyscraper_multi``, and online
serving of V live cameras is ``repro_torch.core.api.SkyscraperPool``.
"""
import sys
import os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse

import numpy as np

from repro_torch.configs.workloads import COVID
from repro_torch.core import ingest as IG
from repro_torch.core.offline import fit
from repro_torch.data.stream import generate


def sparkline(xs, width=64):
    xs = np.asarray(xs, float)
    xs = xs[:: max(1, len(xs) // width)]
    lo, hi = xs.min(), xs.max()
    ticks = " .:-=+*#%@"
    if hi - lo < 1e-9:
        return ticks[0] * len(xs)
    return "".join(ticks[int((x - lo) / (hi - lo) * (len(ticks) - 1))]
                   for x in xs)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--days", type=float, default=1.0,
                    help="days of stream to ingest (default 1.0)")
    ap.add_argument("--fit-days", type=float, default=6.0,
                    help="days of historical stream to fit on (default 6)")
    args = ap.parse_args(argv)
    dev = args.device

    print(f"== offline phase (fit on {args.fit_days:g} days of historical "
          f"stream) ==")
    fitted = fit(COVID, n_cores=8, days_unlabeled=args.fit_days,
                 n_categories=4, device=dev)
    print(f"K={len(fitted.configs)} Pareto configs, costs="
          f"{np.round(fitted.cost, 2)} core-s/seg")
    print(f"forecaster val MAE: {fitted.forecast_metrics['val_mae']:.4f}")

    print(f"\n== online: {args.days * 24:g}h ingestion, 8 cores + 4GB "
          f"buffer + cloud ==")
    print("   (fused engine: every planning window on the device)")
    stream = generate(COVID, days=args.days, seed=99)
    res = IG.run_skyscraper_fused(fitted, stream, n_cores=8,
                                  cloud_budget_core_s=15_000.0,
                                  buffer_gb=4.0, plan_days=0.25 * args.days,
                                  device=dev)
    k = IG.best_static_config(fitted, 8)
    static = IG.run_static(fitted, stream, k, n_cores=8)
    opt = IG.run_optimum(fitted, stream, n_cores=8,
                         cloud_budget_core_s=15_000.0, device=dev)

    print(f"skyscraper quality: {res.quality_pct:6.2f}%  "
          f"(work {res.work_core_s / 1e3:.0f}k core-s, "
          f"cloud {res.cloud_core_s:.0f} core-s)")
    print(f"static-best quality: {static.quality_pct:6.2f}%")
    print(f"optimum (oracle):    {opt.quality_pct:6.2f}%")
    print(f"knob switches: "
          f"{int((np.diff(res.k_trace) != 0).sum())} over "
          f"{len(res.k_trace)} segments")
    print("\nbuffer fill over the day (paper Fig. 3, third panel):")
    print("  " + sparkline(res.buffer_trace))
    print("difficulty (content) over the day:")
    print("  " + sparkline(stream.difficulty))
    print("chosen config cost over the day (second panel):")
    print("  " + sparkline(fitted.cost[res.k_trace]))
    assert res.quality_pct > static.quality_pct
    print("\nOK: content-adaptive ingestion beat the static baseline.")
    return res, static, opt


if __name__ == "__main__":
    main()
