"""``python -m repro_torch.obs``: the port's observability report driver.

Port of ``repro/obs/run.py``. Traces every engine of ``obs.engines``
(see ``obs.trace``) on a device (the card unless ``--device cpu``),
writes

- ``OBS_TORCH.json``       aggregated per-engine metrics,
- ``OBS_TORCH_TRACE.json`` the Chrome-trace span timeline (open in
  ``chrome://tracing`` or Perfetto; regenerated, not committed),

and with ``--compare OLD.json`` exits non-zero on regressions:

- **ceilings** (structural, host-independent, zero headroom): a warm
  kernel-library load, a host synchronisation, or extra libraries
  against the baseline;
- **span-time floors** (timings, host-class-gated): a span that slowed
  >20% against the baseline fails, but only when both reports come from
  the same host class AND the baseline span is above ``SPAN_FLOOR_US``
  (micro-spans are noise);
- a baseline engine that disappears (or degrades to skipped) fails.

A topology change skips the per-engine gates; the topology names the
device type, so a CPU report and a card report are never gated against
each other.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List

import torch

from repro_torch.device import resolve
from repro_torch.obs.trace import trace_all

SCHEMA = 1
SPAN_FLOOR_US = 5000.0       # gate span growth only above this baseline
SPAN_GROWTH = 0.20           # >20% slower than baseline fails
_CEILINGS = ("new_executables", "recompiles", "host_transfers")


def run_obs(only=None, reps: int = 3, with_syncs: bool = True,
            device=None):
    """Trace the engines on ``device`` (``None`` means CUDA); return
    ``(report, chrome_trace)``."""
    dev = resolve(device)
    records, trace = trace_all(only=only, reps=reps, with_syncs=with_syncs,
                               device=dev)
    report = {
        "schema": SCHEMA,
        "topology": {"n_devices": (torch.cuda.device_count()
                                   if dev.type == "cuda" else 1),
                     "device": dev.type},
        "host": {"host_cores": float(os.cpu_count() or 1)},
        "engines": records,
        "n_engines": len(records),
        "n_skipped": sum(1 for r in records.values() if "skipped" in r),
    }
    return report, trace


def compare(new: Dict, old: Dict) -> List[str]:
    """Regressions of ``new`` against a baseline report."""
    regressions: List[str] = []
    if new.get("topology") != old.get("topology"):
        print(f"[obs] topology changed {old.get('topology')} -> "
              f"{new.get('topology')}; skipping per-engine gates",
              file=sys.stderr)
        return regressions
    old_cores = old.get("host", {}).get("host_cores")
    new_cores = new.get("host", {}).get("host_cores")
    same_host = (old_cores is None or new_cores is None
                 or old_cores == new_cores)
    if not same_host:
        print(f"[obs] host class changed ({old_cores:.0f} -> "
              f"{new_cores:.0f} cores): span floors advisory, "
              f"ceilings still gated", file=sys.stderr)
    for name, old_rec in sorted(old.get("engines", {}).items()):
        if "skipped" in old_rec:
            continue
        new_rec = new.get("engines", {}).get(name)
        if new_rec is None:
            regressions.append(f"engine {name!r} disappeared from trace")
            continue
        if "skipped" in new_rec:
            regressions.append(
                f"engine {name!r} now skipped: {new_rec['skipped']}")
            continue
        for key in _CEILINGS:
            ov, nv = old_rec.get(key), new_rec.get(key)
            if isinstance(ov, (int, float)) \
                    and isinstance(nv, (int, float)) and nv > ov:
                regressions.append(
                    f"{name}: {key} grew {ov} -> {nv} [ceiling]")
        ov, nv = old_rec.get("span_us"), new_rec.get("span_us")
        if same_host and isinstance(ov, (int, float)) \
                and isinstance(nv, (int, float)) \
                and ov >= SPAN_FLOOR_US \
                and nv > ov * (1.0 + SPAN_GROWTH):
            regressions.append(
                f"{name}: span_us slowed {ov:.0f} -> {nv:.0f} "
                f"(>{SPAN_GROWTH:.0%}) [floor]")
    return regressions


def _summary(report: Dict) -> str:
    topo = report["topology"]
    lines = [f"obs: {report['n_engines']} engines traced "
             f"({report['n_skipped']} skipped, {topo['n_devices']} "
             f"{topo['device']} devices)"]
    for name, rec in report["engines"].items():
        if "skipped" in rec:
            lines.append(f"  {name:34s} SKIP ({rec['skipped']})")
            continue
        lines.append(
            f"  {name:34s} span={rec['span_us']:9.1f}us "
            f"cold={rec['cold_us']:10.1f}us "
            f"exec+{rec['new_executables']} "
            f"recompile={rec['recompiles']} "
            f"hosttx={rec.get('host_transfers', '?')} "
            f"launches={rec['launches'] or '-'} "
            f"out={rec['out_bytes']}B")
    return "\n".join(lines)


def main(argv=None) -> int:
    """CLI for the dispatch tracer (``python -m repro_torch.obs``): runs
    every engine under the tracer, writes the report and a Chrome trace,
    and regression-gates against ``--compare``."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="dispatch tracer over the port's engines: "
                    "Chrome-trace spans + a regression-gated report")
    ap.add_argument("--json", default="OBS_TORCH.json",
                    help="report path (default ./OBS_TORCH.json)")
    ap.add_argument("--trace", default="OBS_TORCH_TRACE.json",
                    help="Chrome-trace output path "
                         "(default ./OBS_TORCH_TRACE.json)")
    ap.add_argument("--compare", metavar="OLD",
                    help="fail on regressions against a baseline report")
    ap.add_argument("--only", help="substring filter on engine names "
                                   "(compare gates still apply to the "
                                   "traced subset)")
    ap.add_argument("--smoke", action="store_true",
                    help="a single warm rep per engine")
    ap.add_argument("--reps", type=int, default=None,
                    help="warm calls per engine (default 3; smoke 1)")
    ap.add_argument("--device", default=None,
                    help="device to trace on (default: the card, cuda)")
    args = ap.parse_args(argv)

    old = None
    if args.compare:
        with open(args.compare) as fh:
            old = json.load(fh)

    reps = args.reps if args.reps is not None else (1 if args.smoke else 3)
    report, trace = run_obs(only=args.only, reps=reps, device=args.device)
    print(_summary(report))

    with open(args.json, "w") as fh:
        json.dump(report, fh, indent=1, sort_keys=True)
        fh.write("\n")
    print(f"[obs] wrote {args.json}")
    with open(args.trace, "w") as fh:
        json.dump(trace, fh)
        fh.write("\n")
    print(f"[obs] wrote {len(trace['traceEvents'])} spans to {args.trace}")

    rc = 0
    if old is not None:
        regs = compare(report, old)
        for r in regs:
            print(f"[obs] REGRESSION: {r}")
        if regs:
            rc = 1
        else:
            print(f"[obs] compare vs {args.compare}: OK")
    return rc
