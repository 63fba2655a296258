"""Host-side dispatch tracing over the port's engines.

Port of ``repro/obs/trace.py``. Every engine of ``obs.engines`` is
traceable: the tracer builds the engine's tiny example on a device,
runs it with wall-clock spans around the cold call and the warm calls,
each ending in ``torch.cuda.synchronize()`` on the card (a span without
it measures only the enqueue), and records per engine:

- ``new_executables``: kernel libraries loaded by the cold call (the
  count of ``kernels.build._LIBS``, the port's counterpart of the
  reference's jit-cache probe); ``recompiles``: its growth over the
  warm calls, which must be 0;
- ``arg_bytes`` / ``out_bytes``: the tensors and arrays of the
  arguments and of the output;
- ``host_transfers``: the host synchronisations of one more warm call
  under ``torch.cuda.set_sync_debug_mode("warn")`` (a ``.item()``, a
  copy to or from the host, a ``nonzero``), 0 on the CPU;
- ``launches``: each kernel wrapper's ``LAUNCHES`` delta in one warm
  call, the port's dispatch count of its hand-written kernels (also in
  each warm span's Chrome ``args``).

Spans are emitted in Chrome trace-event format (load the trace file in
``chrome://tracing`` or Perfetto) and aggregated into the report that
``python -m repro_torch.obs --compare`` gates regressions against.
"""
from __future__ import annotations

import json
import statistics
import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as _k3
from repro_torch.kernels import frame_preproc as _k2
from repro_torch.kernels import ssd as _k4
from repro_torch.kernels import warehouse_agg as _k1
from repro_torch.obs import engines as E

# (name in the records, module, counter): every kernel wrapper's count
_COUNTERS = (("K1", _k1, "LAUNCHES"), ("K2", _k2, "LAUNCHES"),
             ("K3", _k3, "LAUNCHES"), ("K3_bwd", _k3, "BWD_LAUNCHES"),
             ("K4", _k4, "LAUNCHES"), ("K4_bwd", _k4, "BWD_LAUNCHES"))


def traceable_engine_names() -> set:
    """Engines the tracer covers: every entry of ``obs.engines``."""
    return set(E.ENGINES)


def _tree_bytes(tree, seen=None) -> int:
    """Bytes of the tensors and numpy arrays in a tree of tuples, lists,
    dicts, dataclasses and objects' attributes (a store's columns),
    each counted once (``numel * element_size``)."""
    seen = set() if seen is None else seen
    if id(tree) in seen:
        return 0
    seen.add(id(tree))
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, np.ndarray):
        return int(tree.nbytes)
    if isinstance(tree, dict):
        return sum(_tree_bytes(v, seen) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_tree_bytes(v, seen) for v in tree)
    if hasattr(tree, "__dict__") and not isinstance(tree, type) \
            and not callable(tree):
        return _tree_bytes(vars(tree), seen)
    return 0


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count, by kernel."""
    return {k: getattr(mod, attr) for k, mod, attr in _COUNTERS}


def _delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def host_syncs(call, device) -> int:
    """The host synchronisations of ``call()`` on ``device``: the
    warnings of ``torch.cuda.set_sync_debug_mode("warn")`` while it
    runs, the device drained before and after outside the counted
    region, the mode restored. 0 on the CPU, where nothing syncs."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return 0
    _sync(dev)
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    _sync(dev)
    # the mode's first use also warns once that it is a prototype
    return sum(1 for w in caught
               if "called a synchronizing CUDA operation" in str(w.message))


class SpanRecorder:
    """Collects Chrome trace events against one wall-clock origin."""

    def __init__(self):
        self.origin = time.perf_counter()
        self.events: List[Dict] = []

    def span(self, name: str, cat: str, t_start: float, t_end: float,
             tid: int, args: Optional[Dict] = None) -> None:
        self.events.append({
            "name": name, "cat": cat, "ph": "X",
            "ts": (t_start - self.origin) * 1e6,
            "dur": max((t_end - t_start) * 1e6, 0.01),
            "pid": 0, "tid": tid, "args": args or {}})

    def chrome_trace(self) -> Dict:
        return {"traceEvents": self.events, "displayTimeUnit": "ms"}


def trace_engine(name: str, builder, rec: SpanRecorder, tid: int,
                 reps: int = 3, with_syncs: bool = True,
                 device=None) -> Dict:
    """Trace one engine: cold span (first call, kernel builds included),
    ``reps`` warm spans, library and launch deltas, byte sizes, host
    synchronisations. ``builder(device)`` returns the engine's
    ``EngineExample``. Returns the engine's record."""
    dev = resolve(device)
    try:
        ex = builder(dev)
    except E.SkipEngine as e:
        return {"skipped": str(e)}

    def call():
        out = ex.fn(*ex.args, **ex.kwargs)
        _sync(dev)
        return out

    p0 = len(build._LIBS)
    _sync(dev)
    t0 = time.perf_counter()
    out = call()
    t1 = time.perf_counter()
    p1 = len(build._LIBS)
    rec.span(f"{name}:cold", "compile+run", t0, t1, tid,
             {"new_executables": p1 - p0})

    spans_us = []
    recompiles = 0
    launches: Dict[str, int] = {}
    for i in range(max(reps, 1)):
        q0, n0 = len(build._LIBS), launch_counts()
        s0 = time.perf_counter()
        out = call()
        s1 = time.perf_counter()
        q1, launches = len(build._LIBS), _delta(launch_counts(), n0)
        recompiles += q1 - q0
        spans_us.append((s1 - s0) * 1e6)
        rec.span(name, "dispatch", s0, s1, tid,
                 {"call": i, "recompiles": q1 - q0, "launches": launches})

    record = {
        "cold_us": (t1 - t0) * 1e6,
        "span_us": statistics.median(spans_us),
        "span_min_us": min(spans_us),
        "new_executables": int(p1 - p0),
        "recompiles": int(recompiles),
        "arg_bytes": _tree_bytes((ex.args, ex.kwargs)),
        "out_bytes": _tree_bytes(out),
        "launches": launches,
    }
    if with_syncs:
        record["host_transfers"] = host_syncs(
            lambda: ex.fn(*ex.args, **ex.kwargs), dev)
    return record


def trace_all(only: Optional[str] = None, reps: int = 3,
              with_syncs: bool = True,
              device=None) -> Tuple[Dict[str, Dict], Dict]:
    """Trace every engine (optionally substring-filtered) on ``device``
    (``None`` means CUDA). Returns ``(records, chrome_trace)``."""
    dev = resolve(device)
    engines = {k: v for k, v in E.ENGINES.items() if not only or only in k}
    rec = SpanRecorder()
    records: Dict[str, Dict] = {}
    for tid, (name, builder) in enumerate(engines.items()):
        records[name] = trace_engine(name, builder, rec, tid, reps=reps,
                                     with_syncs=with_syncs, device=dev)
    return records, rec.chrome_trace()


def validate_chrome_trace(trace: Dict) -> List[str]:
    """Structural problems of a Chrome trace dict (empty list = valid:
    serializable, required keys present, durations non-negative)."""
    problems = []
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    for i, ev in enumerate(events):
        for key in ("name", "ph", "ts", "pid", "tid"):
            if key not in ev:
                problems.append(f"event {i}: missing {key!r}")
        if ev.get("ph") == "X" and ev.get("dur", 0) < 0:
            problems.append(f"event {i}: negative dur")
    try:
        json.dumps(trace)
    except (TypeError, ValueError) as e:
        problems.append(f"not JSON-serializable: {e}")
    return problems
