"""Flight-recorder telemetry of the fused run and of the store: the
port of ``repro/obs/telemetry.py`` for one stream.

The fused run (``core.ingest.run_skyscraper_fused(telemetry=True)``)
carries a dict of float32 0-d counters beside the switcher state through
its window loop and snapshots them at every window boundary; the host
derives per-window deltas from the snapshots. Nothing is read back to
the host inside the loop.

- Each counter is updated once per segment, in time order, by one
  float32 add (or max) per step, in the reference's order, so every
  counter is bit-exact against ``telemetry_ref``, the numpy float32
  replay of the run's traces, on any device.
- A padding step (``valid`` False) leaves every counter as it was.

Counter semantics (all float32):

    seg_total          valid segments executed
    seg_dropped        segments shed by overload (no feasible placement)
    buffer_hwm_s       high-water mark of post-segment buffer fill (s)
    buffer_occ_sum_s   sum of post-segment buffer fill (s); divide by
                       seg_total for the mean occupancy
    onprem_core_s      on-prem work accumulated (core-seconds)
    cloud_core_s       cloud work accumulated (core-seconds)
    config_switches    valid steps whose chosen config differs from the
                       previous step's (dropped segments still switch)

Many streams: ``window_scan_multi_tel`` carries (V,) counters beside
the batched switcher state (``switcher.window_scan_multi``), one update
per stream and segment in time order, so each stream's counters are
bit-exact against ``telemetry_ref`` of its own traces. ``HostTelemetry``
is the serving pool's recorder: the same float32 updates on the host,
from the per-tick outputs the pool reads back anyway.

``StoreTelemetry`` and ``store_obs_*`` are the store's counters,
computed from host metadata only: ingest and query dispatches, the
ingest-to-queryable lag in ticks, the standing registry's gauges and
the cold tier's spills and dequantizes (``warehouse.tiers``). Shard
balance past one shard comes with the sharded store.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.switcher import (_masked_switch,
                                      _masked_switch_multi, window_scan,
                                      window_scan_multi)

TEL_KEYS = ("seg_total", "seg_dropped", "buffer_hwm_s",
            "buffer_occ_sum_s", "onprem_core_s", "cloud_core_s",
            "config_switches")


# ---------------------------------------------------------------------------
# device side: the counter dict and the telemetry window loop
# ---------------------------------------------------------------------------

def tel_init(state) -> Dict[str, torch.Tensor]:
    """Zeroed counters shaped like the switcher state's ``buffer_s`` (0-d
    float32 on its device)."""
    return {k: torch.zeros_like(state["buffer_s"]) for k in TEL_KEYS}


def tel_step(tel, k_prev, out, valid):
    """One segment's counter update. ``k_prev`` is the pre-step
    ``k_cur``, ``out`` the switch step's outs dict; ``valid`` False leaves
    every counter as it was. Each update is one float32 add (max for the
    high-water mark), in the reference's order."""
    def add(cur, x):
        return torch.where(valid, cur + x, cur)

    return {
        "seg_total": add(tel["seg_total"], 1.0),
        "seg_dropped": add(tel["seg_dropped"],
                           out["dropped"].to(torch.float32)),
        "buffer_hwm_s": torch.where(
            valid, torch.maximum(tel["buffer_hwm_s"], out["buffer_s"]),
            tel["buffer_hwm_s"]),
        "buffer_occ_sum_s": add(tel["buffer_occ_sum_s"], out["buffer_s"]),
        "onprem_core_s": add(tel["onprem_core_s"], out["on_s"]),
        "cloud_core_s": add(tel["cloud_core_s"], out["cl_s"]),
        "config_switches": add(tel["config_switches"],
                               (out["k"] != k_prev).to(torch.float32)),
    }


def masked_switch_tel(carry, qual_row, arrival, valid, alpha, tables):
    """``switcher._masked_switch`` with the counters carried beside the
    state: carry (state, tel) -> ((state, tel), outs)."""
    state, tel = carry
    new_state, out = _masked_switch(state, qual_row, arrival, valid, alpha,
                                    tables)
    return (new_state, tel_step(tel, state["k_cur"], out, valid)), out


def window_scan_tel(state, tel, quals, arrivals, valid, alpha, tables):
    """``switcher.window_scan`` with the counters: returns ((state, tel),
    outs)."""
    return window_scan((state, tel), quals, arrivals, valid, alpha, tables,
                       step=masked_switch_tel)


def masked_switch_multi_tel(carry, qual_rows, arrivals, valid, alpha,
                            tables):
    """``switcher._masked_switch_multi`` with (V,) counters carried
    beside the batched state."""
    state, tel = carry
    new_state, out = _masked_switch_multi(state, qual_rows, arrivals, valid,
                                          alpha, tables)
    return (new_state, tel_step(tel, state["k_cur"], out, valid)), out


def window_scan_multi_tel(state, tel, quals, arrivals, valid, alpha,
                          tables):
    """``switcher.window_scan_multi`` with the per-stream counters:
    returns ((state, tel), outs with (V, W) leaves)."""
    return window_scan_multi((state, tel), quals, arrivals, valid, alpha,
                             tables, step=masked_switch_multi_tel)


# ---------------------------------------------------------------------------
# host side: the run's telemetry and its numpy mirror
# ---------------------------------------------------------------------------

@dataclass
class Telemetry:
    """Flight-recorder counters of one run, on the host.

    ``counters`` holds the final cumulative float32 values (scalars for
    one stream, (V,) arrays for many), and ``per_window`` the cumulative
    snapshots at each window boundary ((n_w,) or (n_w, V) arrays);
    ``extras`` carries the serving pool's host counts (ticks, replans).
    The raw counters are the bit-exactness contract; the derived views
    (means, deltas) are for display."""
    counters: Dict[str, np.ndarray]
    per_window: Dict[str, np.ndarray] = field(default_factory=dict)
    extras: Dict[str, float] = field(default_factory=dict)

    @classmethod
    def from_device(cls, tel_windows) -> "Telemetry":
        """From the stacked per-window snapshots ((n_w,) tensors or
        arrays): the last row is the end-of-run value."""
        per_window = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                          else np.asarray(v))
                      for k, v in tel_windows.items()}
        counters = {k: v[-1] for k, v in per_window.items()}
        return cls(counters=counters, per_window=per_window)

    @property
    def segments(self) -> float:
        return float(np.sum(self.counters["seg_total"]))

    @property
    def dropped(self) -> float:
        return float(np.sum(self.counters["seg_dropped"]))

    @property
    def buffer_hwm_s(self) -> float:
        return float(np.max(self.counters["buffer_hwm_s"]))

    @property
    def buffer_occ_mean_s(self) -> float:
        n = np.sum(self.counters["seg_total"])
        return float(np.sum(self.counters["buffer_occ_sum_s"])
                     / max(n, 1.0))

    @property
    def onprem_core_s(self) -> float:
        return float(np.sum(self.counters["onprem_core_s"]))

    @property
    def cloud_core_s(self) -> float:
        return float(np.sum(self.counters["cloud_core_s"]))

    @property
    def config_switches(self) -> float:
        return float(np.sum(self.counters["config_switches"]))

    def window_deltas(self) -> Dict[str, np.ndarray]:
        """Per-window deltas of the monotone counters (the gauge
        ``buffer_hwm_s`` stays cumulative)."""
        out = {}
        for k, v in self.per_window.items():
            if k == "buffer_hwm_s":
                out[k] = v.copy()
            else:
                out[k] = np.diff(v, axis=0, prepend=np.zeros_like(v[:1]))
        return out

    def summary(self) -> str:
        return (f"segments={self.segments:.0f} "
                f"dropped={self.dropped:.0f} "
                f"buffer_hwm={self.buffer_hwm_s:.1f}s "
                f"occ_mean={self.buffer_occ_mean_s:.2f}s "
                f"onprem={self.onprem_core_s:.0f}core-s "
                f"cloud={self.cloud_core_s:.0f}core-s "
                f"switches={self.config_switches:.0f}")


def _accumulate(counters: Dict[str, np.ndarray], k_prev: np.ndarray,
                k, dropped, buffer_s, on_s, cl_s, valid) -> np.ndarray:
    """One segment-time step of the float32 mirror, vectorised over a
    stream axis. Updates ``counters`` in place; returns the new
    ``k_prev``. One float32 add (or max) per counter, in the device
    loop's order."""
    v = np.asarray(valid, bool)
    f32 = np.float32

    def add(key, x):
        counters[key] = np.where(
            v, (counters[key] + np.asarray(x, f32)).astype(f32),
            counters[key])

    add("seg_total", f32(1.0))
    add("seg_dropped", dropped)
    counters["buffer_hwm_s"] = np.where(
        v, np.maximum(counters["buffer_hwm_s"], np.asarray(buffer_s, f32)),
        counters["buffer_hwm_s"])
    add("buffer_occ_sum_s", buffer_s)
    add("onprem_core_s", on_s)
    add("cloud_core_s", cl_s)
    add("config_switches", (np.asarray(k) != k_prev).astype(f32))
    return np.where(v, np.asarray(k, np.int64), k_prev)


def telemetry_ref(traces: Dict[str, np.ndarray], k0,
                  valid: Optional[np.ndarray] = None
                  ) -> Dict[str, np.ndarray]:
    """Numpy float32 mirror of the device counters: replay the run's
    per-segment traces in time order with sequential float32 adds.
    ``traces`` has keys ``k``, ``dropped``, ``buffer_s``, ``on_s`` and
    ``cl_s`` with (T,) (one stream) or (V, T) leaves; ``k0`` is the
    initial ``k_cur`` (the most qualitative config, ``argmin(rank_pos)``).
    Returns the counters the device run must match bit for bit."""
    single = np.asarray(traces["k"]).ndim == 1

    def twod(x):
        a = np.asarray(x)
        return a[None] if single else a
    k = twod(traces["k"])
    dropped = twod(traces["dropped"])
    buf = twod(traces["buffer_s"]).astype(np.float32)
    on = twod(traces["on_s"]).astype(np.float32)
    cl = twod(traces["cl_s"]).astype(np.float32)
    V, T = k.shape
    vmask = (np.ones((V, T), bool) if valid is None
             else twod(valid).astype(bool))
    counters = {key: np.zeros((V,), np.float32) for key in TEL_KEYS}
    k_prev = np.broadcast_to(np.asarray(k0, np.int64), (V,)).copy()
    for t in range(T):
        k_prev = _accumulate(counters, k_prev, k[:, t], dropped[:, t],
                             buf[:, t], on[:, t], cl[:, t], vmask[:, t])
    if single:
        counters = {key: v[0] for key, v in counters.items()}
    return counters


class HostTelemetry:
    """The serving pool's flight recorder: sequential float32 counters
    per slot, updated on the host from the per-tick switch outputs the
    pool already reads back (``_accumulate``, the same updates as the
    device loop), so it adds no device work."""

    def __init__(self, n_streams: int, k0: int):
        self.V = int(n_streams)
        self.k0 = int(k0)
        self.counters = {k: np.zeros((self.V,), np.float32)
                         for k in TEL_KEYS}
        self._k_prev = np.full((self.V,), int(k0), np.int64)
        self.ticks = 0
        self.replans = 0

    def update(self, outs, valid=None) -> None:
        """One pool tick: ``outs`` holds (V,) host arrays;
        ``valid`` (V,) bool masks the slots that took no step (retired or
        empty), whose counters stay as they were."""
        self._k_prev = _accumulate(
            self.counters, self._k_prev, outs["k"], outs["dropped"],
            outs["buffer_s"], outs["on_s"], outs["cl_s"],
            np.ones((self.V,), bool) if valid is None
            else np.asarray(valid, bool))
        self.ticks += 1

    def grow(self, n_streams: int) -> None:
        """Widen to ``n_streams`` slots (the pool's bucket growth): the
        counters kept, new slots zeroed with ``k_prev = k0``."""
        n = int(n_streams)
        if n <= self.V:
            return
        pad = n - self.V
        self.counters = {k: np.concatenate([v, np.zeros((pad,), np.float32)])
                         for k, v in self.counters.items()}
        self._k_prev = np.concatenate(
            [self._k_prev, np.full((pad,), self.k0, np.int64)])
        self.V = n

    def reset_slot(self, v: int) -> None:
        """Zero one slot's counters (a freed slot re-admitted for another
        stream starts afresh)."""
        for arr in self.counters.values():
            arr[v] = np.float32(0.0)
        self._k_prev[v] = self.k0

    def snapshot(self, select=None) -> Telemetry:
        """The counters, restricted to the slots ``select`` when given
        (the pool passes its active slots)."""
        if select is None:
            counters = {k: v.copy() for k, v in self.counters.items()}
        else:
            idx = np.asarray(select, np.int64)
            counters = {k: v[idx].copy() for k, v in self.counters.items()}
        return Telemetry(counters=counters,
                         extras={"ticks": float(self.ticks),
                                 "replans": float(self.replans)})


# ---------------------------------------------------------------------------
# warehouse: ingest-to-queryable lag and dispatch counts (host metadata)
# ---------------------------------------------------------------------------

@dataclass
class StoreTelemetry:
    """The store's flight recorder, from host metadata only (row counts,
    batch shapes): no device read.

    The ingest-to-queryable lag is counted in ticks (segment slots): a
    row that landed in a T-segment fused batch at in-batch offset ``t``
    waited ``T - 1 - t`` ticks; a per-tick ingest has lag 0."""
    rows_by_shard: np.ndarray
    ingest_dispatches: int = 0
    query_dispatches: int = 0
    lag_rows: int = 0
    lag_sum_ticks: int = 0
    lag_max_ticks: int = 0
    spill_events: int = 0
    spilled_rows: int = 0
    dequantize_events: int = 0
    # the standing-query registry: registered plans, ingests that
    # refreshed them, and the alert subscriptions' activity
    standing_queries: int = 0
    standing_refreshes: int = 0
    alerts_checked: int = 0
    alerts_fired: int = 0

    @property
    def n_rows(self) -> int:
        return int(np.sum(self.rows_by_shard))

    @property
    def imbalance(self) -> float:
        """max-shard rows / mean-shard rows (1.0 when balanced, and for
        an empty store)."""
        total = int(np.sum(self.rows_by_shard))
        if total == 0:
            return 1.0
        mean = total / len(self.rows_by_shard)
        return float(np.max(self.rows_by_shard) / mean)

    @property
    def lag_mean_ticks(self) -> float:
        return self.lag_sum_ticks / max(self.lag_rows, 1)

    def summary(self) -> str:
        return (f"rows={self.n_rows} shards={len(self.rows_by_shard)} "
                f"imbalance={self.imbalance:.2f} "
                f"lag_mean={self.lag_mean_ticks:.1f}t "
                f"lag_max={self.lag_max_ticks}t "
                f"ingests={self.ingest_dispatches} "
                f"queries={self.query_dispatches} "
                f"spills={self.spill_events} "
                f"dequantizes={self.dequantize_events} "
                f"standing={self.standing_queries} "
                f"refreshes={self.standing_refreshes} "
                f"alerts={self.alerts_fired}/{self.alerts_checked}")


def store_obs_init() -> Dict[str, int]:
    """A fresh counter dict for one store."""
    return {"ingest_dispatches": 0, "query_dispatches": 0,
            "lag_rows": 0, "lag_sum_ticks": 0, "lag_max_ticks": 0,
            "standing_queries": 0, "standing_refreshes": 0,
            "alerts_checked": 0, "alerts_fired": 0}


def store_obs_batch(obs: Dict[str, int], n_streams: int, T: int) -> None:
    """One fused-batch ingest: ``n_streams`` streams of ``T`` segments
    became queryable together, so per stream the lag over its rows is
    0..T-1 (sum T(T-1)/2, max T-1)."""
    obs["ingest_dispatches"] += 1
    obs["lag_rows"] += n_streams * T
    obs["lag_sum_ticks"] += n_streams * (T * (T - 1) // 2)
    obs["lag_max_ticks"] = max(obs["lag_max_ticks"], T - 1)


def store_obs_tick(obs: Dict[str, int], n_rows: int) -> None:
    """One per-tick ingest: its rows are queryable the tick they land
    (lag 0)."""
    obs["ingest_dispatches"] += 1
    obs["lag_rows"] += n_rows
