"""Online video ingestion (paper §4): the per-window loop, the fused run
of one stream and of many, and the paper's baselines.

Port of ``repro/core/ingest.py``.

- ``run_skyscraper`` is the paper's online loop, one planning window at
  a time: the forecast (the forecaster on the labels seen so far, the
  window's true category mix, or uniform), the Lagrangian LP and the
  switcher's window run on the device; the budget, the labels seen and
  the App. E.2 online fine-tuning of the forecaster are the reference's
  per-window bookkeeping on the host, so each window ends in a read of
  its traces.
- ``run_skyscraper_fused`` and ``run_skyscraper_multi`` are the fused
  runs. The reference compiles each whole run into one program (an
  outer ``lax.scan`` over planning windows); here it is a Python loop
  over windows whose body is the same three steps — forecast the
  category mix, solve the window-rationed LP, run the switcher over the
  window — as tensor ops on one device. Nothing is read back to the
  host inside the loop, so on the card the host only enqueues work
  until the traces are copied out at the end. The multi-stream run
  (paper App. D, scenario 1) plans all V streams jointly in each window
  (the window's category mix of each stream, then one stacked LP under
  the shared budget) and switches them in one batched step per segment.
- The baselines (Static, Chameleon*, VideoStorm-like) are the
  reference's per-segment numpy loops on the host; ``run_optimum``, the
  ground-truth knapsack, solves its LP (one category per segment) on
  the device.

Tensor division below always divides by a tensor on the same device,
never by a Python number: CUDA divides a tensor by a CPU scalar through
a multiplication by its reciprocal, which rounds differently from the
CPU and from the reference.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.forecaster import (forecast_from_labels, make_dataset,
                                         train_forecaster)
from repro_torch.core.knobs import quality as qfn
from repro_torch.core.offline import Fitted
from repro_torch.core.planner import (solve_lp_lagrangian, solve_lp_rationed,
                                      solve_lp_stacked, solve_multi_stream)
from repro_torch.core.switcher import (init_state, init_state_multi,
                                       pad_window, pad_window_multi,
                                       run_window, run_window_multi,
                                       stack_tables, window_scan,
                                       window_scan_multi)
from repro_torch.data.stream import Stream
from repro_torch.device import resolve
from repro_torch.obs.telemetry import (Telemetry, tel_init,
                                       window_scan_multi_tel,
                                       window_scan_tel)

CLOUD_PREMIUM = 1.8      # App. L


@dataclass
class RunResult:
    """Aggregate outcome of one simulated stream run: quality sums,
    core-seconds by tier, buffer peak/overflow, and the config-choice
    histogram/trace the ablation tables report."""
    quality_sum: float
    quality_max_sum: float
    onprem_core_s: float
    cloud_core_s: float
    buffer_peak_s: float
    overflow: bool
    k_hist: np.ndarray
    c_trace: np.ndarray = None
    k_trace: np.ndarray = None
    buffer_trace: np.ndarray = None
    plans: List = field(default_factory=list)
    # the flight recorder's counters (``telemetry=True``), else None
    telemetry: Optional[Telemetry] = None
    # fired standing-query alerts from the sink's registry (one Alert per
    # subscription; empty without a sink or subscriptions)
    alerts: List = field(default_factory=list)

    @property
    def quality_pct(self) -> float:
        return 100.0 * self.quality_sum / max(self.quality_max_sum, 1e-9)

    @property
    def work_core_s(self) -> float:
        return self.onprem_core_s + self.cloud_core_s


def _notify_standing(sink):
    """Poll the sink's standing-query subscriptions right after a run's
    rows landed (the ingest already folded them into the registered
    partials); the fired alerts, [] when the sink has no registry or no
    subscription."""
    reg = getattr(sink, "standing", None)
    if reg is None or not reg.has_subscriptions:
        return []
    return reg.poll()


def _max_quality(stream: Stream, power: np.ndarray) -> np.ndarray:
    return qfn(power.max(), stream.difficulty)


def _assemble_result(cat: Dict[str, np.ndarray], qmax: np.ndarray, K: int,
                     plans: List) -> RunResult:
    """RunResult from a flattened host trace dict (numpy, as the
    reference assembles it)."""
    return RunResult(
        quality_sum=float(cat["qual"].sum()),
        quality_max_sum=float(qmax.sum()),
        onprem_core_s=float(cat["on_s"].sum()),
        cloud_core_s=float(cat["cl_s"].sum()),
        buffer_peak_s=float(cat["buffer_s"].max()),
        overflow=False,
        k_hist=np.bincount(cat["k"], minlength=K),
        c_trace=cat["c"], k_trace=cat["k"], buffer_trace=cat["buffer_s"],
        plans=plans)


def _oracle_rate(q_w, centers, valid, w_tf):
    """Nearest-center labels over a window -> valid-masked category
    rate: (..., W, K) quals vs (..., C, K) centers -> (..., C), with or
    without a leading stream axis. The squared distance is summed over K
    in index order, one add per config, so it rounds the same on every
    device; sentinel padding rows never win the argmin, so padded
    categories get rate 0."""
    diff = q_w[..., :, None, :] - centers[..., None, :, :]
    sq = diff * diff
    d = sq[..., 0]
    for k in range(1, sq.shape[-1]):
        d = d + sq[..., k]
    oh = torch.nn.functional.one_hot(torch.argmin(d, dim=-1),
                                     centers.shape[-2]).to(torch.float32)
    return (oh * valid[..., None]).sum(-2) / w_tf


def run_skyscraper(fitted: Fitted, stream: Stream, *, n_cores: int,
                   cloud_budget_core_s: float = 0.0, buffer_gb: float = 4.0,
                   plan_days: Optional[float] = None,
                   forecast_mode: str = "model",   # model | oracle | uniform
                   online_finetune: bool = False,  # App. E.2
                   seed: int = 0, device=None) -> RunResult:
    """The paper's online loop on ``device`` (``None`` means CUDA): plan
    each window with the chosen forecast mode, then switch over its
    segments; returns the run's ``RunResult``, equal to the reference's.

    Per window, as the reference: the forecast ``r`` (``model``: the
    forecaster on the last ``n_split * interval`` labels, zero-padded in
    front, once a window has run; ``oracle``: the window's true category
    mix, from the host's float32 qualities; else uniform); the budget in
    Python float64 from the cloud spend read back after the last window,
    with the cloud share ``W_t / (T - t)`` of the rest of the stream,
    divided by W_t, rounded to float32 once and solved by the plain
    Lagrangian LP; the window padded to W (``pad_window``) and run. With
    ``online_finetune`` the forecaster is trained 3 more epochs on the
    labels seen once there are ``interval * (n_split + 2)``, and the
    result replaces ``fitted.forecaster`` (the caller's, on its
    device), as the reference's loop replaces it."""
    dev = resolve(device)
    if forecast_mode not in ("model", "oracle", "uniform"):
        raise ValueError(f"unknown forecast_mode {forecast_mode!r}")
    caller = fitted
    if fitted.device != dev:
        fitted = fitted.to(dev)
    w = fitted.workload
    tau = w.segment_seconds
    plan_days = plan_days or fitted.horizon_segments * tau / 86400
    W = max(1, int(plan_days * 86400 / tau))
    tables = fitted.tables(buffer_gb=buffer_gb,
                           cloud_budget=cloud_budget_core_s)
    quals_h = stream.quality(fitted.power, seed=seed).astype(np.float32)
    quals = torch.as_tensor(quals_h, device=dev)
    arrivals = torch.as_tensor(stream.arrival.astype(np.float32), device=dev)
    T = stream.n_segments
    C, K = fitted.centers.shape
    need = fitted.interval_segments * fitted.n_split

    state = init_state(tables)
    buf = torch.zeros((need,), dtype=torch.int64, device=dev)
    labels_hist: List[np.ndarray] = []
    outs_all = {k: [] for k in ("k", "c", "qual", "on_s", "cl_s", "buffer_s")}
    plans = []
    t = 0
    while t < T:
        W_t = min(W, T - t)
        # ---- forecast r (category distribution over the window) ---------
        if forecast_mode == "oracle":
            q_true = quals_h[t:t + W_t]
            d = ((q_true[:, None, :] - fitted.centers[None]) ** 2).sum(-1)
            r = np.bincount(d.argmin(1), minlength=C) / W_t
            r_dev = torch.as_tensor(r, dtype=torch.float32, device=dev)
        elif forecast_mode == "model" and labels_hist:
            r_dev = forecast_from_labels(fitted.forecaster, buf, C,
                                         n_split=fitted.n_split,
                                         interval=fitted.interval_segments)
            r = r_dev.cpu().numpy()
        else:
            r = np.full(C, 1.0 / C)
            r_dev = torch.as_tensor(r, dtype=torch.float32, device=dev)
        # ---- plan (budget = on-prem + rationed cloud, in core-s) --------
        cloud_left = cloud_budget_core_s - float(state["cloud_spent"])
        frac = W_t / (T - t)
        budget = n_cores * tau * W_t + max(cloud_left, 0.0) * frac \
            / CLOUD_PREMIUM
        # LP cost is per segment; hand the planner the per-segment budget
        alpha = solve_lp_lagrangian(tables.centers, tables.cost, r_dev,
                                    np.float32(budget / W_t))
        plans.append((r, alpha.cpu().numpy()))
        # ---- reactive switching over the window (padded to W) ----------
        q_w, a_w, valid = pad_window(quals[t:t + W_t], arrivals[t:t + W_t],
                                     W)
        state, outs = run_window(state, q_w, a_w, alpha, tables, valid=valid)
        host = {k: outs[k][:W_t].cpu().numpy() for k in outs_all}
        for k in ("k", "c"):
            host[k] = host[k].astype(np.int32)
        for k in outs_all:
            outs_all[k].append(host[k])
        labels_hist.append(host["c"])
        if forecast_mode == "model":
            buf = torch.cat([buf, outs["c"][:W_t]])[W_t:]
        t += W_t
        # App. E.2: continuous online fine-tuning of the forecaster on
        # the categories the switcher itself has been recording
        if online_finetune and forecast_mode == "model":
            lab = np.concatenate(labels_hist)
            if len(lab) >= fitted.interval_segments * (fitted.n_split + 2):
                X, Y = make_dataset(lab, C,
                                    interval=fitted.interval_segments,
                                    n_split=fitted.n_split,
                                    horizon=min(W, len(lab) // 4))
                if len(X) >= 8:
                    fitted.forecaster, _ = train_forecaster(
                        fitted.forecaster, X, Y, epochs=3, seed=seed)
    if online_finetune and forecast_mode == "model":
        caller.forecaster = fitted.to(caller.device).forecaster
    cat = {k: np.concatenate(v) for k, v in outs_all.items()}
    return _assemble_result(cat, _max_quality(stream, fitted.power), K,
                            plans)


def _window_layout(T: int, W: int):
    """Split a T-segment run into ceil(T/W) fixed-length windows: padded
    layout plus per-window real lengths and cloud rations."""
    n_w = -(-T // W)
    pad = n_w * W - T
    starts = np.arange(n_w) * W
    wts = np.minimum(W, T - starts).astype(np.int32)
    fracs = (wts / (T - starts)).astype(np.float32)
    return n_w, pad, wts, fracs


def run_skyscraper_fused(fitted: Fitted, stream: Stream, *, n_cores: int,
                         cloud_budget_core_s: float = 0.0,
                         buffer_gb: float = 4.0,
                         plan_days: Optional[float] = None,
                         forecast_mode: str = "model",
                         seed: int = 0, sink=None, sink_stream_id: int = 0,
                         sink_t0: int = 0, telemetry: bool = False,
                         device=None) -> RunResult:
    """Run ``stream`` through forecast -> LP -> switcher, one planning
    window at a time, on ``device`` (``None`` means CUDA). Modes:
    ``model`` (the forecaster on the rolling label buffer; uniform until
    the first window has run), ``oracle`` (the window's true category
    mix) and ``uniform``.

    ``sink``: an optional ``warehouse.SegmentStore`` or
    ``ShardedStore`` on the same device. The stacked (n_w, W) traces and
    the (T, K) measured-quality vectors go to ``sink.ingest_fused``
    without leaving the device (a sharded sink lands them on shard
    ``sink_stream_id % n_shards``), folded into its standing queries;
    their fired alerts are ``RunResult.alerts``.

    ``telemetry=True`` carries the flight recorder's counters
    (``obs.telemetry``) through the window loop beside the switcher state
    and snapshots them at each window boundary; ``RunResult.telemetry``
    holds them, bit-exact against ``obs.telemetry_ref`` of the run's
    traces. ``False`` runs exactly the loop it runs without the flag."""
    dev = resolve(device)
    if fitted.device != dev:
        fitted = fitted.to(dev)
    if forecast_mode not in ("model", "oracle", "uniform"):
        raise ValueError(f"unknown forecast_mode {forecast_mode!r}")
    w = fitted.workload
    tau = w.segment_seconds
    plan_days = plan_days or fitted.horizon_segments * tau / 86400
    W = max(1, int(plan_days * 86400 / tau))
    tables = fitted.tables(buffer_gb=buffer_gb,
                           cloud_budget=cloud_budget_core_s)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    quals = f32(stream.quality(fitted.power, seed=seed).astype(np.float32))
    arrivals = f32(stream.arrival.astype(np.float32))
    T = stream.n_segments
    C, K = fitted.centers.shape
    n_w, pad, wts, fracs = _window_layout(T, W)
    quals_w = torch.nn.functional.pad(quals, (0, 0, 0, pad)).reshape(n_w, W,
                                                                     K)
    arrs_w = torch.nn.functional.pad(arrivals, (0, pad),
                                     value=1.0).reshape(n_w, W)
    valid_w = (torch.arange(n_w * W, device=dev) < T).reshape(n_w, W)
    need = fitted.interval_segments * fitted.n_split
    buf = torch.zeros((need,), dtype=torch.int64, device=dev)
    uniform = torch.full((C,), 1.0 / C, dtype=torch.float32, device=dev)
    core_s, budget = f32(n_cores * tau), f32(cloud_budget_core_s)
    premium = f32(CLOUD_PREMIUM)
    state = init_state(tables)
    tel = tel_init(state) if telemetry else None
    n_seen = 0
    outs_w, rs, alphas, tels = [], [], [], []
    for i in range(n_w):
        w_t = int(wts[i])
        w_tf = f32(float(w_t))
        # ---- forecast r (category distribution over the window) -------
        if forecast_mode == "oracle":
            r = _oracle_rate(quals_w[i], tables.centers, valid_w[i], w_tf)
        elif forecast_mode == "model" and n_seen > 0:
            r = forecast_from_labels(fitted.forecaster, buf, C,
                                     n_split=fitted.n_split,
                                     interval=fitted.interval_segments)
        else:
            r = uniform
        # ---- plan: cloud ration computed from the carried spend -------
        alpha = solve_lp_rationed(
            tables.centers, tables.cost, r, core_s_per_segment=core_s,
            cloud_left=budget - state["cloud_spent"], frac=f32(fracs[i]),
            window_len=w_tf, cloud_premium=premium)
        # ---- reactive switching over the window -----------------------
        if telemetry:
            (state, tel), outs = window_scan_tel(state, tel, quals_w[i],
                                                 arrs_w[i], valid_w[i],
                                                 alpha, tables)
            tels.append(tel)
        else:
            state, outs = window_scan(state, quals_w[i], arrs_w[i],
                                      valid_w[i], alpha, tables)
        # ---- roll the W_t real labels into the history buffer ---------
        if forecast_mode == "model":
            buf = torch.cat([buf, outs["c"]])[w_t:w_t + need]
        n_seen += w_t
        outs_w.append(outs)
        rs.append(r)
        alphas.append(alpha)
    stacked = {k: torch.stack([o[k] for o in outs_w]) for k in outs_w[0]}
    alerts = []
    if sink is not None:
        # Load: the (n_w, W) traces and the (T, K) quality vectors stay on
        # the device on their way into the store (which folds them into
        # its standing queries)
        sink.ingest_fused(stacked, quals, stream_id=sink_stream_id,
                          t0=sink_t0)
        alerts = _notify_standing(sink)
    # un-window: padding only ever sits at the very end
    cat = {k: v.reshape((n_w * W,) + v.shape[2:])[:T].cpu().numpy()
           for k, v in stacked.items()}
    for k in ("k", "p", "c"):
        cat[k] = cat[k].astype(np.int32)
    rs = torch.stack(rs).cpu().numpy()
    alphas = torch.stack(alphas).cpu().numpy()
    res = _assemble_result(cat, _max_quality(stream, fitted.power), K,
                           [(rs[i], alphas[i]) for i in range(n_w)])
    if telemetry:
        res.telemetry = Telemetry.from_device(
            {k: torch.stack([t[k] for t in tels]) for k in tels[0]})
    res.alerts = alerts
    return res


# ---------------------------------------------------------------------------
# many streams (paper App. D, scenario 1)
# ---------------------------------------------------------------------------

def _multi_prep(fitteds, streams, *, buffer_gb, cloud_budget_core_s, seed,
                dev):
    """Shared multi-stream setup: each stream's tables (its share of the
    cloud budget), the category tables sentinel-padded to a common
    C_max, and the stacked stream data (V, T, K) / (V, T)."""
    V = len(fitteds)
    T = min(s.n_segments for s in streams)
    K = len(fitteds[0].configs)
    assert all(len(f.configs) == K for f in fitteds), \
        "joint plan shares one cost table: config counts must match"
    Cs = [f.centers.shape[0] for f in fitteds]
    C_max = max(Cs)
    tables = []
    for f, C_v in zip(fitteds, Cs):
        tb = f.tables(buffer_gb=buffer_gb,
                      cloud_budget=cloud_budget_core_s / V)
        if C_v < C_max:
            # sentinel rows: |center - qual| is huge, so argmin never
            # classifies a segment into a padding category
            pad = torch.full((C_max - C_v, K), 1e6, dtype=torch.float32,
                             device=dev)
            tb.centers = torch.cat([tb.centers, pad])
        tables.append(tb)
    quals = torch.as_tensor(np.stack(
        [s.quality(f.power, seed=seed)[:T].astype(np.float32)
         for s, f in zip(streams, fitteds)]), device=dev)         # (V,T,K)
    arrs = torch.as_tensor(np.stack(
        [s.arrival[:T].astype(np.float32) for s in streams]),
        device=dev)                                               # (V,T)
    qmax = np.stack([np.asarray(_max_quality(s, f.power))[:T]
                     for s, f in zip(streams, fitteds)]).sum(axis=1)
    return V, T, K, Cs, C_max, tables, quals, arrs, qmax


def _fused_run_multi(state, quals_w, arrs_w, valid_w, wts, tables, cost,
                     core_s_total, cloud_ration, *,
                     with_traces: bool = False, telemetry: bool = False):
    """The whole multi-stream run, window by window: each window's
    per-stream oracle category mix -> one joint stacked LP under the
    shared per-segment budget -> the batched V-stream window loop.
    quals_w (n_w, V, W, K); arrs_w / valid_w (n_w, V, W); wts (n_w,)
    real window lengths. Returns (final carry, ys) as the reference's
    scan: ys are the per-window traces ((n_w, V, W) leaves, padding
    zeroed) with ``with_traces``, else the per-window per-stream quality
    sums (n_w, V); with ``telemetry`` the carry is (state, counters) and
    ys (res, per-window counter snapshots). Nothing is read back to the
    host."""
    centers = tables.centers                              # (V, C_max, K)
    dev = centers.device
    budget = core_s_total + cloud_ration
    carry = (state, tel_init(state)) if telemetry else state
    res, tels = [], []
    for i in range(quals_w.shape[0]):
        q_w, a_w, valid = quals_w[i], arrs_w[i], valid_w[i]
        w_tf = torch.as_tensor(float(wts[i]), dtype=torch.float32,
                               device=dev)
        # per-stream oracle r over the window (App. D Eqs. 7-9)
        r = _oracle_rate(q_w, centers, valid, w_tf)
        alpha = solve_lp_stacked(centers, cost, r, budget)
        if telemetry:
            carry, outs = window_scan_multi_tel(*carry, q_w, a_w, valid,
                                                alpha, tables)
            tels.append(carry[1])
        else:
            carry, outs = window_scan_multi(carry, q_w, a_w, valid, alpha,
                                            tables)
        res.append(outs if with_traces else outs["qual"].sum(1))
    if with_traces:
        res = {k: torch.stack([o[k] for o in res]) for k in res[0]}
    else:
        res = torch.stack(res)
    if telemetry:
        tels = {k: torch.stack([t[k] for t in tels]) for k in tels[0]}
        return carry, (res, tels)
    return carry, res


def run_skyscraper_multi(fitteds, streams, *, n_cores_each: int,
                         cloud_budget_core_s: float = 0.0,
                         buffer_gb: float = 4.0,
                         plan_days: float = 0.25, seed: int = 0,
                         sink=None, sink_stream_base: int = 0,
                         sink_t0: int = 0, telemetry: bool = False,
                         device=None):
    """Multi-stream ingestion (paper App. D, scenario 1) on ``device``
    (``None`` means CUDA): each stream has its own cores and buffer; the
    cloud budget and the knob PLAN are joint, one LP over all streams'
    categories, so the shared budget flows to the stream where it buys
    the most quality.

    ``sink``: an optional ``warehouse.SegmentStore`` or
    ``ShardedStore`` on the same device; every stream's per-segment
    traces land there without leaving the device (rows stream-major,
    stream ids from ``sink_stream_base``; a sharded sink routes each
    stream to shard ``id % n_shards``), folded into its standing queries
    by the ingest, their fired alerts under ``"alerts"``.

    ``telemetry=True`` adds a ``"telemetry"`` key: a ``Telemetry`` with
    per-stream (V,) counters, bit-exact against ``telemetry_ref``.
    Returns ``{"quality_pct", "per_stream_pct"[, "alerts", "telemetry"]}``.
    """
    dev = resolve(device)
    fitteds = [f if f.device == dev else f.to(dev) for f in fitteds]
    tau = fitteds[0].workload.segment_seconds
    W = max(1, int(plan_days * 86400 / tau))
    V, T, K, _, _, tables, quals, arrs, qmax = _multi_prep(
        fitteds, streams, buffer_gb=buffer_gb,
        cloud_budget_core_s=cloud_budget_core_s, seed=seed, dev=dev)
    n_w, pad, wts, _ = _window_layout(T, W)
    quals_w = torch.nn.functional.pad(quals, (0, 0, 0, pad)) \
        .reshape(V, n_w, W, K).transpose(0, 1)           # (n_w, V, W, K)
    arrs_w = torch.nn.functional.pad(arrs, (0, pad), value=1.0) \
        .reshape(V, n_w, W).transpose(0, 1)               # (n_w, V, W)
    valid_w = (torch.arange(n_w * W, device=dev) < T) \
        .reshape(n_w, 1, W).expand(n_w, V, W)

    def f32(x):
        return torch.as_tensor(np.float32(x), device=dev)

    _, ys = _fused_run_multi(
        init_state_multi(tables), quals_w, arrs_w, valid_w, wts,
        stack_tables(tables), tables[0].cost,
        f32(V * n_cores_each * tau),
        f32(cloud_budget_core_s / (CLOUD_PREMIUM * max(T, 1))),
        with_traces=sink is not None, telemetry=telemetry)
    res, tel = ys if telemetry else (ys, None)
    alerts = []
    if sink is not None:
        sink.ingest_fused_multi(res, quals, stream_base=sink_stream_base,
                                t0=sink_t0)
        alerts = _notify_standing(sink)
        # padded segments are exact no-ops, so summing over (n_w, W) is
        # the per-stream quality total
        sums = res["qual"].cpu().numpy().sum(axis=(0, 2))
    else:
        sums = res.cpu().numpy().sum(axis=0)
    out = {"quality_pct": 100.0 * sums.sum() / max(qmax.sum(), 1e-9),
           "per_stream_pct": (100.0 * sums
                              / np.maximum(qmax, 1e-9)).tolist()}
    if alerts:
        out["alerts"] = alerts
    if telemetry:
        out["telemetry"] = Telemetry.from_device(tel)
    return out


def run_skyscraper_multi_windowed(fitteds, streams, *, n_cores_each: int,
                                  cloud_budget_core_s: float = 0.0,
                                  buffer_gb: float = 4.0,
                                  plan_days: float = 0.25, seed: int = 0,
                                  device=None):
    """The windowed host loop the fused multi-stream run replaced: the
    forecast (each stream's true category mix, on the host) and the
    joint LP between windows, one batched window loop per window. Kept
    as the baseline the fused run is held to."""
    dev = resolve(device)
    fitteds = [f if f.device == dev else f.to(dev) for f in fitteds]
    tau = fitteds[0].workload.segment_seconds
    W = max(1, int(plan_days * 86400 / tau))
    V, T, K, Cs, C_max, tables, quals, arrs, qmax = _multi_prep(
        fitteds, streams, buffer_gb=buffer_gb,
        cloud_budget_core_s=cloud_budget_core_s, seed=seed, dev=dev)
    tab_stack = stack_tables(tables)
    state = init_state_multi(tables)
    quals_h = quals.cpu().numpy()
    sums = np.zeros(V)
    t = 0
    while t < T:
        W_t = min(W, T - t)
        # joint plan: per-stream oracle r over the window (App. D Eq. 7-9)
        rs, qs = [], []
        for v in range(V):
            q_true = quals_h[v, t:t + W_t]
            d = ((q_true[:, None, :] - fitteds[v].centers[None]) ** 2).sum(-1)
            rs.append(np.bincount(d.argmin(1), minlength=Cs[v]) / W_t)
            qs.append(fitteds[v].centers)
        budget = V * n_cores_each * tau + (cloud_budget_core_s
                                           / (CLOUD_PREMIUM * T))
        alphas = solve_multi_stream(
            [torch.as_tensor(q, device=dev) for q in qs],
            torch.as_tensor(fitteds[0].cost, device=dev), rs,
            np.float32(budget))
        a_stack = torch.zeros((V, C_max, K), dtype=torch.float32, device=dev)
        for v, a in enumerate(alphas):
            a_stack[v, :Cs[v]] = a
        # pad the tail window to W (masked steps are exact no-ops)
        q_w, a_w, valid = pad_window_multi(quals[:, t:t + W_t],
                                           arrs[:, t:t + W_t], W)
        state, outs = run_window_multi(state, q_w, a_w, a_stack, tab_stack,
                                       valid=valid)
        sums += outs["qual"].cpu().numpy().sum(axis=1)
        t += W_t
    return {"quality_pct": 100.0 * sums.sum() / max(qmax.sum(), 1e-9),
            "per_stream_pct": (100.0 * sums
                               / np.maximum(qmax, 1e-9)).tolist()}


# ---------------------------------------------------------------------------
# the paper's baselines (host numpy, as the reference) and the optimum
# ---------------------------------------------------------------------------

def _run_fixed_policy(fitted: Fitted, stream: Stream, pick_k, *,
                      n_cores: int, buffer_gb: float = 4.0,
                      cloud_budget_core_s: float = 0.0,
                      extra_backlog: Optional[np.ndarray] = None,
                      seed: int = 0) -> RunResult:
    """Shared numpy loop for Static / Chameleon* / VideoStorm baselines.
    pick_k(t, measured_qualities) -> config index, called before step
    t's ``extra_backlog[t]`` is read. Buffer-agnostic policies may
    overflow: overflowing segments are dropped (quality 0)."""
    tau = fitted.workload.segment_seconds
    cap_s = buffer_gb * 1e9 / 90e3
    quals = stream.quality(fitted.power, seed=seed)
    K = len(fitted.configs)
    b = 0.0
    cloud = 0.0
    on_sum = cl_sum = q_sum = 0.0
    peak = 0.0
    overflow = False
    k_hist = np.zeros(K, np.int64)
    for t in range(stream.n_segments):
        k = pick_k(t, quals[t])
        m = stream.arrival[t]
        # cheapest placement that fits buffer + cloud budget
        rts = fitted.place_rt[k] * m
        cls_ = fitted.place_cl[k] * m
        ons = fitted.place_on[k] * m
        feas = fitted.place_valid[k] & (rts <= tau + (cap_s - b)) \
            & (cloud + cls_ <= cloud_budget_core_s)
        if feas.any():
            p = np.where(feas, cls_, np.inf).argmin()
            rt, on_s, cl_s = rts[p], ons[p], cls_[p]
            q = quals[t, k]
        else:
            # buffer-agnostic baseline would overflow: drop the segment
            overflow = True
            rt, on_s, cl_s, q = 0.0, 0.0, 0.0, 0.0
        if extra_backlog is not None:
            b += extra_backlog[t] / n_cores
        b = max(0.0, b + rt - tau)
        peak = max(peak, b)
        cloud += cl_s
        on_sum += on_s
        cl_sum += cl_s
        q_sum += q
        k_hist[k] += 1
    qmax = _max_quality(stream, fitted.power)
    return RunResult(q_sum, float(qmax.sum()), on_sum, cl_sum, peak,
                     overflow, k_hist)


def run_static(fitted: Fitted, stream: Stream, k: int, **kw) -> RunResult:
    """Ablation baseline: run the whole stream pinned to config ``k``."""
    return _run_fixed_policy(fitted, stream, lambda t, q: k, **kw)


def best_static_config(fitted: Fitted, n_cores: int) -> int:
    """Most qualitative config that runs real-time all-on-prem (ablation 1a)."""
    tau = fitted.workload.segment_seconds
    ok = (fitted.cost / n_cores) <= tau
    if not ok.any():
        return int(np.argmin(fitted.cost))
    return int(np.argmax(np.where(ok, fitted.power, -1)))


def run_videostorm_like(fitted: Fitted, stream: Stream, *, n_cores: int,
                        **kw) -> RunResult:
    """Query-load adaptive (VideoStorm): most qualitative config whose
    cheapest placement currently fits — content-agnostic, greedy buffer."""
    order = np.argsort(-fitted.power)
    tau = fitted.workload.segment_seconds
    cap_s = kw.get("buffer_gb", 4.0) * 1e9 / 90e3
    state = {"b": 0.0}

    def pick(t, q):
        m = stream.arrival[t]
        for k in order:
            rts = fitted.place_rt[k] * m
            feas = fitted.place_valid[k] & (rts <= tau + (cap_s - state["b"]))
            if feas.any():
                state["b"] = max(0.0, state["b"]
                                 + rts[np.where(feas, fitted.place_cl[k],
                                                np.inf).argmin()] - tau)
                return int(k)
        return int(np.argmin(fitted.cost))

    return _run_fixed_policy(fitted, stream, pick, n_cores=n_cores, **kw)


def run_chameleon_star(fitted: Fitted, stream: Stream, *, n_cores: int,
                       epoch_segments: int = 50, profile_top: int = 6,
                       quality_floor: float = 0.9, seed: int = 0,
                       **kw) -> RunResult:
    """Chameleon* (§5.3): periodic profiling of the top configs (the
    profiling work is real and added to the backlog), then the cheapest
    config within ``quality_floor`` of the best profiled quality. Buffer
    added (vs. original Chameleon) but unmanaged. ``pick`` writes the
    profiling work into ``extra`` at step t before the loop reads
    ``extra[t]``."""
    quals = stream.quality(fitted.power, seed=seed)
    by_pow = np.argsort(-fitted.power)[:profile_top]
    current = {"k": int(np.argmin(fitted.cost))}
    extra = np.zeros(stream.n_segments)

    def pick(t, q):
        if t % epoch_segments == 0:
            prof = quals[t, by_pow]
            extra[min(t, len(extra) - 1)] = fitted.cost[by_pow].sum()
            ok = by_pow[prof >= quality_floor * prof.max()]
            current["k"] = int(ok[np.argmin(fitted.cost[ok])])
        return current["k"]

    return _run_fixed_policy(fitted, stream, pick, n_cores=n_cores,
                             extra_backlog=extra, seed=seed, **kw)


def run_optimum(fitted: Fitted, stream: Stream, *, n_cores: int,
                cloud_budget_core_s: float = 0.0, seed: int = 0,
                chunk: int = 40_000, device=None) -> RunResult:
    """Ground-truth knapsack (ablation 2c): per-segment config choice
    maximizing total quality under the total work budget — the LP bound,
    solved exactly with the Lagrangian planner on ``device`` (``None``
    means CUDA), one category per segment (T rows). ``chunk`` is the
    reference's, unused there too."""
    dev = resolve(device)
    tau = fitted.workload.segment_seconds
    T = stream.n_segments
    quals = stream.quality(fitted.power, seed=seed)      # (T,K)
    budget = n_cores * tau * T + cloud_budget_core_s / CLOUD_PREMIUM
    r = torch.full((T,), 1.0 / T, dtype=torch.float32, device=dev)
    alpha = solve_lp_lagrangian(
        torch.as_tensor(quals.astype(np.float32), device=dev),
        torch.as_tensor(fitted.cost, dtype=torch.float32, device=dev), r,
        np.float32(budget / T))
    k_sel = alpha.cpu().numpy().argmax(1)
    q_sum = float(quals[np.arange(T), k_sel].sum())
    work = float(fitted.cost[k_sel].sum())
    qmax = _max_quality(stream, fitted.power)
    return RunResult(q_sum, float(qmax.sum()), work, 0.0, 0.0, False,
                     np.bincount(k_sel, minlength=len(fitted.configs)))
