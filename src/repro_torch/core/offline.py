"""Offline preparation phase (paper §3, App. A/E/H).

Port of ``repro/core/offline.py``. ``fit()`` = profile + Pareto-filter
knob configs (greedy hill climbing over max-min-sampled segments, App.
A.1), enumerate + Pareto-filter task placements (App. A.2/M), build
content categories (KMeans on quality vectors, §3.2), train the
forecasting model (§3.3), and validate the throughput guarantee. The
config, placement and labelling steps are the reference's numpy code;
KMeans and the forecaster run in torch on ``device``.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field, replace
from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs.workloads import WorkloadCfg
from repro_torch.core import knobs as KB
from repro_torch.core.categories import kmeans
from repro_torch.core.forecaster import (init_forecaster, make_dataset,
                                         train_forecaster)
from repro_torch.core.placement import tasks_from_dag
from repro_torch.core.switcher import SwitchTables
from repro_torch.data.stream import generate
from repro_torch.device import resolve

P_MAX = 8          # placement slots per config
UPLINK_MBS = 12.5  # 100 Mbit/s
RTT_S = 0.25


@dataclass
class Fitted:
    """Everything the offline phase produces: per-config power/cost and
    placement tables and the quality centers (host numpy, as in the
    reference), the forecaster params (tensors on ``device``), and the
    selected config subset."""
    workload: WorkloadCfg
    configs: List[Dict]
    power: np.ndarray
    cost: np.ndarray
    place_rt: np.ndarray
    place_on: np.ndarray
    place_cl: np.ndarray
    place_valid: np.ndarray
    centers: np.ndarray
    forecaster: Dict
    n_split: int
    interval_segments: int
    horizon_segments: int
    n_cores: int
    device: torch.device = torch.device("cpu")
    timings: Dict[str, float] = field(default_factory=dict)
    forecast_metrics: Dict[str, float] = field(default_factory=dict)

    def to(self, device) -> "Fitted":
        """The same fit with its forecaster params on ``device``."""
        dev = resolve(device)
        params = {n: {p: t.to(dev) for p, t in layer.items()}
                  for n, layer in self.forecaster.items()}
        return replace(self, forecaster=params, device=dev)

    def tables(self, *, buffer_gb: float = 4.0, bitrate_Bps: float = 90e3,
               cloud_budget: float = 0.0) -> SwitchTables:
        """The switcher's tables as float32 tensors on ``self.device``."""
        tau = self.workload.segment_seconds
        rank = np.argsort(np.argsort(-self.power))       # 0 = most powerful

        def t(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x), device=self.device,
                                   dtype=dtype)

        return SwitchTables(
            centers=t(self.centers), power=t(self.power), cost=t(self.cost),
            place_rt=t(self.place_rt), place_on=t(self.place_on),
            place_cl=t(self.place_cl),
            place_valid=t(self.place_valid, torch.bool),
            rank_pos=t(rank, torch.int64),
            tau=t(tau), buffer_cap_s=t(buffer_gb * 1e9 / bitrate_Bps),
            cloud_budget=t(cloud_budget))


def _segment_placements(w: WorkloadCfg, kv: Dict, n_cores: int):
    """Throughput-mode placement costs per segment: for each subset of
    tasks offloaded, runtime = max(on_core_s/cores, uplink serialization)
    + RTT if any cloud task. Pareto on (runtime, cloud core-s)."""
    tasks = tasks_from_dag(w.dag)
    mult = KB.task_multipliers(w, kv)
    fps = 30.0
    frames = fps * w.segment_seconds
    per = []
    for t in tasks:
        m = mult.get(t.name, 1.0)
        per.append((t.onprem_ms * m * frames / 1e3,
                    t.cloud_ms * m * frames / 1e3,
                    t.mb_in * m * frames))
    n = len(tasks)
    cands = []
    for mask in itertools.product([0, 1], repeat=n):
        on_s = sum(p[0] for p, b in zip(per, mask) if not b)
        cl_s = sum(p[1] for p, b in zip(per, mask) if b)
        up_mb = sum(p[2] for p, b in zip(per, mask) if b)
        r = max(on_s / n_cores, up_mb / UPLINK_MBS) \
            + (RTT_S if any(mask) else 0.0)
        cands.append((r, cl_s, on_s))
    # pareto: sort by runtime, keep strictly-decreasing cloud cost
    cands.sort()
    pareto = []
    best_cl = float("inf")
    for r, c, o in cands:
        if c < best_cl - 1e-9:
            pareto.append((r, c, o))
            best_cl = c
    if len(pareto) > P_MAX:
        # even subsample but ALWAYS keep both endpoints — the last point
        # is the zero-cloud placement the throughput guarantee relies on
        idx = np.unique(np.linspace(0, len(pareto) - 1, P_MAX).astype(int))
        pareto = [pareto[i] for i in idx]
    rt = np.full(P_MAX, np.inf)
    on = np.zeros(P_MAX)
    cl = np.zeros(P_MAX)
    valid = np.zeros(P_MAX, bool)
    for i, (r, c, o) in enumerate(pareto):
        rt[i], cl[i], on[i], valid[i] = r, c, o, True
    return rt, on, cl, valid


def _hill_climb_pareto(w: WorkloadCfg, all_configs: List[Dict],
                       difficulties: np.ndarray, max_k: int = 12):
    """Greedy hill climbing (VideoStorm-style, App. A.1) per sampled
    segment; union of visited configs approximates the Pareto set."""
    powers = np.array([KB.config_power(w, kv) for kv in all_configs])
    costs = np.array([KB.config_work(w, kv) for kv in all_configs])
    names = list(w.knobs)
    idx_of = {tuple(kv[n] for n in names): i
              for i, kv in enumerate(all_configs)}

    def neighbors(kv):
        out = []
        for n in names:
            dom = list(w.knobs[n])
            i = dom.index(kv[n])
            for j in (i - 1, i + 1):
                if 0 <= j < len(dom):
                    kv2 = dict(kv)
                    kv2[n] = dom[j]
                    out.append(idx_of[tuple(kv2[x] for x in names)])
        return out

    selected = set()
    for d in difficulties:
        qual = 1.0 - d * (1.0 - powers)
        cur = int(np.argmin(costs))
        selected.add(cur)
        for _ in range(64):
            best, best_gain = None, 0.0
            for nb in neighbors(all_configs[cur]):
                dq = qual[nb] - qual[cur]
                dc = costs[nb] - costs[cur]
                if dq > 1e-9:
                    gain = dq / max(dc, 1e-6)
                    if gain > best_gain:
                        best, best_gain = nb, gain
            if best is None:
                break
            cur = best
            selected.add(cur)
    # thin to max_k keeping the cost-quality Pareto spread
    sel = sorted(selected, key=lambda i: costs[i])
    if len(sel) > max_k:
        keep = np.linspace(0, len(sel) - 1, max_k).astype(int)
        sel = [sel[i] for i in keep]
    return sel


def fit(w: WorkloadCfg, *, n_cores: int, days_unlabeled: float = 14.0,
        n_categories: int = 4, seed: int = 0, sample_frac: float = 0.05,
        n_search: int = 5, plan_days: float = 2.0, input_days: float = 2.0,
        n_split: int = 8, max_k: int = 12, device=None) -> Fitted:
    """Offline ETL fit (Sec. 4.1): profile configs on sampled segments,
    solve placements, cluster content categories, train the forecaster,
    and prune to ``max_k`` configs; returns the ``Fitted`` bundle.
    ``device=None`` means CUDA (see ``repro_torch.device.resolve``).
    The forecaster's init draws from a ``torch.Generator`` seeded with
    ``seed``, not from ``jax.random``, so its weights differ from the
    reference's; every numpy step is the reference's own."""
    dev = resolve(device)
    t_all = {}
    rng = np.random.default_rng(seed)
    tau = w.segment_seconds

    # --- filter knob configurations (App. A.1) ---------------------------
    t0 = time.time()
    all_configs = KB.enumerate_configs(w)
    pre = generate(w, days=1.0, seed=seed + 7)
    n_pre = min(200, pre.n_segments)
    pre_d = pre.difficulty[rng.choice(pre.n_segments, n_pre, replace=False)]
    # greedy max-min sampling in (k-, k+) quality space == difficulty space
    chosen = [float(pre_d[np.argmin(np.abs(pre_d - pre_d.mean()))])]
    for _ in range(n_search - 1):
        dmin = np.min(np.abs(pre_d[:, None] - np.array(chosen)[None]), axis=1)
        chosen.append(float(pre_d[np.argmax(dmin)]))
    sel = _hill_climb_pareto(w, all_configs, np.array(chosen), max_k)
    configs = [all_configs[i] for i in sel]
    power = np.array([KB.config_power(w, kv) for kv in configs], np.float32)
    cost = np.array([KB.config_work(w, kv) for kv in configs], np.float32)
    t_all["filter_configs"] = time.time() - t0

    # --- filter task placements (App. A.2 / M) ---------------------------
    t0 = time.time()
    K = len(configs)
    rt = np.zeros((K, P_MAX))
    on = np.zeros((K, P_MAX))
    cl = np.zeros((K, P_MAX))
    valid = np.zeros((K, P_MAX), bool)
    for i, kv in enumerate(configs):
        rt[i], on[i], cl[i], valid[i] = _segment_placements(w, kv, n_cores)
    t_all["filter_placements"] = time.time() - t0

    # --- throughput guarantee: cheapest config real-time on-prem ---------
    k_cheap = int(np.argmin(cost))
    rt_cheap = cost[k_cheap] / n_cores
    if rt_cheap > tau * 1.001:
        raise ValueError(
            f"provisioning too small: cheapest config needs "
            f"{rt_cheap:.2f}s > segment {tau}s on {n_cores} cores")

    # --- content categories (§3.2) ---------------------------------------
    t0 = time.time()
    unl = generate(w, days=days_unlabeled, seed=seed + 1)
    qual_all = unl.quality(power, seed=seed + 2)          # (T, K)
    n_samp = max(n_categories * 20, int(unl.n_segments * sample_frac))
    samp = rng.choice(unl.n_segments, min(n_samp, unl.n_segments),
                      replace=False)
    centers, _ = kmeans(qual_all[samp], n_categories, seed=seed, device=dev)
    centers = centers.cpu().numpy()
    t_all["categories"] = time.time() - t0

    # --- forecaster (§3.3, App. H) ----------------------------------------
    t0 = time.time()
    # label the unlabeled stream with the cheapest config only (App. H)
    col = centers[:, k_cheap]
    labels = np.argmin(np.abs(qual_all[:, k_cheap][:, None] - col[None]),
                       axis=1)
    interval = max(1, int(input_days * 86400 / n_split / tau))
    horizon = max(1, int(plan_days * 86400 / tau))
    # clamp to the available unlabeled data (short fits in tests)
    T_unl = len(labels)
    horizon = min(horizon, max(1, T_unl // 4))
    interval = min(interval, max(1, (T_unl - horizon) // (2 * n_split)))
    X, Y = make_dataset(labels, n_categories, interval=interval,
                        n_split=n_split, horizon=horizon)
    t_all["forecast_data"] = time.time() - t0
    t0 = time.time()
    params = init_forecaster(torch.Generator().manual_seed(seed), n_split,
                             n_categories, device=dev)
    params, fmetrics = train_forecaster(params, X, Y)
    t_all["forecast_train"] = time.time() - t0

    return Fitted(workload=w, configs=configs, power=power, cost=cost,
                  place_rt=rt, place_on=on, place_cl=cl, place_valid=valid,
                  centers=centers, forecaster=params, n_split=n_split,
                  interval_segments=interval, horizon_segments=horizon,
                  n_cores=n_cores, device=dev, timings=t_all,
                  forecast_metrics=fmetrics)
