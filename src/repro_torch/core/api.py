"""User-facing Skyscraper API (paper App. F), single stream: the port of
``repro/core/api.py``'s ``Skyscraper``.

    sky = Skyscraper(fps=30, segment_seconds=2.0)
    sky.set_resources(num_cores=8, buffer_gb=4.0, cloud_budget_core_s=0)
    sky.register_knob("det_interval", [1, 5, 10])
    sky.fit(unlabeled_segments, proc_fn)
    status, out = sky.process(segment)        # online, content-adaptive

``proc_fn(segment, knobs) -> (output, quality)`` is the user's transform
(the V-ETL *T*). ``fit()`` profiles every knob configuration's
wall-clock runtime, Pareto-filters configurations, builds content
categories from measured quality vectors and trains the forecaster.
``process()`` is the online loop: classify -> look up plan -> switch ->
execute. The switcher's tables and state live on the handle's device;
the pool of many streams (``SkyscraperPool``) comes with the
multi-stream slice (ROADMAP, Queue 1).
"""
from __future__ import annotations

import itertools
import time
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from repro_torch.core.categories import kmeans
from repro_torch.core.forecaster import (forecast_from_labels,
                                         init_forecaster, make_dataset,
                                         train_forecaster)
from repro_torch.core.planner import solve_lp_lagrangian
from repro_torch.core.switcher import SwitchTables, init_state, switch_step
from repro_torch.device import resolve


class Skyscraper:
    """User-facing ETL handle: declare a workload (fps, knobs, cores,
    buffer, cloud budget), ``fit()`` offline tables, then ``process()``
    segments online. ``device=None`` means CUDA."""

    def __init__(self, fps: int = 30, segment_seconds: float = 2.0,
                 n_categories: int = 4, seed: int = 0, device=None):
        self.device = resolve(device)
        self.fps = fps
        self.tau = segment_seconds
        self.n_categories = n_categories
        self.seed = seed
        self.knobs: Dict[str, Sequence] = {}
        self.num_cores = 1
        self.buffer_gb = 4.0
        self.cloud_budget = 0.0
        self.budget_override = None
        self._fitted = False

    def set_resources(self, *, num_cores: int, buffer_gb: float = 4.0,
                      cloud_budget_core_s: float = 0.0):
        self.num_cores = num_cores
        self.buffer_gb = buffer_gb
        self.cloud_budget = cloud_budget_core_s
        self.budget_override = None

    def set_budget(self, core_s_per_segment: float):
        """Override the per-segment compute budget used by the planner
        (defaults to num_cores * segment_seconds)."""
        self.budget_override = core_s_per_segment
        if self._fitted:
            self._replan()

    def register_knob(self, name: str, domain: Sequence):
        self.knobs[name] = tuple(domain)

    def _f32(self, x) -> torch.Tensor:
        return torch.as_tensor(np.array(x, np.float32), device=self.device)

    # ------------------------------------------------------------------
    def fit(self, unlabeled: Sequence, proc_fn: Callable, *,
            profile_repeats: int = 1, plan_segments: int = 512,
            n_split: int = 4, max_k: int = 10):
        """unlabeled: list of segments (opaque to Skyscraper)."""
        configs = [dict(zip(self.knobs, v))
                   for v in itertools.product(*self.knobs.values())]
        # --- profile runtimes + quality vectors on the unlabeled data ---
        sample = unlabeled[:: max(1, len(unlabeled) // 40)]
        runtimes = np.zeros(len(configs))
        quals = np.zeros((len(unlabeled), len(configs)), np.float32)
        for ki, kv in enumerate(configs):
            t0 = time.perf_counter()
            for _ in range(profile_repeats):
                for seg in sample:
                    proc_fn(seg, kv)
            runtimes[ki] = ((time.perf_counter() - t0)
                            / (profile_repeats * len(sample)))
            for si, seg in enumerate(unlabeled):
                _, q = proc_fn(seg, kv)
                quals[si, ki] = q
        # --- Pareto-filter configurations -------------------------------
        mq = quals.mean(axis=0)
        keep = []
        best_q = -1.0
        for i in np.argsort(runtimes):
            if mq[i] > best_q + 1e-6:
                keep.append(i)
                best_q = mq[i]
        keep = keep[:max_k]
        quals = quals[:, keep]
        # --- categories + forecaster ------------------------------------
        centers, labels = kmeans(quals, min(self.n_categories,
                                            len(unlabeled)),
                                 seed=self.seed, device=self.device)
        C = centers.shape[0]
        labels = labels.cpu().numpy()
        interval = max(1, len(labels) // (4 * n_split))
        horizon = max(1, min(plan_segments, len(labels) // 4))
        X, Y = make_dataset(labels, C, interval=interval, n_split=n_split,
                            horizon=horizon)
        params = init_forecaster(torch.Generator().manual_seed(self.seed),
                                 n_split, C, device=self.device)
        forecaster, metrics = train_forecaster(params, X, Y)
        self._install(configs=[configs[i] for i in keep],
                      cost=runtimes[keep] * self.num_cores, power=mq[keep],
                      centers=centers.cpu().numpy(), forecaster=forecaster,
                      n_split=n_split, interval=interval, proc_fn=proc_fn,
                      plan_segments=plan_segments)
        self.forecast_metrics = metrics
        return self

    def _install(self, *, configs: List[Dict], cost, power, centers,
                 forecaster, n_split: int, interval: int, proc_fn: Callable,
                 plan_segments: int):
        """Take a fitted state (the end of ``fit``): build the switcher
        tables (one all-on-prem placement per config) and the first
        plan. ``convert.fitted_skyscraper`` calls it with a reference
        fit's state."""
        self.configs = [dict(c) for c in configs]
        self.cost = np.asarray(cost, np.float64)        # core-s per segment
        self.centers = np.asarray(centers, np.float32)
        self.forecaster = forecaster
        self.n_split, self.interval = n_split, interval
        power = np.asarray(power, np.float32)
        K = len(self.configs)
        self.tables = SwitchTables(
            centers=self._f32(self.centers),
            power=self._f32(power),
            cost=self._f32(self.cost),
            place_rt=self._f32((self.cost / self.num_cores)[:, None]),
            place_on=self._f32(self.cost[:, None]),
            place_cl=self._f32(np.zeros((K, 1))),
            place_valid=torch.ones((K, 1), dtype=torch.bool,
                                   device=self.device),
            rank_pos=torch.as_tensor(np.argsort(np.argsort(-power)),
                                     device=self.device),
            tau=self._f32(self.tau),
            buffer_cap_s=self._f32(self.buffer_gb * 1e9 / 90e3),
            cloud_budget=self._f32(self.cloud_budget),
        )
        self.state = init_state(self.tables)
        self.proc_fn = proc_fn
        self._labels_hist: List[int] = []
        self._plan_every = plan_segments
        self._seen = 0
        self._replan()
        self._fitted = True

    def _replan(self):
        C = self.centers.shape[0]
        need = self.n_split * self.interval
        if len(self._labels_hist) >= need:
            lab = torch.as_tensor(self._labels_hist[-need:],
                                  dtype=torch.int32, device=self.device)
            r = forecast_from_labels(self.forecaster, lab, C,
                                     n_split=self.n_split,
                                     interval=self.interval)
        else:
            r = self._f32(np.full(C, 1.0 / C))
        budget = (self.budget_override if self.budget_override
                  else self.num_cores * self.tau)
        self.alpha = solve_lp_lagrangian(self.tables.centers,
                                         self.tables.cost, r,
                                         self._f32(budget))

    # ------------------------------------------------------------------
    def process(self, segment, arrival_mult: float = 1.0):
        """Run the V-ETL Transform on one segment with adaptive knobs."""
        if not self._fitted:
            raise RuntimeError("call fit() first")
        K = len(self.configs)
        self.state, out = switch_step(
            self.state, torch.zeros((K,), device=self.device),
            self._f32(arrival_mult), self.alpha, self.tables)
        k = int(out["k"])
        result, q = self.proc_fn(segment, self.configs[k])
        # report the measured quality back (drives the next classification)
        self.state["qual_prev"] = self._f32(q)
        self._labels_hist.append(int(out["c"]))
        self._seen += 1
        if self._seen % self._plan_every == 0:
            self._replan()
        return {"config": self.configs[k], "k": k, "category": int(out["c"]),
                "quality": float(q),
                "buffer_s": float(out["buffer_s"])}, result
