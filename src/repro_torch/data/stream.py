"""Synthetic V-ETL content streams with ground-truth quality oracle.

A numpy copy of ``repro/data/stream.py``: the same seed gives the same
stream, bit for bit, on both sides, so the port and the reference are
held against each other on identical inputs. Semi-Markov latent content
states with the paper's mean dwell times (§5.3), a diurnal difficulty
cycle for the traffic workloads, and the MOSEI HIGH/LONG arrival spikes
(§5.2). Each segment carries a scalar difficulty in [0,1].
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.configs.workloads import WorkloadCfg
from repro_torch.core.knobs import quality as qfn

DAY_SECONDS = 86_400.0


@dataclass
class Stream:
    workload: str
    segment_seconds: float
    latent: np.ndarray          # (T,) int
    difficulty: np.ndarray      # (T,) float [0,1]
    arrival: np.ndarray         # (T,) float work multiplier (stream count)
    state_difficulty: np.ndarray  # (n_latent,)

    @property
    def n_segments(self) -> int:
        return len(self.latent)

    def quality(self, power: np.ndarray, noise_sigma: float = 0.02,
                seed: int = 0) -> np.ndarray:
        """(T, K) ground-truth quality of each config on each segment."""
        rng = np.random.default_rng(seed)
        q = qfn(power[None, :], self.difficulty[:, None])
        q = q + rng.normal(0, noise_sigma, q.shape)
        return np.clip(q, 0.0, 1.0)


def generate(w: WorkloadCfg, days: float, seed: int = 0) -> Stream:
    rng = np.random.default_rng(seed)
    tau = w.segment_seconds
    T = int(days * DAY_SECONDS / tau)
    n = w.n_latent
    state_diff = np.linspace(0.08, 0.92, n)
    dwell = max(2, int(w.dwell_seconds / tau))

    # time-of-day difficulty weighting (traffic: hard during the day)
    t_sec = np.arange(T) * tau
    tod = (t_sec % DAY_SECONDS) / DAY_SECONDS
    if w.diurnal:
        # smooth day bump centred at 13:00 plus rush-hour shoulders
        day = np.exp(-0.5 * ((tod - 0.55) / 0.22) ** 2)
        rush = (np.exp(-0.5 * ((tod - 0.35) / 0.04) ** 2)
                + np.exp(-0.5 * ((tod - 0.73) / 0.04) ** 2))
        hardness = 0.15 + 0.6 * day + 0.5 * rush
    else:
        hardness = 0.5 + 0.25 * np.sin(2 * np.pi * t_sec / (DAY_SECONDS / 3))
    hardness = np.clip(hardness, 0.05, 1.1)

    latent = np.zeros(T, np.int64)
    cur = 0
    t = 0
    while t < T:
        run = 1 + rng.geometric(1.0 / dwell)
        latent[t:t + run] = cur
        t += run
        # next state: biased towards difficulty ~ hardness(t)
        target = hardness[min(t, T - 1)] * (n - 1)
        w_states = np.exp(-0.5 * ((np.arange(n) - target) / 0.9) ** 2)
        w_states /= w_states.sum()
        cur = rng.choice(n, p=w_states)

    difficulty = state_diff[latent] + rng.normal(0, 0.03, T)
    difficulty = np.clip(difficulty, 0.0, 1.0)

    arrival = np.ones(T)
    if w.spike == "high":
        # short, tall spikes: every ~6h, 5-minute bursts of 62/12 ~ 5x work
        period = int(6 * 3600 / tau)
        width = int(300 / tau)
        for s in range(period // 2, T, period):
            arrival[s:s + width] = 5.0
    elif w.spike == "long":
        # one sustained peak per day lasting ~6 h at 2.2x
        period = int(DAY_SECONDS / tau)
        width = int(6 * 3600 / tau)
        for s in range(period // 3, T, period):
            arrival[s:s + width] = 2.2
    elif not w.diurnal:
        arrival = 1.0 + 0.3 * np.sin(2 * np.pi * t_sec / DAY_SECONDS)

    return Stream(w.name, tau, latent, difficulty, arrival, state_diff)
