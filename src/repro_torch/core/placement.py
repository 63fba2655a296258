"""Task-placement machinery (paper App. A.2 + M.1): the port's copy of
``repro/core/placement.py``, host numpy as in the reference.

- ``simulate``: the App. M list-scheduling simulator: on-prem tasks on
  the earliest-free core, cloud tasks serialized through uplink/downlink
  bandwidth with RTT folded into the cloud runtime.
- ``enumerate_placements``: exhaustive 2^T enumeration for small DAGs
  (every DAG of the paper has at most 12 tasks); past
  ``max_exhaustive`` tasks, the all-on-prem placement and each task
  alone in the cloud. Pareto-filtered on (runtime, cloud cost).
  ``offline._segment_placements`` (throughput mode) keeps its own copy
  of the Pareto step.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class Task:
    """One DAG node for placement: per-segment on-prem/cloud runtimes
    and transfer sizes, with deps as indices into the task list."""
    name: str
    deps: Tuple[int, ...]
    onprem_ms: float
    cloud_ms: float
    mb_in: float
    mb_out: float


def tasks_from_dag(dag) -> List[Task]:
    """Build ``Task`` records from the workload DAG tuples, resolving
    dependency names to indices."""
    names = [t[0] for t in dag]
    out = []
    for name, deps, on_ms, cl_ms, mi, mo in dag:
        out.append(Task(name, tuple(names.index(d) for d in deps),
                        on_ms, cl_ms, mi, mo))
    return out


def simulate(tasks: Sequence[Task], placement: Sequence[bool], n_cores: int,
             uplink_mbs: float = 12.5, downlink_mbs: float = 25.0,
             mult: Dict[str, float] = None) -> Tuple[float, float, float]:
    """placement[i]=True -> cloud. Returns (runtime_s, onprem_core_s,
    cloud_core_s). ``mult`` scales per-task durations (knob effects)."""
    mult = mult or {}
    n = len(tasks)
    finish = np.zeros(n)
    cores = np.zeros(n_cores)          # free-at times
    up_free = 0.0
    down_free = 0.0
    onprem_s = 0.0
    cloud_s = 0.0
    for i, t in enumerate(tasks):
        m = mult.get(t.name, 1.0)
        ready = max((finish[d] for d in t.deps), default=0.0)
        if placement[i]:
            dur = t.cloud_ms * m / 1e3
            up = t.mb_in * m / uplink_mbs
            start_up = max(ready, up_free)
            up_free = start_up + up
            done_cloud = up_free + dur
            down = t.mb_out * m / downlink_mbs
            start_down = max(done_cloud, down_free)
            down_free = start_down + down
            finish[i] = down_free
            cloud_s += dur
        else:
            dur = t.onprem_ms * m / 1e3
            ci = int(np.argmin(cores))
            start = max(ready, cores[ci])
            cores[ci] = start + dur
            finish[i] = cores[ci]
            onprem_s += dur
    return float(finish.max(initial=0.0)), onprem_s, cloud_s


def pareto_filter(points: List[Tuple[float, float, int]]) -> List[int]:
    """points (runtime, cloud_cost, idx) -> indices on the Pareto frontier."""
    best = []
    min_cost = float("inf")
    for rt, cc, idx in sorted(points):
        if cc < min_cost - 1e-12:
            best.append(idx)
            min_cost = cc
    return best


def enumerate_placements(tasks: Sequence[Task], n_cores: int,
                         mult: Dict[str, float] = None,
                         max_exhaustive: int = 14):
    """Returns list of (placement_mask, runtime_s, onprem_s, cloud_s) on
    the (runtime, cloud) Pareto frontier, sorted by cloud cost asc."""
    n = len(tasks)
    if n <= max_exhaustive:
        masks = list(itertools.product([False, True], repeat=n))
    else:                               # greedy fallback for big DAGs
        masks = [tuple(False for _ in range(n))]
        for i in range(n):              # each task alone in the cloud
            cur = [False] * n
            cur[i] = True
            masks.append(tuple(cur))
    sims = []
    for mask in masks:
        rt, on_s, cl_s = simulate(tasks, mask, n_cores, mult=mult)
        sims.append((mask, rt, on_s, cl_s))
    keep = pareto_filter([(rt, cl, i) for i, (_, rt, _, cl) in enumerate(sims)])
    out = [sims[i] for i in keep]
    out.sort(key=lambda x: x[3])        # by cloud cost
    return out
