"""Task records for placement (paper App. A.2): a copy of ``Task`` and
``tasks_from_dag`` from ``repro/core/placement.py``, the part of it that
``offline.fit`` needs."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple


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
