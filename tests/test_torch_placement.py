"""The port's task placement (``repro_torch.core.placement``: the App. M
simulator, the Pareto filter and the placement enumeration, host numpy)
against the reference's on the cases of ``tests/test_placement_edge.py``
and ``tests/test_placement_stream.py``: every workload DAG at several
core counts and knob multipliers, all-on-prem and all-cloud, chains past
the exhaustive limit (the greedy fallback), empty task lists, tied and
identical Pareto points, and random point sets. Each result equals the
reference's exactly (the same numpy arithmetic in the same order)."""
import itertools

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.configs.workloads import WORKLOADS as R_WORKLOADS
from repro.core import placement as RP
from repro_torch.configs.workloads import WORKLOADS
from repro_torch.core import placement as PP
from _torch_threads import cap_torch_threads

cap_torch_threads()


def _both(dag):
    return RP.tasks_from_dag(dag), PP.tasks_from_dag(dag)


def _chain(mod, n):
    """The n-task chain of ``test_placement_edge.py``."""
    return [mod.Task(f"t{i}", (i - 1,) if i else (), 10.0 + 3.0 * (i % 5),
                     4.0 + 2.0 * (i % 3), 0.5 + 0.1 * i, 0.2)
            for i in range(n)]


@pytest.mark.parametrize("wname", sorted(WORKLOADS))
def test_tasks_and_simulate_equal(wname):
    rt, pt = _both(R_WORKLOADS[wname].dag)
    assert [t.__dict__ for t in pt] == [t.__dict__ for t in rt]
    n = len(pt)
    mult = {pt[0].name: 1.7, pt[-1].name: 0.4}
    masks = list(itertools.product([False, True], repeat=n))[:64]
    for cores in (1, 2, 4, 16):
        for mask in masks + [(True,) * n]:
            for m in (None, mult):
                assert PP.simulate(pt, mask, cores, mult=m) == \
                    RP.simulate(rt, mask, cores, mult=m)
    got = PP.simulate(pt, [False] * n, 2, uplink_mbs=3.0, downlink_mbs=7.0)
    assert got == RP.simulate(rt, [False] * n, 2, uplink_mbs=3.0,
                              downlink_mbs=7.0)
    on, cl = PP.simulate(pt, [False] * n, 2), PP.simulate(pt, [True] * n, 2)
    assert on[2] == 0.0 and cl[2] > 0.0 and on[1] > 0


@pytest.mark.parametrize("wname", sorted(WORKLOADS))
@pytest.mark.parametrize("cores", [2, 4, 8])
def test_enumerate_placements_equal(wname, cores):
    rt, pt = _both(R_WORKLOADS[wname].dag)
    mult = {pt[0].name: 2.0}
    for m in (None, mult):
        got = PP.enumerate_placements(pt, cores, mult=m)
        assert got == RP.enumerate_placements(rt, cores, mult=m)
        cls = [o[3] for o in got]
        assert cls == sorted(cls) and cls[0] == 0.0


@pytest.mark.parametrize("n", [0, 1, 6, 15, 16])
def test_enumerate_placements_chains_equal(n):
    """Chains below and past the exhaustive limit of 14 (the fallback:
    all on-prem and each task alone in the cloud), and no tasks."""
    got = PP.enumerate_placements(_chain(PP, n), n_cores=4)
    assert got == RP.enumerate_placements(_chain(RP, n), n_cores=4)
    assert got[0][3] == 0.0
    if n == 0:
        assert got == [((), 0.0, 0.0, 0.0)]
    assert PP.enumerate_placements(_chain(PP, n), 4, max_exhaustive=3) == \
        RP.enumerate_placements(_chain(RP, n), 4, max_exhaustive=3)


def test_simulate_empty_task_list():
    assert PP.simulate([], [], n_cores=2) == RP.simulate([], [], n_cores=2) \
        == (0.0, 0.0, 0.0)


@pytest.mark.parametrize("pts", [
    [(1.0, 2.0, 0), (1.0, 2.0, 1), (2.0, 1.0, 2), (2.0, 1.0, 3),
     (3.0, 1.0, 4)],
    [(5.0, 5.0, i) for i in range(4)],
    [],
    [(1.0, 1.0, 0)],
])
def test_pareto_filter_cases_equal(pts):
    assert PP.pareto_filter(pts) == RP.pareto_filter(pts)


@settings(max_examples=30, deadline=None)
@given(st.lists(st.tuples(st.floats(0.1, 10), st.floats(0.1, 10)),
                min_size=1, max_size=30))
def test_pareto_filter_random_equal(pts):
    points = [(rt, cc, i) for i, (rt, cc) in enumerate(pts)]
    keep = PP.pareto_filter(points)
    assert keep == RP.pareto_filter(points)
    for i in keep:
        for j in range(len(pts)):
            if j != i:
                assert not (pts[j][0] < pts[i][0] - 1e-12
                            and pts[j][1] < pts[i][1] - 1e-12)


def test_pareto_filter_seeded_sets_equal():
    rng = np.random.default_rng(0)
    for n in (2, 10, 100):
        pts = [(float(a), float(b), i) for i, (a, b) in
               enumerate(rng.uniform(0, 1, (n, 2)))]
        assert PP.pareto_filter(pts) == RP.pareto_filter(pts)
