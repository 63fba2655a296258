"""The port's plain-numpy query oracle ``warehouse.execute_ref`` against
the reference's ``repro.warehouse.execute_ref``, bit for bit (values,
dtypes and masks), and against the port's ``execute`` on the CPU (the
engine path and the default path, K1's plain version):

- on ``test_torch_store_query.py``'s named ``PLANS`` over the store a
  fused run filled;
- on 50 seeded random plans (filters on int and float columns with
  integral, fractional and out-of-range thresholds, Project, each
  reducer and agg, a TopK after a reduction) over seeded random columns
  with repeated values and signed zeros (TopK's total-order tie-break).
"""
import numpy as np
import pytest
import torch

import repro.warehouse as RW
from _torch_parity import ref_plan
from _torch_threads import cap_torch_threads
from repro_torch import warehouse as PW
from repro_torch.warehouse import (Filter, GroupBy, MultiGroupBy, Project,
                                   TopK, WindowAgg, execute, execute_ref)
from test_torch_store_query import PLANS, _plans, _stores

cap_torch_threads()

INT_COLS = ("stream_id", "t", "category", "k")
FLOAT_COLS = ("quality", "on_core_s", "cloud_core_s", "buffer_s")
OPS = ("eq", "ne", "lt", "le", "gt", "ge")


def test_exported():
    assert "execute_ref" in PW.__all__ and PW.execute_ref is execute_ref


def _same(got, want):
    gt, gm = got
    wt, wm = want
    assert gm.dtype == np.asarray(wm).dtype
    np.testing.assert_array_equal(gm, np.asarray(wm))
    assert set(gt) == set(wt)
    for k in wt:
        w = np.asarray(wt[k])
        assert gt[k].dtype == w.dtype, k
        np.testing.assert_array_equal(gt[k], w, err_msg=k)


def _same_as_execute(cols, n, plan, want):
    """The port's ``execute`` over torch columns equals ``want``, by the
    engine path and by the default one (K1's plain version where the
    plan has a fused spec)."""
    tcols = {k: torch.as_tensor(v) for k, v in cols.items()}
    for uk in (False, None):
        table, mask = execute((tcols, n), plan, use_kernel=uk)
        _same(({k: v.numpy() for k, v in table.items()}, mask.numpy()),
              want)


@pytest.mark.parametrize("name", PLANS)
def test_named_plans(name):
    ref, got, _ = _stores()
    plan = _plans(got)[name]
    cols = {k: np.asarray(v) for k, v in ref.columns.items()}
    want = RW.execute_ref(cols, ref.n_rows, ref_plan(plan))
    mine = execute_ref(cols, ref.n_rows, plan)
    _same(mine, want)
    table, mask = execute(got, plan, use_kernel=False)
    _same(({k: v.numpy() for k, v in table.items()}, mask.numpy()), want)


def _columns(rng, cap, D=3):
    cols = {
        "stream_id": rng.integers(0, 6, cap).astype(np.int32),
        "t": rng.integers(0, 120, cap).astype(np.int32),
        "category": rng.integers(0, 4, cap).astype(np.int32),
        "k": rng.integers(0, 5, cap).astype(np.int32),
    }
    for name in FLOAT_COLS:
        # few distinct values (ties), signed zeros, negatives
        x = rng.choice(np.float32([-0.0, 0.0, 0.25, 0.5, -1.5, 2.0, 7.75]),
                       cap)
        x = np.where(rng.random(cap) < 0.5,
                     rng.standard_normal(cap).astype(np.float32), x)
        cols[name] = x.astype(np.float32)
    cols["out"] = rng.standard_normal((cap, D)).astype(np.float32)
    return cols


def _filter(rng):
    if rng.random() < 0.5:
        col = str(rng.choice(INT_COLS))
        v = float(rng.choice([0, 1, 2, 3.5, -1, 60, 2.0 ** 31, -1e12]))
    else:
        col = str(rng.choice(FLOAT_COLS))
        v = float(rng.choice([0.0, -0.0, 0.25, 0.5, -1.0, 3.0]))
    return Filter(col, str(rng.choice(OPS)), v)


def _reducer(rng):
    kind = int(rng.integers(0, 5))
    agg = str(rng.choice(("sum", "mean", "count", "max", "min")))
    if kind == 0:
        key = str(rng.choice(INT_COLS))
        num = int(rng.integers(1, 8))
        value = "out" if agg in ("sum", "mean") and rng.random() < 0.3 \
            else str(rng.choice(FLOAT_COLS))
        return GroupBy(key, value, agg=agg, num_groups=num)
    if kind == 1:
        return WindowAgg(window=int(rng.integers(1, 40)),
                         value=str(rng.choice(FLOAT_COLS)), agg=agg,
                         num_windows=int(rng.integers(1, 9)))
    if kind == 2:
        keys = tuple(str(c) for c in rng.choice(INT_COLS, 2, replace=False))
        nums = tuple(int(x) for x in rng.integers(1, 5, 2))
        wins = tuple(int(x) for x in rng.choice([0, 1, 7], 2))
        return MultiGroupBy(keys=keys, value=str(rng.choice(FLOAT_COLS)),
                            agg=agg, nums=nums,
                            windows=wins if rng.random() < 0.5 else ())
    if kind == 3:
        return TopK(int(rng.integers(1, 12)),
                    by=str(rng.choice(FLOAT_COLS + INT_COLS)),
                    largest=bool(rng.random() < 0.5))
    return None


def _random_plan(rng):
    plan = [_filter(rng) for _ in range(int(rng.integers(0, 3)))]
    red = _reducer(rng)
    if red is None:
        if rng.random() < 0.5:
            plan.append(Project(("t", "k", "quality")))
        return tuple(plan)
    plan.append(red)
    if not isinstance(red, TopK) and rng.random() < 0.5:
        by = red.value if red.value != "out" else "count"
        plan.append(TopK(int(rng.integers(1, 6)), by=by,
                         largest=bool(rng.random() < 0.5)))
    return tuple(plan)


@pytest.mark.parametrize("seed", range(50))
def test_random_plans(seed):
    rng = np.random.default_rng(1000 + seed)
    cap = int(rng.integers(1, 200))
    n = int(rng.integers(0, cap + 1))
    cols = _columns(rng, cap)
    plan = _random_plan(rng)
    want = RW.execute_ref(cols, n, ref_plan(plan))
    mine = execute_ref(cols, n, plan)
    _same(mine, want)
    _same_as_execute(cols, n, plan, want)
