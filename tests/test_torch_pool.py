"""The port's serving pool (``core.api.SkyscraperPool``) against the
reference's ``SkyscraperPool`` and the single-stream oracle, on the CPU.
Both pools start from one reference fit, carried across with
``convert.fitted_skyscraper``.

- A hypothesis schedule of admits (random priorities), retires and
  ticks (random arrival multipliers), with the plans pinned as in
  tests/test_pool_elastic.py:97: every status (k, category, buffer_s,
  dropped, shed) equals the reference pool's and the port's
  single-stream ``switch_step`` run alone on that stream, bit for bit;
  on tests/test_pool_elastic.py's fitted handle and on
  tests/test_obs_telemetry.py:229's, each fitted with its profiled
  runtimes pinned (one config survives the Pareto filter, and three).
- Priority shedding (:156), its standing alerts (:197), admission
  control (:218) and the joint plan's priority weights (:235), each
  also held against the reference pool's statuses, plans and alerts;
  the joint plan switched on mid-run (``pool.joint_plan``).
- The slot ladder: the capacity grows only when no slot is free, at a
  bucket boundary, and inside a bucket a tick, an admit, a retire and a
  replan leave every carried tensor where it was (``data_ptr``).
- ``HostTelemetry`` against the rows the pool's sink captured
  (tests/test_obs_telemetry.py:229) and against the reference's.
- The shed decision of ``_pool_tick_fn`` against the reference's on
  random slots, priorities (with ties) and capacities: equal keep and
  shed sets; the prefix sum matches XLA's order, so they are equal
  even where the capacity sits within rounding of a prefix sum.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.warehouse as RW
from _torch_parity import ref_fitted, ref_plan, table_arrays
from repro.core import api as RA
from repro.core import switcher as RS
from repro_torch.convert import (fitted_skyscraper, pool_state_from_arrays,
                                 switch_tables_from_arrays)
from repro_torch.core import api as PA
from repro_torch.core import switcher as PS
from repro_torch.obs import telemetry as PT
from repro_torch.warehouse import (Filter, GroupBy, SegmentStore,
                                   StandingQueries)
from _torch_threads import cap_torch_threads

cap_torch_threads()


def _quality_of(knobs):
    return min(0.5 + 0.1 * knobs["q"], 1.0)


def _proc_q(seg, knobs):
    return ("out", _quality_of(knobs))


def _proc_det(seg, kv):
    return seg, float(np.clip(1 - seg * (1 - 1.0 / kv["det"]), 0, 1))


_SKIES = {}


class _Clock:
    """A stand-in for the ``time`` module during the reference's fit:
    its clock advances only by each profiled call's pinned runtime, so
    the Pareto filter keeps the same configs on every machine."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now

    def timed(self, proc, runtime):
        def call(seg, knobs):
            self.now += runtime(knobs)
            return proc(seg, knobs)
        return call


def _skies(kind):
    """(reference Skyscraper, the port's on the CPU) on one fit, its
    profiled runtimes pinned: the elastic handle's best config is also
    its cheapest, so one config survives the Pareto filter; the det
    handle's cost falls as its quality falls, so all three do."""
    if kind not in _SKIES:
        if kind == "elastic":        # tests/test_pool_elastic.py:51
            rng = np.random.default_rng(0)
            args = dict(fps=2, segment_seconds=1.0, n_categories=2, seed=0)
            res = dict(num_cores=4, buffer_gb=1.0, cloud_budget_core_s=0.0)
            knob, proc = ("q", [1, 2, 3]), _proc_q
            segs = [rng.random((3,)) for _ in range(12)]
            plan = 512
            runtime = lambda kv: (4 - kv["q"]) * 1e-3       # noqa: E731
        else:                        # tests/test_obs_telemetry.py:229
            args = dict(segment_seconds=2.0, n_categories=3)
            res = dict(num_cores=4)
            knob, proc = ("det", [1, 5, 10]), _proc_det
            segs = list(np.linspace(0, 1, 40))
            plan = 16
            runtime = lambda kv: (11 - kv["det"]) * 1e-3    # noqa: E731
        r = RA.Skyscraper(**args)
        r.set_resources(**res)
        r.register_knob(*knob)
        clock = _Clock()
        with mock.patch.object(RA, "time", clock):
            r.fit(segs, clock.timed(proc, runtime), plan_segments=plan)
        assert len(r.configs) == (1 if kind == "elastic" else 3)
        p = PA.Skyscraper(**args, device="cpu")
        p.set_resources(**res)
        p.register_knob(*knob)
        arrays = dict(configs=r.configs, cost=np.asarray(r.cost),
                      power=np.asarray(r.tables.power),
                      centers=np.asarray(r.centers),
                      forecaster=jax.tree.map(np.asarray, r.forecaster),
                      n_split=r.n_split, interval=r.interval)
        fitted_skyscraper(p, arrays, proc, plan_segments=plan)
        _SKIES[kind] = (r, p)
    return _SKIES[kind]


def _same_status(a, b):
    assert a["stream_id"] == b["stream_id"]
    for key in ("k", "category", "dropped", "shed", "quality", "config"):
        assert a[key] == b[key], (key, a, b)
    np.testing.assert_array_equal(np.float32(a["buffer_s"]),
                                  np.float32(b["buffer_s"]))


# ---------------------------------------------------------------------------
# hypothesis: random admit / retire / tick schedules
# ---------------------------------------------------------------------------

@st.composite
def _schedules(draw):
    ops = []
    for _ in range(draw(st.integers(min_value=4, max_value=10))):
        kind = draw(st.sampled_from(["admit", "admit", "tick", "tick",
                                     "tick", "retire"]))
        if kind == "admit":
            ops.append(("admit", draw(st.floats(min_value=0.5,
                                                max_value=4.0))))
        elif kind == "retire":
            ops.append(("retire", draw(st.integers(0, 100))))
        else:
            ops.append(("tick", draw(st.integers(0, 10_000))))
    return ops


@pytest.mark.parametrize("kind", ("elastic", "det"))
@settings(max_examples=10, deadline=None)
@given(ops=_schedules())
def test_schedules_match_oracle_and_reference(kind, ops):
    rsky, psky = _skies(kind)
    saved = rsky._plan_every, psky._plan_every
    rsky._plan_every = psky._plan_every = 10_000   # plans pinned
    try:
        rpool = RA.SkyscraperPool(rsky, n_streams=1, slot_chunk=2)
        ppool = PA.SkyscraperPool(psky, n_streams=1, slot_chunk=2,
                                  device="cpu")
        ostate = {0: PS.init_state(psky.tables)}
        pending = {0: None}
        next_sid = 1
        for op in ops:
            if op[0] == "admit":
                for pool in (rpool, ppool):
                    pool.admit(next_sid, priority=op[1])
                ostate[next_sid] = PS.init_state(psky.tables)
                pending[next_sid] = None
                next_sid += 1
            elif op[0] == "retire":
                if ppool.V > 1:
                    sid = ppool.streams[op[1] % ppool.V]
                    rpool.retire(sid)
                    ppool.retire(sid)
                    del ostate[sid], pending[sid]
            else:
                rng = np.random.default_rng(op[1])
                mults = {s: 0.5 + rng.random() for s in ppool.streams}
                segs = {s: rng.random() for s in ppool.streams}
                r_st, _ = rpool.process(segs, arrival_mults=mults)
                p_st, _ = ppool.process(segs, arrival_mults=mults)
                assert ppool.cap == rpool.cap
                for a, b in zip(p_st, r_st):
                    _same_status(a, b)
                    sid = a["stream_id"]
                    stt = dict(ostate[sid])
                    if pending[sid] is not None:
                        stt["qual_prev"] = torch.tensor(
                            np.float32(pending[sid]))
                    stt, outs = PS.switch_step(
                        stt, torch.zeros(len(psky.configs)),
                        torch.tensor(np.float32(mults[sid])), psky.alpha,
                        psky.tables)
                    ostate[sid] = stt
                    assert a["k"] == int(outs["k"])
                    assert a["category"] == int(outs["c"])
                    assert np.float32(a["buffer_s"]) == \
                        outs["buffer_s"].numpy()
                    assert a["dropped"] == bool(outs["dropped"])
                    assert not a["shed"]
                    pending[sid] = None if a["dropped"] else a["quality"]
    finally:
        rsky._plan_every, psky._plan_every = saved


# ---------------------------------------------------------------------------
# shedding, alerts, admission, joint plans
# ---------------------------------------------------------------------------

def _both(kind, **kw):
    rsky, psky = _skies(kind)
    return (RA.SkyscraperPool(rsky, **kw),
            PA.SkyscraperPool(psky, device="cpu", **kw))


def test_shed_order_respects_priority():
    prios = [4.0, 3.0, 2.0, 1.0]
    rpool, ppool = _both("elastic", n_streams=4, priorities=prios,
                         telemetry=True)
    # one config: the streams' demands are equal, and room for two is
    # exactly two
    segs = [np.zeros(3)] * 4
    for a, b in zip(ppool.process(segs)[0], rpool.process(segs)[0]):
        _same_status(a, b)
    demand = float(ppool.telemetry().counters["onprem_core_s"][0])
    assert demand > 0
    rpool.capacity_core_s = ppool.capacity_core_s = demand * 2.5
    n_ticks = 6
    shed_count = np.zeros(4)
    for tick in range(n_ticks):
        statuses, results = ppool.process(segs)
        for a, b in zip(statuses, rpool.process(segs)[0]):
            _same_status(a, b)
        shed = [s["shed"] for s in statuses]
        for i in range(1, 4):
            assert not (shed[i - 1] and not shed[i]), (tick, shed)
        if tick == 0:
            assert shed == [False, False, True, True], shed
        for i, s in enumerate(shed):
            if s:
                assert results[i] is None
        shed_count += shed
    assert shed_count[0] == 0 and shed_count[3] == n_ticks
    stats = ppool.shed_stats()
    assert stats == rpool.shed_stats()
    for sid, prio in enumerate(prios):
        assert stats[sid]["priority"] == prio
        assert stats[sid]["segments"] == n_ticks + 1
    np.testing.assert_array_equal(
        ppool.telemetry().counters["seg_dropped"], shed_count)


def test_shed_surfaces_as_standing_alerts():
    rsky, psky = _skies("elastic")
    K = len(psky.configs)
    plan = [GroupBy("stream_id", "quality", agg="min", num_groups=8)]
    pred = Filter("quality", "le", 0.0)
    rsink = RW.SegmentStore(out_dim=K, chunk_rows=32)
    RW.StandingQueries(rsink).subscribe(
        list(ref_plan(plan)), ref_plan((pred,))[0], name="shed-watch")
    psink = SegmentStore(out_dim=K, chunk_rows=32, device="cpu")
    StandingQueries(psink).subscribe(plan, pred, name="shed-watch")
    kw = dict(n_streams=3, priorities=[3.0, 2.0, 1.0], telemetry=True)
    rpool = RA.SkyscraperPool(rsky, sink=rsink, **kw)
    ppool = PA.SkyscraperPool(psky, sink=psink, device="cpu", **kw)
    segs = [np.zeros(3)] * 3
    rpool.process(segs)
    ppool.process(segs)
    demand = float(ppool.telemetry().counters["onprem_core_s"][0])
    rpool.capacity_core_s = ppool.capacity_core_s = demand * 1.5
    for _ in range(3):
        rpool.process(segs)
        ppool.process(segs)
    assert len(ppool.alerts) == 1 and ppool.alerts[0].name == "shed-watch"
    fired = ppool.alerts[0].fired
    np.testing.assert_array_equal(fired, rpool.alerts[0].fired)
    assert not fired[0] and fired[2]     # equal demands: the shed test
    rr, pr = rsink.host_rows(), psink.host_rows()
    for k in rr:
        np.testing.assert_array_equal(pr[k], np.asarray(rr[k]), err_msg=k)


def test_admission_control_refuses_infeasible():
    rsky, psky = _skies("det")
    cost_min = float(np.min(np.asarray(psky.tables.cost)))
    pool = PA.SkyscraperPool(psky, n_streams=2, device="cpu",
                             capacity_core_s=cost_min * 3.5)
    pool.admit(77)
    with pytest.raises(PA.AdmissionError):
        pool.admit(79)
    assert 79 not in pool.streams
    pool.admit(79, force=True)
    assert 79 in pool.streams
    pool.retire(79)
    pool.retire(77)
    pool.admit(78)
    with pytest.raises(ValueError):
        pool.admit(78)
    with pytest.raises(ValueError, match="runs on"):
        PA.SkyscraperPool(psky, n_streams=1, device="meta")


def test_joint_plan_weights_priorities():
    rpool, ppool = _both("det", n_streams=3, priorities=[3.0, 2.0, 1.0],
                         joint_plan=True)
    rng = np.random.default_rng(5)
    for _ in range(2 * ppool.sky._plan_every):
        segs = list(rng.random(3))
        for a, b in zip(ppool.process(segs)[0], rpool.process(segs)[0]):
            _same_status(a, b)
    alpha = ppool._alpha.numpy()
    active = ppool._active.numpy()
    np.testing.assert_allclose(alpha[active].sum(-1), 1.0, atol=1e-5)
    assert np.isfinite(alpha).all()
    # the forecasts are float64 in the port (1e-6 of the reference's), so
    # the plans are held to the tolerance tests/test_torch_ingest.py holds
    np.testing.assert_allclose(alpha, np.asarray(rpool._alpha), atol=1e-5)



def test_joint_plan_switched_on_mid_run():
    """``pool.joint_plan = True`` between ticks: the replans from then
    on are the joint LP's, as on the reference pool switched the same
    way; every status still bit-exact."""
    rpool, ppool = _both("det", n_streams=3, priorities=[3.0, 2.0, 1.0])
    assert not ppool.joint_plan
    every = ppool.sky._plan_every
    rng = np.random.default_rng(6)
    for tick in range(3 * every):
        if tick == every:
            ppool.joint_plan = True
            rpool._joint_plan = True
        segs = list(rng.random(3))
        for a, b in zip(ppool.process(segs)[0], rpool.process(segs)[0]):
            _same_status(a, b)
    assert ppool.joint_plan
    np.testing.assert_allclose(ppool._alpha.numpy(), np.asarray(rpool._alpha),
                               atol=1e-5)

def test_independent_replans_match_reference():
    """The default replan: the vmapped per-stream LPs, first on the
    uniform prior (bit for bit) and then on the forecasts."""
    rpool, ppool = _both("det", n_streams=5)
    rng = np.random.default_rng(9)
    every = ppool.sky._plan_every
    for tick in range(3 * every):
        segs = list(rng.random(5))
        for a, b in zip(ppool.process(segs)[0], rpool.process(segs)[0]):
            _same_status(a, b)
        if tick == every - 1:        # the first replan: uniform prior
            np.testing.assert_array_equal(ppool._alpha.numpy(),
                                          np.asarray(rpool._alpha))
    np.testing.assert_allclose(ppool._alpha.numpy(),
                               np.asarray(rpool._alpha), atol=1e-5)


def test_pool_state_carried_across():
    """``convert.pool_state_from_arrays`` loads a reference pool's state
    mid-run; both then tick on identically."""
    rpool, ppool = _both("det", n_streams=3, telemetry=False)
    rng = np.random.default_rng(2)
    for _ in range(5):
        rpool.process(list(rng.random(3)))
    pool_state_from_arrays(ppool, {
        "tables": table_arrays(rpool.tables),
        "state": {k: np.asarray(v) for k, v in rpool.state.items()},
        "bufs": np.asarray(rpool._bufs), "alpha": np.asarray(rpool._alpha),
        "active": np.asarray(rpool._active),
        "priority": np.asarray(rpool._priority)})
    ppool._seen = rpool._seen
    ppool._pending_q = rpool._pending_q.copy()
    ppool._pending_valid = rpool._pending_valid.copy()
    for _ in range(20):
        segs = list(rng.random(3))
        for a, b in zip(ppool.process(segs)[0], rpool.process(segs)[0]):
            _same_status(a, b)


# ---------------------------------------------------------------------------
# the slot ladder: growth at bucket boundaries, no new buffers inside
# ---------------------------------------------------------------------------

def test_slot_growth_only_at_bucket_boundaries():
    _, psky = _skies("det")
    pool = PA.SkyscraperPool(psky, n_streams=2, telemetry=True,
                             device="cpu")
    rng = np.random.default_rng(1)
    sid = [1000]
    caps = []

    def ptrs():
        """Every tensor the pool carries from tick to tick."""
        out = {f"tables.{f}": getattr(pool.tables, f)
               for f in PS.SwitchTables.__dataclass_fields__}
        out.update({f"state.{k}": v for k, v in pool.state.items()})
        out.update(bufs=pool._bufs, alpha=pool._alpha, active=pool._active,
                   priority=pool._priority)
        return {k: v.data_ptr() for k, v in out.items()}

    for extra in (3, 7, 14):             # through caps 8, 16, 32
        for _ in range(extra):
            before, cap0, free0 = ptrs(), pool.cap, len(pool._free)
            sid[0] += 1
            pool.admit(sid[0], priority=float(sid[0] % 5))
            if free0:
                assert pool.cap == cap0 and ptrs() == before
            else:
                assert pool.cap == 2 * cap0          # the only growth
            # a tick, a retire and a replan inside the bucket
            before = ptrs()
            for _ in range(psky._plan_every + 1):
                pool.process({s: rng.random() for s in pool.streams})
            pool.retire(pool.streams[0])
            pool.admit(sid[0] + 10_000)
            sid[0] += 1
            assert ptrs() == before
        caps.append(pool.cap)
    assert caps == sorted(caps) and len(set(caps)) == 3 and caps[-1] >= 32
    assert pool.telemetry().extras["replans"] > 0


# ---------------------------------------------------------------------------
# the flight recorder and the shed decision
# ---------------------------------------------------------------------------

def test_host_telemetry_bit_exact_vs_sink_rows():
    rsky, psky = _skies("det")
    V, n_ticks = 3, 16
    K = len(psky.configs)
    store = SegmentStore(out_dim=K, chunk_rows=64, device="cpu")
    pool = PA.SkyscraperPool(psky, n_streams=V, sink=store, telemetry=True,
                             device="cpu")
    rpool = RA.SkyscraperPool(rsky, n_streams=V, telemetry=True)
    rng = np.random.default_rng(7)
    for _ in range(n_ticks):
        segs = list(rng.random(V))
        pool.process(segs)
        rpool.process(segs)
    tel = pool.telemetry()
    assert tel.extras == {"ticks": float(n_ticks), "replans": 1.0}
    assert tel.segments == V * n_ticks and tel.dropped == 0.0
    h = store.host_rows()
    order = np.lexsort((h["t"], h["stream_id"]))
    traces = {"k": h["k"][order].reshape(V, n_ticks),
              "dropped": np.zeros((V, n_ticks), np.float32),
              "buffer_s": h["buffer_s"][order].reshape(V, n_ticks),
              "on_s": h["on_core_s"][order].reshape(V, n_ticks),
              "cl_s": h["cloud_core_s"][order].reshape(V, n_ticks)}
    want = PT.telemetry_ref(traces, int(torch.argmin(psky.tables.rank_pos)))
    rtel = rpool.telemetry()
    for key in PT.TEL_KEYS:
        np.testing.assert_array_equal(tel.counters[key], want[key],
                                      err_msg=key)
        np.testing.assert_array_equal(tel.counters[key],
                                      rtel.counters[key], err_msg=key)
    assert tel.extras == rtel.extras
    assert PA.SkyscraperPool(psky, n_streams=V,
                             device="cpu").telemetry() is None
    h2 = PT.HostTelemetry(2, 1)
    h2.grow(4)
    h2.update({"k": np.array([1, 0, 2, 1]), "dropped": np.zeros(4, bool),
               "buffer_s": np.ones(4, np.float32),
               "on_s": np.ones(4, np.float32),
               "cl_s": np.zeros(4, np.float32)},
              valid=np.array([True, True, False, True]))
    h2.reset_slot(1)
    snap = h2.snapshot(select=[0, 1, 3])
    np.testing.assert_array_equal(snap.counters["config_switches"],
                                  [0.0, 0.0, 0.0])
    np.testing.assert_array_equal(snap.counters["seg_total"], [1, 0, 1])


@pytest.mark.parametrize("seed", range(6))
def test_shed_keep_sets_match_reference(seed):
    """``_pool_tick_fn`` on both sides, 40 slots (past one block of the
    prefix sum), priorities with ties, random active slots and
    capacities around the prefix sums of the planned demand."""
    f = ref_fitted()
    C, K = f.centers.shape
    V = 40
    rng = np.random.default_rng(seed)
    rts = [f.tables(buffer_gb=float(rng.choice([4.0, 0.05])))
           for _ in range(V)]
    stacked = RS.stack_tables(rts)
    pt = switch_tables_from_arrays(table_arrays(stacked), "cpu")
    state = RS.init_state_multi(rts)
    state = dict(state, buffer_s=jnp.asarray(rng.random(V) * 2, jnp.float32))
    active = rng.random(V) < 0.8
    prio = np.round(rng.random(V) * 3, 0).astype(np.float32) + 1
    q_meas = rng.random(V).astype(np.float32)
    q_valid = rng.random(V) < 0.5
    arr = (0.5 + rng.random(V)).astype(np.float32)
    alpha = rng.random((V, C, K)).astype(np.float32)
    alpha /= alpha.sum(-1, keepdims=True)
    zeros = np.zeros((V, K), np.float32)
    args_r = (state, jnp.asarray(q_meas), jnp.asarray(q_valid),
              jnp.asarray(zeros), jnp.asarray(arr), jnp.asarray(active),
              jnp.asarray(prio), jnp.asarray(alpha), stacked)
    p_state = {k: torch.as_tensor(np.array(v)).to(
        torch.int64 if k == "k_cur" else torch.float32)
        for k, v in state.items()}
    args_p = (p_state, torch.tensor(q_meas), torch.tensor(q_valid),
              torch.tensor(zeros), torch.tensor(arr), torch.tensor(active),
              torch.tensor(prio), torch.tensor(alpha), pt)
    _, free = RA._pool_tick(*args_r, jnp.float32(np.inf), jnp.float32(np.inf))
    order = np.argsort(np.where(active, -prio, np.inf), kind="stable")
    demand = np.asarray(free["on_s"])[order]
    sums = np.cumsum(demand.astype(np.float64))
    checked = 0
    for cap in list(sums[::3]) + list(rng.random(8) * sums[-1]):
        cap32 = np.float32(cap)
        for wm in (np.inf, 0.6):
            r_state, r_out = RA._pool_tick(*args_r, jnp.float32(cap32),
                                           jnp.float32(wm))
            p_state2, p_out = PA._pool_tick_fn(
                *args_p, torch.tensor(cap32), torch.tensor(np.float32(wm)))
            ulp = np.spacing(np.float32(sums[-1]))
            if np.min(np.abs(sums - cap32)) > V * ulp:
                checked += 1
            # the port's prefix sum is XLA's order: equal everywhere
            for key in ("shed", "dropped", "qual", "on_s", "buffer_s"):
                np.testing.assert_array_equal(
                    p_out[key].numpy(), np.asarray(r_out[key]), err_msg=key)
            for key, val in r_state.items():
                np.testing.assert_array_equal(p_state2[key].numpy(),
                                              np.asarray(val), err_msg=key)
    assert checked > 0
