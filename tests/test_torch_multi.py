"""The port's multi-stream path against the reference, on the CPU:
seeded numpy inputs through both packages.

- The batched decision (``switcher._masked_switch_multi``) against
  ``jax.vmap(_masked_switch)``: every output and state leaf bit for bit,
  with per-stream tables, budgets, buffers, arrival spikes that force
  drops, cloud placements and masked (no-op) streams.
- ``_fused_run_multi`` with the flight recorder on the reference's demo
  tables (tests/test_obs_telemetry.py:76's parameters): traces, per-
  stream counters and their window snapshots bit for bit, and the
  counters equal to ``telemetry_ref`` of each stream's traces.
- ``run_skyscraper_multi`` on COVID, with a ``SegmentStore`` sink that
  carries a standing registry and a subscription: every stored row
  (k, c, buffer, spend, quality traces), the per-stream telemetry, the
  alerts and the standing answers bit for bit, and so ``quality_pct``
  and the per-stream qualities; without a sink those come from float32
  sums over each window in another order, held within W * 2^-24
  relative. One case pads a
  stream's categories with sentinel rows (C_v < C_max).
- The windowed host loop against the reference's (bit for bit) and
  against the fused run (within 0.1 quality points, as
  tests/test_fused_ingest.py:93 holds the reference).
- ``solve_multi_stream`` on tests/test_multistream_shedding.py:14's
  case: the harder stream gets the budget, plans equal the reference's.
- ``ingest_tick``, plain and masked, against the reference store: rows
  and standing answers bit for bit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import port_fitted, ref_fitted, ref_plan, table_arrays
import repro.warehouse as RW
from repro.analysis import examples as EX
from repro.configs.workloads import COVID
from repro.core import ingest as RI
from repro.core import planner as RP
from repro.core import switcher as RS
from repro.data.stream import generate
from repro_torch.configs.workloads import COVID as P_COVID
from repro_torch.convert import switch_tables_from_arrays
from repro_torch.core import ingest as PI
from repro_torch.core import planner as PP
from repro_torch.core import switcher as PS
from repro_torch.data.stream import generate as p_generate
from repro_torch.obs import telemetry as PT
from repro_torch.warehouse import (Filter, GroupBy, SegmentStore,
                                   StandingQueries, WindowAgg)
from _torch_threads import cap_torch_threads

cap_torch_threads()

LEAVES = ("k", "p", "c", "qual", "on_s", "cl_s", "buffer_s", "rt",
          "dropped")
TRACE_KEYS = ("k", "dropped", "buffer_s", "on_s", "cl_s")


def _eq(got, want, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=msg)


# ---------------------------------------------------------------------------
# the batched decision
# ---------------------------------------------------------------------------

def _multi_case(kind, seed, V=5):
    f = ref_fitted()
    C, K = f.centers.shape
    rng = np.random.default_rng(seed)
    kws = [dict(buffer_gb=float(rng.choice([4.0, 0.002, 0.001])),
                cloud_budget=float(rng.choice([0.0, 400.0])))
           for _ in range(V)]
    rts = [f.tables(**kw) for kw in kws]
    state = RS.init_state_multi(rts)
    state = dict(state,
                 used=jnp.asarray(rng.integers(0, 5, (V, C, K)), jnp.float32),
                 count=jnp.asarray(rng.integers(0, 9, (V, C)), jnp.float32),
                 buffer_s=jnp.asarray(rng.random(V) * 3, jnp.float32),
                 cloud_spent=jnp.asarray(rng.random(V) * 300, jnp.float32),
                 k_cur=jnp.asarray(rng.integers(0, K, V), jnp.int32),
                 qual_prev=jnp.asarray(rng.random(V), jnp.float32))
    quals = rng.random((V, K)).astype(np.float32)
    arr = np.where(rng.random(V) < 0.3, 4000.0,
                   1.0 + 2 * rng.random(V)).astype(np.float32)
    valid = rng.random(V) < (0.7 if kind == "masked" else 1.1)
    alpha = rng.random((V, C, K)).astype(np.float32)
    alpha /= alpha.sum(-1, keepdims=True)
    return rts, state, quals, arr, valid, alpha


def _port_state(state):
    return {k: torch.as_tensor(np.array(v)).to(
        torch.int64 if k == "k_cur" else torch.float32)
        for k, v in state.items()}


@pytest.mark.parametrize("kind,seed", [("all", s) for s in range(4)]
                         + [("masked", s) for s in range(4, 8)])
def test_switch_multi_matches_vmapped_masked_switch(kind, seed):
    rts, state, quals, arr, valid, alpha = _multi_case(kind, seed)
    stacked = RS.stack_tables(rts)
    r_state, r_out = jax.jit(jax.vmap(RS._masked_switch))(
        state, jnp.asarray(quals), jnp.asarray(arr), jnp.asarray(valid),
        jnp.asarray(alpha), stacked)
    pt = switch_tables_from_arrays(table_arrays(stacked), "cpu")
    p_state, p_out = PS._masked_switch_multi(
        _port_state(state), torch.tensor(quals), torch.tensor(arr),
        torch.tensor(valid), torch.tensor(alpha), pt)
    for leaf in LEAVES:
        _eq(p_out[leaf], r_out[leaf], leaf)
    for key, val in r_state.items():
        _eq(p_state[key], val, key)


def test_switch_step_multi_and_window_match_reference():
    """``switch_step_multi`` (unmasked) and ``run_window_multi`` over a
    padded window (``pad_window_multi``) against the reference's."""
    rts, state, quals, arr, _, alpha = _multi_case("all", 11)
    stacked = RS.stack_tables(rts)
    pt = switch_tables_from_arrays(table_arrays(stacked), "cpu")
    r_state, r_out = RS.switch_step_multi(
        state, jnp.asarray(quals), jnp.asarray(arr), jnp.asarray(alpha),
        stacked)
    p_state, p_out = PS.switch_step_multi(
        _port_state(state), torch.tensor(quals), torch.tensor(arr),
        torch.tensor(alpha), pt)
    for leaf in LEAVES:
        _eq(p_out[leaf], r_out[leaf], leaf)
    rng = np.random.default_rng(12)
    V, K = quals.shape
    q_w = rng.random((V, 7, K)).astype(np.float32)
    a_w = np.ones((V, 7), np.float32)
    rq, ra, rv = RS.pad_window_multi(jnp.asarray(q_w), jnp.asarray(a_w), 10)
    pq, pa, pv = PS.pad_window_multi(torch.tensor(q_w), torch.tensor(a_w), 10)
    for g, w in ((pq, rq), (pa, ra), (pv, rv)):
        _eq(g, w)
    r_state, r_out = RS.run_window_multi(state, rq, ra, jnp.asarray(alpha),
                                         stacked, valid=rv)
    p_state, p_out = PS.run_window_multi(_port_state(state), pq, pa,
                                         torch.tensor(alpha), pt, valid=pv)
    for leaf in LEAVES:
        assert p_out[leaf].shape == (V, 10)
        _eq(p_out[leaf], r_out[leaf], leaf)
    for key, val in r_state.items():
        _eq(p_state[key], val, key)


# ---------------------------------------------------------------------------
# the fused multi-stream window loop with the flight recorder
# ---------------------------------------------------------------------------

# (T, W, V, seed): tests/test_obs_telemetry.py:76's parameter ranges
TEL_CASES = ((1, 2, 1, 0), (24, 6, 3, 1), (13, 4, 2, 2), (17, 5, 3, 3),
             (9, 2, 1, 4), (20, 3, 2, 5))


@pytest.mark.parametrize("T,W,V,seed", TEL_CASES)
def test_window_scan_multi_tel_matches_reference(T, W, V, seed):
    rng = np.random.default_rng(seed)
    ts = [EX.demo_tables(seed=seed + s) for s in range(V)]
    K = ts[0].cost.shape[0]
    n_w, pad, wts, _ = RI._window_layout(T, W)
    quals_w = rng.random((n_w, V, W, K)).astype(np.float32)
    arrs_w = np.ones((n_w, V, W), np.float32)
    valid_w = np.broadcast_to(
        (np.arange(n_w * W) < T).reshape(n_w, 1, W), (n_w, V, W))
    stacked = RS.stack_tables(ts)
    _, (r_res, r_tels) = RI._fused_run_multi(
        RS.init_state_multi(ts), jnp.asarray(quals_w), jnp.asarray(arrs_w),
        jnp.asarray(valid_w), jnp.asarray(wts), stacked, ts[0].cost,
        jnp.float32(16.0), jnp.float32(0.5), with_traces=True,
        telemetry=True)
    pt = switch_tables_from_arrays(table_arrays(stacked), "cpu")
    _, (p_res, p_tels) = PI._fused_run_multi(
        PS.init_state_multi([switch_tables_from_arrays(table_arrays(t),
                                                       "cpu") for t in ts]),
        torch.tensor(quals_w), torch.tensor(arrs_w),
        torch.tensor(np.ascontiguousarray(valid_w)), wts, pt, pt.cost[0],
        torch.tensor(np.float32(16.0)), torch.tensor(np.float32(0.5)),
        with_traces=True, telemetry=True)
    for leaf in LEAVES:
        _eq(p_res[leaf], r_res[leaf], leaf)
    tel = PT.Telemetry.from_device(p_tels)
    traces = {k: p_res[k].numpy().transpose(1, 0, 2).reshape(V, -1)[:, :T]
              for k in TRACE_KEYS}
    k0 = np.asarray([int(np.argmin(np.asarray(t.rank_pos))) for t in ts])
    want = PT.telemetry_ref(traces, k0)
    for key in PT.TEL_KEYS:
        assert tel.counters[key].shape == (V,)
        _eq(tel.counters[key], want[key], key)
        _eq(tel.per_window[key], r_tels[key], key)


# ---------------------------------------------------------------------------
# run_skyscraper_multi on COVID
# ---------------------------------------------------------------------------

KW = dict(n_cores_each=8, cloud_budget_core_s=2_000.0, plan_days=0.02)
PLANS = ((GroupBy("stream_id", "quality", agg="mean", num_groups=4),),
         (Filter("quality", "gt", 0.5),
          GroupBy("k", "on_core_s", agg="sum", num_groups=16)),
         (WindowAgg(500, "quality", agg="max", num_windows=16),))
SUB = ((GroupBy("stream_id", "buffer_s", agg="max", num_groups=4),),
       Filter("buffer_s", "ge", 0.0))


def _fits(padded: bool):
    """Three streams' fits; with ``padded`` the second stream keeps 3 of
    the fit's 4 categories, so its table is sentinel-padded."""
    r, p = ref_fitted(), port_fitted()
    if not padded:
        return [r] * 3, [p] * 3
    r3 = dataclasses.replace(r, centers=np.asarray(r.centers)[:3])
    p3 = dataclasses.replace(p, centers=np.asarray(p.centers)[:3])
    return [r, r3, r], [p, p3, p]


def _registry(reg, plans, sub):
    handles = [reg.register(p) for p in plans]
    reg.subscribe(sub[0], sub[1], name="buffer-watch")
    return handles


@functools.lru_cache(maxsize=None)
def _multi_runs(padded: bool, sink: bool):
    rf, pf = _fits(padded)
    r_streams = [generate(COVID, days=0.05, seed=40 + v) for v in range(3)]
    p_streams = [p_generate(P_COVID, days=0.05, seed=40 + v)
                 for v in range(3)]
    K = len(rf[0].configs)
    rstore = pstore = rh = ph = None
    kw = dict(KW, telemetry=True)
    if sink:
        rstore = RW.SegmentStore(out_dim=K, chunk_rows=1024)
        rh = _registry(RW.StandingQueries(rstore),
                       [ref_plan(p) for p in PLANS],
                       (ref_plan(SUB[0]), ref_plan((SUB[1],))[0]))
        pstore = SegmentStore(out_dim=K, chunk_rows=1024, device="cpu")
        ph = _registry(StandingQueries(pstore), PLANS, SUB)
    ref = RI.run_skyscraper_multi(rf, r_streams, sink=rstore,
                                  sink_stream_base=7, **kw)
    got = PI.run_skyscraper_multi(pf, p_streams, sink=pstore,
                                  sink_stream_base=7, device="cpu", **kw)
    return ref, got, rstore, pstore, rh, ph


@pytest.mark.parametrize("padded", (False, True))
@pytest.mark.parametrize("sink", (False, True))
def test_run_skyscraper_multi_matches_reference(padded, sink):
    ref, got, rstore, pstore, rh, ph = _multi_runs(padded, sink)
    for key in PT.TEL_KEYS:
        _eq(got["telemetry"].counters[key], ref["telemetry"].counters[key],
            key)
        _eq(got["telemetry"].per_window[key],
            ref["telemetry"].per_window[key], key)
    if not sink:
        # each window's quality is a float32 sum of W values on either
        # side, added in another order: within W * 2^-24 of the sum
        W = int(KW["plan_days"] * 86400 / COVID.segment_seconds)
        tol = W * 2.0 ** -24
        np.testing.assert_allclose(got["per_stream_pct"],
                                   ref["per_stream_pct"], rtol=tol)
        assert got["quality_pct"] == pytest.approx(ref["quality_pct"],
                                                   rel=tol)
        return
    # with a sink both sum the stored traces in numpy: bit for bit
    assert got["per_stream_pct"] == ref["per_stream_pct"]
    assert got["quality_pct"] == ref["quality_pct"]
    rr, pr = rstore.host_rows(), pstore.host_rows()
    assert len(pstore) == len(rstore) == 3 * len(rr["t"]) // 3
    for k in rr:
        _eq(pr[k], rr[k], k)
    assert set(pr["stream_id"].tolist()) == {7, 8, 9}
    # the per-stream telemetry replays from the rows each stream landed
    T = len(pr["t"]) // 3
    traces = {"k": pr["k"].reshape(3, T),
              "dropped": np.zeros((3, T), np.float32),
              "buffer_s": pr["buffer_s"].reshape(3, T),
              "on_s": pr["on_core_s"].reshape(3, T),
              "cl_s": pr["cloud_core_s"].reshape(3, T)}
    if got["telemetry"].dropped == 0:
        want = PT.telemetry_ref(traces, int(np.argmax(port_fitted().power)))
        for key in PT.TEL_KEYS:
            _eq(got["telemetry"].counters[key], want[key], key)
    # standing answers and alerts: the folds saw the same rows
    for h_r, h_p in zip(rh, ph):
        rt, rm = rstore.standing.answer(h_r)
        pt, pm = pstore.standing.answer(h_p)
        _eq(pm, rm)
        for k in rt:
            _eq(pt[k], rt[k], k)
    assert [a.name for a in got["alerts"]] == [a.name for a in
                                               ref["alerts"]]
    _eq(got["alerts"][0].fired, ref["alerts"][0].fired)
    tel = pstore.telemetry()
    assert tel.ingest_dispatches == 1 and tel.lag_rows == 3 * T
    assert tel.lag_max_ticks == T - 1


def test_windowed_multi_matches_reference_and_fused():
    rf, pf = _fits(False)
    r_streams = [generate(COVID, days=0.05, seed=5 + 12 * v)
                 for v in range(2)]
    p_streams = [p_generate(P_COVID, days=0.05, seed=5 + 12 * v)
                 for v in range(2)]
    kw = dict(KW)
    ref = RI.run_skyscraper_multi_windowed(rf[:2], r_streams, **kw)
    got = PI.run_skyscraper_multi_windowed(pf[:2], p_streams,
                                           device="cpu", **kw)
    assert got["quality_pct"] == ref["quality_pct"]
    assert got["per_stream_pct"] == ref["per_stream_pct"]
    fused = PI.run_skyscraper_multi(pf[:2], p_streams, device="cpu", **kw)
    assert fused["quality_pct"] == pytest.approx(got["quality_pct"],
                                                 abs=0.1)
    np.testing.assert_allclose(fused["per_stream_pct"],
                               got["per_stream_pct"], atol=0.1)


def test_solve_multi_stream_budget_shared_fairly():
    cost = np.array([1.0, 4.0, 10.0], np.float32)
    easy = np.array([[0.9, 0.95, 1.0]], np.float32)
    hard = np.array([[0.2, 0.6, 1.0]], np.float32)
    rs = [np.ones(1, np.float32), np.ones(1, np.float32)]
    a_easy, a_hard = PP.solve_multi_stream(
        [torch.tensor(easy), torch.tensor(hard)], cost, rs, 8.0)
    w_easy, w_hard = RP.solve_multi_stream([easy, hard], cost, rs, 8.0)
    _eq(a_easy, w_easy)
    _eq(a_hard, w_hard)
    spend_easy = float((a_easy.numpy() * cost).sum())
    spend_hard = float((a_hard.numpy() * cost).sum())
    assert spend_hard > spend_easy
    assert spend_easy + spend_hard <= 8.0 + 1e-3
    q, s = PP.plan_value(a_hard, torch.tensor(hard), torch.tensor(cost),
                         torch.ones(1))
    qr, sr = RP.plan_value(w_hard, jnp.asarray(hard), jnp.asarray(cost),
                           jnp.ones(1))
    assert (q, s) == pytest.approx((qr, sr), rel=1e-6)


@pytest.mark.parametrize("masked", (False, True))
def test_ingest_tick_matches_reference(masked):
    """Ticks of traces into a store with a registry: the plain form
    lands slot v as stream v, the masked form compacts the active slots
    (real ids) to consecutive rows and folds only those."""
    rng = np.random.default_rng(3 if masked else 4)
    V, K = 6, 5
    rstore = RW.SegmentStore(out_dim=K, chunk_rows=8)
    pstore = SegmentStore(out_dim=K, chunk_rows=8, device="cpu")
    plan = (GroupBy("stream_id", "quality", agg="sum", num_groups=64),)
    rh = RW.StandingQueries(rstore).register(ref_plan(plan))
    ph = StandingQueries(pstore).register(plan)
    for t in range(5):
        outs = {"c": rng.integers(0, 4, V), "k": rng.integers(0, K, V),
                "qual": rng.random(V).astype(np.float32),
                "on_s": rng.random(V).astype(np.float32),
                "cl_s": rng.random(V).astype(np.float32),
                "buffer_s": rng.random(V).astype(np.float32)}
        q = rng.random(V).astype(np.float32)
        vecs = rng.random((V, K)).astype(np.float32)
        kw = {}
        if masked:
            kw = dict(stream_ids=rng.permutation(40)[:V],
                      valid=rng.random(V) < 0.6)
        n_r = rstore.ingest_tick({k: jnp.asarray(v) for k, v in outs.items()},
                                 quality=jnp.asarray(q),
                                 out_vecs=jnp.asarray(vecs), t=t, **kw)
        n_p = pstore.ingest_tick({k: torch.as_tensor(v)
                                  for k, v in outs.items()},
                                 quality=torch.tensor(q),
                                 out_vecs=torch.tensor(vecs), t=t, **kw)
        assert n_r == n_p
    rr, pr = rstore.host_rows(), pstore.host_rows()
    for k in rr:
        _eq(pr[k], rr[k], k)
    rt, rm = rstore.standing.answer(rh)
    pt, pm = pstore.standing.answer(ph)
    _eq(pm, rm)
    for k in rt:
        _eq(pt[k], rt[k], k)
    rtel, ptel = rstore.telemetry(), pstore.telemetry()
    assert ptel.summary() == rtel.summary()
