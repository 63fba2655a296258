"""The port's flight recorder (``repro_torch.obs.telemetry``) against the
reference's ``repro.obs.telemetry``, on the CPU: the single-stream cases
of tests/test_obs_telemetry.py.

- ``window_scan_tel`` over a run cut into windows (the last one padded),
  on the reference fit's tables with random qualities and plans, arrival
  spikes that force drops and a small buffer at three times the
  arrival rate: the counters after every window equal, bit for bit, the
  reference's ``window_scan_tel`` on the same inputs and
  ``telemetry_ref`` of the port's own traces.
- ``run_skyscraper_fused(telemetry=True)`` on COVID in each forecast
  mode: its counters equal the reference run's and ``telemetry_ref`` of
  the rows its store sink captured, bit for bit, and its decisions equal
  those of the run without telemetry.
- ``Telemetry.window_deltas`` sums back to the counters.
- The store's counters (a T-batch's lag against tick ingest, query
  dispatches, the standing registry's gauges) equal the reference
  store's after the same calls.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import port_fitted, ref_fitted, ref_plan
import repro.warehouse as RW
from repro.configs.workloads import COVID
from repro.core import ingest as RI
from repro.core import switcher as RS
from repro.data.stream import generate
from repro.obs import telemetry as RT
from repro_torch.configs.workloads import COVID as P_COVID
from repro_torch.core import ingest as PI
from repro_torch.core import switcher as PS
from repro_torch.data.stream import generate as p_generate
from repro_torch.obs import telemetry as PT
from repro_torch.warehouse import (Filter, GroupBy, SegmentStore,
                                   StandingQueries)
from _torch_threads import cap_torch_threads

cap_torch_threads()

TRACE_KEYS = ("k", "dropped", "buffer_s", "on_s", "cl_s")
# (T, W, seed, kind): run length, window, draw seed, table variant
SCAN_CASES = ((1, 2, 0, "steady"), (23, 5, 1, "steady"),
              (40, 8, 2, "spike"), (17, 4, 3, "small_buffer"),
              (37, 6, 4, "spike"), (9, 9, 5, "small_buffer"),
              (31, 7, 6, "steady"), (12, 5, 7, "spike"))


def _tables(kind):
    kw = {"steady": dict(buffer_gb=4.0, cloud_budget=0.0),
          "spike": dict(buffer_gb=0.002, cloud_budget=0.0),
          "small_buffer": dict(buffer_gb=0.001, cloud_budget=400.0)}[kind]
    return ref_fitted().tables(**kw), port_fitted().tables(**kw)


def _scan_case(T, W, seed, kind):
    """Run both window loops window by window; returns the port's and the
    reference's per-window counters, the port's flat traces and k0."""
    rt, pt = _tables(kind)
    C, K = ref_fitted().centers.shape
    rng = np.random.default_rng(seed)
    n_w, pad, _, _ = PI._window_layout(T, W)
    quals = rng.random((n_w * W, K)).astype(np.float32)
    arrivals = np.where(rng.random(n_w * W) < 0.2, 4000.0, 1.0) \
        if kind == "spike" else \
        np.full(n_w * W, 3.0 if kind == "small_buffer" else 1.0)
    arrivals = arrivals.astype(np.float32)
    valid = np.arange(n_w * W) < T
    quals[~valid], arrivals[~valid] = 0.0, 1.0
    r_state, p_state = RS.init_state(rt), PS.init_state(pt)
    r_tel, p_tel = RT.tel_init(r_state), PT.tel_init(p_state)
    r_scan = jax.jit(RT.window_scan_tel)
    snaps, ref_snaps, outs = [], [], []
    for w in range(n_w):
        sl = slice(w * W, (w + 1) * W)
        alpha = rng.random((C, K)).astype(np.float32)
        alpha /= alpha.sum(1, keepdims=True)
        (r_state, r_tel), _ = r_scan(
            r_state, r_tel, jnp.asarray(quals[sl]), jnp.asarray(arrivals[sl]),
            jnp.asarray(valid[sl]), jnp.asarray(alpha), rt)
        (p_state, p_tel), out = PT.window_scan_tel(
            p_state, p_tel, torch.from_numpy(quals[sl]),
            torch.from_numpy(arrivals[sl]), torch.from_numpy(valid[sl]),
            torch.from_numpy(alpha), pt)
        snaps.append(p_tel)
        ref_snaps.append({k: np.asarray(v) for k, v in r_tel.items()})
        outs.append(out)
    traces = {k: torch.cat([o[k] for o in outs])[:T].numpy()
              for k in TRACE_KEYS}
    k0 = int(torch.argmin(pt.rank_pos))
    tel = PT.Telemetry.from_device(
        {k: torch.stack([s[k] for s in snaps]) for k in PT.TEL_KEYS})
    return tel, ref_snaps, traces, k0


@pytest.mark.parametrize("T,W,seed,kind", SCAN_CASES)
def test_window_scan_tel_bit_exact(T, W, seed, kind):
    tel, ref_snaps, traces, k0 = _scan_case(T, W, seed, kind)
    n_w = PI._window_layout(T, W)[0]
    want = PT.telemetry_ref(traces, k0)
    assert PT.TEL_KEYS == RT.TEL_KEYS
    for key in PT.TEL_KEYS:
        assert tel.per_window[key].shape == (n_w,)
        assert tel.counters[key].dtype == np.float32
        np.testing.assert_array_equal(tel.counters[key], want[key],
                                      err_msg=key)
        np.testing.assert_array_equal(
            tel.per_window[key], np.stack([s[key] for s in ref_snaps]),
            err_msg=key)
    # the numpy mirrors agree with each other
    ref = RT.telemetry_ref(traces, k0)
    for key in PT.TEL_KEYS:
        np.testing.assert_array_equal(want[key], ref[key], err_msg=key)
    if kind == "spike":
        assert tel.dropped > 0
    if kind == "small_buffer":
        assert tel.buffer_hwm_s > 0


def test_padding_step_is_a_no_op():
    _, pt = _tables("steady")
    state = PS.init_state(pt)
    tel = {k: torch.tensor(float(i) + 0.5) for i, k in
           enumerate(PT.TEL_KEYS)}
    _, out = PS._masked_switch(state, torch.rand(pt.n_configs),
                               torch.tensor(1.0), torch.tensor(True),
                               torch.ones(pt.centers.shape) / pt.n_configs,
                               pt)
    same = PT.tel_step(tel, state["k_cur"] + 1, out, torch.tensor(False))
    for key in PT.TEL_KEYS:
        assert torch.equal(same[key], tel[key]), key


KW = dict(n_cores=8, cloud_budget_core_s=3000.0, plan_days=0.02)


@functools.lru_cache(maxsize=None)
def _runs(mode):
    ref = RI.run_skyscraper_fused(ref_fitted(),
                                  generate(COVID, days=0.11, seed=42),
                                  forecast_mode=mode, telemetry=True, **KW)
    store = SegmentStore(out_dim=len(ref_fitted().configs), device="cpu")
    stream = p_generate(P_COVID, days=0.11, seed=42)
    got = PI.run_skyscraper_fused(port_fitted(), stream, forecast_mode=mode,
                                  sink=store, telemetry=True, device="cpu",
                                  **KW)
    bare = PI.run_skyscraper_fused(port_fitted(), stream, forecast_mode=mode,
                                   device="cpu", **KW)
    return ref, got, bare, store


@pytest.mark.parametrize("mode", ("model", "oracle", "uniform"))
def test_fused_run_telemetry_matches_reference(mode):
    ref, got, bare, store = _runs(mode)
    T = len(got.k_trace)
    tel = got.telemetry
    assert bare.telemetry is None
    np.testing.assert_array_equal(got.k_trace, bare.k_trace)
    np.testing.assert_array_equal(got.c_trace, bare.c_trace)
    np.testing.assert_array_equal(got.buffer_trace, bare.buffer_trace)
    assert tel.segments == T == 4752
    assert tel.per_window["seg_total"].shape == (len(got.plans),)
    for key in PT.TEL_KEYS:
        np.testing.assert_array_equal(tel.counters[key],
                                      np.asarray(ref.telemetry.counters[key]),
                                      err_msg=key)
        np.testing.assert_array_equal(
            tel.per_window[key], np.asarray(ref.telemetry.per_window[key]),
            err_msg=key)
    # the replay of the rows the sink captured (no drops in this run)
    assert tel.dropped == 0.0
    h = store.host_rows()
    want = PT.telemetry_ref(
        {"k": h["k"], "dropped": np.zeros(T, np.float32),
         "buffer_s": h["buffer_s"], "on_s": h["on_core_s"],
         "cl_s": h["cloud_core_s"]}, int(np.argmax(port_fitted().power)))
    for key in PT.TEL_KEYS:
        np.testing.assert_array_equal(tel.counters[key], want[key],
                                      err_msg=key)
    assert tel.buffer_hwm_s == float(np.max(got.buffer_trace))
    assert tel.summary() == ref.telemetry.summary()


def test_window_deltas_sum_back_to_counters():
    tel, _, _, _ = _scan_case(23, 5, 1, "steady")
    deltas = tel.window_deltas()
    for key in PT.TEL_KEYS:
        if key == "buffer_hwm_s":
            np.testing.assert_array_equal(deltas[key], tel.per_window[key])
        else:
            np.testing.assert_allclose(deltas[key].sum(axis=0),
                                       tel.counters[key], rtol=1e-6,
                                       err_msg=key)
    ref = RT.Telemetry(counters=tel.counters, per_window=tel.per_window)
    for key, v in ref.window_deltas().items():
        np.testing.assert_array_equal(deltas[key], v, err_msg=key)


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    return {
        "stream_id": np.zeros(n, np.int32),
        "t": np.arange(n, dtype=np.int32),
        "category": rng.integers(0, 4, n).astype(np.int32),
        "k": rng.integers(0, 3, n).astype(np.int32),
        "quality": rng.random(n).astype(np.float32),
        "on_core_s": rng.random(n).astype(np.float32),
        "cloud_core_s": rng.random(n).astype(np.float32),
        "buffer_s": rng.random(n).astype(np.float32),
        "out": rng.random((n, 2)).astype(np.float32),
    }


def _traces(T, seed):
    rng = np.random.default_rng(seed)
    W = 8
    n_w = -(-T // W)

    def lay(x):
        return np.pad(x, (0, n_w * W - T)).reshape(n_w, W)
    return {"c": lay(rng.integers(0, 4, T).astype(np.int32)),
            "k": lay(rng.integers(0, 3, T).astype(np.int32)),
            "qual": lay(rng.random(T).astype(np.float32)),
            "on_s": lay(rng.random(T).astype(np.float32)),
            "cl_s": lay(rng.random(T).astype(np.float32)),
            "buffer_s": lay(rng.random(T).astype(np.float32))}


def test_store_counters_match_reference():
    """Tick ingest (lag 0), a T-batch (lag 0..T-1), queries, and the
    standing registry's gauges, after the same calls on both stores."""
    ref = RW.SegmentStore(out_dim=2, chunk_rows=64)
    got = SegmentStore(out_dim=2, chunk_rows=64, device="cpu")
    empty = got.telemetry()
    assert empty.n_rows == 0 and empty.imbalance == 1.0
    assert empty.lag_mean_ticks == 0.0
    plan = (GroupBy("category", "quality", agg="mean", num_groups=4),)
    sub_plan = (GroupBy("k", "cloud_core_s", agg="sum", num_groups=3),)
    pred = Filter("cloud_core_s", "gt", 5.0)
    r_reg, p_reg = RW.StandingQueries(ref), StandingQueries(got)
    r_reg.register(ref_plan(plan))
    p_reg.register(plan)
    r_reg.subscribe(ref_plan(sub_plan), ref_plan((pred,))[0])
    p_reg.subscribe(sub_plan, pred)
    rows = _rows(50, 0)
    ref.append_rows({k: jnp.asarray(v) for k, v in rows.items()})
    got.append_rows(rows)
    tr = _traces(37, 1)
    out = np.random.default_rng(2).random((37, 2)).astype(np.float32)
    ref.ingest_fused({k: jnp.asarray(v) for k, v in tr.items()},
                     jnp.asarray(out), stream_id=1)
    got.ingest_fused({k: torch.from_numpy(v) for k, v in tr.items()},
                     torch.from_numpy(out), stream_id=1)
    r_reg.poll()
    p_reg.poll()
    for q in ((Filter("quality", "ge", 0.0),), (Filter("quality", "ge", 0.5),),
              plan):
        ref.query(ref_plan(q))
        got.query(q)
    want, have = ref.telemetry(), got.telemetry()
    for f in ("n_rows", "ingest_dispatches", "query_dispatches", "lag_rows",
              "lag_sum_ticks", "lag_max_ticks", "standing_queries",
              "standing_refreshes", "alerts_checked", "alerts_fired",
              "spill_events", "spilled_rows", "dequantize_events",
              "imbalance", "lag_mean_ticks"):
        assert getattr(have, f) == getattr(want, f), f
    assert (have.ingest_dispatches, have.query_dispatches) == (2, 3)
    assert (have.lag_rows, have.lag_max_ticks) == (87, 36)
    assert have.lag_sum_ticks == 37 * 36 // 2
    assert have.standing_queries == 2 and have.alerts_checked == 1
    assert have.summary() == want.summary()
    np.testing.assert_array_equal(have.rows_by_shard, want.rows_by_shard)
