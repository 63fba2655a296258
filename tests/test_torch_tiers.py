"""The port's int8 cold tier (``warehouse.tiers.TieredStore`` and
``distribution.compression``) against the reference, on the CPU.

- ``quantize_int8``/``dequantize`` with the reference's own uniform
  draws (``jax.random.uniform`` of its keys) against the reference's
  compiled ``quantize_int8``, one tensor and a chunk batch: codes,
  scales and values bit for bit.
- A spill with the reference's draws (``spill(draws=)``): cold codes,
  scales and integer columns bit for bit against the reference's
  ``TieredStore``; queries over the two-tier view equal the reference
  tier's; ``convert.cold_tier_from_arrays`` carries its cold tier over.
- A spill with the port's own draws: answers within the quantization
  bound of the unspilled store (``max_cold_scale``; means within one
  scale, sums within a scale per summed row, counts exact), hot rows
  exact (tests/test_warehouse.py:360); spill guards and the memoized
  view (:381); standing answers unchanged bit for bit by a spill, and
  later folds equal to the reference registry's on the same rows
  (tests/test_standing.py:226); the tier counters
  (tests/test_obs_telemetry.py:196).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.warehouse as RW
from _torch_parity import ref_plan
from repro.distribution import compression as RC
from repro.warehouse.query import execute_ref
from repro_torch.convert import cold_tier_from_arrays
from repro_torch.distribution import compression as PC
from repro_torch.warehouse import (Filter, GroupBy, SegmentStore,
                                   StandingQueries, TieredStore, WindowAgg)
from _torch_threads import cap_torch_threads

cap_torch_threads()

D = 3


def _rows(n, seed=0, t0=0):
    rng = np.random.default_rng(seed)
    return {
        "stream_id": rng.integers(0, 4, n).astype(np.int32),
        "t": (t0 + np.arange(n)).astype(np.int32),
        "category": rng.integers(0, 4, n).astype(np.int32),
        "k": rng.integers(0, D, n).astype(np.int32),
        "quality": rng.random(n).astype(np.float32),
        "on_core_s": (rng.random(n) * 20).astype(np.float32),
        "cloud_core_s": (rng.random(n) * 5).astype(np.float32),
        "buffer_s": (rng.random(n) * 40).astype(np.float32),
        "out": rng.random((n, D)).astype(np.float32),
    }


def _eq(a, b, msg=""):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_array_equal(a, np.asarray(b), err_msg=msg)


@pytest.mark.parametrize("seed", range(6))
def test_quantize_int8_with_reference_draws(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 3000))
    x = (rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(seed)
    q, s = jax.jit(RC.quantize_int8)(jnp.asarray(x), key)
    r = np.asarray(jax.random.uniform(key, x.shape))
    pq, ps = PC.quantize_int8(torch.tensor(x), torch.tensor(r))
    _eq(pq, q)
    _eq(ps, s)
    _eq(PC.dequantize(pq, ps), jax.jit(RC.dequantize)(q, s))
    # a batch of chunks, one scale each, as the tier quantizes them
    m = max(1, n // 4)
    xs = x[:4 * m].reshape(-1, m) if n >= 4 else x[None]
    keys = jax.random.split(key, xs.shape[0])
    vq, vs = jax.jit(jax.vmap(RC.quantize_int8))(jnp.asarray(xs), keys)
    vr = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, xs.shape[1:]))(keys))
    wq, ws = PC.quantize_int8(torch.tensor(xs), torch.tensor(vr))
    _eq(wq, vq)
    _eq(ws, vs)
    _eq(PC.dequantize(wq, ws), jax.jit(jax.vmap(RC.dequantize))(vq, vs))
    # the error bound: at most one scale per element
    err = np.abs(PC.dequantize(wq, ws).numpy() - xs)
    assert (err <= ws.numpy()[:, None] * (1 + 2 ** -20)).all()


def _ref_draws(seed, n_cold, n_chunks):
    """The reference tier's draws for a spill of ``n_chunks`` chunks."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), n_cold)
    keys = jax.random.split(key, n_chunks)

    def draws(name, nc, width):
        assert nc == n_chunks
        return torch.tensor(np.asarray(jax.vmap(
            lambda k: jax.random.uniform(k, (width,)))(keys)))
    return draws


def _pair(n=4096, chunk=512, seed=11):
    rows = _rows(n, seed=seed)
    rstore = RW.SegmentStore(out_dim=D, chunk_rows=chunk)
    rstore.append_rows({k: jnp.asarray(v) for k, v in rows.items()})
    pstore = SegmentStore(out_dim=D, chunk_rows=chunk, device="cpu")
    pstore.append_rows(rows)
    return rows, RW.TieredStore(rstore, seed=1), TieredStore(
        pstore, seed=1, device="cpu")


PLANS = ((GroupBy("category", "quality", agg="mean", num_groups=4),),
         (Filter("on_core_s", "gt", 5.0),
          GroupBy("k", "buffer_s", agg="sum", num_groups=4)),
         (WindowAgg(512, "cloud_core_s", agg="max", num_windows=8),),
         (GroupBy("stream_id", "quality", agg="count", num_groups=4),))


def test_spill_matches_reference_with_its_draws():
    rows, rt, pt = _pair()
    chunk = rt.hot.chunk_rows
    for keep in (3000, 1000):
        n_chunks = (rt.hot.n_rows - keep) // chunk
        spilled = rt.spill(keep_hot=keep)
        assert pt.spill(keep_hot=keep,
                        draws=_ref_draws(1, pt.n_cold, n_chunks)) == spilled
        assert pt.n_cold == rt.n_cold and pt.hot.n_rows == rt.hot.n_rows
    for k in rt.cold_q:
        _eq(pt.cold_q[k], rt.cold_q[k], k)
        _eq(pt.cold_scales[k], rt.cold_scales[k], k)
    for k in rt.cold_int:
        _eq(pt.cold_int[k], rt.cold_int[k], k)
    pcols, pn = pt.materialize()
    rcols, rn = rt.materialize()
    assert pn == rn == len(rows["t"])
    for k in rcols:
        _eq(pcols[k][:pn], np.asarray(rcols[k])[:rn], k)
    for plan in PLANS:
        rtab, rmask = rt.query(ref_plan(plan))
        for uk in (False, True):
            ptab, pmask = pt.query(plan, use_kernel=uk)
            _eq(pmask, rmask)
            for k in rtab:
                _eq(ptab[k], rtab[k], f"{plan} {k} {uk}")
    # the reference's cold tier carried across into a fresh port tier
    fresh = TieredStore(SegmentStore(out_dim=D, chunk_rows=chunk,
                                     device="cpu"), seed=1, device="cpu")
    fresh.hot.append_rows({k: v[rt.n_cold:] for k, v in rows.items()})
    cold_tier_from_arrays(
        fresh, {k: np.asarray(v) for k, v in rt.cold_q.items()},
        {k: np.asarray(v) for k, v in rt.cold_scales.items()},
        {k: np.asarray(v) for k, v in rt.cold_int.items()})
    fcols, fn = fresh.materialize()
    assert fn == rn
    for k in rcols:
        _eq(fcols[k][:fn], np.asarray(rcols[k])[:rn], k)


def _fixture(n=4096, chunk=512, seed=11):
    rows = _rows(n, seed=seed)
    store = SegmentStore(out_dim=D, chunk_rows=chunk, device="cpu")
    store.append_rows(rows)
    ts = TieredStore(store, seed=1, device="cpu")
    spilled = ts.spill(keep_hot=n // 2)
    assert spilled > 0 and spilled % chunk == 0
    assert ts.n_rows == n and ts.hot.n_rows == n - spilled
    return ts, rows, n, spilled


def test_tiered_query_within_quantization_tolerance():
    ts, rows, n, spilled = _fixture()
    assert 0 < ts.max_cold_scale() <= 40 / 127 * (1 + 1e-6)
    for uk in (False, True):
        plan = (GroupBy("category", "quality", agg="mean", num_groups=4),)
        table, _ = ts.query(plan, use_kernel=uk)
        ref, _ = execute_ref(rows, n, ref_plan(plan))
        tol = ts.max_cold_scale() + 1e-6
        np.testing.assert_allclose(table["quality"].numpy(), ref["quality"],
                                   atol=tol)
        _eq(table["count"], ref["count"])
        # a sum is within one scale per summed cold row
        plan = (GroupBy("k", "on_core_s", agg="sum", num_groups=D),)
        table, _ = ts.query(plan, use_kernel=uk)
        ref, _ = execute_ref(rows, n, ref_plan(plan))
        np.testing.assert_allclose(
            table["on_core_s"].numpy(), ref["on_core_s"],
            atol=ts.max_cold_scale() * spilled + 1e-3)
        # the hot rows stayed float32: a plan over recent times is exact
        t_lo = float(np.sort(rows["t"])[spilled])
        plan = (Filter("t", "ge", t_lo),
                GroupBy("category", "quality", agg="sum", num_groups=4))
        table, _ = ts.query(plan, use_kernel=uk)
        ref, _ = execute_ref(rows, n, ref_plan(plan))
        _eq(table["quality"], ref["quality"])


def test_spill_guards_and_memoized_view():
    ts, _, n, _ = _fixture(seed=17)
    with pytest.raises(AssertionError):
        ts.spill(-1)
    ts.spill(0)
    assert ts.n_rows == n
    assert ts.n_cold % ts.hot.chunk_rows == 0 and ts.n_cold <= n
    cols1, _ = ts.materialize()
    cols2, _ = ts.materialize()
    assert cols1 is cols2
    ts.hot.append_rows(_rows(8, seed=18, t0=n))
    cols3, n_tot = ts.materialize()
    assert cols3 is not cols1 and n_tot == n + 8
    # the port's own draws: the same seed and cold count, the same codes
    a, _, _, _ = _fixture(seed=5)
    b, _, _, _ = _fixture(seed=5)
    for k in a.cold_q:
        _eq(a.cold_q[k], b.cold_q[k], k)
    with pytest.raises(ValueError, match="runs on"):
        TieredStore(a.hot, device="meta")


def test_spill_invariance_single():
    """A spill leaves every standing answer as it was, bit for bit, and
    later folds go on as the reference's registry folds the same rows;
    a rescan of the two-tier view is only within the bound."""
    pstore = SegmentStore(out_dim=D, chunk_rows=256, device="cpu")
    ts = TieredStore(pstore, seed=2, device="cpu")
    reg = StandingQueries(ts)
    assert ts.standing is reg
    rstore = RW.SegmentStore(out_dim=D, chunk_rows=256)
    rts = RW.TieredStore(rstore, seed=2)
    rreg = RW.StandingQueries(rts)
    plan = (Filter("quality", "ge", 0.1),
            GroupBy("category", "quality", agg="sum", num_groups=4))
    # the engine's fold path, bit-exact with the reference registry's
    # (tests/test_torch_standing.py); K1's path regroups the float sums
    h = reg.register(plan, use_kernel=False)
    rh = rreg.register(ref_plan(plan), use_pallas=False)
    hk = reg.register(plan, name="k1", use_kernel=True)
    a, b = _rows(2048, seed=16), _rows(256, seed=17, t0=2048)
    pstore.append_rows(a)
    rstore.append_rows({k: jnp.asarray(v) for k, v in a.items()})
    before = [tuple(reg.answer(x)) for x in (h, hk)]
    before = [({k: v.clone() for k, v in t.items()}, m) for t, m in before]
    assert ts.spill(keep_hot=512) > 0
    rts.spill(keep_hot=512)
    for x, (bt, bm) in zip((h, hk), before):
        after_t, after_m = reg.answer(x)
        _eq(after_m, bm)
        for k in bt:
            _eq(after_t[k], bt[k], k)
    before = before[0][0]
    rescan, _ = ts.query(plan)
    np.testing.assert_allclose(rescan["quality"].numpy(),
                               before["quality"].numpy(),
                               atol=ts.max_cold_scale() * 2048 + 1e-6)
    pstore.append_rows(b)
    rstore.append_rows({k: jnp.asarray(v) for k, v in b.items()})
    got_t, got_m = reg.answer(h)
    want_t, want_m = rreg.answer(rh)
    _eq(got_m, want_m)
    for k in want_t:
        _eq(got_t[k], want_t[k], k)
    full = {k: np.concatenate([a[k], b[k]]) for k in a}
    ref, _ = execute_ref(full, 2048 + 256, ref_plan(plan))
    _eq(got_t["quality"], ref["quality"])
    k1_t, _ = reg.answer(hk)
    np.testing.assert_allclose(k1_t["quality"].numpy(), ref["quality"],
                               rtol=1e-5, atol=1e-4)
    # a plan registered after the spill backfills from the two-tier view
    cplan = (GroupBy("k", "quality", agg="count", num_groups=D),)
    t2, _ = reg.answer(reg.register(cplan))
    r2, _ = execute_ref(full, 2048 + 256, ref_plan(cplan))
    _eq(t2["count"], r2["count"])


def test_tier_counters():
    rng = np.random.default_rng(3)
    n, chunk = 2048, 256
    rows = _rows(n, seed=3)
    rows["k"] = rng.integers(0, 3, n).astype(np.int32)
    store = SegmentStore(out_dim=D, chunk_rows=chunk, device="cpu")
    store.append_rows(rows)
    ts = TieredStore(store, seed=1, device="cpu")
    spilled = ts.spill(keep_hot=n // 2)
    tel = ts.telemetry()
    assert tel.spill_events == 1 and tel.spilled_rows == spilled
    assert tel.n_rows == n and tel.dequantize_events == 0
    plan = (GroupBy("category", "quality", agg="mean", num_groups=4),)
    ts.query(plan)
    d1 = ts.telemetry().dequantize_events
    assert d1 == 1
    ts.query(plan)                       # the view is memoized: no miss
    assert ts.telemetry().dequantize_events == d1
    assert ts.telemetry().query_dispatches == 2
    ts.spill(keep_hot=0)
    ts.query(plan)
    tel = ts.telemetry()
    assert tel.spill_events == 2 and tel.dequantize_events == 2
    assert tel.spilled_rows == ts.n_cold
    assert "spills=2 dequantizes=2" in tel.summary()
