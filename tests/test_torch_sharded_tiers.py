"""The port's sharded cold tier (``warehouse.tiers.ShardedTieredStore``)
against the reference's on its stacked single-device path
(``mesh=None``), on the CPU.

- Spills with the reference's own uniform draws (``spill(draws=)``, the
  ``jax.random`` keys its ``_quantize_chunks_sharded`` splits): the
  stacked cold codes, scales and integer columns (junk rows past each
  shard's valid depth included), the compacted hot columns, the
  per-shard depths, the cold capacity and the two-tier view
  (``shard_source``) equal the reference's bit for bit, and so do the
  queries over the view on both of the port's paths. The cases are the
  reference's own (tests/test_sharded_warehouse.py:326-396): a ragged
  spill with empty shards, then an imbalanced second spill, and a
  shallow spill beside a shard whose cold tier sits at capacity.
- With the port's own draws: answers within the quantization bound of
  the unspilled rows (``max_cold_scale`` per mean, counts exact), the
  spill guard, the memoized view, standing answers unchanged bit for
  bit by a spill (tests/test_standing.py:255) with later folds equal to
  the reference registry's, and the flight recorder's per-shard rows
  over both tiers.
"""
import jax
import numpy as np
import pytest
import torch

import repro.warehouse as RW
from _torch_parity import ref_plan
from repro.warehouse.query import execute_ref
from repro_torch.warehouse import (Filter, GroupBy, ShardedStore,
                                   ShardedTieredStore, StandingQueries, TopK,
                                   WindowAgg)
from test_torch_sharded import _eq, _rows, _same_answer
from _torch_threads import cap_torch_threads

cap_torch_threads()

D = 2


def _ref_draws(seed, spills, n_shards):
    """The reference tier's uniforms for its spill number ``spills``."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), spills)
    shard_keys = jax.random.split(key, n_shards)

    def draws(name, S, n_chunks, width):
        assert S == n_shards
        out = [jax.vmap(lambda k: jax.random.uniform(k, (width,)))(
            jax.random.split(k, n_chunks)) for k in shard_keys]
        return torch.tensor(np.stack([np.asarray(o) for o in out]))
    return draws


class Pair:
    """One sharded tier on each side, the same rows landed in both."""

    def __init__(self, n_shards, chunk, seed):
        self.rhot = RW.ShardedStore(out_dim=D, n_shards=n_shards,
                                    chunk_rows=chunk, mesh=None)
        self.phot = ShardedStore(out_dim=D, n_shards=n_shards,
                                 chunk_rows=chunk, device="cpu")
        self.rt = RW.ShardedTieredStore(self.rhot, seed=seed)
        self.pt = ShardedTieredStore(self.phot, seed=seed, device="cpu")
        self.seed, self.S, self.rows = seed, n_shards, []

    def append(self, rows):
        self.rhot.append_rows(rows)
        self.phot.append_rows(rows)
        self.rows.append(rows)

    def spill(self, keep_hot):
        draws = _ref_draws(self.seed, self.pt._spills, self.S)
        got = self.pt.spill(keep_hot, draws=draws)
        assert got == self.rt.spill(keep_hot)
        return got

    def all_rows(self):
        return {k: np.concatenate([r[k] for r in self.rows])
                for k in self.rows[0]}

    def check(self):
        """Every array of both tiers and the view, bit for bit."""
        rt, pt = self.rt, self.pt
        _eq(pt.n_cold_by_shard, rt.n_cold_by_shard)
        _eq(pt.hot.n_rows_by_shard, rt.hot.n_rows_by_shard)
        assert pt.cold_capacity == rt.cold_capacity
        for mine, theirs in ((pt.cold_q, rt.cold_q),
                             (pt.cold_scales, rt.cold_scales),
                             (pt.cold_int, rt.cold_int),
                             (pt.hot.columns, rt.hot.columns)):
            assert set(mine) == set(theirs)
            for k in theirs:
                _eq(mine[k], theirs[k], k)
        (pc, pn), (rc, rn) = pt.shard_source(), rt.shard_source()
        _eq(pn, rn)
        for k in rc:
            _eq(pc[k], rc[k], k)
        ptel, rtel = pt.telemetry(), rt.telemetry()
        for key in ("spill_events", "spilled_rows", "dequantize_events",
                    "ingest_dispatches", "lag_rows", "imbalance"):
            assert getattr(ptel, key) == getattr(rtel, key), key
        _eq(ptel.rows_by_shard, rtel.rows_by_shard)


def _plans(nw):
    return ((GroupBy("category", "quality", agg="mean", num_groups=4),),
            (Filter("on_core_s", "gt", 5.0),
             GroupBy("k", "buffer_s", agg="sum", num_groups=4)),
            (WindowAgg(256, "cloud_core_s", agg="max", num_windows=nw),),
            (GroupBy("category", "out", agg="sum", num_groups=4),),
            (Filter("quality", "ge", 0.5), TopK(6, by="on_core_s")))


def _queries(pair):
    nw = pair.pt.t_max // 256 + 1
    for plan in _plans(nw):
        want = pair.rt.query(ref_plan(plan))
        for uk in (False, None):
            _same_answer(pair.pt.query(plan, use_kernel=uk), want,
                         (plan, uk))


def test_ragged_spill_with_empty_shards_matches_the_reference():
    pair = Pair(8, 256, seed=2)
    rows = _rows(2000, seed=31, d=D)
    rows["stream_id"] = (np.arange(2000, dtype=np.int32) % 2) * 4
    pair.append(rows)
    assert pair.spill(0) == 2 * (1000 // 256) * 256     # both live shards
    assert pair.pt.n_cold_by_shard[[1, 2, 3, 5, 6, 7]].sum() == 0
    pair.check()
    _queries(pair)
    # an imbalanced second spill: only shard 0 receives new rows
    more = _rows(600, seed=32, t0=2000, d=D)
    more["stream_id"] = np.zeros(600, np.int32)
    pair.append(more)
    assert pair.spill(0) == (832 // 256) * 256
    assert pair.pt.n_cold_by_shard[0] == 768 + 768
    pair.check()
    _queries(pair)


def test_shallow_spill_beside_a_deep_shard_matches_the_reference():
    """tests/test_sharded_warehouse.py:396: shard 0's cold tier sits
    exactly at capacity when a later spill moves rows of shard 1 only;
    the whole d_max write block stays inside the reserved capacity."""
    chunk = 256
    pair = Pair(2, chunk, seed=3)

    def add(n, stream, t0, seed):
        rows = _rows(n, seed=seed, t0=t0, d=D)
        rows["stream_id"] = np.full(n, stream, np.int32)
        pair.append(rows)

    add(8 * chunk, 0, 0, 41)
    add(100, 1, 8 * chunk, 42)
    assert pair.spill(0) == 8 * chunk
    add(8 * chunk, 0, 8 * chunk + 100, 43)
    assert pair.spill(0) == 8 * chunk
    assert pair.pt.n_cold_by_shard[0] == pair.pt.cold_capacity == 16 * chunk
    add(chunk, 1, 17 * chunk, 44)
    assert pair.spill(0) == chunk
    assert pair.pt.cold_capacity >= pair.pt.n_cold_by_shard[0] + chunk
    pair.check()
    _queries(pair)
    plan = (GroupBy("category", "quality", agg="count", num_groups=4),)
    rows = pair.all_rows()
    (t, _), (rt, _) = (pair.pt.query(plan),
                       execute_ref(rows, len(rows["t"]), ref_plan(plan)))
    _eq(t["count"], rt["count"])


def test_own_draws_within_the_quantization_bound():
    pair = Pair(4, 128, seed=1)
    rows = _rows(4096, seed=12, d=D)
    rows["stream_id"] = (np.arange(4096, dtype=np.int32) * 7) % 16
    pair.append(rows)
    ts = pair.pt
    spilled = ts.spill(keep_hot=300)
    assert spilled > 0 and spilled % (128 * 4) == 0 and ts.n_rows == 4096
    with pytest.raises(AssertionError):
        ts.spill(-1)
    plan = (GroupBy("category", "quality", agg="mean", num_groups=4),)
    (t, _), (rt, _) = ts.query(plan), execute_ref(rows, 4096,
                                                  ref_plan(plan))
    _eq(t["count"], rt["count"])
    np.testing.assert_allclose(t["quality"].numpy(), rt["quality"],
                               atol=ts.max_cold_scale() + 1e-4)
    # the view is memoized until an ingest or a spill
    c1, _ = ts.shard_source()
    c2, _ = ts.shard_source()
    assert c1 is c2 and ts.telemetry().dequantize_events == 1
    ts.hot.append_rows(_rows(8, seed=13, t0=5000, d=D))
    c3, n3 = ts.shard_source()
    assert c3 is not c1 and int(n3.sum()) == ts.n_rows == 4096 + 8
    tel = ts.telemetry()
    assert (tel.spill_events, tel.spilled_rows) == (1, spilled)
    _eq(tel.rows_by_shard, ts.hot.n_rows_by_shard + ts.n_cold_by_shard)


@pytest.mark.parametrize("use_kernel", (False, None))
def test_standing_answers_are_spill_invariant(use_kernel):
    pair = Pair(2, 128, seed=3)
    rreg = RW.StandingQueries(pair.rt)
    preg = StandingQueries(pair.pt)
    plans = ((GroupBy("category", "quality", agg="max", num_groups=4),),
             (Filter("quality", "ge", 0.25),
              GroupBy("category", "on_core_s", agg="sum", num_groups=4)))
    handles = [(rreg.register(ref_plan(p)),
                preg.register(p, use_kernel=use_kernel)) for p in plans]
    pair.append(_rows(1024, seed=18, d=D))
    before = [preg.answer(ph) for _, ph in handles]
    assert pair.spill(256) > 0
    for (_, ph), (bt, bm) in zip(handles, before):
        _same_answer(preg.answer(ph), (bt, bm))
    pair.append(_rows(300, seed=19, t0=1024, d=D))
    for (rh, ph), plan in zip(handles, plans):
        got, want = preg.answer(ph), rreg.answer(rh)
        if use_kernel is False or plan[-1].agg == "max":
            _same_answer(got, want, plan)
        else:
            _eq(got[1], want[1])
            np.testing.assert_allclose(got[0]["on_core_s"].numpy(),
                                       np.asarray(want[0]["on_core_s"]),
                                       rtol=1e-5, atol=1e-4)
    # a plan registered after the spill backfills over the two-tier view
    late = (GroupBy("k", "quality", agg="sum", num_groups=4),)
    _same_answer(preg.answer(preg.register(late, use_kernel=False)),
                 rreg.answer(rreg.register(ref_plan(late))))
