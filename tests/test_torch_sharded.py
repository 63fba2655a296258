"""The port's sharded warehouse (``warehouse.store.ShardedStore``,
``warehouse.query.execute_sharded``, the sharded ``StandingQueries``,
``runtime.elastic.rebalance`` and the sharded sinks) against the
reference's stacked single-device path (``mesh=None``) on the CPU.

The same numpy rows, made from a seed, land in a reference
``ShardedStore`` and a port one, and the cases mirror the reference's
own oracles:

- routing, growth and the sinks (tests/test_sharded_warehouse.py:43-146,
  tests/test_obs_telemetry.py:137): every stored row, shard by shard,
  and each shard's capacity equal the reference's bit for bit; the
  fused single- and multi-stream runs, the pool tick (plain and
  masked) and ``append_rows`` as sinks; the store's flight recorder;
- queries (:153-281): against the reference's sharded answers bit for
  bit on both of the port's paths, since each shard's partial adds in
  row order (the engine's scatter and K1's plain version alike) and the
  merge adds the shards in the reference's order (``query._merge_sum``);
  against ``execute_ref`` of the unsharded rows within the reference's
  own rtol 1e-5, atol 1e-4 for float sums (a different grouping of the
  same float32 sum), exactly for counts, masks, max and min; one shard
  bit for bit with the single store; an empty store's row TopK as the
  single store answers it;
- the compressed merge (:303): bit for bit given the reference's
  draws on partials of two or more elements (a one-element partial
  compiles to another program in the reference; it is held to the
  bound), and within the reference's bound S * (max|ref| / 127 + 1e-3)
  with the port's own draws;
- standing queries (tests/test_standing.py:261-407): on the engine path
  (``use_kernel=False``) the answers equal the reference registry's bit
  for bit, since each shard folds its own rows in order; on K1's path
  (its plain version here) within rtol 1e-5, atol 1e-4 of them, each
  delta being summed from zero before it is added (the tolerance
  tests/test_torch_standing.py states); one shard equal to the single
  store;
- ``rebalance`` (tests/test_pool_elastic.py:327-394): the new stores'
  rows, counts and capacities equal the reference's bit for bit, the
  ownership law holds, the registry replays with its handles, and the
  pool's sharded sink repartitions end to end.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.warehouse as RW
from _torch_parity import port_fitted, ref_fitted, ref_plan
from repro.configs.workloads import COVID
from repro.core import ingest as RI
from repro.data.stream import generate
from repro.runtime.elastic import rebalance as ref_rebalance
from repro.warehouse.query import execute_ref
from repro_torch.configs.workloads import COVID as P_COVID
from repro_torch.core import ingest as PI
from repro_torch.data.stream import generate as p_generate
from repro_torch.runtime.elastic import rebalance
from repro_torch.warehouse import (Filter, GroupBy, MultiGroupBy, Project,
                                   SegmentStore, ShardedStore,
                                   StandingQueries, TopK, WindowAgg, to_host,
                                   windows_for)
from repro_torch.warehouse import query as Q
from _torch_threads import cap_torch_threads

cap_torch_threads()

D = 3


def _rows(n, seed=0, t0=0, d=D, streams=None):
    """``tests/test_warehouse.py``'s ``_random_rows``; ``streams`` sets
    the stream ids as ``tests/test_sharded_warehouse.py``'s ``_stores``
    does."""
    rng = np.random.default_rng(seed)
    rows = {
        "stream_id": rng.integers(0, 4, n).astype(np.int32),
        "t": (t0 + np.arange(n)).astype(np.int32),
        "category": rng.integers(0, 4, n).astype(np.int32),
        "k": rng.integers(0, d, n).astype(np.int32),
        "quality": rng.random(n).astype(np.float32),
        "on_core_s": (rng.random(n) * 20).astype(np.float32),
        "cloud_core_s": (rng.random(n) * 5).astype(np.float32),
        "buffer_s": (rng.random(n) * 40).astype(np.float32),
        "out": rng.random((n, d)).astype(np.float32),
    }
    if streams is not None:
        rows["stream_id"] = (np.arange(n, dtype=np.int32) * 7) % streams
    return rows


def _ref(rows, n, plan):
    """``execute_ref`` of the reference over host rows."""
    return execute_ref(rows, n, ref_plan(plan))


def _eq(a, b, msg=""):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(msg))


def _pair(n_shards, chunk):
    return (RW.ShardedStore(out_dim=D, n_shards=n_shards, chunk_rows=chunk,
                            mesh=None),
            ShardedStore(out_dim=D, n_shards=n_shards, chunk_rows=chunk,
                         device="cpu"))


def _stores(n, n_shards, seed=0, chunk=256, streams=16):
    rows = _rows(n, seed=seed, streams=streams)
    rstore, pstore = _pair(n_shards, chunk)
    rstore.append_rows(rows)
    pstore.append_rows(rows)
    return rows, rstore, pstore


def _same_rows(rstore, pstore):
    assert pstore.capacity == rstore.capacity
    _eq(pstore.n_rows_by_shard, rstore.n_rows_by_shard)
    rr, pr = rstore.host_rows(), pstore.host_rows()
    for k in rr:
        _eq(pr[k], rr[k], k)


def _same_answer(got, want, msg=""):
    (gt, gm), (wt, wm) = got, want
    _eq(gm, wm, msg)
    assert set(gt) == set(wt)
    for k in wt:
        _eq(gt[k], wt[k], (k, msg))


def _close_to_ref(got, ref, node, msg=""):
    """The reference's own oracle (tests/test_sharded_warehouse.py:177):
    masks and counts exact, max / min exact, float sums within rtol
    1e-5, atol 1e-4 of ``execute_ref``."""
    (gt, gm), (rt, rm) = got, ref
    _eq(gm, rm, msg)
    _eq(gt["count"], rt["count"], msg)
    if node.agg in ("max", "min", "count"):
        _eq(gt[node.value], rt[node.value], msg)
    else:
        np.testing.assert_allclose(gt[node.value].numpy(), rt[node.value],
                                   rtol=1e-5, atol=1e-4, err_msg=str(msg))


# ---------------------------------------------------------------------------
# routing, growth, sinks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", (1, 3, 4))
def test_append_routes_by_stream_hash(n_shards):
    rows, rstore, pstore = _stores(3000, n_shards)
    _same_rows(rstore, pstore)
    h, off = pstore.host_rows(), 0
    for s in range(n_shards):
        blk = slice(off, off + pstore.n_rows_by_shard[s])
        assert (h["stream_id"][blk] % n_shards == s).all()
        assert (np.diff(h["t"][blk]) > 0).all()      # append order kept
        off += pstore.n_rows_by_shard[s]
    assert sorted(h["t"].tolist()) == sorted(rows["t"].tolist())
    assert pstore.telemetry().summary() == rstore.telemetry().summary()


def test_growth_is_chunk_aligned_like_the_reference():
    rstore, pstore = _pair(2, 100)
    for i in range(4):
        rows = _rows(130, seed=i, t0=130 * i)
        rstore.append_rows(rows)
        pstore.append_rows(rows)
        assert pstore.capacity == rstore.capacity
    assert pstore.capacity % 100 == 0
    assert pstore.capacity >= pstore.n_rows_by_shard.max()
    _same_rows(rstore, pstore)


@pytest.mark.parametrize("masked", (False, True))
def test_ingest_tick_routes_like_the_reference(masked):
    """Pool ticks into 3 shards with a registry: slot v as stream v, or
    real ids with inactive slots landing nowhere; rows, folds and the
    flight recorder equal the reference's."""
    rng = np.random.default_rng(7 if masked else 8)
    V, K = 6, 5
    rstore = RW.ShardedStore(out_dim=K, n_shards=3, chunk_rows=8, mesh=None)
    pstore = ShardedStore(out_dim=K, n_shards=3, chunk_rows=8, device="cpu")
    plan = (GroupBy("stream_id", "quality", agg="sum", num_groups=64),)
    rh = RW.StandingQueries(rstore).register(ref_plan(plan))
    ph = StandingQueries(pstore).register(plan, use_kernel=False)
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
    _same_rows(rstore, pstore)
    _same_answer(pstore.standing.answer(ph), rstore.standing.answer(rh))
    assert pstore.telemetry().summary() == rstore.telemetry().summary()
    assert pstore.t_max == rstore.t_max


SUB = ((GroupBy("stream_id", "buffer_s", agg="max", num_groups=16),),
       Filter("buffer_s", "ge", 0.0))


def _registry(reg, ref: bool):
    plan, pred = SUB
    if ref:
        h = reg.register(ref_plan((Filter("quality", "gt", 0.5), GroupBy(
            "k", "on_core_s", agg="sum", num_groups=16))))
        reg.subscribe(ref_plan(plan), ref_plan((pred,))[0], name="watch")
        return h
    h = reg.register((Filter("quality", "gt", 0.5), GroupBy(
        "k", "on_core_s", agg="sum", num_groups=16)), use_kernel=False)
    reg.subscribe(plan, pred, name="watch", use_kernel=False)
    return h


@functools.lru_cache(maxsize=None)
def _multi_runs():
    """Three streams of one fit through the fused multi-stream run into a
    4-shard sink from stream id 10, the recorder on, on both sides."""
    rf, pf = ref_fitted(), port_fitted()
    r_streams = [generate(COVID, days=0.02, seed=60 + v) for v in range(3)]
    p_streams = [p_generate(P_COVID, days=0.02, seed=60 + v)
                 for v in range(3)]
    K = len(rf.configs)
    rstore = RW.ShardedStore(out_dim=K, n_shards=4, chunk_rows=256,
                             mesh=None)
    pstore = ShardedStore(out_dim=K, n_shards=4, chunk_rows=256,
                          device="cpu")
    rh = _registry(RW.StandingQueries(rstore), True)
    ph = _registry(StandingQueries(pstore), False)
    kw = dict(n_cores_each=8, cloud_budget_core_s=900.0, plan_days=0.01,
              sink_stream_base=10, telemetry=True)
    ref = RI.run_skyscraper_multi([rf] * 3, r_streams, sink=rstore, **kw)
    got = PI.run_skyscraper_multi([pf] * 3, p_streams, sink=pstore,
                                  device="cpu", **kw)
    return ref, got, rstore, pstore, rh, ph


def test_multi_stream_sink_shards_like_the_reference():
    ref, got, rstore, pstore, rh, ph = _multi_runs()
    _same_rows(rstore, pstore)
    # streams 12, 10 and 11 on shards 0, 2 and 3; shard 1 empty
    h = pstore.host_rows()
    n = pstore.n_rows_by_shard
    assert n[1] == 0 and n[0] == n[2] == n[3]
    _eq(h["stream_id"], np.repeat([12, 10, 11], n[0]))
    assert got["per_stream_pct"] == ref["per_stream_pct"]
    _same_answer(pstore.standing.answer(ph), rstore.standing.answer(rh))
    assert [a.name for a in got["alerts"]] == [a.name for a in
                                               ref["alerts"]] == ["watch"]
    _eq(got["alerts"][0].fired, ref["alerts"][0].fired)


def test_multi_stream_telemetry_with_sharded_sink():
    """tests/test_obs_telemetry.py:137 on the port: per-shard rows,
    the imbalance of empty shards, the batch lag."""
    ref, got, rstore, pstore, _, _ = _multi_runs()
    stel, rtel = pstore.telemetry(), rstore.telemetry()
    T = pstore.n_rows // 3
    assert stel.summary() == rtel.summary()
    _eq(stel.rows_by_shard, rtel.rows_by_shard)
    assert (stel.rows_by_shard == 0).sum() == 1
    assert stel.imbalance == rtel.imbalance == 4 / 3
    assert stel.ingest_dispatches == 1 and stel.lag_rows == 3 * T
    assert stel.lag_max_ticks == T - 1
    assert stel.lag_sum_ticks == 3 * (T * (T - 1) // 2)
    for key in got["telemetry"].counters:
        _eq(got["telemetry"].counters[key], ref["telemetry"].counters[key],
            key)


def test_single_stream_fused_sink_owns_one_shard():
    rf, pf = ref_fitted(), port_fitted()
    K = len(rf.configs)
    tau = COVID.segment_seconds
    rstore = RW.ShardedStore(out_dim=K, n_shards=4, chunk_rows=128,
                             mesh=None)
    pstore = ShardedStore(out_dim=K, n_shards=4, chunk_rows=128,
                          device="cpu")
    rh = _registry(RW.StandingQueries(rstore), True)
    ph = _registry(StandingQueries(pstore), False)
    kw = dict(n_cores=8, plan_days=64.5 * tau / 86400,
              forecast_mode="uniform", sink_stream_id=6)
    ref = RI.run_skyscraper_fused(rf, generate(COVID, days=0.01, seed=7),
                                  sink=rstore, **kw)
    got = PI.run_skyscraper_fused(pf, p_generate(P_COVID, days=0.01, seed=7),
                                  sink=pstore, device="cpu", **kw)
    T = pstore.n_rows
    assert pstore.n_rows_by_shard[6 % 4] == T
    _same_rows(rstore, pstore)
    _eq(pstore.host_rows()["t"], np.arange(T, dtype=np.int32))
    _same_answer(pstore.standing.answer(ph), rstore.standing.answer(rh))
    assert [a.name for a in got.alerts] == [a.name for a in ref.alerts]
    _eq(got.alerts[0].fired, ref.alerts[0].fired)


# ---------------------------------------------------------------------------
# the partial / merge engine
# ---------------------------------------------------------------------------

def _plans(nw):
    return (
        (Filter("quality", "ge", 0.4), Filter("stream_id", "ne", 3),
         WindowAgg(window=250, value="on_core_s", agg="mean",
                   num_windows=nw), TopK(7, by="on_core_s")),
        (Filter("buffer_s", "lt", 30.0),
         GroupBy("category", "cloud_core_s", agg="sum", num_groups=4)),
        (Project(("t", "quality", "k")), Filter("quality", "le", 0.9),
         TopK(11, by="quality", largest=False)),
        (Filter("stream_id", "eq", 5), TopK(9, by="quality")),
        (Filter("quality", "ge", 0.5), Project(("t", "quality"))),
        (Filter("quality", "ge", 0.3),
         MultiGroupBy(keys=("t", "category"), value="on_core_s", agg="mean",
                      nums=(nw, 4), windows=(500, 0)),
         TopK(5, by="on_core_s")),
        (GroupBy("category", "out", agg="sum", num_groups=4),),
        (GroupBy("category", "k", agg="sum", num_groups=4),),
    ) + tuple((Filter("quality", "ge", 0.2),
               GroupBy("category", "on_core_s", agg=agg, num_groups=4))
              for agg in ("sum", "mean", "count", "max", "min"))


@pytest.mark.parametrize("n_shards,seed", ((1, 2), (3, 4), (4, 3), (8, 5)))
def test_queries_match_the_reference(n_shards, seed):
    rows, rstore, pstore = _stores(4000, n_shards, seed=seed)
    single = SegmentStore(out_dim=D, chunk_rows=256, device="cpu")
    single.append_rows(rows)
    nw = windows_for(pstore, 250)
    for plan in _plans(nw):
        want = rstore.query(ref_plan(plan))
        for uk in (False, None):
            _same_answer(pstore.query(plan, use_kernel=uk), want,
                         (plan, uk))
        _, node, _ = Q.split_plan(plan)
        if node is not None and not isinstance(node, TopK):
            _close_to_ref(pstore.query(plan), _ref(rows, 4000, plan),
                          node, plan)
        if n_shards == 1:
            # one shard is the single store, bit for bit (but a TopK's
            # row index, which is global)
            got, one = pstore.query(plan), single.query(plan)
            _eq(got[1], one[1])
            for k in one[0]:
                _eq(got[0][k], one[0][k], (k, plan))


def test_kernel_path_counts_one_query_and_takes_k1():
    _, _, pstore = _stores(500, 4)
    plan = (GroupBy("category", "quality", agg="mean", num_groups=4),)
    Q.PATHS.update(kernel=0, engine=0)
    pstore.query(plan)
    pstore.query(plan, use_kernel=False)
    pstore.query((TopK(3, by="quality"),))
    assert Q.PATHS == {"kernel": 1, "engine": 1}
    with pytest.raises(ValueError, match="cannot run"):
        pstore.query((TopK(3, by="quality"),), use_kernel=True)


def test_row_plan_and_topk_survivors_against_execute_ref():
    rows, _, pstore = _stores(3000, 3, seed=4)
    plan = (Filter("stream_id", "eq", 5), TopK(9, by="quality"))
    (t, m), (rt, rm) = pstore.query(plan), _ref(rows, 3000, plan)
    assert int(m.sum()) == int(rm.sum())
    got = sorted(zip(t["t"][m].tolist(), t["quality"][m].tolist()))
    want = sorted(zip(rt["t"][rm].tolist(), rt["quality"][rm].tolist()))
    assert got == want
    plan = (Filter("quality", "ge", 0.5), Project(("t", "quality")))
    got, want = to_host(*pstore.query(plan)), _ref(rows, 3000, plan)
    want = {k: v[want[1]] for k, v in want[0].items()}
    assert sorted(got["t"].tolist()) == sorted(want["t"].tolist())


def test_empty_shards_and_empty_store():
    rows = _rows(500, seed=8)
    rows["stream_id"] = (np.arange(500, dtype=np.int32) % 2) * 4
    rstore, pstore = _pair(8, 64)
    rstore.append_rows(rows)
    pstore.append_rows(rows)
    assert pstore.n_rows_by_shard[[1, 2, 3, 5, 6, 7]].sum() == 0
    for plan in ((GroupBy("category", "quality", agg="mean",
                          num_groups=4),),
                 (Filter("quality", "gt", 2.0),
                  GroupBy("category", "quality", agg="sum", num_groups=4),
                  TopK(3, by="quality")),
                 (TopK(4, by="quality"),)):
        for uk in (False, None):
            _same_answer(pstore.query(plan, use_kernel=uk),
                         rstore.query(ref_plan(plan)), plan)
    assert not pstore.query(plan[:0] + (Filter("quality", "gt", 2.0),
                                        GroupBy("category", "quality",
                                                num_groups=4)))[1].any()
    # an empty store: a row TopK answers as the single store does
    for n_shards in (1, 4):
        empty = ShardedStore(out_dim=D, n_shards=n_shards, chunk_rows=64,
                             device="cpu")
        one = SegmentStore(out_dim=D, chunk_rows=64, device="cpu")
        for plan in ((TopK(3, by="quality"),),
                     (GroupBy("category", "quality", agg="max",
                              num_groups=4),)):
            (t, m), (t1, m1) = empty.query(plan), one.query(plan)
            _eq(m, m1)
            for k in t1:
                _eq(t[k], t1[k], k)


def _ref_draws(n_shards, shape, seed=0):
    import jax
    keys = jax.random.split(jax.random.PRNGKey(seed), n_shards)
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape))(keys))


@pytest.mark.parametrize("n_shards", (2, 4))
def test_compressed_merge(n_shards):
    rows, rstore, pstore = _stores(4000, n_shards, seed=11)
    for plan, shape in (((GroupBy("category", "out", agg="sum",
                                  num_groups=4),), (4, D)),
                        ((WindowAgg(500, "quality", agg="mean",
                                    num_windows=8),), (8,))):
        want = rstore.query(ref_plan(plan), compressed=True)
        draws = _ref_draws(n_shards, shape)
        for uk in (False, None):
            _same_answer(pstore.query(plan, compressed=True, draws=draws,
                                      use_kernel=uk), want, plan)
    # the port's own draws: counts exact, sums within the bound
    plan = (GroupBy("category", "out", agg="sum", num_groups=4),)
    (t, _), (rt, _) = (pstore.query(plan, compressed=True, seed=3),
                       _ref(rows, 4000, plan))
    _eq(t["count"], rt["count"])
    bound = n_shards * (np.abs(rt["out"]).max() / 127 + 1e-3)
    assert np.abs(t["out"].numpy() - rt["out"]).max() <= bound


# ---------------------------------------------------------------------------
# standing queries on a sharded store
# ---------------------------------------------------------------------------

STANDING = (
    (Filter("quality", "ge", 0.3),
     GroupBy("category", "quality", agg="sum", num_groups=4)),
    (GroupBy("category", "quality", agg="max", num_groups=4),),
    (WindowAgg(window=128, value="on_core_s", agg="count", num_windows=8),),
    (MultiGroupBy(keys=("k", "category"), value="out", agg="mean",
                  nums=(D, 4), windows=(0, 0)),),
)


@pytest.mark.parametrize("use_kernel", (False, None))
def test_sharded_standing_matches_the_reference(use_kernel):
    """Registered over 400 rows (a backfill per shard), then two ingests
    folding each shard's own rows; a bucket crossing on the way."""
    rstore, pstore = _pair(2, 256)
    rows0 = _rows(400, seed=21)
    rstore.append_rows(rows0)
    pstore.append_rows(rows0)
    rreg, preg = RW.StandingQueries(rstore), StandingQueries(pstore)
    handles = [(rreg.register(ref_plan(p)),
                preg.register(p, use_kernel=use_kernel)) for p in STANDING]
    handles.append((rreg.register(ref_plan(STANDING[0][1:])),
                    preg.register(STANDING[0][1:], use_kernel=use_kernel)))
    for i, seed in enumerate((22, 23)):
        rows = _rows(300, seed=seed, t0=400 + 300 * i)
        rstore.append_rows(rows)
        pstore.append_rows(rows)
    for (rh, ph), plan in zip(handles, STANDING + (STANDING[0][1:],)):
        got, want = preg.answer(ph), rreg.answer(rh)
        _, node, _ = Q.split_plan(plan)
        if use_kernel is False or node.agg in ("max", "min", "count"):
            _same_answer(got, want, plan)
        else:
            _eq(got[1], want[1])
            for k in want[0]:
                np.testing.assert_allclose(got[0][k].numpy(),
                                           np.asarray(want[0][k]),
                                           rtol=1e-5, atol=1e-4)
        # and the rescan of the same store
        _close_to_ref(got, _ref(pstore.host_rows(), pstore.n_rows,
                                       plan), node, plan)
    assert preg._group_of(preg._queries[handles[0][1]]).use_kernel == (
        use_kernel is None)
    assert pstore.telemetry().summary() == rstore.telemetry().summary()


def test_sharded_one_shard_equals_single_store():
    rows0, rows1 = _rows(200, seed=24), _rows(150, seed=25, t0=200)
    plan = (Filter("quality", "lt", 0.7),
            GroupBy("category", "quality", agg="sum", num_groups=4))
    answers = []
    for store in (SegmentStore(out_dim=D, chunk_rows=128, device="cpu"),
                  ShardedStore(out_dim=D, n_shards=1, chunk_rows=128,
                               device="cpu")):
        store.append_rows(rows0)
        reg = StandingQueries(store)
        h = reg.register(plan, use_kernel=False)
        store.append_rows(rows1)
        answers.append(reg.answer(h))
    _same_answer(answers[1], answers[0])


# ---------------------------------------------------------------------------
# rebalance
# ---------------------------------------------------------------------------

def _sorted_rows(hr):
    order = np.lexsort((hr["t"], hr["quality"], hr["stream_id"]))
    return {k: v[order] for k, v in hr.items()}


@pytest.mark.parametrize("s_old,s_new", ((2, 4), (2, 8), (4, 2), (3, 1)))
def test_rebalance_matches_the_reference(s_old, s_new):
    rows = _rows(57)
    rstore = RW.ShardedStore(out_dim=D, n_shards=s_old, chunk_rows=8,
                             mesh=None)
    pstore = ShardedStore(out_dim=D, n_shards=s_old, chunk_rows=8,
                          device="cpu")
    rstore.append_rows(rows)
    pstore.append_rows(rows)
    new = rebalance(pstore, s_new, device="cpu")
    _same_rows(ref_rebalance(rstore, s_new, mesh=None), new)
    a, b = _sorted_rows(pstore.host_rows()), _sorted_rows(new.host_rows())
    for k in a:
        _eq(b[k], a[k], k)
    ids = new.columns["stream_id"].numpy()
    for s in range(s_new):
        assert (ids[s, :new.n_rows_by_shard[s]] % s_new == s).all()
    assert pstore.n_shards == s_old and len(pstore) == 57 == len(new)


def test_rebalance_replays_the_registry():
    rstore, pstore = _pair(2, 8)
    rreg, preg = RW.StandingQueries(rstore), StandingQueries(pstore)
    plan = (GroupBy("category", "quality", agg="sum", num_groups=4),)
    sub = (GroupBy("k", "quality", agg="sum", num_groups=4),)
    pred = Filter("quality", "gt", 0.5)
    rh = rreg.register(ref_plan(plan))
    ph = preg.register(plan, use_kernel=False)
    rreg.subscribe(ref_plan(sub), ref_plan((pred,))[0], name="hot-k")
    preg.subscribe(sub, pred, name="hot-k", use_kernel=False)
    rows = _rows(43, seed=3)
    rstore.append_rows(rows)
    pstore.append_rows(rows)
    rnew, pnew = ref_rebalance(rstore, 4, mesh=None), rebalance(
        pstore, 4, device="cpu")
    assert ph == rh
    _same_answer(pnew.standing.answer(ph), rnew.standing.answer(rh))
    alerts, ralerts = pnew.standing.poll(), rnew.standing.poll()
    assert [a.name for a in alerts] == [a.name for a in ralerts] == ["hot-k"]
    _eq(alerts[0].fired, ralerts[0].fired)
    q = (Filter("quality", "gt", 0.3),
         GroupBy("category", "quality", agg="mean", num_groups=4))
    _same_answer(pnew.query(q), rnew.query(ref_plan(q)))
    (t0, m0), (t1, m1) = pstore.query(q), pnew.query(q)
    _eq(m0, m1)
    _eq(t0["count"], t1["count"])
    np.testing.assert_allclose(t0["quality"].numpy(), t1["quality"].numpy(),
                               rtol=1e-5, atol=1e-5)


def test_rebalance_roundtrip_through_one_shard():
    rows = _rows(29, seed=5)
    pstore = ShardedStore(out_dim=D, n_shards=4, chunk_rows=8, device="cpu")
    pstore.append_rows(rows)
    back = rebalance(rebalance(pstore, 1, device="cpu"), 4, device="cpu")
    a, b = _sorted_rows(pstore.host_rows()), _sorted_rows(back.host_rows())
    for k in a:
        _eq(b[k], a[k], k)
    _eq(back.n_rows_by_shard, pstore.n_rows_by_shard)


def test_pool_sink_rebalance_end_to_end():
    """admit -> tick -> retire -> rebalance through a 2-shard sink on
    both pools (tests/test_pool_elastic.py:394): rows and alerts equal
    the reference's, each stream's history moves to its new owner."""
    from test_torch_pool import _skies
    from repro.core import api as RA
    from repro_torch.core import api as PA
    r, p = _skies("elastic")
    K = len(r.configs)
    rsink = RW.ShardedStore(out_dim=K, n_shards=2, chunk_rows=32, mesh=None)
    psink = ShardedStore(out_dim=K, n_shards=2, chunk_rows=32, device="cpu")
    watch = (GroupBy("stream_id", "quality", agg="min", num_groups=16),)
    RW.StandingQueries(rsink).subscribe(
        ref_plan(watch), ref_plan((Filter("quality", "le", 0.6),))[0])
    StandingQueries(psink).subscribe(watch, Filter("quality", "le", 0.6))
    rpool = RA.SkyscraperPool(r, n_streams=2, sink=rsink)
    ppool = PA.SkyscraperPool(p, n_streams=2, sink=psink, device="cpu")
    for pool in (rpool, ppool):
        pool.admit(9)
    for n in (4, 2):
        for _ in range(n):
            rpool.process([np.zeros(3)] * rpool.V)
            ppool.process([np.zeros(3)] * ppool.V)
            _eq(ppool.alerts[0].fired, rpool.alerts[0].fired)
        if n == 4:
            rpool.retire(1)
            ppool.retire(1)
    assert len(psink) == len(rsink) == 3 * 4 + 2 * 2
    _same_rows(rsink, psink)
    new = rebalance(psink, 4, device="cpu")
    _same_rows(ref_rebalance(rsink, 4, mesh=None), new)
    assert set(new.host_rows()["stream_id"].tolist()) == {0, 1, 9}
