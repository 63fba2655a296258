"""The port's standing queries (``repro_torch.warehouse.standing``)
against the reference's single-store ``StandingQueries`` on the CPU.

Each test mirrors a single-store test of ``tests/test_standing.py`` on
the same numpy rows, made from a seed, landed in a reference store and
a port store:

- on the engine path (``use_kernel=False``) standing answers are
  bit-exact against the reference registry's answers and against
  ``execute_ref`` over the same rows, float sums included: the fold
  continues each group's float32 addition sequence (``index_add_`` adds
  in row order on the CPU, as the reference's scatter does);
- on K1's path (``use_kernel=None`` on CPU columns: the kernel's plain
  version computes each ingest's delta, added to the stored partial)
  counts, max and min are exact and float sums lie within rtol 1e-5,
  atol 1e-4 of the rescan (the tolerance
  ``tests/test_standing_properties.py`` holds the reference's kernel
  delta path to): each delta is summed from zero and then added, a
  regrouping of the same float32 sum.
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.warehouse as RW
from _torch_parity import port_fitted, ref_fitted, ref_plan
from repro.configs.workloads import COVID
from repro.core import ingest as RI
from repro.data.stream import generate
from repro_torch.configs.workloads import COVID as P_COVID
from repro_torch.core import ingest as PI
from repro_torch.data.stream import generate as p_generate
from repro_torch.kernels import warehouse_agg as K
from repro_torch.warehouse import (Alert, Filter, GroupBy, MultiGroupBy,
                                   SegmentStore, StandingQueries, TopK,
                                   WindowAgg)
from repro_torch.warehouse import query as Q
from repro_torch.warehouse import standing as S
from _torch_threads import cap_torch_threads

cap_torch_threads()

D = 3


def _rows(n, seed=0, t0=0, d=D):
    """``tests/test_warehouse.py``'s ``_random_rows``."""
    rng = np.random.default_rng(seed)
    return {
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


class Pair:
    """The same store and registry on both sides."""

    def __init__(self, chunk_rows, d=D):
        self.ref = RW.SegmentStore(out_dim=d, chunk_rows=chunk_rows)
        self.port = SegmentStore(out_dim=d, chunk_rows=chunk_rows,
                                 device="cpu")
        self.rows = []

    def append(self, rows):
        self.ref.append_rows(rows)
        self.port.append_rows(rows)
        self.rows.append(rows)

    def attach(self):
        self.rreg = RW.StandingQueries(self.ref)
        self.preg = StandingQueries(self.port)

    def register(self, plan, use_kernel=False):
        return (self.rreg.register(ref_plan(plan), use_pallas=False),
                self.preg.register(plan, use_kernel=use_kernel))

    def full(self):
        return {k: np.concatenate([r[k] for r in self.rows])
                for k in self.rows[0]}


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def _answers_equal(pair, handles, plan):
    """Port answer == reference answer == execute_ref, bit for bit."""
    (rh, ph) = handles
    table, mask = pair.preg.answer(ph)
    rtable, rmask = pair.rreg.answer(rh)
    full = pair.full()
    ref, emask = RW.execute_ref(full, len(full["t"]), ref_plan(plan))
    _eq(mask.numpy(), rmask, str(plan))
    _eq(mask.numpy(), emask, str(plan))
    assert set(table) == set(ref)
    for k in ref:
        _eq(table[k].numpy(), np.asarray(rtable[k]), f"{plan}:{k}")
        _eq(table[k].numpy(), ref[k], f"{plan}:{k}")


PLANS = [
    (Filter("quality", "ge", 0.25),
     GroupBy("category", "quality", agg="sum", num_groups=4)),
    (GroupBy("category", "quality", agg="max", num_groups=4),
     TopK(2, by="quality")),
    (WindowAgg(window=128, value="on_core_s", agg="mean", num_windows=8),),
    (MultiGroupBy(keys=("k", "category"), value="quality", agg="sum",
                  nums=(D, 4), windows=(0, 0)),),
    (MultiGroupBy(keys=("t", "category"), value="out", agg="mean",
                  nums=(8, 4), windows=(128, 0)),),
]


def test_register_then_ingest_matches_rescan_bit_exact():
    pair = Pair(256)
    pair.append(_rows(500, seed=1))
    pair.attach()
    S.FOLDS.update(kernel=0, engine=0)
    handles = [pair.register(p) for p in PLANS]
    pair.append(_rows(300, seed=2, t0=500))
    pair.append(_rows(200, seed=3, t0=800))
    for h, plan in zip(handles, PLANS):
        _answers_equal(pair, h, plan)
    # a backfill and two ingest folds per plan, all on the engine's path
    assert S.FOLDS == {"kernel": 0, "engine": 3 * len(PLANS)}
    assert pair.port.obs["standing_refreshes"] == 2


def test_registration_after_ingest_and_empty_store_seed():
    pair = Pair(128)
    pair.attach()
    plan = (Filter("quality", "lt", 0.5),
            GroupBy("category", "quality", agg="mean", num_groups=4))
    h_empty = pair.register(plan)
    pair.append(_rows(200, seed=4))
    h_mid = pair.register(plan)               # same shape: joins the group
    pair.append(_rows(150, seed=5, t0=200))
    for h in (h_empty, h_mid):
        _answers_equal(pair, h, plan)
    assert len(pair.preg._groups) == 1
    g = next(iter(pair.preg._groups.values()))
    assert (g.q, g.qb) == (2, 2)


def test_same_shape_thresholds_batch_one_group_in_buckets():
    pair = Pair(2048)
    pair.append(_rows(256, seed=6))
    pair.attach()

    def plan(thr):
        return (Filter("quality", "ge", thr),
                GroupBy("category", "quality", agg="sum", num_groups=4))

    g_sizes = []
    handles = {}
    for i, thr in enumerate((0.2, 0.5, 0.8, 0.05, 0.33)):
        handles[thr] = pair.register(plan(thr))
        g = next(iter(pair.preg._groups.values()))
        g_sizes.append((g.q, g.qb, tuple(g.state["acc"].shape)))
        pair.append(_rows(256, seed=7 + i, t0=256 * (i + 1)))
    assert g_sizes == [(1, 1, (1, 4)), (2, 2, (2, 4)), (3, 4, (4, 4)),
                       (4, 4, (4, 4)), (5, 8, (8, 4))]
    assert len(pair.preg._groups) == 1
    for thr, h in handles.items():
        _answers_equal(pair, h, plan(thr))
    # the operands stack (Q, F): the reference's rows for its live slots
    g = next(iter(pair.preg._groups.values()))
    rg = next(iter(pair.rreg._groups.values()))
    assert (g.q, g.qb) == (rg.q, rg.qb)
    for a, b in zip(g.fvals, rg.fvals_dev):
        _eq(a, np.asarray(b)[:g.q])


def test_answer_reads_no_stored_rows(monkeypatch):
    """``answer`` reads the accumulators only: with every path that
    reads rows poisoned and the columns taken away, it still answers;
    the state restored restores the earlier answer."""
    pair = Pair(64)
    pair.append(_rows(64, seed=11))
    pair.attach()
    plan = (GroupBy("category", "quality", agg="sum", num_groups=4),)
    h = pair.register(plan)
    t1, _ = pair.preg.answer(h[1])
    g = pair.preg._group_of(pair.preg._queries[h[1]])
    frozen = {k: v.clone() for k, v in g.state.items()}
    pair.append(_rows(640, seed=12, t0=64))
    _answers_equal(pair, h, plan)

    def boom(*a, **k):
        raise AssertionError("answer read stored rows")

    for mod, name in ((K, "fused_segment_agg"), (K, "fused_segment_agg_ref"),
                      (Q, "_seg_partial"), (S, "_seg_fold"),
                      (S, "fused_segment_agg")):
        monkeypatch.setattr(mod, name, boom)
    launches, paths = K.LAUNCHES, dict(Q.PATHS)
    cols, pair.port.columns = pair.port.columns, {}
    t2, _ = pair.preg.answer(h[1])
    pair.port.columns = cols
    assert K.LAUNCHES == launches and Q.PATHS == paths
    ref, _ = RW.execute_ref(pair.full(), 704, ref_plan(plan))
    _eq(t2["quality"].numpy(), ref["quality"])
    g.state = frozen
    t3, _ = pair.preg.answer(h[1])
    _eq(t3["quality"].numpy(), t1["quality"].numpy())


def _alerts_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert isinstance(a, Alert)
        assert (a.sub, a.name, a.handle) == (b.sub, b.name, b.handle)
        _eq(a.fired, np.asarray(b.fired))
        assert a.n_fired == b.n_fired
        assert set(a.table) == set(b.table)
        for k in b.table:
            _eq(a.table[k], np.asarray(b.table[k]), k)


def test_subscription_fires_fixed_shape_and_counts():
    pair = Pair(128)
    pair.attach()
    plan = (GroupBy("category", "quality", agg="count", num_groups=4),)
    sid = pair.preg.subscribe(plan, Filter("count", "ge", 120),
                              name="hot-category", use_kernel=False)
    rsid = pair.rreg.subscribe(ref_plan(plan), RW.Filter("count", "ge", 120),
                               name="hot-category", use_pallas=False)
    assert sid == rsid and pair.preg.has_subscriptions
    pair.append(_rows(100, seed=13))
    quiet = pair.preg.poll()
    _alerts_equal(quiet, pair.rreg.poll())
    assert quiet[0].fired.shape == (4,) and quiet[0].n_fired == 0
    rows = _rows(400, seed=14, t0=100)
    rows["category"][:] = 2                   # slam one group
    pair.append(rows)
    (alert,) = pair.preg.poll()
    _alerts_equal([alert], pair.rreg.poll())
    assert alert.n_fired == 1 and bool(alert.fired[2])
    assert {k: pair.port.obs[k] for k in ("standing_refreshes",
                                          "alerts_checked",
                                          "alerts_fired")} == \
        {"standing_refreshes": 2, "alerts_checked": 2, "alerts_fired": 1}
    # the store's whole flight recorder (ingests, lag, the standing gauge)
    assert pair.port.obs == pair.ref.obs
    tel = pair.ref.telemetry()
    assert (tel.alerts_checked, tel.alerts_fired,
            tel.standing_refreshes) == (2, 1, 2)


def test_alert_on_float_column_and_predicate_validation():
    pair = Pair(128)
    pair.attach()
    plan = (WindowAgg(window=64, value="on_core_s", agg="sum",
                      num_windows=4),)
    pair.preg.subscribe(plan, Filter("on_core_s", "gt", 100.0),
                        use_kernel=False)
    pair.rreg.subscribe(ref_plan(plan), RW.Filter("on_core_s", "gt", 100.0),
                        use_pallas=False)
    with pytest.raises(AssertionError):
        pair.preg.subscribe(plan, predicate=TopK(3, by="on_core_s"))
    pair.append(_rows(256, seed=15))
    (alert,) = pair.preg.poll()
    _alerts_equal([alert], pair.rreg.poll())
    ref, rmask = RW.execute_ref(pair.full(), 256, ref_plan(plan))
    _eq(alert.fired, rmask & (ref["on_core_s"] > 100.0))


def test_register_rejects_non_aggregating_and_unknown_columns():
    store = SegmentStore(out_dim=D, chunk_rows=64, device="cpu")
    reg = StandingQueries(store)
    with pytest.raises(ValueError, match="aggregating reducer"):
        reg.register((Filter("quality", "ge", 0.5), TopK(3, "quality")))
    with pytest.raises(ValueError, match="aggregating reducer"):
        reg.register((Filter("quality", "ge", 0.5),))
    with pytest.raises(ValueError, match="unknown column"):
        reg.register((Filter("nope", "ge", 0.5),
                      GroupBy("category", "quality", agg="sum",
                              num_groups=4)))
    with pytest.raises(ValueError, match="unknown columns"):
        reg.register((GroupBy("category", "latency", agg="mean",
                              num_groups=4),))
    with pytest.raises(AssertionError, match="already has"):
        StandingQueries(store)               # one registry per store
    assert len(reg) == 0 and store.standing is reg


@pytest.mark.parametrize("plan", [
    (Filter("k", "gt", 0.5),
     GroupBy("category", "quality", agg="max", num_groups=4)),
    (Filter("quality", "ge", 0.3),
     GroupBy("category", "on_core_s", agg="min", num_groups=4)),
    (WindowAgg(window=128, value="quality", agg="count", num_windows=8),),
    (Filter("quality", "ge", 0.25),
     GroupBy("category", "quality", agg="sum", num_groups=4)),
    (MultiGroupBy(keys=("t", "category"), value="out", agg="mean",
                  nums=(8, 4), windows=(128, 0)),),
], ids=["max", "min", "count", "sum", "wide_mean"])
def test_kernel_delta_fold_matches_engine(plan):
    """K1's path (its plain version on CPU columns, the default there)
    against the engine's fold on the same ingests: counts, max and min
    exact, float sums within the rescan tolerance; one K1 call per
    (query, batch) and no engine fold."""
    store = SegmentStore(out_dim=D, chunk_rows=256, device="cpu")
    store.append_rows(_rows(300, seed=19))
    reg = StandingQueries(store)
    S.FOLDS.update(kernel=0, engine=0)
    h_k = reg.register(plan)                  # None: the kernel's path
    assert reg._group_of(reg._queries[h_k]).use_kernel
    for i in range(3):
        store.append_rows(_rows(300 + i, seed=20 + i, t0=300 * (i + 1)))
    store.append_rows(_rows(0, seed=30))      # an empty ingest
    assert S.FOLDS == {"kernel": 5, "engine": 0}
    full = store.host_rows()
    ref, rmask = RW.execute_ref(full, store.n_rows, ref_plan(plan))
    table, mask = reg.answer(h_k)
    _eq(mask.numpy(), rmask)
    _eq(table["count"].numpy(), ref["count"])
    node = plan[-1]
    got, want = table[node.value].numpy(), ref[node.value]
    if node.agg in ("count", "max", "min"):
        _eq(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="cannot run"):
        reg.register((GroupBy("category", "out", agg="max",
                              num_groups=4),), use_kernel=True)


def test_run_result_alerts_from_a_fused_run():
    """A fused run with a sink polls the sink's subscriptions after its
    rows land: ``RunResult.alerts`` equals the reference's."""
    fitted = ref_fitted()
    K_ = len(fitted.configs)
    kw = dict(n_cores=8, cloud_budget_core_s=2000.0, plan_days=0.02)
    ref = RW.SegmentStore(out_dim=K_, chunk_rows=512)
    got = SegmentStore(out_dim=K_, chunk_rows=512, device="cpu")
    plan = (Filter("quality", "ge", 0.3),
            GroupBy("category", "quality", agg="mean", num_groups=4))
    rreg, preg = RW.StandingQueries(ref), StandingQueries(got)
    rreg.subscribe(ref_plan(plan), RW.Filter("quality", "gt", 0.5),
                   use_pallas=False)
    preg.subscribe(plan, Filter("quality", "gt", 0.5), use_kernel=False)
    h = (rreg.register(ref_plan(plan[-1:]), use_pallas=False),
         preg.register(plan[-1:], use_kernel=False))
    rres = RI.run_skyscraper_fused(fitted, generate(COVID, days=0.05,
                                                    seed=8), sink=ref, **kw)
    pres = PI.run_skyscraper_fused(port_fitted(), p_generate(
        P_COVID, days=0.05, seed=8), sink=got, device="cpu", **kw)
    assert len(pres.alerts) == 1
    _alerts_equal(pres.alerts, rres.alerts)
    t, m = preg.answer(h[1])
    rt, rm = rreg.answer(h[0])
    _eq(m.numpy(), np.asarray(rm))
    for k in rt:
        _eq(t[k].numpy(), np.asarray(rt[k]), k)
    # no sink, or a sink without subscriptions: no alerts
    assert PI.run_skyscraper_fused(port_fitted(), p_generate(
        P_COVID, days=0.02, seed=9), device="cpu", **kw).alerts == []


# ---------------------------------------------------------------------------
# property: random plans and ingest interleavings, single store
# (``tests/test_standing_properties.py`` without shards and spills)
# ---------------------------------------------------------------------------

_FLOAT_COLS = ("quality", "on_core_s", "buffer_s")
_INT_COLS = ("category", "k", "stream_id")
_OPS = ("eq", "ne", "lt", "le", "gt", "ge")


def _prop_rows(n, rng, t0=0):
    return {
        "stream_id": rng.integers(0, 9, n).astype(np.int32),
        "t": (t0 + np.sort(rng.integers(0, 40, n))).astype(np.int32),
        "category": rng.integers(0, 5, n).astype(np.int32),
        "k": rng.integers(0, 3, n).astype(np.int32),
        "quality": rng.random(n).astype(np.float32),
        "on_core_s": (rng.random(n) * 20 - 5).astype(np.float32),
        "cloud_core_s": (rng.random(n) * 5).astype(np.float32),
        "buffer_s": (rng.random(n) * 40).astype(np.float32),
        "out": rng.random((n, 2)).astype(np.float32),
    }


@st.composite
def _cases(draw):
    batches = draw(st.lists(st.integers(min_value=0, max_value=110),
                            min_size=1, max_size=3))
    reg_after = draw(st.integers(min_value=0, max_value=len(batches)))
    data_seed = draw(st.integers(min_value=0, max_value=10_000))
    plan = []
    for _ in range(draw(st.integers(min_value=0, max_value=2))):
        if draw(st.booleans()):
            col = draw(st.sampled_from(_FLOAT_COLS))
            val = draw(st.floats(min_value=-6.0, max_value=25.0))
        else:
            col = draw(st.sampled_from(_INT_COLS))
            val = float(draw(st.integers(min_value=-1, max_value=9)))
        plan.append(Filter(col, draw(st.sampled_from(_OPS)), val))
    kind = draw(st.sampled_from(["group", "window", "multi"]))
    agg = draw(st.sampled_from(["sum", "mean", "count", "max", "min"]))
    value = draw(st.sampled_from(_FLOAT_COLS + ("k",)))
    if kind == "group":
        plan.append(GroupBy(draw(st.sampled_from(_INT_COLS)), value,
                            agg=agg,
                            num_groups=draw(st.sampled_from([1, 6]))))
    elif kind == "window":
        plan.append(WindowAgg(window=draw(st.sampled_from([30, 80])),
                              value=value, agg=agg, num_windows=9))
    else:
        plan.append(MultiGroupBy(keys=("t", "category"), value=value,
                                 agg=agg, nums=(5, 5), windows=(40, 0)))
    use_kernel = draw(st.sampled_from([False, None]))
    return tuple(batches), reg_after, data_seed, tuple(plan), use_kernel


@settings(max_examples=40, deadline=None)
@given(_cases())
def test_standing_answer_matches_full_rescan(case):
    batches, reg_after, data_seed, plan, use_kernel = case
    rng = np.random.default_rng(data_seed)
    store = SegmentStore(out_dim=2, chunk_rows=48, device="cpu")
    reg = StandingQueries(store)
    handle = None
    seen = []
    t0 = 0
    for i, n in enumerate(batches):
        if reg_after == i:
            handle = reg.register(plan, use_kernel=use_kernel)
        if n:
            rows = _prop_rows(n, rng, t0=t0)
            t0 = int(rows["t"].max()) + 1
            store.append_rows(rows)
            seen.append(rows)
    if handle is None:
        handle = reg.register(plan, use_kernel=use_kernel)
    n_total = sum(len(r["t"]) for r in seen)
    full = ({k: np.concatenate([r[k] for r in seen]) for k in seen[0]}
            if seen else _prop_rows(0, rng))
    ref, rmask = RW.execute_ref(full, n_total, ref_plan(plan))
    table, mask = reg.answer(handle)
    _eq(mask.numpy(), rmask)
    _eq(table["count"].numpy(), ref["count"])
    node = plan[-1]
    for key in table:
        if key not in ("count", node.value):
            _eq(table[key].numpy(), ref[key], key)
    got, want = table[node.value].numpy(), ref[node.value]
    exact = (node.agg in ("count", "max", "min")
             or (node.value == "k" and node.agg == "sum"))
    if not reg._group_of(reg._queries[handle]).use_kernel or exact:
        _eq(got, want)          # the engine's fold: bit-exact
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
