"""Kernel K1 of the port (``repro_torch.kernels.warehouse_agg``) against
the reference: its plain version and the engine path on the CPU, held
against the reference's Pallas kernel in interpret mode and its numpy
mirror ``execute_ref``, over the matrix of
tests/test_warehouse_agg_pallas.py — every agg, scalar and wide values,
int and float filters with ``int_pred``'s edge thresholds, multi-key
windows, ragged live rows, the empty store — plus the path selector.

Tolerances: counts, max, min and the plain path's sums are compared
bit for bit (the plain version and ``execute_ref`` both add in row
order); against the Pallas kernel, which regroups float sums across row
tiles, float sums and means are held to rtol/atol 1e-5, as the
reference's own test holds them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from _torch_parity import ref_plan
from repro.kernels.warehouse_agg import FusedAggSpec as RSpec
from repro.kernels.warehouse_agg import fused_segment_agg as r_fused
import repro.warehouse as RW
from repro.warehouse import execute as r_execute
from repro.warehouse import query as RQ
from repro_torch.kernels import warehouse_agg as K
from repro_torch.warehouse import (Filter, GroupBy, MultiGroupBy,
                                   SegmentStore, TopK, WindowAgg, execute)
from repro_torch.warehouse import query as Q
from _torch_threads import cap_torch_threads

cap_torch_threads()

AGGS = ("sum", "mean", "count", "max", "min")


def _rows(n, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "stream_id": rng.integers(0, 6, n).astype(np.int32),
        "t": np.sort(rng.integers(0, 300, n)).astype(np.int32),
        "category": rng.integers(0, 5, n).astype(np.int32),
        "k": rng.integers(0, 3, n).astype(np.int32),
        "quality": rng.random(n).astype(np.float32),
        "on_core_s": (rng.random(n) * 20 - 5).astype(np.float32),
        "cloud_core_s": (rng.random(n) * 5).astype(np.float32),
        "buffer_s": (rng.random(n) * 40).astype(np.float32),
        "out": rng.random((n, 3)).astype(np.float32),
    }


def _store(n=130, seed=0):
    s = SegmentStore(out_dim=3, chunk_rows=48, device="cpu")  # ragged cap
    if n:
        s.append_rows(_rows(n, seed))
    return s


def execute_ref(cols, n, plan):
    return RW.execute_ref(cols, n, ref_plan(plan))


def _jax_cols(store):
    return {k: jnp.asarray(v.numpy()) for k, v in store.columns.items()}


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _check(table, mask, ref, rmask, value, exact):
    np.testing.assert_array_equal(_host(mask), rmask)
    np.testing.assert_array_equal(_host(table["count"]), ref["count"])
    got = _host(table[value]).astype(np.float32)
    want = np.asarray(ref[value], np.float32)
    assert np.all(np.isfinite(got)), "non-finite result leaked"
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _three_ways(store, plan, value, agg):
    """The port's plain kernel path and engine path (bit-exact against
    execute_ref) and the reference's Pallas kernel (to the stated
    tolerance)."""
    ref, rmask = execute_ref(store.host_rows(), store.n_rows, plan)
    for uk in (None, False):
        table, mask = execute(store, plan, use_kernel=uk)
        _check(table, mask, ref, rmask, value, exact=True)
    rt, rm = r_execute((_jax_cols(store), store.n_rows), ref_plan(plan),
                       use_pallas=True)
    _check(table, mask, {k: np.asarray(v) for k, v in rt.items()},
           np.asarray(rm), value, exact=agg in ("count", "max", "min"))


@pytest.mark.parametrize("agg", AGGS)
def test_groupby_matches_reference(agg):
    plan = (Filter("quality", "ge", 0.3),
            GroupBy("category", "on_core_s", agg=agg, num_groups=5))
    _three_ways(_store(), plan, "on_core_s", agg)


@pytest.mark.parametrize("agg", ("sum", "mean", "count"))
def test_wide_multigroupby_windows(agg):
    plan = (Filter("k", "le", 1),
            MultiGroupBy(keys=("t", "category"), value="out", agg=agg,
                         nums=(4, 5), windows=(100, 0)))
    _three_ways(_store(), plan, "out", agg)


def test_window_with_topk_post():
    store = _store()
    plan = (Filter("quality", "ge", 0.4),
            WindowAgg(window=60, value="quality", agg="mean",
                      num_windows=6),
            TopK(3, by="quality"))
    ref, rmask = execute_ref(store.host_rows(), store.n_rows, plan)
    table, mask = execute(store, plan)
    np.testing.assert_array_equal(mask.numpy(), rmask)
    for col in ("window", "quality", "count", "index"):
        np.testing.assert_array_equal(table[col].numpy(), ref[col])


@pytest.mark.parametrize("agg", AGGS)
def test_plain_kernel_vs_reference_kernel(agg):
    """The raw partials: the port's plain version against the reference
    Pallas kernel on a many-step grid (block_rows << capacity)."""
    store = _store(n=140)
    spec = dict(filters=(("quality", "ge", 0),), keys=(("category", 5, 0),),
                value="buffer_s", agg=agg)
    _, fvals = Q.normalize((Filter("quality", "ge", 0.25),))
    got = K.fused_segment_agg(store.columns, store.n_rows, fvals,
                              K.FusedAggSpec(**spec))
    _, rfvals = RQ.normalize((RW.Filter("quality", "ge", 0.25),))
    want = r_fused(_jax_cols(store), jnp.int32(store.n_rows), rfvals,
                   spec=RSpec(**spec), block_rows=16)
    np.testing.assert_array_equal(got["cnt"].numpy(), np.asarray(want["cnt"]))
    if agg in ("max", "min"):
        np.testing.assert_array_equal(got["acc"].numpy(),
                                      np.asarray(want["acc"]))
    else:
        np.testing.assert_allclose(got["acc"].numpy(), np.asarray(want["acc"]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("agg", AGGS)
def test_empty_group_contract(agg):
    """A group emptied by the filter and groups never present: 0.0,
    count 0, masked-off row — never ±inf."""
    store = _store()
    plan = (Filter("category", "ne", 2),
            GroupBy("category", "quality", agg=agg, num_groups=8))
    ref, rmask = execute_ref(store.host_rows(), store.n_rows, plan)
    assert ref["count"][2] == 0 and not rmask[5:].any()
    for uk in (None, False):
        table, mask = execute(store, plan, use_kernel=uk)
        _check(table, mask, ref, rmask, "quality", exact=True)


def test_all_rows_filtered_and_single_group():
    store = _store()
    for agg in AGGS:
        for plan in ((Filter("quality", "lt", -5.0),
                      GroupBy("category", "quality", agg=agg, num_groups=5)),
                     (GroupBy("k", "quality", agg=agg, num_groups=1),)):
            ref, rmask = execute_ref(store.host_rows(), store.n_rows, plan)
            for uk in (None, False):
                table, mask = execute(store, plan, use_kernel=uk)
                _check(table, mask, ref, rmask, "quality", exact=True)


def test_empty_store_yields_empty_groups():
    store = _store(n=0)
    cols = {k: v.numpy() for k, v in store.columns.items()}
    for agg in AGGS:
        plan = (GroupBy("category", "quality", agg=agg, num_groups=4),)
        ref, rmask = execute_ref(cols, 0, plan)
        assert not rmask.any() and np.all(ref["quality"] == 0.0)
        for uk in (None, False):
            table, mask = execute(store, plan, use_kernel=uk)
            _check(table, mask, ref, rmask, "quality", exact=True)


def test_ragged_live_rows():
    """Rows past ``n_rows`` are never read: garbage there changes
    nothing."""
    store = _store(n=130)
    cols = {k: v.clone() for k, v in store.columns.items()}
    cols["quality"][100:] = 1e9
    cols["category"][100:] = 3
    plan = (Filter("buffer_s", "lt", 30.0),
            GroupBy("category", "quality", agg="sum", num_groups=5))
    ref, rmask = execute_ref({k: v.numpy() for k, v in cols.items()}, 100,
                             plan)
    for uk in (None, False):
        table, mask = execute((cols, 100), plan, use_kernel=uk)
        _check(table, mask, ref, rmask, "quality", exact=True)


_I32 = 2 ** 31
_X_EDGE = np.asarray(
    [-_I32, -_I32 + 1, -7, -6, -5, -2, -1, 0, 1, 2, 5, 6, 7,
     _I32 - 2, _I32 - 1], np.int32)
_THRESHOLDS = [
    -float(_I32) - 0.7, -float(_I32), -_I32 + 0.5, -6.5, -6.0, -5.5,
    -1.5, -1.0, -0.5, -0.0, 0.0, 0.5, 1.0, 2.5, 5.0, 6.999,
    _I32 - 1.5, float(_I32 - 1), _I32 - 0.5, float(_I32), _I32 + 0.7,
    -1e20, 1e20, float("-inf"), float("inf"),
]


@pytest.mark.parametrize("op", ("eq", "ne", "lt", "le", "gt", "ge"))
def test_int_pred_edges_vs_float64(op):
    """Every threshold bucket (sign x integrality x in/out of int32)
    against the exact float64 comparison, through the row mask and
    through the plain kernel's count."""
    cols = {"x": torch.as_tensor(_X_EDGE),
            "g": torch.zeros(len(_X_EDGE), dtype=torch.int32)}
    n = len(_X_EDGE)
    for v in _THRESHOLDS:
        want = Q._CMP[op](_X_EDGE.astype(np.float64), np.float64(v))
        _, mask = execute((cols, n), (Filter("x", op, v),))
        np.testing.assert_array_equal(mask.numpy(), want,
                                      err_msg=f"{op} {v!r}")
        table, _ = execute((cols, n), (Filter("x", op, v),
                                       GroupBy("g", "x", agg="count",
                                               num_groups=1)))
        assert int(table["count"][0]) == int(want.sum()), f"{op} {v!r}"


def test_selector_rules():
    store = _store(n=10)
    cols = store.columns

    def resolve(flag, plan):
        spec, _ = Q.normalize(plan)
        pre, node, _ = Q.split_plan(spec)
        return Q._resolve_use_kernel(flag, pre, node, cols)

    agg = (Filter("quality", "ge", 0.5),
           GroupBy("category", "quality", num_groups=4))
    assert resolve(None, agg) is True       # CPU: the plain version
    assert resolve(True, agg) is True
    assert resolve(False, agg) is False     # the engine's _seg_partial
    for plan in ((Filter("quality", "ge", 0.5),),
                 (TopK(3, by="quality"),),
                 (GroupBy("category", "out", agg="max", num_groups=4),)):
        assert resolve(None, plan) is False
        with pytest.raises(ValueError):
            resolve(True, plan)
    # beyond the kernel's struct: True raises, naming the limit; None on
    # CPU columns runs the plain version, which has no such limit
    too_many = tuple(Filter("quality", "ge", 0.1 * j)
                     for j in range(K.MAX_FILTERS + 1)) + agg[1:]
    with pytest.raises(ValueError, match="9 filters"):
        execute(store, too_many, use_kernel=True)
    assert resolve(None, too_many) is True
    # more groups than shared memory holds: still the kernel's plan
    many = (GroupBy("t", "out", agg="sum", num_groups=20_000),)
    assert resolve(True, many) is True and resolve(None, many) is True
    Q.PATHS.update(kernel=0, engine=0)
    execute(store, agg)
    execute(store, agg, use_kernel=False)
    assert Q.PATHS == {"kernel": 1, "engine": 1}


def test_kernel_limits_and_accumulator_mode():
    """Shared accumulators up to SMEM_LIMIT, global ones past it, and a
    ValueError naming each limit of the kernel's spec."""
    def spec(keys, value="x", agg="sum", filters=()):
        return K.FusedAggSpec(filters, keys, value, agg)

    per_group = 8                           # a scalar sum and a count
    fit = K.SMEM_LIMIT // per_group
    assert K.accumulator_mode(spec((("g", fit, 0),)), 0) == "shared"
    assert K.accumulator_mode(spec((("g", fit + 1, 0),)), 0) == "global"
    assert K.accumulator_mode(spec((("g", 4, 0),)), 9) == "shared"
    K.check_kernel(spec((("g", K.GLOBAL_LIMIT // per_group, 0),)), 0)
    bad = [
        (spec((("g", 4, 0),), filters=tuple(
            ("x", "ge", j) for j in range(K.MAX_FILTERS + 1))), 0,
         "9 filters"),
        (spec(()), 0, "no group key"),
        (spec(tuple((f"g{j}", 2, 0) for j in range(K.MAX_KEYS + 1))), 0,
         "5 keys"),
        (spec((("g", 4, 0),), agg="max"), 3, "width 3"),
        (spec((("g", K.GLOBAL_LIMIT // per_group + 1, 0),)), 0,
         "bytes of accumulators"),
    ]
    for sp, width, match in bad:
        with pytest.raises(ValueError, match=match):
            K.check_kernel(sp, width)


# ------------------------------------------------- the kernel's geometry ----
N_SM = 132                                  # H100 SXM
MAIN_ROWS = 256 * 43_200                    # the main path's store


def _main_specs():
    """The five main-path plans' kernel specs and value widths."""
    f = (("quality", "ge", 0),)
    return {
        "window_topk": (K.FusedAggSpec(f, (("t", 288, 150),), "quality",
                                       "mean"), 0),
        "category_mean": (K.FusedAggSpec(f, (("category", 4, 0),),
                                         "quality", "mean"), 0),
        "window_x_category": (K.FusedAggSpec((), (("t", 288, 150),
                                                  ("category", 4, 0)),
                                             "out", "mean"), 9),
        "camera_buffer_peak": (K.FusedAggSpec((), (("stream_id", 256, 0),),
                                              "buffer_s", "max"), 0),
        "camera_x_window": (K.FusedAggSpec((), (("stream_id", 256, 0),
                                                ("t", 288, 150)),
                                           "quality", "mean"), 0),
    }


def _geometry_specs():
    yield from _main_specs().values()
    for num in (1, 4, 1000, 7000, K.SMEM_LIMIT // 8, K.SMEM_LIMIT // 8 + 1,
                64_000, 2 ** 20):
        for width in (0, 3, 9):
            if width and num > 2 ** 19:
                continue
            yield K.FusedAggSpec((), (("g", num, 0),), "x", "sum"), width


@pytest.mark.parametrize("n_rows", (0, 1, 3, 5, 1027, 4 * 10_000 + 3,
                                    MAIN_ROWS))
def test_geometry_grid_covers_every_row(n_rows):
    """Strips of 4 rows from the aligned head, cut into the grid's blocks,
    plus the scalar rows before and after them, are every row once."""
    for spec, width in _geometry_specs():
        geo = K.geometry(n_rows, spec, width, N_SM)
        assert geo.blocks >= 1 and geo.threads % 32 == 0
        assert 32 <= geo.threads <= K.MAX_THREADS
        for head in (-1, 0, 1, 2, 3):
            h, n_strips, per_block = K.strip_plan(n_rows, head, geo.blocks)
            assert geo.blocks * per_block >= n_strips
            front = n_rows if h < 0 else h
            tail = n_rows - (front + 4 * n_strips)
            assert tail >= 0 and (h < 0 or tail < 4)
            assert front + 4 * n_strips + tail == n_rows
            if head >= 0 and n_rows >= head + 4:
                assert h == head and n_strips > 0


def test_geometry_shared_memory_and_mode_boundary():
    """Shared mode fits a block's 227 KB (replicas, and one warp's
    staging of a wide column, included); the mode changes where one copy
    of the accumulators stops fitting, as ``accumulator_mode`` says."""
    for spec, width in _geometry_specs():
        geo = K.geometry(MAIN_ROWS, spec, width, N_SM)
        assert geo.mode == K.accumulator_mode(spec, width)
        assert geo.smem_bytes <= K.SMEM_LIMIT
        assert geo.blocks_per_sm >= 1
        if geo.mode == "shared":
            copy = K.accumulator_bytes(spec.num_groups, width)
            assert 1 <= geo.replicas <= geo.threads // 32
            assert geo.smem_bytes >= geo.replicas * copy
        else:
            assert geo.replicas == 1
            assert geo.smem_bytes == geo.threads // 32 * K.staging_bytes(width)
    for width in (0, 9):
        per_group = (max(1, width) + 1) * 4
        fit = (K.SMEM_LIMIT - K.staging_bytes(width)) // per_group
        spec = K.FusedAggSpec((), (("g", fit, 0),), "x", "sum")
        assert K.geometry(MAIN_ROWS, spec, width, N_SM).mode == "shared"
        spec = K.FusedAggSpec((), (("g", fit + 1, 0),), "x", "sum")
        assert K.geometry(MAIN_ROWS, spec, width, N_SM).mode == "global"


@pytest.mark.parametrize("plan", sorted(_main_specs()))
def test_geometry_resident_warps_on_the_main_path(plan):
    """Every main-path plan keeps at least 32 warps resident on an SM,
    and the grid fills every SM."""
    spec, width = _main_specs()[plan]
    geo = K.geometry(MAIN_ROWS, spec, width, N_SM)
    assert geo.resident_warps >= K.MIN_WARPS
    assert geo.blocks == geo.blocks_per_sm * N_SM
    want = "global" if plan == "camera_x_window" else "shared"
    assert geo.mode == want


def test_vector_head():
    """The first row at which every column's 4-row strip is 16-byte
    aligned: scalar columns step 4 bytes a row, a (rows, D) column 4D."""
    base = 1 << 20
    assert K.vector_head([base, base + 64], [1, 1]) == 0
    assert K.vector_head([base + 4, base + 4], [1, 1]) == 3
    assert K.vector_head([base + 4, base + 36], [1, 9]) == 3
    assert K.vector_head([base + 4, base + 8], [1, 1]) == -1
    assert K.vector_head([base + 4, base], [1, 2]) == -1
    assert K.vector_head([base + 2], [1]) == -1


_F32_EDGES = np.array(
    [0.0, -0.0, np.inf, -np.inf, 1.0, -1.0, 1.5, -1.5, 2.0, -2.0,
     np.finfo(np.float32).max, -np.finfo(np.float32).max,
     np.finfo(np.float32).tiny, -np.finfo(np.float32).tiny,
     np.float32(1e-45), np.float32(-1e-45), np.float32(3e-39),
     np.float32(-3e-39), np.nextafter(np.float32(1), np.float32(2)),
     np.nextafter(np.float32(1), np.float32(0)), 0.3, -0.3, 6e5, -6e5],
    np.float32)


def test_ordered_int_orders_like_the_floats():
    """``ordered_int(a) < ordered_int(b)`` if and only if ``a < b``, and
    equal ints for equal floats (+0 and -0 included), over every pair of
    float32 edge values; the map inverts (with -0 as +0)."""
    ints = [K.ordered_int(float(x)) for x in _F32_EDGES]
    assert all(-2 ** 31 <= i < 2 ** 31 for i in ints)
    for a, ia in zip(_F32_EDGES, ints):
        back = K.from_ordered_int(ia)
        assert back == a and np.float32(back).tobytes() == (
            np.float32(a) + np.float32(0)).tobytes()
        for b, ib in zip(_F32_EDGES, ints):
            assert (ia < ib) == (a < b), (a, b)
            assert (ia == ib) == (a == b), (a, b)


@given(st.floats(width=32, allow_nan=False),
       st.floats(width=32, allow_nan=False))
@settings(max_examples=300, deadline=None)
def test_ordered_int_property(a, b):
    ia, ib = K.ordered_int(a), K.ordered_int(b)
    assert (ia < ib) == (a < b)
    assert (ia == ib) == (a == b)


def test_window_division_magic():
    """The kernel's floor division by a window (a multiply-high by a host
    magic number, ``~a`` for negative ``a``) equals ``a // w`` over int32
    edge values and random ones, for windows from 2 to 2^31 - 1."""
    rng = np.random.default_rng(4)
    xs = [0, 1, -1, 2, -2, 149, 150, 151, -150, -151, 43_199, 2 ** 30,
          2 ** 31 - 1, -2 ** 31, -2 ** 31 + 1]
    xs += [int(x) for x in rng.integers(-2 ** 31, 2 ** 31, 2000)]
    for w in (2, 3, 5, 7, 10, 20, 150, 255, 256, 600, 43_200, 65_537,
              2 ** 20 + 1, 2 ** 30 + 3, 2 ** 31 - 1):
        magic, shift = K.div_magic(w)
        assert 0 <= magic < 2 ** 32 and 1 <= shift <= 31
        for a in xs:
            assert K.floor_div(a, w) == a // w, (a, w)
    with pytest.raises(ValueError):
        K.div_magic(1)
