"""The port's traceable engines: one entry per engine of the reference's
dispatch tracer (``OBS.json``), under the same name, each building
``(fn, args, kwargs)`` on a device.

``fn`` is the port function that the parity tests hold against the
reference engine of that name; where the reference traces a jitted
private function that the port inlines in a method (the fused run, a
store's ingest), ``fn`` calls that method. The inputs have the shapes
of the reference's tiny examples (``repro/analysis/examples.py``),
drawn from a seeded numpy generator, so each call takes microseconds
of device work and the span measures the host's dispatch.

A store method writes in place and advances the store's row count; its
``fn`` resets the count first, so every call lands the same rows at the
same place and does the same work. In-place helpers return what they
wrote, so the tracer sizes it as the call's output.

Nothing is built at import: ``build(name, device)`` makes one example.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

K, C, P, V = 4, 3, 3, 2          # configs, categories, placements, streams
W, T, N_W = 6, 10, 2             # window len, run len, windows per run
N_SPLIT, INTERVAL = 2, 3         # forecaster history layout
OUT_DIM, CAP = 4, 64             # warehouse embedding width / capacity
N_SHARDS = 2
N_VALID = (50, 40)               # live rows of the sharded examples' shards
Q_STAND = 2                     # stacked query slots of a standing group
_CHUNK, _N_SPILL = 4, 8          # the tiers' chunk and spill depth


class SkipEngine(Exception):
    """Raised by a builder when the engine cannot run on this device;
    the tracer records the reason instead of a span."""


class EngineExample(NamedTuple):
    fn: Callable
    args: Tuple[Any, ...]
    kwargs: Dict[str, Any] = {}


# ---- inputs -----------------------------------------------------------------

def _f32(x, dev):
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def _demo_arrays(seed: int = 0, tau: float = 2.0, n_cores: int = 4):
    """The reference's ``demo_tables`` as numpy arrays."""
    rng = np.random.default_rng(seed)
    power = np.sort(rng.random(K)).astype(np.float32)
    cost = np.sort(rng.random(K) * 20 + 0.5).astype(np.float32)
    cost[0] = min(cost[0], tau * n_cores * 0.9)
    centers = np.sort(rng.random((C, K)), axis=0).astype(np.float32)
    rt = np.stack([cost / n_cores, cost / n_cores * 0.6,
                   cost / n_cores * 0.3], 1)
    cl = np.stack([np.zeros(K), cost * 0.4, cost * 0.7], 1)
    on = np.stack([cost, cost * 0.6, cost * 0.3], 1)
    return dict(centers=centers, power=power, cost=cost, place_rt=rt,
                place_on=on, place_cl=cl, place_valid=np.ones((K, P), bool))


def demo_tables(dev, seed: int = 0, tau: float = 2.0, cap: float = 30.0,
                cloud: float = 50.0):
    from repro_torch.core.switcher import SwitchTables
    a = _demo_arrays(seed, tau)
    return SwitchTables(
        centers=_f32(a["centers"], dev), power=_f32(a["power"], dev),
        cost=_f32(a["cost"], dev), place_rt=_f32(a["place_rt"], dev),
        place_on=_f32(a["place_on"], dev), place_cl=_f32(a["place_cl"], dev),
        place_valid=torch.ones((K, P), dtype=torch.bool, device=dev),
        rank_pos=torch.as_tensor(np.argsort(np.argsort(-a["power"])),
                                 device=dev),
        tau=_f32(tau, dev), buffer_cap_s=_f32(cap, dev),
        cloud_budget=_f32(cloud, dev))


def _alpha(rng, dev):
    a = rng.random((C, K)).astype(np.float32)
    return _f32(a / a.sum(1, keepdims=True), dev)


def _quals(rng, dev, *shape):
    return _f32(rng.random(shape + (K,)), dev)


def _forecaster(dev):
    from repro_torch.core.forecaster import init_forecaster
    return init_forecaster(torch.Generator().manual_seed(0), N_SPLIT, C,
                           device=dev)


def _multi(dev):
    from repro_torch.core.switcher import init_state_multi, stack_tables
    ts = [demo_tables(dev, seed=s) for s in range(V)]
    return ts, init_state_multi(ts), stack_tables(ts)


# ---- switcher ---------------------------------------------------------------

def switch_step(dev):
    from repro_torch.core.switcher import _switch, init_state
    rng = np.random.default_rng(0)
    t = demo_tables(dev)
    return EngineExample(_switch, (init_state(t), _quals(rng, dev),
                                   _f32(1.2, dev), _alpha(rng, dev), t))


def switch_step_multi(dev):
    from repro_torch.core.switcher import _switch_multi
    rng = np.random.default_rng(0)
    _, state, tables = _multi(dev)
    alpha = torch.stack([_alpha(rng, dev) for _ in range(V)])
    return EngineExample(_switch_multi,
                         (state, _quals(rng, dev, V),
                          torch.ones((V,), device=dev), alpha, tables))


def run_window(dev):
    from repro_torch.core.switcher import init_state
    from repro_torch.core.switcher import run_window as fn
    rng = np.random.default_rng(0)
    t = demo_tables(dev)
    return EngineExample(fn, (init_state(t), _quals(rng, dev, W),
                              torch.ones((W,), device=dev),
                              _alpha(rng, dev), t),
                         {"valid": torch.ones((W,), dtype=torch.bool,
                                              device=dev)})


def run_window_multi(dev):
    from repro_torch.core.switcher import run_window_multi as fn
    rng = np.random.default_rng(0)
    _, state, tables = _multi(dev)
    alpha = torch.stack([_alpha(rng, dev) for _ in range(V)])
    return EngineExample(fn, (state, _quals(rng, dev, V, W),
                              torch.ones((V, W), device=dev), alpha, tables),
                         {"valid": torch.ones((V, W), dtype=torch.bool,
                                              device=dev)})


# ---- fused ingestion --------------------------------------------------------

def _tiny_fit(dev):
    """A ``Fitted`` over the demo tables and a T-segment COVID stream,
    planned in windows of W segments."""
    from repro_torch.configs.workloads import COVID
    from repro_torch.core.offline import Fitted
    from repro_torch.data.stream import DAY_SECONDS, generate
    a = _demo_arrays()
    fitted = Fitted(workload=COVID, configs=[{"k": k} for k in range(K)],
                    forecaster=_forecaster(dev), n_split=N_SPLIT,
                    interval_segments=INTERVAL, horizon_segments=W,
                    n_cores=4, device=dev, **a)
    tau = COVID.segment_seconds
    stream = generate(COVID, days=(T + 0.5) * tau / DAY_SECONDS, seed=0)
    return fitted, stream, (W + 0.5) * tau / DAY_SECONDS


def fused_single(dev, telemetry: bool = False):
    from repro_torch.core.ingest import run_skyscraper_fused
    fitted, stream, plan_days = _tiny_fit(dev)
    return EngineExample(run_skyscraper_fused, (fitted, stream),
                         {"n_cores": 4, "cloud_budget_core_s": 50.0,
                          "plan_days": plan_days, "forecast_mode": "model",
                          "telemetry": telemetry, "device": dev})


def fused_multi(dev, telemetry: bool = False):
    from repro_torch.core.ingest import _fused_run_multi
    rng = np.random.default_rng(0)
    ts, state, tables = _multi(dev)
    valid = (np.arange(N_W * W) < T).reshape(N_W, 1, W)
    return EngineExample(
        _fused_run_multi,
        (state, _f32(rng.random((N_W, V, W, K)), dev),
         torch.ones((N_W, V, W), device=dev),
         torch.as_tensor(np.broadcast_to(valid, (N_W, V, W)).copy(),
                         device=dev),
         np.minimum(W, T - np.arange(N_W) * W).astype(np.int32),
         tables, ts[0].cost, _f32(16.0, dev), _f32(0.5, dev)),
        {"with_traces": True, "telemetry": telemetry})


# ---- serving pool -----------------------------------------------------------

def _pool_plan_args(dev):
    rng = np.random.default_rng(0)
    bufs = torch.as_tensor(rng.integers(0, C, (V, N_SPLIT * INTERVAL)),
                           dtype=torch.int32, device=dev)
    centers = _f32(np.sort(rng.random((C, K)), axis=0), dev)
    cost = _f32(np.sort(rng.random(K) * 10 + 0.5), dev)
    return (_forecaster(dev), bufs, centers, cost, _f32(8.0, dev), True)


def pool_replan(dev):
    from repro_torch.core.api import _pool_replan
    return EngineExample(_pool_replan, _pool_plan_args(dev),
                         {"n_split": N_SPLIT, "interval": INTERVAL})


def pool_shift(dev):
    from repro_torch.core.api import _pool_shift
    bufs = torch.zeros((V, N_SPLIT * INTERVAL), dtype=torch.int32,
                       device=dev)
    return EngineExample(_pool_shift,
                         (bufs, torch.ones((V,), dtype=torch.int64,
                                           device=dev)))


def pool_replan_stacked(dev):
    from repro_torch.core.api import _pool_replan_stacked
    return EngineExample(
        _pool_replan_stacked,
        _pool_plan_args(dev) + (torch.ones((V,), dtype=torch.bool,
                                           device=dev),
                                torch.ones((V,), device=dev)),
        {"n_split": N_SPLIT, "interval": INTERVAL})


def pool_tick(dev):
    from repro_torch.core.api import _pool_tick_fn
    rng = np.random.default_rng(0)
    _, state, tables = _multi(dev)
    alpha = torch.stack([_alpha(rng, dev) for _ in range(V)])
    ones = torch.ones((V,), device=dev)
    yes = torch.ones((V,), dtype=torch.bool, device=dev)
    inf = _f32(np.inf, dev)
    return EngineExample(_pool_tick_fn,
                         (state, ones, yes, _quals(rng, dev, V), ones, yes,
                          ones, alpha, tables, inf, inf))


def pool_admit(dev):
    from repro_torch.core.api import _pool_admit_fn
    rng = np.random.default_rng(0)
    ts, state, tables = _multi(dev)
    alpha = torch.stack([_alpha(rng, dev) for _ in range(V)])
    bufs = torch.zeros((V, N_SPLIT * INTERVAL), dtype=torch.int32,
                       device=dev)
    active = torch.zeros((V,), dtype=torch.bool, device=dev)
    priority = torch.zeros((V,), device=dev)
    row_alpha = _alpha(rng, dev)

    def admit(*args):
        _pool_admit_fn(*args)
        return tables, state, bufs, alpha, active, priority

    return EngineExample(admit, (tables, state, bufs, alpha, active,
                                 priority, 0, 1.0, ts[0], row_alpha))


def pool_retire(dev):
    from repro_torch.core.api import _pool_retire
    active = torch.ones((V,), dtype=torch.bool, device=dev)

    def retire(active, slot):
        _pool_retire(active, slot)
        return active

    return EngineExample(retire, (active, 0))


# ---- forecaster / categories / planner --------------------------------------

def adam_step(dev):
    from repro_torch.core.forecaster import _adam_step, _flat
    params = _forecaster(dev)
    opt = {"m": [torch.zeros_like(p) for p in _flat(params)],
           "v": [torch.zeros_like(p) for p in _flat(params)], "t": 0}
    rng = np.random.default_rng(0)
    return EngineExample(_adam_step,
                         (params, opt, _f32(rng.random((8, N_SPLIT, C)), dev),
                          _f32(rng.random((8, C)), dev), 3e-3))


def lloyd_step(dev):
    from repro_torch.core.categories import _lloyd_step
    rng = np.random.default_rng(0)
    return EngineExample(_lloyd_step, (_f32(rng.random((C, K)), dev),
                                       _f32(rng.random((20, K)), dev)))


def classify_full(dev):
    from repro_torch.core.categories import classify_full as fn
    rng = np.random.default_rng(0)
    return EngineExample(fn, (_f32(rng.random(K), dev),
                              _f32(rng.random((C, K)), dev)))


def classify_1d(dev):
    from repro_torch.core.categories import classify_1d as fn
    rng = np.random.default_rng(0)
    return EngineExample(fn, (_f32(0.5, dev),
                              torch.tensor(1, device=dev),
                              _f32(rng.random((C, K)), dev)))


def lp_lagrangian(dev):
    from repro_torch.core.planner import solve_lp_lagrangian
    rng = np.random.default_rng(0)
    qual = _f32(np.sort(rng.random((C, K)), axis=0), dev)
    cost = _f32(np.sort(rng.random(K) * 10 + 0.5), dev)
    return EngineExample(solve_lp_lagrangian,
                         (qual, cost, _f32(np.full(C, 1.0 / C), dev),
                          _f32(4.0, dev)))


# ---- warehouse: queries -----------------------------------------------------

def store_cols(dev, stacked: bool = False):
    """The reference examples' all-zero columns of capacity CAP (stacked
    on a leading shard axis when ``stacked``)."""
    from repro_torch.warehouse.store import _empty_columns
    cols = _empty_columns(CAP, OUT_DIM, dev)
    if stacked:
        cols = {k: v[None].repeat((N_SHARDS,) + (1,) * v.dim())
                for k, v in cols.items()}
    return cols


def plan(kind: str):
    from repro_torch.warehouse.query import (Filter, GroupBy, MultiGroupBy,
                                             TopK, WindowAgg)
    if kind == "filter_groupby":
        return (Filter("quality", "ge", 0.25),
                GroupBy("category", "quality", agg="mean", num_groups=C))
    if kind == "window_sum":
        return (WindowAgg(window=4, value="on_core_s", agg="sum",
                          num_windows=8),)
    if kind == "multi_topk":
        return (MultiGroupBy(keys=("t", "category"), value="quality",
                             agg="sum", nums=(8, C), windows=(4, 0)),
                TopK(5, "quality"))
    if kind == "topk":
        return (Filter("t", "lt", 48), TopK(5, "quality"))
    if kind == "group_max":
        return (Filter("k", "gt", 0.5),
                GroupBy("category", "quality", agg="max", num_groups=C))
    raise ValueError(kind)


def query(dev, kind: str, use_kernel: bool = False):
    """``execute`` over the (columns, 50 live rows) pair; ``use_kernel``
    takes K1's path (the reference's ``use_pallas``)."""
    from repro_torch.warehouse.query import execute
    return EngineExample(execute, ((store_cols(dev), 50), plan(kind)),
                         {"use_kernel": use_kernel})


def _sharded_store(dev, n_valid=N_VALID):
    from repro_torch.warehouse.store import ShardedStore
    return ShardedStore._from_parts(
        columns=store_cols(dev, stacked=True), n_rows_by_shard=n_valid,
        t_max=max(n_valid) - 1, out_dim=OUT_DIM, n_shards=N_SHARDS,
        chunk_rows=CAP, device=dev)


def query_sharded(dev, kind: str, use_kernel: bool = False):
    from repro_torch.warehouse.query import execute_sharded
    return EngineExample(execute_sharded, (_sharded_store(dev), plan(kind)),
                         {"use_kernel": use_kernel})


# ---- warehouse: ingests -----------------------------------------------------

def _traces(dev, *lead):
    rng = np.random.default_rng(0)
    tr = {}
    for src in ("c", "k", "qual", "on_s", "cl_s", "buffer_s"):
        if src in ("c", "k"):
            tr[src] = torch.as_tensor(rng.integers(0, C, lead),
                                      dtype=torch.int32, device=dev)
        else:
            tr[src] = _f32(rng.random(lead), dev)
    return tr


def _rows(n, dev):
    from repro_torch.warehouse.store import OUT_COLUMN, SCALAR_COLUMNS
    rows = {name: torch.zeros((n,), dtype=dt, device=dev)
            for name, dt in SCALAR_COLUMNS}
    rows[OUT_COLUMN] = torch.zeros((n, OUT_DIM), device=dev)
    return rows


def _store(dev, standing: bool = False):
    """An empty ``SegmentStore`` at capacity CAP, with a standing query
    group of ``Q_STAND`` slots (the engine path) when ``standing``."""
    from repro_torch.warehouse.store import SegmentStore
    store = SegmentStore(out_dim=OUT_DIM, chunk_rows=CAP, device=dev)
    store._reserve(CAP)
    if standing:
        _register(store)
    return store


def _register(store):
    from repro_torch.warehouse.query import Filter
    from repro_torch.warehouse.standing import StandingQueries
    reg = StandingQueries(store)
    for thr in (0.25, 0.5):                      # Q_STAND queries
        reg.register((Filter("quality", "ge", thr),) + plan(
            "filter_groupby")[1:], use_kernel=False)
    return reg


def _rewound(store, method):
    """``method`` of ``store`` with the row count reset before each call,
    so every call lands its rows at row 0 (of each shard)."""
    def call(*args, **kwargs):
        if hasattr(store, "n_rows_by_shard"):
            store.n_rows_by_shard[:] = 0
        else:
            store.n_rows = 0
        store.t_max = -1
        getattr(store, method)(*args, **kwargs)
        return store.columns
    return call


def store_scatter(dev, standing: bool = False):
    return EngineExample(_rewound(_store(dev, standing), "append_rows"),
                         (_rows(5, dev),))


def store_ingest_fused(dev):
    return EngineExample(_rewound(_store(dev), "ingest_fused"),
                         (_traces(dev, N_W, W),
                          torch.zeros((T, OUT_DIM), device=dev)))


def store_ingest_fused_multi(dev):
    return EngineExample(_rewound(_store(dev), "ingest_fused_multi"),
                         (_traces(dev, N_W, V, W),
                          torch.zeros((V, T, OUT_DIM), device=dev)))


def store_ingest_tick(dev, standing: bool = False, masked: bool = False):
    kw = {"quality": torch.ones((V,), device=dev),
          "out_vecs": torch.zeros((V, OUT_DIM), device=dev), "t": 0}
    if masked:
        kw.update(stream_ids=torch.arange(V, dtype=torch.int32, device=dev),
                  valid=np.ones(V, bool))
    return EngineExample(_rewound(_store(dev, standing), "ingest_tick"),
                         (_traces(dev, V),), kw)


def _sharded_empty(dev, standing: bool = False):
    store = _sharded_store(dev, n_valid=(0,) * N_SHARDS)
    if standing:
        _register(store)
    return store


def store_sharded(dev, kind: str):
    if kind == "append":
        return EngineExample(_rewound(_sharded_empty(dev), "append_rows"),
                             (_rows(6, dev),))
    if kind == "fused_multi":
        return EngineExample(
            _rewound(_sharded_empty(dev), "ingest_fused_multi"),
            (_traces(dev, N_W, V, W),
             torch.zeros((V, T, OUT_DIM), device=dev)))
    kw = {"quality": torch.ones((V,), device=dev),
          "out_vecs": torch.zeros((V, OUT_DIM), device=dev), "t": 0}
    if kind == "tick_ids":
        kw.update(stream_ids=torch.arange(V, dtype=torch.int32, device=dev),
                  valid=np.ones(V, bool))
    return EngineExample(
        _rewound(_sharded_empty(dev, standing=kind == "standing"),
                 "ingest_tick"), (_traces(dev, V),), kw)


def store_rebalance(dev):
    """The re-partition of ``rebalance``, at its capacity for the rows
    (one shard may own them all)."""
    from repro_torch.runtime.elastic import _repartition
    from repro_torch.warehouse.store import _bucket_cap
    return EngineExample(_repartition, (store_cols(dev, stacked=True),
                                        np.asarray(N_VALID), N_SHARDS,
                                        _bucket_cap(sum(N_VALID), CAP)))


# ---- warehouse: standing queries --------------------------------------------

def _standing_args(dev, kind: str, sharded: bool = False):
    """(spec, stacked (Q, F) filter operands, fresh state) of a standing
    group of ``Q_STAND`` same-shape queries."""
    from repro_torch.kernels.warehouse_agg import identity
    from repro_torch.warehouse.query import _num_groups, normalize, split_plan
    spec, fv = normalize(plan(kind))
    fvq = tuple(np.stack([a] * Q_STAND) for a in fv)
    _pre, node, _post = split_plan(spec)
    lead = ((N_SHARDS,) if sharded else ()) + (Q_STAND, _num_groups(node))
    state = {"acc": torch.full(lead, identity(node.agg), device=dev),
             "cnt": torch.zeros(lead, device=dev)}
    return spec, fvq, state


def standing_backfill(dev, kind: str, use_kernel: bool = False):
    from repro_torch.warehouse.standing import _backfill
    spec, fvq, state = _standing_args(dev, kind)
    return EngineExample(_backfill, (store_cols(dev), 50, fvq, state),
                         {"sspec": (spec, use_kernel)})


def standing_fold_sharded(dev):
    """Each shard's live rows folded into its slice of a registered
    group's state (``ShardedStore._fold``, the fold of a sharded
    ingest)."""
    store = _sharded_store(dev)
    _register(store)

    def fold(lo, counts):
        store._fold(lo, counts)
        return store.standing.kernel_args()[0]

    return EngineExample(fold, (np.zeros(N_SHARDS, np.int64),
                                np.asarray(N_VALID)))


def standing_answer(dev, sharded: bool):
    from repro_torch.warehouse.standing import _answer_kernel
    spec, fvq, state = _standing_args(dev, "filter_groupby", sharded)
    return EngineExample(_answer_kernel, (state, fvq),
                         {"spec": spec, "sharded": sharded})


# ---- warehouse: tiers -------------------------------------------------------

def _draws(dev):
    """Uniform draws per float column, made once on the device, indexed
    as the tiers' ``draws(name, *shape)`` callback asks."""
    rng = np.random.default_rng(0)
    cache = {}

    def draws(name, *shape):
        if name not in cache:
            cache[name] = _f32(rng.random(shape), dev)
        return cache[name]
    return draws


def tiers_quantize(dev):
    from repro_torch.warehouse.tiers import _quantize_chunks
    return EngineExample(_quantize_chunks, (store_cols(dev), _draws(dev)),
                         {"n": _N_SPILL, "chunk": _CHUNK})


def tiers_compact(dev):
    from repro_torch.warehouse.tiers import _compact

    def compact(cols, n_spill):
        _compact(cols, n_spill=n_spill)
        return cols

    return EngineExample(compact, (store_cols(dev), _N_SPILL))


def tiers_materialize(dev):
    from repro_torch.warehouse.tiers import _materialize, _quantize_chunks
    cols = store_cols(dev)
    q, scales, ints = _quantize_chunks(cols, _draws(dev), n=_N_SPILL,
                                       chunk=_CHUNK)
    return EngineExample(_materialize, (q, scales, ints, cols),
                         {"chunk": _CHUNK})


def tiers_quantize_sharded(dev):
    from repro_torch.warehouse.tiers import _quantize_chunks_sharded
    return EngineExample(_quantize_chunks_sharded,
                         (store_cols(dev, stacked=True), _draws(dev)),
                         {"n": _N_SPILL, "chunk": _CHUNK})


def tiers_cold_write(dev):
    from repro_torch.warehouse.tiers import _cold_write

    def write(dst, src, off):
        _cold_write(dst, src, off)
        return dst

    return EngineExample(write, (
        {"x": torch.zeros((N_SHARDS, 16, 3), device=dev)},
        {"x": torch.ones((N_SHARDS, _N_SPILL, 3), device=dev)},
        np.zeros(N_SHARDS, np.int64)))


def tiers_compact_ragged(dev):
    from repro_torch.warehouse.tiers import _compact_ragged

    def compact(cols, d):
        _compact_ragged(cols, d)
        return cols

    return EngineExample(compact, (
        {"x": torch.ones((N_SHARDS, 16, 3), device=dev)},
        np.asarray([4, 0])))


def tiers_materialize_sharded(dev):
    from repro_torch.warehouse.tiers import (_materialize_sharded,
                                             _quantize_chunks_sharded)
    cols = store_cols(dev, stacked=True)
    q, scales, ints = _quantize_chunks_sharded(cols, _draws(dev), n=_N_SPILL,
                                               chunk=_CHUNK)
    return EngineExample(_materialize_sharded,
                         (q, scales, ints, cols, np.asarray([_N_SPILL, 0])),
                         {"chunk": _CHUNK})


# ---- the list ---------------------------------------------------------------

ENGINES: Dict[str, Callable[[torch.device], EngineExample]] = {
    "switch_step": switch_step,
    "switch_step_multi": switch_step_multi,
    "run_window": run_window,
    "run_window_multi": run_window_multi,
    "fused_single": fused_single,
    "fused_single_telemetry": lambda d: fused_single(d, telemetry=True),
    "fused_multi": fused_multi,
    "fused_multi_telemetry": lambda d: fused_multi(d, telemetry=True),
    "pool_replan": pool_replan,
    "pool_shift": pool_shift,
    "pool_replan_stacked": pool_replan_stacked,
    "pool_tick": pool_tick,
    "pool_admit": pool_admit,
    "pool_retire": pool_retire,
    "forecaster_adam": adam_step,
    "kmeans_lloyd": lloyd_step,
    "classify_full": classify_full,
    "classify_1d": classify_1d,
    "lp_lagrangian": lp_lagrangian,
    "warehouse_query_filter_groupby":
        lambda d: query(d, "filter_groupby"),
    "warehouse_query_window": lambda d: query(d, "window_sum"),
    "warehouse_query_multi_topk": lambda d: query(d, "multi_topk"),
    "warehouse_query_pallas_groupby":
        lambda d: query(d, "filter_groupby", True),
    "warehouse_query_pallas_window": lambda d: query(d, "window_sum", True),
    "warehouse_query_pallas_groupmax": lambda d: query(d, "group_max", True),
    "warehouse_query_pallas_multi": lambda d: query(d, "multi_topk", True),
    "warehouse_query_sharded_groupby":
        lambda d: query_sharded(d, "filter_groupby"),
    "warehouse_query_sharded_topk": lambda d: query_sharded(d, "topk"),
    "warehouse_query_pallas_sharded":
        lambda d: query_sharded(d, "filter_groupby", True),
    "warehouse_scatter": store_scatter,
    "warehouse_scatter_standing": lambda d: store_scatter(d, standing=True),
    "warehouse_ingest_fused": store_ingest_fused,
    "warehouse_ingest_fused_multi": store_ingest_fused_multi,
    "warehouse_ingest_tick": store_ingest_tick,
    "warehouse_ingest_tick_masked":
        lambda d: store_ingest_tick(d, masked=True),
    "warehouse_ingest_tick_standing":
        lambda d: store_ingest_tick(d, standing=True),
    "warehouse_append_sharded": lambda d: store_sharded(d, "append"),
    "warehouse_ingest_sharded_fused":
        lambda d: store_sharded(d, "fused_multi"),
    "warehouse_ingest_sharded_tick": lambda d: store_sharded(d, "tick"),
    "warehouse_ingest_sharded_standing":
        lambda d: store_sharded(d, "standing"),
    "warehouse_ingest_sharded_tick_ids":
        lambda d: store_sharded(d, "tick_ids"),
    "store_rebalance": store_rebalance,
    "standing_backfill": lambda d: standing_backfill(d, "filter_groupby"),
    "standing_backfill_pallas":
        lambda d: standing_backfill(d, "group_max", True),
    "standing_fold_sharded": standing_fold_sharded,
    "standing_answer": lambda d: standing_answer(d, False),
    "standing_answer_sharded": lambda d: standing_answer(d, True),
    "tiers_quantize": tiers_quantize,
    "tiers_compact": tiers_compact,
    "tiers_materialize": tiers_materialize,
    "tiers_quantize_sharded": tiers_quantize_sharded,
    "tiers_cold_write": tiers_cold_write,
    "tiers_compact_ragged": tiers_compact_ragged,
    "tiers_materialize_sharded": tiers_materialize_sharded,
}


def build(name: str, device) -> EngineExample:
    """The example of engine ``name`` on ``device``."""
    return ENGINES[name](torch.device(device))
