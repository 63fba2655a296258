"""The port's store and query engine against the reference, on the CPU.

- ``host_rows()`` after the same sequence of a fused run's sink ingest,
  ``ingest_fused`` and ``append_rows`` equals the reference's, through
  several rungs of the capacity ladder (``chunk_rows=512``);
- ``execute`` on the README plans (Filter + WindowAgg + TopK, Filter +
  GroupBy mean, MultiGroupBy window x category on ``out``) and on
  plans only the engine path takes (a row plan with Project, a TopK
  reducer, a wide sum) equals ``execute_ref`` and the reference's
  ``execute`` bit for bit, on both of the port's paths (the kernel's
  plain version and ``_seg_partial``): on the CPU every path adds in
  row order, as the reference's numpy mirror and XLA path do.
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
from repro_torch.configs.workloads import COVID as P_COVID
from repro_torch.core import ingest as PI
from repro_torch.data.stream import generate as p_generate
from repro_torch.warehouse import (Filter, GroupBy, MultiGroupBy, Project,
                                   SegmentStore, TopK, WindowAgg, execute,
                                   to_host, windows_for)
from repro_torch.warehouse import query as Q
from repro_torch.warehouse import store as PS
from _torch_threads import cap_torch_threads

cap_torch_threads()

CHUNK = 512
KW = dict(n_cores=8, cloud_budget_core_s=2000.0, plan_days=0.02)


def _extra_rows(n, seed, K):
    rng = np.random.default_rng(seed)
    return {
        "stream_id": rng.integers(1, 9, n).astype(np.int32),
        "t": np.sort(rng.integers(0, 2500, n)).astype(np.int32),
        "category": rng.integers(0, 4, n).astype(np.int32),
        "k": rng.integers(0, K, n).astype(np.int32),
        "quality": rng.random(n).astype(np.float32),
        "on_core_s": (rng.random(n) * 20).astype(np.float32),
        "cloud_core_s": (rng.random(n) * 3).astype(np.float32),
        "buffer_s": (rng.random(n) * 50).astype(np.float32),
        "out": rng.random((n, K)).astype(np.float32),
    }


def _traces(T, seed, K):
    """A fused run's stacked (n_w, W) trace leaves, padded at the end."""
    rng = np.random.default_rng(seed)
    W = 300
    n_w = -(-T // W)
    return {
        "c": rng.integers(0, 4, (n_w, W)).astype(np.int32),
        "k": rng.integers(0, K, (n_w, W)).astype(np.int32),
        "qual": rng.random((n_w, W)).astype(np.float32),
        "on_s": (rng.random((n_w, W)) * 9).astype(np.float32),
        "cl_s": (rng.random((n_w, W)) * 2).astype(np.float32),
        "buffer_s": (rng.random((n_w, W)) * 30).astype(np.float32),
    }, rng.random((T, K)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _stores():
    """The same ingest sequence on both sides; returns (ref, port)."""
    K = len(ref_fitted().configs)
    ref = RW.SegmentStore(out_dim=K, chunk_rows=CHUNK)
    got = SegmentStore(out_dim=K, chunk_rows=CHUNK, device="cpu")
    caps = []
    RI.run_skyscraper_fused(ref_fitted(), generate(COVID, days=0.05, seed=8),
                            sink=ref, **KW)
    PI.run_skyscraper_fused(port_fitted(),
                            p_generate(P_COVID, days=0.05, seed=8),
                            sink=got, device="cpu", **KW)
    caps.append((ref.capacity, got.capacity))
    rows = _extra_rows(700, 1, K)
    ref.append_rows({k: jnp.asarray(v) for k, v in rows.items()})
    got.append_rows(rows)
    caps.append((ref.capacity, got.capacity))
    traces, out = _traces(1333, 2, K)
    ref.ingest_fused({k: jnp.asarray(v) for k, v in traces.items()},
                     jnp.asarray(out), stream_id=9, t0=50)
    got.ingest_fused({k: torch.as_tensor(v) for k, v in traces.items()},
                     torch.as_tensor(out), stream_id=9, t0=50)
    caps.append((ref.capacity, got.capacity))
    return ref, got, caps


def test_host_rows_equal_through_ladder_growth():
    ref, got, caps = _stores()
    assert [g for _, g in caps] == [r for r, _ in caps]
    assert [g for _, g in caps] == [4096, 4096, 8192]    # 0 -> 2 rungs
    assert got.n_rows == ref.n_rows == 2160 + 700 + 1333
    assert got.t_max == ref.t_max
    want, have = ref.host_rows(), got.host_rows()
    assert set(have) == set(want)
    for k in want:
        assert have[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)


def test_bucket_cap_ladder():
    for need in (1, 511, 512, 513, 1024, 1025, 5000, 70_000):
        assert PS._bucket_cap(need, CHUNK) == \
            RW.store._bucket_cap(need, CHUNK)


def _plans(store):
    nw = windows_for(store, 150)
    return {
        "window_topk": (Filter("quality", "ge", 0.6),
                        WindowAgg(window=150, value="quality", agg="mean",
                                  num_windows=nw),
                        TopK(5, by="quality", largest=False)),
        "groupby_mean": (Filter("quality", "ge", 0.6),
                         GroupBy("category", "quality", agg="mean",
                                 num_groups=4)),
        "window_x_category": (MultiGroupBy(keys=("t", "category"),
                                           value="out", agg="mean",
                                           nums=(nw, 4), windows=(150, 0)),),
        "stream_max": (Filter("stream_id", "le", 8.5),
                       GroupBy("stream_id", "buffer_s", agg="max",
                               num_groups=10)),
        "rows": (Filter("k", "ne", 0), Filter("on_core_s", "lt", 12.0),
                 Project(("t", "k", "on_core_s"))),
        "topk_rows": (Filter("category", "eq", 2),
                      TopK(7, by="on_core_s")),
        "wide_sum_topk": (GroupBy("category", "out", agg="sum",
                                  num_groups=4),
                          TopK(2, by="count")),
    }


PLANS = ("window_topk", "groupby_mean", "window_x_category", "stream_max",
         "rows", "topk_rows", "wide_sum_topk")


def _equal(table, mask, want, wmask):
    np.testing.assert_array_equal(mask.numpy(), np.asarray(wmask))
    assert set(table) == set(want)
    for k in want:
        np.testing.assert_array_equal(table[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("name", PLANS)
def test_execute_bit_exact(name):
    ref, got, _ = _stores()
    plan = _plans(got)[name]
    cols = {k: np.asarray(v) for k, v in ref.columns.items()}
    want, wmask = RW.execute_ref(cols, ref.n_rows, ref_plan(plan))
    rt, rm = RW.execute(ref, ref_plan(plan), use_pallas=False)
    for uk in (None, False):
        table, mask = execute(got, plan, use_kernel=uk)
        _equal(table, mask, want, wmask)
        _equal(table, mask, rt, rm)
    assert to_host(table, mask).keys() == RW.to_host(rt, rm).keys()


def test_store_query_method_counts_paths():
    _, got, _ = _stores()
    plans = _plans(got)
    Q.PATHS.update(kernel=0, engine=0)
    got.query(plans["groupby_mean"])
    got.query(plans["window_x_category"], use_kernel=False)
    got.query(plans["rows"])                 # no reducer: counted nowhere
    assert Q.PATHS == {"kernel": 1, "engine": 1}


def test_windows_for_matches_reference():
    ref, got, _ = _stores()
    for w in (1, 60, 150, 10_000):
        assert windows_for(got, w) == RW.windows_for(ref, w)


def test_empty_store_and_append_nothing():
    s = SegmentStore(out_dim=3, device="cpu")
    assert len(s) == 0 and s.capacity == 0
    assert s.host_rows()["out"].shape == (0, 3)
    table, mask = s.query((GroupBy("k", "quality", agg="max",
                                   num_groups=3),))
    assert not mask.any() and float(table["quality"].abs().sum()) == 0.0
