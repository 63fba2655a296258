"""Kernel K1 (``csrc/warehouse_agg.cu``) on the card against its plain
version on the same CUDA tensors. ``cuda``-marked: every test skips
where no card is visible. On a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: counts, max, min and integer-valued sums exactly; float
sums and means to 1e-5 relative to the sum of magnitudes (the kernel's
shared-memory atomics add a block's rows in another order than the
plain version's ``index_add_``; both are float32 sums of at most a few
thousand terms per group and block here).

This file imports neither JAX nor ``repro``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import warehouse_agg as K
from repro_torch.warehouse import (Filter, GroupBy, MultiGroupBy,
                                   SegmentStore, WindowAgg, execute)
from repro_torch.warehouse import query as Q

AGGS = ("sum", "mean", "count", "max", "min")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA; none is visible")
    return torch.device("cuda")


def _store(device, n=50_000, seed=0, D=9):
    rng = np.random.default_rng(seed)
    s = SegmentStore(out_dim=D, chunk_rows=8192, device=device)
    s.append_rows({
        "stream_id": rng.integers(0, 16, n).astype(np.int32),
        "t": np.sort(rng.integers(0, 40_000, n)).astype(np.int32),
        "category": rng.integers(0, 4, n).astype(np.int32),
        "k": rng.integers(0, D, n).astype(np.int32),
        "quality": rng.random(n).astype(np.float32),
        "on_core_s": (rng.random(n) * 20 - 5).astype(np.float32),
        "cloud_core_s": (rng.random(n) * 5).astype(np.float32),
        "buffer_s": (rng.random(n) * 40).astype(np.float32),
        "out": rng.random((n, D)).astype(np.float32),
    })
    return s


def _close(got, want, exact, scale=None):
    got, want = got.double().cpu(), want.double().cpu()
    if exact:
        assert torch.equal(got, want)
    else:
        tol = 1e-5 * (scale.double().cpu() if scale is not None
                      else want.abs()) + 1e-6
        assert bool(((got - want).abs() <= tol).all())


def _vs_plain(store, plan, value, agg):
    Q.PATHS.update(kernel=0, engine=0)
    before = K.LAUNCHES
    tk, mk = execute(store, plan, use_kernel=True)
    assert K.LAUNCHES == before + 1 and Q.PATHS["kernel"] == 1
    tp, mp = execute(store, plan, use_kernel=False)
    assert torch.equal(mk.cpu(), mp.cpu())
    _close(tk["count"], tp["count"], exact=True)
    exact = agg in ("count", "max", "min")
    _close(tk[value], tp[value], exact)


@pytest.mark.cuda
@pytest.mark.parametrize("agg", AGGS)
def test_groupby_matches_plain(cuda, agg):
    store = _store(cuda)
    for plan in ((Filter("quality", "ge", 0.3),
                  GroupBy("category", "on_core_s", agg=agg, num_groups=5)),
                 (Filter("stream_id", "lt", 7.5), Filter("k", "ne", 2),
                  GroupBy("stream_id", "buffer_s", agg=agg,
                          num_groups=16))):
        _vs_plain(store, plan, plan[-1].value, agg)


@pytest.mark.cuda
@pytest.mark.parametrize("agg", ("sum", "mean", "count"))
def test_wide_window_x_category(cuda, agg):
    store = _store(cuda)
    plan = (Filter("k", "le", 6),
            MultiGroupBy(keys=("t", "category"), value="out", agg=agg,
                         nums=(267, 4), windows=(150, 0)))
    _vs_plain(store, plan, "out", agg)


@pytest.mark.cuda
@pytest.mark.parametrize("agg", AGGS)
def test_window_agg_and_integer_sums(cuda, agg):
    store = _store(cuda)
    _vs_plain(store, (WindowAgg(window=600, value="quality", agg=agg,
                                num_windows=67),), "quality", agg)
    # an integer column: its sums are exact on both paths
    plan = (GroupBy("category", "k", agg=agg, num_groups=4),)
    tk, _ = execute(store, plan, use_kernel=True)
    tp, _ = execute(store, plan, use_kernel=False)
    _close(tk["k"], tp["k"], exact=True)


@pytest.mark.cuda
@pytest.mark.parametrize("agg", AGGS)
def test_global_accumulators_match_plain(cuda, agg):
    """64,000 groups: past shared memory, so the blocks accumulate in
    global memory."""
    store = _store(cuda)
    node = MultiGroupBy(keys=("stream_id", "t"), value="buffer_s", agg=agg,
                        nums=(16, 4000), windows=(0, 10))
    spec = K.FusedAggSpec((), (("stream_id", 16, 0), ("t", 4000, 10)),
                          "buffer_s", agg)
    assert K.accumulator_mode(spec, 0) == "global"
    _vs_plain(store, (Filter("quality", "ge", 0.2), node), "buffer_s", agg)


@pytest.mark.cuda
def test_default_path_on_the_card_is_the_kernel_or_raises(cuda):
    store = _store(cuda, n=1000)
    wide = (MultiGroupBy(keys=("t", "category"), value="out", agg="mean",
                         nums=(4000, 4), windows=(10, 0)),)
    Q.PATHS.update(kernel=0, engine=0)
    before = K.LAUNCHES
    execute(store, wide)
    assert K.LAUNCHES == before + 1 and Q.PATHS["kernel"] == 1
    too_many = tuple(Filter("quality", "ge", 0.1 * j)
                     for j in range(K.MAX_FILTERS + 1)) + (
        GroupBy("category", "quality", num_groups=4),)
    with pytest.raises(ValueError, match="filters"):
        execute(store, too_many)
    assert K.LAUNCHES == before + 1 and Q.PATHS["engine"] == 0


@pytest.mark.cuda
def test_int_pred_edges(cuda):
    x = torch.tensor([-2 ** 31, -7, -6, -1, 0, 1, 5, 6, 2 ** 31 - 1],
                     dtype=torch.int32, device=cuda)
    cols = {"x": x, "g": torch.zeros_like(x)}
    for op in ("eq", "ne", "lt", "le", "gt", "ge"):
        for v in (-2.0 ** 31 - 0.7, -6.5, -6.0, -0.5, 0.0, 5.0, 6.999,
                  2.0 ** 31 - 1, 2.0 ** 31, float("-inf"), float("inf")):
            want = Q._CMP[op](x.cpu().double(), v).sum()
            table, _ = execute((cols, len(x)), (
                Filter("x", op, v), GroupBy("g", "x", agg="count",
                                            num_groups=1)),
                use_kernel=True)
            assert int(table["count"][0]) == int(want), (op, v)


@pytest.mark.cuda
def test_ragged_and_empty(cuda):
    store = _store(cuda, n=3000)
    cols = {k: v.clone() for k, v in store.columns.items()}
    cols["quality"][2000:] = 1e9
    plan = (GroupBy("category", "quality", agg="max", num_groups=4),)
    tk, _ = execute((cols, 2000), plan, use_kernel=True)
    tp, _ = execute((cols, 2000), plan, use_kernel=False)
    _close(tk["quality"], tp["quality"], exact=True)
    assert float(tk["quality"].max()) < 1.0
    empty = SegmentStore(out_dim=3, device=cuda)
    for agg in AGGS:
        spec = K.FusedAggSpec((), (("category", 4, 0),), "quality", agg)
        part = K.fused_segment_agg(empty.columns, 0, ((), (), (), ()), spec)
        assert float(part["cnt"].abs().sum()) == 0.0
        fill = {"max": float("-inf"), "min": float("inf")}.get(agg, 0.0)
        assert bool((part["acc"] == fill).all())
