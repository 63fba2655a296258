"""Kernels K1 (``csrc/warehouse_agg.cu``), K2 (``csrc/frame_preproc.cu``),
K3 (``csrc/flash_attention.cu``) and K4 (``csrc/ssd_scan.cu``) on the
card against their plain versions on the same CUDA tensors (hymba-1.5b's
and mixtral-8x7b's prefill shapes among them), the reduced qwen,
mamba2, hymba and mixtral models on the card against the same models on
the CPU, a short fused run's flight-recorder counters against
``obs.telemetry_ref``, and the per-window loop and the optimum on the
card against the CPU, the reduced whisper on the card against the CPU
(K3 at whisper's full-size shapes too), the float8 kv cache's writes
on the card, K3's backward kernel against its plain version
(``bwd_error_bound``) at every head dim and tile, bfloat16 through
``csrc/flash_attention_bwd_bf16.cu`` (held to that bound's bfloat16
terms), the same bits on two launches, gradients through K3 on the card
(the kernel's, nonzero), a bfloat16 train step of a cut qwen1.5-0.5b
launching the bfloat16 backward once per layer, K4's backward kernel
(``csrc/ssd_scan_bwd.cu``; bfloat16 through ``csrc/ssd_scan_bwd_bf16.cu``,
held to that bound's bfloat16 terms) within its ``bwd_error_bound`` with
the same bits on two launches, a bfloat16 train step of a reduced
mamba2-370m launching the bfloat16 backward once per layer, the kernels
without a backward refusing a gradient by name (K2, and K4's one-pass
``launch``), and one train step of the reduced dense, MoE, vlm,
encoder-decoder, SSM and hybrid models on the card against the CPU
(1e-5), the dispatch tracer's host-synchronisation counter and its K1
engines' launch counts. ``cuda``-marked: every test
skips where no card is visible. On a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: counts, max, min and integer-valued sums exactly; float
sums and means to 1e-5 relative to the sum of magnitudes (the kernel's
shared-memory atomics add a block's rows in another order than the
plain version's ``index_add_``; both are float32 sums of at most a few
thousand terms per group and block here). K2: float32 within
f^2 * 2^-24 * max|x| (a sum of f^2 terms in another order), bfloat16
within one bfloat16 ulp. K3: within Skv * 2^-24 * max|v| (float32 sums
over Skv keys in another order). K4: y and the final state within
``kernels.ssd.error_bound`` of the plain version run in float64 (the
float32 sums' lengths times their sums of magnitudes, the cumsum's
roundings in each decay exponent and the 3xTF32 products' terms); each
of K4's five passes within the bound ``kernels.ssd.pass_errors`` states
for it, against its plain version in float64 on the same inputs. The
models' logits: 1e-4 (float32 matmuls, attention and scans in other
orders, two layers). bfloat16 operands: K3 and K4 within their
``error_bound`` on the widened inputs (each with its bfloat16 kernel's
own terms; K4's bfloat16 passes each within ``pass_errors``' bfloat16
bound, its gradient through the bfloat16 forward's scratch within
``bwd_error_bound``) plus the rounding of the output to
bfloat16 (``BF16_ROUND``, half an ulp, times |out|); the reduced models
at the default RunOptions (bfloat16) on the card against the port's CPU
run within ``models.options.bf16_logit_tolerance`` (mixtral's with its
routing pinned to the CPU run's choices: a bfloat16 ulp can move a
token to another expert, a discrete change the tolerance does not
cover; ``tests/test_torch_moe.py`` says more). The per-window loop:
k and c traces and ``k_hist`` equal to the CPU run's, the sums within
1e-5 relative; the optimum's selection equal. Standing answers on
the card (K1's delta folds) against ``store.query`` on the same rows:
masks, counts, max and min exactly, float sums and means within 1e-5 of
each group's sum of magnitudes. The batched switch, a short
multi-stream run, the pool's ticks and a spill of the cold tier on the
card against the same on the CPU: decisions, states, counters, rows
and tier codes bit for bit (elementwise float32 operations and exact
count adds only). The sharded store: each shard's K1 partial (empty
shards and fold views at unaligned rows among them) against the plain
version as above; the store on the card against the same batches on the
CPU, rows, rebalanced rows and cold codes bit for bit, answers within
the tolerance above; a warehouse saved on the card loads on the CPU bit
for bit. The store spread over a world of NCCL ranks (one a card)
against the stacked store on the card, bit for bit on rows whose sums
are exact.

This file imports neither JAX nor ``repro``.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import frame_preproc as FP
from repro_torch.kernels import ssd as SSD
from repro_torch.kernels import warehouse_agg as K
from repro_torch.models.model import Model
from repro_torch.models.options import RunOptions, bf16_logit_tolerance
from repro_torch.runtime import steps as S
from repro_torch.warehouse import (Filter, GroupBy, MultiGroupBy,
                                   SegmentStore, StandingQueries, TopK,
                                   WindowAgg, execute)
from repro_torch.warehouse import query as Q
from repro_torch.warehouse import standing as ST
from _torch_threads import cap_torch_threads

cap_torch_threads()

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


def _k1_vs_plain(cols, n, fvals, spec):
    """K1 against its plain version run with the value column in float64:
    counts, max and min exactly, float sums within 1e-5 of each group's
    sum of magnitudes."""
    got = K.fused_segment_agg(cols, n, fvals, spec)
    v64 = cols[spec.value][:n].double()
    want = K.fused_segment_agg_ref({**cols, spec.value: v64}, n, fvals, spec)
    assert torch.equal(got["cnt"].cpu(), want["cnt"].cpu())
    g, w = got["acc"].double().cpu(), want["acc"].double().cpu()
    if spec.agg in ("max", "min"):
        assert torch.equal(g, w)
    else:
        scale = K.fused_segment_agg_ref({**cols, spec.value: v64.abs()}, n,
                                        fvals, spec)["acc"].cpu()
        assert bool(((g - w).abs() <= 1e-5 * scale + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shift", (1, 2, 3))
def test_k1_unaligned_column_views(cuda, shift):
    """Columns viewed from row ``shift``: bases off 16 bytes, a head of
    scalar rows before the first aligned strip; and a column whose
    alignment no row can match the others' (every row scalar)."""
    store = _store(cuda, n=5000)
    cols = {k: v[shift:] for k, v in store.columns.items()}
    n = 5000 - shift
    for agg in AGGS:
        for value, keys in (("buffer_s", (("category", 4, 0),)),
                            ("out", (("t", 267, 150), ("category", 4, 0)))):
            if value == "out" and agg in ("max", "min"):
                continue
            spec = K.FusedAggSpec((("quality", "ge", 0),), keys, value, agg)
            _, fvals = Q.normalize((Filter("quality", "ge", 0.3),))
            _k1_vs_plain(cols, n, fvals, spec)
    mixed = dict(store.columns)
    mixed["buffer_s"] = store.columns["buffer_s"][1:]
    spec = K.FusedAggSpec((), (("category", 4, 0),), "buffer_s", "max")
    _k1_vs_plain(mixed, 4000, ((), (), (), ()), spec)


@pytest.mark.cuda
@pytest.mark.parametrize("n", (1, 3, 5, 4 * 1000 + 3))
def test_k1_short_and_ragged_row_counts(cuda, n):
    """Row counts that leave a scalar tail, with columns holding exactly
    ``n`` rows (no slack past the live rows)."""
    store = _store(cuda, n=n, seed=n)
    cols = {k: v[:n].contiguous() for k, v in store.columns.items()}
    for agg in AGGS:
        spec = K.FusedAggSpec((("quality", "ge", 0),),
                              (("category", 4, 0),), "on_core_s", agg)
        _, fvals = Q.normalize((Filter("quality", "ge", 0.2),))
        _k1_vs_plain(cols, n, fvals, spec)
    wide = K.FusedAggSpec((), (("category", 4, 0),), "out", "sum")
    _k1_vs_plain(cols, n, ((), (), (), ()), wide)


@pytest.mark.cuda
@pytest.mark.parametrize("agg", AGGS)
def test_k1_warp_group_patterns(cuda, agg):
    """Every warp's rows in 32 (and 128) different groups, and every
    row in one group, for scalar and wide values."""
    n = 1 << 14
    rng = np.random.default_rng(3)
    cols = {"g_all": torch.arange(n, dtype=torch.int32, device=cuda),
            "g_one": torch.zeros(n, dtype=torch.int32, device=cuda),
            "g_mix": torch.as_tensor((np.arange(n) // 3 * 7919 % 997)
                                     .astype(np.int32), device=cuda),
            "x": torch.as_tensor(rng.normal(0, 1, n).astype(np.float32),
                                 device=cuda),
            "w": torch.as_tensor(rng.normal(0, 1, (n, 5)).astype(np.float32),
                                 device=cuda)}
    for key, num in (("g_all", n), ("g_one", 1), ("g_mix", 997)):
        for value in ("x", "w"):
            if value == "w" and agg in ("max", "min"):
                continue
            spec = K.FusedAggSpec((), ((key, num, 0),), value, agg)
            _k1_vs_plain(cols, n, ((), (), (), ()), spec)


@pytest.mark.cuda
@pytest.mark.parametrize("agg", ("max", "min"))
def test_k1_max_min_signed_zeros_infinities_global(cuda, agg):
    """max and min through the ordered-int atomics: groups holding only
    -0.0 and +0.0, only -inf or +inf, negatives and NaN rows, in shared
    and in global mode."""
    n = 4096
    vals = np.array([-0.0, 0.0, -np.inf, np.inf, -3.5, -1e-38, 2.5, np.nan],
                    np.float32)
    x = np.resize(vals, n).astype(np.float32)
    for num in (8, 70_000):
        g = (np.arange(n) % 8) * (num // 8)
        g[::5] = (np.arange(n)[::5] // 5) % num    # other groups mix values
        cols = {"g": torch.as_tensor(g.astype(np.int32), device=cuda),
                "x": torch.as_tensor(x, device=cuda)}
        spec = K.FusedAggSpec((), (("g", num, 0),), "x", agg)
        assert K.accumulator_mode(spec, 0) == ("shared" if num == 8
                                               else "global")
        got = K.fused_segment_agg(cols, n, ((), (), (), ()), spec)
        acc = np.full(num, -np.inf if agg == "max" else np.inf)
        fold = np.fmax if agg == "max" else np.fmin        # NaN skipped
        for gi, xi in zip(g, x.astype(np.float64)):
            acc[gi] = fold(acc[gi], xi)
        np.testing.assert_array_equal(got["acc"].cpu().numpy(), acc)
        np.testing.assert_array_equal(got["cnt"].cpu().numpy(),
                                      np.bincount(g, minlength=num))


# ---------------------------------------------------------------- K2 ----
def _k2_tol(want, x, f):
    tol = f * f * 2.0 ** -24 * float(x.float().abs().max()) + 1e-7
    if want.dtype == torch.bfloat16:
        tol += 2.0 ** -7 * float(want.float().abs().max())
    return tol


@pytest.mark.cuda
@pytest.mark.parametrize("factor", (2, 3, 4))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("shape", ((5, 48, 72, 3), (96, 60, 4)))
def test_k2_matches_plain(cuda, factor, dtype, shape):
    x = torch.randn(shape, device=cuda).to(dtype)
    before = FP.LAUNCHES
    got = FP.downsample(x, factor)
    torch.cuda.synchronize()
    assert FP.LAUNCHES == before + 1
    want = FP.downsample_ref(x, factor)
    assert got.shape == want.shape and got.dtype == dtype
    assert float((got.float() - want.float()).abs().max()) <= \
        _k2_tol(want, x, factor)


@pytest.mark.cuda
def test_k2_strided_frame_axis(cuda):
    x = torch.randn((12, 64, 96, 3), device=cuda)
    for s in (2, 4):
        got = FP.downsample(x[::s], 2)
        want = FP.downsample_ref(x[::s].contiguous(), 2)
        assert float((got - want).abs().max()) <= _k2_tol(want, x, 2)


@pytest.mark.cuda
def test_k2_refuses(cuda):
    before = FP.LAUNCHES
    with pytest.raises(TypeError, match="floating"):
        FP.downsample(torch.zeros((4, 8, 3), dtype=torch.int32,
                                  device=cuda), 2)
    with pytest.raises(TypeError, match="float32 and bfloat16"):
        FP.downsample(torch.zeros((4, 8, 3), dtype=torch.float16,
                                  device=cuda), 2)
    with pytest.raises(ValueError, match="divide"):
        FP.downsample(torch.zeros((6, 8, 3), device=cuda), 4)
    with pytest.raises(ValueError, match="contiguous"):
        FP.downsample(torch.zeros((2, 8, 8, 6), device=cuda)[..., ::2], 2)
    assert FP.LAUNCHES == before


# ---------------------------------------------------------------- K3 ----
K3_CASES = (
    (2, 300, 300, 8, 2, 64, True, None),
    (2, 200, 333, 4, 4, 16, False, None),
    (1, 130, 197, 4, 2, 64, True, None),
    (1, 500, 500, 8, 4, 64, True, 32),
    (1, 600, 600, 4, 2, 64, True, 256),
    (4, 77, 77, 4, 4, 12, False, 32),
    (3, 130, 130, 4, 1, 128, True, None),
    (30, 16, 16, 4, 4, 8, True, None),
    (1, 300, 333, 4, 2, 128, True, 100),        # D = 128, ragged window
    # hymba-1.5b's prefill (B cut to 1): 25 heads over 5 kv heads (R = 5),
    # its window of 1,024 and its global layers; a ragged S
    (1, 2048, 2048, 25, 5, 64, True, 1024),
    (1, 2048, 2048, 25, 5, 64, True, None),
    (1, 1500, 1500, 25, 5, 64, True, 1024),
    # D = 128 with GQA 4 and a window (mixtral: 32 heads over 8 kv heads,
    # its window of 4,096 past the prefill's 2,048, B cut to 1), and a
    # window inside S
    (1, 2048, 2048, 32, 8, 128, True, 4096),
    (1, 700, 700, 8, 2, 128, True, 200),
)


@pytest.mark.cuda
@pytest.mark.parametrize("case", K3_CASES)
def test_k3_matches_plain(cuda, case):
    B, Sq, Skv, H, G, D, causal, window = case
    q = torch.randn((B, Sq, H, D), device=cuda)
    k = torch.randn((B, Skv, G, D), device=cuda)
    v = torch.randn((B, Skv, G, D), device=cuda)
    before = FA.LAUNCHES
    got = FA.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FA.LAUNCHES == before + 1
    want = FA.flash_attention_ref(q, k, v, causal=causal, window=window)
    bound = FA.error_bound(q, k, v, causal=causal, window=window)
    assert bool(((got - want).abs() <= bound).all())


@pytest.mark.cuda
def test_k3_stress_within_error_bound(cuda):
    """|q|, |k| up to 8: scores up to about 60, a sharp softmax."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    B, Sq, Skv, H, G, D = 1, 256, 256, 4, 2, 64
    q = 16 * torch.rand((B, Sq, H, D), generator=gen, device=cuda) - 8
    k = 16 * torch.rand((B, Skv, G, D), generator=gen, device=cuda) - 8
    v = torch.randn((B, Skv, G, D), generator=gen, device=cuda)
    got = FA.flash_attention(q, k, v, causal=True)
    want = FA.flash_attention_ref(q, k, v, causal=True)
    bound = FA.error_bound(q, k, v, causal=True)
    assert bool(((got - want).abs() <= bound).all())


@pytest.mark.cuda
def test_k3_refuses(cuda):
    q = torch.randn((1, 8, 4, 16), device=cuda)
    before = FA.LAUNCHES
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        FA.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError, match="one dtype"):
        FA.flash_attention(q, q.bfloat16(), q.bfloat16())
    big = torch.randn((1, 8, 4, 160), device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        FA.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_attention(q.transpose(1, 2), q, q)
    with pytest.raises(ValueError, match="group"):
        kv = q[:, :, :3].contiguous()
        FA.flash_attention(q, kv, kv)
    assert FA.LAUNCHES == before


# ------------------------------------------------------------ model ----
@pytest.mark.cuda
def test_model_on_card_matches_cpu(cuda):
    model = Model(get("qwen1.5-0.5b").reduced(),
                  RunOptions(compute_dtype="float32"))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    on_card = {k: ({kk: vv.to(cuda) for kk, vv in v.items()}
                   if isinstance(v, dict) else v.to(cuda))
               for k, v in params.items()}
    tokens = torch.randint(0, 256, (3, 40), generator=torch.Generator()
                           .manual_seed(1))
    before = FA.LAUNCHES
    got = model.forward_logits(on_card, {"tokens": tokens.to(cuda)})
    assert FA.LAUNCHES == before + model.cfg.n_layers
    want = model.forward_logits(params, {"tokens": tokens})
    assert float((got.cpu() - want).abs().max()) <= 1e-4


# ---------------------------------------------------------------- K4 ----
K4_CASES = (                 # B, S, H, P, G, N, chunk, init_state
    (2, 300, 4, 64, 1, 128, 256, False),     # S past one chunk, ragged
    (2, 300, 4, 64, 1, 128, 256, True),
    (1, 100, 8, 16, 2, 16, 256, True),       # S < chunk, G > 1
    (2, 130, 6, 64, 3, 16, 64, False),
    (1, 77, 4, 16, 4, 128, 16, True),        # chunk 16, G = H
    (3, 33, 3, 8, 3, 16, 8, False),          # test_kernels.py's uneven
    (2, 150, 8, 64, 2, 128, 256, True),      # S < chunk, G > 1, full widths
    (2, 61, 4, 16, 2, 32, 8, True),          # ragged last chunk at Q = 8
    (2, 2048, 25, 64, 1, 16, 256, False),    # hymba-1.5b's prefill, B = 2
    (1, 1500, 25, 64, 1, 16, 256, True),     # the same, ragged, a state in
)


def _k4_inputs(B, S, H, P, G, N, device, seed=0):
    """Drawn as the model draws them: dt = softplus(dt_bias + z), dt_bias
    from the ``dt_bias`` init range, A = -exp(A_log) from ``ssm_a``'s."""
    gen = torch.Generator().manual_seed(seed)
    u = 1e-3 + (1e-1 - 1e-3) * torch.rand(H, generator=gen)
    dt = torch.nn.functional.softplus(
        torch.log(torch.expm1(u)) + torch.randn(B, S, H, generator=gen))
    A = -(1.0 + 15.0 * torch.rand(H, generator=gen))
    args = (torch.randn(B, S, H, P, generator=gen), dt, A,
            torch.randn(B, S, G, N, generator=gen) * 0.3,
            torch.randn(B, S, G, N, generator=gen) * 0.3)
    init = torch.randn(B, H, P, N, generator=gen) * 0.5
    return [a.to(device) for a in args], init.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", K4_CASES)
def test_k4_matches_plain(cuda, case):
    B, S, H, P, G, N, chunk, with_init = case
    args, init = _k4_inputs(B, S, H, P, G, N, cuda)
    init = init if with_init else None
    before, before_bf16 = SSD.LAUNCHES, SSD.BF16_LAUNCHES
    y, state = SSD.ssd_scan(*args, chunk=chunk, init_state=init)
    torch.cuda.synchronize()
    assert SSD.LAUNCHES == before + 1 and SSD.BF16_LAUNCHES == before_bf16
    assert y.shape == (B, S, H, P) and state.shape == (B, H, P, N)
    want_y, want_state = SSD.ssd_scan_ref(
        *[a.double() for a in args], chunk=chunk,
        init_state=None if init is None else init.double())
    tol_y, tol_state = SSD.error_bound(*args, chunk=chunk, init_state=init)
    assert float((y.double() - want_y).abs().max()) <= tol_y
    assert float((state.double() - want_state).abs().max()) <= tol_state


@pytest.mark.cuda
@pytest.mark.parametrize("case", K4_CASES)
def test_k4_passes_match_plain(cuda, case):
    """Each pass against its plain version in float64, fed the kernels'
    own outputs of the passes before it; launching passes one by one
    counts no ``ssd_scan`` call."""
    B, S, H, P, G, N, chunk, with_init = case
    args, init = _k4_inputs(B, S, H, P, G, N, cuda, seed=1)
    before = SSD.LAUNCHES
    shares = SSD.pass_errors(*args, chunk=chunk,
                             init_state=init if with_init else None)
    assert SSD.LAUNCHES == before
    assert set(shares) == set(SSD.PASSES)
    assert max(shares.values()) <= 1.0, shares


@pytest.mark.cuda
def test_mamba_on_card_matches_cpu(cuda):
    model = Model(get("mamba2-370m").reduced(),
                  RunOptions(compute_dtype="float32", ssd_chunk=16))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    on_card = {k: ({kk: vv.to(cuda) for kk, vv in v.items()}
                   if isinstance(v, dict) else v.to(cuda))
               for k, v in params.items()}
    tokens = torch.randint(0, 256, (3, 40), generator=torch.Generator()
                           .manual_seed(1))
    before = SSD.LAUNCHES
    got = model.forward_logits(on_card, {"tokens": tokens.to(cuda)})
    assert SSD.LAUNCHES == before + model.cfg.n_layers
    want = model.forward_logits(params, {"tokens": tokens})
    assert float((got.cpu() - want).abs().max()) <= 1e-4
    # prefill and two decode steps: the same tokens as on the CPU
    nxt_c, cache_c = model.prefill(on_card, {"tokens": tokens.to(cuda)})
    nxt, cache = model.prefill(params, {"tokens": tokens})
    for _ in range(2):
        assert torch.equal(nxt_c.cpu(), nxt)
        nxt_c, cache_c = model.decode_step(on_card, cache_c, nxt_c)
        nxt, cache = model.decode_step(params, cache, nxt)
    assert torch.equal(nxt_c.cpu(), nxt)
    assert float((cache_c["layers"]["ssm"].cpu()
                  - cache["layers"]["ssm"]).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("S", (37, 80))
def test_hybrid_on_card_matches_cpu(cuda, S):
    """The reduced hymba in float32 (layer 0 global, layer 1 with a window
    of 32: S = 37 is short of 2W, S = 80 past it): K3 and K4 once per
    layer, the logits within 1e-4 of the CPU run, then a prefill and two
    decode steps with the same tokens as on the CPU."""
    model = Model(get("hymba-1.5b").reduced(),
                  RunOptions(compute_dtype="float32", ssd_chunk=16))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    on_card = {k: ({kk: vv.to(cuda) for kk, vv in v.items()}
                   if isinstance(v, dict) else v.to(cuda))
               for k, v in params.items()}
    tokens = torch.randint(0, 256, (3, S), generator=torch.Generator()
                           .manual_seed(1))
    before = FA.LAUNCHES, SSD.LAUNCHES
    got = model.forward_logits(on_card, {"tokens": tokens.to(cuda)})
    assert (FA.LAUNCHES - before[0], SSD.LAUNCHES - before[1]) == (2, 2)
    want = model.forward_logits(params, {"tokens": tokens})
    assert float((got.cpu() - want).abs().max()) <= 1e-4
    nxt_c, cache_c = model.prefill(on_card, {"tokens": tokens.to(cuda)},
                                   cache_len=S + 3)
    nxt, cache = model.prefill(params, {"tokens": tokens}, cache_len=S + 3)
    for _ in range(2):
        assert torch.equal(nxt_c.cpu(), nxt)
        nxt_c, cache_c = model.decode_step(on_card, cache_c, nxt_c)
        nxt, cache = model.decode_step(params, cache, nxt)
    assert torch.equal(nxt_c.cpu(), nxt)
    for name, leaf in cache["layers"].items():
        assert float((cache_c["layers"][name].cpu() - leaf).abs().max()) \
            <= 1e-4, name


# ------------------------------------------------------- bfloat16 ----
# chip_smoke.K3_BF16_CASES' shapes beyond K3_CASES: qwen1.5-110b's local
# prefill at (1, 4) (two warpgroups at D = 128), D = 128 with a ragged
# Skv over B > 1 (TMA's zero fill stays in its batch row), D = 12 at G =
# 1, one query against 1,500 keys; a trailing "shift" starts q, k and v
# one value past an aligned base, "lse" runs the forward with its
# log-sum-exp
K3_BF16_EXTRA = (
    (4, 2048, 2048, 16, 2, 128, True, None),
    (3, 300, 157, 4, 2, 128, False, None),
    (2, 90, 90, 4, 1, 12, True, None),
    (4, 1, 1500, 20, 20, 64, False, None),
    (2, 100, 120, 4, 2, 64, True, None, "shift"),
    (2, 300, 333, 8, 2, 128, True, 100, "lse"),
)


@pytest.mark.cuda
@pytest.mark.parametrize("case", K3_CASES + K3_BF16_EXTRA)
def test_k3_bfloat16_within_error_bound(cuda, case):
    """bfloat16 q, k, v through the bfloat16 kernel: the output in
    bfloat16, within the bfloat16 kernel's bound plus its rounding,
    against the plain version on the widened inputs in float32; with the
    log-sum-exp, that within ``lse_error_bound``."""
    B, Sq, Skv, H, G, D, causal, window, *extra = case
    gen = torch.Generator(device=cuda).manual_seed(11)
    shift = 1 if "shift" in extra else 0
    q, k, v = (torch.randn(math.prod(shape) + shift, generator=gen,
                           device=cuda).to(torch.bfloat16)[shift:]
               .view(shape) for shape in
               ((B, Sq, H, D), (B, Skv, G, D), (B, Skv, G, D)))
    before, before_bf16 = FA.LAUNCHES, FA.BF16_LAUNCHES
    if "lse" in extra:
        got, lse = FA.flash_attention_fwd_lse(q, k, v, causal=causal,
                                              window=window)
    else:
        got = FA.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FA.LAUNCHES == before + 1 and got.dtype == torch.bfloat16
    assert FA.BF16_LAUNCHES == before_bf16 + 1
    ref = FA.flash_attention_ref(q.float(), k.float(), v.float(),
                                 causal=causal, window=window)
    bound = FA.error_bound(q, k, v, causal=causal, window=window, ref=ref)
    assert bool(((got.float() - ref).abs() <= bound).all())
    if "lse" in extra:
        l64 = FA.lse_ref(q.double(), k.double(), causal=causal,
                         window=window)
        lb = FA.lse_error_bound(q.float(), k.float(), l64, causal=causal,
                                window=window)
        fin = torch.isfinite(l64)
        assert torch.equal(fin, torch.isfinite(lse))
        assert bool(((lse.double() - l64).abs()[fin] <= lb[fin]).all())


@pytest.mark.cuda
def test_k3_bfloat16_launch_shape(cuda):
    """The bfloat16 kernel's launch: 128 q rows (two warpgroups) a block
    from Sq = 256 on at D = 128 as at D = 64, one below; TMA where D %
    8 == 0, D >= 64 and the bases are 16-byte aligned, cp.async for
    D < 64, loads through registers otherwise."""
    def shape(Sq, D, shift=0):
        x = torch.zeros(Sq * D + shift, device=cuda,
                        dtype=torch.bfloat16)[shift:].view(1, Sq, 1, D)
        return FA.bf16_launch_shape(x, x, x)
    for D in (64, 128):
        got = shape(2048, D)
        assert (got["warpgroups"], got["q_rows"], got["load"]) == \
            (2, 128, "tma")
        assert got["head_dim_padded"] == D and got["threads"] == 288
        assert shape(255, D)["warpgroups"] == 1
    assert shape(300, 16)["load"] == "cp.async"
    assert shape(300, 12)["load"] == "registers"
    assert shape(300, 64, shift=1)["load"] == "registers"


@pytest.mark.cuda
@pytest.mark.parametrize("case", K4_CASES)
@pytest.mark.parametrize("dt_dtype", ("bfloat16", "float32"))
def test_k4_bfloat16_within_error_bound(cuda, case, dt_dtype):
    """bfloat16 x, B, C (dt in bfloat16 as the model passes it, or in
    float32; the state in, where there is one, in bfloat16) through the
    bfloat16 kernels (``csrc/ssd_scan_bf16.cu``): y in bfloat16 within
    the bfloat16 bound on the widened inputs plus its rounding, the final
    state in float32 within its bound."""
    B, S, H, P, G, N, chunk, with_init = case
    x, dt, A, Bm, Cm, init = _k4_bf16_inputs(case, dt_dtype, cuda, seed=2)
    before, before_bf16 = SSD.LAUNCHES, SSD.BF16_LAUNCHES
    y, state = SSD.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, init_state=init)
    torch.cuda.synchronize()
    assert SSD.LAUNCHES == before + 1
    assert SSD.BF16_LAUNCHES == before_bf16 + 1
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    want_y, want_state = SSD.ssd_scan_ref(
        *[t.double() for t in (x, dt, A, Bm, Cm)], chunk=chunk,
        init_state=None if init is None else init.double())
    tol_y, tol_state = SSD.error_bound(x, dt, A, Bm, Cm, chunk=chunk,
                                       init_state=init, ref_y=want_y)
    assert bool(((y.double() - want_y).abs() <= tol_y).all())
    assert float((state.double() - want_state).abs().max()) <= tol_state


def _k4_bf16_inputs(case, dt_dtype, device, seed):
    """``_k4_inputs`` with x, B, C (and the state in, where the case has
    one) in bfloat16 and dt in ``dt_dtype``."""
    B, S, H, P, G, N, chunk, with_init = case
    (x, dt, A, Bm, Cm), init = _k4_inputs(B, S, H, P, G, N, device, seed)
    bf = torch.bfloat16
    return (x.to(bf), dt.to(getattr(torch, dt_dtype)), A, Bm.to(bf),
            Cm.to(bf), init.to(bf) if with_init else None)


@pytest.mark.cuda
@pytest.mark.parametrize("case", K4_CASES)
def test_k4_bfloat16_passes_within_their_bounds(cuda, case):
    """Each pass of the bfloat16 kernels against its plain version in
    float64, fed the kernels' own outputs of the passes before it, within
    ``pass_errors``' bfloat16 bounds; one by one they count no call."""
    x, dt, A, Bm, Cm, init = _k4_bf16_inputs(case, "bfloat16", cuda, seed=3)
    before = (SSD.LAUNCHES, SSD.BF16_LAUNCHES)
    shares = SSD.pass_errors(x, dt, A, Bm, Cm, chunk=case[6],
                             init_state=init)
    assert (SSD.LAUNCHES, SSD.BF16_LAUNCHES) == before
    assert set(shares) == set(SSD.PASSES)
    assert max(shares.values()) <= 1.0, shares


@pytest.mark.cuda
@pytest.mark.parametrize("case", ((2, 300, 4, 64, 1, 128, 256, True),
                                  (1, 100, 8, 16, 2, 16, 64, False)))
def test_k4_bfloat16_gradient_through_its_scratch(cuda, case):
    """bfloat16 operands that need a gradient go through ``SsdScanFn``:
    the bfloat16 forward (one launch of each count), its scratch kept for
    the bfloat16 backward kernel (one launch of each count), whose
    gradients lie within ``bwd_error_bound``'s bfloat16 terms of the plain
    backward in float64."""
    B, S, H, P, G, N, chunk, with_init = case
    x, dt, A, Bm, Cm, init = _k4_bf16_inputs(case, "bfloat16", cuda, seed=4)
    leaves = [t.detach().requires_grad_() if t is not None else None
              for t in (x, dt, A, Bm, Cm, init)]
    gen = torch.Generator(device=cuda).manual_seed(6)
    dy = torch.randn(x.shape, generator=gen, device=cuda).to(x.dtype)
    dfinal = torch.randn((B, H, P, N), generator=gen, device=cuda)
    n0 = (SSD.LAUNCHES, SSD.BF16_LAUNCHES, SSD.BWD_LAUNCHES,
          SSD.BF16_BWD_LAUNCHES)
    y, state = SSD.ssd_scan(*leaves[:5], chunk=chunk, init_state=leaves[5])
    torch.autograd.backward((y, state), (dy, dfinal))
    torch.cuda.synchronize()
    assert (SSD.LAUNCHES - n0[0], SSD.BF16_LAUNCHES - n0[1],
            SSD.BWD_LAUNCHES - n0[2],
            SSD.BF16_BWD_LAUNCHES - n0[3]) == (1, 1, 1, 1)

    def f64(t):
        return None if t is None else t.double()
    want = SSD.ssd_scan_bwd_ref(*map(f64, (x, dt, A, Bm, Cm, dy, dfinal)),
                                chunk=chunk, init_state=f64(init))
    bound = SSD.bwd_error_bound(x, dt, A, Bm, Cm, dy, dfinal, chunk=chunk,
                                init_state=init, refs=want)
    for leaf, w, b in zip(leaves, want, bound):
        if leaf is None:
            continue
        assert leaf.grad.dtype == leaf.dtype
        assert bool(((leaf.grad.double() - w).abs() <= b).all())


@pytest.mark.cuda
def test_k4_bfloat16_refusals_and_launch(cuda):
    """bfloat16 x reaches only the bfloat16 kernels, which refuse by name
    what they do not take (before launching: no count moves); their
    launch: TMA for P = 64 and N = 128 on aligned bases, cp.async for N =
    16, registers for N = 20 or a base off 16 bytes."""
    (x, dt, A, Bm, Cm), init = _k4_inputs(1, 64, 4, 64, 1, 128, cuda)
    bf = torch.bfloat16
    xb, Bb, Cb = x.to(bf), Bm.to(bf), Cm.to(bf)
    before = (SSD.LAUNCHES, SSD.BF16_LAUNCHES)
    refused = (
        (TypeError, "Cm", (xb, dt, A, Bb, Cm), {}),
        (TypeError, "dt in", (xb, dt.half(), A, Bb, Cb), {}),
        (TypeError, "init_state in", (xb, dt, A, Bb, Cb),
         {"init_state": init.half()}),
        (ValueError, "head dims up to 64",
         (torch.zeros((1, 64, 4, 65), dtype=bf, device=cuda), dt, A, Bb, Cb),
         {}),
        (ValueError, "chunks of 1 to 256", (xb, dt, A, Bb, Cb),
         {"chunk": 512}),
        (ValueError, "x is not contiguous",
         (xb.transpose(1, 2).contiguous().transpose(1, 2), dt, A, Bb, Cb),
         {}),
    )
    for err, match, args, kw in refused:
        with pytest.raises(err, match=match):
            SSD.ssd_scan(*args, **kw)
    assert (SSD.LAUNCHES, SSD.BF16_LAUNCHES) == before
    shape = SSD.bf16_launch_shape(xb, Bb, Cb)
    assert (shape["x_load"], shape["bc_load"], shape["n_halves"]) == \
        ("tma", "tma", 2)

    def loads(N, shift=0):
        x = torch.zeros(64 * 4 * 64 + shift, dtype=bf,
                        device=cuda)[shift:].view(1, 64, 4, 64)
        b = torch.zeros(64 * N + shift, dtype=bf,
                        device=cuda)[shift:].view(1, 64, 1, N)
        shape = SSD.bf16_launch_shape(x, b, b)
        return shape["x_load"], shape["bc_load"]
    assert loads(16) == ("tma", "cp.async")
    assert loads(20) == ("tma", "registers")
    assert loads(128, shift=1) == ("registers", "registers")


@pytest.mark.cuda
def test_kernels_refuse_other_dtypes_by_name(cuda):
    """float16, which the reference's kernels take, is refused by name,
    and so is a mix the model path never passes."""
    (x, dt, A, Bm, Cm), _ = _k4_inputs(1, 16, 2, 8, 1, 8, cuda)
    h = torch.float16
    before = SSD.LAUNCHES
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        SSD.ssd_scan(x.to(h), dt.to(h), A, Bm.to(h), Cm.to(h))
    with pytest.raises(TypeError, match="Bm"):
        SSD.ssd_scan(x.bfloat16(), dt, A, Bm, Cm.bfloat16())
    with pytest.raises(TypeError, match="A in"):
        SSD.ssd_scan(x, dt, A.bfloat16(), Bm, Cm)
    with pytest.raises(TypeError, match="dt in"):
        SSD.ssd_scan(x, dt.bfloat16(), A, Bm, Cm)
    assert SSD.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ("qwen1.5-0.5b", "mamba2-370m",
                                  "hymba-1.5b"))
def test_models_at_default_options_on_card_match_cpu(cuda, arch):
    """The reduced models at the default RunOptions (bfloat16 compute)
    through K3 / K4 (the hybrid: both, K3 with its window in layer 1) on
    the card, against the port's CPU run (the plain versions), within
    ``bf16_logit_tolerance``; then a prefill and two decode steps."""
    model = Model(get(arch).reduced(), RunOptions())
    assert model.opts.compute_dtype == "bfloat16"
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    on_card = {k: ({kk: vv.to(cuda) for kk, vv in v.items()}
                   if isinstance(v, dict) else v.to(cuda))
               for k, v in params.items()}
    tokens = torch.randint(0, 256, (3, 40), generator=torch.Generator()
                           .manual_seed(1))
    kernels = {"dense": (FA,), "ssm": (SSD,),
               "hybrid": (FA, SSD)}[model.cfg.family]
    before = [kn.LAUNCHES for kn in kernels]
    got = model.forward_logits(on_card, {"tokens": tokens.to(cuda)})
    assert [kn.LAUNCHES - b for kn, b in zip(kernels, before)] == \
        [model.cfg.n_layers] * len(kernels)
    assert got.dtype == torch.bfloat16
    want = model.forward_logits(params, {"tokens": tokens}).float()
    tol = bf16_logit_tolerance(model.cfg.n_layers, float(want.abs().max()))
    assert float((got.float().cpu() - want).abs().max()) <= tol
    nxt, cache = model.prefill(on_card, {"tokens": tokens.to(cuda)},
                               cache_len=48)
    assert [kn.LAUNCHES - b for kn, b in zip(kernels, before)] == \
        [2 * model.cfg.n_layers] * len(kernels)
    for _ in range(2):
        nxt, cache = model.decode_step(on_card, cache, nxt)
    assert nxt.shape == (3,)
    assert bool(((nxt >= 0) & (nxt < model.cfg.vocab)).all())


# ------------------------------------------- K1 on delta blocks ----
@pytest.mark.cuda
@pytest.mark.parametrize("lo", (1, 2, 3, 4 * 100 + 1))
@pytest.mark.parametrize("n", (0, 1, 3, 4093))
def test_k1_on_offset_slices(cuda, lo, n):
    """The standing fold's delta blocks: every column sliced [lo:lo+n],
    the (n, 9) ``out`` column included, with lo % 4 in {1, 2, 3} (bases
    off 16 bytes, a head of scalar rows) and n from 0 (the identities:
    zeros, -inf / +inf for max / min) to 4,093."""
    store = _store(cuda, n=5000, seed=lo + n)
    cols = {k: v[lo:lo + n] for k, v in store.columns.items()}
    _, fvals = Q.normalize((Filter("quality", "ge", 0.3),))
    for agg in AGGS:
        for value, keys in (("buffer_s", (("category", 4, 0),)),
                            ("out", (("t", 267, 150), ("category", 4, 0)))):
            if value == "out" and agg in ("max", "min"):
                continue
            spec = K.FusedAggSpec((("quality", "ge", 0),), keys, value, agg)
            before = K.LAUNCHES
            _k1_vs_plain(cols, n, fvals, spec)
            assert K.LAUNCHES == before + 1
            if n == 0:
                part = K.fused_segment_agg(cols, 0, fvals, spec)
                assert float(part["cnt"].abs().sum()) == 0.0
                assert bool((part["acc"] == K.identity(agg)).all())


@pytest.mark.cuda
def test_standing_answers_on_card_match_query(cuda):
    """Standing queries folded by K1 on the card (a backfill, then
    ingests of 1, 4,093, 0 and 4,906 rows) against ``store.query`` over
    the same rows: masks and counts equal, max and min exact, sums and
    means within 1e-5 relative (every summed column here is
    non-negative, so that is 1e-5 of each group's sum of magnitudes);
    one K1 call per (query, batch), and no query path taken."""
    store = _store(cuda, n=20_000, seed=5)
    reg = StandingQueries(store)
    plans = [
        (Filter("quality", "ge", 0.3),
         GroupBy("category", "quality", agg="mean", num_groups=4)),
        (GroupBy("stream_id", "buffer_s", agg="max", num_groups=16),),
        (GroupBy("category", "on_core_s", agg="min", num_groups=4),
         TopK(2, by="on_core_s")),
        (MultiGroupBy(keys=("t", "category"), value="out", agg="sum",
                      nums=(300, 4), windows=(150, 0)),),
        (WindowAgg(window=1000, value="cloud_core_s", agg="sum",
                   num_windows=41),),
    ]
    ST.FOLDS.update(kernel=0, engine=0)
    Q.PATHS.update(kernel=0, engine=0)
    before = K.LAUNCHES
    handles = [reg.register(p) for p in plans]
    sid = reg.subscribe(plans[0], Filter("quality", "gt", 0.62))
    extra = _store(cuda, n=9_000, seed=6).host_rows()
    batches = ((0, 1), (1, 4094), (4094, 4094), (4094, 9000))
    for a, b in batches:
        store.append_rows({k: v[a:b] for k, v in extra.items()})
    n_q = len(plans) + 1
    assert ST.FOLDS == {"kernel": n_q * (1 + len(batches)), "engine": 0}
    assert K.LAUNCHES - before == ST.FOLDS["kernel"]
    assert Q.PATHS == {"kernel": 0, "engine": 0}
    for h, plan in zip(handles, plans):
        table, mask = reg.answer(h)
        want, wmask = store.query(plan, use_kernel=False)
        assert torch.equal(mask.cpu(), wmask.cpu()), plan
        assert torch.equal(table["count"].cpu(), want["count"].cpu())
        node = next(nd for nd in plan if not isinstance(nd, (Filter, TopK)))
        exact = node.agg in ("max", "min")
        _close(table[node.value], want[node.value], exact)
    (alert,) = reg.poll()
    assert alert.sub == sid and alert.fired.shape == (4,)
    assert store.obs["alerts_checked"] == 1


# ------------------------------------------------------ telemetry ----
@pytest.mark.cuda
def test_fused_run_telemetry_on_card(cuda):
    """A short fused run on the card with the flight recorder: its
    counters equal ``telemetry_ref`` of its own traces (the store's rows,
    no drops) and the same run's on the CPU, bit for bit, and its
    decisions are those of the run without telemetry."""
    from repro_torch.configs.workloads import COVID
    from repro_torch.core.ingest import run_skyscraper_fused
    from repro_torch.core.offline import fit
    from repro_torch.data.stream import generate
    from repro_torch.obs import TEL_KEYS, telemetry_ref
    fitted = fit(COVID, n_cores=8, days_unlabeled=0.5, device=cuda)
    stream = generate(COVID, days=0.05, seed=7)
    kw = dict(n_cores=8, cloud_budget_core_s=3000.0, plan_days=0.01)
    store = SegmentStore(out_dim=len(fitted.configs), device=cuda)
    res = run_skyscraper_fused(fitted, stream, sink=store, telemetry=True,
                               device=cuda, **kw)
    bare = run_skyscraper_fused(fitted, stream, device=cuda, **kw)
    cpu = run_skyscraper_fused(fitted.to("cpu"), stream, telemetry=True,
                               device="cpu", **kw)
    tel, T = res.telemetry, stream.n_segments
    assert np.array_equal(res.k_trace, bare.k_trace)
    assert tel.segments == T and tel.dropped == 0.0
    h = store.host_rows()
    want = telemetry_ref({"k": h["k"], "dropped": np.zeros(T, np.float32),
                          "buffer_s": h["buffer_s"], "on_s": h["on_core_s"],
                          "cl_s": h["cloud_core_s"]},
                         int(np.argmax(fitted.power)))
    for key in TEL_KEYS:
        assert np.array_equal(tel.counters[key], want[key]), key
        assert np.array_equal(tel.per_window[key],
                              cpu.telemetry.per_window[key]), key
    stel = store.telemetry()
    assert (stel.n_rows, stel.ingest_dispatches, stel.lag_max_ticks) == \
        (T, 1, T - 1)


# ---------------------------------------------------------------------------
# many streams, the serving pool and the cold tier: the card against the CPU
# ---------------------------------------------------------------------------

def _cpu_fit():
    from repro_torch.configs.workloads import COVID
    from repro_torch.core.offline import fit
    return fit(COVID, n_cores=8, days_unlabeled=0.5, device="cpu")


@pytest.mark.cuda
def test_switch_multi_on_card_matches_cpu(cuda):
    from repro_torch.core import switcher as PS
    fitted = _cpu_fit()
    rng = np.random.default_rng(0)
    V = 64
    tabs = [fitted.tables(buffer_gb=float(rng.choice([4.0, 0.002])),
                          cloud_budget=float(rng.choice([0.0, 400.0])))
            for _ in range(V)]
    C, K = fitted.centers.shape
    quals = torch.tensor(rng.random((V, 40, K)), dtype=torch.float32)
    arrs = torch.tensor(np.where(rng.random((V, 40)) < 0.1, 4000.0,
                                 1.0 + rng.random((V, 40))),
                        dtype=torch.float32)
    valid = torch.tensor(rng.random((V, 40)) < 0.9)
    alpha = torch.tensor(rng.random((V, C, K)), dtype=torch.float32)
    alpha = alpha / alpha.sum(-1, keepdim=True)
    outs = {}
    for dev in ("cpu", cuda):
        st = {k: v.to(dev) for k, v in PS.init_state_multi(tabs).items()}
        tb = PS.stack_tables([PS.SwitchTables(**{
            f: getattr(t, f).to(dev) for f in PS.SwitchTables.__dataclass_fields__})
            for t in tabs])
        st, out = PS.window_scan_multi(st, quals.to(dev), arrs.to(dev),
                                       valid.to(dev), alpha.to(dev), tb)
        outs[str(dev)] = ({k: v.cpu() for k, v in st.items()},
                          {k: v.cpu() for k, v in out.items()})
    (s_c, o_c), (s_g, o_g) = outs["cpu"], outs[str(cuda)]
    assert o_c["dropped"].any()
    for k in o_c:
        assert torch.equal(o_c[k], o_g[k]), k
    for k in s_c:
        assert torch.equal(s_c[k], s_g[k]), k


@pytest.mark.cuda
def test_multi_run_on_card_matches_cpu(cuda):
    from repro_torch.configs.workloads import COVID
    from repro_torch.core.ingest import run_skyscraper_multi
    from repro_torch.data.stream import generate
    from repro_torch.obs import TEL_KEYS
    fitted = _cpu_fit()
    streams = [generate(COVID, days=0.03, seed=60 + v) for v in range(8)]
    kw = dict(n_cores_each=8, cloud_budget_core_s=4000.0, plan_days=0.01,
              telemetry=True)
    got = {}
    for dev in ("cpu", cuda):
        store = SegmentStore(out_dim=len(fitted.configs), device=dev)
        reg = StandingQueries(store)
        h = reg.register((GroupBy("stream_id", "quality", agg="sum",
                                  num_groups=8),))
        before = K.LAUNCHES
        out = run_skyscraper_multi([fitted.to(dev)] * 8, streams,
                                   sink=store, device=dev, **kw)
        got[str(dev)] = (out, store.host_rows(), reg.answer(h),
                         K.LAUNCHES - before)
    (oc, hc, ac, _), (og, hg, ag, launches) = got["cpu"], got[str(cuda)]
    assert launches >= 1
    for k in hc:
        assert np.array_equal(hc[k], hg[k]), k
    for key in TEL_KEYS:
        assert np.array_equal(oc["telemetry"].counters[key],
                              og["telemetry"].counters[key]), key
    assert oc["per_stream_pct"] == og["per_stream_pct"]
    _close(ag[0]["quality"], ac[0]["quality"], exact=False)


@pytest.mark.cuda
def test_pool_ticks_on_card_match_cpu(cuda):
    from repro_torch.core.api import Skyscraper, SkyscraperPool

    def proc(seg, kv):
        return seg, float(np.clip(1 - seg * (1 - 1.0 / kv["det"]), 0, 1))
    skies = {}
    for dev in ("cpu", cuda):
        sky = Skyscraper(segment_seconds=2.0, n_categories=3, device=dev)
        sky.set_resources(num_cores=4)
        sky.register_knob("det", [1, 5, 10])
        if not skies:
            sky.fit(list(np.linspace(0, 1, 40)), proc, plan_segments=16)
            base = sky
        else:
            sky._install(configs=base.configs, cost=base.cost,
                         power=base.tables.power.cpu().numpy(),
                         centers=base.centers,
                         forecaster={n: {p: t.to(dev) for p, t in l.items()}
                                     for n, l in base.forecaster.items()},
                         n_split=base.n_split, interval=base.interval,
                         proc_fn=proc, plan_segments=16)
        skies[str(dev)] = sky
    runs = {}
    for dev, sky in skies.items():
        pool = SkyscraperPool(sky, n_streams=12, telemetry=True,
                              priorities=list(range(1, 13)), device=dev)
        rng = np.random.default_rng(4)
        log = []
        for t in range(60):
            if t == 20:
                pool.capacity_core_s = float(np.min(sky.cost)) * 7.5
            if t % 9 == 8:
                pool.admit(100 + t, priority=float(t % 4), force=True)
            if t % 13 == 12:
                pool.retire(pool.streams[0])
            log.append(pool.process(list(rng.random(pool.V)))[0])
        runs[dev] = (log, pool.telemetry())
    (lc, tc), (lg, tg) = runs["cpu"], runs[str(cuda)]
    assert lc == lg
    assert any(s["shed"] for tick in lc for s in tick)
    for k in tc.counters:
        assert np.array_equal(tc.counters[k], tg.counters[k]), k


@pytest.mark.cuda
def test_tier_spill_on_card_matches_cpu(cuda):
    from repro_torch.warehouse import TieredStore
    rng = np.random.default_rng(8)
    n = 20_000
    rows = {"stream_id": rng.integers(0, 4, n).astype(np.int32),
            "t": np.arange(n, dtype=np.int32),
            "category": rng.integers(0, 4, n).astype(np.int32),
            "k": rng.integers(0, 3, n).astype(np.int32),
            "quality": rng.random(n).astype(np.float32),
            "on_core_s": rng.random(n).astype(np.float32),
            "cloud_core_s": rng.random(n).astype(np.float32),
            "buffer_s": rng.random(n).astype(np.float32),
            "out": rng.random((n, 3)).astype(np.float32)}
    tiers = {}
    for dev in ("cpu", cuda):
        store = SegmentStore(out_dim=3, chunk_rows=1024, device=dev)
        store.append_rows(rows)
        ts = TieredStore(store, seed=3, device=dev)
        ts.spill(keep_hot=3000)
        tiers[str(dev)] = ts
    tc, tg = tiers["cpu"], tiers[str(cuda)]
    for k in tc.cold_q:
        assert torch.equal(tc.cold_q[k], tg.cold_q[k].cpu()), k
        assert torch.equal(tc.cold_scales[k], tg.cold_scales[k].cpu()), k
    plan = (GroupBy("category", "quality", agg="mean", num_groups=4),)
    before = K.LAUNCHES
    got, _ = tg.query(plan)
    assert K.LAUNCHES == before + 1
    want, _ = tc.query(plan)
    _close(got["quality"], want["quality"], exact=False)


def _sharded_rows(n, seed, streams=(0, 4)):
    """Rows of the given streams only, so the other shards stay empty."""
    rng = np.random.default_rng(seed)
    return {"stream_id": np.asarray(streams, np.int32)[
                rng.integers(0, len(streams), n)],
            "t": np.arange(n, dtype=np.int32),
            "category": rng.integers(0, 4, n).astype(np.int32),
            "k": rng.integers(0, 3, n).astype(np.int32),
            "quality": rng.random(n).astype(np.float32),
            "on_core_s": (rng.random(n) * 20 - 5).astype(np.float32),
            "cloud_core_s": rng.random(n).astype(np.float32),
            "buffer_s": (rng.random(n) * 40).astype(np.float32),
            "out": rng.random((n, 3)).astype(np.float32)}


SHARD_PLANS = tuple(
    (Filter("quality", "ge", 0.3),
     GroupBy("category", "on_core_s", agg=agg, num_groups=4))
    for agg in AGGS) + (
    (MultiGroupBy(keys=("t", "category"), value="out", agg="mean",
                  nums=(8, 4), windows=(4096, 0)),),
    (WindowAgg(window=1000, value="buffer_s", agg="max", num_windows=40),))


@pytest.mark.cuda
def test_k1_per_shard_partials_with_empty_shards(cuda):
    """Each shard's K1 partial on a stacked 8-shard store whose streams
    hash onto shards 0 and 4 only, against the plain version in float64;
    then the merged answers (8 launches a plan) against the engine's on
    the same store."""
    from repro_torch.warehouse import ShardedStore, execute_sharded
    store = ShardedStore(out_dim=3, n_shards=8, chunk_rows=4096,
                         device=cuda)
    store.append_rows(_sharded_rows(30_000, seed=1))
    cols, counts = store.shard_source()
    assert counts[[1, 2, 3, 5, 6, 7]].sum() == 0
    for plan in SHARD_PLANS:
        spec, fvals = Q.normalize(plan)
        pre, node, _ = Q.split_plan(spec)
        for s in range(8):
            shard = {k: v[s] for k, v in cols.items()}
            _k1_vs_plain(shard, int(counts[s]), fvals,
                         Q._kernel_spec(pre, node, shard))
        before = K.LAUNCHES
        tk, mk = execute_sharded(store, plan)
        assert K.LAUNCHES == before + 8
        tp, mp = execute_sharded(store, plan, use_kernel=False)
        assert torch.equal(mk.cpu(), mp.cpu())
        _close(tk["count"], tp["count"], exact=True)
        _close(tk[node.value], tp[node.value],
               exact=node.agg in ("count", "max", "min"))


@pytest.mark.cuda
@pytest.mark.parametrize("lo", (1, 2, 3, 4))
def test_k1_fold_views_at_unaligned_rows(cuda, lo):
    """The sharded fold's delta block: a shard's rows [lo, lo + n) as
    views into its stacked columns, their bases off 16 bytes."""
    from repro_torch.warehouse import ShardedStore
    store = ShardedStore(out_dim=3, n_shards=2, chunk_rows=4096,
                         device=cuda)
    store.append_rows(_sharded_rows(9_000, seed=2, streams=(0, 1)))
    for n in (1, 3, 4_093):
        block = {k: v[1, lo:lo + n] for k, v in store.columns.items()}
        for plan in SHARD_PLANS:
            spec, fvals = Q.normalize(plan)
            pre, node, _ = Q.split_plan(spec)
            _k1_vs_plain(block, n, fvals, Q._kernel_spec(pre, node, block))


@pytest.mark.cuda
def test_sharded_store_on_card_matches_cpu(cuda):
    """The same batches into a 4-shard store on the card and on the CPU,
    a registry on each (K1 folds on the card, the engine on the CPU):
    rows bit for bit, answers and standing answers within tolerance,
    rebalanced rows and a spill's cold codes bit for bit."""
    from repro_torch.runtime.elastic import rebalance
    from repro_torch.warehouse import (ShardedStore, ShardedTieredStore,
                                       execute_sharded)
    stores, regs = {}, {}
    for dev in ("cpu", cuda):
        store = ShardedStore(out_dim=3, n_shards=4, chunk_rows=2048,
                             device=dev)
        store.append_rows(_sharded_rows(5_000, seed=3, streams=range(6)))
        reg = StandingQueries(store)
        hs = [reg.register(p, use_kernel=str(dev) != "cpu")
              for p in SHARD_PLANS[:5]]
        for i in range(3):
            rows = _sharded_rows(3_001 + i, seed=4 + i, streams=range(7))
            rows["t"] += 5_000 + 4_000 * i
            store.append_rows(rows)
        stores[str(dev)], regs[str(dev)] = store, (reg, hs)
    sc, sg = stores["cpu"], stores[str(cuda)]
    hc, hg = sc.host_rows(), sg.host_rows()
    for k in hc:
        assert np.array_equal(hc[k], hg[k]), k
    (rc, hsc), (rg, hsg) = regs["cpu"], regs[str(cuda)]
    for h_c, h_g, plan in zip(hsc, hsg, SHARD_PLANS):
        agg = plan[-1].agg
        for got, want in ((rg.answer(h_g), rc.answer(h_c)),
                          (execute_sharded(sg, plan),
                           execute_sharded(sc, plan))):
            assert torch.equal(got[1].cpu(), want[1])
            _close(got[0]["count"], want[0]["count"], exact=True)
            _close(got[0]["on_core_s"], want[0]["on_core_s"],
                   exact=agg in ("count", "max", "min"))
    topk = (Filter("quality", "ge", 0.5), TopK(9, by="on_core_s"))
    (tg, mg), (tc, mc) = sg.query(topk), sc.query(topk)
    assert torch.equal(mg.cpu(), mc)
    for k in tc:
        assert torch.equal(tg[k].cpu(), tc[k]), k
    bg, bc = rebalance(sg, 3), rebalance(sc, 3, device="cpu")
    for k, v in bc.host_rows().items():
        assert np.array_equal(bg.host_rows()[k], v), k
    tg_, tc_ = (ShardedTieredStore(sg, seed=5, device=cuda),
                ShardedTieredStore(sc, seed=5, device="cpu"))
    assert tg_.spill(keep_hot=1000) == tc_.spill(keep_hot=1000) > 0
    for k in tc_.cold_q:
        assert torch.equal(tg_.cold_q[k].cpu(), tc_.cold_q[k]), k
        assert torch.equal(tg_.cold_scales[k].cpu(), tc_.cold_scales[k]), k


@pytest.mark.cuda
def test_warehouse_saved_on_card_loads_on_cpu(cuda, tmp_path):
    from repro_torch.warehouse import (TieredStore, load_warehouse,
                                       save_warehouse)
    store = SegmentStore(out_dim=3, chunk_rows=1024, device=cuda)
    store.append_rows(_sharded_rows(9_000, seed=6, streams=range(4)))
    ts = TieredStore(store, seed=2, device=cuda)
    ts.spill(keep_hot=2_000)
    back = load_warehouse(save_warehouse(str(tmp_path / "w.rsk"), ts),
                          device="cpu")
    assert (back.n_cold, back.hot.n_rows) == (ts.n_cold, ts.hot.n_rows)
    for mine, theirs in ((back.hot.columns, ts.hot.columns),
                         (back.cold_q, ts.cold_q),
                         (back.cold_scales, ts.cold_scales),
                         (back.cold_int, ts.cold_int)):
        for k in theirs:
            assert torch.equal(mine[k], theirs[k].cpu()), k
    plan = (GroupBy("category", "quality", agg="mean", num_groups=4),)
    (tc, mc), (tg, mg) = back.query(plan), ts.query(plan)
    assert torch.equal(mc, mg.cpu())
    _close(tg["quality"], tc["quality"], exact=False)


# ------------------------------------------------------- mixtral ----
def _on_card(params, cuda):
    return {k: ({kk: vv.to(cuda) for kk, vv in v.items()}
                if isinstance(v, dict) else v.to(cuda))
            for k, v in params.items()}


def _routed(model, params, tokens, pinned=None):
    """Logits and each layer's expert choices; with ``pinned`` the router
    takes those choices (the gates its own probabilities at them)."""
    from repro_torch.models import moe
    seen, route = [], moe.route

    def hook(probs, k):
        if pinned is None:
            vals, idx = route(probs, k)
        else:
            idx = pinned[len(seen)].to(probs.device)
            vals = torch.gather(probs, -1, idx)
        seen.append(idx.cpu())
        return vals, idx

    moe.route = hook
    try:
        logits = model.forward_logits(params, {"tokens": tokens})
    finally:
        moe.route = route
    return logits, seen


@pytest.mark.cuda
@pytest.mark.parametrize("S", (37, 80))
def test_mixtral_on_card_matches_cpu(cuda, S):
    """The reduced mixtral in float32 (window 32, 4 experts top-2): K3
    with the window once per layer, the routing and logits (within 1e-4)
    equal to the CPU run's, then a prefill and two decode steps with the
    same tokens as on the CPU."""
    model = Model(get("mixtral-8x7b").reduced(),
                  RunOptions(compute_dtype="float32"))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    on_card = _on_card(params, cuda)
    tokens = torch.randint(0, 256, (3, S), generator=torch.Generator()
                           .manual_seed(1))
    before = FA.LAUNCHES, FA.WINDOW_LAUNCHES
    got, routes = _routed(model, on_card, tokens.to(cuda))
    assert (FA.LAUNCHES - before[0], FA.WINDOW_LAUNCHES - before[1]) == \
        (2, 2)
    want, want_routes = _routed(model, params, tokens)
    for a, b in zip(routes, want_routes):
        assert torch.equal(a, b)
    assert float((got.cpu() - want).abs().max()) <= 1e-4
    nxt_c, cache_c = model.prefill(on_card, {"tokens": tokens.to(cuda)},
                                   cache_len=S + 3)
    nxt, cache = model.prefill(params, {"tokens": tokens}, cache_len=S + 3)
    for _ in range(2):
        assert torch.equal(nxt_c.cpu(), nxt)
        nxt_c, cache_c = model.decode_step(on_card, cache_c, nxt_c)
        nxt, cache = model.decode_step(params, cache, nxt)
    assert torch.equal(nxt_c.cpu(), nxt)


@pytest.mark.cuda
def test_mixtral_at_default_options_on_card_matches_cpu(cuda):
    """The reduced mixtral at the default RunOptions (bfloat16) on the
    card, its routing pinned to the CPU run's choices, within
    ``bf16_logit_tolerance``; free-running, at least 97% of each layer's
    tokens choose the same experts."""
    model = Model(get("mixtral-8x7b").reduced(), RunOptions())
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    on_card = _on_card(params, cuda)
    tokens = torch.randint(0, 256, (3, 80), generator=torch.Generator()
                           .manual_seed(1))
    want, routes = _routed(model, params, tokens)
    got, _ = _routed(model, on_card, tokens.to(cuda), pinned=routes)
    assert got.dtype == torch.bfloat16
    tol = bf16_logit_tolerance(model.cfg.n_layers,
                               float(want.float().abs().max()))
    assert float((got.float().cpu() - want.float()).abs().max()) <= tol
    _, free = _routed(model, on_card, tokens.to(cuda))
    for a, b in zip(free, routes):
        same = (a.sort(-1).values == b.sort(-1).values).all(-1)
        assert float(same.float().mean()) >= 0.97


# -------------------------------------- the paper's comparisons ----
@pytest.fixture(scope="module")
def small_fit():
    from repro_torch.configs.workloads import COVID
    from repro_torch.core.offline import fit
    return fit(COVID, n_cores=8, days_unlabeled=0.5, seed=0, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ("model", "oracle", "uniform"))
def test_per_window_loop_on_card_matches_cpu(cuda, small_fit, mode):
    from repro_torch.configs.workloads import COVID
    from repro_torch.core import ingest
    from repro_torch.data.stream import generate
    stream = generate(COVID, days=0.05, seed=3)
    kw = dict(n_cores=8, cloud_budget_core_s=300.0, plan_days=0.01,
              forecast_mode=mode)
    got = ingest.run_skyscraper(small_fit, stream, device=cuda, **kw)
    want = ingest.run_skyscraper(small_fit, stream, device="cpu", **kw)
    for name in ("k_trace", "c_trace", "k_hist"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    for name in ("quality_sum", "onprem_core_s", "cloud_core_s",
                 "buffer_peak_s"):
        assert getattr(got, name) == pytest.approx(getattr(want, name),
                                                   rel=1e-5), name
    assert small_fit.device == torch.device("cpu")


@pytest.mark.cuda
def test_optimum_on_card_matches_cpu(cuda, small_fit):
    from repro_torch.configs.workloads import COVID
    from repro_torch.core import ingest
    from repro_torch.data.stream import generate
    stream = generate(COVID, days=1.0, seed=4)
    got = ingest.run_optimum(small_fit, stream, n_cores=8,
                             cloud_budget_core_s=5_000.0, device=cuda)
    want = ingest.run_optimum(small_fit, stream, n_cores=8,
                              cloud_budget_core_s=5_000.0, device="cpu")
    assert np.array_equal(got.k_hist, want.k_hist)
    assert got.quality_sum == want.quality_sum


# ------------------------------------------------- whisper, float8 ----
# whisper-large-v3's K3 shapes (B, Sq, Skv, H, G, D, causal, window): the
# encoder's self-attention over 1,500 frames, the prefill's
# cross-attention of a 440-token prompt over them, one decode query
# against them, all non-causal; and the decoder's causal self-attention
WHISPER_K3 = ((4, 1500, 1500, 20, 20, 64, False, None),
              (4, 440, 1500, 20, 20, 64, False, None),
              (4, 1, 1500, 20, 20, 64, False, None),
              (4, 440, 440, 20, 20, 64, True, None))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("case", WHISPER_K3)
def test_k3_at_whisper_shapes(cuda, case, dtype):
    """K3 at whisper's shapes within ``error_bound`` of the plain version
    (bfloat16: the bfloat16 kernel's bound, against the plain version on
    the widened inputs, the output's rounding added)."""
    B, Sq, Skv, H, G, D, causal, window = case
    gen = torch.Generator(device=cuda).manual_seed(21)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda)
               .to(getattr(torch, dtype)) for shape in
               ((B, Sq, H, D), (B, Skv, G, D), (B, Skv, G, D)))
    before = FA.LAUNCHES
    got = FA.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FA.LAUNCHES == before + 1 and got.dtype == q.dtype
    want = FA.flash_attention_ref(q.float(), k.float(), v.float(),
                                  causal=causal, window=window)
    bound = FA.error_bound(q, k, v, causal=causal, window=window,
                           ref=want if dtype == "bfloat16" else None)
    assert bool(((got.float() - want).abs() <= bound).all())


def _tree_to(tree, device):
    return {k: (_tree_to(v, device) if isinstance(v, dict) else
                v.to(device)) for k, v in tree.items()}


@pytest.mark.cuda
def test_whisper_on_card_matches_cpu(cuda):
    """The reduced whisper in float32 on the card against the CPU run of
    the same params: K3 once per encoder layer and twice per decoder
    layer (self and cross) in a forward and a prefill, once per decoder
    layer (cross) in a decode step; logits and caches within 1e-4, the
    same tokens over 4 decode steps."""
    model = Model(get("whisper-large-v3").reduced(),
                  RunOptions(compute_dtype="float32"))
    cfg = model.cfg
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    on_card = _tree_to(params, cuda)
    gen = torch.Generator().manual_seed(1)
    batch = {"frames": torch.randn(3, 50, cfg.d_model, generator=gen),
             "tokens": torch.randint(0, 256, (3, 12), generator=gen)}
    card_batch = _tree_to(batch, cuda)
    per_prefill = cfg.n_enc_layers + 2 * cfg.n_layers
    before = FA.LAUNCHES
    got = model.forward_logits(on_card, card_batch)
    assert FA.LAUNCHES == before + per_prefill
    want = model.forward_logits(params, batch)
    assert float((got.cpu() - want).abs().max()) <= 1e-4
    nxt_c, cache_c = model.prefill(on_card, card_batch, cache_len=16)
    nxt, cache = model.prefill(params, batch, cache_len=16)
    assert FA.LAUNCHES == before + 2 * per_prefill
    for _ in range(4):
        assert torch.equal(nxt_c.cpu(), nxt)
        before = FA.LAUNCHES
        nxt_c, cache_c = model.decode_step(on_card, cache_c, nxt_c)
        assert FA.LAUNCHES == before + cfg.n_layers
        nxt, cache = model.decode_step(params, cache, nxt)
    assert torch.equal(nxt_c.cpu(), nxt)
    for name in ("k", "v", "xk", "xv"):
        assert float((cache_c[name].cpu() - cache[name]).abs().max()) \
            <= 1e-4, name
    assert torch.equal(cache_c["slot_pos"].cpu(), cache["slot_pos"])


@pytest.mark.cuda
def test_float8_cache_on_card(cuda):
    """``write_slot`` into a float8 cache on the card, byte for byte as
    on the CPU (``index_copy_`` has no float8 kernel: the codes go through
    uint8 views); then the reduced qwen at ``kv_cache_dtype`` float8 on
    the card: its prefill's codes equal the float8 cast of the default
    (bfloat16) cache's on the same card, K3 once per layer, and decode
    steps run from it."""
    from repro_torch.models.transformer import write_slot
    gen = torch.Generator().manual_seed(3)
    fp8 = torch.float8_e4m3fn
    cache = torch.randn(2, 9, 4, 16, generator=gen).to(fp8)
    x = 3 * torch.randn(2, 1, 4, 16, generator=gen)
    want = cache.clone()
    write_slot(want, torch.tensor([5]), x)
    got = cache.to(cuda)
    write_slot(got, torch.tensor([5], device=cuda), x.to(cuda))
    assert got.dtype == fp8
    assert torch.equal(got.view(torch.uint8).cpu(), want.view(torch.uint8))

    cfg = get("qwen1.5-0.5b").reduced()
    params = _tree_to(Model(cfg).init(torch.Generator().manual_seed(0),
                                      "cpu"), cuda)
    tokens = torch.randint(0, 256, (3, 40), generator=gen).to(cuda)
    _, ref = Model(cfg, RunOptions()).prefill(params, {"tokens": tokens},
                                              cache_len=48)
    before = FA.LAUNCHES
    model = Model(cfg, RunOptions(kv_cache_dtype="float8_e4m3fn"))
    nxt, cache = model.prefill(params, {"tokens": tokens}, cache_len=48)
    assert FA.LAUNCHES == before + cfg.n_layers
    for name in ("k", "v"):
        assert cache["layers"][name].dtype == fp8
        assert torch.equal(cache["layers"][name].view(torch.uint8),
                           ref["layers"][name].to(fp8).view(torch.uint8))
    for _ in range(3):
        nxt, cache = model.decode_step(params, cache, nxt)
    assert cache["layers"]["k"].dtype == fp8
    assert bool(((nxt >= 0) & (nxt < cfg.vocab)).all())


# ------------------------------------------------ K3's backward, training
K3_BWD_CASES = (
    # B, Sq, Skv, H, G, D, causal, window
    (2, 300, 300, 8, 2, 64, True, None),
    (2, 200, 333, 4, 4, 16, False, None),
    (1, 500, 500, 8, 4, 64, True, 32),
    (3, 130, 130, 4, 1, 128, True, None),
    (1, 300, 333, 4, 2, 128, True, 100),
    (1, 90, 20, 2, 1, 32, False, 8),            # rows 27.. see no key
    (1, 1500, 1500, 4, 4, 64, False, None),     # whisper's encoder length
    (1, 77, 93, 10, 2, 32, True, 20),           # R = 5, rows off every tile
    # D = 12: 16-byte copies in float32, one value at a time in bfloat16
    (1, 70, 50, 3, 3, 12, False, None),
    (1, 100, 100, 4, 2, 40, True, None),        # D = 40 in a 64-wide tile
    # D = 10: 4-byte copies in float32, one value at a time in bfloat16
    (1, 70, 50, 4, 2, 10, True, None),
    # q, k, v and dO one value past a 16-byte boundary (the last element:
    # the offset, in values): 4-byte copies in float32 at D = 64, one
    # value at a time in bfloat16
    (2, 100, 120, 4, 2, 64, True, None, 1),
    (1, 300, 333, 4, 2, 128, True, 100, 1),     # and at D = 128
)


def _k3_bwd_inputs(case, dtype, device):
    """q, k, v, dO for a ``K3_BWD_CASES`` case, each a view ``shift``
    values into a fresh buffer (0: the buffer's aligned start)."""
    B, Sq, Skv, H, G, D, causal, window, *shift = case
    shift = shift[0] if shift else 0

    def randn(shape):
        n = int(np.prod(shape))
        return torch.randn(n + shift, device=device).to(dtype)[shift:] \
            .view(shape)
    q, do = randn((B, Sq, H, D)), randn((B, Sq, H, D))
    k, v = randn((B, Skv, G, D)), randn((B, Skv, G, D))
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("case", K3_BWD_CASES)
def test_k3_backward_within_its_bound(cuda, case, dtype):
    """The backward kernel against ``flash_attention_bwd_ref`` in float64
    on the same inputs and the forward's o and lse, within
    ``bwd_error_bound`` (bfloat16: its bfloat16 terms, the bfloat16
    tensors passed to it, plus the outputs' rounding)."""
    B, Sq, Skv, H, G, D, causal, window = case[:8]
    q, k, v, do = _k3_bwd_inputs(case, dtype, cuda)
    o, lse = FA.flash_attention_fwd_lse(q, k, v, causal=causal,
                                        window=window)
    before = FA.BWD_LAUNCHES
    got = FA.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                 window=window)
    torch.cuda.synchronize()
    assert FA.BWD_LAUNCHES == before + 1
    want = FA.flash_attention_bwd_ref(*(x.double() for x in (q, k, v, o, do)),
                                      lse.double(), causal=causal,
                                      window=window)
    bound = FA.bwd_error_bound(q, k, v, o, do, lse, causal=causal,
                               window=window,
                               refs=want if dtype == torch.bfloat16 else None)
    for a, b, c in zip(got, want, bound):
        assert a.dtype == dtype and bool(torch.isfinite(a).all())
        assert bool(((a.double() - b).abs() <= c).all())
    blind = ~FA._visible(Sq, Skv, causal, window, cuda).any(-1)
    if bool(blind.any()):
        assert bool(torch.isinf(lse[:, :, blind]).all())
        assert float(got[0][:, blind].float().abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("case", K3_BWD_CASES[:1] + K3_BWD_CASES[3:5]
                         + K3_BWD_CASES[7:8])
def test_k3_backward_same_bits_on_every_launch(cuda, case, dtype):
    """No atomics: each output is written once by the block that owns it,
    so two launches on the same inputs give the same bits."""
    causal, window = case[6], case[7]
    q, k, v, do = _k3_bwd_inputs(case, dtype, cuda)
    o, lse = FA.flash_attention_fwd_lse(q, k, v, causal=causal,
                                        window=window)
    first = FA.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                   window=window)
    again = FA.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                   window=window)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_k3_backward_takes_its_dtypes_library(cuda, dtype):
    """A bfloat16 backward launches ``csrc/flash_attention_bwd_bf16.cu``
    (``BF16_BWD_LAUNCHES``), a float32 one does not; the bfloat16 launch
    shape says how its tiles land."""
    q, k, v, do = _k3_bwd_inputs(K3_BWD_CASES[0], dtype, cuda)
    o, lse = FA.flash_attention_fwd_lse(q, k, v, causal=True)
    n0 = (FA.BWD_LAUNCHES, FA.BF16_BWD_LAUNCHES)
    FA.flash_attention_bwd(q, k, v, o, do, lse, causal=True)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    assert (FA.BWD_LAUNCHES - n0[0], FA.BF16_BWD_LAUNCHES - n0[1]) == \
        (1, int(bf16))
    if bf16:
        shape = FA.bwd_bf16_launch_shape(q, k, v, do)
        assert shape["load"] == "tma" and shape["head_dim_padded"] == 64
        assert (shape["dkdv_warpgroups"], shape["dq_warpgroups"]) == (2, 1)


@pytest.mark.cuda
def test_bf16_train_step_launches_the_bf16_backward(cuda):
    """``value_and_grad`` of a cut qwen1.5-0.5b at bfloat16 compute (the
    default RunOptions, remat none) on the card: ``FlashAttentionFn``
    launches K3's bfloat16 forward and its bfloat16 backward once per
    layer each; the loss and the gradients are finite."""
    import dataclasses
    from repro_torch.runtime.steps import value_and_grad
    cfg = dataclasses.replace(get("qwen1.5-0.5b").reduced(), n_layers=3)
    model = Model(cfg, RunOptions(remat="none"))
    assert model.opts.compute_dtype == "bfloat16"
    params = model.init(torch.Generator().manual_seed(0), cuda)
    tokens = torch.randint(0, 256, (2, 128), device=cuda)
    n0 = (FA.BF16_LAUNCHES, FA.BF16_BWD_LAUNCHES)
    loss, grads = value_and_grad(model, params, {"tokens": tokens})
    assert (FA.BF16_LAUNCHES - n0[0], FA.BF16_BWD_LAUNCHES - n0[1]) == \
        (cfg.n_layers, cfg.n_layers)
    assert bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.cuda
def test_k3_gradients_on_card_flow_through_the_kernel(cuda):
    """The repaired fault: a gradient through K3 on a CUDA tensor is the
    backward kernel's, nonzero, and equal to the plain version's within
    the tolerance of the models' logits (1e-4 of each gradient's
    largest magnitude)."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = [torch.randn(s, generator=gen, device=cuda)
         for s in ((2, 128, 4, 64), (2, 128, 2, 64), (2, 128, 2, 64))]
    w = torch.randn((2, 128, 4, 64), generator=gen, device=cuda)
    t = [a.clone().requires_grad_(True) for a in x]
    f0, b0 = FA.LAUNCHES, FA.BWD_LAUNCHES
    got = torch.autograd.grad((FA.flash_attention(*t, causal=True,
                                                  window=40) * w).sum(), t)
    assert (FA.LAUNCHES, FA.BWD_LAUNCHES) == (f0 + 1, b0 + 1)
    t = [a.clone().requires_grad_(True) for a in x]
    want = torch.autograd.grad((FA.flash_attention_ref(
        *t, causal=True, window=40) * w).sum(), t)
    for a, b in zip(got, want):
        assert float(a.abs().max()) > 0
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    # without a gradient the serve path writes no log-sum-exp
    with torch.no_grad():
        o = FA.flash_attention(*t, causal=True)
    assert o.grad_fn is None and FA.BWD_LAUNCHES == b0 + 1


@pytest.mark.cuda
def test_kernels_without_a_backward_refuse_gradients(cuda):
    """K2 and K4's one-pass ``launch`` refuse a gradient by name; K4's
    ``ssd_scan`` takes it through ``SsdScanFn`` (its backward kernel),
    and so mamba2's ``value_and_grad`` runs on the card."""
    x = torch.randn((1, 32, 2, 16), device=cuda, requires_grad=True)
    dt = torch.rand((1, 32, 2), device=cuda)
    A = -torch.rand(2, device=cuda)
    Bm = torch.randn((1, 32, 1, 16), device=cuda)
    with pytest.raises(RuntimeError, match="SSD kernel.*no backward"):
        SSD.launch("ssd_cumsum", x, dt, A, Bm, Bm, None, x, x, {}, 16)
    y, _ = SSD.ssd_scan(x, dt, A, Bm, Bm, chunk=16)
    assert y.grad_fn is not None
    with torch.no_grad():
        y, _ = SSD.ssd_scan(x, dt, A, Bm, Bm, chunk=16)
    assert y.shape == x.shape and y.grad_fn is None
    frame = torch.rand((2, 8, 8, 3), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="downsample kernel.*no backward"):
        FP.downsample(frame, 2)
    cfg = get("mamba2-370m").reduced()
    model = Model(cfg, RunOptions(remat="none", compute_dtype="float32"))
    params = model.init(torch.Generator().manual_seed(0), cuda)
    tokens = torch.randint(0, 256, (2, 32), device=cuda)
    from repro_torch.runtime.steps import value_and_grad
    b0 = SSD.BWD_LAUNCHES
    loss, grads = value_and_grad(model, params, {"tokens": tokens})
    assert SSD.BWD_LAUNCHES == b0 + cfg.n_layers
    assert bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ("full", "dots"))
def test_k4_backward_under_remat_on_card(cuda, mode):
    """mamba2's ``value_and_grad`` on the card with ``remat`` full or
    dots: the forward launched again in the backward (two launches a
    layer), the backward once a layer, the gradients those without remat
    within 1e-6 of each leaf's largest magnitude (the same kernels; the
    products around them recomputed)."""
    from repro_torch.runtime.steps import value_and_grad
    cfg = get("mamba2-370m").reduced()
    tokens = torch.randint(0, 256, (2, 64), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(0))
    out = {}
    for remat in ("none", mode):
        model = Model(cfg, RunOptions(remat=remat, compute_dtype="float32"))
        params = model.init(torch.Generator().manual_seed(0), cuda)
        n0 = (SSD.LAUNCHES, SSD.BWD_LAUNCHES)
        loss, grads = value_and_grad(model, params, {"tokens": tokens})
        out[remat] = (grads, SSD.LAUNCHES - n0[0], SSD.BWD_LAUNCHES - n0[1])
    L = cfg.n_layers
    assert out["none"][1:] == (L, L) and out[mode][1:] == (2 * L, L)
    for a, b in zip(out[mode][0], out["none"][0]):
        assert float((a - b).abs().max()) <= 1e-6 * float(
            b.abs().max().clamp_min(1e-30))


K4_BWD_CASES = (             # B, S, H, P, G, N, chunk, init, d(final)
    (2, 300, 4, 64, 1, 128, 256, True, True),    # S % Q != 0
    (1, 100, 8, 16, 2, 16, 256, False, True),    # S < Q, G > 1
    (1, 200, 25, 64, 1, 16, 64, True, False),    # R = 25, N = 16
    (2, 61, 4, 12, 2, 20, 8, False, False),      # Q 8, P 12, N 20
    (1, 512, 32, 64, 1, 128, 256, False, False),  # R = 32: 4 head slices
)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("case", K4_BWD_CASES)
def test_k4_backward_within_its_bound_same_bits(cuda, case, dtype):
    """K4's backward kernel on the forward kernels' scratch: every
    gradient within ``bwd_error_bound`` of the plain version in float64
    (for bfloat16 operands its bfloat16 terms: the bfloat16 library's
    split products), in its operand's dtype, and the same bits on a
    second launch."""
    B, S, H, P, G, N, chunk, with_init, with_dfinal = case
    gen = torch.Generator(device=cuda).manual_seed(5)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda)
    x, dy = randn(B, S, H, P).to(dtype), randn(B, S, H, P).to(dtype)
    dt = torch.nn.functional.softplus(randn(B, S, H) - 3).to(dtype)
    A = -(1 + 15 * torch.rand(H, generator=gen, device=cuda))
    Bm, Cm = randn(B, S, G, N).to(dtype), randn(B, S, G, N).to(dtype)
    init = randn(B, H, P, N).to(dtype) if with_init else None
    dfinal = randn(B, H, P, N) if with_dfinal else None
    _, _, scr = SSD._forward(x, dt, A, Bm, Cm, init, chunk)
    got = SSD.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, dfinal, scr, chunk=chunk,
                           init_state=init)
    again = SSD.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, dfinal, scr, chunk=chunk,
                             init_state=init)
    torch.cuda.synchronize()

    def f64(t):
        return None if t is None else t.double()
    want = SSD.ssd_scan_bwd_ref(*map(f64, (x, dt, A, Bm, Cm, dy, dfinal)),
                                chunk=chunk, init_state=f64(init))
    bound = SSD.bwd_error_bound(x, dt, A, Bm, Cm, dy, dfinal, chunk=chunk,
                                init_state=init, refs=want)
    types = (dtype, dtype, torch.float32, dtype, dtype, dtype)
    assert (got[5] is None) == (init is None)
    for g, h, w, b, t in zip(got, again, want, bound, types):
        if g is None:
            continue
        assert g.dtype == t and torch.equal(g, h)
        assert bool(((g.double() - w).abs() <= b).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_k4_backward_takes_its_dtypes_library(cuda, dtype):
    """A bfloat16 backward launches ``csrc/ssd_scan_bwd_bf16.cu``
    (``BF16_BWD_LAUNCHES``), a float32 one does not; the bfloat16 launch
    shape says how each case's tiles land (TMA, cp.async, registers)."""
    n0 = (SSD.BWD_LAUNCHES, SSD.BF16_BWD_LAUNCHES)
    B, S, H, P, G, N, chunk = K4_BWD_CASES[0][:7]
    gen = torch.Generator(device=cuda).manual_seed(8)
    x, dy = (torch.randn((B, S, H, P), generator=gen, device=cuda).to(dtype)
             for _ in range(2))
    dt = torch.rand((B, S, H), generator=gen, device=cuda)
    A = -torch.rand(H, generator=gen, device=cuda)
    Bm, Cm = (torch.randn((B, S, G, N), generator=gen, device=cuda).to(dtype)
              for _ in range(2))
    _, _, scr = SSD._forward(x, dt, A, Bm, Cm, None, chunk)
    SSD.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, None, scr, chunk=chunk)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    assert (SSD.BWD_LAUNCHES - n0[0], SSD.BF16_BWD_LAUNCHES - n0[1]) == \
        (1, int(bf16))
    if bf16:
        routes = {}
        for case in K4_BWD_CASES:
            B, S, H, P, G, N = case[:6]
            x = torch.zeros((B, S, H, P), device=cuda, dtype=dtype)
            Bm = torch.zeros((B, S, G, N), device=cuda, dtype=dtype)
            shape = SSD.bwd_bf16_launch_shape(x, x, Bm, Bm)
            routes[case] = (shape["x_load"], shape["bc_load"])
            assert shape["n_halves"] == (2 if N > 64 else 1)
        assert set(routes.values()) >= {("tma", "tma"), ("tma", "cp.async"),
                                        ("cp.async", "cp.async"),
                                        ("registers", "registers")}


@pytest.mark.cuda
def test_bf16_mamba2_train_step_launches_the_bf16_backward(cuda):
    """``value_and_grad`` of a reduced mamba2-370m at bfloat16 compute
    (the default RunOptions, remat none) on the card: ``SsdScanFn``
    launches K4's bfloat16 forward and its bfloat16 backward once per
    layer each; the loss and the gradients are finite."""
    from repro_torch.runtime.steps import value_and_grad
    cfg = get("mamba2-370m").reduced()
    model = Model(cfg, RunOptions(remat="none"))
    assert model.opts.compute_dtype == "bfloat16"
    params = model.init(torch.Generator().manual_seed(0), cuda)
    tokens = torch.randint(0, 256, (2, 128), device=cuda)
    n0 = (SSD.BF16_LAUNCHES, SSD.BWD_LAUNCHES, SSD.BF16_BWD_LAUNCHES)
    loss, grads = value_and_grad(model, params, {"tokens": tokens})
    assert (SSD.BF16_LAUNCHES - n0[0], SSD.BWD_LAUNCHES - n0[1],
            SSD.BF16_BWD_LAUNCHES - n0[2]) == (cfg.n_layers,) * 3
    assert bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ("qwen1.5-0.5b", "mixtral-8x7b",
                                  "internvl2-26b", "whisper-large-v3",
                                  "mamba2-370m", "hymba-1.5b"))
def test_train_step_on_card_matches_cpu(cuda, arch):
    """One step of the launcher's train step on the card (K3 both ways;
    K4 both ways for mamba2 and hymba) against the same step on the CPU:
    loss within 1e-5 relative, each gradient leaf within 1e-5 of its
    largest magnitude."""
    from repro_torch.data.tokens import make_batch_iter
    from repro_torch.launch.train import train_options
    from repro_torch.runtime.steps import (init_train_state,
                                           make_train_step, value_and_grad)
    cfg = get(arch).reduced()
    model = Model(cfg, train_options(64))
    runs = []
    for dev in ("cpu", cuda):
        state = init_train_state(model, torch.Generator().manual_seed(0), dev)
        batch = next(make_batch_iter(cfg, global_batch=2, seq_len=64,
                                     seed=0, device=dev))
        b0 = (FA.BWD_LAUNCHES, SSD.BWD_LAUNCHES)
        loss, grads = value_and_grad(model, state["params"], batch)
        _, met = make_train_step(model)(state, batch)
        runs.append((float(loss), grads, float(met["gnorm"]),
                     (FA.BWD_LAUNCHES - b0[0], SSD.BWD_LAUNCHES - b0[1])))
    (lc, gc, nc, _), (lg, gg, ng, launches) = runs
    uses = {"mamba2-370m": (False, True), "hymba-1.5b": (True, True)}
    assert tuple(n > 0 for n in launches) == uses.get(arch, (True, False))
    assert abs(lg - lc) <= 1e-5 * abs(lc) and abs(ng - nc) <= 1e-5 * nc
    for a, b in zip(gg, gc):
        assert float((a.cpu() - b).abs().max()) <= 1e-5 * float(
            b.abs().max().clamp_min(1e-30))


@pytest.mark.cuda
def test_host_sync_counter_on_card(cuda):
    """The tracer's host-synchronisation counter: a ``.item()`` counts
    one, device-only work counts none, and the debug mode is restored."""
    from repro_torch.obs.trace import host_syncs
    x = torch.arange(8.0, device=cuda)
    mode = torch.cuda.get_sync_debug_mode()
    assert host_syncs(lambda: x.sum().item(), cuda) == 1
    assert host_syncs(lambda: (x * 2).add_(1), cuda) == 0
    assert torch.cuda.get_sync_debug_mode() == mode


@pytest.mark.cuda
def test_tracer_on_card_launches_k1(cuda):
    """The tracer over the K1 engines on the card: one K1 launch per
    warm call of a single-store query or backfill, one per shard of a
    sharded query, no library loaded by a warm call, a valid trace."""
    from repro_torch.obs import engines as E
    from repro_torch.obs import validate_chrome_trace
    from repro_torch.obs.trace import trace_all
    records, trace = trace_all(only="pallas", reps=2, device=cuda)
    assert len(records) == 6
    assert validate_chrome_trace(trace) == []
    for name, rec in records.items():
        want = E.N_SHARDS if "sharded" in name else 1
        if name == "standing_backfill_pallas":
            want = E.Q_STAND                # one delta per query slot
        assert rec["launches"] == {"K1": want}, (name, rec["launches"])
        assert rec["recompiles"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("sharded", (False, True))
def test_ingest_tick_takes_stream_ids_on_the_card(cuda, sharded):
    """A tick's ``stream_ids`` given as a CUDA tensor (as the tracer's
    masked-tick engines pass them) land as the same rows as host ids."""
    from repro_torch.warehouse import ShardedStore
    stores = [ShardedStore(out_dim=2, n_shards=2, chunk_rows=8, device=cuda)
              if sharded else SegmentStore(out_dim=2, chunk_rows=8,
                                           device=cuda) for _ in range(2)]
    traces = {k: torch.arange(3, device=cuda).to(torch.float32)
              for k in ("c", "k", "qual", "on_s", "cl_s", "buffer_s")}
    ids = np.asarray([5, 2, 7], np.int32)
    for store, sid in zip(stores, (ids, torch.as_tensor(ids, device=cuda))):
        store.ingest_tick(traces, quality=torch.ones(3, device=cuda),
                          out_vecs=torch.zeros((3, 2), device=cuda), t=4,
                          stream_ids=sid, valid=np.asarray([1, 0, 1], bool))
    a, b = (s.host_rows() for s in stores)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert sorted(a["stream_id"].tolist()) == [5, 7]


@pytest.mark.cuda
def test_store_over_nccl_ranks_equals_the_stacked_store(cuda, tmp_path):
    """A world of NCCL ranks, one a card (as many cards as divide the 8
    shards: one on a one-card machine), spawned under a deadline, runs
    ``tests/_torch_dist.py``'s scenario on an 8-shard store spread over
    it; this process runs it on the stacked store on card 0: every row,
    answer (K1's partials and folds, the engine's, TopK ids, row plans,
    the compressed merge), standing answer, alert, rebalanced store and
    tier array bit for bit. The op log's floats lie on a grid of 1/16,
    so every sum is exact in float32 and K1's atomics cannot move a
    bit; the answers over the tiers' views, whose dequantized values
    are off that grid, within 1e-5 (this file's K1 tolerance). A CUDA
    store refuses a gloo group, a CPU store the NCCL group."""
    import _torch_dist as TD
    world = max(w for w in range(1, torch.cuda.device_count() + 1)
                if TD.SHARDS % w == 0)
    ops = TD.op_log(grid=16)
    draws = [np.random.default_rng(i).random((TD.SHARDS,) + shape)
             .astype(np.float32) for i, (_, shape) in enumerate(TD.COMPRESSED)]
    want = TD.scenario(None, ops, compressed_draws=draws,
                       tier_draws=[None, None], device="cuda")
    ranks, _ = TD.run_world(TD.rank_card, world, tmp_path, device=None,
                            ops=ops, compressed_draws=draws)
    TD.same_ranks([r["scenario"] for r in ranks], want, exact_views=False)
    for r in ranks:
        assert r["gloo"] == ("a store on cuda needs a nccl group; this "
                             "group's backend is gloo")
        assert r["nccl"] == ("a store on cpu needs a gloo group; this "
                             "group's backend is nccl")


@pytest.mark.cuda
def test_train_step_over_nccl_ranks_matches_the_unsharded_step(cuda,
                                                               tmp_path):
    """A world of NCCL ranks, one a card (as many cards as divide the
    global batch of 4 rows: one on a one-card machine), each holding its
    blocks of the train state (``make_train_step(..., mesh=)``, K3 and K4
    both ways on every rank), against the same two steps without a mesh
    on card 0 from the same state: bit for bit at one rank, else within
    ``tests/_torch_dist.held``'s train-step tolerances (the moments
    within 1e-5 of each leaf's largest magnitude, the params within that
    plus the bound of the one update)."""
    import _torch_dist as TD
    world = max(w for w in range(1, torch.cuda.device_count() + 1)
                if 4 % w == 0)
    rng = np.random.default_rng(0)
    opts = dict(remat="none", compute_dtype="float32")
    kw = dict(peak_lr=1e-2, warmup=2, total_steps=10)
    cases = []
    for arch in ("qwen1.5-0.5b", "mixtral-8x7b", "hymba-1.5b"):
        cfg = get(arch).reduced()
        model = Model(cfg, RunOptions(**opts))
        init = S.init_train_state(model, torch.Generator().manual_seed(0),
                                  "cpu")
        cases.append({"arch": arch, "opts": opts, "mesh": (world, 1),
                      "state": TD.host(init), "kw": kw, "batches": [
                          {"tokens": rng.integers(0, cfg.vocab, (4, 64))}
                          for _ in range(2)]})
    ranks, _ = TD.run_world(TD.rank_train_card, world, tmp_path,
                            device=None, cases=cases)
    for i, case in enumerate(cases):
        want = TD.plain_steps(case, device="cuda")
        got = ranks[0][i]
        for r in ranks[1:]:
            assert r[i]["metrics"] == got["metrics"]
        if world == 1:
            assert got["metrics"] == want["metrics"]
            TD.same_bits(got["state"], want["state"], case["arch"])
        else:
            TD.held(got, want, (case["arch"], world))


# the split's moments against the steps without a mesh, of each leaf's
# largest magnitude: K3 and K4 at H/m heads lay their 3xTF32 products
# and their head slices' partial sums out otherwise than at H heads, so
# a gradient moves by up to their error bounds (about 1e-3 of a sum's
# magnitudes at these lengths: chip_smoke.py's TRAIN_GRAD_TOL and
# DIST_MOMENT_TOL); measured on four H100s, mamba2's dt_bias second
# moment at 5.8e-5 of its largest value, above the CPU tests' 1e-5
SPLIT_MOMENT_TOL = 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("seq", (False, True))
@pytest.mark.parametrize("world", (2, 4))
def test_model_axis_split_over_nccl_ranks_matches_the_unsharded_step(
        cuda, tmp_path, world, seq):
    """The model axis computed over NCCL ranks, one a card: reduced qwen,
    mixtral (``moe_sharding="ep"``), mamba2 and hymba at (1, W) and, at
    4 ranks, (2, 2), each rank running K3 and K4 both ways on its own
    heads, with and without the sequence split (``seq``:
    ``seq_shard_activations``, the residual stream's rows split over
    ``"model"``), against the same two steps without a mesh on card 0 within
    ``tests/_torch_dist.held``'s train-step tolerances, the moments
    within SPLIT_MOMENT_TOL of each leaf's largest magnitude; at (1, W)
    no leaf gathered. Needs ``world`` cards (NCCL refuses a card twice;
    ``chip_smoke.py``'s ``train_dist`` part (d) runs two ranks on one
    card through gloo)."""
    import _torch_dist as TD
    if torch.cuda.device_count() < world:
        pytest.skip(f"{world} NCCL ranks need {world} cards; "
                    f"{torch.cuda.device_count()} visible")
    rng = np.random.default_rng(1)
    opts = dict(remat="none", compute_dtype="float32")
    kw = dict(peak_lr=1e-2, warmup=2, total_steps=10)
    meshes = [(1, world)] + ([(2, 2)] if world == 4 else [])
    cases = []
    for arch, moe in (("qwen1.5-0.5b", "tp"), ("mixtral-8x7b", "ep"),
                      ("mamba2-370m", "tp"), ("hymba-1.5b", "tp")):
        cfg = get(arch).reduced()
        o = {**opts, "moe_sharding": moe, "seq_shard_activations": seq}
        model = Model(cfg, RunOptions(**o))
        init = S.init_train_state(model, torch.Generator().manual_seed(0),
                                  "cpu")
        batches = [{"tokens": rng.integers(0, cfg.vocab, (4, 64))}
                   for _ in range(2)]
        cases += [{"arch": arch, "opts": o, "mesh": mesh,
                   "state": TD.host(init), "kw": kw, "batches": batches}
                  for mesh in meshes]
    ranks, _ = TD.run_world(TD.rank_train_card, world, tmp_path,
                            device=None, cases=cases)
    for i, case in enumerate(cases):
        want = TD.plain_steps(case, device="cuda")
        got = ranks[0][i]
        for r in ranks[1:]:
            assert r[i]["metrics"] == got["metrics"]
        TD.held(got, want, (case["arch"], case["mesh"]), SPLIT_MOMENT_TOL)
        assert got["bytes"]["model"] > 0
        if case["mesh"][0] == 1:
            assert got["bytes"]["gathered"] == 0, (case, got["bytes"])


# the split serving's logits against one rank's on the card: K3's
# 3xTF32 products (``error_bound``: about 1e-5 of a row's magnitudes at
# these lengths, the same per head at any head count) and the
# row-parallel products' parts added by an all-reduce, the decode's
# softmax merged over the ranks' slots: float32 sums of the same terms
# in another order, far inside 1e-4 of these reduced models' logits
SERVE_SPLIT_TOL = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("world", (2, 4))
def test_split_serving_over_nccl_ranks_matches_one_rank(cuda, tmp_path,
                                                        world):
    """Serving across NCCL ranks, one a card: reduced qwen, mixtral
    (``moe_sharding="ep"``), mamba2, hymba and whisper at (1, W) and, at
    4 ranks, (2, 2), each rank's prefill through K3 and K4 on its own
    heads, k and v moved to its slots, 3 decode steps each merging the
    softmax over the ranks' slots; against the same steps without a
    mesh on card 0: the logits within SERVE_SPLIT_TOL, the tokens equal
    except where the top two logits lie within it; K3 (and K4 for the
    SSM and hybrid families) launched on every rank. Needs ``world``
    cards (``chip_smoke.py``'s ``serve_dist`` runs two ranks on one card
    through gloo)."""
    import _torch_dist as TD
    if torch.cuda.device_count() < world:
        pytest.skip(f"{world} NCCL ranks need {world} cards; "
                    f"{torch.cuda.device_count()} visible")
    rng = np.random.default_rng(2)
    opts = dict(remat="none", compute_dtype="float32")
    meshes = [(1, world)] + ([(2, 2)] if world == 4 else [])
    cases = []
    for arch, moe in (("qwen1.5-0.5b", "tp"), ("mixtral-8x7b", "ep"),
                      ("mamba2-370m", "tp"), ("hymba-1.5b", "tp"),
                      ("whisper-large-v3", "tp")):
        cfg = get(arch).reduced()
        o = {**opts, "moe_sharding": moe}
        model = Model(cfg, RunOptions(**o))
        params = TD.host(model.init(torch.Generator().manual_seed(0), "cpu"))
        batch = {"tokens": rng.integers(0, cfg.vocab, (4, 40))
                 .astype(np.int32)}
        if cfg.family == "encdec":
            batch["frames"] = rng.standard_normal(
                (4, 48, cfg.d_model)).astype(np.float32)
        cases += [{"arch": arch, "opts": o, "mesh": mesh, "params": params,
                   "batch": batch, "cache_len": 48, "steps": 3}
                  for mesh in meshes]
    ranks, _ = TD.run_world(TD.rank_serve_card, world, tmp_path,
                            device=None, cases=cases)
    for i, case in enumerate(cases):
        want = TD.plain_serve(case, device="cuda")
        fam = get(case["arch"]).family
        for r in ranks:
            got = r[i]
            assert got["launches"]["k3"] > 0 or fam == "ssm", case["arch"]
            assert got["launches"]["k4"] > 0 or fam not in ("ssm",
                                                            "hybrid")
            for st, w in zip(got["steps"], want["steps"]):
                assert np.isfinite(st["logits"]).all()
                np.testing.assert_allclose(st["logits"], w["logits"],
                                           rtol=0, atol=SERVE_SPLIT_TOL,
                                           err_msg=str(case["mesh"]))
                top2 = np.sort(w["logits"], -1)[:, -2:]
                flip = st["tokens"] != w["tokens"]
                assert not (flip & (top2[:, 1] - top2[:, 0]
                                    > SERVE_SPLIT_TOL)).any(), case["arch"]

