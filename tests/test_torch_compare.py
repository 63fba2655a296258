"""The paper's comparisons in the port (``repro_torch.core``) against the
reference on the CPU, on the same carried-across ``Fitted`` and the same
streams.

- ``run_skyscraper`` (the per-window loop) in modes model, oracle and
  uniform, on the 0.11-day stream (4,752 segments) with ``plan_days=
  0.02`` (windows of 864, the last one padded): the k, c and buffer
  traces, ``k_hist`` and every ``RunResult`` sum equal; the forecasts
  and plans within 1e-5 (exactly equal in modes oracle and uniform; in
  mode model the port evaluates the forecast in float64, so a plan may
  differ in its last bits without changing a decision).
- ``online_finetune``: the forecaster is trained again between windows,
  and the port's Adam steps match the reference's within about 1e-5 a
  step, not bit for bit (autograd and XLA sum the gradients in other
  orders, and Adam divides by the root of tiny second moments). Over a
  run the differences grow, so this mode is held to stated tolerances
  (measured on this input: weights 4.6e-4 apart against a fine-tune that
  moves them by 3.6e-2, forecasts 7.4e-6, plans 2.1e-5, 8 of 21,600 k
  decisions, quality sums 1.8e-6 relative): weights within 1e-3,
  forecasts and plans within 1e-4, at most 0.5% of the k decisions
  different, and the sums within 1e-4 relative. The plans of the
  windows before the first fine-tune are held as in mode model.
- Each baseline's ``RunResult`` (Static at ``best_static_config``,
  VideoStorm-like, Chameleon* with and without an overflowing buffer)
  equal to the reference's, field by field.
- ``run_optimum`` at a full camera-day (43,200 segments: the LP at
  43,200 rows, whose spends recurse through two levels of XLA's tree
  reduction): its selection ``k_hist`` and its sums equal.
- ``solve_lp_scipy`` equal to the reference's, the infeasible case too;
  ``pad_window`` and ``run_window`` equal to the reference's.
- On MOT as well (a fit on one day of unlabeled video, carried across):
  each baseline's ``RunResult`` and ``run_optimum``'s selection and sums
  equal on a 0.05-day stream (1,080 segments of 4 s), the optimum with
  and without a cloud budget.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import arrays_of, port_fitted, ref_fitted
from repro.configs.workloads import COVID, MOT
from repro.core import ingest as RI
from repro.core import switcher as RS
from repro.core.offline import fit
from repro.core.planner import solve_lp_scipy as ref_scipy
from repro.data.stream import generate
from repro_torch.configs.workloads import COVID as P_COVID
from repro_torch.configs.workloads import MOT as P_MOT
from repro_torch.convert import fitted_from_arrays
from repro_torch.core import ingest as PI
from repro_torch.core import switcher as PS
from repro_torch.core.planner import solve_lp_scipy
from repro_torch.data.stream import generate as p_generate
from _torch_threads import cap_torch_threads

cap_torch_threads()

KW = dict(n_cores=8, cloud_budget_core_s=3000.0, plan_days=0.02)
MODES = ("model", "oracle", "uniform")
SUMS = ("quality_sum", "quality_max_sum", "onprem_core_s", "cloud_core_s",
        "buffer_peak_s", "overflow")


def _streams(days, seed, workload="covid"):
    ref, port = {"covid": (COVID, P_COVID), "mot": (MOT, P_MOT)}[workload]
    return generate(ref, days=days, seed=seed), \
        p_generate(port, days=days, seed=seed)


@functools.lru_cache(maxsize=None)
def _mot_fitted():
    """The reference's MOT fit on one day of unlabeled video, and the
    same carried across to the port."""
    f = fit(MOT, n_cores=8, days_unlabeled=1.0, seed=0)
    return f, fitted_from_arrays("mot", arrays_of(f), device="cpu")


@functools.lru_cache(maxsize=None)
def _runs(mode):
    rs, ps = _streams(0.11, 42)
    ref = RI.run_skyscraper(ref_fitted(), rs, forecast_mode=mode, **KW)
    got = PI.run_skyscraper(port_fitted(), ps, forecast_mode=mode,
                            device="cpu", **KW)
    return ref, got


@pytest.mark.parametrize("mode", MODES)
def test_skyscraper_traces_equal(mode):
    ref, got = _runs(mode)
    assert len(got.k_trace) == 4752
    for name in ("k_trace", "c_trace", "buffer_trace", "k_hist"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(ref, name), err_msg=name)
    assert got.k_trace.dtype == ref.k_trace.dtype == np.int32


@pytest.mark.parametrize("mode", MODES)
def test_skyscraper_sums_and_plans(mode):
    ref, got = _runs(mode)
    for name in SUMS:
        assert getattr(got, name) == getattr(ref, name), name
    assert got.quality_pct == ref.quality_pct
    assert len(got.plans) == len(ref.plans) == 6       # 5 full + 1 padded
    for (gr, ga), (rr, ra) in zip(got.plans, ref.plans):
        assert gr.dtype == rr.dtype
        if mode == "model":
            np.testing.assert_allclose(gr, rr, rtol=0, atol=1e-5)
            np.testing.assert_allclose(ga, ra, rtol=0, atol=1e-5)
        else:
            np.testing.assert_array_equal(gr, rr)
            np.testing.assert_array_equal(ga, ra)


def test_pad_window_and_run_window_equal():
    """The loop's last window (432 of 864 segments) goes through
    ``pad_window`` and ``run_window`` as the reference's does."""
    f = ref_fitted()
    tables = f.tables(buffer_gb=4.0, cloud_budget=3000.0)
    pt = port_fitted().tables(buffer_gb=4.0, cloud_budget=3000.0)
    rng = np.random.default_rng(3)
    K = len(f.configs)
    quals = rng.uniform(0, 1, (5, K)).astype(np.float32)
    arr = rng.uniform(0.5, 2, 5).astype(np.float32)
    alpha = rng.dirichlet(np.ones(K), f.centers.shape[0]).astype(np.float32)
    rq, ra, rv = RS.pad_window(jnp.asarray(quals), jnp.asarray(arr), 8)
    gq, ga, gv = PS.pad_window(torch.as_tensor(quals), torch.as_tensor(arr),
                               8)
    for g, r in ((gq, rq), (ga, ra), (gv, rv)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    rst, rout = RS.run_window(RS.init_state(tables), rq, ra,
                              jnp.asarray(alpha), tables, valid=rv)
    gst, gout = PS.run_window(PS.init_state(pt), gq, ga,
                              torch.as_tensor(alpha), pt, valid=gv)
    for k in ("k", "c", "qual", "on_s", "cl_s", "buffer_s", "dropped"):
        np.testing.assert_array_equal(gout[k].numpy(), np.asarray(rout[k]),
                                      err_msg=k)
    for k in ("used", "count", "buffer_s", "cloud_spent", "qual_prev"):
        np.testing.assert_array_equal(gst[k].numpy(), np.asarray(rst[k]),
                                      err_msg=k)
    # no valid mask: every step runs, the padding's too
    rst, rfull = RS.run_window(RS.init_state(tables), rq, ra,
                               jnp.asarray(alpha), tables)
    gst, gfull = PS.run_window(PS.init_state(pt), gq, ga,
                               torch.as_tensor(alpha), pt)
    for k in ("k", "c", "buffer_s"):
        np.testing.assert_array_equal(gfull[k].numpy(), np.asarray(rfull[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(gst["count"].numpy(),
                                  np.asarray(rst["count"]))
    assert float(gst["count"].sum()) == 8.0


# --------------------------- online fine-tuning -----------------------------

@functools.lru_cache(maxsize=None)
def _finetune_runs():
    """A fit on half a day of unlabeled video (interval 1,012, so the
    forecaster trains again from the 7th of 10 windows of 2,160)."""
    rf = fit(COVID, n_cores=8, days_unlabeled=0.5, seed=0)
    before = arrays_of(rf)
    pf = fitted_from_arrays("covid", before, device="cpu")
    rcopy = dataclasses.replace(rf)
    rs, ps = _streams(0.5, 42)
    kw = dict(n_cores=8, cloud_budget_core_s=3000.0, plan_days=0.05,
              forecast_mode="model", online_finetune=True)
    ref = RI.run_skyscraper(rcopy, rs, **kw)
    got = PI.run_skyscraper(pf, ps, device="cpu", **kw)
    return before, rcopy, pf, ref, got


def test_online_finetune_within_stated_tolerance():
    before, rcopy, pf, ref, got = _finetune_runs()
    moved = 0.0
    for layer in ("l1", "l2", "l3"):
        for p in ("w", "b"):
            mine = pf.forecaster[layer][p].numpy()
            theirs = np.asarray(rcopy.forecaster[layer][p])
            moved = max(moved, float(np.abs(theirs - before["forecaster"]
                                            [layer][p]).max()))
            np.testing.assert_allclose(mine, theirs, rtol=0, atol=1e-3)
    assert moved > 1e-2          # the fine-tune did train, on both sides
    assert len(got.plans) == len(ref.plans) == 10
    for i, ((gr, ga), (rr, ra)) in enumerate(zip(got.plans, ref.plans)):
        tol = 1e-5 if i < 7 else 1e-4
        np.testing.assert_allclose(gr, rr, rtol=0, atol=tol)
        np.testing.assert_allclose(ga, ra, rtol=0, atol=tol)
    assert np.mean(got.k_trace != ref.k_trace) <= 0.005
    for name in SUMS[:-1]:
        assert getattr(got, name) == pytest.approx(getattr(ref, name),
                                                   rel=1e-4, abs=1e-3), name
    assert got.overflow == ref.overflow


def test_online_finetune_replaces_the_callers_forecaster():
    """As in the reference, the fine-tuned forecaster replaces the
    caller's ``fitted.forecaster``, on the caller's device."""
    before, _, pf, _, _ = _finetune_runs()
    assert pf.device == torch.device("cpu")
    assert pf.forecaster["l1"]["w"].device == torch.device("cpu")
    assert not np.array_equal(pf.forecaster["l1"]["w"].numpy(),
                              before["forecaster"]["l1"]["w"])


# ------------------------------- baselines ----------------------------------

BASELINES = {
    "static": lambda IG, f, s: IG.run_static(
        f, s, IG.best_static_config(f, 8), n_cores=8),
    "static_cloud": lambda IG, f, s: IG.run_static(
        f, s, 0, n_cores=8, cloud_budget_core_s=2000.0, buffer_gb=0.05),
    "videostorm": lambda IG, f, s: IG.run_videostorm_like(f, s, n_cores=8),
    "videostorm_small": lambda IG, f, s: IG.run_videostorm_like(
        f, s, n_cores=8, buffer_gb=0.02, cloud_budget_core_s=500.0),
    "chameleon": lambda IG, f, s: IG.run_chameleon_star(f, s, n_cores=8),
    "chameleon_small": lambda IG, f, s: IG.run_chameleon_star(
        f, s, n_cores=1, buffer_gb=0.02),
}


@pytest.mark.parametrize("name", sorted(BASELINES))
def test_baseline_run_result_equal(name):
    rs, ps = _streams(0.11, 42)
    ref = BASELINES[name](RI, ref_fitted(), rs)
    got = BASELINES[name](PI, port_fitted(), ps)
    for field in SUMS:
        assert getattr(got, field) == getattr(ref, field), field
    np.testing.assert_array_equal(got.k_hist, ref.k_hist)
    if name == "chameleon_small":
        assert got.overflow          # the buffer-agnostic baseline drops


@pytest.mark.parametrize("name", sorted(BASELINES))
def test_baseline_run_result_equal_on_mot(name):
    rs, ps = _streams(0.05, 42, "mot")
    rf, pf = _mot_fitted()
    ref = BASELINES[name](RI, rf, rs)
    got = BASELINES[name](PI, pf, ps)
    for field in SUMS:
        assert getattr(got, field) == getattr(ref, field), field
    np.testing.assert_array_equal(got.k_hist, ref.k_hist)


def test_best_static_config_equal():
    f, pf = ref_fitted(), port_fitted()
    for cores in (1, 2, 4, 8, 16, 64):
        assert PI.best_static_config(pf, cores) == \
            RI.best_static_config(f, cores)


# -------------------------------- optimum -----------------------------------

@pytest.mark.parametrize("cloud", [0.0, 10_000.0])
def test_optimum_selection_exact_at_a_camera_day(cloud):
    rs, ps = _streams(1.0, 42)
    ref = RI.run_optimum(ref_fitted(), rs, n_cores=8,
                         cloud_budget_core_s=cloud)
    got = PI.run_optimum(port_fitted(), ps, n_cores=8,
                         cloud_budget_core_s=cloud, device="cpu")
    assert got.k_hist.sum() == 43_200
    np.testing.assert_array_equal(got.k_hist, ref.k_hist)
    for field in SUMS:
        assert getattr(got, field) == getattr(ref, field), field


@pytest.mark.parametrize("cloud", [0.0, 2_000.0])
def test_optimum_selection_exact_on_mot(cloud):
    rs, ps = _streams(0.05, 42, "mot")
    rf, pf = _mot_fitted()
    ref = RI.run_optimum(rf, rs, n_cores=8, cloud_budget_core_s=cloud)
    got = PI.run_optimum(pf, ps, n_cores=8, cloud_budget_core_s=cloud,
                         device="cpu")
    assert got.k_hist.sum() == ps.n_segments
    np.testing.assert_array_equal(got.k_hist, ref.k_hist)
    for field in SUMS:
        assert getattr(got, field) == getattr(ref, field), field


# ------------------------------- the LP oracle ------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_solve_lp_scipy_equal(seed):
    rng = np.random.default_rng(seed)
    C, K = int(rng.integers(1, 7)), int(rng.integers(1, 9))
    qual = rng.uniform(0, 1, (C, K)).astype(np.float32)
    cost = rng.uniform(0.1, 5, K).astype(np.float32)
    r = rng.dirichlet(np.ones(C)).astype(np.float32)
    budget = float(rng.uniform(cost.min(), cost.max()))
    want = ref_scipy(qual, cost, r, budget)
    np.testing.assert_array_equal(solve_lp_scipy(qual, cost, r, budget),
                                  want)
    got = solve_lp_scipy(torch.as_tensor(qual), torch.as_tensor(cost),
                         torch.as_tensor(r), budget)
    np.testing.assert_array_equal(got, want)


def test_solve_lp_scipy_infeasible_takes_the_cheapest():
    qual = np.array([[0.5, 0.9], [0.4, 0.8]], np.float32)
    cost = np.array([2.0, 1.0], np.float32)
    r = np.array([0.5, 0.5], np.float32)
    got = solve_lp_scipy(qual, cost, r, 0.1)
    np.testing.assert_array_equal(got, ref_scipy(qual, cost, r, 0.1))
    np.testing.assert_array_equal(got, [[0.0, 1.0], [0.0, 1.0]])
