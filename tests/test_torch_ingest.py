"""The port's fused single-stream run against the reference's
``run_skyscraper_fused``, on the same carried-across ``Fitted`` and the
same stream, on the CPU.

``plan_days=0.02`` cuts the 0.11-day stream (4,752 segments) into
planning windows of 864 segments, the last one padded. Per mode
(model, oracle, uniform):

- ``k_trace`` and ``c_trace`` are equal at every step;
- the forecasts ``rs`` and the plans ``alphas`` agree to atol 1e-5
  (the port evaluates the forecast in float64 and the reference's
  compiled LP reduces its spends in another order, so a plan may differ
  in its last bits without changing a decision);
- the ``RunResult`` sums agree to rel 5e-4, the tolerance
  tests/test_fused_ingest.py holds.
"""
import functools

import numpy as np
import pytest

from _torch_parity import port_fitted, ref_fitted
from repro.configs.workloads import COVID
from repro.core import ingest as RI
from repro.data.stream import generate
from repro_torch.configs.workloads import COVID as P_COVID
from repro_torch.core import ingest as PI
from repro_torch.data.stream import generate as p_generate
from _torch_threads import cap_torch_threads

cap_torch_threads()

KW = dict(n_cores=8, cloud_budget_core_s=3000.0, plan_days=0.02)


@functools.lru_cache(maxsize=None)
def _runs(mode):
    ref = RI.run_skyscraper_fused(ref_fitted(),
                                  generate(COVID, days=0.11, seed=42),
                                  forecast_mode=mode, **KW)
    got = PI.run_skyscraper_fused(port_fitted(),
                                  p_generate(P_COVID, days=0.11, seed=42),
                                  forecast_mode=mode, device="cpu", **KW)
    return ref, got


MODES = ("model", "oracle", "uniform")


@pytest.mark.parametrize("mode", MODES)
def test_traces_equal(mode):
    ref, got = _runs(mode)
    assert len(got.k_trace) == 4752
    np.testing.assert_array_equal(got.k_trace, ref.k_trace)
    np.testing.assert_array_equal(got.c_trace, ref.c_trace)
    np.testing.assert_array_equal(got.k_hist, ref.k_hist)
    np.testing.assert_allclose(got.buffer_trace, ref.buffer_trace,
                               rtol=5e-4, atol=1e-3)


@pytest.mark.parametrize("mode", MODES)
def test_forecasts_and_plans(mode):
    ref, got = _runs(mode)
    assert len(got.plans) == len(ref.plans) == 6       # 5 full + 1 padded
    for (gr, ga), (rr, ra) in zip(got.plans, ref.plans):
        np.testing.assert_allclose(gr, rr, rtol=0, atol=1e-5)
        np.testing.assert_allclose(ga, ra, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_run_result_sums(mode):
    ref, got = _runs(mode)
    for k in ("quality_sum", "quality_max_sum", "onprem_core_s",
              "cloud_core_s", "buffer_peak_s"):
        assert getattr(got, k) == pytest.approx(getattr(ref, k), rel=5e-4,
                                                abs=1e-3), k
    assert got.overflow == ref.overflow
    assert got.quality_pct == pytest.approx(ref.quality_pct, rel=5e-4)


def test_window_layout_matches_reference():
    for T, W in ((4752, 864), (100, 100), (101, 100), (7, 3)):
        got = PI._window_layout(T, W)
        want = RI._window_layout(T, W)
        assert got[:2] == tuple(int(x) for x in want[:2])
        np.testing.assert_array_equal(got[2], np.asarray(want[2]))
        np.testing.assert_array_equal(got[3], np.asarray(want[3]))


def test_unknown_mode_raises():
    with pytest.raises(ValueError):
        PI.run_skyscraper_fused(port_fitted(),
                                p_generate(P_COVID, days=0.01, seed=1),
                                forecast_mode="nope", device="cpu", **KW)
