"""The port's ``fit`` and ``run_skyscraper_fused`` against the reference
on the three workloads besides COVID (``_torch_parity.py`` pins COVID):
MOT, MOSEI-HIGH and MOSEI-LONG, on the CPU.

- ``fit`` (the port's own, from the same seed): configs, power, cost and
  the placement tables exactly, the KMeans centers to 1e-6, the
  forecaster layout;
- the fused run from the reference's fit carried across, on the same
  stream, in the ``model`` and ``oracle`` forecast modes: k and c
  traces equal at every step, plans to atol 1e-5 and the result's sums
  to rel 5e-4, the tolerances of ``test_torch_ingest.py``.

MOT fits on 1 day (21,600 segments of 4 s), MOSEI on 2 (its segments
are 7 s); the runs take 2,160 / 3,702 segments in 5 planning windows at
8 cores with no cloud.
"""
import functools

import numpy as np
import pytest

from _torch_parity import arrays_of
from _torch_threads import cap_torch_threads
from repro.configs import workloads as RWL
from repro.core import ingest as RI
from repro.core.offline import fit as ref_fit
from repro.data.stream import generate
from repro_torch.configs import workloads as PWL
from repro_torch.convert import fitted_from_arrays
from repro_torch.core import ingest as PI
from repro_torch.core.offline import fit
from repro_torch.data.stream import generate as p_generate

cap_torch_threads()

WORKLOADS = {"mot": (1.0, 0.05), "mosei-high": (2.0, 0.3),
             "mosei-long": (2.0, 0.3)}          # fit days, run days
MODES = ("model", "oracle")


@functools.lru_cache(maxsize=None)
def _fits(name):
    days = WORKLOADS[name][0]
    ref = ref_fit(RWL.WORKLOADS[name], n_cores=8, days_unlabeled=days,
                  seed=0)
    got = fit(PWL.WORKLOADS[name], n_cores=8, days_unlabeled=days, seed=0,
              device="cpu")
    return ref, got


@functools.lru_cache(maxsize=None)
def _runs(name, mode):
    ref_f, _ = _fits(name)
    days = WORKLOADS[name][1]
    kw = dict(n_cores=8, cloud_budget_core_s=0.0, plan_days=days / 5,
              forecast_mode=mode)
    ref = RI.run_skyscraper_fused(
        ref_f, generate(RWL.WORKLOADS[name], days=days, seed=42), **kw)
    got = PI.run_skyscraper_fused(
        fitted_from_arrays(name, arrays_of(ref_f), device="cpu"),
        p_generate(PWL.WORKLOADS[name], days=days, seed=42), device="cpu",
        **kw)
    return ref, got


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_fit_matches_reference(name):
    ref, got = _fits(name)
    assert got.configs == ref.configs
    for k in ("power", "cost", "place_rt", "place_on", "place_cl",
              "place_valid"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k),
                                      err_msg=k)
    for k in ("n_split", "interval_segments", "horizon_segments",
              "n_cores"):
        assert getattr(got, k) == getattr(ref, k), k
    np.testing.assert_allclose(got.centers, ref.centers, rtol=0, atol=1e-6)
    assert set(got.forecaster) == set(ref.forecaster)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_fused_run_matches_reference(name, mode):
    ref, got = _runs(name, mode)
    assert len(got.k_trace) == len(ref.k_trace) > 2000
    np.testing.assert_array_equal(got.k_trace, ref.k_trace)
    np.testing.assert_array_equal(got.c_trace, ref.c_trace)
    np.testing.assert_array_equal(got.k_hist, ref.k_hist)
    assert len(np.unique(got.k_trace)) > 1       # the switcher switched
    assert len(got.plans) == len(ref.plans)
    for (gr, ga), (rr, ra) in zip(got.plans, ref.plans):
        np.testing.assert_allclose(gr, rr, rtol=0, atol=1e-5)
        np.testing.assert_allclose(ga, ra, rtol=0, atol=1e-5)
    for k in ("quality_sum", "quality_max_sum", "onprem_core_s",
              "cloud_core_s", "buffer_peak_s"):
        assert getattr(got, k) == pytest.approx(getattr(ref, k), rel=5e-4,
                                                abs=1e-3), k
    assert got.overflow == ref.overflow
