"""The paper's headline claims on the port alone (``repro_torch.core``,
on the CPU), the port's own versions of ``tests/test_e2e_vetl.py``'s:
on a COVID camera-day (43,200 segments) with the port's own fit,
Skyscraper's per-window loop beats the best static config at equal
provisioning, stays within 6 points of the ground-truth optimum, and
obeys the buffer and the cloud budget. The other two claims are in
``test_torch_compare_monotone.py`` (more budget never hurts) and
``test_torch_compare_system.py`` (Chameleon* overflows on small
hardware; the V-ETL constraints on every workload). Each camera-day
takes about 25 s on one CPU core, so the claims are split by file."""
import pytest

from repro_torch.configs.workloads import COVID
from repro_torch.core import ingest as IG
from repro_torch.core.offline import fit
from repro_torch.data.stream import generate
from _torch_threads import cap_torch_threads

cap_torch_threads()


@pytest.fixture(scope="module")
def fitted():
    return fit(COVID, n_cores=8, days_unlabeled=4.0, n_categories=4, seed=0,
               device="cpu")


@pytest.fixture(scope="module")
def stream():
    return generate(COVID, days=1.0, seed=42)


@pytest.fixture(scope="module")
def sky(fitted, stream):
    return IG.run_skyscraper(fitted, stream, n_cores=8,
                             cloud_budget_core_s=10_000.0, plan_days=0.25,
                             device="cpu")


def test_skyscraper_beats_static(fitted, stream, sky):
    k = IG.best_static_config(fitted, 8)
    st = IG.run_static(fitted, stream, k, n_cores=8)
    assert sky.quality_pct > st.quality_pct + 2.0
    assert not sky.overflow


def test_close_to_optimum(fitted, stream, sky):
    opt = IG.run_optimum(fitted, stream, n_cores=8,
                         cloud_budget_core_s=10_000.0, device="cpu")
    assert sky.quality_pct > opt.quality_pct - 6.0, (
        sky.quality_pct, opt.quality_pct)
    assert opt.quality_pct >= sky.quality_pct - 1e-9


def test_buffer_and_cloud_limits(fitted, stream):
    sky = IG.run_skyscraper(fitted, stream, n_cores=8,
                            cloud_budget_core_s=500.0, buffer_gb=0.5,
                            plan_days=0.25, device="cpu")
    assert sky.buffer_peak_s <= 0.5 * 1e9 / 90e3 + 1e-3
    assert sky.cloud_core_s <= 500.0 + 1e-3
