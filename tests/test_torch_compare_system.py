"""System behaviour on the port alone (``repro_torch.core``, on the
CPU), the port's own versions of ``tests/test_system.py``'s and of
``tests/test_e2e_vetl.py``'s ``test_chameleon_star_overflows_small_hw``:
the V-ETL definition's two constraints (Eq. 1 throughput: the buffer
never overflows; the cloud budget) hold at once on every workload, and
on small hardware the buffer-agnostic Chameleon* overflows where
Skyscraper's guarantee holds."""
import pytest

from repro_torch.configs.workloads import COVID, WORKLOADS
from repro_torch.core import ingest as IG
from repro_torch.core.offline import fit
from repro_torch.data.stream import generate
from _torch_threads import cap_torch_threads

cap_torch_threads()


@pytest.mark.parametrize("wname", sorted(WORKLOADS))
def test_vetl_constraints_hold(wname):
    w = WORKLOADS[wname]
    f = fit(w, n_cores=16, days_unlabeled=3.0,
            n_categories=4 if wname in ("covid", "mot") else 5, seed=0,
            device="cpu")
    s = generate(w, days=0.5, seed=11)
    res = IG.run_skyscraper(f, s, n_cores=16, cloud_budget_core_s=5_000.0,
                            buffer_gb=1.0, plan_days=0.1, device="cpu")
    cap_s = 1.0 * 1e9 / 90e3
    assert res.buffer_peak_s <= cap_s + 1e-3          # Eq. 1
    assert res.cloud_core_s <= 5_000.0 + 1e-3         # budget
    assert not res.overflow
    assert res.quality_pct > 50.0


def test_chameleon_star_overflows_small_hw():
    f4 = fit(COVID, n_cores=4, days_unlabeled=4.0, n_categories=4, seed=0,
             device="cpu")
    s = generate(COVID, days=1.0, seed=7)
    ch = IG.run_chameleon_star(f4, s, n_cores=4, buffer_gb=0.02)
    sky = IG.run_skyscraper(f4, s, n_cores=4, buffer_gb=0.02,
                            plan_days=0.25, device="cpu")
    assert ch.overflow          # paper: Chameleon* crashes on small hw
    assert not sky.overflow     # Skyscraper's guarantee holds
    assert sky.buffer_peak_s <= 0.02 * 1e9 / 90e3 + 1e-3
