"""More budget can never hurt, on the port alone (``repro_torch.core``,
on the CPU): the port's own version of ``tests/test_e2e_vetl.py``'s
``test_quality_monotone_in_resources``. Quality of the per-window loop
is (weakly) monotone in the cloud budget at fixed provisioning, on a
COVID camera-day with the port's own fit."""
from repro_torch.configs.workloads import COVID
from repro_torch.core import ingest as IG
from repro_torch.core.offline import fit
from repro_torch.data.stream import generate
from _torch_threads import cap_torch_threads

cap_torch_threads()


def test_quality_monotone_in_resources():
    fitted = fit(COVID, n_cores=8, days_unlabeled=4.0, n_categories=4,
                 seed=0, device="cpu")
    stream = generate(COVID, days=1.0, seed=42)
    q = []
    for cloud in (0.0, 5_000.0, 50_000.0):
        r = IG.run_skyscraper(fitted, stream, n_cores=8,
                              cloud_budget_core_s=cloud, plan_days=0.25,
                              device="cpu")
        assert r.cloud_core_s <= cloud + 1e-3
        q.append(r.quality_pct)
    assert q[1] >= q[0] - 0.5 and q[2] >= q[1] - 0.5, q
