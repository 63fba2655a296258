"""The port's switcher and planner against the reference, on the
reference fit's tables carried across.

- ``window_scan`` vs ``run_window``: every output leaf (k, p, c, qual,
  on_s, cl_s, buffer_s, rt, dropped) and the final state are compared
  bit for bit at every step, including arrival spikes that force drops,
  a tiny buffer that forces cloud placements, and padded no-op steps.
- ``solve_lp_lagrangian`` vs the reference: bit-exact on every
  instance (the port sums each spend in the order of the reference's
  compiled CPU program, inside and outside its bisection loop), on the
  uniform plan the fused run starts from and on the rationed entry
  point; and vs ``solve_lp_scipy`` by plan value, as
  tests/test_planner.py checks, including K=1 and infeasible budgets.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import port_fitted, ref_fitted
from repro.core import planner as RP
from repro.core import switcher as RS
from repro_torch.core import planner as PP
from repro_torch.core import switcher as PS

LEAVES = ("k", "p", "c", "qual", "on_s", "cl_s", "buffer_s", "rt",
          "dropped")
W = 240


def _case(kind, seed=3):
    f = ref_fitted()
    C, K = f.centers.shape
    rng = np.random.default_rng(seed)
    quals = np.clip(rng.random((W, K)), 0, 1).astype(np.float32)
    arrivals = np.ones(W, np.float32)
    valid = np.ones(W, bool)
    alpha = rng.random((C, K)).astype(np.float32)
    alpha /= alpha.sum(1, keepdims=True)
    kw = dict(buffer_gb=4.0, cloud_budget=0.0)
    if kind == "spike":
        arrivals[40:70] = 4000.0        # no config/placement fits: drops
        kw["buffer_gb"] = 0.002
    elif kind == "cloud":
        kw = dict(buffer_gb=0.001, cloud_budget=400.0)
        arrivals[:] = 3.0
    elif kind == "padded":
        valid[W - 37:] = False
        quals[W - 37:] = 0.0
        arrivals[W - 37:] = 1.0
    return f, kw, quals, arrivals, valid, alpha


@pytest.mark.parametrize("kind", ("steady", "spike", "cloud", "padded"))
def test_window_scan_bit_exact(kind):
    f, kw, quals, arrivals, valid, alpha = _case(kind)
    rt = f.tables(**kw)
    r_state, r_outs = RS.run_window(RS.init_state(rt), jnp.asarray(quals),
                                    jnp.asarray(arrivals),
                                    jnp.asarray(alpha), rt,
                                    valid=jnp.asarray(valid))
    pt = port_fitted().tables(**kw)
    p_state, p_outs = PS.window_scan(PS.init_state(pt), torch.tensor(quals),
                                     torch.tensor(arrivals),
                                     torch.tensor(valid), torch.tensor(alpha),
                                     pt)
    for leaf in LEAVES:
        np.testing.assert_array_equal(p_outs[leaf].numpy(),
                                      np.asarray(r_outs[leaf]),
                                      err_msg=leaf)
    for key, val in r_state.items():
        np.testing.assert_array_equal(p_state[key].numpy(), np.asarray(val),
                                      err_msg=key)
    if kind == "spike":
        assert p_outs["dropped"].any(), "setup must force drops"
    if kind == "cloud":
        assert float(p_outs["cl_s"].sum()) > 0, "setup must use the cloud"
    if kind == "padded":
        assert not p_outs["qual"][W - 37:].any()


def _lp_instance(seed, kind="random"):
    rng = np.random.default_rng(seed)
    C = int(rng.integers(1, 8))
    K = int(rng.integers(1, 10))
    qual = rng.random((C, K)).astype(np.float32)
    cost = np.sort(rng.random(K) * 10 + 0.1).astype(np.float32)
    r = rng.random(C).astype(np.float32) + 0.01
    r /= r.sum()
    if kind == "infeasible":
        budget = float(cost.min()) * float(rng.random() * 0.9)
    else:
        budget = float(rng.random() * 12)
    return qual, cost, r, np.float32(budget)


def _both(qual, cost, r, budget):
    want = np.asarray(RP.solve_lp_lagrangian(
        jnp.asarray(qual), jnp.asarray(cost), jnp.asarray(r), budget))
    got = PP.solve_lp_lagrangian(torch.tensor(qual), torch.tensor(cost),
                                 torch.tensor(r), budget).numpy()
    return got, want


@pytest.mark.parametrize("kind", ("random", "infeasible"))
def test_lp_matches_reference(kind):
    for seed in range(120):
        got, want = _both(*_lp_instance(seed, kind))
        np.testing.assert_array_equal(got, want, err_msg=str(seed))


def test_lp_uniform_plan_bit_exact():
    """The fused run's plans on the fit's own tables with the uniform
    forecast, across budgets: bit-exact."""
    f = ref_fitted()
    C = f.centers.shape[0]
    r = np.full(C, 1.0 / C, np.float32)
    for budget in np.linspace(float(f.cost.min()) * 0.5,
                              float(f.cost.max()) * 1.2, 25):
        got, want = _both(f.centers, f.cost, r, np.float32(budget))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ("random", "infeasible"))
def test_lp_value_matches_scipy(kind):
    for seed in range(60):
        qual, cost, r, budget = _lp_instance(100 + seed, kind)
        a_ref = RP.solve_lp_scipy(qual, cost, r, float(budget))
        a = PP.solve_lp_lagrangian(torch.tensor(qual), torch.tensor(cost),
                                   torch.tensor(r), budget).numpy()
        q = float((r[:, None] * a * qual).sum())
        s = float((r[:, None] * a * cost[None]).sum())
        q_ref = float((r[:, None] * a_ref * qual).sum())
        s_ref = float((r[:, None] * a_ref * cost[None]).sum())
        np.testing.assert_allclose(a.sum(1), 1.0, atol=1e-4)
        assert (a >= -1e-6).all()
        assert abs(q - q_ref) <= 1e-4, (seed, q, q_ref)
        if kind == "infeasible":
            assert abs(s - s_ref) <= 1e-3, (seed, s, s_ref)
        else:
            assert s <= max(float(budget), s_ref) + 1e-3, (seed, s, budget)
        if qual.shape[1] == 1:
            np.testing.assert_allclose(a, 1.0, atol=1e-6)


def test_lp_rationed_matches_reference():
    f = ref_fitted()
    r = np.asarray([0.1, 0.2, 0.3, 0.4], np.float32)
    for cloud_left, frac in ((0.0, 1.0), (2_500.0, 0.4), (-5.0, 0.7)):
        kw = dict(core_s_per_segment=16.0, cloud_left=cloud_left, frac=frac,
                  window_len=864.0, cloud_premium=1.8)
        want = np.asarray(RP.solve_lp_rationed(
            jnp.asarray(f.centers), jnp.asarray(f.cost), jnp.asarray(r),
            **kw))
        got = PP.solve_lp_rationed(torch.tensor(f.centers),
                                   torch.tensor(f.cost), torch.tensor(r),
                                   **kw).numpy()
        np.testing.assert_array_equal(got, want)
