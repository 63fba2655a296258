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
- The stacked and batched LPs of the multi-stream run and the serving
  pool, bit for bit on a seeded grid (V in {1, 2, 3, 8, 16, 64}, C in
  2..8, K from 3 to 24): ``solve_lp_stacked`` (one LP of V*C rows, with
  and without priority weights) against the reference's, and
  ``solve_lp_batched`` against ``jax.vmap(solve_lp_lagrangian)``, the
  pool's replan, whose XLA program adds its spends in other orders. A
  budget one float32 step either side of the unconstrained plan's
  spend pins the order of the spends outside the bisection loop too.
- The pool's shed prefix sum (``api._prefix_sum``) against the
  reference's compiled ``jnp.cumsum``, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import port_fitted, ref_fitted
from repro.core import planner as RP
from repro.core import switcher as RS
from repro_torch.core import api as PA
from repro_torch.core import planner as PP
from repro_torch.core import switcher as PS
from _torch_threads import cap_torch_threads

cap_torch_threads()

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


# ---------------------------------------------------------------------------
# stacked and batched LPs (the multi-stream run and the serving pool)
# ---------------------------------------------------------------------------

GRID_V = (1, 2, 3, 8, 16, 64)
GRID_CK = [(C, K) for C in range(2, 9) for K in (3, 8, 17, 24)]


def _stacked_case(seed, V, C, K, joint=True):
    rng = np.random.default_rng(seed)
    qual = rng.random((V, C, K)).astype(np.float32)
    cost = np.sort(rng.random(K) * 10 + 0.1).astype(np.float32)
    r = rng.random((V, C)).astype(np.float32) + 0.01
    r /= r.sum(1, keepdims=True)
    scale = V if joint else 1
    budgets = (np.float32(rng.random() * 12 * scale),
               np.float32(rng.random() * 6 * scale))
    w = (rng.random(V) * 3 + 0.5).astype(np.float32)
    return qual, cost, r, budgets, w


@pytest.mark.parametrize("V", GRID_V)
def test_lp_stacked_matches_reference(V):
    """The joint LP of V streams (``_fused_run_multi``'s plan): V*C rows
    reach XLA's tree-reduced spend past 32 and its vectorised kernels
    below; each budget's plan bit-exact."""
    for C, K in GRID_CK:
        qual, cost, r, budgets, _ = _stacked_case(V * 1000 + C * 31 + K, V,
                                                  C, K)
        for b in budgets:
            want = np.asarray(RP.solve_lp_stacked(
                jnp.asarray(qual), jnp.asarray(cost), jnp.asarray(r), b))
            got = PP.solve_lp_stacked(torch.tensor(qual), torch.tensor(cost),
                                      torch.tensor(r), b).numpy()
            np.testing.assert_array_equal(got, want, err_msg=str((C, K, b)))


@pytest.mark.parametrize("V", (1, 3, 8, 16))
def test_lp_stacked_weighted_matches_reference(V):
    """The pool's priority-weighted joint LP (``_pool_replan_stacked``):
    outside the loop XLA contracts the weighting into the score."""
    f = jax.jit(lambda q, c, r, b, w: RP.solve_lp_stacked(q, c, r, b,
                                                          weights=w))
    for C, K in GRID_CK[::2]:
        qual, cost, r, budgets, w = _stacked_case(V * 977 + C * 13 + K, V,
                                                  C, K)
        for b in budgets:
            want = np.asarray(f(jnp.asarray(qual), jnp.asarray(cost),
                                jnp.asarray(r), b, jnp.asarray(w)))
            got = PP.solve_lp_stacked(torch.tensor(qual), torch.tensor(cost),
                                      torch.tensor(r), b,
                                      weights=torch.tensor(w)).numpy()
            np.testing.assert_array_equal(got, want, err_msg=str((C, K, b)))


def _vmapped():
    return jax.jit(lambda q, c, r, b: jax.vmap(
        lambda rv: RP.solve_lp_lagrangian(q, c, rv, b))(r))


@pytest.mark.parametrize("V", GRID_V)
def test_lp_batched_matches_vmapped_reference(V):
    """The pool's independent replans (``_pool_replan`` vmaps the solver
    over the slots): each stream's plan bit-exact, where a per-stream
    loop of the plain solver differs (XLA hoists and vectorises the
    batched program's spends otherwise)."""
    f = _vmapped()
    for C, K in GRID_CK:
        qual, cost, r, budgets, _ = _stacked_case(V * 733 + C * 7 + K, V, C,
                                                  K, joint=False)
        for b in budgets:
            want = np.asarray(f(jnp.asarray(qual[0]), jnp.asarray(cost),
                                jnp.asarray(r), b))
            got = PP.solve_lp_batched(torch.tensor(qual[0]),
                                      torch.tensor(cost), torch.tensor(r),
                                      b).numpy()
            np.testing.assert_array_equal(got, want, err_msg=str((C, K, b)))


@pytest.mark.parametrize("kind", ("stacked", "batched"))
def test_lp_outside_spend_order(kind):
    """The unconstrained plan's spend s0 decides ``s0 <= budget``: with
    the budget at the port's s0 the plan is that plan, one float32 step
    below it the blend; the reference must agree at both, so its s0 is
    the port's to the bit."""
    f = _vmapped()
    for V in (1, 2, 3, 8, 16, 64):
        for C in range(1, 9):
            K = 3 + (V + C) % 10
            rng = np.random.default_rng(V * 100 + C)
            qual = rng.random((V, C, K)).astype(np.float32)
            cost = np.sort(rng.random(K) * 10 + 0.1).astype(np.float32)
            r = rng.random((V, C)).astype(np.float32) + 0.01
            r /= r.sum(1, keepdims=True)
            if kind == "stacked":
                _, s0 = PP._pick(torch.tensor(qual).reshape(1, V * C, K),
                                 torch.tensor(cost),
                                 torch.tensor(r).reshape(1, V * C),
                                 torch.zeros(1), False)
            else:
                _, s0 = PP._pick(torch.tensor(qual[0]).expand(V, C, K),
                                 torch.tensor(cost), torch.tensor(r),
                                 torch.zeros(V), V > 1)
            top = np.float32(s0.max())
            for b in (top, np.nextafter(top, np.float32(-np.inf))):
                if kind == "stacked":
                    want = np.asarray(RP.solve_lp_stacked(
                        jnp.asarray(qual), jnp.asarray(cost),
                        jnp.asarray(r), b))
                    got = PP.solve_lp_stacked(
                        torch.tensor(qual), torch.tensor(cost),
                        torch.tensor(r), b).numpy()
                else:
                    want = np.asarray(f(jnp.asarray(qual[0]),
                                        jnp.asarray(cost), jnp.asarray(r),
                                        b))
                    got = PP.solve_lp_batched(
                        torch.tensor(qual[0]), torch.tensor(cost),
                        torch.tensor(r), b).numpy()
                np.testing.assert_array_equal(got, want,
                                              err_msg=str((V, C, K, b)))


def test_lp_batched_is_one_chain_of_tensor_ops():
    """The batched solver costs the same number of tensor ops for 2 and
    for 64 streams (no Python loop over streams)."""
    def n_ops(V):
        q = torch.rand(4, 6, generator=torch.Generator().manual_seed(0))
        c = torch.linspace(1.0, 3.0, 6)
        r = torch.full((V, 4), 0.25)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]) as prof:
            PP.solve_lp_batched(q, c, r, 2.0, iters=8)
        return sum(e.count for e in prof.key_averages())
    assert n_ops(2) == n_ops(64)


@pytest.mark.parametrize("n", (1, 5, 16, 17, 100, 256, 257, 1000, 4096))
def test_prefix_sum_matches_xla_cumsum(n):
    """XLA's CPU cumsum is a blocked scan of 16 (its reduce-window
    rewrite), not a sequential sum past 16 values; the port's prefix sum
    takes that order, in elementwise adds."""
    f = jax.jit(jnp.cumsum)
    for seed in range(3):
        rng = np.random.default_rng(seed * 10_000 + n)
        x = (rng.random(n) * 10.0 ** rng.integers(-1, 4)).astype(np.float32)
        np.testing.assert_array_equal(
            PA._prefix_sum(torch.tensor(x)).numpy(),
            np.asarray(f(jnp.asarray(x))))


# the LPs at the card's sizes: the multi-stream run's joint plan (256
# streams x 4 categories = 1,024 rows, 32 windows of 32), one past it that
# is no multiple of 32 (1,100 rows: a padded window), and the pool's
# replans at its top slot bucket (2,048 slots x 3 categories: 6,144 rows,
# past 32 windows, so the tree reduction recurses)
CARD_SHAPES = [("stacked", 256, 4, 8), ("stacked", 275, 4, 8),
               ("stacked", 2048, 3, 3), ("weighted", 512, 3, 3),
               ("weighted", 275, 4, 8), ("weighted", 2048, 3, 3),
               ("batched", 512, 3, 3), ("batched", 2048, 3, 3)]


@pytest.mark.parametrize("kind,V,C,K", CARD_SHAPES)
def test_lp_matches_reference_at_card_shapes(kind, V, C, K):
    """Bit-exact plans at the sizes the card runs, for binding budgets
    (the blend reads every in-loop spend) and at the unconstrained
    plan's spend and one float32 step below it (the outside spend)."""
    qual, cost, r, budgets, w = _stacked_case(V * 11 + C + K, V, C, K,
                                              joint=kind != "batched")
    tq, tc, tr = torch.tensor(qual), torch.tensor(cost), torch.tensor(r)
    if kind == "batched":
        f = _vmapped()
        ref = lambda b: f(jnp.asarray(qual[0]), jnp.asarray(cost),  # noqa
                          jnp.asarray(r), b)
        port = lambda b: PP.solve_lp_batched(tq[0], tc, tr, b)      # noqa
        _, s0 = PP._pick(tq[0].expand(V, C, K), tc, tr, torch.zeros(V), True)
    else:
        wj = jnp.asarray(w) if kind == "weighted" else None
        wt = torch.tensor(w) if kind == "weighted" else None
        f = jax.jit(lambda q, c, rr, b, ww: RP.solve_lp_stacked(
            q, c, rr, b, weights=ww))
        ref = lambda b: f(jnp.asarray(qual), jnp.asarray(cost),     # noqa
                          jnp.asarray(r), b, wj)
        port = lambda b: PP.solve_lp_stacked(tq, tc, tr, b,         # noqa
                                             weights=wt)
        wq = tq if wt is None else tq * wt[:, None, None]
        _, s0 = PP._pick(wq.reshape(1, V * C, K), tc, tr.reshape(1, V * C),
                         torch.zeros(1), False)
    top = np.float32(s0.max())
    for b in budgets + (top, np.nextafter(top, np.float32(-np.inf))):
        np.testing.assert_array_equal(port(b).numpy(), np.asarray(ref(b)),
                                      err_msg=str((kind, V, C, K, b)))
