"""Knob planner (paper §4.1): assign knob-config mixing histograms to
content categories, maximizing expected quality under a compute budget.

    max   sum_{k,c} a[k,c] r[c] qual[k,c]
    s.t.  sum_{k,c} a[k,c] r[c] cost[k] <= budget
          sum_k a[k,c] = 1,  a >= 0                       (per category)

Port of ``repro/core/planner.py``'s exact Lagrangian solver: the dual is
a 1-D piecewise-linear function of the budget multiplier λ, so bisect λ
(each category picks argmax_k (qual - λ·cost)), then blend the
prefer-cheap / prefer-expensive endpoint plans to exhaust the budget.
Every step is a tensor op on the inputs' device, with no host read, so
the solver runs between switcher windows without a synchronisation.
``solve_lp_scipy`` is the paper's approach, an off-the-shelf LP (HiGHS)
on the host in float64, kept as the oracle the exact solver is held to.
"""
from __future__ import annotations

import numpy as np
import torch


def solve_lp_scipy(qual, cost, r, budget):
    """The LP through ``scipy.optimize.linprog(method="highs")`` on the
    host in float64, as the reference solves it: qual (C,K), cost (K,),
    r (C,) host arrays, budget a float. Returns alpha (C,K) float64
    numpy; when no plan is feasible, every category gets the cheapest
    config."""
    from scipy.optimize import linprog
    qual = np.asarray(qual, np.float64)
    cost = np.asarray(cost, np.float64)
    r = np.asarray(r, np.float64)
    C, K = qual.shape
    c_obj = -(r[:, None] * qual).reshape(-1)             # maximize
    A_ub = (r[:, None] * cost[None, :]).reshape(1, -1)
    A_eq = np.zeros((C, C * K))
    for ci in range(C):
        A_eq[ci, ci * K:(ci + 1) * K] = 1.0
    res = linprog(c_obj, A_ub=A_ub, b_ub=[budget], A_eq=A_eq,
                  b_eq=np.ones(C), bounds=(0, 1), method="highs")
    if not res.success:
        # infeasible budget: everyone gets the cheapest config
        alpha = np.zeros((C, K))
        alpha[:, int(np.argmin(cost))] = 1.0
        return alpha
    return res.x.reshape(C, K)


def _fma(a, b, c):
    """float32 fused multiply-add: the product of two float32 values is
    exact in float64, so one float64 add and one rounding to float32
    give ``fma(a, b, c)`` (up to a double rounding that needs the exact
    sum to sit on a float32 midpoint)."""
    return (a.double() * b.double() + c.double()).float()


def _chain(r, v, acc):
    """``acc`` plus ``r[..., j] * v[..., j]`` for j in index order, one
    FMA each."""
    for j in range(r.shape[-1]):
        acc = _fma(r[..., j], v[..., j], acc)
    return acc


def _lanes(r, v, lanes: int, width: int):
    """``sum_j r * v`` over the last axis as ``lanes`` vector lanes: r
    and v zero-padded to ``width`` (a multiple of ``lanes``), one chain
    of FMAs per lane, then the lanes halved pairwise."""
    pad = width - r.shape[-1]
    if pad:
        r = torch.nn.functional.pad(r, (0, pad))
        v = torch.nn.functional.pad(v, (0, pad))
    acc = torch.zeros(r.shape[:-1] + (lanes,), dtype=torch.float32,
                      device=r.device)
    for j in range(0, width, lanes):
        acc = _fma(r[..., j:j + lanes], v[..., j:j + lanes], acc)
    while acc.shape[-1] > 1:
        h = acc.shape[-1] // 2
        acc = acc[..., :h] + acc[..., h:]
    return acc[..., 0]


def _windows(x):
    """XLA's tree reduction of a float32 sum over the last axis longer
    than 32: zero-pad to whole windows of 32 (the odd element of the
    padding goes to the end), add each window in index order, then add
    the window sums in order (again by windows, past 32 of them)."""
    n = x.shape[-1]
    nw = -(-n // 32)
    pad = nw * 32 - n
    x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
    x = x.reshape(x.shape[:-1] + (nw, 32))
    acc = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    for j in range(32):
        acc = acc + x[..., j]
    if nw > 32:
        return _windows(acc)
    out = torch.zeros(acc.shape[:-1], dtype=torch.float32, device=x.device)
    for j in range(nw):
        out = out + acc[..., j]
    return out


def _spend(r, v, hoisted: bool):
    """``sum_c r[c] * v[c]`` over the last axis in float32, in the order
    the reference's compiled CPU program (jax 0.9 / XLA CPU) takes for
    the spend of a plan of n = ``r.shape[-1]`` rows. A one-ulp change of
    a spend moves the budget blend, and through it the switcher's
    deficit argmax, so the order matters. Read off the optimised HLO,
    LLVM IR and object code of ``solve_lp_lagrangian``, its vmap and
    ``solve_lp_stacked`` for n <= 2,048, and held bit for bit against
    the reference up to n = 6,144 (the pool's joint replan at 2,048
    slots, where the window sums recurse):

    - n > 32: XLA's tree reduction rewrite. The products are rounded
      (their own fusion), then summed by windows of 32 (``_windows``).
    - a loop that XLA hoists into one call (``hoisted``): one FMA chain.
    - else one fused kernel that LLVM vectorises: n <= 2 one chain,
      n <= 4 one vector of 4 lanes, n <= 8 one of 8, n <= 16 8 lanes
      over two steps (the tail masked), and up to 32 lanes of 8 (or of 4
      when 4*floor(n/4) is not a multiple of 8) over the first
      4*floor(n/4) rows, then a scalar FMA chain over the rest."""
    n = r.shape[-1]
    if n > 32:
        return _windows(r * v)
    zero = torch.zeros(r.shape[:-1], dtype=torch.float32, device=r.device)
    if hoisted or n <= 2:
        return _chain(r, v, zero)
    if n <= 4:
        return _lanes(r, v, 4, 4)
    if n <= 8:
        return _lanes(r, v, 8, 8)
    if n <= 16:
        return _lanes(r, v, 8, 16)
    end = 4 * (n // 4)
    acc = _lanes(r[..., :end], v[..., :end], 8 if end % 8 == 0 else 4, end)
    return _chain(r[..., end:], v[..., end:], acc)


def _hoisted(C: int, K: int, V: int = 0) -> bool:
    """Whether XLA hoists the bisection loop into one call, whose body
    it compiles as a single function (the ``xla_cpu_small_call``
    attribute): a loop whose buffers are small. Read off the compiled
    programs: the plain solver at C rows hoists exactly when
    4*C*K + 5*C + 2*K <= 162 (C <= 16, K <= 40), the solver vmapped
    over V streams when 4*V*C*K + 5*V*C + 2*K + 8*V <= 170 (V <= 5,
    C <= 6, K <= 8; ``V=0`` means not vmapped)."""
    if V:
        return 4 * V * C * K + 5 * V * C + 2 * K + 8 * V <= 170
    return 4 * C * K + 5 * C + 2 * K <= 162


def _pick(qual, cost, r, lam, hoisted: bool, weights=None):
    """The plan that maximises qual - lam * cost per row, and its spend.
    qual (V, C, K), r (V, C), lam (V,). ``weights`` (V, C, 1), the
    stacked LP's priority weights outside its loop: there XLA fuses the
    weighting into the score and contracts it, so the score is
    fma(qual, w, -lam * cost), rounded once."""
    lc = lam[:, None, None] * cost
    if weights is None:
        score = qual - lc
    else:
        score = (qual.double() * weights.double() - lc.double()).float()
    idx = torch.argmax(score, dim=-1)
    a = torch.nn.functional.one_hot(idx, qual.shape[-1]).to(torch.float32)
    # each row of a*cost holds one non-zero, so its sum is exact
    return a, _spend(r, (a * cost).sum(-1), hoisted)


def _solve(qual, cost, r, budget, iters, *, inside: bool, outside: bool,
           weights=None):
    """The Lagrangian solver on a leading batch axis: qual (V, C, K)
    (V = 1 for one LP), r (V, C), budget (V,), ``weights`` None or
    (V, C, 1), multiplied into qual. ``inside``/``outside``:
    whether the spends in and outside the bisection loop take one FMA
    chain (``_spend``'s ``hoisted``). Every step is a tensor op over the
    whole batch."""
    V, C, K = qual.shape
    dev = qual.device
    if weights is not None:
        raw, qual = qual, qual * weights
    zero = torch.zeros((V,), dtype=torch.float32, device=dev)
    a0, s0 = _pick(qual, cost, r, zero, outside)          # unconstrained opt
    # λ large enough that argmax is (near-)min-cost: must beat the largest
    # quality gap across the SMALLEST positive cost gap.
    gaps = torch.diff(torch.sort(cost).values)
    gap_min = torch.where(gaps > 1e-9, gaps,
                          torch.full_like(gaps, float("inf"))).min()
    gap_min = torch.where(torch.isfinite(gap_min), gap_min,
                          torch.ones_like(gap_min))
    q_range = qual.amax((-2, -1)) - qual.amin((-2, -1))
    lam_hi = torch.clamp_max((q_range + 1.0) / torch.clamp_min(gap_min, 1e-6),
                             1e7)
    if weights is None:
        a_aff, s_aff = _pick(qual, cost, r, lam_hi, outside)
    else:                                                  # min-spend plan
        a_aff, s_aff = _pick(raw, cost, r, lam_hi, outside, weights)
    lo, hi, a_un, s_un = zero, lam_hi, a0, s0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        a, s = _pick(qual, cost, r, mid, inside)
        take = s <= budget
        lo, hi = torch.where(take, lo, mid), torch.where(take, mid, hi)
        t3 = take[:, None, None]
        a_aff, s_aff = torch.where(t3, a, a_aff), torch.where(take, s, s_aff)
        a_un, s_un = torch.where(t3, a_un, a), torch.where(take, s_un, s)
    # blend to exhaust the budget: θ·s_un + (1-θ)·s_aff = budget
    theta = torch.where(
        s_un > s_aff,
        torch.clamp((budget - s_aff) / torch.clamp_min(s_un - s_aff, 1e-9),
                    0.0, 1.0),
        zero)[:, None, None]
    a_mix = theta * a_un + (1 - theta) * a_aff
    return torch.where((s0 <= budget)[:, None, None], a0, a_mix)


def _prep(qual, cost, r, budget):
    qual = qual.to(torch.float32)
    cost = cost.to(torch.float32)
    r = r.to(torch.float32)
    budget = torch.as_tensor(budget, dtype=torch.float32, device=qual.device)
    return qual, cost, r, budget


def solve_lp_lagrangian(qual, cost, r, budget, iters: int = 64):
    """Exact solver. qual (C,K); cost (K,); r (C,); budget a float or
    0-d tensor. Returns alpha (C,K) float32.

    The affordable / unaffordable endpoint plans are CARRIED through the
    bisection (not recomputed afterwards), as the reference's docstring
    explains: argmax boundaries are rounding-sensitive, so a plan
    recomputed at the final λ could land on the other side of one."""
    qual, cost, r, budget = _prep(qual, cost, r, budget)
    C, K = qual.shape
    if K == 1:                       # single config: nothing to plan
        return torch.ones((C, 1), dtype=torch.float32, device=qual.device)
    return _solve(qual[None], cost, r[None], budget.reshape(1), iters,
                  inside=_hoisted(C, K), outside=False)[0]


def solve_lp_batched(qual, cost, r, budget, iters: int = 64):
    """V independent LPs in one chain of tensor ops, as the reference's
    ``jax.vmap(solve_lp_lagrangian)`` (the serving pool's replan): qual
    (C,K) shared by every stream, r (V,C), budget shared. Each stream's
    plan equals the vmapped program's bit for bit, whose spends XLA adds
    in another order than the plain solver's: past one stream it
    vectorises the spends outside the loop across the streams, so each
    is one FMA chain, and it hoists the loop by another bound
    (``_hoisted``). Returns (V,C,K)."""
    qual, cost, r, budget = _prep(qual, cost, r, budget)
    V = r.shape[0]
    C, K = qual.shape
    if K == 1:
        return torch.ones((V, C, 1), dtype=torch.float32, device=qual.device)
    return _solve(qual.expand(V, C, K), cost, r,
                  budget.expand(V), iters, inside=_hoisted(C, K, V),
                  outside=V > 1)


def solve_lp_stacked(qual, cost, r, budget, weights=None):
    """The joint multi-stream LP on static shapes: qual (V, C_max, K)
    sentinel-padded category tables, r (V, C_max) forecasts with zero
    rate on padding rows, one shared ``budget``. Flattening the stream
    axis into the category axis and solving once is exact (the
    reference's argument); zero-rate rows add nothing to spend or value.
    ``weights`` (V,) scales each stream's quality term, so under a
    shared budget the plan buys quality for high-priority streams first.
    Returns alpha (V, C_max, K)."""
    qual, cost, r, budget = _prep(qual, cost, r, budget)
    V, C, K = qual.shape
    if K == 1:
        return torch.ones((V, C, 1), dtype=torch.float32, device=qual.device)
    w = None
    if weights is not None:
        w = torch.as_tensor(weights, dtype=torch.float32,
                            device=qual.device).repeat_interleave(C)
    alpha = _solve(qual.reshape(1, V * C, K), cost, r.reshape(1, V * C),
                   budget.reshape(1), 64, inside=_hoisted(V * C, K),
                   outside=False,
                   weights=None if w is None else w.reshape(1, V * C, 1))
    return alpha.reshape(V, C, K)


def plan_value(alpha, qual, cost, r):
    """Returns (expected quality, expected spend) of a plan."""
    q = float(torch.sum(r[:, None] * alpha * qual))
    s = float(torch.sum(r[:, None] * alpha * cost[None, :]))
    return q, s


def solve_multi_stream(quals, cost, rs, budget):
    """Joint multi-stream knob plan (paper App. D, Eqs. 7-9): quals a
    list of per-stream (C_v, K) tables, rs their forecasts, cost (K,),
    budget the total core-s per segment across ALL streams. The stacked
    system is one LP of the same structure. Returns the list of
    per-stream alpha (C_v, K)."""
    dev = torch.as_tensor(quals[0]).device
    sizes = [q.shape[0] for q in quals]
    qual = torch.cat([torch.as_tensor(q, dtype=torch.float32, device=dev)
                      for q in quals])
    r = torch.cat([torch.as_tensor(x, dtype=torch.float32, device=dev)
                   for x in rs])
    alpha = solve_lp_lagrangian(qual, torch.as_tensor(cost, device=dev), r,
                                budget)
    return list(torch.split(alpha, sizes))


def solve_lp_rationed(qual, cost, r, *, core_s_per_segment, cloud_left,
                      frac, window_len, cloud_premium):
    """Window-rationed LP entry point (paper §4 online loop): the
    per-window budget is the on-prem capacity plus the REMAINING cloud
    budget rationed by the window's share of the rest of the run,
    discounted by the cloud premium. ``cloud_left`` may be a device
    tensor (the switcher's carried spend). Returns the (C, K) plan."""
    dev = qual.device

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    w_t = f32(window_len)
    budget = (f32(core_s_per_segment) * w_t
              + torch.clamp_min(f32(cloud_left), 0.0) * f32(frac)
              / f32(cloud_premium))
    return solve_lp_lagrangian(qual, cost, r, budget / w_t)
