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
"""
from __future__ import annotations

import torch


def _fma(a, b, c):
    """float32 fused multiply-add: the product of two float32 values is
    exact in float64, so one float64 add and one rounding to float32
    give ``fma(a, b, c)`` (up to a double rounding that needs the exact
    sum to sit on a float32 midpoint)."""
    return (a.double() * b.double() + c.double()).float()


def _lane_sum(r, v, lanes: int):
    """``sum_c r[c] * v[c]`` in float32 as ``lanes`` vector lanes: r and
    v zero-padded to a multiple of ``lanes``, one chain of FMAs per lane,
    then the lanes halved pairwise. ``lanes=1`` is one FMA chain."""
    C = r.shape[0]
    pad = -C % lanes
    if pad:
        r = torch.nn.functional.pad(r, (0, pad))
        v = torch.nn.functional.pad(v, (0, pad))
    acc = torch.zeros((lanes,), dtype=torch.float32, device=r.device)
    for j in range(0, C + pad, lanes):
        acc = _fma(r[j:j + lanes], v[j:j + lanes], acc)
    while acc.shape[0] > 1:
        h = acc.shape[0] // 2
        acc = acc[:h] + acc[h:]
    return acc[0]


def _outside_lanes(C: int) -> int:
    """The lanes of the spend of a plan picked outside the bisection
    loop, in the order the reference's compiled CPU program takes for
    this multiply-reduce standing alone: 8 when C is a multiple of 8, 4
    when C == 4, else one chain. A one-ulp change of a spend moves the
    budget blend below, and through it the switcher's deficit argmax, so
    the order matters."""
    return 8 if C % 8 == 0 else 4 if C == 4 else 1


def _loop_lanes(C: int, K: int) -> int:
    """The lanes of the spend inside the bisection loop, as the
    reference's compiled CPU program takes it (jax 0.9 / XLA CPU).

    XLA hoists a while loop whose buffers are small into one call and
    compiles its body as a single function (the ``xla_cpu_small_call``
    attribute, ``xla_cpu_small_while_loop_byte_threshold``). There the
    spend is one FMA chain. A larger loop runs each fusion as its own
    kernel, whose spend takes 4 vector lanes for C <= 4 and 8 (zero
    padded) above. Which loops XLA hoists was read off the compiled
    programs for C <= 16, K <= 40: exactly those with
    4*C*K + 5*C + 2*K <= 162."""
    if 4 * C * K + 5 * C + 2 * K <= 162:
        return 1
    return 4 if C <= 4 else 8


def _pick(qual, cost, r, lam, lanes: int):
    score = qual - lam * cost[None, :]
    idx = torch.argmax(score, dim=1)
    a = torch.nn.functional.one_hot(idx, qual.shape[1]).to(torch.float32)
    # each row of a*cost holds one non-zero, so its sum is exact
    return a, _lane_sum(r, (a * cost[None, :]).sum(1), lanes)


def solve_lp_lagrangian(qual, cost, r, budget, iters: int = 64):
    """Exact solver. qual (C,K); cost (K,); r (C,); budget a float or
    0-d tensor. Returns alpha (C,K) float32.

    The affordable / unaffordable endpoint plans are CARRIED through the
    bisection (not recomputed afterwards), as the reference's docstring
    explains: argmax boundaries are rounding-sensitive, so a plan
    recomputed at the final λ could land on the other side of one."""
    qual = qual.to(torch.float32)
    cost = cost.to(torch.float32)
    r = r.to(torch.float32)
    budget = torch.as_tensor(budget, dtype=torch.float32, device=qual.device)
    C, K = qual.shape
    if K == 1:                       # single config: nothing to plan
        return torch.ones((C, 1), dtype=torch.float32, device=qual.device)

    zero = torch.zeros((), dtype=torch.float32, device=qual.device)
    outside = _outside_lanes(C)
    a0, s0 = _pick(qual, cost, r, zero, outside)          # unconstrained opt
    # λ large enough that argmax is (near-)min-cost: must beat the largest
    # quality gap across the SMALLEST positive cost gap.
    gaps = torch.diff(torch.sort(cost).values)
    gap_min = torch.where(gaps > 1e-9, gaps,
                          torch.full_like(gaps, float("inf"))).min()
    gap_min = torch.where(torch.isfinite(gap_min), gap_min,
                          torch.ones_like(gap_min))
    q_range = qual.max() - qual.min()
    lam_hi = torch.clamp_max((q_range + 1.0) / torch.clamp_min(gap_min, 1e-6),
                             1e7)
    a_aff, s_aff = _pick(qual, cost, r, lam_hi, outside)  # min-spend plan
    lo, hi, a_un, s_un = zero, lam_hi, a0, s0
    inside = _loop_lanes(C, K)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        a, s = _pick(qual, cost, r, mid, inside)
        take = s <= budget
        lo, hi = torch.where(take, lo, mid), torch.where(take, mid, hi)
        a_aff, s_aff = torch.where(take, a, a_aff), torch.where(take, s, s_aff)
        a_un, s_un = torch.where(take, a_un, a), torch.where(take, s_un, s)
    # blend to exhaust the budget: θ·s_un + (1-θ)·s_aff = budget
    theta = torch.where(
        s_un > s_aff,
        torch.clamp((budget - s_aff) / torch.clamp_min(s_un - s_aff, 1e-9),
                    0.0, 1.0),
        zero)
    a_mix = theta * a_un + (1 - theta) * a_aff
    return torch.where(s0 <= budget, a0, a_mix)


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
