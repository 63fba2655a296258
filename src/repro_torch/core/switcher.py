"""Knob switcher (paper §4.2): the reactive per-segment decision.

Port of ``repro/core/switcher.py``. Per segment:
 1. classify current content from the running config's reported quality
    (Eq. 5 — one KMeans dimension);
 2. pick the config with the largest planned-minus-actual usage deficit
    (Eq. 6);
 3. pick the cheapest placement that cannot overflow the buffer,
    degrading to less-qualitative configs if necessary (a masked argmin),
    and drop the segment when nothing fits at all.

The reference's ``lax.scan`` over a window becomes a Python loop of
tensor ops (``window_scan``; ``run_window`` and ``pad_window`` are the
reference's entry and padding around it). Every index into a table goes through
``index_select`` on a one-element tensor, never through ``tensor[t]``
with a 0-d tensor, which would read the index back to the host: one
window runs on the card without a single synchronisation. The decision
uses only elementwise IEEE operations, comparisons and first-index
argmin/argmax (as ``jnp.argmin``/``jnp.argmax``), so it is bit-exact
with the reference and does not depend on the device.

Many streams (paper App. D): ``stack_tables`` stacks V streams' tables
field by field onto a leading (V,) axis and ``init_state_multi`` their
states. ``_switch_multi`` is the reference's ``jax.vmap(_switch)`` as
one chain of tensor ops over that axis: each stream's row, column or
entry of a table is read with ``take_along_dim`` at its own index
tensor, and the usage counts are added at ``(arange(V), c, k)`` with
``index_put`` (adds of +1.0 to float32 counts, so exact). It is
bit-exact with the reference's batched decision, on any device.
``window_scan_multi`` runs V streams through one planning window, one
batched step per segment.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

BIG = 10 ** 6


@dataclass
class SwitchTables:
    """Lookup tables the switcher steps against, all tensors on one
    device (the reference's python-float scalars are 0-d float32
    tensors here, rounded to float32 as ``jnp.asarray`` rounds them)."""
    centers: torch.Tensor      # (C, K) mean quality of config k on category c
    power: torch.Tensor        # (K,)
    cost: torch.Tensor         # (K,) all-on-prem core-s / segment
    place_rt: torch.Tensor     # (K, P) wall seconds / segment
    place_on: torch.Tensor     # (K, P) on-prem core-s
    place_cl: torch.Tensor     # (K, P) cloud core-s
    place_valid: torch.Tensor  # (K, P) bool
    rank_pos: torch.Tensor     # (K,) int64, 0 = most qualitative
    tau: torch.Tensor          # () segment seconds
    buffer_cap_s: torch.Tensor  # () buffer size in seconds of video
    cloud_budget: torch.Tensor  # () total cloud core-s for the run

    @property
    def n_categories(self):
        return self.centers.shape[0]

    @property
    def n_configs(self):
        return self.centers.shape[1]


def init_state(tables: SwitchTables) -> Dict[str, torch.Tensor]:
    """Fresh switcher state (usage stats, buffer, cloud spend, current
    config = most qualitative) on the tables' device."""
    C, K = tables.centers.shape
    dev = tables.centers.device

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    return {
        "used": torch.zeros((C, K), dtype=torch.float32, device=dev),
        "count": torch.zeros((C,), dtype=torch.float32, device=dev),
        "buffer_s": f32(0.0),
        "cloud_spent": f32(0.0),
        "k_cur": torch.argmin(tables.rank_pos),
        "qual_prev": f32(1.0),
    }


def _at(x: torch.Tensor, i: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``x`` indexed at the 0-d index tensor ``i`` along ``dim``, on the
    device (no host read of ``i``)."""
    return torch.index_select(x, dim, i.reshape(1)).squeeze(dim)


def _switch(state, qual_row, arrival, alpha, tables: SwitchTables):
    """One knob-switching decision; returns (new state, outputs) as new
    tensors (``state`` is not modified)."""
    tau, cap = tables.tau, tables.buffer_cap_s
    # 1. classify from previous segment's reported quality (Eq. 5)
    col = _at(tables.centers, state["k_cur"], dim=1)
    c = torch.argmin(torch.abs(col - state["qual_prev"]))
    # 2. usage-deficit pick (Eq. 6)
    frac = _at(state["used"], c) / torch.clamp_min(_at(state["count"], c),
                                                   1.0)
    k_next = torch.argmax(_at(alpha, c) - frac)
    # 3. placement feasibility
    rt_eff = tables.place_rt * arrival
    cl_eff = tables.place_cl * arrival
    headroom = tau + (cap - state["buffer_s"])
    feas = (tables.place_valid
            & (rt_eff <= headroom)
            & (state["cloud_spent"] + cl_eff <= tables.cloud_budget))
    feas_k = feas.any(1)
    cl_masked = torch.where(feas, tables.place_cl, float("inf"))
    p_best = torch.argmin(cl_masked, dim=1)                      # (K,)
    eligible = tables.rank_pos >= _at(tables.rank_pos, k_next)
    cand = feas_k & eligible
    pos1 = torch.where(cand, tables.rank_pos, BIG)
    pos2 = torch.where(feas_k, tables.rank_pos, BIG)
    k_sel = torch.where(cand.any(), torch.argmin(pos1), torch.argmin(pos2))
    p_sel = _at(p_best, k_sel)
    # overload shedding: if NO config/placement fits, drop the segment
    any_feas = feas_k.any()
    flat = k_sel * tables.place_rt.shape[1] + p_sel
    rt = torch.where(any_feas, _at(rt_eff.reshape(-1), flat), 0.0)
    on_s = torch.where(any_feas,
                       _at(tables.place_on.reshape(-1), flat) * arrival, 0.0)
    cl_s = torch.where(any_feas, _at(cl_eff.reshape(-1), flat), 0.0)
    qual = torch.where(any_feas, _at(qual_row, k_sel), 0.0)
    one = torch.ones((), dtype=torch.float32, device=qual.device)
    new_state = {
        "used": state["used"].index_put((c, k_sel), one, accumulate=True),
        "count": state["count"].index_put((c,), one, accumulate=True),
        "buffer_s": torch.clamp_min(state["buffer_s"] + rt - tau, 0.0),
        "cloud_spent": state["cloud_spent"] + cl_s,
        "k_cur": k_sel,
        "qual_prev": qual,
    }
    out = {"k": k_sel, "p": p_sel, "c": c, "qual": qual, "on_s": on_s,
           "cl_s": cl_s, "buffer_s": new_state["buffer_s"], "rt": rt,
           "dropped": ~any_feas}
    return new_state, out


def _masked_switch(state, qual_row, arrival, valid, alpha,
                   tables: SwitchTables):
    """``_switch``, but a ``valid=False`` step is an exact no-op: state is
    untouched and every output is zeroed (padding segments contribute
    nothing to quality, work, or buffer)."""
    new_state, out = _switch(state, qual_row, arrival, alpha, tables)
    new_state = {k: torch.where(valid, new_state[k], state[k])
                 for k in new_state}
    zero = {"k": 0, "p": 0, "c": 0, "qual": 0.0, "on_s": 0.0, "cl_s": 0.0,
            "buffer_s": state["buffer_s"], "rt": 0.0, "dropped": False}
    out = {k: torch.where(valid, o, zero[k]) for k, o in out.items()}
    return new_state, out


def window_scan(state, quals, arrivals, valid, alpha, tables: SwitchTables,
                step=None):
    """The masked switch over one planning window, as a loop: quals
    (W,K), arrivals (W,), valid (W,) bool. Returns (final state, outs)
    with (W,) output leaves — the reference's ``lax.scan`` ys. ``step``
    (default ``_masked_switch``) is the loop's body, with the same
    arguments and the carry first: ``obs.telemetry.masked_switch_tel``
    carries (state, counters)."""
    step = step or _masked_switch
    outs = {k: [] for k in ("k", "p", "c", "qual", "on_s", "cl_s",
                            "buffer_s", "rt", "dropped")}
    for i in range(quals.shape[0]):
        state, out = step(state, quals[i], arrivals[i], valid[i], alpha,
                          tables)
        for k, v in out.items():
            outs[k].append(v)
    return state, {k: torch.stack(v) for k, v in outs.items()}


def run_window(state, quals, arrivals, alpha, tables: SwitchTables,
               valid: Optional[torch.Tensor] = None):
    """``window_scan`` over one planning window (the reference's jitted
    ``run_window``): quals (T,K), arrivals (T,), every step valid unless
    ``valid`` (T,) bool marks padding (exact no-ops)."""
    if valid is None:
        valid = torch.ones(quals.shape[:1], dtype=torch.bool,
                           device=quals.device)
    return window_scan(state, quals, arrivals, valid, alpha, tables)


def pad_window(quals, arrivals, W: int):
    """Pad a (T,K)/(T,) window to length W, returning (quals, arrivals,
    valid (W,)): quals padded with 0, arrivals with 1.0, as the
    reference pads them."""
    T = quals.shape[0]
    valid = torch.arange(W, device=quals.device) < T
    if T == W:
        return quals, arrivals, valid
    quals = torch.nn.functional.pad(quals, (0, 0, 0, W - T))
    arrivals = torch.nn.functional.pad(arrivals, (0, W - T), value=1.0)
    return quals, arrivals, valid


def switch_step(state, qual_row, arrival, alpha, tables: SwitchTables):
    """One knob-switching decision (``_switch`` on one step): qual_row
    (K,) holds the measured qualities of this segment (only
    ``qual_row[k_sel]`` is observed by the system)."""
    return _switch(state, qual_row, arrival, alpha, tables)


# ---------------------------------------------------------------------------
# many streams: a leading (V,) axis on tables, state, alpha and outputs
# ---------------------------------------------------------------------------

def stack_tables(tables: List[SwitchTables]) -> SwitchTables:
    """Stack V streams' tables field by field onto a leading (V,) axis
    (the scalar fields become (V,) float32 tensors, so streams may have
    their own budgets)."""
    return SwitchTables(**{
        f: torch.stack([getattr(t, f) for t in tables])
        for f in SwitchTables.__dataclass_fields__})


def init_state_multi(tables: List[SwitchTables]) -> Dict[str, torch.Tensor]:
    """Batched state for V streams: each leaf gains a leading (V,) axis."""
    states = [init_state(t) for t in tables]
    return {k: torch.stack([st[k] for st in states]) for k in states[0]}


def _row(x: torch.Tensor, i: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """``x[v, ..., i[v], ...]`` for every stream v: ``x`` indexed along
    ``dim`` at each stream's own index (i is (V,)), on the device."""
    shape = [x.shape[0]] + [1] * (x.dim() - 1)
    idx = i.reshape(shape).expand(
        *[x.shape[d] if d != dim else 1 for d in range(x.dim())])
    return torch.take_along_dim(x, idx, dim=dim).squeeze(dim)


def _switch_multi(state, qual_rows, arrivals, alpha, tables: SwitchTables):
    """One decision for V streams at once (the reference's
    ``jax.vmap(_switch)``): state leaves (V, ...), qual_rows (V, K),
    arrivals (V,), alpha (V, C, K), tables stacked. Returns (new state,
    outputs with (V,) leaves); ``state`` is not modified."""
    V = qual_rows.shape[0]
    tau, cap = tables.tau, tables.buffer_cap_s
    ar = arrivals[:, None, None]
    # 1. classify from previous segment's reported quality (Eq. 5)
    col = _row(tables.centers, state["k_cur"], dim=2)             # (V, C)
    c = torch.argmin(torch.abs(col - state["qual_prev"][:, None]), dim=1)
    # 2. usage-deficit pick (Eq. 6)
    frac = _row(state["used"], c) / torch.clamp_min(
        _row(state["count"], c), 1.0)[:, None]
    k_next = torch.argmax(_row(alpha, c) - frac, dim=1)
    # 3. placement feasibility
    rt_eff = tables.place_rt * ar
    cl_eff = tables.place_cl * ar
    headroom = tau + (cap - state["buffer_s"])
    feas = (tables.place_valid
            & (rt_eff <= headroom[:, None, None])
            & (state["cloud_spent"][:, None, None] + cl_eff
               <= tables.cloud_budget[:, None, None]))
    feas_k = feas.any(2)                                          # (V, K)
    cl_masked = torch.where(feas, tables.place_cl, float("inf"))
    p_best = torch.argmin(cl_masked, dim=2)                       # (V, K)
    eligible = tables.rank_pos >= _row(tables.rank_pos, k_next)[:, None]
    cand = feas_k & eligible
    pos1 = torch.where(cand, tables.rank_pos, BIG)
    pos2 = torch.where(feas_k, tables.rank_pos, BIG)
    k_sel = torch.where(cand.any(1), torch.argmin(pos1, dim=1),
                        torch.argmin(pos2, dim=1))
    p_sel = _row(p_best, k_sel)
    # overload shedding: if NO config/placement fits, drop the segment
    any_feas = feas_k.any(1)
    flat = k_sel * tables.place_rt.shape[2] + p_sel

    def at_flat(x):
        return _row(x.reshape(V, -1), flat)

    rt = torch.where(any_feas, at_flat(rt_eff), 0.0)
    on_s = torch.where(any_feas, at_flat(tables.place_on) * arrivals, 0.0)
    cl_s = torch.where(any_feas, at_flat(cl_eff), 0.0)
    qual = torch.where(any_feas, _row(qual_rows, k_sel), 0.0)
    v = torch.arange(V, device=qual_rows.device)
    one = torch.ones((V,), dtype=torch.float32, device=qual_rows.device)
    new_state = {
        "used": state["used"].index_put((v, c, k_sel), one, accumulate=True),
        "count": state["count"].index_put((v, c), one, accumulate=True),
        "buffer_s": torch.clamp_min(state["buffer_s"] + rt - tau, 0.0),
        "cloud_spent": state["cloud_spent"] + cl_s,
        "k_cur": k_sel,
        "qual_prev": qual,
    }
    out = {"k": k_sel, "p": p_sel, "c": c, "qual": qual, "on_s": on_s,
           "cl_s": cl_s, "buffer_s": new_state["buffer_s"], "rt": rt,
           "dropped": ~any_feas}
    return new_state, out


def _bcast(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (V,) mask shaped to broadcast against a (V, ...) leaf."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - 1))


def _masked_switch_multi(state, qual_rows, arrivals, valid, alpha,
                         tables: SwitchTables):
    """``_switch_multi`` where each stream whose ``valid`` (V,) is False
    takes an exact no-op step: its state is untouched and its outputs
    are zeroed (the reference's ``jax.vmap(_masked_switch)``)."""
    new_state, out = _switch_multi(state, qual_rows, arrivals, alpha,
                                   tables)
    new_state = {k: torch.where(_bcast(valid, v), v, state[k])
                 for k, v in new_state.items()}
    zero = {"k": 0, "p": 0, "c": 0, "qual": 0.0, "on_s": 0.0, "cl_s": 0.0,
            "buffer_s": state["buffer_s"], "rt": 0.0, "dropped": False}
    out = {k: torch.where(valid, o, zero[k]) for k, o in out.items()}
    return new_state, out


def switch_step_multi(state, qual_rows, arrivals, alpha,
                      tables: SwitchTables):
    """One batched decision for V live streams: state from
    ``init_state_multi``, qual_rows (V,K), arrivals (V,), alpha (V,C,K),
    tables from ``stack_tables``."""
    return _switch_multi(state, qual_rows, arrivals, alpha, tables)


def pad_window_multi(quals, arrivals, W: int):
    """Pad a (V,T,K)/(V,T) window to length W along time, returning
    (quals, arrivals, valid (V,W))."""
    V, T = arrivals.shape
    valid = (torch.arange(W, device=arrivals.device) < T).expand(V, W)
    if T == W:
        return quals, arrivals, valid
    quals = torch.nn.functional.pad(quals, (0, 0, 0, W - T))
    arrivals = torch.nn.functional.pad(arrivals, (0, W - T), value=1.0)
    return quals, arrivals, valid


def window_scan_multi(state, quals, arrivals, valid, alpha,
                      tables: SwitchTables, step=None):
    """V streams through one planning window, one batched step per
    segment: quals (V,W,K), arrivals (V,W), valid (V,W) bool. Returns
    (final state, outs with (V,W) leaves). ``step`` (default
    ``_masked_switch_multi``) is the loop's body, with the carry first:
    ``obs.telemetry.masked_switch_multi_tel`` carries (state, counters)."""
    step = step or _masked_switch_multi
    outs = []
    for t in range(arrivals.shape[1]):
        state, out = step(state, quals[:, t], arrivals[:, t], valid[:, t],
                          alpha, tables)
        outs.append(out)
    return state, {k: torch.stack([o[k] for o in outs], 1) for k in outs[0]}


def run_window_multi(state, quals, arrivals, alpha, tables: SwitchTables,
                     valid: Optional[torch.Tensor] = None):
    """``window_scan_multi`` with every step valid unless ``valid``
    (V,T) marks padding."""
    if valid is None:
        valid = torch.ones(arrivals.shape, dtype=torch.bool,
                           device=arrivals.device)
    return window_scan_multi(state, quals, arrivals, valid, alpha, tables)
