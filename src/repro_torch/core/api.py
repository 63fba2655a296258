"""User-facing Skyscraper API (paper App. F): the port of
``repro/core/api.py``'s ``Skyscraper`` and its serving pool
``SkyscraperPool``.

    sky = Skyscraper(fps=30, segment_seconds=2.0)
    sky.set_resources(num_cores=8, buffer_gb=4.0, cloud_budget_core_s=0)
    sky.register_knob("det_interval", [1, 5, 10])
    sky.fit(unlabeled_segments, proc_fn)
    status, out = sky.process(segment)        # online, content-adaptive

``proc_fn(segment, knobs) -> (output, quality)`` is the user's transform
(the V-ETL *T*). ``fit()`` profiles every knob configuration's
wall-clock runtime, Pareto-filters configurations, builds content
categories from measured quality vectors and trains the forecaster.
``process()`` is the online loop: classify -> look up plan -> switch ->
execute. The switcher's tables and state live on the handle's device.

``SkyscraperPool`` serves many live streams on one fitted handle: one
batched decision per tick for every slot (``switcher._masked_switch_
multi``), priority shedding under a capacity, batched replans, a
warehouse sink and a host-side flight recorder.
"""
from __future__ import annotations

import itertools
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.categories import kmeans
from repro_torch.core.forecaster import (forecast_from_labels,
                                         init_forecaster, make_dataset,
                                         train_forecaster)
from repro_torch.core.planner import (solve_lp_batched, solve_lp_lagrangian,
                                      solve_lp_stacked)
from repro_torch.core.switcher import (SwitchTables, _masked_switch_multi,
                                       init_state, init_state_multi,
                                       stack_tables, switch_step)
from repro_torch.device import resolve


class Skyscraper:
    """User-facing ETL handle: declare a workload (fps, knobs, cores,
    buffer, cloud budget), ``fit()`` offline tables, then ``process()``
    segments online. ``device=None`` means CUDA."""

    def __init__(self, fps: int = 30, segment_seconds: float = 2.0,
                 n_categories: int = 4, seed: int = 0, device=None):
        self.device = resolve(device)
        self.fps = fps
        self.tau = segment_seconds
        self.n_categories = n_categories
        self.seed = seed
        self.knobs: Dict[str, Sequence] = {}
        self.num_cores = 1
        self.buffer_gb = 4.0
        self.cloud_budget = 0.0
        self.budget_override = None
        self._fitted = False

    def set_resources(self, *, num_cores: int, buffer_gb: float = 4.0,
                      cloud_budget_core_s: float = 0.0):
        self.num_cores = num_cores
        self.buffer_gb = buffer_gb
        self.cloud_budget = cloud_budget_core_s
        self.budget_override = None

    def set_budget(self, core_s_per_segment: float):
        """Override the per-segment compute budget used by the planner
        (defaults to num_cores * segment_seconds)."""
        self.budget_override = core_s_per_segment
        if self._fitted:
            self._replan()

    def register_knob(self, name: str, domain: Sequence):
        self.knobs[name] = tuple(domain)

    def _f32(self, x) -> torch.Tensor:
        return torch.as_tensor(np.array(x, np.float32), device=self.device)

    # ------------------------------------------------------------------
    def fit(self, unlabeled: Sequence, proc_fn: Callable, *,
            profile_repeats: int = 1, plan_segments: int = 512,
            n_split: int = 4, max_k: int = 10):
        """unlabeled: list of segments (opaque to Skyscraper)."""
        configs = [dict(zip(self.knobs, v))
                   for v in itertools.product(*self.knobs.values())]
        # --- profile runtimes + quality vectors on the unlabeled data ---
        sample = unlabeled[:: max(1, len(unlabeled) // 40)]
        runtimes = np.zeros(len(configs))
        quals = np.zeros((len(unlabeled), len(configs)), np.float32)
        for ki, kv in enumerate(configs):
            t0 = time.perf_counter()
            for _ in range(profile_repeats):
                for seg in sample:
                    proc_fn(seg, kv)
            runtimes[ki] = ((time.perf_counter() - t0)
                            / (profile_repeats * len(sample)))
            for si, seg in enumerate(unlabeled):
                _, q = proc_fn(seg, kv)
                quals[si, ki] = q
        # --- Pareto-filter configurations -------------------------------
        mq = quals.mean(axis=0)
        keep = []
        best_q = -1.0
        for i in np.argsort(runtimes):
            if mq[i] > best_q + 1e-6:
                keep.append(i)
                best_q = mq[i]
        keep = keep[:max_k]
        quals = quals[:, keep]
        # --- categories + forecaster ------------------------------------
        centers, labels = kmeans(quals, min(self.n_categories,
                                            len(unlabeled)),
                                 seed=self.seed, device=self.device)
        C = centers.shape[0]
        labels = labels.cpu().numpy()
        interval = max(1, len(labels) // (4 * n_split))
        horizon = max(1, min(plan_segments, len(labels) // 4))
        X, Y = make_dataset(labels, C, interval=interval, n_split=n_split,
                            horizon=horizon)
        params = init_forecaster(torch.Generator().manual_seed(self.seed),
                                 n_split, C, device=self.device)
        forecaster, metrics = train_forecaster(params, X, Y)
        self._install(configs=[configs[i] for i in keep],
                      cost=runtimes[keep] * self.num_cores, power=mq[keep],
                      centers=centers.cpu().numpy(), forecaster=forecaster,
                      n_split=n_split, interval=interval, proc_fn=proc_fn,
                      plan_segments=plan_segments)
        self.forecast_metrics = metrics
        return self

    def _install(self, *, configs: List[Dict], cost, power, centers,
                 forecaster, n_split: int, interval: int, proc_fn: Callable,
                 plan_segments: int):
        """Take a fitted state (the end of ``fit``): build the switcher
        tables (one all-on-prem placement per config) and the first
        plan. ``convert.fitted_skyscraper`` calls it with a reference
        fit's state."""
        self.configs = [dict(c) for c in configs]
        self.cost = np.asarray(cost, np.float64)        # core-s per segment
        self.centers = np.asarray(centers, np.float32)
        self.forecaster = forecaster
        self.n_split, self.interval = n_split, interval
        power = np.asarray(power, np.float32)
        K = len(self.configs)
        self.tables = SwitchTables(
            centers=self._f32(self.centers),
            power=self._f32(power),
            cost=self._f32(self.cost),
            place_rt=self._f32((self.cost / self.num_cores)[:, None]),
            place_on=self._f32(self.cost[:, None]),
            place_cl=self._f32(np.zeros((K, 1))),
            place_valid=torch.ones((K, 1), dtype=torch.bool,
                                   device=self.device),
            rank_pos=torch.as_tensor(np.argsort(np.argsort(-power)),
                                     device=self.device),
            tau=self._f32(self.tau),
            buffer_cap_s=self._f32(self.buffer_gb * 1e9 / 90e3),
            cloud_budget=self._f32(self.cloud_budget),
        )
        self.state = init_state(self.tables)
        self.proc_fn = proc_fn
        self._labels_hist: List[int] = []
        self._plan_every = plan_segments
        self._seen = 0
        self._replan()
        self._fitted = True

    def _replan(self):
        C = self.centers.shape[0]
        need = self.n_split * self.interval
        if len(self._labels_hist) >= need:
            lab = torch.as_tensor(self._labels_hist[-need:],
                                  dtype=torch.int32, device=self.device)
            r = forecast_from_labels(self.forecaster, lab, C,
                                     n_split=self.n_split,
                                     interval=self.interval)
        else:
            r = self._f32(np.full(C, 1.0 / C))
        budget = (self.budget_override if self.budget_override
                  else self.num_cores * self.tau)
        self.alpha = solve_lp_lagrangian(self.tables.centers,
                                         self.tables.cost, r,
                                         self._f32(budget))

    # ------------------------------------------------------------------
    def process(self, segment, arrival_mult: float = 1.0):
        """Run the V-ETL Transform on one segment with adaptive knobs."""
        if not self._fitted:
            raise RuntimeError("call fit() first")
        K = len(self.configs)
        self.state, out = switch_step(
            self.state, torch.zeros((K,), device=self.device),
            self._f32(arrival_mult), self.alpha, self.tables)
        k = int(out["k"])
        result, q = self.proc_fn(segment, self.configs[k])
        # report the measured quality back (drives the next classification)
        self.state["qual_prev"] = self._f32(q)
        self._labels_hist.append(int(out["c"]))
        self._seen += 1
        if self._seen % self._plan_every == 0:
            self._replan()
        return {"config": self.configs[k], "k": k, "category": int(out["c"]),
                "quality": float(q),
                "buffer_s": float(out["buffer_s"])}, result


# ---------------------------------------------------------------------------
# the serving pool: V slots, one batched decision per tick
# ---------------------------------------------------------------------------

def _pool_replan(params, bufs, centers, cost, budget, use_model: bool, *,
                 n_split: int, interval: int):
    """Every slot's plan in one chain of tensor ops: each stream's
    rolling label buffer -> its forecast (batched, in float64) -> V
    independent LPs (``solve_lp_batched``, the reference's vmapped
    solver). ``use_model`` False takes the uniform prior (the buffers
    have not filled once yet)."""
    r = _pool_rates(params, bufs, centers.shape[0], use_model,
                    n_split=n_split, interval=interval)
    return solve_lp_batched(centers, cost, r, budget)


def _pool_rates(params, bufs, C: int, use_model: bool, *, n_split: int,
                interval: int):
    """(V, C) category rates of every slot: its label buffer's forecast
    (batched, in float64), or the uniform prior while ``use_model`` is
    False."""
    if use_model:
        return forecast_from_labels(params, bufs, C, n_split=n_split,
                                    interval=interval)
    return torch.full((bufs.shape[0], C), 1.0 / C, dtype=torch.float32,
                      device=bufs.device)


def _pool_shift(bufs, c):
    """The rolling label buffers shifted by one tick: the oldest label
    out, this tick's category in."""
    return torch.cat([bufs[:, 1:], c[:, None].to(bufs.dtype)], 1)


def _pool_replan_stacked(params, bufs, centers, cost, budget,
                         use_model: bool, active, priority, *, n_split: int,
                         interval: int):
    """The joint priority-weighted replan: every ACTIVE stream's forecast
    feeds one stacked LP under the shared pool budget, each stream's
    quality scaled by its priority (``solve_lp_stacked``'s weights), so
    under overload the low-priority streams degrade first. Inactive
    slots get zero rate and add nothing to the joint spend."""
    r = _pool_rates(params, bufs, centers.shape[0], use_model,
                    n_split=n_split, interval=interval)
    r = r * active.to(torch.float32)[:, None]
    qual = centers.expand((bufs.shape[0],) + centers.shape)
    return solve_lp_stacked(qual, cost, r, budget, weights=priority)


def _prefix_sum(x):
    """Inclusive prefix sum of a float32 vector in one fixed order of
    elementwise adds, so it is the same on every device: XLA's CPU
    order for ``jnp.cumsum`` (its reduce-window rewrite). Up to 16
    values: one add per value in index order. Longer: blocks of 16,
    zero-padded at the end; each block's prefix in order; the exclusive
    prefix of the block totals (the same recursion) added to every value
    of the next block."""
    n = x.shape[-1]
    if n <= 16:
        outs = [x[..., 0]]
        for j in range(1, n):
            outs.append(outs[-1] + x[..., j])
        return torch.stack(outs, -1)
    nb = -(-n // 16)
    xp = torch.nn.functional.pad(x, (0, nb * 16 - n))
    within = _prefix_sum(xp.reshape(x.shape[:-1] + (nb, 16)))
    incl = _prefix_sum(within[..., 15])
    excl = torch.cat([torch.zeros_like(incl[..., :1]), incl[..., :-1]], -1)
    return (within + excl[..., None]).reshape(
        x.shape[:-1] + (nb * 16,))[..., :n]


def _pool_tick_fn(state, q_meas, q_valid, quals, arr, active, priority,
                  alpha, tables, capacity_core_s, watermark_frac):
    """One pool tick: fold last tick's measured qualities into the
    classification state, run the masked batched switch (inactive slots
    are exact no-ops), then shed by priority. Returns (new state, outs
    with (V,) leaves and a ``shed`` mask); ``state`` is not modified.

    Shedding, the paper's last degradation rung: when the tick's planned
    on-prem demand exceeds ``capacity_core_s``, streams are kept in
    priority order (a stable argsort: equal priorities by slot) while
    the prefix sum of their demand fits (``_prefix_sum``); and a stream
    whose pre-tick buffer reached ``watermark_frac`` of its capacity is
    shed too. A shed segment takes the switch's drop semantics: no work,
    no quality, the buffer drains by tau. Both thresholds +inf make the
    stage the identity."""
    state = dict(state, qual_prev=torch.where(q_valid, q_meas,
                                              state["qual_prev"]))
    pre_buf = state["buffer_s"]
    new_state, outs = _masked_switch_multi(state, quals, arr, active, alpha,
                                           tables)
    demand = outs["on_s"]
    inf = torch.full_like(priority, float("inf"))
    order = torch.argsort(torch.where(active, -priority, inf), stable=True)
    fits = _prefix_sum(demand[order]) <= capacity_core_s
    keep = torch.zeros_like(active).scatter(0, order, fits)
    hwm_s = watermark_frac * tables.buffer_cap_s
    shed = active & ~outs["dropped"] & (~keep | (pre_buf >= hwm_s))
    shed_buf = torch.clamp_min(pre_buf - tables.tau, 0.0)
    new_state = dict(
        new_state,
        buffer_s=torch.where(shed, shed_buf, new_state["buffer_s"]),
        cloud_spent=torch.where(shed,
                                new_state["cloud_spent"] - outs["cl_s"],
                                new_state["cloud_spent"]),
        qual_prev=torch.where(shed, 0.0, new_state["qual_prev"]))
    outs = dict(outs,
                qual=torch.where(shed, 0.0, outs["qual"]),
                on_s=torch.where(shed, 0.0, outs["on_s"]),
                cl_s=torch.where(shed, 0.0, outs["cl_s"]),
                rt=torch.where(shed, 0.0, outs["rt"]),
                buffer_s=torch.where(shed, shed_buf, outs["buffer_s"]),
                dropped=outs["dropped"] | shed,
                shed=shed)
    return new_state, outs


def _pool_admit_fn(tables, state, bufs, alpha, active, priority, slot: int,
                   prio: float, row_tables, alpha_row) -> None:
    """Fill one slot with a freshly admitted stream, in place: its table
    row (its own or the pool's), a fresh switcher state, an empty label
    buffer, the current single-stream plan, its priority, active."""
    for f in SwitchTables.__dataclass_fields__:
        getattr(tables, f)[slot] = getattr(row_tables, f)
    for k, v in init_state(row_tables).items():
        state[k][slot] = v
    bufs[slot] = 0
    alpha[slot] = alpha_row
    active[slot] = True
    priority[slot] = prio


def _pool_retire(active, slot: int) -> None:
    """Retire one slot, in place: an exact no-op in later ticks."""
    active[slot] = False


class AdmissionError(RuntimeError):
    """Raised by ``SkyscraperPool.admit`` when admission control finds the
    pool cannot serve one more stream even at every stream's cheapest
    configuration (the throughput guarantee could not hold, so the
    stream is refused rather than admitted into certain shedding)."""


# host-read order of a tick's outs: one float64 transfer carries them all
_HOST_KEYS = ("k", "c", "buffer_s", "dropped", "shed", "on_s", "cl_s")


class SkyscraperPool:
    """An elastic pool of live streams sharing one fitted ``Skyscraper``,
    switched by one batched decision per tick (paper App. D scenario 1
    as an online serving runtime), on the handle's device.

    Slots, not streams: the capacity follows the power-of-two slot
    ladder (``_bucket_cap`` on the leading axis of every carried
    tensor), and an ``active`` mask makes retired or empty slots exact
    no-ops. ``admit``/``retire`` write rows in place, and a tick writes
    its new state into the carried tensors, so within a bucket the pool
    allocates no new device buffers for its state; only a bucket
    boundary does (``_grow``).

        pool = SkyscraperPool(fitted_sky, n_streams=8)
        statuses, outputs = pool.process([seg0, ..., seg7])
        pool.admit(stream_id=99, priority=2.0)
        pool.retire(stream_id=3)
        statuses, outputs = pool.process({99: seg, ...})  # by stream id

    Overload (``capacity_core_s`` / ``shed_watermark``): the tick sheds
    the lowest-priority streams first when the planned demand exceeds
    the pool's core-seconds per tick, or when a stream's buffer crossed
    the watermark fraction of its capacity (``_pool_tick_fn``).
    ``joint_plan=True`` replans every stream through one
    priority-weighted stacked LP under the pool's budget instead of
    independent per-stream budgets.

    Planning: each slot's category history is a rolling label buffer
    on the device; a replan is one batched forecast and LP, enqueued
    before the tick's decisions are read back, so on the card it runs
    while the host does the Transform work.

    ``sink``: an optional ``warehouse.SegmentStore`` or
    ``ShardedStore`` on the same device (``out_dim ==
    len(sky.configs)``); every tick lands one row per active stream with
    its real id (on a sharded sink, on shard ``id % n_shards``), folded
    into the store's standing queries, and each tick's fired
    subscriptions surface in ``pool.alerts``. ``device=None`` means CUDA, and must be the
    Skyscraper's device. ``telemetry=True`` attaches the host flight
    recorder (``obs.telemetry.HostTelemetry``), read with
    ``telemetry()`` and ``shed_stats()``.
    """

    def __init__(self, sky: Skyscraper, n_streams: int, sink=None,
                 telemetry: bool = False, *, priorities=None,
                 slot_chunk: int = 8, capacity_core_s=None,
                 shed_watermark=None, joint_plan: bool = False,
                 device=None):
        assert sky._fitted, "fit() the Skyscraper first"
        from repro_torch.warehouse.store import _bucket_cap
        self.device = resolve(device)
        if self.device != sky.device:
            raise ValueError(f"the pool runs on {self.device} and the "
                             f"Skyscraper on {sky.device}")
        self.sky = sky
        self.sink = sink
        self._chunk = max(1, int(slot_chunk))
        self._cap = _bucket_cap(max(int(n_streams), 1), self._chunk)
        self.capacity_core_s = capacity_core_s
        self.shed_watermark = shed_watermark
        self._joint_plan = bool(joint_plan)
        self._hist_len = sky.n_split * sky.interval
        self._centers = sky.tables.centers
        self._k0 = int(torch.argmin(sky.tables.rank_pos))
        # host-side slot bookkeeping: stream s starts at slot s
        self._slot_of: Dict[int, int] = {v: v for v in range(n_streams)}
        self._stream_of: Dict[int, int] = {v: v for v in range(n_streams)}
        self._free = list(range(n_streams, self._cap))
        self._active_np = np.zeros(self._cap, bool)
        self._active_np[:n_streams] = True
        self._priority_np = np.zeros(self._cap, np.float32)
        self._priority_np[:n_streams] = (
            1.0 if priorities is None
            else np.asarray(priorities, np.float32))
        self._alloc(self._cap)
        self._seen = 0
        # last tick's fired standing-query alerts (see ``process``)
        self.alerts = []
        self._tel = None
        self._retired_tel: Dict[int, Dict] = {}
        if telemetry:
            from repro_torch.obs.telemetry import HostTelemetry
            self._tel = HostTelemetry(self._cap, self._k0)

    def _alloc(self, cap: int) -> None:
        """(Re)build every carried tensor at ``cap`` slots: the rows of
        the current slots kept, the new ones inactive template rows."""
        sky, dev = self.sky, self.device
        old = getattr(self, "tables", None)
        n = 0 if old is None else old.tau.shape[0]
        pad = cap - n
        tables = stack_tables([sky.tables] * pad)
        state = init_state_multi([sky.tables] * pad)
        bufs = torch.zeros((pad, self._hist_len), dtype=torch.int32,
                           device=dev)
        alpha = sky.alpha.expand((pad,) + sky.alpha.shape)
        if old is not None:
            tables = SwitchTables(**{
                f: torch.cat([getattr(old, f), getattr(tables, f)])
                for f in SwitchTables.__dataclass_fields__})
            state = {k: torch.cat([self.state[k], state[k]]) for k in state}
            bufs = torch.cat([self._bufs, bufs])
            alpha = torch.cat([self._alpha, alpha])
            self._pending_q = np.concatenate(
                [self._pending_q, np.zeros(pad, np.float32)])
            self._pending_valid = np.concatenate(
                [self._pending_valid, np.zeros(pad, bool)])
        else:
            # last tick's measured qualities, folded into the NEXT tick's
            # classification state by the tick
            self._pending_q = np.zeros(cap, np.float32)
            self._pending_valid = np.zeros(cap, bool)
        self.tables, self.state = tables, state
        self._bufs, self._alpha = bufs, alpha.contiguous()
        self._active = torch.as_tensor(self._active_np, device=dev)
        self._priority = torch.as_tensor(self._priority_np, device=dev)
        self._zeros = torch.zeros((cap, len(sky.configs)),
                                  dtype=torch.float32, device=dev)

    # -- lifecycle -----------------------------------------------------
    @property
    def V(self) -> int:
        """Number of ACTIVE streams (the slot capacity is ``cap``)."""
        return len(self._slot_of)

    @property
    def cap(self) -> int:
        """Current slot capacity (a rung of the power-of-two ladder)."""
        return self._cap

    @property
    def streams(self):
        """Active stream ids in slot order (the ``process`` list order)."""
        return [self._stream_of[s] for s in sorted(self._stream_of)]

    @property
    def joint_plan(self) -> bool:
        """Whether replans solve one stacked priority-weighted LP (see
        ``_replan``); settable, taking effect at the next replan."""
        return self._joint_plan

    @joint_plan.setter
    def joint_plan(self, on: bool) -> None:
        self._joint_plan = bool(on)

    def _min_demand_core_s(self, extra: int = 0) -> float:
        """Lower bound on one tick's on-prem demand: every active stream
        (plus ``extra`` more) at its cheapest config."""
        return float(np.min(self.sky.cost)) * (self.V + extra)

    def admit(self, stream_id: int, priority: float = 1.0, tables=None,
              force: bool = False) -> int:
        """Admit a live stream into a free slot (growing the slot ladder
        one bucket when none is free). ``tables`` optionally gives it its
        own ``SwitchTables`` row (the same config set); ``priority``
        orders it in the shed ladder and weights it in the joint LP.
        Returns the slot.

        Admission control: with ``capacity_core_s`` set, a stream whose
        admission would push the pool's cheapest-config demand past the
        capacity is refused (``AdmissionError``); ``force=True`` admits
        it anyway and leaves the overload to the shed ladder."""
        if stream_id in self._slot_of:
            raise ValueError(f"stream {stream_id} already admitted")
        if (not force and self.capacity_core_s is not None
                and self._min_demand_core_s(extra=1)
                > float(self.capacity_core_s)):
            raise AdmissionError(
                f"admitting stream {stream_id} needs >= "
                f"{self._min_demand_core_s(extra=1):.3f} core-s/tick at "
                f"the cheapest config, over the provisioned "
                f"{float(self.capacity_core_s):.3f}")
        if not self._free:
            self._grow(self._cap * 2)
        slot = min(self._free)
        self._free.remove(slot)
        row = tables if tables is not None else self.sky.tables
        _pool_admit_fn(self.tables, self.state, self._bufs, self._alpha,
                       self._active, self._priority, slot,
                       float(np.float32(priority)), row, self.sky.alpha)
        self._active_np[slot] = True
        self._priority_np[slot] = np.float32(priority)
        self._slot_of[stream_id] = slot
        self._stream_of[slot] = stream_id
        self._pending_valid[slot] = False
        if self._tel is not None:
            self._tel.reset_slot(slot)
        return slot

    def retire(self, stream_id: int) -> int:
        """Remove a stream: its slot goes inactive (an exact no-op in the
        tick) and returns to the free list. Its flight-recorder counters
        stay in ``shed_stats()``. Returns the freed slot."""
        slot = self._slot_of.pop(stream_id)
        del self._stream_of[slot]
        if self._tel is not None:
            self._retired_tel[stream_id] = {
                "segments": float(self._tel.counters["seg_total"][slot]),
                "dropped": float(self._tel.counters["seg_dropped"][slot]),
                "priority": float(self._priority_np[slot]),
            }
        self._active_np[slot] = False
        _pool_retire(self._active, slot)
        self._pending_valid[slot] = False
        self._free.append(slot)
        return slot

    def _grow(self, new_cap: int) -> None:
        """Widen the slot ladder to ``new_cap``: every carried tensor
        padded with inactive template rows (new buffers, the only place a
        pool allocates them)."""
        pad = new_cap - self._cap
        self._active_np = np.concatenate([self._active_np,
                                          np.zeros(pad, bool)])
        self._priority_np = np.concatenate(
            [self._priority_np, np.zeros(pad, np.float32)])
        self._alloc(new_cap)
        self._free.extend(range(self._cap, new_cap))
        if self._tel is not None:
            self._tel.grow(new_cap)
        self._cap = new_cap

    # -- observability -------------------------------------------------
    def telemetry(self):
        """The pool's flight recorder (``obs.telemetry.Telemetry``) over
        the ACTIVE streams in slot order, or None without one."""
        if self._tel is None:
            return None
        return self._tel.snapshot(select=sorted(self._stream_of))

    def shed_stats(self) -> Dict[int, Dict]:
        """Per-stream shed accounting from the flight recorder:
        ``{stream_id: {segments, dropped, priority}}``; retired streams
        keep what they accumulated while live."""
        out = {}
        if self._tel is None:
            return out
        for slot in sorted(self._stream_of):
            out[self._stream_of[slot]] = {
                "segments": float(self._tel.counters["seg_total"][slot]),
                "dropped": float(self._tel.counters["seg_dropped"][slot]),
                "priority": float(self._priority_np[slot]),
            }
        for sid, rec in self._retired_tel.items():
            out.setdefault(sid, dict(rec))
        return out

    # -- planning ------------------------------------------------------
    def _replan(self):
        """Refresh every slot's plan, written into the carried plans in
        place. Default: independent per-stream LPs. ``joint_plan=True``:
        one stacked priority-weighted LP under the pool budget
        (``capacity_core_s`` when set, else the per-stream budget times
        the active count)."""
        sky = self.sky
        budget = (sky.budget_override if sky.budget_override
                  else sky.num_cores * sky.tau)
        use_model = self._seen >= self._hist_len
        if self._joint_plan:
            total = (float(self.capacity_core_s)
                     if self.capacity_core_s is not None
                     else float(budget) * max(self.V, 1))
            alpha = _pool_replan_stacked(
                sky.forecaster, self._bufs, self._centers, sky.tables.cost,
                sky._f32(total), use_model, self._active, self._priority,
                n_split=sky.n_split, interval=sky.interval)
        else:
            alpha = _pool_replan(
                sky.forecaster, self._bufs, self._centers, sky.tables.cost,
                sky._f32(budget), use_model, n_split=sky.n_split,
                interval=sky.interval)
        self._alpha.copy_(alpha)
        if self._tel is not None:
            self._tel.replans += 1

    # -- the tick ------------------------------------------------------
    def process(self, segments, arrival_mults: Optional[Sequence] = None):
        """One batched switch and shed decision for every slot, then the
        Transform (``proc_fn``) of each active stream that was not shed.

        ``segments``: a list in slot order (``pool.streams`` gives the
        ids), or a ``{stream_id: segment}`` dict; ``arrival_mults``
        likewise. Returns ``(statuses, results)`` of the active streams
        in slot order; a dropped or shed stream's result is None."""
        sky, dev = self.sky, self.device
        slots = sorted(self._stream_of)
        if isinstance(segments, dict):
            segs = [segments[self._stream_of[s]] for s in slots]
        else:
            assert len(segments) == len(slots), \
                f"need {len(slots)} segments (one per active stream)"
            segs = list(segments)
        K = len(sky.configs)
        arr_np = np.ones(self._cap, np.float32)
        if arrival_mults is not None:
            if isinstance(arrival_mults, dict):
                for sid, m in arrival_mults.items():
                    arr_np[self._slot_of[sid]] = m
            else:
                arr_np[np.asarray(slots)] = np.asarray(arrival_mults,
                                                       np.float32)
        cap_op = sky._f32(np.inf if self.capacity_core_s is None
                          else self.capacity_core_s)
        wm_op = sky._f32(np.inf if self.shed_watermark is None
                         else self.shed_watermark)
        new_state, outs = _pool_tick_fn(
            self.state, torch.as_tensor(self._pending_q, device=dev),
            torch.as_tensor(self._pending_valid, device=dev), self._zeros,
            torch.as_tensor(arr_np, device=dev), self._active,
            self._priority, self._alpha, self.tables, cap_op, wm_op)
        for k, v in new_state.items():
            self.state[k].copy_(v)
        self._bufs.copy_(_pool_shift(self._bufs, outs["c"]))
        # when this tick closes a planning window, enqueue the replan now,
        # before the host waits for the decisions, so on the card it runs
        # while the host does this tick's Transform work
        if (self._seen + 1) % sky._plan_every == 0:
            self._replan()
        host = torch.stack([outs[k].to(torch.float64)
                            for k in _HOST_KEYS]).cpu().numpy()
        h = dict(zip(_HOST_KEYS, host))
        ks, cats = h["k"].astype(np.int64), h["c"].astype(np.int64)
        drops, sheds = h["dropped"] != 0, h["shed"] != 0
        bufs_s = h["buffer_s"].astype(np.float32)
        statuses, results = [], []
        q_np = np.zeros(self._cap, np.float32)
        q_valid = np.zeros(self._cap, bool)
        for i, slot in enumerate(slots):
            k = int(ks[slot])
            status = {"stream_id": self._stream_of[slot],
                      "config": sky.configs[k], "k": k,
                      "category": int(cats[slot]),
                      "buffer_s": float(bufs_s[slot]),
                      "dropped": bool(drops[slot]),
                      "shed": bool(sheds[slot])}
            if drops[slot]:
                # shed or dropped: the segment is NOT transformed (the
                # work the shed saves); quality 0 by contract
                status["quality"] = 0.0
                results.append(None)
            else:
                result, q = sky.proc_fn(segs[i], sky.configs[k])
                q_np[slot] = q
                q_valid[slot] = True
                status["quality"] = float(q)
                results.append(result)
            statuses.append(status)
        if self._tel is not None:
            self._tel.update({"k": ks, "dropped": drops, "buffer_s": bufs_s,
                              "on_s": h["on_s"].astype(np.float32),
                              "cl_s": h["cl_s"].astype(np.float32)},
                             valid=self._active_np)
        self._pending_q = q_np
        self._pending_valid = q_valid
        if self.sink is not None:
            # Load: the decision traces are on the device already; the
            # measured qualities are the only values born on the host.
            # One row per ACTIVE stream, with its real stream id.
            ids = np.zeros(self._cap, np.int64)
            for slot in slots:
                ids[slot] = self._stream_of[slot]
            q_dev = torch.as_tensor(q_np, device=dev)
            out_vec = (torch.nn.functional.one_hot(outs["k"], K)
                       .to(torch.float32) * q_dev[:, None])
            self.sink.ingest_tick(outs, quality=q_dev, out_vecs=out_vec,
                                  t=self._seen, stream_ids=ids,
                                  valid=self._active_np)
            from repro_torch.core.ingest import _notify_standing
            self.alerts = _notify_standing(self.sink)
        self._seen += 1
        return statuses, results
