"""Standing queries: registered plans kept fresh AT INGEST RATE.

Port of ``repro/warehouse/standing.py``.
``store.query(plan)`` rescans every stored row. An aggregating plan,
though, reduces to fixed-shape ``{"acc", "cnt"}`` accumulators (the
query engine's partial), and those can be kept current: fold each
ingest's NEW rows into the stored accumulators and the answer is an
O(result) finalize, with no rescan.

``StandingQueries`` is that registry, attached to one store
(``SegmentStore``, ``ShardedStore`` or a tiered wrapper of either):

- ``register(plan)`` splits the plan at its aggregating reducer
  (GroupBy / WindowAgg / MultiGroupBy; row plans and a TopK reducer have
  no fixed-size state and are refused), backfills once over the rows the
  store already holds, and from then on every ingest folds its rows in.
- The fold runs inside the store's ingest call (``SegmentStore.
  ingest_fused`` / ``append_rows``), right after the rows land, on the
  rows as the store holds them (cast to the column dtypes): the slices
  ``[lo:lo + n]`` of its columns.
- Queries of the same plan SHAPE form one group: their filter operands
  stack ``(Q, F)`` and their state carries a leading query axis of
  ``Qb`` slots, Q rounded up to a power of two (the reference's
  buckets; the padding slots are never folded or read).
- ``subscribe(plan, predicate)`` adds an alert: each ``poll()`` evaluates
  the predicate over the plan's answer table and returns the fired mask
  per result row, counted in the store's ``obs`` (``standing_refreshes``,
  ``alerts_checked``, ``alerts_fired``).

Each group folds on one of the query engine's two paths, chosen at
registration by ``use_kernel`` with ``execute``'s rules
(``query._resolve_use_kernel``):

- the engine (``use_kernel=False``): ``query._seg_fold``, the segment
  scatter seeded with the stored accumulator. Each group's float32
  addition sequence continues where the last fold stopped, so a backfill
  plus any interleaving of folds is bit-exact with one rescan in ingest
  order: on the CPU, standing answers equal ``query.execute_ref`` (and
  the reference's) bit for bit, float sums included.
- K1 (``use_kernel=None`` or ``True`` where the plan has a fused spec):
  ``fused_segment_agg`` over the new rows gives a delta partial (on CUDA
  the kernel, on the CPU its plain version), which combines with the
  stored one by + for sum, mean and count and by elementwise max / min.
  Counts, max and min stay exact; float sums carry the deltas'
  rounding and the kernel's order of addition, so they are held to a
  tolerance, as the query path's are.

On a ``ShardedStore`` the state carries a leading shard axis ``(S, Qb,
groups[, D])``: after every ingest each shard folds the rows it just
received (a contiguous slice of its columns, since the router lands a
shard's rows in update order), on the path the group chose with
``_resolve_use_kernel`` on one shard's columns; the registration
backfill folds each shard's live rows; an answer merges the shards by
sum / max / min (``query._merge_sum``, in shard order) before it
finalizes. On a store spread over a ``torch.distributed`` group the
state holds the rank's own ``k`` shards, ``(k, Qb, groups[, D])``, and
``answer`` / ``answer_host`` / ``poll`` gather every shard's
accumulators in shard order first (collectives: every rank calls them
together), so every rank returns the stacked store's answers and fires
its alerts. The reference folds each shard's owned rows under an
ownership mask over the whole block, which adds only identities for the
rows it does not own, so the engine path (``use_kernel=False``) is
bit-exact with it on the CPU; K1's path regroups the sums as on one
store.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.warehouse_agg import CMP as _CMP
from repro_torch.kernels.warehouse_agg import fused_segment_agg, identity
from repro_torch.warehouse.query import (Filter, GroupBy, TopK, WindowAgg,
                                         _apply_nodes, _FilterRef,
                                         _kernel_spec, _merge_sum,
                                         _num_groups, _resolve_use_kernel,
                                         _seg_finalize, _seg_fold,
                                         _seg_table, normalize, split_plan,
                                         to_host)

# how many (query, batch) folds took each path: one K1 call per kernel fold
FOLDS = {"kernel": 0, "engine": 0}


def _bucket(n: int) -> int:
    """Power-of-two query-slot buckets (1, 2, 4, ...)."""
    return 1 << (n - 1).bit_length()


def _slot(state, i: int, sharded: bool = False):
    """Query slot ``i`` of a stacked state (its shard axis kept)."""
    return {k: (v[:, i] if sharded else v[i]) for k, v in state.items()}


def _fvals_of(fvals, i: int):
    return tuple(a[i] for a in fvals)


# ---------------------------------------------------------------------------
# the fold: new rows -> stored partials, inside the store's ingest call
# ---------------------------------------------------------------------------

def _fold_group(state, fvals, table, mask, n_new, *, spec, use_kernel):
    """Fold one group's batch of new rows into its stacked state, in
    place, for each query row of ``fvals`` (the live slots). ``table`` is
    the new rows' column block, ``mask`` its valid rows, ``n_new`` the
    valid prefix (the bound K1 reads to). Returns ``state``."""
    pre, node, _post = split_plan(spec)
    for i in range(len(fvals[0])):
        st, fv = _slot(state, i), _fvals_of(fvals, i)
        if not use_kernel:
            tbl, m = _apply_nodes(table, mask, fv, pre)
            _seg_fold(st, tbl, m, node)
            FOLDS["engine"] += 1
            continue
        # the delta partial from K1, then the combiner of the partials'
        # merge algebra
        delta = fused_segment_agg(table, n_new, fv,
                                  _kernel_spec(pre, node, table))
        FOLDS["kernel"] += 1
        if node.agg == "max":
            torch.maximum(st["acc"], delta["acc"], out=st["acc"])
        elif node.agg == "min":
            torch.minimum(st["acc"], delta["acc"], out=st["acc"])
        else:
            st["acc"].add_(delta["acc"])
        st["cnt"].add_(delta["cnt"])
    return state


def _fold_all(sstates, sfvals, table, mask, n_new, sspecs):
    """Every registered group's fold, in registration order; ``sspecs``
    holds the ``(plan spec, use_kernel)`` pair of each group."""
    return tuple(
        _fold_group(st, fv, table, mask, n_new, spec=sp, use_kernel=uk)
        for st, fv, (sp, uk) in zip(sstates, sfvals, sspecs))


def _backfill(cols, n_rows: int, fvals, state, *, sspec):
    """The one-time O(rows) registration scan: the same fold, seeded with
    a fresh state, over the store's live rows."""
    spec, use_kernel = sspec
    first = next(iter(cols.values()))
    mask = torch.arange(first.shape[0], device=first.device) < n_rows
    return _fold_group(state, fvals, cols, mask, n_rows, spec=spec,
                       use_kernel=use_kernel)


def _answer(st, fv, *, spec, sharded: bool = False):
    """O(result) answer of one query: merge its per-shard accumulators
    when ``sharded`` (sum / max / min over the leading shard axis), then
    finalize and run the post-reduction nodes. Reads only the state,
    never the stored rows; the answer owns its tensors (the folds update
    the state in place, and a sum's finalize would otherwise hand out
    the accumulator itself)."""
    _pre, node, post = split_plan(spec)
    acc, cnt = st["acc"], st["cnt"]
    if sharded:
        acc = {"max": lambda a: a.amax(0),
               "min": lambda a: a.amin(0)}.get(node.agg, _merge_sum)(acc)
        cnt = _merge_sum(cnt)
    out, cnt = _seg_finalize(acc.clone(), cnt.clone(), node.agg)
    table, mask = _seg_table(node, out, cnt)
    return _apply_nodes(table, mask, fv, post)


def _answer_kernel(state, fvals, *, spec, sharded: bool = False):
    """``_answer`` for each query row of ``fvals``, the result tables
    stacked on a leading query axis."""
    answers = [_answer(_slot(state, i, sharded), _fvals_of(fvals, i),
                       spec=spec, sharded=sharded)
               for i in range(len(fvals[0]))]
    return ({k: torch.stack([t[k] for t, _ in answers])
             for k in answers[0][0]},
            torch.stack([m for _, m in answers]))


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

@dataclass
class Alert:
    """One subscription's poll result: ``fired`` is the fixed-shape
    per-result-row alert mask (predicate AND the row's validity), the
    same shape every poll; ``table`` the answer it was evaluated on
    (host numpy)."""
    sub: int
    name: str
    handle: int
    fired: np.ndarray
    table: Dict[str, np.ndarray]

    @property
    def n_fired(self) -> int:
        return int(self.fired.sum())


@dataclass
class _Sub:
    sid: int
    name: str
    handle: int
    predicate: Filter


@dataclass
class _Query:
    handle: int
    name: str
    plan: tuple
    spec: tuple                        # normalized plan shape (group key)
    fvals: Tuple[np.ndarray, ...]      # this query's (F,) operands
    slot: int                          # row in the group's stacked state


class _Group:
    """All registered queries of one plan SHAPE: one spec, stacked
    ``(Q, F)`` filter operands, stacked ``([S,] Qb, groups[, D])``
    accumulators."""

    def __init__(self, reg: "StandingQueries", spec, use_kernel: bool):
        self.reg = reg
        self.spec = spec
        self.use_kernel = bool(use_kernel)
        _pre, self.node, _post = split_plan(spec)
        self.queries: List[_Query] = []
        self.qb = 0
        self.fvals = None
        self.state = None

    @property
    def q(self) -> int:
        return len(self.queries)

    @property
    def sspec(self):
        return (self.spec, self.use_kernel)

    def _init_state(self, qb: Optional[int] = None):
        qb = self.qb if qb is None else qb
        node, store, sharded = self.node, self.reg.host, self.reg.sharded
        vcol = store.columns[node.value]
        lead = ((len(store.shards),) if sharded else ()) + (
            qb, _num_groups(node))
        kw = dict(dtype=torch.float32, device=store.device)
        return {"acc": torch.full(lead + tuple(vcol.shape[1 + sharded:]),
                                  identity(node.agg), **kw),
                "cnt": torch.zeros(lead, **kw)}

    def add(self, query: _Query) -> None:
        self.queries.append(query)
        if self.q > self.qb:                 # bucket crossing: grow
            old, old_qb = self.state, self.qb
            self.qb = _bucket(self.q)
            grown = self._init_state()
            if old is not None:
                # folded history cannot be rebuilt from the rows later
                for k in grown:
                    if self.reg.sharded:
                        grown[k][:, :old_qb] = old[k]
                    else:
                        grown[k][:old_qb] = old[k]
            self.state = grown
        self.fvals = tuple(np.stack([q.fvals[i] for q in self.queries])
                           for i in range(4))
        self._backfill_slot(query)

    def _backfill_slot(self, query: _Query) -> None:
        """Fold the store's EXISTING rows into the new query's slot."""
        src = self.reg._source()
        if src is None:                      # empty store: the init state
            return
        cols, n_rows = src
        fv1 = tuple(a[None] for a in query.fvals)
        bf = self._init_state(qb=1)
        if not self.reg.sharded:
            _backfill(cols, n_rows, fv1, bf, sspec=self.sspec)
            for k in self.state:
                self.state[k][query.slot] = bf[k][0]
            return
        for s, n in enumerate(n_rows):       # each shard's live rows
            _backfill({k: v[s] for k, v in cols.items()}, int(n), fv1,
                      _slot(bf, s), sspec=self.sspec)
        for k in self.state:
            self.state[k][:, query.slot] = bf[k][:, 0]


class StandingQueries:
    """The store-attached registry. Attach once per store::

        reg = StandingQueries(store)
        h = reg.register((Filter(...), GroupBy(...)))
        store.append_rows(rows)               # the fold runs in the ingest
        table, mask = reg.answer(h)           # O(result), no rescan
    """

    def __init__(self, store):
        # a TieredStore's registry attaches to its hot tier, whose ingests
        # fold, while backfills scan the wrapper's two-tier view
        self.store = store
        self.host = getattr(store, "hot", store)
        assert getattr(self.host, "standing", None) is None, \
            "store already has a StandingQueries registry attached"
        self.host.standing = self
        self.sharded = hasattr(self.host, "n_shards")
        self._groups: Dict[tuple, _Group] = {}
        self._queries: Dict[int, _Query] = {}
        self._subs: Dict[int, _Sub] = {}
        self._active: List[_Group] = []
        self._next = 0

    def __len__(self) -> int:
        return len(self._queries)

    @property
    def has_subscriptions(self) -> bool:
        return bool(self._subs)

    # -- registration --------------------------------------------------
    def _validate(self, spec) -> None:
        pre, node, _post = split_plan(spec)
        if node is None or isinstance(node, TopK):
            raise ValueError(
                "standing queries need an aggregating reducer (GroupBy/"
                "WindowAgg/MultiGroupBy): pure row plans and row-level "
                "TopK have no fixed-size incremental state")
        avail = set(self.host.columns)
        for nd in pre:
            if isinstance(nd, _FilterRef):
                if nd.column not in avail:
                    raise ValueError(f"unknown column {nd.column!r}")
            else:                                        # Project
                if not set(nd.columns) <= avail:
                    raise ValueError(
                        f"unknown columns {set(nd.columns) - avail}")
                avail = set(nd.columns)
        if isinstance(node, GroupBy):
            keys = {node.key}
        elif isinstance(node, WindowAgg):
            keys = {"t"}
        else:
            keys = set(node.keys)
        missing = (keys | {node.value}) - avail
        if missing:
            raise ValueError(f"plan references unknown columns {missing}")

    def register(self, plan, *, name: Optional[str] = None,
                 use_kernel=None) -> int:
        """Register ``plan`` as a standing query; returns its handle.
        One-time cost: an O(rows) backfill over the current store. Then
        every ingest folds its rows in and ``answer(handle)`` is
        O(result). ``use_kernel`` picks the fold's path for the plan's
        shape, as ``execute`` picks a query's (the first registration of
        a shape decides for its group)."""
        spec, fvals = normalize(plan)
        self._validate(spec)
        g = self._groups.get(spec)
        if g is None:
            pre, node, _post = split_plan(spec)
            cols = self.host.columns
            if self.sharded:                 # the path of one shard's rows
                cols = {k: v[0] for k, v in cols.items()}
            g = _Group(self, spec, _resolve_use_kernel(
                use_kernel, pre, node, cols))
            self._groups[spec] = g
        handle = self._next
        self._next += 1
        q = _Query(handle, name or f"q{handle}", tuple(plan), spec,
                   tuple(np.asarray(a) for a in fvals), g.q)
        g.add(q)
        self._queries[handle] = q
        self.host.obs["standing_queries"] = len(self._queries)
        return handle

    def subscribe(self, plan, predicate: Filter, *,
                  name: Optional[str] = None, use_kernel=None) -> int:
        """Register ``plan`` AND an alert over its answer table:
        ``predicate`` is a ``Filter`` on a result column (the agg value,
        ``count``, or a group-key column). Every ``poll()`` evaluates it
        over the fixed-shape answer and returns the fired mask."""
        assert isinstance(predicate, Filter), \
            "predicate must be a Filter(...) over the answer table"
        handle = self.register(plan, name=name, use_kernel=use_kernel)
        sid = self._next
        self._next += 1
        self._subs[sid] = _Sub(sid, name or f"alert{sid}", handle,
                               predicate)
        return sid

    # -- ingest-side hooks (called by the store) -----------------------
    def kernel_args(self):
        """(sstates, sfvals, sspecs) of the groups that hold queries: what
        the store's ingest hands ``_fold_all``."""
        self._active = [g for g in self._groups.values() if g.q]
        return (tuple(g.state for g in self._active),
                tuple(g.fvals for g in self._active),
                tuple(g.sspec for g in self._active))

    def absorb(self, new_states) -> None:
        """Store the folded state an ingest returned."""
        for g, st in zip(self._active, new_states):
            g.state = st
        self.host.obs["standing_refreshes"] += 1

    def _source(self):
        """(columns, live rows) for a backfill (a tiered store's two-tier
        view; per-shard counts for a sharded store), or None when the
        store is empty."""
        if self.store.n_rows == 0:
            return None
        if self.sharded:
            return self.store.shard_source()
        from repro_torch.warehouse.query import _source as q_source
        return q_source(self.store)

    # -- answers -------------------------------------------------------
    def _all_shards(self, state):
        """``state`` with every shard's accumulators, in shard order: a
        gather over the store's group, or the state itself."""
        group = getattr(self.host, "group", None)
        if group is None:
            return state
        from repro_torch.launch.mesh import all_gather_blocks
        return dict(zip(state, all_gather_blocks(list(state.values()),
                                                 group)))

    def group_answers(self, group: _Group):
        """Stacked (Q, ...) answer tables of one group's queries."""
        return _answer_kernel(self._all_shards(group.state), group.fvals,
                              spec=group.spec, sharded=self.sharded)

    def answer(self, handle: int):
        """(table, mask) of one standing query, tensors on the store's
        device: a finalize of its accumulators and its post nodes, no
        rescan."""
        q = self._queries[handle]
        g = self._group_of(q)
        return _answer(self._all_shards(_slot(g.state, q.slot,
                                               self.sharded)),
                       q.fvals, spec=g.spec, sharded=self.sharded)

    def _group_of(self, q: _Query) -> _Group:
        return self._groups[q.spec]

    def answer_host(self, handle: int) -> Dict[str, np.ndarray]:
        """``answer`` compacted to host numpy (masked rows dropped)."""
        table, mask = self.answer(handle)
        return to_host(table, mask)

    # -- alerts --------------------------------------------------------
    def poll(self) -> List[Alert]:
        """Evaluate every subscription against its plan's CURRENT
        standing answer (one answer per group, shared by its
        subscriptions), the predicates on the host over the fixed-shape
        tables. Counts ``alerts_checked`` and ``alerts_fired``."""
        alerts: List[Alert] = []
        cache: Dict[int, tuple] = {}
        for sub in self._subs.values():
            q = self._queries[sub.handle]
            g = self._group_of(q)
            if id(g) not in cache:
                cache[id(g)] = self.group_answers(g)
            table, mask = cache[id(g)]
            row = {k: v[q.slot].cpu().numpy() for k, v in table.items()}
            valid = mask[q.slot].cpu().numpy()
            col = row[sub.predicate.column]
            dt = np.float64 if np.issubdtype(col.dtype, np.integer) \
                else np.float32
            pred = np.asarray(_CMP[sub.predicate.op](
                col.astype(dt), dt(sub.predicate.value)))
            fired = valid & pred
            self.host.obs["alerts_checked"] += 1
            self.host.obs["alerts_fired"] += int(fired.sum())
            alerts.append(Alert(sub.sid, sub.name, sub.handle, fired, row))
        return alerts
