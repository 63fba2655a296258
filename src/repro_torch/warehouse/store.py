"""V-ETL *Load*: a device-resident columnar segment store.

Port of ``repro/warehouse/store.py``'s ``SegmentStore``. Append-only and
columnar: one tensor per column on one device, grown along the fixed
capacity ladder ``{chunk_rows * 2**j}``. Columns:

    stream_id     int32   which camera/stream produced the segment
    t             int32   segment index on that stream's timeline
    category      int32   content category the switcher classified
    k             int32   knob configuration the switcher chose
    quality       f32     measured quality of the chosen config
    on_core_s     f32     on-prem work spent (core-seconds)
    cloud_core_s  f32     cloud work spent (core-seconds)
    buffer_s      f32     buffer fill after the segment (seconds)
    out           f32     fixed-width application output / embedding (D,)

Where the reference rebuilt its immutable column arrays on every write
(``dynamic_update_slice``), the port writes rows IN PLACE: an ingest is
one slice assignment per column into the preallocated capacity, and
growth copies the live rows once into the next rung of the ladder. The
row count is host state, so queries know the live rows without reading
the device.

``ingest_fused_multi`` lands a multi-stream run's (n_w, V, W) traces
stream-major, and ``ingest_tick`` one row per live stream of a serving
pool's tick; the elastic pool's masked tick compacts its active slots
to consecutive rows carrying their real stream ids.

``ShardedStore`` partitions the same columns by ``stream_id %
n_shards``. Without a group it holds every shard on a stacked
``(n_shards, cap, ...)`` axis on one device (the reference's
single-device layout, ``mesh is None``). Given a ``torch.distributed``
group (``launch.mesh``) it is the reference's mesh layout: each rank
holds its block of ``k = n_shards / W`` shards on its own card, stacked
``(k, cap, ...)``, and every rank calls the same methods with the same
arguments. Each ingest routes every row to its owner shard on the host,
where the stream ids are known, so every rank knows every shard's count
with no collective and writes only its own shards' rows; queries run
through the per-shard partial and merge of
``warehouse.query.execute_sharded``, which gathers the shards' partials
in shard order on a group.

A ``StandingQueries`` registry (``warehouse.standing``) attached to the
store is refreshed inside every ingest and ``append_rows``: right
after a block lands, its rows, read back as the slices ``[lo:lo + n]``
of the store's columns (so as the store holds them, cast to the column
dtypes), fold into every registered plan's accumulators, as the
reference's ``_write_and_fold`` folds them in the ingest dispatch.

``obs`` is the store's flight recorder (``obs.telemetry``): ingest and
query dispatches, the ingest-to-queryable lag of each batch, and the
standing registry's counters, all host metadata; ``telemetry()``
returns them as a ``StoreTelemetry``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.obs.telemetry import (StoreTelemetry, store_obs_batch,
                                       store_obs_init, store_obs_tick)
from repro_torch.warehouse.standing import _fold_all, _slot

SCALAR_COLUMNS = (
    ("stream_id", torch.int32),
    ("t", torch.int32),
    ("category", torch.int32),
    ("k", torch.int32),
    ("quality", torch.float32),
    ("on_core_s", torch.float32),
    ("cloud_core_s", torch.float32),
    ("buffer_s", torch.float32),
)
OUT_COLUMN = "out"

# fused-run trace key -> store column
_RUN_KEYS = (("c", "category"), ("k", "k"), ("qual", "quality"),
             ("on_s", "on_core_s"), ("cl_s", "cloud_core_s"),
             ("buffer_s", "buffer_s"))


def _empty_columns(cap: int, out_dim: int, device) -> Dict[str, torch.Tensor]:
    cols = {n: torch.zeros((cap,), dtype=dt, device=device)
            for n, dt in SCALAR_COLUMNS}
    cols[OUT_COLUMN] = torch.zeros((cap, out_dim), dtype=torch.float32,
                                   device=device)
    return cols


def _bucket_cap(need: int, chunk: int) -> int:
    """Smallest capacity from the fixed ladder ``{chunk * 2**j}`` that
    fits ``need`` rows (the reference's ladder, so both stores grow
    through the same capacities)."""
    units = max(1, -(-need // chunk))
    return chunk * (1 << (units - 1).bit_length())


def _multi_rows(traces, out_vecs, stream_base: int, t0: int, device):
    """A multi-stream run's update block: the (n_w, V, W) traces and the
    (V, T, D) output vectors flattened stream-major (stream 0's T rows,
    then stream 1's, ...), stream ids from ``stream_base``."""
    V, T = int(out_vecs.shape[0]), int(out_vecs.shape[1])

    def flat(x):                                  # (n_w, V, W) -> (V*T,)
        return x.transpose(0, 1).reshape(V, -1)[:, :T].reshape(-1)

    upd = {dst: flat(traces[src]) for src, dst in _RUN_KEYS}
    ar = torch.arange(T, dtype=torch.int32, device=device)
    upd["stream_id"] = stream_base + torch.arange(
        V, dtype=torch.int32, device=device).repeat_interleave(T)
    upd["t"] = (t0 + ar).repeat(V)
    upd[OUT_COLUMN] = torch.as_tensor(out_vecs).reshape(V * T, -1)
    return upd


def _tick_rows(traces, quality, out_vecs, t: int, stream_ids, device):
    """A pool tick's update block on ``device``: one row per slot, slot v
    standing for stream v unless ``stream_ids`` (an array, or a tensor on
    any device) names the real ids."""
    V = int(out_vecs.shape[0])
    upd = {dst: traces[src] for src, dst in _RUN_KEYS}
    upd["quality"] = torch.as_tensor(quality)
    upd["stream_id"] = (torch.arange(V, dtype=torch.int32)
                        if stream_ids is None
                        else torch.as_tensor(stream_ids))
    upd["t"] = torch.full((V,), t, dtype=torch.int32)
    upd[OUT_COLUMN] = torch.as_tensor(out_vecs)
    return {k: v.to(device) for k, v in upd.items()}


def _host_ints(x) -> np.ndarray:
    """An id column given as a tensor (on any device) or an array, as
    host int64."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, np.int64)


class SegmentStore:
    """Append-only columnar store for per-segment V-ETL results on
    ``device`` (``None`` means CUDA)."""

    def __init__(self, out_dim: int, chunk_rows: int = 8192, device=None):
        assert out_dim >= 1 and chunk_rows >= 1
        self.device = resolve(device)
        self.out_dim = int(out_dim)
        self.chunk_rows = int(chunk_rows)
        self.n_rows = 0
        self.t_max = -1
        self.columns = _empty_columns(0, out_dim, self.device)
        # host-side flight-recorder counters (see ``telemetry()``)
        self.obs = store_obs_init()
        # StandingQueries registry (attached by its constructor)
        self.standing = None

    # -- capacity ------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.columns["t"].shape[0]

    def _reserve(self, n_new: int) -> None:
        need = self.n_rows + n_new
        if need <= self.capacity:
            return
        cap = _bucket_cap(need, self.chunk_rows)
        grown = _empty_columns(cap, self.out_dim, self.device)
        for k, col in grown.items():
            col[:self.n_rows] = self.columns[k][:self.n_rows]
        self.columns = grown

    def _write(self, upd: Dict[str, torch.Tensor]) -> None:
        """Write the update block at row ``n_rows``, in place, then fold
        it into the attached standing queries."""
        n = upd["t"].shape[0]
        lo = self.n_rows
        for k, col in self.columns.items():
            col[lo:lo + n] = upd[k].to(device=self.device, dtype=col.dtype)
        self.n_rows += n
        self._fold(lo, n)

    def _fold(self, lo: int, n: int) -> None:
        """Fold rows [lo, lo + n), as stored, into every registered
        standing query (none registered: nothing runs)."""
        reg = self.standing
        if reg is None or not len(reg):
            return
        block = {k: col[lo:lo + n] for k, col in self.columns.items()}
        mask = torch.ones((n,), dtype=torch.bool, device=self.device)
        sstates, sfvals, sspecs = reg.kernel_args()
        reg.absorb(_fold_all(sstates, sfvals, block, mask, n, sspecs))

    # -- ingestion -----------------------------------------------------
    def ingest_fused(self, traces, out_vecs, *, stream_id: int = 0,
                     t0: int = 0) -> int:
        """Land a full ``run_skyscraper_fused`` run: ``traces`` is the
        engine's stacked outs dict ((n_w, W) device leaves), ``out_vecs``
        the (T, D) per-segment output block (e.g. the measured quality
        vectors). Returns the number of rows appended."""
        T = int(out_vecs.shape[0])
        assert out_vecs.ndim == 2 and out_vecs.shape[1] == self.out_dim, \
            f"out_vecs must be (T, {self.out_dim})"
        self._reserve(T)
        upd = {dst: traces[src].reshape(-1)[:T] for src, dst in _RUN_KEYS}
        upd["stream_id"] = torch.full((T,), stream_id, dtype=torch.int32,
                                      device=self.device)
        upd["t"] = t0 + torch.arange(T, dtype=torch.int32,
                                     device=self.device)
        upd[OUT_COLUMN] = torch.as_tensor(out_vecs)
        self._write(upd)
        self.t_max = max(self.t_max, t0 + T - 1)
        store_obs_batch(self.obs, 1, T)
        return T

    def ingest_fused_multi(self, traces, out_vecs, *, stream_base: int = 0,
                           t0: int = 0) -> int:
        """Land a full ``run_skyscraper_multi`` run: traces have
        (n_w, V, W) device leaves, ``out_vecs`` is (V, T, D). Rows land
        stream-major (stream 0's T rows, then stream 1's, ...), stream
        ids from ``stream_base``."""
        V, T = int(out_vecs.shape[0]), int(out_vecs.shape[1])
        assert out_vecs.ndim == 3 and out_vecs.shape[2] == self.out_dim
        self._reserve(V * T)
        self._write(_multi_rows(traces, out_vecs, stream_base, t0,
                                self.device))
        self.t_max = max(self.t_max, t0 + T - 1)
        store_obs_batch(self.obs, V, T)
        return V * T

    def ingest_tick(self, traces, *, quality, out_vecs, t: int,
                    stream_ids=None, valid=None) -> int:
        """Land one serving-pool tick: traces have (V,) device leaves (a
        ``switch_step_multi`` outs dict); ``quality`` (V,) is the quality
        the user's Transform measured.

        The elastic pool passes ``stream_ids`` (V,), the real stream id
        behind each slot, and ``valid`` (V,) host bool: inactive slots
        land no row, and the active ones land at consecutive rows in
        slot order. Without them slot v is stream v and every slot
        lands."""
        V = int(out_vecs.shape[0])
        assert out_vecs.ndim == 2 and out_vecs.shape[1] == self.out_dim
        upd = _tick_rows(traces, quality, out_vecs, t, stream_ids,
                         self.device)
        if valid is not None:
            keep = np.flatnonzero(np.asarray(valid, bool))
            idx = torch.as_tensor(keep, device=self.device)
            upd = {k: v.index_select(0, idx) for k, v in upd.items()}
        n_new = int(upd["t"].shape[0])
        self._reserve(n_new)
        self._write(upd)
        if n_new:
            self.t_max = max(self.t_max, t)
        store_obs_tick(self.obs, n_new)
        return n_new

    def append_rows(self, rows: Dict) -> int:
        """Generic batched append: ``rows`` maps every column name to an
        (n,) array or tensor (``out`` to (n, D))."""
        n = len(rows["t"])
        assert set(rows) == set(self.columns), \
            f"need exactly columns {sorted(self.columns)}"
        self._reserve(n)
        upd = {k: v if isinstance(v, torch.Tensor)
               else torch.as_tensor(np.asarray(v)) for k, v in rows.items()}
        self._write(upd)
        if n:
            self.t_max = max(self.t_max, int(upd["t"].max()))
        store_obs_tick(self.obs, n)
        return n

    # -- reading -------------------------------------------------------
    def query(self, plan, **kw):
        """Run a query plan over the live rows (see ``warehouse.query``;
        ``use_kernel=`` selects the aggregation path)."""
        from repro_torch.warehouse import query as Q
        self.obs["query_dispatches"] += 1
        return Q.execute(self, plan, **kw)

    def telemetry(self) -> StoreTelemetry:
        """The store's flight recorder: rows, ingest and query dispatch
        counts, ingest-to-queryable lag and the standing registry's
        counters, all from host metadata (no device read)."""
        return StoreTelemetry(rows_by_shard=np.asarray([self.n_rows]),
                              **self.obs)

    def host_rows(self) -> Dict[str, np.ndarray]:
        """All live rows as host numpy (an explicit full transfer; a copy
        on the CPU too, since the store writes its columns in place)."""
        return {k: (v[:self.n_rows].cpu() if v.is_cuda
                    else v[:self.n_rows].clone()).numpy()
                for k, v in self.columns.items()}

    def __len__(self) -> int:
        return self.n_rows

    def __repr__(self) -> str:
        return (f"SegmentStore(rows={self.n_rows}, cap={self.capacity}, "
                f"out_dim={self.out_dim}, chunk={self.chunk_rows}, "
                f"device={self.device})")


# ---------------------------------------------------------------------------
# sharded store: stream-hash partitioned rows on a stacked shard axis
# ---------------------------------------------------------------------------

def all_shards(columns, n_rows_by_shard, group):
    """Every shard's columns ``(n_shards, m, ...)``, ``m`` the largest
    shard's live rows, from this rank's ``(k, cap, ...)`` columns: one
    collective on a group, a view of the live prefix without one."""
    m = int(np.max(n_rows_by_shard, initial=0))
    live = {k: v[:, :m] for k, v in columns.items()}
    if group is None:
        return live
    from repro_torch.launch.mesh import all_gather_blocks
    return dict(zip(live, all_gather_blocks(list(live.values()), group)))


class ShardedStore:
    """Stream-hash partitioned ``SegmentStore`` on one device (``None``
    means CUDA), or over a group's ranks: columns are stacked
    ``(n_shards, cap, ...)`` tensors (a rank's ``(k, cap, ...)``) and
    row ``r`` of stream ``sid`` lives on shard ``sid % n_shards``.

    Every ingest routes by owner on the host, where the stream ids are
    known: each shard's owned rows land at consecutive positions from
    that shard's row count, in the update block's order, and rows whose
    ``valid`` is false land nowhere. Every shard grows together, along
    the ``_bucket_cap`` ladder, so all shards share one capacity (the
    reference's, which a row-level TopK's global row id ``shard * cap +
    row`` depends on). Queries run through the per-shard partial and
    its merge (``warehouse.query.execute_sharded``).

    A ``StandingQueries`` registry attached to the store keeps one
    accumulator slice per shard: right after an ingest lands, each
    shard folds the rows it just received (the contiguous slice
    ``[n_old, n_old + c)`` of its columns), as the reference folds each
    shard's owned rows in its ingest dispatch.

    ``group`` (a ``torch.distributed`` process group, e.g.
    ``launch.mesh.make_shard_group``'s) spreads the shards over its
    ranks: this rank holds shards ``shards`` (``columns`` is ``(k, cap,
    ...)`` for them) and every rank must make the same calls in the same
    order. ``n_rows_by_shard``, ``capacity``, ``t_max`` and
    ``telemetry()`` stay global and the same on every rank;
    ``host_rows()`` and queries are collectives. The group's backend
    must fit ``device`` (NCCL for CUDA, gloo for the CPU) and
    ``n_shards`` must be a multiple of its size, else ``ValueError``."""

    def __init__(self, out_dim: int, n_shards: int, chunk_rows: int = 8192,
                 device=None, group=None):
        assert out_dim >= 1 and n_shards >= 1 and chunk_rows >= 1
        self.device = resolve(device)
        self.out_dim = int(out_dim)
        self.n_shards = int(n_shards)
        self.chunk_rows = int(chunk_rows)
        self.group = group
        self.shards = range(self.n_shards)
        if group is not None:
            from repro_torch.launch.mesh import check_backend, \
                make_shard_group
            check_backend(group, self.device)
            _, self.shards = make_shard_group(self.n_shards, group)
        self.t_max = -1
        self.n_rows_by_shard = np.zeros(self.n_shards, np.int64)
        self.columns = self._empty(0)
        self.obs = store_obs_init()
        self.standing = None

    @classmethod
    def _from_parts(cls, *, columns, n_rows_by_shard, t_max, **kw):
        """Adopt already-partitioned columns without an ingest (what the
        tracer's engines, ``obs.engines``, build their stores with); the
        flight-recorder counters and the standing registry start fresh.
        ``kw`` are the constructor's arguments."""
        self = cls(**kw)
        self.columns, self.t_max = columns, int(t_max)
        self.n_rows_by_shard = np.asarray(n_rows_by_shard, np.int64).copy()
        return self

    def _empty(self, cap: int) -> Dict[str, torch.Tensor]:
        k = len(self.shards)
        cols = {n: torch.zeros((k, cap), dtype=dt, device=self.device)
                for n, dt in SCALAR_COLUMNS}
        cols[OUT_COLUMN] = torch.zeros((k, cap, self.out_dim),
                                       dtype=torch.float32,
                                       device=self.device)
        return cols

    # -- capacity ------------------------------------------------------
    @property
    def capacity(self) -> int:
        """Per-shard row capacity."""
        return self.columns["t"].shape[1]

    @property
    def n_rows(self) -> int:
        return int(self.n_rows_by_shard.sum())

    def _reserve(self, incoming_by_shard: np.ndarray) -> None:
        """Grow every shard's capacity together, along the chunk ladder,
        to fit the incoming per-shard row counts."""
        need = int((self.n_rows_by_shard + incoming_by_shard).max())
        if need <= self.capacity:
            return
        grown = self._empty(_bucket_cap(need, self.chunk_rows))
        for k, col in grown.items():
            col[:, :self.capacity] = self.columns[k]
        self.columns = grown

    # -- ingestion -----------------------------------------------------
    def _owner_counts(self, stream_ids) -> np.ndarray:
        return np.bincount(_host_ints(stream_ids) % self.n_shards,
                           minlength=self.n_shards)

    def _route(self, upd: Dict[str, torch.Tensor], owner: np.ndarray
               ) -> np.ndarray:
        """Write each shard's rows of the update block (``owner[i]`` is
        row i's shard, ``n_shards`` for a row that lands nowhere) at
        consecutive rows from that shard's count, in block order, then
        fold them into the standing queries. Only this rank's shards
        are written; every shard's count moves. Returns the per-shard
        counts."""
        counts = np.bincount(owner, minlength=self.n_shards + 1)[
            :self.n_shards]
        self._reserve(counts)
        upd = {k: upd[k].to(device=self.device, dtype=col.dtype)
               for k, col in self.columns.items()}
        lo = self.n_rows_by_shard.copy()
        for s in self._local(counts):
            rows = np.flatnonzero(owner == s)
            idx = (None if len(rows) == len(owner)    # the whole block
                   else torch.as_tensor(rows, device=self.device))
            j = s - self.shards.start
            for k, col in self.columns.items():
                col[j, lo[s]:lo[s] + counts[s]] = (
                    upd[k] if idx is None else upd[k].index_select(0, idx))
        self.n_rows_by_shard += counts
        self._fold(lo, counts)
        return counts

    def _local(self, counts: np.ndarray) -> np.ndarray:
        """This rank's shards among those with a nonzero count."""
        s = np.flatnonzero(counts)
        return s[(s >= self.shards.start) & (s < self.shards.stop)]

    def _fold(self, lo: np.ndarray, counts: np.ndarray) -> None:
        """Fold each of this rank's shards' new rows ``[lo, lo + count)``,
        as stored, into that shard's slice of every registered standing
        query."""
        reg = self.standing
        if reg is None or not len(reg):
            return
        sstates, sfvals, sspecs = reg.kernel_args()
        for s in self._local(counts):
            c, j = int(counts[s]), s - self.shards.start
            block = {k: col[j, lo[s]:lo[s] + c]
                     for k, col in self.columns.items()}
            mask = torch.ones((c,), dtype=torch.bool, device=self.device)
            _fold_all(tuple(_slot(st, j) for st in sstates), sfvals, block,
                      mask, c, sspecs)
        reg.absorb(sstates)                  # folded in place

    def ingest_fused(self, traces, out_vecs, *, stream_id: int = 0,
                     t0: int = 0) -> int:
        """Land a full single-stream fused run ((n_w, W) trace leaves):
        all T rows go to shard ``stream_id % n_shards``."""
        assert out_vecs.ndim == 2 and out_vecs.shape[1] == self.out_dim
        sub = {src: traces[src][:, None] for src, _ in _RUN_KEYS}
        return self._ingest_multi(sub, torch.as_tensor(out_vecs)[None],
                                  stream_base=stream_id, t0=t0)

    def ingest_fused_multi(self, traces, out_vecs, *, stream_base: int = 0,
                           t0: int = 0) -> int:
        """Land a full multi-stream fused run ((n_w, V, W) leaves):
        stream ``v``'s rows go to shard ``(stream_base + v) % n_shards``."""
        assert out_vecs.ndim == 3 and out_vecs.shape[2] == self.out_dim
        return self._ingest_multi(traces, out_vecs, stream_base=stream_base,
                                  t0=t0)

    def _ingest_multi(self, traces, out_vecs, *, stream_base, t0) -> int:
        V, T = int(out_vecs.shape[0]), int(out_vecs.shape[1])
        owner = np.repeat((stream_base + np.arange(V)) % self.n_shards, T)
        self._route(_multi_rows(traces, out_vecs, stream_base, t0,
                                self.device), owner)
        self.t_max = max(self.t_max, t0 + T - 1)
        store_obs_batch(self.obs, V, T)
        return V * T

    def ingest_tick(self, traces, *, quality, out_vecs, t: int,
                    stream_ids=None, valid=None) -> int:
        """Land one serving-pool tick (slot v is stream v unless
        ``stream_ids`` names the real ids): each row goes to the shard
        owning its stream id, and slots whose ``valid`` is false land
        nothing."""
        V = int(out_vecs.shape[0])
        assert out_vecs.ndim == 2 and out_vecs.shape[1] == self.out_dim
        ids = np.arange(V) if stream_ids is None else _host_ints(stream_ids)
        owner = ids % self.n_shards
        if valid is not None:
            owner = np.where(np.asarray(valid, bool), owner, self.n_shards)
        n_new = int(self._route(_tick_rows(traces, quality, out_vecs, t,
                                           stream_ids, self.device),
                                owner).sum())
        if n_new:
            self.t_max = max(self.t_max, t)
        store_obs_tick(self.obs, n_new)
        return n_new

    def append_rows(self, rows: Dict) -> int:
        """Generic batched append, routed by the rows' own stream ids."""
        n = len(rows["t"])
        assert set(rows) == {c for c, _ in SCALAR_COLUMNS} | {OUT_COLUMN}, \
            "need exactly the store's columns"
        upd = {k: v if isinstance(v, torch.Tensor)
               else torch.as_tensor(np.asarray(v)) for k, v in rows.items()}
        self._route(upd, _host_ints(upd["stream_id"]) % self.n_shards)
        if n:
            self.t_max = max(self.t_max, int(upd["t"].max()))
        store_obs_tick(self.obs, n)
        return n

    # -- reading -------------------------------------------------------
    def shard_source(self):
        """(stacked columns of this rank's shards, their live row counts
        as host ints): what the sharded query engine reads."""
        return self.columns, self.n_rows_by_shard[
            self.shards.start:self.shards.stop].copy()

    def query(self, plan, **kw):
        """Run a query plan through the per-shard partial and its merge
        (``warehouse.query.execute_sharded``)."""
        from repro_torch.warehouse import query as Q
        self.obs["query_dispatches"] += 1
        return Q.execute_sharded(self, plan, **kw)

    def telemetry(self) -> StoreTelemetry:
        """The flight recorder with each shard's rows (its imbalance,
        max / mean shard rows, comes from the host counts)."""
        return StoreTelemetry(rows_by_shard=self.n_rows_by_shard.copy(),
                              **self.obs)

    def host_rows(self) -> Dict[str, np.ndarray]:
        """All live rows as host numpy, shard-major (an explicit full
        transfer). On a group a collective: every rank gathers every
        shard's rows and returns them all."""
        cols = all_shards(self.columns, self.n_rows_by_shard, self.group)
        return {k: np.concatenate([v[s, :n].cpu().numpy() for s, n in
                                   enumerate(self.n_rows_by_shard)])
                for k, v in cols.items()}

    def __len__(self) -> int:
        return self.n_rows

    def __repr__(self) -> str:
        held = ("stacked" if self.group is None else
                 f"{self.shards.start}:{self.shards.stop}")
        return (f"ShardedStore(shards={self.n_shards}[{held}], "
                f"rows={self.n_rows_by_shard.tolist()}, "
                f"cap={self.capacity}, out_dim={self.out_dim}, "
                f"chunk={self.chunk_rows}, device={self.device})")
