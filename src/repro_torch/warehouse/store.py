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
from repro_torch.warehouse.standing import _fold_all

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

        def flat(x):                              # (n_w, V, W) -> (V*T,)
            return x.transpose(0, 1).reshape(V, -1)[:, :T].reshape(-1)

        upd = {dst: flat(traces[src]) for src, dst in _RUN_KEYS}
        ar = torch.arange(T, dtype=torch.int32, device=self.device)
        upd["stream_id"] = stream_base + torch.arange(
            V, dtype=torch.int32, device=self.device).repeat_interleave(T)
        upd["t"] = (t0 + ar).repeat(V)
        upd[OUT_COLUMN] = torch.as_tensor(out_vecs).reshape(V * T, -1)
        self._write(upd)
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
        upd = {dst: traces[src] for src, dst in _RUN_KEYS}
        upd["quality"] = torch.as_tensor(quality)
        upd["stream_id"] = (torch.arange(V, dtype=torch.int32)
                            if stream_ids is None
                            else torch.as_tensor(np.asarray(stream_ids)))
        upd["t"] = torch.full((V,), t, dtype=torch.int32)
        upd[OUT_COLUMN] = torch.as_tensor(out_vecs)
        upd = {k: v.to(self.device) for k, v in upd.items()}
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
