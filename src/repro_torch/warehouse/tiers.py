"""Warehouse tiering and persistence: the port of
``repro/warehouse/tiers.py`` (``TieredStore``, ``ShardedTieredStore``,
``save_warehouse`` / ``load_warehouse``).

Hot tier: a float32 ``SegmentStore``. Cold tier: its oldest whole
chunks spilled to int8, one quantization scale per chunk and float
column (``distribution.compression.quantize_int8``, so a cold value is
within its chunk's scale, max|x| / 127, of the original). Integer
columns spill losslessly.

Queries run over both tiers: ``materialize`` dequantizes the cold chunks
and concatenates them in front of the hot columns, and the query engine
(with K1, ``kernels/warehouse_agg``) scans that view. The view is
memoized until the next ingest or spill.

The stochastic rounding's uniform draws come from a CPU
``torch.Generator`` seeded from the tier's ``seed`` and its cold row
count, so a spill gives the same codes on every device. They are not
the reference's ``jax.random`` draws (a deliberate difference; the
error bound is the same).

``ShardedTieredStore`` tiers a ``ShardedStore`` per shard: each shard
spills its own oldest whole chunks (ragged depths, its own scales), the
cold blocks live in one stacked array with a per-shard valid depth, and
each shard's two-tier rows are its cold rows followed by its hot rows.
Over a store spread on a ``torch.distributed`` group each rank spills
and holds its own shards, with the same per-shard draws, so the codes
are the stacked tier's bit for bit.
``save_warehouse`` / ``load_warehouse`` write and read a ``TieredStore``
in the reference's checkpoint format (``checkpoint.ckpt``), so either
package restores the other's files.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.device import resolve
from repro_torch.distribution.compression import dequantize, quantize_int8
from repro_torch.obs.telemetry import StoreTelemetry
from repro_torch.warehouse.store import (SegmentStore, ShardedStore,
                                         _bucket_cap)


def _tier_obs_init():
    """The tier's host counters (see ``telemetry()``): chunk spills and
    cold-tier dequantizes (``materialize`` cache misses)."""
    return {"spill_events": 0, "spilled_rows": 0, "dequantize_events": 0}


def _quantize_chunks(cols, draws: Callable, *, n: int, chunk: int):
    """Quantize the first ``n`` rows (whole chunks) of every float
    column to int8, one scale per chunk; integer columns pass through.
    An output row block (chunk, D) shares its chunk's scale.
    ``draws(name, n_chunks, width)`` returns the (n_chunks, width)
    uniform draws of column ``name``. Returns (codes, scales, ints)."""
    n_chunks = n // chunk
    q, scales, ints = {}, {}, {}
    for name, col in cols.items():
        block = col[:n]
        if col.dtype == torch.float32:
            flat = block.reshape(n_chunks, -1)
            qq, ss = quantize_int8(flat, draws(name, *flat.shape))
            q[name] = qq.reshape(block.shape)
            scales[name] = ss
        else:
            ints[name] = block.clone()
    return q, scales, ints


def _compact(cols, *, n_spill: int) -> None:
    """Drop the spilled prefix from the hot tier, in place: the
    survivors shift to row 0 and the tail is zeroed (capacity kept)."""
    for v in cols.values():
        cap = v.shape[0]
        v[:cap - n_spill] = v[n_spill:].clone()
        v[cap - n_spill:] = 0


def _materialize(cold_q, cold_scales, cold_int, hot_cols, *, chunk: int):
    """The two-tier view the query engine scans: dequantized cold rows
    followed by the hot columns."""
    out = {}
    for name, hot in hot_cols.items():
        if name in cold_q:
            qq = cold_q[name]
            deq = dequantize(qq.reshape(qq.shape[0] // chunk, -1),
                             cold_scales[name])
            cold = deq.reshape(qq.shape).to(hot.dtype)
        else:
            cold = cold_int[name]
        out[name] = torch.cat([cold, hot])
    return out


class TieredStore:
    """A ``SegmentStore`` hot tier plus an int8 cold tier it spills to,
    on ``device`` (``None`` means CUDA), the hot store's device."""

    def __init__(self, hot: SegmentStore, seed: int = 0, device=None):
        if resolve(device) != hot.device:
            raise ValueError(f"the tier runs on {resolve(device)} and its "
                             f"hot store on {hot.device}")
        self.hot = hot
        self.seed = int(seed)
        self.n_cold = 0
        self.cold_q: Dict[str, torch.Tensor] = {}
        self.cold_scales: Dict[str, torch.Tensor] = {}
        self.cold_int: Dict[str, torch.Tensor] = {}
        # the memoized two-tier view, keyed on the hot columns (a grown
        # store replaces them), the hot and the cold row counts
        self._mat_cache = None
        self.tier_obs = _tier_obs_init()

    @property
    def n_rows(self) -> int:
        return self.n_cold + self.hot.n_rows

    @property
    def t_max(self) -> int:
        return self.hot.t_max

    def _draws(self) -> Callable:
        """The spill's rounding draws: a CPU generator seeded from the
        tier's seed and cold row count, one draw per float column in
        column order, moved to the device."""
        g = torch.Generator().manual_seed(self.seed * 1_000_003 + self.n_cold)

        def draw(name, n_chunks, width):
            return torch.rand((n_chunks, width), generator=g).to(
                self.hot.device)
        return draw

    def spill(self, keep_hot: int, draws: Callable = None) -> int:
        """Move the oldest whole chunks to the cold tier until at most
        ``keep_hot`` rows (rounded up to a chunk) stay hot. Returns the
        number of rows spilled. ``draws`` (name, n_chunks, width) ->
        uniforms overrides the tier's own draws (a test passes the
        reference's).

        Standing queries are spill-invariant: every row's float32 value
        was folded into the registered partials when it was ingested, so
        demoting rows to int8 afterwards leaves every registered answer
        as it was; only rescans (and backfills of plans registered after
        the spill) read the quantized values."""
        assert keep_hot >= 0, keep_hot
        chunk = self.hot.chunk_rows
        n_spill = ((self.hot.n_rows - keep_hot) // chunk) * chunk
        if n_spill <= 0:
            return 0
        q, scales, ints = _quantize_chunks(
            self.hot.columns, draws or self._draws(), n=n_spill, chunk=chunk)
        if self.n_cold:
            q = {k: torch.cat([self.cold_q[k], v]) for k, v in q.items()}
            scales = {k: torch.cat([self.cold_scales[k], v])
                      for k, v in scales.items()}
            ints = {k: torch.cat([self.cold_int[k], v])
                    for k, v in ints.items()}
        self.cold_q, self.cold_scales, self.cold_int = q, scales, ints
        self.n_cold += n_spill
        _compact(self.hot.columns, n_spill=n_spill)
        self.hot.n_rows -= n_spill
        self.tier_obs["spill_events"] += 1
        self.tier_obs["spilled_rows"] += n_spill
        return n_spill

    def materialize(self) -> Tuple[Dict[str, torch.Tensor], int]:
        """(columns, n_rows) spanning both tiers, what the query engine
        scans; the valid rows are a prefix (cold rows oldest first, then
        the hot live rows). Memoized: queries between ingests and spills
        reuse the view instead of dequantizing again."""
        if self.n_cold == 0:
            return self.hot.columns, self.hot.n_rows
        key = (id(self.hot.columns), self.hot.n_rows, self.n_cold)
        c = self._mat_cache
        if c is not None and c[0] == key:
            return c[1], self.n_rows
        cols = _materialize(self.cold_q, self.cold_scales, self.cold_int,
                            self.hot.columns, chunk=self.hot.chunk_rows)
        self._mat_cache = (key, cols)
        self.tier_obs["dequantize_events"] += 1
        return cols, self.n_rows

    @property
    def standing(self):
        """The hot store's ``StandingQueries`` registry (``StandingQueries
        (tiered_store)`` attaches there: the hot tier's ingests fold,
        backfills scan the two-tier view)."""
        return self.hot.standing

    def query(self, plan, **kw):
        """Run a query plan over both tiers (``warehouse.query``)."""
        from repro_torch.warehouse import query as Q
        self.hot.obs["query_dispatches"] += 1
        return Q.execute(self, plan, **kw)

    def telemetry(self) -> StoreTelemetry:
        """The hot tier's flight recorder with the tier counters: rows
        span both tiers; a dequantize event is a ``materialize`` cache
        miss."""
        return dataclasses.replace(
            self.hot.telemetry(), rows_by_shard=np.asarray([self.n_rows]),
            **self.tier_obs)

    def max_cold_scale(self) -> float:
        """The largest per-chunk scale of the cold tier: the bound on a
        cold value's quantization error."""
        if not self.cold_scales:
            return 0.0
        return max(float(s.max()) for s in self.cold_scales.values())

    def __repr__(self) -> str:
        return (f"TieredStore(hot={self.hot.n_rows}, cold={self.n_cold}, "
                f"chunk={self.hot.chunk_rows})")


# ---------------------------------------------------------------------------
# sharded tiering: every shard spills its own oldest chunks
# ---------------------------------------------------------------------------

def _quantize_chunks_sharded(cols, draws: Callable, *, n: int, chunk: int):
    """``_quantize_chunks`` on every shard: the first ``n`` rows of each
    shard's (S, cap, ...) block, one scale per (shard, chunk).
    ``draws(name, S, n_chunks, width)`` returns (S, n_chunks, width)
    uniforms. Returns (codes, scales (S, n // chunk), ints)."""
    first = next(iter(cols.values()))
    S = first.shape[0]
    flat = {k: v[:, :n].reshape((S * n,) + v.shape[2:])
            for k, v in cols.items()}

    def per_shard(name, n_chunks, width):
        return draws(name, S, n_chunks // S, width).reshape(n_chunks, width)

    q, scales, ints = _quantize_chunks(flat, per_shard, n=S * n, chunk=chunk)
    q = {k: v.reshape((S, n) + v.shape[1:]) for k, v in q.items()}
    scales = {k: v.reshape(S, n // chunk) for k, v in scales.items()}
    ints = {k: v.reshape((S, n) + v.shape[1:]) for k, v in ints.items()}
    return q, scales, ints


def _cold_write(dst, src, off) -> None:
    """Write each shard's spill block at that shard's own cold offset,
    in place (``dst`` / ``src`` are dicts of (S, cap, ...) / (S, n, ...)
    tensors, ``off`` host ints). Rows past a shard's own spill depth are
    junk beyond its valid cold count until a later spill overwrites
    them; the caller reserves ``n`` rows past every offset, so no write
    runs past the end."""
    for k, d in dst.items():
        n = src[k].shape[1]
        for s, o in enumerate(off):
            d[s, o:o + n] = src[k][s].to(d.dtype)


def _compact_ragged(cols, d) -> None:
    """Drop the first ``d[s]`` rows of every shard's hot block, in place:
    the survivors shift to row 0 and the tail is zeroed (capacity
    kept)."""
    for v in cols.values():
        cap = v.shape[1]
        for s, n in enumerate(d):
            if n:
                v[s, :cap - n] = v[s, n:].clone()
                v[s, cap - n:] = 0


def _materialize_sharded(cold_q, cold_scales, cold_int, hot_cols, c, *,
                         chunk: int):
    """The two-tier view with per-shard cold depths ``c``: each shard's
    dequantized cold block, then its hot block written at its own cold
    depth ``c[s]``, so each shard's valid rows stay a prefix (as the
    reference's ``dynamic_update_slice`` lays them out)."""
    out = {}
    for name, hot in hot_cols.items():
        if name in cold_q:
            qq = cold_q[name]
            S, cap = qq.shape[:2]
            deq = dequantize(qq.reshape(S * cap // chunk, -1),
                             cold_scales[name].reshape(-1))
            cold = deq.reshape(qq.shape).to(hot.dtype)
        else:
            cold = cold_int[name]
        view = torch.cat([cold, torch.zeros_like(hot)], dim=1)
        for s, cs in enumerate(c):
            view[s, cs:cs + hot.shape[1]] = hot[s]
        out[name] = view
    return out


class ShardedTieredStore:
    """Hot / cold tiering over a ``ShardedStore`` on ``device`` (``None``
    means CUDA), the hot store's device. The spill is per shard and
    ragged: each shard quantizes however many of its own oldest whole
    chunks exceed ``keep_hot``, so an imbalanced or empty shard never
    holds the others back. The cold tier is one stacked array, grown
    along the ``_bucket_cap`` ladder, with a per-shard valid depth;
    queries span both tiers through ``execute_sharded`` on the two-tier
    view (``shard_source``, memoized until the next ingest or spill).

    The rounding draws come from a CPU ``torch.Generator`` per shard,
    seeded from the tier's seed, its spill count and the shard; a test
    passes the reference's through ``spill(draws=)``.

    Over a hot store spread on a group, each rank spills and holds its
    own shards (``cold_*`` are ``(k, ...)``); the per-shard counts,
    ``telemetry()`` and ``max_cold_scale()`` stay global, and every rank
    makes the same calls."""

    def __init__(self, hot: ShardedStore, seed: int = 0, device=None):
        if resolve(device) != hot.device:
            raise ValueError(f"the tier runs on {resolve(device)} and its "
                             f"hot store on {hot.device}")
        self.hot = hot
        self.seed = int(seed)
        self._spills = 0
        self.n_cold_by_shard = np.zeros(hot.n_shards, np.int64)
        self.cold_q: Dict[str, torch.Tensor] = {}
        self.cold_scales: Dict[str, torch.Tensor] = {}
        self.cold_int: Dict[str, torch.Tensor] = {}
        self._mat_cache = None
        self.tier_obs = _tier_obs_init()

    @property
    def n_shards(self) -> int:
        return self.hot.n_shards

    @property
    def shards(self) -> range:
        """The shards this rank holds (all of them without a group)."""
        return self.hot.shards

    @property
    def group(self):
        return self.hot.group

    def _mine(self, per_shard: np.ndarray) -> np.ndarray:
        """This rank's slice of a per-shard host array."""
        return per_shard[self.shards.start:self.shards.stop]

    @property
    def n_rows(self) -> int:
        return int(self.n_cold_by_shard.sum()) + self.hot.n_rows

    @property
    def t_max(self) -> int:
        return self.hot.t_max

    @property
    def cold_capacity(self) -> int:
        return self.cold_q["quality"].shape[1] if self.cold_q else 0

    def _cold_reserve(self, need: int) -> None:
        """Grow the stacked cold arrays along the stores' capacity ladder
        to hold ``need`` rows a shard."""
        cap = self.cold_capacity
        if need <= cap:
            return
        chunk, S = self.hot.chunk_rows, len(self.shards)
        new_cap = _bucket_cap(need, chunk)

        def grown(old, shape, dtype, rows):
            new = torch.zeros(shape, dtype=dtype, device=self.hot.device)
            if old is not None:
                new[:, :rows] = old
            return new

        for name, col in self.hot.columns.items():
            tail = tuple(col.shape[2:])
            if col.dtype == torch.float32:
                self.cold_q[name] = grown(self.cold_q.get(name),
                                          (S, new_cap) + tail, torch.int8,
                                          cap)
                self.cold_scales[name] = grown(
                    self.cold_scales.get(name), (S, new_cap // chunk),
                    torch.float32, cap // chunk)
            else:
                self.cold_int[name] = grown(self.cold_int.get(name),
                                            (S, new_cap) + tail, col.dtype,
                                            cap)

    def _draws(self) -> Callable:
        """This spill's rounding draws: one CPU generator per shard this
        rank holds, seeded from the tier's seed, its spill count and the
        shard; each float column draws in column order."""
        gens = [torch.Generator().manual_seed(
            (self.seed * 1_000_003 + self._spills) * 1_009 + s)
            for s in self.shards]

        def draw(name, S, n_chunks, width):
            return torch.stack([torch.rand((n_chunks, width), generator=g)
                                for g in gens]).to(self.hot.device)
        return draw

    def spill(self, keep_hot: int, draws: Callable = None) -> int:
        """Move each shard's oldest whole chunks to its cold tier until at
        most ``keep_hot`` rows (rounded up to a chunk) stay hot on it.
        Returns the rows spilled (on every shard).
        ``draws(name, S, n_chunks, width)`` overrides the tier's own
        uniforms with every shard's (a test passes the reference's); a
        rank takes its own shards' rows of them.

        Every shard quantizes the deepest shard's depth (the reference's
        fixed block), written at its own cold offset: the rows past its
        own depth are junk past its valid count, overwritten by a later
        spill. The cold tier is reserved for that whole block past every
        shard's offset. Standing answers are spill-invariant, as on
        ``TieredStore.spill``."""
        assert keep_hot >= 0, keep_hot
        chunk = self.hot.chunk_rows
        d = np.maximum(
            ((self.hot.n_rows_by_shard - keep_hot) // chunk) * chunk, 0)
        d_max = int(d.max())
        if d_max <= 0:
            return 0
        self._cold_reserve(int((self.n_cold_by_shard + d_max).max()))
        draw = self._draws()
        if draws is not None:
            def draw(name, S, n_chunks, width):
                return draws(name, self.n_shards, n_chunks, width)[
                    self.shards.start:self.shards.stop]
        q, scales, ints = _quantize_chunks_sharded(
            self.hot.columns, draw, n=d_max, chunk=chunk)
        self._spills += 1
        off = self._mine(self.n_cold_by_shard)
        _cold_write(self.cold_q, q, off)
        _cold_write(self.cold_int, ints, off)
        _cold_write(self.cold_scales, scales, off // chunk)
        _compact_ragged(self.hot.columns, self._mine(d))
        self.hot.n_rows_by_shard = self.hot.n_rows_by_shard - d
        self.n_cold_by_shard = self.n_cold_by_shard + d
        self.tier_obs["spill_events"] += 1
        self.tier_obs["spilled_rows"] += int(d.sum())
        return int(d.sum())

    def shard_source(self):
        """(stacked columns of this rank's shards spanning both tiers,
        their live row counts): each shard's rows are its cold rows, then
        its hot rows. Memoized until the next ingest or spill."""
        if not self.n_cold_by_shard.any():
            return self.hot.shard_source()
        counts = self._mine(self.n_cold_by_shard + self.hot.n_rows_by_shard)
        key = (id(self.hot.columns), tuple(self.hot.n_rows_by_shard),
               tuple(self.n_cold_by_shard))
        c = self._mat_cache
        if c is not None and c[0] == key:
            return c[1], counts
        cols = _materialize_sharded(self.cold_q, self.cold_scales,
                                    self.cold_int, self.hot.columns,
                                    self._mine(self.n_cold_by_shard),
                                    chunk=self.hot.chunk_rows)
        self._mat_cache = (key, cols)
        self.tier_obs["dequantize_events"] += 1
        return cols, counts

    @property
    def standing(self):
        """The hot store's ``StandingQueries`` registry (see
        ``TieredStore.standing``)."""
        return self.hot.standing

    def query(self, plan, **kw):
        """Run a query plan over both tiers (``execute_sharded``)."""
        from repro_torch.warehouse import query as Q
        self.hot.obs["query_dispatches"] += 1
        return Q.execute_sharded(self, plan, **kw)

    def telemetry(self) -> StoreTelemetry:
        """The hot store's flight recorder with the tier counters; each
        shard's rows count both tiers."""
        return dataclasses.replace(
            self.hot.telemetry(),
            rows_by_shard=self.hot.n_rows_by_shard + self.n_cold_by_shard,
            **self.tier_obs)

    def max_cold_scale(self) -> float:
        """The largest (shard, chunk) scale of the cold tier: the bound
        on a cold value's quantization error (over every rank's shards:
        a collective on a group)."""
        if not self.cold_scales:
            return 0.0
        top = torch.stack([v.max() for v in self.cold_scales.values()]).max()
        if self.group is not None:
            from repro_torch.launch.mesh import all_gather_blocks
            top = all_gather_blocks([top[None]], self.group)[0].max()
        return float(top)

    def __repr__(self) -> str:
        return (f"ShardedTieredStore(shards={self.n_shards}, "
                f"hot={self.hot.n_rows_by_shard.tolist()}, "
                f"cold={self.n_cold_by_shard.tolist()}, "
                f"chunk={self.hot.chunk_rows})")


# ---------------------------------------------------------------------------
# persistence (through checkpoint.ckpt, the reference's file format)
# ---------------------------------------------------------------------------

def save_warehouse(path: str, ts: TieredStore) -> str:
    """Atomic save of both tiers in the reference's format (its tree and
    meta keys); returns the file's path."""
    tree = {"hot": ts.hot.columns}
    if ts.n_cold:
        tree["cold"] = {"q": ts.cold_q, "scales": ts.cold_scales,
                        "ints": ts.cold_int}
    meta = {"n_rows": ts.hot.n_rows, "t_max": ts.hot.t_max,
            "out_dim": ts.hot.out_dim, "chunk_rows": ts.hot.chunk_rows,
            "n_cold": ts.n_cold, "seed": ts.seed}
    return ckpt.save(path, tree, meta=meta)


def load_warehouse(path: str, device=None) -> TieredStore:
    """A ``save_warehouse`` file (the port's or the reference's) as a
    fresh ``TieredStore`` on ``device`` (``None`` means CUDA). Columns
    come back in the store's own order, so later spills draw as the
    saved store's would."""
    tree, meta = ckpt.restore(path, device=device, return_meta=True)
    assert meta is not None, f"{path} is not a warehouse checkpoint"
    hot = SegmentStore(meta["out_dim"], chunk_rows=meta["chunk_rows"],
                       device=device)
    hot.columns = {k: tree["hot"][k] for k in hot.columns}
    hot.n_rows = meta["n_rows"]
    hot.t_max = meta["t_max"]
    ts = TieredStore(hot, seed=meta["seed"], device=device)
    ts.n_cold = meta["n_cold"]
    if ts.n_cold:
        cold = tree["cold"]
        ts.cold_q = {k: cold["q"][k] for k in hot.columns if k in cold["q"]}
        ts.cold_scales = {k: cold["scales"][k] for k in ts.cold_q}
        ts.cold_int = {k: cold["ints"][k] for k in hot.columns
                       if k in cold["ints"]}
    return ts
