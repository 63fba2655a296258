"""Warehouse tiering: the port of ``repro/warehouse/tiers.py``'s
``TieredStore`` (one store; the sharded tier and checkpoints come later).

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
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.distribution.compression import dequantize, quantize_int8
from repro_torch.obs.telemetry import StoreTelemetry
from repro_torch.warehouse.store import SegmentStore


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
