"""Queries over the warehouse (the paper's "easy to query").

Port of ``repro/warehouse/query.py`` on one device. A query is a tuple
of plan nodes applied left to right:

    Filter(column, op, value)   row predicate; ANDed into the row mask
    Project(columns)            keep only the named columns
    GroupBy(key, value, agg)    per-key aggregation, fixed group count
    WindowAgg(window, value)    same, keyed by time window t // window
    MultiGroupBy(keys, value)   multi-key aggregation via fused key ids
    TopK(k, by)                 the k rows extremal in ``by`` (IEEE total
                                order, ties by ascending row index)

An aggregating plan runs as partial -> finalize: the rows up to the
first reducing node reduce to ``{"acc", "cnt"}`` accumulators, which
``_seg_finalize`` turns into the answer (empty-group contract: 0.0,
count 0, masked-off row, for every agg), then the nodes after it run on
the small result table.

The partial has two paths, chosen per plan by ``use_kernel`` (see
``_resolve_use_kernel``): the fused kernel ``kernels.warehouse_agg``
(on CUDA the hand-written kernel, on the CPU its plain version), or the
engine's own ``_seg_partial`` after the row-by-row filter nodes. On the
card, the engine computes an aggregation only when the caller asks for
it with ``use_kernel=False``.
``execute`` returns ``(table, mask)``: tensors on the store's device plus
a validity mask over their rows.

A sharded store (``ShardedStore``, ``ShardedTieredStore``) runs through
``execute_sharded``: one partial per shard over its stacked columns
(on CUDA columns K1, one launch per shard), merged by sum / max / min
over the shard axis, or by concatenation for TopK candidates and row
plans; then the same finalize and post nodes. The reference's stacked
single-device path, in its merge order. On a store spread over a
``torch.distributed`` group each rank computes its own shards'
partials and gathers every shard's in shard order
(``launch.mesh.all_gather_blocks``) before the same merge, so every
rank's answer is the stacked store's bit for bit: the reference's
``shard_map`` path with its psum / pmax / all_gather, but with float
sums added in shard order (an all-reduce adds in the backend's order).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from fractions import Fraction
from typing import Dict, Tuple, Union

import numpy as np
import torch

from repro_torch.distribution.compression import quantize_int8
from repro_torch.kernels.warehouse_agg import (CMP as _CMP, FusedAggSpec,
                                               check_kernel, filter_pred,
                                               fused_segment_agg, group_ids,
                                               masked_fold, masked_partial)

# how many aggregating queries took each path through ``execute``
PATHS = {"kernel": 0, "engine": 0}


@dataclass(frozen=True)
class Filter:
    """Row predicate plan node: keep rows where ``column <op> value``."""
    column: str
    op: str              # eq | ne | lt | le | gt | ge
    value: float


@dataclass(frozen=True)
class Project:
    """Column-selection plan node: restrict downstream nodes to
    ``columns``."""
    columns: Tuple[str, ...]


@dataclass(frozen=True)
class GroupBy:
    """Grouped aggregation over an integer key column, fixed
    ``num_groups`` output rows."""
    key: str             # integer column holding the group id
    value: str           # column to aggregate
    agg: str = "sum"     # sum | mean | count | max | min
    num_groups: int = 8  # group ids clip into [0, num_groups)


@dataclass(frozen=True)
class WindowAgg:
    """Time-window aggregation: group rows by ``t // window`` into
    ``num_windows`` fixed slots."""
    window: int
    value: str
    agg: str = "sum"
    num_windows: int = 64


@dataclass(frozen=True)
class MultiGroupBy:
    """Aggregate by SEVERAL integer keys at once, the key tuple fused
    into one flat id. ``nums[i]`` is the id count of ``keys[i]`` (ids
    clip into [0, nums[i]) after windowing); ``windows[i] > 1`` divides
    that key's column first. The result has one decoded id column per
    key plus the aggregated value and ``count``."""
    keys: Tuple[str, ...]
    value: str
    agg: str = "sum"
    nums: Tuple[int, ...] = ()
    windows: Tuple[int, ...] = ()


@dataclass(frozen=True)
class TopK:
    """Row-level top-k: the ``k`` rows extremal in ``by``."""
    k: int
    by: str
    largest: bool = True


PlanNode = Union[Filter, Project, GroupBy, WindowAgg, MultiGroupBy, TopK]

# nodes that reduce rows — a plan splits at the FIRST of these
_REDUCERS = (GroupBy, WindowAgg, MultiGroupBy, TopK)


@dataclass(frozen=True)
class _FilterRef:
    """Filter with its value hoisted into the operand vectors."""
    column: str
    op: str
    idx: int


def normalize(plan):
    """Split a plan into its shape (hashable spec) and the filter
    operands as host numpy vectors: the float32 thresholds (float
    columns) plus each threshold's float64-computed floor, integrality
    and out-of-int32-range flag (integer columns; float32 cannot hold
    ints past 2^24, so they are hoisted at full precision)."""
    spec, vals, floors, isint, oob = [], [], [], [], []
    for node in plan:
        if isinstance(node, Filter):
            assert node.op in _CMP, f"unknown filter op {node.op!r}"
            spec.append(_FilterRef(node.column, node.op, len(vals)))
            v = float(node.value)
            assert not math.isnan(v), "NaN filter threshold"
            vals.append(np.float32(v))
            if v >= 2.0 ** 31:                 # incl. +inf
                ob, fl, ii = 1, 0, False
            elif v < -2.0 ** 31:               # incl. -inf
                ob, fl, ii = -1, 0, False
            else:
                ob, fl = 0, math.floor(v)      # in [-2^31, 2^31 - 1]
                ii = v == fl
            floors.append(np.int32(fl))
            isint.append(ii)
            oob.append(np.int32(ob))
        else:
            if isinstance(node, MultiGroupBy):
                assert len(node.keys) >= 1 and \
                    len(node.nums) == len(node.keys), \
                    "MultiGroupBy needs one id count per key"
                assert not node.windows or \
                    len(node.windows) == len(node.keys), \
                    "MultiGroupBy windows must match keys"
            spec.append(node)
    return tuple(spec), (np.asarray(vals, np.float32),
                         np.asarray(floors, np.int32),
                         np.asarray(isint, bool),
                         np.asarray(oob, np.int32))


def _agg_keys(node):
    """``(column, num_ids, window)`` per key of an aggregating node."""
    if isinstance(node, GroupBy):
        return ((node.key, node.num_groups, 0),)
    if isinstance(node, WindowAgg):
        return (("t", node.num_windows, node.window),)
    wins = node.windows or (0,) * len(node.keys)
    return tuple(zip(node.keys, node.nums, wins))


def _seg_ids(table, node):
    """Clipped int64 group ids + group count for an agg node."""
    keys = _agg_keys(node)
    n = table[keys[0][0]].shape[0]
    return group_ids(table, n, keys), math.prod(num for _, num, _ in keys)


def _seg_partial(table, mask, node):
    """Masked segment accumulators of an agg node: {"acc", "cnt"}.
    Filtered and padding rows are exact no-ops."""
    ids, num = _seg_ids(table, node)
    return masked_partial(ids, mask, table[node.value], num, node.agg)


def _seg_fold(part, table, mask, node):
    """Fold a batch of NEW rows into a stored partial, in place: the
    scatter ``_seg_partial`` runs over fresh accumulators runs here over
    the STORED ones, so each group's float32 addition sequence continues
    where the last fold stopped. A backfill and any number of later folds
    therefore give the accumulators one ``_seg_partial`` over all rows in
    ingest order would, bit for bit (the standing queries' exactness
    contract, ``warehouse.standing``); max, min and count are exact in
    any order."""
    ids, _ = _seg_ids(table, node)
    return masked_fold(part, ids, mask, table[node.value], node.agg)


def _num_groups(node) -> int:
    """Result rows of an aggregating node."""
    if isinstance(node, GroupBy):
        return node.num_groups
    if isinstance(node, WindowAgg):
        return node.num_windows
    return math.prod(node.nums)                      # MultiGroupBy


def _seg_finalize(acc, cnt, agg):
    """Accumulators -> the agg's answer. Empty-group contract: a group
    with no surviving rows answers 0.0 with ``count == 0`` for EVERY agg
    — the ∓inf sentinels of max/min never reach a result table."""
    if agg == "mean":
        c = torch.clamp_min(cnt, 1.0)
        out = acc / (c if acc.ndim == cnt.ndim else c[:, None])
    elif agg == "count":
        out = cnt
    elif agg in ("max", "min"):
        out = torch.where(cnt > 0, acc, 0.0)
    else:
        out = acc
    return out, cnt


def _seg_table(node, out, cnt):
    """Result table + mask for a finalized aggregation."""
    dev = cnt.device
    if isinstance(node, GroupBy):
        table = {node.key: torch.arange(node.num_groups, dtype=torch.int32,
                                        device=dev)}
    elif isinstance(node, WindowAgg):
        table = {"window": torch.arange(node.num_windows, dtype=torch.int32,
                                        device=dev)}
    else:                                            # MultiGroupBy
        rem = torch.arange(math.prod(node.nums), dtype=torch.int32,
                           device=dev)
        decoded = {}
        for key, n in zip(reversed(node.keys), reversed(node.nums)):
            decoded[key] = rem % n
            rem = torch.div(rem, n, rounding_mode="floor")
        table = {k: decoded[k] for k in node.keys}
    table[node.value] = out
    table["count"] = cnt
    return table, cnt > 0


def _topk_idx(score: torch.Tensor, kk: int) -> torch.Tensor:
    """``lax.top_k``'s order: descending IEEE-754 TOTAL order (``+0.0``
    above ``-0.0``), ties by ascending row index. Flipping the low 31
    bits of negative floats makes their int32 bit patterns sort as the
    floats' total order; a stable descending sort keeps ties in row
    order."""
    bits = score.contiguous().view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    return torch.sort(key, descending=True, stable=True).indices[:kk]


def _apply_nodes(table, mask, fvals, spec):
    """Run plan nodes left to right on a table (the engine path)."""
    for node in spec:
        if isinstance(node, _FilterRef):
            mask = mask & filter_pred(table[node.column], node.op, node.idx,
                                      fvals)
        elif isinstance(node, Project):
            table = {c: table[c] for c in node.columns}
        elif isinstance(node, (GroupBy, WindowAgg, MultiGroupBy)):
            part = _seg_partial(table, mask, node)
            out, cnt = _seg_finalize(part["acc"], part["cnt"], node.agg)
            table, mask = _seg_table(node, out, cnt)
        elif isinstance(node, TopK):
            score = torch.where(mask, table[node.by].to(torch.float32),
                                float("-inf"))
            if not node.largest:
                score = torch.where(torch.isfinite(score), -score, score)
            idx = _topk_idx(score, min(node.k, int(score.shape[0])))
            table = {c: table[c].index_select(0, idx) for c in table}
            table["index"] = idx.to(torch.int32)
            mask = torch.isfinite(score.index_select(0, idx))
        else:
            raise TypeError(f"unknown plan node {node!r}")
    return table, mask


def split_plan(spec):
    """(pre, reduce_node, post): row-local Filter/Project nodes, the
    first reducing node, and the nodes that run on its result."""
    for i, node in enumerate(spec):
        if isinstance(node, _REDUCERS):
            return spec[:i], node, spec[i + 1:]
    return spec, None, ()


def _kernel_spec(pre, node, cols):
    """``FusedAggSpec`` for a plan's partial phase, or None when the
    fused kernel cannot express it: no reducer, a TopK reducer, wide
    max/min, or a pre-node naming columns the engine path would reject
    (Project order is honored)."""
    if node is None or isinstance(node, TopK):
        return None
    avail = set(cols)
    filters = []
    for nd in pre:
        if isinstance(nd, _FilterRef):
            if nd.column not in avail:
                return None
            filters.append((nd.column, nd.op, nd.idx))
        elif isinstance(nd, Project):
            if not set(nd.columns) <= avail:
                return None
            avail = set(nd.columns)
        else:
            return None
    keys = _agg_keys(node)
    if not {k for k, _, _ in keys} | {node.value} <= avail:
        return None
    if cols[node.value].ndim == 2 and node.agg in ("max", "min"):
        return None
    return FusedAggSpec(filters=tuple(filters), keys=keys,
                        value=node.value, agg=node.agg)


def _value_width(cols, aspec) -> int:
    v = cols[aspec.value]
    return int(v.shape[1]) if v.ndim == 2 else 0


def _resolve_use_kernel(flag, pre, node, cols) -> bool:
    """Which path computes a plan's partial:

    - ``False``: the engine's ``_seg_partial``, on any device;
    - ``True``: the fused kernel's wrapper; raises ``ValueError`` when
      the plan has no fused spec (no reducer, TopK reducer, wide
      max/min) or the kernel cannot take its spec (``check_kernel``
      names the limit), on the CPU as on the card;
    - ``None`` with a fused spec: the wrapper. On CUDA columns that is
      the kernel, or a ``ValueError`` naming the limit the spec passed;
      never the engine. On CPU columns it is the kernel's plain version.
    - ``None`` without a fused spec: the engine. Such a plan does not
      aggregate, reduces by TopK, or asks for max/min of a wide column,
      which the engine refuses too; none of it is the kernel's work.
    """
    if flag is not None and not flag:
        return False
    aspec = _kernel_spec(pre, node, cols)
    if aspec is None:
        if flag:
            raise ValueError("use_kernel=True: the fused kernel cannot run "
                             f"this plan ({node!r})")
        return False
    if flag or cols[aspec.value].device.type == "cuda":
        check_kernel(aspec, _value_width(cols, aspec))
    return True


def _run_plan(cols, n_rows: int, fvals, spec, use_kernel: bool):
    if use_kernel:
        pre, node, post = split_plan(spec)
        part = fused_segment_agg(cols, n_rows, fvals,
                                 _kernel_spec(pre, node, cols))
        out, cnt = _seg_finalize(part["acc"], part["cnt"], node.agg)
        table, mask = _seg_table(node, out, cnt)
        return _apply_nodes(table, mask, fvals, post)
    first = cols["t"] if "t" in cols else next(iter(cols.values()))
    mask = torch.arange(first.shape[0], device=first.device) < n_rows
    return _apply_nodes(cols, mask, fvals, spec)


# ---------------------------------------------------------------------------
# sharded execution: per-shard partials + their merge
# ---------------------------------------------------------------------------

def _merge_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the leading shard axis in shard order, ((p0 + p1) + p2)
    + ..., the order the reference's stacked axis-0 sum compiles to, so
    float sums at one shard count match it bit for bit."""
    out = x[0].clone()
    for p in x[1:]:
        out += p
    return out


def _round32(x: Fraction) -> np.float32:
    """The float32 nearest the exact value ``x`` (ties to even)."""
    r = np.float32(float(x))
    near = [np.nextafter(r, np.float32(-np.inf)), r,
            np.nextafter(r, np.float32(np.inf))]
    return min(near, key=lambda y: (abs(Fraction(float(y)) - x),
                                    int(y.view(np.int32)) & 1))


def _scale_sum(absmax: np.ndarray) -> np.float32:
    """``sum(max(m, 1e-12) / 127)`` over the shards as the reference's
    compiled program computes it: each scale's product with float32(1 /
    127) contracted into the running sum, one fused multiply-add per
    shard in shard order."""
    inv = Fraction(float(np.float32(1.0) / np.float32(127.0)))
    total = np.float32(0.0)
    for m in absmax:
        total = _round32(Fraction(float(max(m, np.float32(1e-12)))) * inv
                         + Fraction(float(total)))
    return total


def _quantized(part, draws: torch.Tensor):
    """One shard's partial for the compressed merge: its float ``acc``
    quantized to int8 with one scale (``quantize_int8`` on the flattened
    partial, stochastic rounding from ``draws``, the shard's uniforms) as
    ``q``, and its largest magnitude as ``absmax``; ``cnt`` kept. What
    crosses the shards is int8."""
    flat = part["acc"].reshape(1, -1)
    q, _ = quantize_int8(flat, draws.reshape(1, -1).to(flat.device))
    return {"q": q.reshape(part["acc"].shape), "cnt": part["cnt"],
            "absmax": flat.abs().amax(1)}


def _code_sum(parts) -> torch.Tensor:
    """The compressed merge of the shards' ``_quantized`` partials: the
    codes summed exactly in int32, times the MEAN scale — the reference's
    stacked ``_compressed_sum``. Its ``sum(scale) / S`` compiles to the
    fused sum of ``_scale_sum`` times float32(1 / S), taken here on the
    host from the S partials' largest magnitudes."""
    S = len(parts)
    total = torch.stack([p["q"] for p in parts]).to(torch.int32).sum(0)
    absmax = torch.cat([p["absmax"] for p in parts]).cpu().numpy()
    mean = np.float32(_scale_sum(absmax) * (np.float32(1.0) / np.float32(S)))
    return total.to(torch.float32) * torch.tensor(mean, device=total.device)


def _shard_partial(cols, n_valid: int, fvals, shard_id: int, *, pre, node,
                   use_kernel: bool):
    """ONE shard's partial: K1's ``{acc, cnt}`` when ``use_kernel``; else
    the engine's row-local nodes, then the reducer's accumulators, a
    TopK's candidates (their ``index`` the global row ``row + shard_id *
    cap``) or, for a row plan, the masked rows themselves."""
    if use_kernel:
        return fused_segment_agg(cols, n_valid, fvals,
                                 _kernel_spec(pre, node, cols))
    first = next(iter(cols.values()))
    cap = int(first.shape[0])
    mask = torch.arange(cap, device=first.device) < n_valid
    table, mask = _apply_nodes(cols, mask, fvals, pre)
    if node is None:
        return {"table": table, "mask": mask}
    if isinstance(node, TopK):
        # the global top k lies among the union of the shards' top k
        score = torch.where(mask, table[node.by].to(torch.float32),
                            float("-inf"))
        if not node.largest:
            score = torch.where(torch.isfinite(score), -score, score)
        idx = _topk_idx(score, min(node.k, cap))
        cand = {c: table[c].index_select(0, idx) for c in table}
        cand["index"] = (idx + shard_id * cap).to(torch.int32)
        return {"table": cand, "score": score.index_select(0, idx)}
    return _seg_partial(table, mask, node)


def _merge_partials(parts, node, post, fvals):
    """The merge: concatenate row plans and TopK candidates (in shard
    order), or combine aggregating partials by sum / max / min over the
    shards (counts by sum, exact), or ``_quantized`` ones by
    ``_code_sum``, finalize, then the post nodes."""
    def cat(key):
        return {c: torch.cat([p[key][c] for p in parts])
                for c in parts[0][key]}

    if node is None:                                 # pure row plan
        return cat("table"), torch.cat([p["mask"] for p in parts])
    if isinstance(node, TopK):
        score = torch.cat([p["score"] for p in parts])
        cand = cat("table")
        idx = _topk_idx(score, min(node.k, int(score.shape[0])))
        table = {c: v.index_select(0, idx) for c, v in cand.items()}
        mask = torch.isfinite(score.index_select(0, idx))
    else:
        if "q" in parts[0]:
            acc = _code_sum(parts)
        elif node.agg == "max":
            acc = torch.stack([p["acc"] for p in parts]).amax(0)
        elif node.agg == "min":
            acc = torch.stack([p["acc"] for p in parts]).amin(0)
        else:
            acc = _merge_sum(torch.stack([p["acc"] for p in parts]))
        cnt = _merge_sum(torch.stack([p["cnt"] for p in parts]))
        out, cnt = _seg_finalize(acc, cnt, node.agg)
        table, mask = _seg_table(node, out, cnt)
    return _apply_nodes(table, mask, fvals, post)


def _gather_parts(parts, node, group):
    """Every shard's partial, in shard order, from this rank's: one
    collective of fixed-shape blocks (``acc`` / ``cnt``, quantized codes,
    TopK candidates and scores), or for a row plan the shards' row
    counts first, then their masked rows padded to the largest count
    (each shard's rows come back compacted, their mask all true)."""
    from repro_torch.launch.mesh import all_gather_blocks

    def gather(blocks):
        # one level of nesting (a part's "table") flattened to key pairs
        flat = [{(k, c): x for k, v in b.items() for c, x in (
            v.items() if isinstance(v, dict) else ((None, v),))}
            for b in blocks]
        keys = list(flat[0])
        got = all_gather_blocks([torch.stack([f[k] for f in flat])
                                 for k in keys], group)
        out = []
        for row in zip(*[g.unbind(0) for g in got]):
            part = {}
            for (k, c), x in zip(keys, row):
                if c is None:
                    part[k] = x
                else:
                    part.setdefault(k, {})[c] = x
            out.append(part)
        return out

    if node is not None:
        return gather(parts)
    dev = parts[0]["mask"].device
    rows = [{c: v[p["mask"]] for c, v in p["table"].items()} for p in parts]
    n = torch.stack([p["mask"].sum() for p in parts])
    counts = all_gather_blocks([n], group)[0].tolist()
    m = max(counts + [1])            # at least a row: no empty transfer
    pad = []
    for r in rows:
        z = {c: torch.zeros((m,) + v.shape[1:], dtype=v.dtype, device=dev)
             for c, v in r.items()}
        for c, v in r.items():
            z[c][:len(v)] = v
        pad.append({"table": z})
    return [{"table": {c: v[:k] for c, v in p["table"].items()},
             "mask": torch.ones(k, dtype=torch.bool, device=dev)}
            for p, k in zip(gather(pad), counts)]


def execute_sharded(store, plan, *, compressed: bool = False, seed: int = 0,
                    draws=None, use_kernel=None):
    """Run ``plan`` over a sharded store: one partial per shard over the
    stacked columns, then their merge (the reference's single-device
    path). ``use_kernel`` picks each shard's partial as ``execute`` picks
    a query's (``_resolve_use_kernel`` on one shard's columns): on CUDA
    columns K1, one launch per shard. ``compressed=True`` merges float
    partial sums through int8 (``_quantized`` and ``_code_sum``: exact
    counts, lossy sums); its rounding uniforms are ``draws`` (S, *partial
    shape), e.g. the reference's, else a CPU ``torch.Generator`` seeded
    with ``seed``. Returns ``(table, mask)`` on the store's device.

    On a store spread over a group (``store.group``) this is a
    collective: each rank computes its own shards' partials and gathers
    every shard's in shard order before the merge, and every rank gets
    the stacked store's answer bit for bit; the compressed merge
    quantizes each shard's partial on its rank and gathers the int8
    codes. A row plan's answer is then the surviving rows alone, in
    shard order, the mask all true (the stacked store's ``to_host``)."""
    cols, n_valid = store.shard_source()
    spec, fvals = normalize(plan)
    pre, node, post = split_plan(spec)
    shards = [{k: v[s] for k, v in cols.items()}
              for s in range(len(n_valid))]
    lo = store.shards.start
    uk = _resolve_use_kernel(use_kernel, pre, node, shards[0])
    if node is not None and not isinstance(node, TopK):
        PATHS["kernel" if uk else "engine"] += 1
    parts = [_shard_partial(c, int(n), fvals, lo + j, pre=pre, node=node,
                            use_kernel=uk)
             for j, (c, n) in enumerate(zip(shards, n_valid))]
    if (compressed and node is not None and not isinstance(node, TopK)
            and node.agg not in ("max", "min")
            and parts[0]["acc"].dtype == torch.float32):
        if draws is None:
            u = torch.rand((store.n_shards,) + tuple(parts[0]["acc"].shape),
                           generator=torch.Generator().manual_seed(seed))
        else:
            u = draws if isinstance(draws, torch.Tensor) \
                else torch.tensor(np.asarray(draws))
        parts = [_quantized(p, u[lo + j]) for j, p in enumerate(parts)]
    if store.group is not None:
        parts = _gather_parts(parts, node, store.group)
    return _merge_partials(parts, node, post, fvals)


def _source(store):
    """(columns, n_rows) from a SegmentStore, a TieredStore (its two-tier
    view, ``materialize``) or a raw (columns, n) pair."""
    if hasattr(store, "materialize"):
        return store.materialize()
    if hasattr(store, "columns") and hasattr(store, "n_rows"):
        return store.columns, store.n_rows
    cols, n = store
    return cols, int(n)


def execute(store, plan, *, use_kernel=None):
    """Run ``plan`` over ``store``; returns ``(table, mask)`` of tensors
    on the store's device. ``use_kernel`` picks the aggregation path
    (see ``_resolve_use_kernel``). Sharded stores route to
    ``execute_sharded``."""
    if hasattr(store, "shard_source"):
        return execute_sharded(store, plan, use_kernel=use_kernel)
    cols, n_rows = _source(store)
    spec, fvals = normalize(plan)
    pre, node, _ = split_plan(spec)
    uk = _resolve_use_kernel(use_kernel, pre, node, cols)
    if node is not None and not isinstance(node, TopK):
        PATHS["kernel" if uk else "engine"] += 1
    return _run_plan(cols, n_rows, fvals, spec, uk)


def windows_for(store, window: int) -> int:
    """Window count covering every stored timestamp."""
    return max(1, int(store.t_max) // int(window) + 1)


def to_host(table, mask) -> Dict[str, np.ndarray]:
    """Compact a query result to host numpy, dropping masked-off rows."""
    m = mask.cpu().numpy()
    return {k: v.cpu().numpy()[m] for k, v in table.items()}


# ---------------------------------------------------------------------------
# numpy reference (tests and examples' correctness baseline)
# ---------------------------------------------------------------------------

def _np_seg_ids(table, node):
    """Clipped int64 group ids + group count for an agg node, in numpy."""
    if isinstance(node, GroupBy):
        ids, num = table[node.key], node.num_groups
    elif isinstance(node, WindowAgg):
        ids, num = table["t"] // node.window, node.num_windows
    else:                                            # MultiGroupBy
        wins = node.windows or (0,) * len(node.keys)
        fused = None
        for key, n, w in zip(node.keys, node.nums, wins):
            ids = np.asarray(table[key], np.int64)
            if w and w > 1:
                ids = ids // w
            ids = np.clip(ids, 0, n - 1)
            fused = ids if fused is None else fused * n + ids
        return fused, math.prod(node.nums)
    return np.clip(np.asarray(ids, np.int64), 0, num - 1), num


def _np_aggregate(table, mask, node):
    """(finalized values, counts) of an agg node over the masked rows."""
    ids, num = _np_seg_ids(table, node)
    v = np.asarray(table[node.value], np.float32)
    agg = node.agg
    cnt = np.zeros(num, np.float32)
    np.add.at(cnt, ids[mask], np.float32(1.0))
    if agg == "count":
        out = cnt
    elif agg in ("sum", "mean"):
        out = np.zeros((num,) + v.shape[1:], np.float32)
        # np.add.at accumulates in row order: the float32 addition
        # sequence of the engine's scatter, so one store's sums match
        # bit for bit
        np.add.at(out, ids[mask], v[mask])
        if agg == "mean":
            c = np.maximum(cnt, 1.0)
            out = out / (c if out.ndim == 1 else c[:, None])
    elif agg == "max":
        assert v.ndim == 1, "max needs a scalar column"
        out = np.full(num, -np.inf, np.float32)
        np.maximum.at(out, ids[mask], v[mask])
        out = np.where(cnt > 0, out, 0.0).astype(np.float32)
    elif agg == "min":
        assert v.ndim == 1, "min needs a scalar column"
        out = np.full(num, np.inf, np.float32)
        np.minimum.at(out, ids[mask], v[mask])
        out = np.where(cnt > 0, out, 0.0).astype(np.float32)
    else:
        raise ValueError(agg)
    return out, cnt


def _np_seg_table(node, out, cnt):
    """Result table + mask for a finalized aggregation, in numpy."""
    if isinstance(node, GroupBy):
        table = {node.key: np.arange(node.num_groups, dtype=np.int32)}
    elif isinstance(node, WindowAgg):
        table = {"window": np.arange(node.num_windows, dtype=np.int32)}
    else:
        num = math.prod(node.nums)
        rem = np.arange(num, dtype=np.int64)
        decoded = {}
        for key, n in zip(reversed(node.keys), reversed(node.nums)):
            decoded[key] = (rem % n).astype(np.int32)
            rem = rem // n
        table = {k: decoded[k] for k in node.keys}
    table[node.value] = out
    table["count"] = cnt
    return table, cnt > 0


def _np_topk_idx(score, kk: int) -> np.ndarray:
    """``_topk_idx`` in numpy: descending IEEE-754 total order (``+0.0``
    above ``-0.0``), ties at identical bit patterns by ascending row
    index. Non-negative floats set the sign bit and negative floats
    invert all bits, so the uint32 keys sort in float total order."""
    bits = np.ascontiguousarray(np.asarray(score, np.float32)) \
        .view(np.uint32)
    key = np.where(bits & np.uint32(0x80000000), ~bits,
                   bits | np.uint32(0x80000000))
    return np.argsort(~key, kind="stable")[:kk].astype(np.int32)


def execute_ref(cols: Dict[str, np.ndarray], n_rows: int, plan):
    """Plain-numpy mirror of ``execute`` (the same clipping, masking and
    summation order, ``_seg_finalize``'s empty-group contract: 0.0 /
    count 0 / masked row for every agg, and ``_topk_idx``'s total-order
    tie-break). Returns ``(table, mask)`` in numpy."""
    cap = len(next(iter(cols.values())))
    mask = np.arange(cap) < n_rows
    table = {k: np.asarray(v) for k, v in cols.items()}
    for node in plan:
        if isinstance(node, Filter):
            x = table[node.column]
            if np.issubdtype(x.dtype, np.integer):
                # exact: int32 values and the threshold both embed in
                # float64 (as the kernels' ``int_pred``)
                mask = mask & _CMP[node.op](x.astype(np.float64),
                                            np.float64(node.value))
            else:
                mask = mask & _CMP[node.op](x.astype(np.float32),
                                            np.float32(node.value))
        elif isinstance(node, Project):
            table = {c: table[c] for c in node.columns}
        elif isinstance(node, (GroupBy, WindowAgg, MultiGroupBy)):
            out, cnt = _np_aggregate(table, mask, node)
            table, mask = _np_seg_table(node, out, cnt)
        elif isinstance(node, TopK):
            score = np.where(mask, table[node.by].astype(np.float32),
                             -np.inf)
            if not node.largest:
                score = np.where(np.isfinite(score), -score, score)
            kk = min(node.k, len(score))
            idx = _np_topk_idx(score, kk)
            top = score[idx]
            table = {c: np.take(table[c], idx, axis=0) for c in table}
            table["index"] = idx
            mask = np.isfinite(top)
        else:
            raise TypeError(f"unknown plan node {node!r}")
    return table, mask
