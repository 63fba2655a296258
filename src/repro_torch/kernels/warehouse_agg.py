"""Fused filter + group + aggregate over the store's columns (kernel K1).

``fused_segment_agg`` is the port of ``repro/kernels/warehouse_agg.py``'s
Pallas kernel: ONE pass over the live rows that evaluates the plan's
filter mask and fused multi-key group id in registers and accumulates
``{"acc", "cnt"}`` partials — the query engine's partial convention,
with ∓inf sentinels for max/min, so ``query._seg_finalize`` applies
unchanged.

On a CUDA tensor the wrapper launches the hand-written Hopper kernel
``csrc/warehouse_agg.cu`` (built with nvcc at first use, bound through
ctypes) or raises; it never falls back. The kernel reads strips of 4
rows with 16-byte loads and combines values by group inside each warp
before one atomic per (group, warp); its accumulators live in shared
memory when one copy fits there and in one global copy otherwise, so
any group count up to ``GLOBAL_LIMIT`` runs on it (``geometry`` sizes
the launch, ``vector_head`` finds the first aligned strip). On a CPU
tensor it runs the plain version ``fused_segment_agg_ref``, built from
``int_pred`` and ``index_add_``/``scatter_reduce_``. ``LAUNCHES`` counts
kernel launches.

Exactness (the reference's contract): count, max, min and integer-valued
sums are exact on both paths. The plain version's sums add in row order
(on the CPU) and match the reference's numpy mirror bit for bit; the
kernel's atomics add warp partials in another order, so its float sums
and means match to float32 rounding of the reordered sum
(``chip_smoke.py`` holds them within 1e-4 of each group's sum of
magnitudes of the plain version accumulated in float64). Each atomic
adds a partial of up to 128 rows, so on groups of millions of rows the
kernel is much closer to float64 than a row-order float32 sum.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

CMP = {
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
}
OPS = ("eq", "ne", "lt", "le", "gt", "ge")          # csrc op codes
AGGS = ("sum", "mean", "count", "max", "min")       # csrc agg codes

# limits of the kernel's by-value spec struct (csrc/warehouse_agg.cu);
# MAX_FILTERS + MAX_KEYS + 1 value <= MAX_COLS, so the operand columns
# of a spec within the first two limits always fit the third
MAX_FILTERS, MAX_KEYS, MAX_COLS = 8, 4, 16
# shared memory one block may take on sm_90 (227 KB), all of an SM's
# (228 KB) and what the runtime keeps for each resident block
SMEM_LIMIT = 232_448
SM_SMEM = 233_472
BLOCK_RESERVED = 1024
# the kernel's launch bound: up to 1024 threads a block, so at most 64
# registers a thread; an SM holds 2048 threads and 65,536 registers
MAX_THREADS = 1024
REGS = 64
SM_THREADS, SM_REGS = 2048, 65_536
# resident warps an SM should hold to keep enough loads in flight
MIN_WARPS = 32
# accumulators past SMEM_LIMIT live in one copy in global memory: at
# most GLOBAL_LIMIT bytes (keeps the kernel's int32 indices in range)
GLOBAL_LIMIT = 1 << 30
THREADS = 256                       # a block's threads unless it must grow
ROWS_PER_STRIP = 4                  # one 16-byte load per scalar column

LAUNCHES = 0


def int_pred(x: torch.Tensor, op: str, i: int, is_int: bool,
             oob: int) -> torch.Tensor:
    """Exact comparison of an INTEGER column ``x`` against a real
    threshold hoisted host-side as ``(floor(v), integral?, oob)`` (see
    ``query.normalize``). Closed-form in ``floor(v)`` with no ``±1``
    arithmetic:

        x >= v  <=>  x >= floor(v)  when v integral, else x > floor(v)
        x >  v  <=>  x > floor(v)
        x <= v  <=>  x <= floor(v)
        x <  v  <=>  x < floor(v)   when v integral, else x <= floor(v)

    ``oob`` (-1/0/+1) marks thresholds outside int32 (incl. ∓inf), where
    the comparison is constant for every x. The operands are host values,
    so the branches are taken on the host."""
    if op not in CMP:
        raise ValueError(f"unknown filter op {op!r}")
    if oob != 0:
        const = {"eq": False, "ne": True, "ge": oob < 0, "gt": oob < 0,
                 "le": oob > 0, "lt": oob > 0}[op]
        return torch.full(x.shape, const, dtype=torch.bool, device=x.device)
    if op in ("eq", "ne") and not is_int:
        return torch.full(x.shape, op == "ne", dtype=torch.bool,
                          device=x.device)
    if op == "ge" and not is_int:
        op = "gt"
    elif op == "lt" and not is_int:
        op = "le"
    return CMP[op](x, int(i))


def filter_pred(x: torch.Tensor, op: str, idx: int, fvals) -> torch.Tensor:
    """The row predicate of one hoisted filter: ``int_pred`` on integer
    columns, the float32 comparison on float columns."""
    vals, floors, isint, oob = fvals
    if not x.is_floating_point():
        return int_pred(x, op, int(floors[idx]), bool(isint[idx]),
                        int(oob[idx]))
    return CMP[op](x.to(torch.float32),
                   torch.tensor(vals[idx], dtype=torch.float32))


def group_ids(cols, n: int, keys) -> torch.Tensor:
    """Fused int64 group ids of rows [0, n): each key cast to int32 with
    truncation, divided (floor) by its window when > 1, clipped into
    [0, num), and encoded ``gid * num + id``."""
    gid = None
    for col, num, window in keys:
        ids = cols[col][:n].to(torch.int32)
        if window > 1:
            ids = torch.div(ids, window, rounding_mode="floor")
        ids = torch.clamp(ids, 0, num - 1).long()
        gid = ids if gid is None else gid * num + ids
    return gid


def identity(agg: str) -> float:
    """The accumulator's empty value: -inf for max, +inf for min, else 0."""
    return {"max": float("-inf"), "min": float("inf")}.get(agg, 0.0)


def masked_fold(part, ids, mask, v, agg: str) -> Dict:
    """Fold value rows ``v`` (n,) or (n, D) under group ids ``ids`` and
    row mask ``mask`` into the accumulators ``part = {"acc", "cnt"}``,
    IN PLACE, and return ``part``. ``index_add_`` adds in row order on
    the CPU, so each group's float32 addition sequence continues where
    ``part`` left it: folding rows in batches gives the same bits as
    folding them at once. Values accumulate in ``part["acc"]``'s dtype."""
    acc, cnt = part["acc"], part["cnt"]
    v = v.to(acc.dtype)
    cnt.index_add_(0, ids, mask.to(cnt.dtype))
    if agg in ("sum", "mean", "count"):
        m = mask if v.ndim == 1 else mask[:, None]
        acc.index_add_(0, ids, torch.where(m, v, 0.0))
        return part
    if v.ndim != 1:
        raise ValueError(f"agg {agg!r} needs a scalar column")
    if agg not in ("max", "min"):
        raise ValueError(f"unknown agg {agg!r}")
    fill = identity(agg)
    acc.scatter_reduce_(0, ids, torch.where(mask, v, fill),
                        "amax" if agg == "max" else "amin")
    return part


def masked_partial(ids, mask, v, num: int, agg: str) -> Dict:
    """Masked segment accumulators ``{"acc", "cnt"}`` of value rows ``v``
    (n,) or (n, D): ``masked_fold`` into fresh accumulators. Sums there
    are the reference's row-order sums on the CPU. Values accumulate in
    float32, or in float64 when ``v`` is float64 (a wider check of the
    same function; the store holds no float64 column)."""
    dt = torch.float64 if v.dtype == torch.float64 else torch.float32
    if agg in ("max", "min") and v.ndim != 1:
        raise ValueError(f"agg {agg!r} needs a scalar column")
    part = {"acc": torch.full((num,) + tuple(v.shape[1:]), identity(agg),
                              dtype=dt, device=v.device),
            "cnt": torch.zeros((num,), dtype=torch.float32, device=v.device)}
    return masked_fold(part, ids, mask, v, agg)


@dataclass(frozen=True)
class FusedAggSpec:
    """Static shape of one fused filter+group+aggregate pass — the
    partial phase of a plan up to and including its first reducing node.

    ``filters[j] = (column, op, idx)`` with ``idx`` indexing the hoisted
    filter operands; ``keys[j] = (column, num_ids, window)`` is the fused
    multi-key encoding (``window > 1`` divides the key column first; ids
    clip into ``[0, num_ids)``), identical to ``query._seg_ids``."""
    filters: Tuple[Tuple[str, str, int], ...]
    keys: Tuple[Tuple[str, int, int], ...]
    value: str
    agg: str  # sum | mean | count | max | min

    @property
    def num_groups(self) -> int:
        return math.prod(n for _, n, _ in self.keys)

    def columns(self) -> Tuple[str, ...]:
        """Operand columns, each once: filters, keys, then the value."""
        names = []
        for col in ([c for c, _, _ in self.filters]
                    + [c for c, _, _ in self.keys] + [self.value]):
            if col not in names:
                names.append(col)
        return tuple(names)


def accumulator_bytes(num: int, width: int) -> int:
    """Bytes one copy of the accumulators takes: ``num`` groups
    of ``width`` value lanes (1 for a scalar column) plus a count."""
    return num * (max(1, width) + 1) * 4


def staging_bytes(width: int) -> int:
    """Shared memory a warp stages a wide column through: its 128 rows
    of ``width`` floats and the 256 words of their sort by group (none
    for a scalar column)."""
    return (128 * width + 256) * 4 if width else 0


def accumulator_mode(spec: FusedAggSpec, width: int) -> str:
    """Where the kernel keeps its accumulators: ``"shared"`` when one
    copy, and one warp's staging of a wide column, fit a block's shared
    memory; else ``"global"`` (one copy in global memory for the whole
    grid)."""
    need = accumulator_bytes(spec.num_groups, width) + staging_bytes(width)
    return "shared" if need <= SMEM_LIMIT else "global"


@dataclass(frozen=True)
class Geometry:
    """How the kernel is launched for one pass."""
    mode: str               # "shared" | "global"
    threads: int            # per block
    blocks: int
    replicas: int           # shared accumulator copies per block
    smem_bytes: int         # dynamic shared memory per block
    blocks_per_sm: int      # resident blocks an SM can hold

    @property
    def resident_warps(self) -> int:
        return self.blocks_per_sm * self.threads // 32


def _blocks_per_sm(threads: int, smem: int) -> int:
    return min(SM_THREADS // threads, SM_REGS // (REGS * threads),
               SM_SMEM // (smem + BLOCK_RESERVED))


def _smem(copy: int, replicas: int, warps: int, width: int) -> int:
    acc = -(-copy * replicas // 16) * 16          # the slabs start 16-aligned
    return acc + warps * staging_bytes(width)


def geometry(n_rows: int, spec: FusedAggSpec, width: int,
             n_sm: int) -> Geometry:
    """Blocks, threads, replicas and accumulator mode of one pass over
    ``n_rows`` rows on a card with ``n_sm`` SMs. Shared mode takes the
    largest block (1024, 512 or 256 threads, fewer only when a large wide
    copy leaves room for few warps' staging) whose accumulators and
    staging fit, so that an SM holds ``MIN_WARPS`` resident warps in as
    few blocks, and as few partial slices to fold, as it can; replicas
    take the shared memory left at that residency, up to one per warp.
    Global mode has no slices and takes blocks of ``THREADS``. The grid
    is one wave of resident blocks, or fewer when the rows are few."""
    mode = accumulator_mode(spec, width)
    copy = accumulator_bytes(spec.num_groups, width)
    strips = -(-max(0, int(n_rows)) // ROWS_PER_STRIP)
    best = None
    sizes = ((MAX_THREADS, 512, 256, 128, 64, 32) if mode == "shared"
             else (THREADS,))
    for threads in sizes:
        warps = threads // 32
        if mode == "global":
            replicas, smem = 1, warps * staging_bytes(width)
        else:
            smem = _smem(copy, 1, warps, width)
            if smem > SMEM_LIMIT:
                continue
            per_sm = _blocks_per_sm(threads, smem)
            replicas = 1
            while (replicas < warps
                   and _smem(copy, replicas + 1, warps, width) <= SMEM_LIMIT
                   and _blocks_per_sm(threads, _smem(copy, replicas + 1,
                                                     warps, width)) == per_sm):
                replicas += 1
            smem = _smem(copy, replicas, warps, width)
        per_sm = _blocks_per_sm(threads, smem)
        blocks = max(1, min(-(-strips // threads), per_sm * n_sm))
        g = Geometry(mode, threads, blocks, replicas, smem, per_sm)
        if best is None or g.resident_warps > best.resident_warps:
            best = g
        if g.resident_warps >= MIN_WARPS:
            break
    return best


def vector_head(ptrs, widths) -> int:
    """The first row from which every operand column's strips of 4 rows
    start 16-byte aligned (0 to 3), or -1 when no row aligns them all.
    ``ptrs`` are the columns' byte addresses, ``widths`` their floats per
    row (1 for a scalar column)."""
    for head in range(ROWS_PER_STRIP):
        if all(p % 4 == 0 and (p // 4 + head * w) % 4 == 0
               for p, w in zip(ptrs, widths)):
            return head
    return -1


def strip_plan(n_rows: int, head: int, blocks: int) -> Tuple[int, int, int]:
    """(head, n_strips, strips_per_block) as the kernel takes them: strips
    of 4 rows from ``head`` (``vector_head``) while 4 rows remain, cut
    into ``blocks`` contiguous runs; the rows before ``head`` and after the
    last strip take the kernel's scalar path. head -1 (no strip): every
    row is scalar."""
    n_strips = (n_rows - head) // ROWS_PER_STRIP if 0 <= head <= n_rows else 0
    if n_strips == 0:
        head = -1
    return head, n_strips, max(1, -(-n_strips // blocks))


def div_magic(w: int) -> Tuple[int, int]:
    """(magic, shift) with ``u // w == (umulhi(magic, u) + u) >> shift``
    for every ``0 <= u < 2**31`` and ``w >= 2`` (the kernel's window
    division): shift = ceil(log2 w), magic = floor(2^32 (2^shift - w) /
    w) + 1 (Granlund and Montgomery's round-up method)."""
    if w < 2:
        raise ValueError(f"window {w} has no magic (needs >= 2)")
    shift = (w - 1).bit_length()
    return ((1 << 32) * ((1 << shift) - w)) // w + 1, shift


def floor_div(a: int, w: int) -> int:
    """The kernel's floor(a / w) for an int32 ``a`` and ``w >= 2``, in
    plain Python: ``~a`` stands in for a negative ``a``."""
    magic, shift = div_magic(w)
    u = ~a if a < 0 else a
    q = (((magic * u) >> 32) + u) >> shift
    return ~q if a < 0 else q


def ordered_int(x: float) -> int:
    """The kernel's order-preserving map of a float32 to an int32 (max and
    min are integer atomics on it): non-negative floats keep their bits,
    negative ones flip the low 31 bits, and -0 maps to +0, so ``a < b``
    if and only if ``ordered_int(a) < ordered_int(b)`` for non-NaN
    float32 values."""
    b = int(np.array(x, np.float32).view(np.int32))
    if b == -2 ** 31:
        b = 0
    return b if b >= 0 else b ^ 0x7FFFFFFF


def from_ordered_int(b: int) -> float:
    """The inverse of ``ordered_int`` (-0 comes back as +0)."""
    b = b if b >= 0 else b ^ 0x7FFFFFFF
    return float(np.array(b, np.int32).view(np.float32))


def check_kernel(spec: FusedAggSpec, width: int) -> None:
    """Raise ``ValueError`` naming the limit when the kernel cannot take
    this spec: more filters or keys than its struct holds, no key,
    max/min over a wide column, or one accumulator copy larger than
    ``GLOBAL_LIMIT``."""
    nbytes = accumulator_bytes(spec.num_groups, width)
    for bad, what in (
            (len(spec.filters) > MAX_FILTERS,
             f"{len(spec.filters)} filters (max {MAX_FILTERS})"),
            (not spec.keys, "no group key (min 1)"),
            (len(spec.keys) > MAX_KEYS,
             f"{len(spec.keys)} keys (max {MAX_KEYS})"),
            (width and spec.agg in ("max", "min"),
             f"agg {spec.agg!r} on a column of width {width} (scalar only)"),
            (nbytes > GLOBAL_LIMIT,
             f"{nbytes} bytes of accumulators (max {GLOBAL_LIMIT})")):
        if bad:
            raise ValueError(f"the kernel cannot take this plan: {what}")


def fused_segment_agg_ref(cols, n_rows: int, fvals,
                          spec: FusedAggSpec) -> Dict:
    """Plain PyTorch version of the kernel, on any device: the same
    function over rows [0, n_rows), in row order."""
    n = int(n_rows)
    v = cols[spec.value][:n]
    mask = torch.ones((n,), dtype=torch.bool, device=v.device)
    for col, op, idx in spec.filters:
        mask &= filter_pred(cols[col][:n], op, idx, fvals)
    ids = group_ids(cols, n, spec.keys)
    if ids is None:
        raise ValueError("the fused aggregation needs at least one key")
    return masked_partial(ids, mask, v, spec.num_groups, spec.agg)


class _Spec(ctypes.Structure):
    """ctypes mirror of ``struct AggSpec`` in csrc/warehouse_agg.cu."""
    _fields_ = [
        ("cols", ctypes.c_void_p * MAX_COLS),
        ("col_is_int", ctypes.c_int * MAX_COLS),
        ("n_filters", ctypes.c_int),
        ("f_col", ctypes.c_int * MAX_FILTERS),
        ("f_op", ctypes.c_int * MAX_FILTERS),
        ("f_val", ctypes.c_float * MAX_FILTERS),
        ("f_floor", ctypes.c_int * MAX_FILTERS),
        ("f_isint", ctypes.c_int * MAX_FILTERS),
        ("f_oob", ctypes.c_int * MAX_FILTERS),
        ("n_keys", ctypes.c_int),
        ("k_col", ctypes.c_int * MAX_KEYS),
        ("k_num", ctypes.c_int * MAX_KEYS),
        ("k_window", ctypes.c_int * MAX_KEYS),
        ("v_col", ctypes.c_int),
        ("width", ctypes.c_int),
        ("agg", ctypes.c_int),
        ("num", ctypes.c_int),
        ("replicas", ctypes.c_int),
        ("global_acc", ctypes.c_int),
        ("n_blocks", ctypes.c_int),
        ("threads", ctypes.c_int),
        ("smem_bytes", ctypes.c_int),
        ("n_scalar", ctypes.c_int),
        ("prefetch", ctypes.c_int),
        ("n_rows", ctypes.c_longlong),
        ("head", ctypes.c_longlong),
        ("n_strips", ctypes.c_longlong),
        ("strips_per_block", ctypes.c_longlong),
        ("k_magic", ctypes.c_uint * MAX_KEYS),
        ("k_shift", ctypes.c_int * MAX_KEYS),
    ]


def _lib():
    from repro_torch.kernels import build
    lib = build.load("warehouse_agg")
    fn = lib.warehouse_agg
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6
        fn.restype = ctypes.c_int
    return fn


def _check_column(name, x, dev, n_rows, value=False):
    if x.device != dev:
        raise ValueError(f"column {name!r} is on {x.device}, not {dev}")
    if x.dtype not in (torch.int32, torch.float32):
        raise TypeError(f"column {name!r} has dtype {x.dtype}; the kernel "
                        "takes int32 and float32")
    if not x.is_contiguous():
        raise ValueError(f"column {name!r} is not contiguous")
    if x.ndim != 1 and not (value and x.ndim == 2
                            and x.dtype == torch.float32):
        raise ValueError(f"column {name!r} has shape {tuple(x.shape)}")
    if x.shape[0] < n_rows:
        raise ValueError(f"column {name!r} holds {x.shape[0]} rows, "
                         f"fewer than n_rows={n_rows}")


def fused_segment_agg(cols, n_rows: int, fvals, spec: FusedAggSpec) -> Dict:
    """Run ONE fused filter+group+aggregate pass over rows [0, n_rows)
    of ``cols`` (the store's column dict; only the spec's operand
    columns are read) and return the engine's partial ``{"acc", "cnt"}``.
    ``fvals`` is ``query.normalize``'s host operand tuple ``(vals,
    floors, isint, oob)``; ``n_rows`` is a host int, so the grid covers
    the live rows only.

    CPU columns take the plain version. CUDA columns launch the kernel
    on the current stream, without synchronising, or raise (see
    ``check_kernel``); accumulators that fit shared memory live there,
    larger ones in global memory (``accumulator_mode``, ``geometry``)."""
    global LAUNCHES
    v = cols[spec.value]
    if v.device.type == "cpu":
        return fused_segment_agg_ref(cols, n_rows, fvals, spec)
    if v.device.type != "cuda":
        raise ValueError(f"no kernel for device {v.device}")
    n_rows = int(n_rows)
    names = spec.columns()
    width = int(v.shape[1]) if v.ndim == 2 else 0
    check_kernel(spec, width)
    for name in names:
        _check_column(name, cols[name], v.device, n_rows,
                      value=name == spec.value)
    vals, floors, isint, oob = (np.asarray(a) for a in fvals)
    num = spec.num_groups
    lanes = max(1, width)
    n_sm = torch.cuda.get_device_properties(v.device).multi_processor_count
    geo = geometry(n_rows, spec, width, n_sm)
    # the wide value is the last operand column: filters and keys are 1-D
    n_scalar = len(names) - (1 if width else 0)
    head = vector_head([cols[c].data_ptr() for c in names],
                       [width if width and c == spec.value else 1
                        for c in names])
    head, n_strips, per_block = strip_plan(n_rows, head, geo.blocks)

    s = _Spec()
    for j, name in enumerate(names):
        s.cols[j] = cols[name].data_ptr()
        s.col_is_int[j] = int(cols[name].dtype == torch.int32)
    s.n_filters = len(spec.filters)
    for j, (col, op, idx) in enumerate(spec.filters):
        s.f_col[j] = names.index(col)
        s.f_op[j] = OPS.index(op)
        s.f_val[j] = float(vals[idx])
        s.f_floor[j] = int(floors[idx])
        s.f_isint[j] = int(bool(isint[idx]))
        s.f_oob[j] = int(oob[idx])
    s.n_keys = len(spec.keys)
    for j, (col, n_ids, window) in enumerate(spec.keys):
        s.k_col[j] = names.index(col)
        s.k_num[j] = int(n_ids)
        s.k_window[j] = int(window)
        if window > 1:
            s.k_magic[j], s.k_shift[j] = div_magic(int(window))
    s.v_col = names.index(spec.value)
    s.width = width
    s.agg = AGGS.index(spec.agg)
    s.num = num
    s.replicas = geo.replicas
    s.global_acc = int(geo.mode == "global")
    s.n_blocks = geo.blocks
    s.threads = geo.threads
    s.smem_bytes = geo.smem_bytes
    s.n_scalar = n_scalar
    # filter columns load before the filter runs; with no filter, all do
    s.prefetch = (sum(1 << names.index(c) for c in {c for c, _, _ in
                                                     spec.filters})
                  if spec.filters else (1 << n_scalar) - 1)
    s.n_rows = n_rows
    s.head = head
    s.n_strips = n_strips
    s.strips_per_block = per_block

    f32 = dict(dtype=torch.float32, device=v.device)
    slices = geo.blocks if geo.mode == "shared" else 0
    part_acc = torch.empty((slices, num * lanes), **f32)
    part_cnt = torch.empty((slices, num), dtype=torch.int32, device=v.device)
    acc = torch.empty((num, width) if width else (num,), **f32)
    cnt = torch.empty((num,), **f32)
    err = _lib()(ctypes.addressof(s), part_acc.data_ptr(),
                 part_cnt.data_ptr(), acc.data_ptr(), cnt.data_ptr(),
                 torch.cuda.current_stream(v.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"warehouse_agg launch failed: cudaError {err}")
    LAUNCHES += 1
    return {"acc": acc, "cnt": cnt}
