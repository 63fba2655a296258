"""Logical-axis sharding: the port of ``repro/distribution/sharding.py``,
and the collectives of a train step whose state is laid out by it.

Models give every parameter *logical* axes (``ParamMeta.axes``:
"fsdp", "tensor", "vocab", "expert", ...). ``spec_for`` resolves them
onto the physical axes of a mesh (``launch/mesh.py``: "pod", "data",
"model") through ``DEFAULT_RULES`` and a ``RunOptions.rules()``
override, strictly: an axis that does not divide its dim is dropped,
as ``in_shardings`` demands. A spec (``Spec``) is a tuple with one
entry per dim, None, an axis name or a tuple of names, so it compares
equal to the reference's ``PartitionSpec``; ``Placement`` pairs it with
a mesh, as ``NamedSharding`` does. The ambient mesh (``use_mesh``,
``ctx``) is the reference's.

A train state laid out so holds, on each rank, the block of each leaf
that its place on the mesh selects (``shard_tensor``).
``StepLayout`` is how one rank's train step sees it:

- ``leaf`` gathers a leaf at its use: an all-gather along each sharded
  dim over that dim's axes (``_Gather``). Its backward sums the ranks'
  gradients over the batch's axes (reduce-scatter) and slices them
  over the other axes, where every rank computed the same rows, so no
  bit changes there; a gradient then summed over the batch's axes the
  leaf is not sharded on (``_SumGrad``, the batch-axis reduction of a
  replicated leaf).
- ``saved_as_shards`` keeps a gathered weight that autograd saves for
  the backward as its local block, gathered again when the backward
  unpacks it, so a step holds one gathered layer at a time (and a
  sequence-split step's gathered rows as this rank's rows); it counts
  the bytes the saves hold (``saved``).
- ``batch_sum`` all-reduces over the batch's axes (the loss, the MoE
  load-balance counts); ``norm_sums`` sums each leaf's sum of squares
  over the axes it is sharded on (the global-norm clip).

The model axis is computed, not only stored (``ModelSplit``, the
layout's ``split`` where ``"model"`` holds more than one rank). The
reference's ``shard()`` constraints on activations (heads, the hidden
``"tensor"`` columns, the ``"vocab"`` logits, the experts) make GSPMD
give each device of a model group its own part of each product; the
port writes that split into the models as Megatron's pair of
collectives over ``"model"``: ``f``, the identity forward whose
backward all-reduces the gradient, where a replicated activation enters
a column-parallel product, and ``g``, an all-reduce forward with the
identity backward, after each row-parallel product. A leaf the split
consumes is used at its use in one of three ways (``leaf``'s ``mode``):

- ``"local"``: its ``"model"`` dim stays this rank's block (only its
  other axes are gathered), and so does its gradient;
- ``"shared"``: a leaf whose rows every rank of the model group reads
  only in part (the SSM's per-head ``(H,)`` leaves, replicated in the
  reference; the expert weights under ``moe_sharding="cap"``; the kv
  projections where the kv heads do not split): gathered as before, its
  gradient summed over ``"model"`` (a reduce-scatter where the
  ``"model"`` dim is gathered, else an all-reduce);
- ``None``: gathered whole (the replicated leaves that feed ``f``, whose
  gradients come back equal on every rank, and every leaf of a block
  whose counts do not split).

The batch's rows are laid out by the port itself
(``data/tokens.local_rows``): each rank of a model group runs the same
rows, its own part of each product. With the reference's
``RunOptions.seq_shard_activations`` (``"seq"`` on ``"model"``) a train
step or a prefill also splits the residual stream's sequence over the
group (Megatron's sequence parallelism: ``ModelSplit.seq``, the layout's
``seq_split``): ``f`` and ``g`` become a gather and a scatter of rows.

Serving across ranks (``runtime.steps.make_prefill_step`` /
``make_decode_step`` with a mesh) adds three collectives of the model
group, counted in ``bytes["model"]`` beside ``f`` and ``g``:
``ModelSplit.heads_to`` (the all-to-all that moves a prefill's k and v
from heads to the cache's slots, and gathers a decode step's new q, k
and v), ``merge_softmax`` (a decode step's attention over each rank's
slots, merged by max, rescale and sum) and ``argmax`` (the next token
over the vocab-split logits).

A mesh whose groups are ``CountingGroup`` objects (``launch.mesh.
AccountMesh``, used by ``launch/dryrun.py``) takes the counting path:
every collective here moves nothing and returns a tensor of the shape
it would return, on its input's device (``meta``), and the byte counts
grow by the same lines as on the card.
"""
from __future__ import annotations

import functools
import math
import weakref
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.optim.adamw import tree_map

NEG_INF = -1e30          # a masked score (``models.layers.NEG_INF``)

# logical axis -> preferred physical axes (in order; tuples mean "use all")
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "fsdp": ("data",),
    "fsdp_pod": ("pod", "data"),   # opt-in: fully shard over pods too
    "tensor": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    "cache_seq": ("model",),
    "seq": (),                     # sequence parallelism off by default
    None: (),
}
# the stacked layer trees, gathered a layer at a time
LAYER_KEYS = ("layers", "enc_layers", "dec_layers")
MODEL = "model"           # the mesh axis the split computes over


class Spec(tuple):
    """One entry per dim: None, a mesh axis name, or a tuple of names."""

    def axes(self) -> Tuple[str, ...]:
        """Every mesh axis the spec shards over, in dim order."""
        return tuple(a for e in self if e is not None
                     for a in ((e,) if isinstance(e, str) else e))

    def dims(self):
        """(dim, axes tuple) of each sharded dim."""
        return [(i, (e,) if isinstance(e, str) else tuple(e))
                for i, e in enumerate(self) if e is not None]


@dataclass
class ShardingCtx:
    mesh: object = None      # anything with ``shape``: {axis name: size}
    rules: dict = field(default_factory=lambda: dict(DEFAULT_RULES))

    def axis_size(self, names: Tuple[str, ...]) -> int:
        if self.mesh is None:
            return 1
        return math.prod(self.mesh.shape[n] for n in names
                         if n in self.mesh.shape)

    def physical(self, logical) -> Tuple[str, ...]:
        names = self.rules.get(logical, ())
        if self.mesh is None:
            return ()
        return tuple(n for n in names if n in self.mesh.shape)


_CTX = ShardingCtx()


@contextmanager
def use_mesh(mesh, rules: Optional[dict] = None):
    """The ambient mesh and rules (``DEFAULT_RULES`` updated by
    ``rules``) inside the block."""
    global _CTX
    prev = _CTX
    r = dict(DEFAULT_RULES)
    if rules:
        r.update(rules)
    _CTX = ShardingCtx(mesh=mesh, rules=r)
    try:
        yield _CTX
    finally:
        _CTX = prev


def ctx() -> ShardingCtx:
    return _CTX


def _resolve(dim_axes: Sequence, shape=None, strict: bool = False) -> Spec:
    """Logical per-dim axes -> ``Spec`` under the ambient mesh.
    ``strict`` drops an axis whose size does not divide its dim."""
    c = _CTX
    out = []
    for i, ax in enumerate(dim_axes):
        phys = c.physical(ax)
        if not phys:
            out.append(None)
            continue
        if strict and shape is not None:
            if shape[i] % math.prod(c.mesh.shape[p] for p in phys):
                out.append(None)
                continue
        out.append(phys if len(phys) > 1 else phys[0])
    return Spec(out)


def spec_for(shape: Tuple[int, ...], dim_axes: Sequence, mesh,
             rules: Optional[dict] = None) -> Spec:
    """The strict (divisible) spec of a parameter or cache argument."""
    with use_mesh(mesh, rules):
        return _resolve(dim_axes, shape=shape, strict=True)


@dataclass(frozen=True)
class Placement:
    """A spec on a mesh: the counterpart of ``NamedSharding``."""
    mesh: object
    spec: Spec


def spec_tree(meta_tree, mesh, rules=None):
    """``spec_for`` of every ``ParamMeta`` of a nested dict."""
    return tree_map(lambda m: spec_for(m.shape, m.axes, mesh, rules),
                    meta_tree)


def sharding_tree(meta_tree, mesh, rules=None):
    """A ``Placement`` on ``mesh`` for every ``ParamMeta`` of a nested
    dict."""
    return tree_map(lambda m: Placement(mesh, spec_for(m.shape, m.axes, mesh,
                                                       rules)), meta_tree)


def tree_leaves(tree):
    """The leaves of a nested dict in sorted key order (``jax.tree``'s,
    and ``optim.adamw.leaves``'), a ``Spec`` or ``Placement`` a leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


# ---------------------------------------------------------------------------
# a rank's block of a leaf
# ---------------------------------------------------------------------------
def shard_tensor(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``x``, a new tensor on
    ``mesh.device`` (``x`` may live anywhere and may be freed after)."""
    for d, axes in spec.dims():
        n = mesh.axis_size(axes)
        size = x.shape[d] // n
        x = x.narrow(d, mesh.index(axes) * size, size)
    out = torch.empty(x.shape, dtype=x.dtype, device=mesh.device)
    return out.copy_(x)


def shard_tree(tree, placements):
    """``shard_tensor`` of every leaf of ``tree`` by the ``Placement`` at
    the same path: the port of ``jax.device_put(tree, shardings)``."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, placements[k]) for k, v in tree.items()}
    return shard_tensor(torch.as_tensor(tree), placements.spec,
                        placements.mesh)


@torch.no_grad()
def full_tensor(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole leaf from every rank's block ``x``: an all-gather along
    each sharded dim (a collective of every rank of the mesh)."""
    for d, axes in spec.dims():
        x = _all_gather(x, d, mesh.group(axes), mesh.axis_size(axes))
    return x


# ---------------------------------------------------------------------------
# collectives along one dim
# ---------------------------------------------------------------------------
class CountingGroup:
    """A group of ``n`` ranks that moves nothing: what an accounting
    mesh's ``group`` returns (``launch.mesh.AccountMesh``). Each
    collective given one returns an uninitialised tensor of the shape it
    would return."""

    def __init__(self, n: int):
        self.n = n


def _moves(group) -> bool:
    """True where ``group`` is a real group (not None, not counting)."""
    return group is not None and not isinstance(group, CountingGroup)


def _all_gather(x, dim: int, group, n: int) -> torch.Tensor:
    if group is None:
        return x
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + xt.shape[1:])
    if _moves(group):
        dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(g, dim: int, group, n: int) -> torch.Tensor:
    gt = g.movedim(dim, 0).contiguous()
    out = gt.new_empty((gt.shape[0] // n,) + gt.shape[1:])
    if _moves(group):
        dist.reduce_scatter_tensor(out, gt, group=group)
    return out.movedim(0, dim).contiguous()


def _all_reduce_(x, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over ``group`` in place (and returned)."""
    if _moves(group):
        dist.all_reduce(x, op=op, group=group)
    return x


def _block(g, dim: int, n: int, i: int) -> torch.Tensor:
    size = g.shape[dim] // n
    return g.narrow(dim, i * size, size).contiguous()


class _Gather(torch.autograd.Function):
    """A leaf's block -> the whole leaf; the backward sums the gradient
    over the batch's axes of each sharded dim and keeps this rank's
    block of it."""

    @staticmethod
    def forward(ctx, x, layout, plan):
        ctx.layout, ctx.plan = layout, plan
        return layout._gather(x, plan)

    @staticmethod
    def backward(ctx, g):
        return ctx.layout._scatter(g, ctx.plan), None, None


class _SumGrad(torch.autograd.Function):
    """The identity; the backward sums the gradient over ``axes``."""

    @staticmethod
    def forward(ctx, x, layout, axes):
        ctx.layout, ctx.axes = layout, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.layout._all_reduce(g, ctx.axes), None, None


@dataclass(frozen=True)
class _Plan:
    dims: Tuple        # (dim, group, n, index, summed) of each gathered dim
    rest: Tuple[str, ...]   # axes its gradient is summed over, unsharded


# a leaf's use under the model axis's split (``StepLayout.leaf``)
MODES = (None, "local", "shared")


def _key(t: torch.Tensor):
    """What names the storage of ``t`` (a gathered leaf or a view of
    one, or a detached alias) while it lives: its address, or on
    ``meta`` (where every storage is at 0) the storage object's own."""
    if t.device.type == "meta":
        return ("meta", t.untyped_storage()._cdata)
    return t.untyped_storage().data_ptr()


class _Kept:
    """A gathered tensor that autograd saves, kept as this rank's block
    (``shard``) with the call that gathers it again (``regather``). The
    saves of one gathered tensor share one ``_Kept``: the first unpack
    of the backward gathers it, the others reuse that until the last
    (``n`` saves not yet unpacked) lets it go."""

    def __init__(self, shard: torch.Tensor, regather):
        self.shard, self.regather = shard, regather
        self.n = 0
        self.full = None

    def unpack(self, shape, stride, offset) -> torch.Tensor:
        full = self.full
        if full is None:
            with torch.no_grad():
                full = self.regather(self.shard)
        self.n -= 1
        self.full = full if self.n > 0 else None
        return full.as_strided(shape, stride, offset)


class _Saved:
    """One tensor autograd saves (``t``, or a ``_Kept`` and the view of
    its gathered tensor), with the storage its bytes count against while
    the save lives (``StepLayout.saved``)."""
    __slots__ = ("t", "kept", "view", "__weakref__")

    def __init__(self, t=None, kept=None, view=None):
        self.t, self.kept, self.view = t, kept, view


class StepLayout:
    """One rank's view of a train state laid out by ``specs`` (a nested
    dict of ``Spec``, the params' tree) over ``mesh`` (a
    ``launch.mesh.TrainMesh``), with the batch's rows split over
    ``batch_axes``. Every rank of the mesh must make the same calls in
    the same order: each gather and each reduction is a collective.

    ``bytes`` counts what this rank moved since it was made: the bytes
    each gather of a leaf returned (``gathered``), the bytes each
    reduce-scatter and all-reduce of a leaf's gradient took in
    (``reduced``), and the bytes the model axis's collectives on
    activations moved (``model``: ``f``'s and ``g``'s all-reduces, the
    split norms' and cross entropy's, the SSM's gathers of B and C and
    their reduce-scatters, a sequence-split step's gathers and
    scatters of rows; an all-reduce and a reduce-scatter counted by
    their input, an all-gather by its output).

    ``split`` is the model axis's ``ModelSplit`` where ``"model"`` holds
    more than one rank, else None (every leaf then gathered whole, the
    step without the split, bit for bit); ``seq_split`` the same group
    sequence-split (``ModelSplit.seq``)."""

    def __init__(self, mesh, specs: Dict, batch_axes: Tuple[str, ...]):
        self.mesh = mesh
        self.specs = specs
        self.batch_axes = tuple(a for a in batch_axes if a in mesh.shape)
        self.n_batch = mesh.axis_size(self.batch_axes)
        self.layer_specs = {k: tree_map(lambda s: Spec(s[1:]), specs[k])
                            for k in LAYER_KEYS if k in specs}
        self.bytes = {"gathered": 0, "reduced": 0, "model": 0}
        self.saved = {"live": 0, "peak": 0}
        self._plans: Dict[Tuple[Spec, Optional[str]], _Plan] = {}
        self._full = weakref.WeakValueDictionary()
        self._live: Dict = {}        # storage key -> [saves, bytes]
        self._params = frozenset()
        m = mesh.shape.get(MODEL, 1)
        self.split = ModelSplit(self) if m > 1 else None
        self.seq_split = ModelSplit(self, seq=True) if m > 1 else None

    # ------------------------------ plans ---------------------------------
    def plan(self, spec: Spec, mode: Optional[str] = None) -> _Plan:
        """How a leaf of ``spec`` is gathered at a use of ``mode``
        (``MODES``) and how its gradient comes back."""
        p = self._plans.get((spec, mode))
        if p is None:
            if mode not in MODES:
                raise ValueError(f"a leaf's mode is one of {MODES}, not "
                                 f"{mode!r}")
            dims = []
            for d, axes in spec.dims():
                group = self.mesh.group(axes)
                if group is None or (mode == "local" and MODEL in axes):
                    continue
                summed = [a in self.batch_axes
                          or (mode == "shared" and a == MODEL)
                          for a in axes]
                if any(summed) and not all(summed):
                    raise NotImplementedError(
                        f"dim {d} of {spec} mixes the batch's axes "
                        f"{self.batch_axes} with others")
                dims.append((d, group, self.mesh.axis_size(axes),
                             self.mesh.index(axes), all(summed)))
            sharded = spec.axes()
            rest = set(self.batch_axes)
            if mode == "shared":
                rest.add(MODEL)
            rest = tuple(a for a in self.mesh.axis_names
                         if a in rest and a not in sharded)
            p = self._plans[(spec, mode)] = _Plan(
                tuple(dims), rest if self.mesh.group(rest) else ())
        return p

    # ---------------------------- collectives -----------------------------
    def _gather(self, x, plan: _Plan):
        for d, group, n, _, _ in plan.dims:
            x = _all_gather(x, d, group, n)
            self.bytes["gathered"] += x.numel() * x.element_size()
        return x

    def _scatter(self, g, plan: _Plan):
        for d, group, n, i, summed in reversed(plan.dims):
            if summed:
                self.bytes["reduced"] += g.numel() * g.element_size()
                g = _reduce_scatter(g, d, group, n)
            else:           # every rank of the group computed the same
                g = _block(g, d, n, i)
        return g

    def _all_reduce(self, g, axes):
        g = g.clone()
        self.bytes["reduced"] += g.numel() * g.element_size()
        return _all_reduce_(g, self.mesh.group(axes))

    # ------------------------------- use ----------------------------------
    def leaf(self, x: torch.Tensor, spec: Spec,
             mode: Optional[str] = None) -> torch.Tensor:
        """The whole leaf from this rank's block ``x`` (autograd: the
        gradient comes back summed over the batch's axes, as this rank's
        block), but for its ``"model"`` dim where ``mode`` is
        ``"local"``, and summed over ``"model"`` too where it is
        ``"shared"`` (``MODES``). ``x`` itself when nothing is gathered
        and nothing summed."""
        plan = self.plan(spec, mode)
        if plan.rest:
            x = _SumGrad.apply(x, self, plan.rest)
        if not plan.dims:
            return x
        full = _Gather.apply(x, self, plan)
        self.keep(full, x.detach(), functools.partial(self._gather,
                                                      plan=plan))
        return full

    def keep(self, full: torch.Tensor, shard: torch.Tensor, regather):
        """Where autograd saves ``full`` (or a view of it) inside
        ``saved_as_shards``, keep ``shard`` and ``regather(shard)`` in
        the backward instead."""
        full._kept = _Kept(shard, regather)
        self._full[_key(full)] = full

    def tree(self, tree, specs, modes=None):
        """``leaf`` of every leaf of ``tree``; ``modes`` maps a key of
        its first level to that leaf's mode (absent: None)."""
        modes = modes or {}
        return ({k: (self.tree(v, specs[k]) if isinstance(v, dict) else
                     self.leaf(v, specs[k], modes.get(k)))
                 for k, v in tree.items()}
                if isinstance(tree, dict) else self.leaf(tree, specs))

    def top(self, params, modes=None):
        """Every leaf of ``params`` outside the stacked layers, whole
        (or as ``modes`` says, as in ``tree``)."""
        rest = {k: v for k, v in params.items() if k not in LAYER_KEYS}
        return {**params, **self.tree(rest, self.specs, modes)}

    def layer(self, lp, key: str = "layers", modes=None):
        """One layer's leaves (unbound from the stack ``key``), whole
        (or as ``modes`` says, as in ``tree``)."""
        return self.tree(lp, self.layer_specs[key], modes)

    @torch.no_grad()
    def batch_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the batch's axes (no gradient)."""
        group = self.mesh.group(self.batch_axes)
        if group is None:
            return x
        return _all_reduce_(x.clone(), group)

    def norm_sums(self, sq):
        """Each leaf's sum of squares (``sq``, in ``tree_leaves`` order of
        the params) summed over the axes its leaf is sharded on: one
        all-reduce per set of axes."""
        by_axes: Dict[Tuple[str, ...], list] = {}
        for i, spec in enumerate(tree_leaves(self.specs)):
            axes = tuple(a for a in self.mesh.axis_names
                         if a in spec.axes())
            if self.mesh.group(axes) is not None:
                by_axes.setdefault(axes, []).append(i)
        sq = list(sq)
        for axes, idx in by_axes.items():
            summed = _all_reduce_(torch.stack([sq[i] for i in idx]),
                                  self.mesh.group(axes))
            for j, i in enumerate(idx):
                sq[i] = summed[j]
        return sq

    # --------------------------- saved tensors ----------------------------
    @contextmanager
    def saved_as_shards(self, params: Sequence[torch.Tensor] = ()):
        """Inside the block, a gathered tensor (or a view of one) that
        autograd saves for the backward is kept as this rank's block and
        gathered again when the backward needs it: a gathered leaf
        (``leaf``), and the rows of the residual stream gathered by a
        sequence-split step's ``f`` (``ModelSplit``). ``saved`` counts
        the bytes the saves hold, each storage once and ``params``'
        storages (the state, held anyway) not at all: ``live`` now and
        its ``peak`` since the layout was made."""
        self._params = frozenset(_key(p) for p in params)
        with torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                      self._unpack):
            yield

    def _pack(self, t: torch.Tensor) -> _Saved:
        full = self._full.get(_key(t))
        if full is None:
            saved, held = _Saved(t=t), t
        else:
            kept = full._kept
            kept.n += 1
            saved = _Saved(kept=kept, view=(t.shape, t.stride(),
                                            t.storage_offset()))
            held = kept.shard
        key = _key(held)
        if key not in self._params:
            entry = self._live.get(key)
            if entry is None:
                entry = self._live[key] = [0, held.untyped_storage().nbytes()]
                self.saved["live"] += entry[1]
                self.saved["peak"] = max(self.saved["peak"],
                                         self.saved["live"])
            entry[0] += 1
            weakref.finalize(saved, self._release, key)
        return saved

    def _release(self, key) -> None:
        entry = self._live[key]
        entry[0] -= 1
        if not entry[0]:
            del self._live[key]
            self.saved["live"] -= entry[1]

    @staticmethod
    def _unpack(saved: _Saved) -> torch.Tensor:
        if saved.kept is None:
            return saved.t
        return saved.kept.unpack(*saved.view)


# ---------------------------------------------------------------------------
# the model axis's compute split
# ---------------------------------------------------------------------------
class _F(torch.autograd.Function):
    """Megatron's f: the identity; the backward all-reduces the gradient
    over the model group (each rank's part of a column-parallel product
    gives a part of its input's gradient)."""

    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.split.all_reduce(g), None


class _G(torch.autograd.Function):
    """Megatron's g: the all-reduce of the row-parallel products' parts;
    the backward is the identity (the gradient of the sum is every
    rank's)."""

    @staticmethod
    def forward(ctx, x, split):
        return split.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Sum(torch.autograd.Function):
    """A sum over the model group that each rank then uses in its own
    way (a split norm's sum of squares): all-reduced both ways."""

    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return split.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.split.all_reduce(g), None


class _GatherLast(torch.autograd.Function):
    """Every rank's columns along the last dim, in rank order; the
    backward sums each rank's gradient of the whole and keeps this
    rank's columns (a reduce-scatter: every rank's heads read them)."""

    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        out = _all_gather(x, x.dim() - 1, split.group, split.m)
        split.layout.bytes[MODEL] += out.numel() * out.element_size()
        return out

    @staticmethod
    def backward(ctx, g):
        split = ctx.split
        split.layout.bytes[MODEL] += g.numel() * g.element_size()
        return _reduce_scatter(g, g.dim() - 1, split.group, split.m), None


class _GatherRows(torch.autograd.Function):
    """Megatron's f under sequence parallelism: every rank's rows (dim 1)
    of the residual stream, in rank order; the backward reduce-scatters
    the gradient (each rank's part of a column-parallel product gives a
    part of every row's gradient). Where autograd saves the result it
    keeps this rank's rows (``StepLayout.saved_as_shards``)."""

    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        full = split.gather_rows(x)
        split.layout.keep(full, x.detach(), split.gather_rows)
        return full

    @staticmethod
    def backward(ctx, g):
        return ctx.split.scatter_rows(g), None


class _ScatterRows(torch.autograd.Function):
    """Megatron's g under sequence parallelism: the row-parallel
    products' parts summed over the group, each rank keeping its rows (a
    reduce-scatter); the backward all-gathers the rows' gradients."""

    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return split.scatter_rows(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.split.gather_rows(g), None


class _GatherAlike(torch.autograd.Function):
    """Every rank's rows of a tensor that each rank then uses alike (a
    block computed whole, the MoE's router logits): the backward's
    gradient is the same on every rank, and each keeps its own rows."""

    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return split.gather_rows(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.split.own_rows(g).contiguous(), None


class _SplitAlike(torch.autograd.Function):
    """This rank's rows of a tensor every rank holds alike; the backward
    all-gathers the rows' gradients, so each rank has them all."""

    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return split.own_rows(x).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.split.gather_rows(g), None


class ModelSplit:
    """One rank's part of the model group (the ranks that differ only on
    ``"model"``): ``m`` ranks, this one the ``index``-th. Each rank of
    the group runs the same rows; the models split each product of a
    block whose counts divide by ``m`` (heads, hidden columns, experts,
    capacity slots, vocab rows) and join them with ``f`` and ``g``.
    Every collective is one of the group's, counted in the layout's
    ``bytes["model"]``.

    ``seq`` (the layout's ``seq_split``): the step is sequence-split
    (``RunOptions.seq_shard_activations``; Megatron's sequence
    parallelism, Korthikanti et al., 2022). The residual stream between
    the blocks is then each rank's S/m rows (dim 1), and the norms run on
    them; ``f`` all-gathers the rows before the split products
    (reduce-scatter in the backward) and ``g`` reduce-scatters the
    row-parallel sums back to rows (all-gather in the backward). A
    reduce-scatter is counted by its input and an all-gather by its
    output, so the pair counts twice the bytes of the all-reduce it
    replaces: the same traffic on the wire, as a ring all-reduce is a
    reduce-scatter then an all-gather."""

    def __init__(self, layout: "StepLayout", seq: bool = False):
        mesh = layout.mesh
        self.layout = layout
        self.m = mesh.shape[MODEL]
        self.index = mesh.index((MODEL,))
        self.group = mesh.group((MODEL,))
        self.seq = seq

    def part(self, n: int) -> Tuple[int, int]:
        """This rank's block [lo, hi) of ``n`` rows cut into ``m`` equal
        blocks (``n`` a multiple of ``m``)."""
        if n % self.m:
            raise ValueError(f"{n} does not split over {self.m} ranks")
        size = n // self.m
        return self.index * size, (self.index + 1) * size

    def span(self, n: int) -> Tuple[int, int]:
        """This rank's share [lo, hi) of ``n`` rows cut as evenly as
        they go (the first ranks' shares one smaller where ``m`` does not
        divide ``n``)."""
        return n * self.index // self.m, n * (self.index + 1) // self.m

    def all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM
                   ) -> torch.Tensor:
        """``x`` reduced over the group (a new tensor; no gradient)."""
        x = x.detach().clone()
        self.layout.bytes[MODEL] += x.numel() * x.element_size()
        return _all_reduce_(x, self.group, op)

    def f(self, x: torch.Tensor) -> torch.Tensor:
        return (_GatherRows if self.seq else _F).apply(x, self)

    def g(self, x: torch.Tensor) -> torch.Tensor:
        return (_ScatterRows if self.seq else _G).apply(x, self)

    def sum_grads(self, x: torch.Tensor) -> torch.Tensor:
        """The identity; the backward all-reduces the gradient (``f``
        without the sequence split, for a tensor whose rows are whole
        on every rank)."""
        return _F.apply(x, self)

    def gather_alike(self, x: torch.Tensor) -> torch.Tensor:
        return _GatherAlike.apply(x, self)

    def split_alike(self, x: torch.Tensor) -> torch.Tensor:
        return _SplitAlike.apply(x, self)

    def own_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the rows (dim 1) of ``x``."""
        lo, hi = self.part(x.shape[1])
        return x[:, lo:hi]

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows (dim 1) of ``x``, in rank order (no
        gradient; counted by what it returns)."""
        out = _all_gather(x, 1, self.group, self.m)
        self.layout.bytes[MODEL] += out.numel() * out.element_size()
        return out

    def scatter_rows(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the group, this rank's block of its rows
        (no gradient; counted by what it takes)."""
        self.layout.bytes[MODEL] += x.numel() * x.element_size()
        return _reduce_scatter(x, 1, self.group, self.m)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return _Sum.apply(x, self)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return _GatherLast.apply(x, self)

    # ------------------------------ serving --------------------------------
    @torch.no_grad()
    def heads_to(self, x: torch.Tensor, lists, *,
                 slots: bool) -> torch.Tensor:
        """Heads to positions, one all-to-all of the group. ``x`` (B, S,
        k, D) holds the heads ``lists[self.index]`` (global indices;
        ``lists`` has every rank's, which together cover heads 0 ..
        n - 1, a head possibly on several ranks); each head is taken
        from the first rank that holds it. Returns (B, S / m, n, D), this
        rank's block of the positions, with ``slots`` (S a multiple of
        m), else (B, S, n, D), every position. Counts the bytes it
        returns."""
        m, i = self.m, self.index
        seen, own = set(), []
        for lst in lists:
            own.append([h for h in dict.fromkeys(lst) if h not in seen])
            seen.update(own[-1])
        n_heads = len(seen)
        if sorted(seen) != list(range(n_heads)):
            raise ValueError(f"the ranks' heads {lists} are not 0 .. "
                             f"{n_heads - 1}")
        B, S, _, D = x.shape
        Sb = S // m if slots else S
        if slots and S % m:
            raise ValueError(f"{S} positions do not split over {m} ranks")
        if x.is_floating_point() and x.element_size() == 1:
            return self.heads_to(x.view(torch.uint8), lists,
                                 slots=slots).view(x.dtype)
        pos = [lists[i].index(h) for h in own[i]]
        mine = x[:, :, pos]                              # (B, S, k_own, D)
        send = (mine.reshape(B, m, Sb, len(pos), D).movedim(1, 0) if slots
                else mine.expand(m, *mine.shape))
        send = send.contiguous()
        recv = x.new_empty((B * Sb * n_heads * D,))
        sizes = [B * Sb * len(o) * D for o in own]
        if _moves(self.group):
            dist.all_to_all_single(recv, send.reshape(-1),
                                   output_split_sizes=sizes,
                                   input_split_sizes=[send[0].numel()] * m,
                                   group=self.group)
        out = x.new_empty((B, Sb, n_heads, D))
        at = 0
        for o, n in zip(own, sizes):
            if o:
                out[:, :, o] = recv[at:at + n].view(B, Sb, len(o), D)
            at += n
        self.layout.bytes[MODEL] += out.numel() * out.element_size()
        return out

    @torch.no_grad()
    def merge_softmax(self, o: torch.Tensor, l: torch.Tensor,
                      mx: torch.Tensor) -> torch.Tensor:
        """A softmax-weighted sum over positions split over the group:
        each rank's unnormalised float32 ``o`` (..., D), its row sums
        ``l`` (...) and row maxima ``mx`` (...; ``NEG_INF`` or below
        where it sees no position). Returns sum_r w_r o_r / sum_r w_r
        l_r with w_r = exp(mx_r - max_r mx_r): a rank that sees nothing
        enters with weight 0 (two all-reduces: the max, then o and l
        together)."""
        M = self.all_reduce(mx, dist.ReduceOp.MAX)
        w = torch.where(mx > NEG_INF / 2, torch.exp(mx - M),
                        torch.zeros((), dtype=mx.dtype, device=mx.device))
        both = self.all_reduce(torch.cat([o * w[..., None],
                                          (l * w)[..., None]], -1))
        return both[..., :-1] / both[..., -1:]

    @torch.no_grad()
    def argmax(self, logits: torch.Tensor) -> torch.Tensor:
        """``torch.argmax`` over the last dim of logits split over the
        group, each rank its block of the columns: the global index of
        the largest, ties to the lowest global index (two
        all-reduces: the max, then the least index holding it)."""
        i = torch.argmax(logits, dim=-1)
        v = torch.gather(logits, -1, i[..., None])[..., 0].float()
        top = self.all_reduce(v, dist.ReduceOp.MAX)
        at = torch.where(v == top, i + self.index * logits.shape[-1],
                         torch.full_like(i, torch.iinfo(i.dtype).max))
        return self.all_reduce(at, dist.ReduceOp.MIN)
