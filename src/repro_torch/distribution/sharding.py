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
  unpacks it, so a step holds one gathered layer at a time.
- ``batch_sum`` all-reduces over the batch's axes (the loss, the MoE
  load-balance counts); ``norm_sums`` sums each leaf's sum of squares
  over the axes it is sharded on (the global-norm clip).

A deliberate difference: the reference's ``shard()`` constraints on
activations change no value, and the port does not put them into the
models. It lays the batch out itself (``data/tokens.local_rows``): each
rank runs its own rows through the whole model.
"""
from __future__ import annotations

import math
import weakref
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.optim.adamw import tree_map

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
def _all_gather(x, dim: int, group, n: int) -> torch.Tensor:
    if group is None:
        return x
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + xt.shape[1:])
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(g, dim: int, group, n: int) -> torch.Tensor:
    gt = g.movedim(dim, 0).contiguous()
    out = gt.new_empty((gt.shape[0] // n,) + gt.shape[1:])
    dist.reduce_scatter_tensor(out, gt, group=group)
    return out.movedim(0, dim).contiguous()


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
    dims: Tuple        # (dim, group, n, index, summed) of each sharded dim
    rest: Tuple[str, ...]   # batch axes the leaf is not sharded on


class StepLayout:
    """One rank's view of a train state laid out by ``specs`` (a nested
    dict of ``Spec``, the params' tree) over ``mesh`` (a
    ``launch.mesh.TrainMesh``), with the batch's rows split over
    ``batch_axes``. Every rank of the mesh must make the same calls in
    the same order: each gather and each reduction is a collective.

    ``bytes`` counts what this rank moved since it was made: the bytes
    each gather returned (``gathered``), and the bytes each
    reduce-scatter and all-reduce took in (``reduced``)."""

    def __init__(self, mesh, specs: Dict, batch_axes: Tuple[str, ...]):
        self.mesh = mesh
        self.specs = specs
        self.batch_axes = tuple(a for a in batch_axes if a in mesh.shape)
        self.n_batch = mesh.axis_size(self.batch_axes)
        self.layer_specs = {k: tree_map(lambda s: Spec(s[1:]), specs[k])
                            for k in LAYER_KEYS if k in specs}
        self.bytes = {"gathered": 0, "reduced": 0}
        self._plans: Dict[Spec, _Plan] = {}
        self._full = weakref.WeakValueDictionary()

    # ------------------------------ plans ---------------------------------
    def plan(self, spec: Spec) -> _Plan:
        p = self._plans.get(spec)
        if p is None:
            dims = []
            for d, axes in spec.dims():
                group = self.mesh.group(axes)
                if group is None:
                    continue
                summed = [a in self.batch_axes for a in axes]
                if any(summed) and not all(summed):
                    raise NotImplementedError(
                        f"dim {d} of {spec} mixes the batch's axes "
                        f"{self.batch_axes} with others")
                dims.append((d, group, self.mesh.axis_size(axes),
                             self.mesh.index(axes), all(summed)))
            sharded = spec.axes()
            rest = tuple(a for a in self.batch_axes if a not in sharded)
            p = self._plans[spec] = _Plan(
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
        dist.all_reduce(g, group=self.mesh.group(axes))
        return g

    # ------------------------------- use ----------------------------------
    def leaf(self, x: torch.Tensor, spec: Spec) -> torch.Tensor:
        """The whole leaf from this rank's block ``x`` (autograd: the
        gradient comes back summed over the batch's axes, as this rank's
        block). ``x`` itself when nothing is sharded over more than one
        rank and the batch is not split."""
        plan = self.plan(spec)
        if plan.rest:
            x = _SumGrad.apply(x, self, plan.rest)
        if not plan.dims:
            return x
        full = _Gather.apply(x, self, plan)
        full._shard = (x.detach(), plan)
        self._full[full.untyped_storage().data_ptr()] = full
        return full

    def tree(self, tree, specs):
        return ({k: self.tree(v, specs[k]) for k, v in tree.items()}
                if isinstance(tree, dict) else self.leaf(tree, specs))

    def top(self, params):
        """Every leaf of ``params`` outside the stacked layers, whole."""
        return {k: (v if k in LAYER_KEYS else self.tree(v, self.specs[k]))
                for k, v in params.items()}

    def layer(self, lp, key: str = "layers"):
        """One layer's leaves (unbound from the stack ``key``), whole."""
        return self.tree(lp, self.layer_specs[key])

    @torch.no_grad()
    def batch_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the batch's axes (no gradient)."""
        group = self.mesh.group(self.batch_axes)
        if group is None:
            return x
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

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
            summed = torch.stack([sq[i] for i in idx])
            dist.all_reduce(summed, group=self.mesh.group(axes))
            for j, i in enumerate(idx):
                sq[i] = summed[j]
        return sq

    # --------------------------- saved tensors ----------------------------
    @contextmanager
    def saved_as_shards(self):
        """Inside the block, a gathered leaf (or a view of one) that
        autograd saves for the backward is kept as this rank's block and
        gathered again when the backward needs it."""
        def pack(t):
            base = t if t._base is None else t._base
            full = self._full.get(base.untyped_storage().data_ptr())
            if full is None:
                return t
            x, plan = full._shard
            return (x, plan, t.shape, t.stride(), t.storage_offset())

        def unpack(p):
            if isinstance(p, torch.Tensor):
                return p
            x, plan, shape, stride, offset = p
            with torch.no_grad():
                full = self._gather(x, plan)
            return full.as_strided(shape, stride, offset)

        with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            yield
