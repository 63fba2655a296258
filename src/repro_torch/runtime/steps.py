"""Step builders: the train, prefill and decode steps shared by the
launcher, ``chip_smoke.py`` and the tests; the port of
``repro/runtime/steps.py``.

A train state is the reference's tree, ``{"params", "opt": {"m", "v",
"count"}, "step"}``, with int32 scalars for the counts, so it crosses
between the packages through ``checkpoint/ckpt.py``. The train step
differentiates ``Model.loss`` with autograd (through K3's backward kernel
on the card), accumulates microbatches as the reference does, clips,
takes the learning rate from the optimizer's count, and updates the
state in place (``optim/adamw.py``).

Across cards (``make_train_step(..., mesh=)``, one rank a card over a
``launch.mesh.TrainMesh``) the state is laid out as the reference's
``train_state_shardings`` lays it out: each leaf of the params and of
both moments is cut into the blocks its logical axes select (ZeRO-3
over ``"data"``, and over ``"model"`` where the rules put a dim there),
``count`` and ``step`` whole on every rank. Each rank runs its own rows
of the global batch (``data.tokens.local_rows``: microbatch i is the
global batch's microbatch i, split over the ranks). Inside the layer
loop each leaf is gathered at its use, a layer at a time, inside the
remat region (``distribution/sharding.StepLayout``); a gathered weight
that autograd saves is kept as its block and gathered again in the
backward. A rank's loss is its share of the global mean, so the
gathers' backward, which sums over the batch's ranks, gives each rank
its block of the global gradient. Then the global-norm clip (each
leaf's squares summed over its ranks), the rate from ``count`` and
AdamW on the blocks. The loss and the norm come back the same on every
rank. On one rank every collective is the identity, and the step is the
step without a mesh, bit for bit.

The ``"model"`` axis is computed, as the reference's activation
constraints make GSPMD compute it: the ranks of a model group run the
same rows, each its own heads (K3 and K4 at H/m), hidden columns,
experts or capacity slots and vocab rows, joined by Megatron's ``f``
and ``g`` (``sharding.ModelSplit``, ``models.transformer.split_plan``);
the leaves they consume keep their ``"model"`` dims local, gathered only
over ``"data"`` / ``"pod"``. The clip sums each split leaf's squares
over ``"model"`` once (its spec has the axis) and leaves the replicated
leaves alone, whose gradients come back equal on every rank. At a model
axis of 1 the step is the one without the split, bit for bit.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Dict, List, Tuple

import torch

from repro_torch.device import resolve
from repro_torch.distribution import sharding as shd
from repro_torch.models.model import Model, _leaves, _set, materialize
from repro_torch.optim.adamw import (adamw_init, adamw_update,
                                     clip_by_global_norm, leaves,
                                     tree_map, warmup_cosine)


def init_train_state(model: Model, generator: torch.Generator,
                     device=None, mesh=None) -> Dict:
    """Fresh params drawn from ``generator`` on ``device`` (``None``
    means CUDA), zero moments, step 0. With a ``mesh`` (a
    ``TrainMesh``; ``device`` is then its device) each leaf is drawn whole
    on the generator's device, as ``Model.init`` draws it, and only this
    rank's block is kept: the same params, laid out by
    ``train_state_shardings``."""
    if mesh is None:
        dev = resolve(device)
        params = model.init(generator, dev)
        return {"params": params, "opt": adamw_init(params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}
    specs = model.param_specs(mesh)
    params: Dict = {}
    for path, meta in _leaves(model.meta()):
        spec = specs
        for k in path:
            spec = spec[k]
        full = materialize(meta, generator, generator.device)
        _set(params, path, shd.shard_tensor(full, spec, mesh))
        del full
    return {"params": params, "opt": adamw_init(params),
            "step": torch.zeros((), dtype=torch.int32, device=mesh.device)}


def abstract_train_state(model: Model) -> Dict:
    """The train state's shapes and dtypes as tensors on ``meta``."""
    params = model.abstract_params()
    scalar = torch.empty((), dtype=torch.int32, device="meta")
    return {"params": params,
            "opt": {"m": params, "v": params, "count": scalar},
            "step": scalar}


def train_state_shardings(model: Model, mesh) -> Dict:
    """The reference's tree of placements: the moments take the params',
    ``count`` and ``step`` are whole on every rank."""
    p = model.param_shardings(mesh)
    rep = shd.Placement(mesh, shd.spec_for((), (), mesh))
    return {"params": p, "opt": {"m": p, "v": p, "count": rep}, "step": rep}


def shard_train_state(model: Model, state: Dict, mesh) -> Dict:
    """This rank's blocks of a whole train state (``init_train_state``'s
    without a mesh, a checkpoint's, or the reference's through
    ``convert.params_from_arrays``), new tensors on ``mesh.device``."""
    return shd.shard_tree(state, train_state_shardings(model, mesh))


def value_and_grad(model: Model, params, batch, layout=None
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """``Model.loss`` of ``batch`` and its float32 gradient for every leaf
    of ``params`` (in ``leaves`` order; zeros for a leaf the loss does
    not reach, as JAX gives). It differentiates detached aliases of the
    leaves (the same storage), so the caller's tensors are left as they
    were, also when the loss raises. With a ``layout`` (``params`` this
    rank's blocks, ``batch`` its rows): this rank's share of the loss and
    its block of the global gradient."""
    params = tree_map(lambda p: p.detach().requires_grad_(True), params)
    ps = leaves(params)
    with nullcontext() if layout is None else layout.saved_as_shards():
        loss = model.loss(params, batch, layout=layout)
    grads = torch.autograd.grad(loss, ps, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p, dtype=torch.float32)
                           if g is None else g.float()
                           for p, g in zip(ps, grads)]


def make_train_step(model: Model, *, peak_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000,
                    clip: float = 1.0, weight_decay: float = 0.1,
                    mesh=None):
    """``train_step(state, batch) -> (state, {"loss", "gnorm", "lr"})``.
    With ``model.opts.microbatches`` n > 1 the batch's leading axis is cut
    into n microbatches; their losses and float32 gradients are summed,
    then divided by n. Then the global-norm clip, the learning rate
    ``warmup_cosine(opt["count"])`` and AdamW. The state is updated in
    place and returned.

    With a ``mesh`` (a ``TrainMesh``) the state is this rank's blocks
    (``init_train_state(..., mesh=)``, ``shard_train_state``) and the
    batch this rank's rows of the global batch, its microbatches in
    order (``data.tokens.local_rows``); every rank of the mesh calls the
    step alike. The step's ``layout`` (``sharding.StepLayout``) counts
    the bytes it gathered, reduced and moved over ``"model"``."""
    n_mb = model.opts.microbatches
    layout = None if mesh is None else shd.StepLayout(
        mesh, model.param_specs(mesh), model.batch_axes(mesh))
    sums = None if layout is None else layout.norm_sums

    def train_step(state: Dict, batch: Dict):
        params = state["params"]
        if n_mb > 1:
            loss = torch.zeros((), dtype=torch.float32,
                               device=params["embed"].device)
            grads = None
            for i in range(n_mb):
                mb = {k: _micro(v, n_mb, i) for k, v in batch.items()}
                l, g = value_and_grad(model, params, mb, layout)
                loss = loss + l
                if grads is None:
                    grads = g
                else:
                    torch._foreach_add_(grads, g)
            loss = loss / n_mb
            torch._foreach_div_(grads, n_mb)
        else:
            loss, grads = value_and_grad(model, params, batch, layout)
        if layout is not None:      # the ranks' shares -> the global loss
            loss = layout.batch_sum(loss)
        grads, gnorm = clip_by_global_norm(grads, clip, sums)
        lr = warmup_cosine(state["opt"]["count"], peak_lr=peak_lr,
                           warmup=warmup, total=total_steps)
        params, opt = adamw_update(grads, state["opt"], params, lr=lr,
                                   weight_decay=weight_decay)
        new_state = {"params": params, "opt": opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, "gnorm": gnorm, "lr": lr}

    train_step.layout = layout
    return train_step


def _micro(x, n: int, i: int):
    """Microbatch ``i`` of ``n`` of a batch entry (array or tensor): rows
    [i B/n, (i + 1) B/n), as the reference's reshape to (n, B/n, ...)."""
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} does not split into "
                         f"{n} microbatches")
    b = x.shape[0] // n
    return x[i * b:(i + 1) * b]


def make_prefill_step(model: Model):
    def prefill_step(params, batch):
        return model.prefill(params, batch)
    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, cache, token):
        return model.decode_step(params, cache, token)
    return decode_step
