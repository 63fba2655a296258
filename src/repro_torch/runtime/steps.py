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
axis of 1 the step is the one without the split, bit for bit. With
``seq_shard_activations`` (in ``model.opts``) the train step and the
prefill also split the residual stream's rows over ``"model"``
(``models.transformer.splits``); the decode step ignores it.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Dict, List, Tuple

import torch

from repro_torch.device import resolve
from repro_torch.distribution import sharding as shd
from repro_torch.models.model import Model, _leaves, _set, materialize
from repro_torch.models.transformer import ParamMeta, splits
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
    with nullcontext() if layout is None else layout.saved_as_shards(ps):
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


def init_params(model: Model, generator: torch.Generator, device=None,
                mesh=None) -> Dict:
    """Serving params drawn from ``generator`` a layer slice at a time,
    so no whole stacked leaf is ever drawn (qwen1.5-110b's ``w_gate`` is
    (80, 8,192, 49,152): 129 GB in float32): each leaf in sorted key
    order, a stacked one layer by layer, each slice scaled as the whole
    leaf's rows are. On ``device`` (None means CUDA) without a ``mesh``;
    with one (a ``TrainMesh``) each slice is cut to this rank's block
    as it is drawn (``param_specs``), on the mesh's device.

    The draws are ``Model.init``'s on the CPU's generator wherever a
    slice's element count is a multiple of 16 (torch's normal sampler
    fills blocks of 16), so at every width of the zoo; a CUDA
    generator's Philox offset moves by a call's launch shape, so there
    the draws differ from the whole-leaf ones. Compare only params drawn
    alike: both sides of a comparison call this."""
    dev = mesh.device if mesh is not None else resolve(device)
    specs = None if mesh is None else model.param_specs(mesh)

    def put(x, spec):
        return (x.to(dev) if spec is None
                else shd.shard_tensor(x, spec, mesh))
    params: Dict = {}
    for path, meta in _leaves(model.meta()):
        spec = specs
        for k in path if specs is not None else ():
            spec = spec[k]
        if path[0] not in shd.LAYER_KEYS:
            _set(params, path, put(materialize(meta, generator,
                                               generator.device), spec))
            continue
        row = ParamMeta(meta.shape[1:], meta.init, meta.dtype,
                        tuple(d - 1 for d in meta.fan_in_dims),
                        meta.axes[1:])
        rspec = None if spec is None else shd.Spec(spec[1:])
        block = None
        for li in range(meta.shape[0]):
            x = put(materialize(row, generator, generator.device), rspec)
            if block is None:
                block = torch.empty((meta.shape[0],) + x.shape,
                                    dtype=x.dtype, device=dev)
            block[li] = x
            del x
        _set(params, path, block)
    return params


def _serve_layout(model: Model, mesh):
    return None if mesh is None else shd.StepLayout(
        mesh, model.param_specs(mesh), model.batch_axes(mesh))


def _whole_logits(model: Model, layout, logits):
    """A vocab-split step's logits gathered whole over the model group
    (not counted: only the comparisons ask for them)."""
    vsp = splits(layout, model.cfg, model.opts).vocab
    if vsp is None:
        return logits
    return shd._all_gather(logits, logits.dim() - 1, vsp.group, vsp.m)


def make_prefill_step(model: Model, mesh=None, *, logits: bool = False):
    """``prefill_step(params, batch, cache_len=None) -> (next token,
    cache)``, and with ``logits`` the last position's logits, whole.

    With a ``mesh`` (a ``TrainMesh``; the reference's ``lower_cell``
    lays prefill out so) ``params`` are this rank's blocks by
    ``param_shardings`` (``init_params(..., mesh=)``, or
    ``shard_tensor`` of whole ones): ZeRO-3 over ``"data"``, gathered a
    layer at a time at use, and ``"model"`` computed as the train step
    computes it (``sharding.ModelSplit``: K3 and K4 on this rank's
    heads). ``batch`` is this rank's rows of the global batch, cut over
    ``("pod", "data")`` (``data.tokens.local_rows``); rows that do not
    split over those axes are whole on every rank, as ``spec_for`` drops
    an axis that does not divide, and so is every leaf dim that does not
    divide its axes. The cache comes back as the reference lays it out:
    k and v this rank's block of the slots (``"cache_seq"`` on
    ``"model"``, moved from heads to slots by one all-to-all; whole where
    the slots do not divide), the SSM state and conv caches as this rank
    computed them. The step's ``layout.bytes`` counts what it moved. At
    one rank it is the step without a mesh, bit for bit."""
    layout = _serve_layout(model, mesh)

    def prefill_step(params, batch, cache_len=None):
        out = model.prefill(params, batch, cache_len=cache_len,
                            layout=layout, logits=logits)
        if logits:
            return out[0], out[1], _whole_logits(model, layout, out[2])
        return out
    prefill_step.layout = layout
    return prefill_step


def make_decode_step(model: Model, mesh=None, *, logits: bool = False):
    """``decode_step(params, cache, token) -> (next token, cache)``, and
    with ``logits`` the step's logits, whole. With a ``mesh``, ``params``
    and ``token`` as ``make_prefill_step``'s and ``cache`` its: the new
    token's q, k and v gathered over ``"model"``, its slot written by the
    rank that holds it, each rank's slots attended and the softmax
    merged over ``"model"``, the next token the argmax over the vocab
    split. The cache is updated in place."""
    layout = _serve_layout(model, mesh)

    def decode_step(params, cache, token):
        out = model.decode_step(params, cache, token, layout=layout,
                                logits=logits)
        if logits:
            return out[0], out[1], _whole_logits(model, layout, out[2])
        return out
    decode_step.layout = layout
    return decode_step
