"""Step builders: the train, prefill and decode steps shared by the
launcher, ``chip_smoke.py`` and the tests; the port of
``repro/runtime/steps.py``.

A train state is the reference's tree, ``{"params", "opt": {"m", "v",
"count"}, "step"}``, with int32 scalars for the counts, so it crosses
between the packages through ``checkpoint/ckpt.py``. The train step
differentiates ``Model.loss`` with autograd (through K3's backward kernel
on the card), accumulates microbatches as the reference does, clips,
takes the learning rate from the optimizer's count, and updates the
state in place (``optim/adamw.py``). The reference's
``abstract_train_state`` and ``train_state_shardings`` describe a mesh
and have no counterpart on one card (ROADMAP, Queue 1).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.device import resolve
from repro_torch.models.model import Model
from repro_torch.optim.adamw import (adamw_init, adamw_update,
                                     clip_by_global_norm, leaves,
                                     tree_map, warmup_cosine)


def init_train_state(model: Model, generator: torch.Generator,
                     device=None) -> Dict:
    """Fresh params drawn from ``generator`` on ``device`` (``None``
    means CUDA), zero moments, step 0."""
    dev = resolve(device)
    params = model.init(generator, dev)
    return {"params": params, "opt": adamw_init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def value_and_grad(model: Model, params, batch
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """``Model.loss`` of ``batch`` and its float32 gradient for every leaf
    of ``params`` (in ``leaves`` order; zeros for a leaf the loss does
    not reach, as JAX gives). It differentiates detached aliases of the
    leaves (the same storage), so the caller's tensors are left as they
    were, also when the loss raises."""
    params = tree_map(lambda p: p.detach().requires_grad_(True), params)
    ps = leaves(params)
    loss = model.loss(params, batch)
    grads = torch.autograd.grad(loss, ps, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p, dtype=torch.float32)
                           if g is None else g.float()
                           for p, g in zip(ps, grads)]


def make_train_step(model: Model, *, peak_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000,
                    clip: float = 1.0, weight_decay: float = 0.1):
    """``train_step(state, batch) -> (state, {"loss", "gnorm", "lr"})``.
    With ``model.opts.microbatches`` n > 1 the batch's leading axis is cut
    into n microbatches; their losses and float32 gradients are summed,
    then divided by n. Then the global-norm clip, the learning rate
    ``warmup_cosine(opt["count"])`` and AdamW. The state is updated in
    place and returned."""
    n_mb = model.opts.microbatches

    def train_step(state: Dict, batch: Dict):
        params = state["params"]
        if n_mb > 1:
            loss = torch.zeros((), dtype=torch.float32,
                               device=params["embed"].device)
            grads = None
            for i in range(n_mb):
                mb = {k: _micro(v, n_mb, i) for k, v in batch.items()}
                l, g = value_and_grad(model, params, mb)
                loss = loss + l
                if grads is None:
                    grads = g
                else:
                    torch._foreach_add_(grads, g)
            loss = loss / n_mb
            torch._foreach_div_(grads, n_mb)
        else:
            loss, grads = value_and_grad(model, params, batch)
        grads, gnorm = clip_by_global_norm(grads, clip)
        lr = warmup_cosine(state["opt"]["count"], peak_lr=peak_lr,
                           warmup=warmup, total=total_steps)
        params, opt = adamw_update(grads, state["opt"], params, lr=lr,
                                   weight_decay=weight_decay)
        new_state = {"params": params, "opt": opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, "gnorm": gnorm, "lr": lr}

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
