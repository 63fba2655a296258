"""AdamW with decoupled weight decay, global-norm clipping and the
warmup-cosine schedule: the port of ``repro/optim/adamw.py``.

The state keeps the reference's layout, ``{"m", "v", "count"}`` with
``count`` an int32 scalar, so a train state crosses between the two
packages through a checkpoint. The formula is the reference's, operation
for operation in float32: ``b1 = 0.9``, ``b2 = 0.95``, ``eps = 1e-8``,
the bias corrections ``1 - b ** count`` with ``count`` in float32, the
decoupled decay ``p - lr * (step + weight_decay * p)`` and the clip's
``max(g, 1e-9)``.

One deliberate difference (ROADMAP): the reference returns new arrays,
as JAX must; here ``adamw_update`` and ``clip_by_global_norm`` update
the params, the moments and the gradients in place, under
``torch.no_grad()``, so a step holds no second copy of the state.

A tree is a nested dict of tensors; its leaves are taken in sorted key
order (``jax.tree.leaves``'s order), which fixes the order of the global
norm's sum.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict (in sorted key order) or list."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` on every tensor of a nested dict, the structure kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def adamw_init(params) -> Dict:
    """Zero moments shaped as ``params`` and a zero int32 count."""
    dev = leaves(params)[0].device
    return {"m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` in place by min(1, max_norm / max(g, 1e-9)), g their
    global norm. Returns (grads, g)."""
    g = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0)
    torch._foreach_mul_(leaves(grads), scale)
    return grads, g


@torch.no_grad()
def adamw_update(grads, opt_state, params, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1):
    """One AdamW step, in place on ``params`` and the moments; ``grads``
    a tree like ``params`` or its leaves in ``leaves`` order, ``lr`` a
    float32 scalar tensor (or a number). Returns (params, new opt state),
    the state's count advanced by one."""
    c = opt_state["count"] + 1
    cf = c.float()
    bc1 = 1 - b1 ** cf
    bc2 = 1 - b2 ** cf
    for p, m, v, g in zip(leaves(params), leaves(opt_state["m"]),
                          leaves(opt_state["v"]), leaves(grads)):
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        p.sub_(lr * (step + weight_decay * p))
    return params, {"m": opt_state["m"], "v": opt_state["v"], "count": c}


def warmup_cosine(step, *, peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor): linear warmup to
    ``peak_lr`` over ``warmup`` steps, then a cosine down to ``floor`` of
    it at ``total``. float32."""
    s = step.float()
    warm = peak_lr * s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup, warm, cos)
