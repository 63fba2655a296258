"""int8 quantization with one scale per tensor and stochastic rounding:
the port of ``repro/distribution/compression.py``'s ``quantize_int8``
and ``dequantize``, which the warehouse's cold tier spills through
(``warehouse.tiers``), and of its ``compressed_psum`` and
``compress_grads_across_pods``, the int8 all-reduce with error feedback
over a ``torch.distributed`` group (the reference's ``'pod'`` axis).

The reference draws its rounding uniforms inside (``jax.random.uniform``
of a key); here they are an argument, so a test can pass the
reference's draws and hold the codes bit for bit, and the tier draws
its own from a seeded ``torch.Generator``. Either way each element's
error is at most its tensor's scale, max|x| / 127.

The scale is max|x| times float32(1/127), as the reference's compiled
program computes it (XLA turns the division by the constant into that
product; the cold tier always runs compiled), so the codes match the
reference's jitted ``quantize_int8`` and its tier bit for bit.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

_INV127 = float(np.float32(1.0) / np.float32(127.0))


def quantize_int8(x: torch.Tensor, r: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``x`` (..., n) to int8 with one scale per leading index
    (per tensor when ``x`` is 1-D), rounding each element up with
    probability equal to its fraction: ``r`` holds uniform draws in
    [0, 1) of ``x``'s shape. Returns (q int8, scale float32 (...,))."""
    x = x.to(torch.float32)
    scale = torch.clamp_min(x.abs().amax(-1), 1e-12) * _INV127
    y = x / scale[..., None]
    lo = torch.floor(y)
    q = lo + (r.to(x.device) < y - lo).to(torch.float32)
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 codes (..., n) times their scale (...,), in float32."""
    return q.to(torch.float32) * scale[..., None]


def compressed_psum(x: torch.Tensor, r: torch.Tensor, err: torch.Tensor,
                    group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mean of ``x`` over the ranks of ``group`` (the default group
    for ``None``) through int8, with error feedback: ``y = x + err``
    quantized with one scale per tensor (``quantize_int8``, uniforms
    ``r`` of ``x``'s shape), the codes all-reduced as int32 (exact in any
    order) and the scales summed; returns ``(total * (scale_sum / n) /
    n, y - q * scale)``, the reference's formulas. A collective: every
    rank calls it with tensors of one shape.

    The arithmetic is the reference's compiled mesh program's: the
    residual is one fused multiply-add (computed in float64, where ``q *
    scale`` is exact, then rounded once), and the scale sum adds the
    ranks' float32 scales, gathered, in rank order."""
    n = dist.get_world_size(group)
    y = x + err
    q, scale = quantize_int8(y.reshape(-1), r.reshape(-1))
    q = q.reshape(y.shape)
    new_err = (y.double() - q.double() * scale.double()).to(torch.float32)
    total = q.to(torch.int32)
    dist.all_reduce(total, group=group)
    scales = [torch.empty(1, device=y.device) for _ in range(n)]
    dist.all_gather(scales, scale.reshape(1), group=group)
    scale_sum = scales[0]
    for s in scales[1:]:
        scale_sum = scale_sum + s
    return total.to(torch.float32) * (scale_sum[0] / n) / n, new_err


def compress_grads_across_pods(grads: Dict[str, torch.Tensor],
                               errs: Dict[str, torch.Tensor],
                               draws: Dict[str, torch.Tensor], group=None):
    """``compressed_psum`` of every gradient leaf over ``group``, with
    its error-feedback residual ``errs[name]`` and its rounding uniforms
    ``draws[name]``; returns ``(mean grads, new residuals)``, dicts in
    ``grads``' order. The reference's ``jax.random.split`` of one key
    into a key a leaf is the caller's here: pass those draws to hold
    the reference's bits. Gradients must have the same shapes on every
    rank (data parallel over the group)."""
    out = {k: compressed_psum(g, draws[k], errs[k], group)
           for k, g in grads.items()}
    return ({k: v[0] for k, v in out.items()},
            {k: v[1] for k, v in out.items()})
