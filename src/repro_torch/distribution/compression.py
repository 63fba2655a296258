"""int8 quantization with one scale per tensor and stochastic rounding:
the port of ``repro/distribution/compression.py``'s ``quantize_int8``
and ``dequantize``, which the warehouse's cold tier spills through
(``warehouse.tiers``).

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

from typing import Tuple

import numpy as np
import torch

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
