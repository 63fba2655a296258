"""The guard of a kernel launch that has no backward (K1, K2, K4's passes
launched one at a time, and K3's forward called alone): its wrapper
fills its result through ctypes, so autograd would see a result with no
gradient and hand zeros upstream without a word."""
from __future__ import annotations

import torch


def refuse_grad(what: str, *tensors) -> None:
    """Raise, naming ``what``, when grad mode is on and one of
    ``tensors`` requires a gradient: a kernel without a backward must
    not hand autograd a result that silently has none."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{what} has no backward yet: run it under "
                           "torch.no_grad(), or on the CPU, whose plain "
                           "version autograd differentiates")
