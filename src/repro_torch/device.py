"""The port's one device rule: ``None`` means ``"cuda"``, and a missing
card is an error, never a silent move to the CPU."""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise ``RuntimeError`` when CUDA is asked
    for (explicitly or by default) and no card is visible. ``"cpu"``
    must be asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev
