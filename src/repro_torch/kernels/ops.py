"""Frame ops around the kernels: the port of ``repro/kernels/ops.py``'s
``tile_frames`` (the paper's tiling knob), a reshape and not a kernel.
The kernel wrappers themselves live in ``frame_preproc`` (K2),
``flash_attention`` (K3) and ``warehouse_agg`` (K1)."""
from __future__ import annotations

import torch


def tile_frames(frame: torch.Tensor, tiles: int) -> torch.Tensor:
    """Split (B,H,W,C) into t x t tiles stacked on the batch axis
    (t = sqrt(tiles))."""
    t = int(tiles ** 0.5)
    if t * t != tiles:
        raise ValueError("tiles must be a square number")
    if t == 1:
        return frame
    B, H, W, C = frame.shape
    x = frame.reshape(B, t, H // t, t, W // t, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B * t * t, H // t, W // t, C)
