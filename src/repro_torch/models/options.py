"""Runtime options (orthogonal to ``ArchConfig``): the port's copy of
``repro/models/options.py`` with the fields a one-card run reads.
Sharding rules and MoE knobs come with the slices that need them."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RunOptions:
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "full"            # none | full | dots (training only)
    layer_loop: str = "scan"       # scan | unroll: both are a layer loop here
    q_chunk: int = 512             # the reference's attention chunking;
    kv_chunk: int = 1024           # K3 picks its own tiles
    ssd_chunk: int = 256           # SSD chunk length (K4's Q)
