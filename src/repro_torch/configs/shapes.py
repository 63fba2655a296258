"""Assigned input shapes and (arch x shape) applicability: the port's
own copy of ``repro/configs/shapes.py``.

LM transformer shapes are seq_len x global_batch. ``decode_*``/``long_*``
lower ``serve_step`` (one new token against a KV cache of seq_len), NOT
``train_step``. ``long_500k`` requires sub-quadratic attention: run for
SSM / hybrid / SWA archs, skip (documented) for pure full-attention archs.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ArchConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k":    ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k":  ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k":   ShapeSpec("long_500k", "decode", 524_288, 1),
}

# Archs whose attention cost/cache is sub-quadratic / bounded in seq_len:
# SSM (mamba2), hybrid (hymba: SWA + 3 global layers), SWA MoEs (mixtral).
SUBQUADRATIC = {"mamba2-370m", "hymba-1.5b", "mixtral-8x7b", "mixtral-8x22b"}


def applicable(arch: ArchConfig, shape: ShapeSpec) -> bool:
    if shape.name == "long_500k":
        return arch.name in SUBQUADRATIC
    return True


def skip_reason(arch: ArchConfig, shape: ShapeSpec) -> str:
    if shape.name == "long_500k" and arch.name not in SUBQUADRATIC:
        return ("pure full-attention arch: 500k-token decode needs a "
                "sub-quadratic attention mechanism (see DESIGN.md §5)")
    return ""


def all_cells():
    """Yield (arch_name, shape_name, runnable, reason) for all 40 cells."""
    from repro_torch.configs.base import registry
    for aname, acfg in sorted(registry().items()):
        for sname, sspec in SHAPES.items():
            ok = applicable(acfg, sspec)
            yield aname, sname, ok, ("" if ok else skip_reason(acfg, sspec))
