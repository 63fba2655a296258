from repro_torch.configs.base import (ArchConfig, MoECfg, SSMCfg, get,
                                      registry)
from repro_torch.configs.shapes import (SHAPES, ShapeSpec, all_cells,
                                        applicable)

__all__ = [
    "ArchConfig", "MoECfg", "SSMCfg", "get", "registry",
    "SHAPES", "ShapeSpec", "all_cells", "applicable",
]
