"""hymba-1.5b [hybrid] — parallel attention and mamba heads in every
layer, sliding-window attention with 3 global full-attention layers
[arXiv:2411.13676]. Meta tokens omitted, as in the reference."""
from repro_torch.configs.base import ArchConfig, SSMCfg, register

CONFIG = register(ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32001,
    head_dim=64,
    mlp="swiglu",
    window=1024,
    global_layers=(0, 15, 31),   # full attention; the rest use the window
    ssm=SSMCfg(d_state=16, head_dim=64, d_inner=1600, chunk=256, n_groups=1),
    source="arXiv:2411.13676",
))
