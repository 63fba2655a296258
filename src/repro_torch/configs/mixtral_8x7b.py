"""mixtral-8x7b [moe] — 8 experts top-2, SWA [arXiv:2401.04088]."""
from repro_torch.configs.base import ArchConfig, MoECfg, register

CONFIG = register(ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    head_dim=128,
    mlp="swiglu",
    window=4096,
    moe=MoECfg(n_experts=8, top_k=2),
    rope_theta=1_000_000.0,
    source="arXiv:2401.04088",
))
