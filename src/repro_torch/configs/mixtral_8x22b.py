"""mixtral-8x22b [moe] — 8 experts top-2, SWA [arXiv:2401.04088]."""
from repro_torch.configs.base import ArchConfig, MoECfg, register

CONFIG = register(ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    head_dim=128,
    mlp="swiglu",
    window=4096,
    moe=MoECfg(n_experts=8, top_k=2),
    rope_theta=1_000_000.0,
    source="arXiv:2401.04088",
))
