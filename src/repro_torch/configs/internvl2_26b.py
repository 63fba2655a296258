"""internvl2-26b [vlm] — InternViT frontend (STUB: precomputed patch
embeddings) + InternLM2 26B-class language backbone [arXiv:2404.16821]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92553,
    head_dim=128,
    mlp="swiglu",
    frontend="patch",
    frontend_tokens=256,   # stub patch embeddings prepended to the text
    source="arXiv:2404.16821",
))
