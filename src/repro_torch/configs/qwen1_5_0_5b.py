"""qwen1.5-0.5b [dense] — QKV bias, MHA [hf:Qwen/Qwen1.5-0.5B]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab=151936,
    head_dim=64,
    qkv_bias=True,
    mlp="swiglu",
    tie_embeddings=True,
    source="hf:Qwen/Qwen1.5-0.5B",
))
