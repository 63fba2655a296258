"""qwen1.5-110b [dense] — QKV bias, GQA [hf:Qwen/Qwen1.5-110B]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab=152064,
    head_dim=128,
    qkv_bias=True,
    mlp="swiglu",
    source="hf:Qwen/Qwen1.5-110B",
))
