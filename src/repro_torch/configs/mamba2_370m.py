"""mamba2-370m [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060]."""
from repro_torch.configs.base import ArchConfig, SSMCfg, register

CONFIG = register(ArchConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,          # attention-free
    n_kv_heads=0,
    d_ff=0,             # no separate MLP; mamba block only
    vocab=50280,
    ssm=SSMCfg(d_state=128, head_dim=64, d_inner=2048, chunk=256, n_groups=1),
    tie_embeddings=True,
    source="arXiv:2405.21060",
))
