"""whisper-large-v3 [audio] — enc-dec transformer backbone; the conv audio
frontend is a STUB (the caller passes precomputed frame embeddings)
[arXiv:2212.04356]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,          # decoder layers
    n_enc_layers=32,      # encoder layers
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,        # MHA
    d_ff=5120,
    vocab=51866,
    head_dim=64,
    mlp="gelu",
    max_target_len=448,
    frontend="audio",
    source="arXiv:2212.04356",
))
