"""Architecture configs: the port's own copy of ``repro/configs/base.py``.

Each architecture module in this package exports ``CONFIG`` with the
published numbers and registers it; ``get(name)`` looks one up and
``reduced()`` gives the tiny same-family config the CPU tests use. The
zoo is the reference's ten: qwen1.5-0.5b, llama3-8b, nemotron-4-15b and
qwen1.5-110b (dense), internvl2-26b (vlm), mixtral-8x7b and
mixtral-8x22b (moe), mamba2-370m (ssm), hymba-1.5b (hybrid) and
whisper-large-v3 (encdec).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class MoECfg:
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMCfg:
    d_state: int = 128
    head_dim: int = 64
    d_inner: int = 0          # 0 -> 2*d_model
    chunk: int = 256          # SSD chunk length
    n_groups: int = 1
    conv_width: int = 4


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0         # 0 -> d_model // n_heads
    qkv_bias: bool = False
    mlp: str = "swiglu"       # swiglu | relu2 | gelu
    window: Optional[int] = None          # sliding-window attention size
    global_layers: Tuple[int, ...] = ()   # layers with full attention (hybrid)
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    n_enc_layers: int = 0
    max_target_len: int = 448
    frontend: str = "none"    # modality frontend stub: none | patch | audio
    frontend_tokens: int = 0
    source: str = ""

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def d_inner(self) -> int:
        if self.ssm is None:
            return 0
        return self.ssm.d_inner or 2 * self.d_model

    @property
    def ssm_heads(self) -> int:
        if self.ssm is None:
            return 0
        return self.d_inner // self.ssm.head_dim

    def param_count(self, active_only: bool = False) -> int:
        """The reference's analytic count: the projections, the MLP (or
        the experts and router), the SSM block's projections, conv and
        per-head vectors, and the embedding and head; norms are left
        out."""
        d = self.d_model
        n = 0
        if self.family == "ssm":
            n += self._ssm_layer_params() * self.n_layers
        elif self.family == "hybrid":
            n += (self._attn_params() + self._ssm_layer_params(hybrid=True)
                  + self._mlp_params()) * self.n_layers
        else:
            n += (self._attn_params() + self._mlp_params(active_only)) \
                * self.n_layers
        if self.n_enc_layers:
            # encoder layers (attention and MLP), and the decoder's
            # cross-attention
            enc = 4 * d * d + self._mlp_params()
            n += self.n_enc_layers * enc + 4 * d * d * self.n_layers
        n += self.vocab * d * (1 if self.tie_embeddings else 2)
        return n

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.hd
        return (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                + self.n_heads * hd * d)

    def _mlp_params(self, active_only: bool = False) -> int:
        d = self.d_model
        dense = (3 if self.mlp == "swiglu" else 2) * d * self.d_ff
        if self.moe is None:
            return dense
        e = self.moe.top_k if active_only else self.moe.n_experts
        return e * dense + d * self.moe.n_experts

    def _ssm_layer_params(self, hybrid: bool = False) -> int:
        """One mamba2 block (the hybrid's at di = n_heads * hd; the pure
        SSM family has no separate MLP)."""
        d, s = self.d_model, self.ssm
        di = self.n_heads * self.hd if hybrid else self.d_inner
        nh = di // s.head_dim
        in_proj = d * (2 * di + 2 * s.n_groups * s.d_state + nh)
        conv = s.conv_width * (di + 2 * s.n_groups * s.d_state)
        return in_proj + di * d + conv + nh

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU tests (the reference's
        numbers, so both sides build the same shapes)."""
        kw = dict(
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=(min(self.n_kv_heads, 4)
                        if self.n_kv_heads < self.n_heads else 4),
            d_ff=128,
            vocab=256,
            head_dim=16,
            window=min(self.window, 32) if self.window else None,
            global_layers=(0,) if self.global_layers else (),
            frontend_tokens=(min(self.frontend_tokens, 8)
                             if self.frontend_tokens else 0),
        )
        if self.moe is not None:
            kw["moe"] = MoECfg(n_experts=4, top_k=2)
        if self.ssm is not None:
            kw["ssm"] = SSMCfg(d_state=16, head_dim=16, d_inner=128, chunk=16)
        if self.n_enc_layers:
            kw["n_enc_layers"] = 2
            kw["max_target_len"] = 16
        return dataclasses.replace(self, **kw)


_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def registry() -> Dict[str, ArchConfig]:
    """Every config by name; the architecture modules are imported here
    for their side effect."""
    from repro_torch.configs import (  # noqa: F401
        hymba_1_5b, internvl2_26b, llama3_8b, mamba2_370m, mixtral_8x7b,
        mixtral_8x22b, nemotron_4_15b, qwen1_5_0_5b, qwen1_5_110b,
        whisper_large_v3)
    return dict(_REGISTRY)


def get(name: str) -> ArchConfig:
    """The registered config ``name``."""
    configs = registry()
    if name not in configs:
        raise KeyError(f"{name!r} is not a config of the zoo; it has "
                       f"{sorted(configs)}")
    return configs[name]
