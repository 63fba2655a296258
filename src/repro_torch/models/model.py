"""Model facade: init / forward / prefill / decode, the port of
``repro/models/model.py`` for the families the port runs."""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve
from repro_torch.models import transformer as tf
from repro_torch.models.options import RunOptions
from repro_torch.models.transformer import ParamMeta

PM = ParamMeta


def _leaves(tree, prefix=()):
    """(path, meta) pairs in sorted key order (``jax.tree``'s order)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


_UNIFORM = {"ssm_a": (1.0, 16.0), "dt_bias": (1e-3, 1e-1)}


def materialize(meta: ParamMeta, generator: torch.Generator, device):
    """One parameter from its meta, as the reference's init kinds:
    ``normal`` scaled by 1/sqrt(fan-in), ``embed`` normal x 0.02,
    ``ssm_a`` (A_log: log of U[1, 16]), ``dt_bias`` (the inverse softplus
    of U[1e-3, 1e-1]) and ``zeros`` / ``ones``. Draws come from
    ``generator`` on its own device, so a seed gives the same weights on
    every target device."""
    dt = getattr(torch, meta.dtype)
    if meta.init == "zeros":
        return torch.zeros(meta.shape, dtype=dt, device=device)
    if meta.init == "ones":
        return torch.ones(meta.shape, dtype=dt, device=device)
    if meta.init in _UNIFORM:
        lo, hi = _UNIFORM[meta.init]
        u = lo + (hi - lo) * torch.rand(meta.shape, generator=generator,
                                        dtype=torch.float32,
                                        device=generator.device)
        x = torch.log(u) if meta.init == "ssm_a" else torch.log(torch.expm1(u))
        return x.to(device=device, dtype=dt)
    x = torch.randn(meta.shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    if meta.init == "embed":
        x = x * 0.02
    elif meta.init == "normal":
        fan_in = math.prod(meta.shape[d] for d in meta.fan_in_dims) or 1
        x = x * (1.0 / math.sqrt(fan_in))
    else:
        raise NotImplementedError(f"init kind {meta.init!r} comes with the "
                                  "families that use it")
    return x.to(device=device, dtype=dt)


class Model:
    def __init__(self, cfg: ArchConfig, opts: RunOptions = RunOptions()):
        tf.check_family(cfg)
        self.cfg = cfg
        self.opts = opts

    # ----------------------------- params --------------------------------
    def meta(self) -> Dict[str, Any]:
        m = tf.model_meta(self.cfg)
        if self.opts.param_dtype != "float32":
            # serving-mode weights (e.g. bf16): matrices only, norms fp32
            def cast(tree):
                return {k: cast(v) if isinstance(v, dict) else
                        (PM(v.shape, v.init, self.opts.param_dtype,
                            v.fan_in_dims)
                         if len(v.shape) >= 2 and v.dtype == "float32"
                         else v)
                        for k, v in tree.items()}
            m = cast(m)
        return m

    def init(self, generator: torch.Generator, device=None) -> Dict:
        """Random parameters on ``device`` (``None`` means CUDA), drawn
        from ``generator`` leaf by leaf in sorted key order."""
        dev = resolve(device)
        params: Dict = {}
        for path, meta in _leaves(self.meta()):
            _set(params, path, materialize(meta, generator, dev))
        return params

    # ----------------------------- steps ---------------------------------
    @staticmethod
    def _tokens(params, tokens):
        return torch.as_tensor(tokens, device=params["embed"].device)

    def forward_logits(self, params, batch):
        embeds = batch.get("embeds")
        logits, _, _ = tf.lm_forward(params, self.cfg, self.opts,
                                     self._tokens(params, batch["tokens"]),
                                     embeds)
        return logits

    def prefill(self, params, batch, cache_len: Optional[int] = None):
        return tf.lm_prefill(params, self.cfg, self.opts,
                             self._tokens(params, batch["tokens"]),
                             batch.get("embeds"), cache_len=cache_len)

    def decode_step(self, params, cache, token):
        return tf.lm_decode_step(params, self.cfg, self.opts, cache,
                                 self._tokens(params, token))

    # ------------------------- cache metadata ----------------------------
    def cache_len(self, seq_len: int) -> int:
        cfg = self.cfg
        if cfg.window is not None and not cfg.global_layers:
            return min(seq_len, cfg.window)  # uniform SWA: ring buffer
        return seq_len

    def cache_meta(self, batch: int, seq_len: int) -> Dict[str, Any]:
        cfg, cdt = self.cfg, self.opts.compute_dtype
        L = cfg.n_layers
        pos = PM((), "zeros", "int32")
        Sc = self.cache_len(seq_len)

        def ssm_pm(di):
            s = cfg.ssm
            GN, cw = s.n_groups * s.d_state, s.conv_width - 1
            return {
                "ssm": PM((L, batch, di // s.head_dim, s.head_dim,
                           s.d_state), "zeros", "float32"),
                "conv_x": PM((L, batch, cw, di), "zeros", cdt),
                "conv_b": PM((L, batch, cw, GN), "zeros", cdt),
                "conv_c": PM((L, batch, cw, GN), "zeros", cdt)}

        if cfg.family == "ssm":
            return {"layers": ssm_pm(cfg.d_inner), "pos": pos}
        kv = PM((L, batch, Sc, cfg.n_kv_heads, cfg.hd), "zeros", cdt)
        layers = {"k": kv, "v": kv}
        if cfg.family == "hybrid":
            layers.update(ssm_pm(cfg.n_heads * cfg.hd))
        return {"layers": layers, "pos": pos,
                "slot_pos": PM((Sc,), "zeros", "int32")}
