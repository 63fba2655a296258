"""Decoder stack: the port of ``repro/models/transformer.py`` for the
dense (and vlm) family and the SSM family (mamba2) — prefill / forward
and decode.

Parameters are a plain dict with the reference's layout: ``embed`` (Vp,
d), ``final_ln``, optional ``head``, and ``layers`` whose leaves are
stacked on a leading L axis. The reference's ``lax.scan`` over layers is
a Python loop over that axis. MoE, hybrid and encoder-decoder models
raise until their slices come (ROADMAP, Queue 1).

Decode updates the cache in place instead of returning a copy: the kv
cache (``index_copy_`` at the step's slot; 24 layers at 2,056 positions
are 400 MB) and the SSM state and conv caches (``copy_``; mamba2-370m's
state is 201 MB at a batch of 4). The reference copies them only because
its arrays are immutable.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import ssd
from repro_torch.models.attention import apply_rope, attend, decode_attend
from repro_torch.models.layers import (embed_tokens, lm_logits, mlp,
                                       padded_vocab, rms_norm)
from repro_torch.models.options import RunOptions

PORTED_FAMILIES = ("dense", "vlm", "ssm")


@dataclass(frozen=True)
class ParamMeta:
    """Shape, init kind and dtype of one parameter (the reference's
    ``ParamMeta`` without its sharding axes)."""
    shape: Tuple[int, ...]
    init: str = "normal"             # normal | zeros | ones | ssm_a | dt_bias | embed
    dtype: str = "float32"
    fan_in_dims: Tuple[int, ...] = (0,)   # dims contracted at use (scale)


PM = ParamMeta


def check_family(cfg: ArchConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family} family ({cfg.name}) is not ported yet; the "
            f"port runs {PORTED_FAMILIES} (ROADMAP, Queue 1)")


# ===========================================================================
# Parameter metadata
# ===========================================================================
def attn_meta(cfg: ArchConfig) -> Dict[str, PM]:
    d, H, G, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    m = {
        "ln1": PM((d,), "ones"),
        "wq": PM((d, H * hd)),
        "wk": PM((d, G * hd)),
        "wv": PM((d, G * hd)),
        "wo": PM((H * hd, d)),
    }
    if cfg.qkv_bias:
        m["bq"] = PM((H * hd,), "zeros")
        m["bk"] = PM((G * hd,), "zeros")
        m["bv"] = PM((G * hd,), "zeros")
    return m


def mlp_meta(cfg: ArchConfig) -> Dict[str, PM]:
    d, f = cfg.d_model, cfg.d_ff
    m = {"ln2": PM((d,), "ones")}
    if cfg.mlp == "swiglu":
        m["w_gate"] = PM((d, f))
        m["w_up"] = PM((d, f))
    else:
        m["w_up"] = PM((d, f))
        if cfg.mlp == "gelu":
            m["b_up"] = PM((f,), "zeros")
            m["b_down"] = PM((d,), "zeros")
    m["w_down"] = PM((f, d))
    return m


def ssm_meta(cfg: ArchConfig) -> Dict[str, PM]:
    """The mamba2 block: projections kept unfused (wx, wz, wb, wc
    separate, one causal conv per tensor), as the reference lays them
    out. (The reference's ``di`` and ``own_norm`` serve the hybrid
    family, which is not ported.)"""
    s = cfg.ssm
    d, di, H = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    GN = s.n_groups * s.d_state
    return {
        "ln1": PM((d,), "ones"),
        "wx": PM((d, di)),
        "wz": PM((d, di)),
        "wb": PM((d, GN)),
        "wc": PM((d, GN)),
        "wdt": PM((d, H)),
        "dt_bias": PM((H,), "dt_bias"),
        "A_log": PM((H,), "ssm_a"),
        "Dskip": PM((H,), "ones"),
        "conv_wx": PM((s.conv_width, di)),
        "conv_bx": PM((di,), "zeros"),
        "conv_wb": PM((s.conv_width, GN)),
        "conv_bb": PM((GN,), "zeros"),
        "conv_wc": PM((s.conv_width, GN)),
        "conv_bc": PM((GN,), "zeros"),
        "gln": PM((di,), "ones"),
        "wout": PM((di, d)),
    }


def layer_meta(cfg: ArchConfig) -> Dict[str, PM]:
    check_family(cfg)
    if cfg.family == "ssm":
        return ssm_meta(cfg)
    return {**attn_meta(cfg), **mlp_meta(cfg)}


def _stack(meta: Dict[str, PM], L: int) -> Dict[str, PM]:
    return {k: PM((L,) + m.shape, m.init, m.dtype,
                  tuple(d + 1 for d in m.fan_in_dims))
            for k, m in meta.items()}


def model_meta(cfg: ArchConfig) -> Dict[str, Any]:
    d = cfg.d_model
    meta: Dict[str, Any] = {
        "embed": PM((padded_vocab(cfg.vocab), d), "embed"),
        "final_ln": PM((d,), "ones"),
        "layers": _stack(layer_meta(cfg), cfg.n_layers),
    }
    if not cfg.tie_embeddings:
        meta["head"] = PM((d, padded_vocab(cfg.vocab)))
    return meta


# ===========================================================================
# Blocks: forward (prefill) and decode
# ===========================================================================
def _qkv(p, xn, cfg: ArchConfig):
    B, S, _ = xn.shape
    H, G, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = xn @ p["wq"], xn @ p["wk"], xn @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(B, S, H, hd), k.reshape(B, S, G, hd),
            v.reshape(B, S, G, hd))


def attn_apply(p, x, cfg: ArchConfig, opts: RunOptions, *,
               window: Optional[int], pos_offset: int = 0,
               return_kv: bool = False):
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(p, xn, cfg)
    B, S = x.shape[:2]
    positions = pos_offset + torch.arange(S, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = attend(q, k, v, causal=True, window=window,
               q_chunk=opts.q_chunk, kv_chunk=opts.kv_chunk)
    out = x + o.reshape(B, S, -1) @ p["wo"]
    return (out, (k, v)) if return_kv else out


def attn_decode(p, x, cfg: ArchConfig, *, window, kc, vc, slot_pos, cur_pos):
    """x (B,1,d); kc, vc (B,Sc,G,hd), written in place at slot
    ``cur_pos % Sc``; slot_pos (Sc,); cur_pos () integer tensor."""
    B = x.shape[0]
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(p, xn, cfg)
    pos = cur_pos.reshape(1)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    slot = torch.remainder(pos, kc.shape[1]).long()
    kc.index_copy_(1, slot, k.to(kc.dtype))
    vc.index_copy_(1, slot, v.to(vc.dtype))
    o = decode_attend(q, kc, vc, slot_pos[None, :], cur_pos.expand(B),
                      window=window)
    return x + o.reshape(B, 1, -1) @ p["wo"]


def _ssm_pre(p, xn):
    """Unfused projections. Returns x_in, z (…,di), b, c (…,GN),
    dt_raw (…,H)."""
    return (xn @ p["wx"], xn @ p["wz"], xn @ p["wb"], xn @ p["wc"],
            xn @ p["wdt"])


def ssm_apply(p, x, cfg: ArchConfig, opts: RunOptions, *,
              return_state: bool = False):
    """Mamba2 block over the full sequence. x (B,S,d). Returns (y, the
    decode cache or None): with ``return_state`` the final SSM state and
    the last cw-1 positions of each conv input."""
    s = cfg.ssm
    B, S, _ = x.shape
    di, H, P = cfg.d_inner, cfg.ssm_heads, s.head_dim
    G, N = s.n_groups, s.d_state
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    x_raw, z, b, c, dtr = _ssm_pre(p, xn)
    x_in = F.silu(ssd.causal_conv(x_raw, p["conv_wx"], p["conv_bx"]))
    b_c = F.silu(ssd.causal_conv(b, p["conv_wb"], p["conv_bb"]))
    c_c = F.silu(ssd.causal_conv(c, p["conv_wc"], p["conv_bc"]))
    Bm = b_c.reshape(B, S, G, N)
    Cm = c_c.reshape(B, S, G, N)
    dt = F.softplus(dtr + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    xh = x_in.reshape(B, S, H, P)
    y, state = ssd.ssd_scan(xh, dt, A, Bm, Cm, chunk=opts.ssd_chunk)
    y = y + p["Dskip"][None, None, :, None] * xh
    y = rms_norm(y.reshape(B, S, di) * F.silu(z), p["gln"], cfg.norm_eps)
    cache = None
    if return_state:
        cw = s.conv_width
        cache = {"ssm": state, "conv_x": x_raw[:, -(cw - 1):],
                 "conv_b": b[:, -(cw - 1):], "conv_c": c[:, -(cw - 1):]}
    return x + y @ p["wout"], cache


def ssm_decode(p, x, cfg: ArchConfig, cache_l):
    """One step. x (B,1,d); cache_l holds this layer's ssm (B,H,P,N)
    float32, conv_x (B,cw-1,di), conv_b and conv_c (B,cw-1,GN), all
    updated in place."""
    s = cfg.ssm
    B = x.shape[0]
    di, H, P = cfg.d_inner, cfg.ssm_heads, s.head_dim
    G, N = s.n_groups, s.d_state
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    x_raw, z, b, c, dtr = _ssm_pre(p, xn[:, 0])
    outs = []
    for name, inp, w, bias in (("conv_x", x_raw, "conv_wx", "conv_bx"),
                               ("conv_b", b, "conv_wb", "conv_bb"),
                               ("conv_c", c, "conv_wc", "conv_bc")):
        o, new = ssd.causal_conv_step(cache_l[name], inp, p[w], p[bias])
        cache_l[name].copy_(new)
        outs.append(o)
    x_in = F.silu(outs[0])
    Bm = F.silu(outs[1]).reshape(B, G, N)
    Cm = F.silu(outs[2]).reshape(B, G, N)
    dt = F.softplus(dtr + p["dt_bias"])                  # (B,H)
    A = -torch.exp(p["A_log"].float())
    xh = x_in.reshape(B, H, P)
    y, new_state = ssd.ssd_decode_step(cache_l["ssm"], xh, dt, A, Bm, Cm)
    cache_l["ssm"].copy_(new_state)
    y = y + p["Dskip"][None, :, None] * xh
    y = rms_norm(y.reshape(B, 1, di) * F.silu(z[:, None]), p["gln"],
                 cfg.norm_eps)
    return x + y @ p["wout"]


def _ffn(p, x, cfg: ArchConfig, opts: RunOptions):
    if cfg.moe is not None:
        raise NotImplementedError("MoE layers are not ported yet "
                                  "(ROADMAP, Queue 1)")
    y = mlp(p, rms_norm(x, p["ln2"], cfg.norm_eps), cfg.mlp)
    return x + y, torch.zeros((), dtype=torch.float32, device=x.device)


# ===========================================================================
# Layer-stack runners
# ===========================================================================
def _layer_window(cfg: ArchConfig, li: int) -> Optional[int]:
    if cfg.window is None:
        return None
    if cfg.global_layers and li in cfg.global_layers:
        return None
    return cfg.window


def _layer(params, li: int) -> Dict[str, torch.Tensor]:
    return {k: v[li] for k, v in params["layers"].items()}


def _block_fwd(lp, x, cfg, opts, *, window, return_cache):
    if cfg.family == "ssm":
        y, c = ssm_apply(lp, x, cfg, opts, return_state=return_cache)
        return y, c, torch.zeros((), dtype=torch.float32, device=x.device)
    if return_cache:
        y, (k, v) = attn_apply(lp, x, cfg, opts, window=window,
                               return_kv=True)
        y, aux = _ffn(lp, y, cfg, opts)
        return y, {"k": k, "v": v}, aux
    y = attn_apply(lp, x, cfg, opts, window=window)
    y, aux = _ffn(lp, y, cfg, opts)
    return y, None, aux


def run_stack(params, x, cfg: ArchConfig, opts: RunOptions, *,
              return_cache: bool = False):
    """Forward through all layers; returns (x, cache | None, aux) with
    each cache entry (k and v, or the ssm state and conv caches) stacked
    on L."""
    check_family(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for li in range(cfg.n_layers):
        x, c, a = _block_fwd(_layer(params, li), x, cfg, opts,
                             window=_layer_window(cfg, li),
                             return_cache=return_cache)
        aux = aux + a
        caches.append(c)
    cache = ({k: torch.stack([c[k] for c in caches]) for k in caches[0]}
             if return_cache else None)
    return x, cache, aux


def run_stack_decode(params, cache, x, cfg: ArchConfig, opts: RunOptions, *,
                     slot_pos, cur_pos):
    """One decode step through all layers; ``cache["layers"]`` (stacked
    on L) is updated in place and returned."""
    check_family(cfg)
    layers = cache["layers"]
    for li in range(cfg.n_layers):
        lp = _layer(params, li)
        if cfg.family == "ssm":
            x = ssm_decode(lp, x, cfg, {k: v[li] for k, v in layers.items()})
            continue
        x = attn_decode(lp, x, cfg, window=_layer_window(cfg, li),
                        kc=layers["k"][li], vc=layers["v"][li],
                        slot_pos=slot_pos, cur_pos=cur_pos)
        x, _ = _ffn(lp, x, cfg, opts)
    return x, layers


# ===========================================================================
# Top-level LM functions
# ===========================================================================
def _head(params, cfg: ArchConfig):
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def _compute_params(params, dtype):
    """float32 matrices (every leaf of more than one dimension, stacked
    norms included) in the compute dtype, as the reference casts them."""
    def cast(a):
        return a.to(dtype) if a.dtype == torch.float32 and a.ndim > 1 else a
    out = {k: cast(v) for k, v in params.items() if k != "layers"}
    out["layers"] = {k: cast(v) for k, v in params["layers"].items()}
    return out


def lm_forward(params, cfg: ArchConfig, opts: RunOptions, tokens,
               embeds=None, *, return_cache: bool = False):
    """tokens (B,S) integer; embeds (B,F,d) optional frontend stub output.
    Returns (logits (B,S,Vp), cache | None, aux)."""
    cdt = getattr(torch, opts.compute_dtype)
    params = _compute_params(params, cdt)
    x = embed_tokens(params["embed"], tokens).to(cdt)
    if embeds is not None:
        x = torch.cat([embeds.to(cdt), x], dim=1)
    x, cache, aux = run_stack(params, x, cfg, opts, return_cache=return_cache)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return lm_logits(x, _head(params, cfg), cfg.vocab), cache, aux


def lm_prefill(params, cfg: ArchConfig, opts: RunOptions, tokens,
               embeds=None, cache_len: Optional[int] = None):
    """Returns (last-position argmax token (B,) int32, cache). A
    ``cache_len`` past the prompt reserves decode head-room (empty slots
    at position -1); the SSM family's cache has no positions, so it
    ignores ``cache_len`` and has no ``slot_pos``."""
    logits, layer_cache, _ = lm_forward(params, cfg, opts, tokens, embeds,
                                        return_cache=True)
    S_total = logits.shape[1]
    next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    dev = logits.device
    pos = torch.tensor(S_total, dtype=torch.int32, device=dev)
    if cfg.family == "ssm":
        return next_tok, {"layers": layer_cache, "pos": pos}
    Sc = layer_cache["k"].shape[2]
    slot_pos = torch.arange(Sc, dtype=torch.int32, device=dev)
    if cache_len is not None and cache_len > Sc:
        pad = cache_len - Sc
        layer_cache = {k: F.pad(v, (0, 0, 0, 0, 0, pad))
                       for k, v in layer_cache.items()}
        slot_pos = torch.cat([slot_pos, torch.full((pad,), -1,
                                                   dtype=torch.int32,
                                                   device=dev)])
    return next_tok, {"layers": layer_cache, "pos": pos,
                      "slot_pos": slot_pos}


def lm_decode_step(params, cfg: ArchConfig, opts: RunOptions, cache, token):
    """token (B,) integer -> (next token (B,) int32, cache). The cache's
    layers and slot_pos (absent for the SSM family) are updated in
    place; ``pos`` advances by one."""
    cdt = getattr(torch, opts.compute_dtype)
    params = _compute_params(params, cdt)
    cur = cache["pos"]
    x = embed_tokens(params["embed"], token[:, None]).to(cdt)
    slot_pos = cache.get("slot_pos")
    if slot_pos is not None:
        slot = torch.remainder(cur.reshape(1), slot_pos.shape[0]).long()
        slot_pos.index_copy_(0, slot, cur.reshape(1).to(slot_pos.dtype))
    x, layers = run_stack_decode(params, cache, x, cfg, opts,
                                 slot_pos=slot_pos, cur_pos=cur)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    logits = lm_logits(x[:, 0], _head(params, cfg), cfg.vocab)
    next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    new_cache = {"layers": layers, "pos": cur + 1}
    if slot_pos is not None:
        new_cache["slot_pos"] = slot_pos
    return next_tok, new_cache
