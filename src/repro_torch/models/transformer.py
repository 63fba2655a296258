"""Decoder stack: the port of ``repro/models/transformer.py`` for the
dense (and vlm) family, the MoE family (mixtral: GQA attention with a
sliding window and a top-k expert FFN, ``models/moe.py``), the SSM
family (mamba2) and the hybrid family (hymba: attention and mamba heads
in parallel in every layer) — prefill / forward and decode.

Parameters are a plain dict with the reference's layout: ``embed`` (Vp,
d), ``final_ln``, optional ``head``, and ``layers`` whose leaves are
stacked on a leading L axis. The reference's ``lax.scan`` over layers is
a Python loop over that axis, which gives each layer its own window, so
the reference's grouped scan of same-window layers (``_layer_groups``)
has no counterpart here. The encoder-decoder family (whisper) is
``models/whisper.py``.

Decode updates the cache in place instead of returning a copy: the kv
cache (``write_slot`` at the step's slot; 24 layers at 2,056 positions
are 400 MB) and the SSM state and conv caches (``copy_``; mamba2-370m's
state is 201 MB at a batch of 4). The reference copies them only because
its arrays are immutable. ``RunOptions.kv_cache_dtype`` (float8_e4m3fn,
say) stores k and v in that dtype from the prefill on; decode widens
them at the product.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ArchConfig
from repro_torch.models import ssd
from repro_torch.models.attention import apply_rope, attend, decode_attend
from repro_torch.models.layers import (embed_tokens, lm_logits, mlp,
                                       padded_vocab, rms_norm, softmax_xent)
from repro_torch.models.moe import moe_ffn
from repro_torch.models.options import RunOptions

PORTED_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")


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


def moe_meta(cfg: ArchConfig) -> Dict[str, PM]:
    """The expert FFN: a router and E experts' SwiGLU matrices, each
    expert's scaled by its own fan-in (dim 1: d, or f for ``w_down``)."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    return {
        "ln2": PM((d,), "ones"),
        "router": PM((d, E)),
        "w_gate": PM((E, d, f), fan_in_dims=(1,)),
        "w_up": PM((E, d, f), fan_in_dims=(1,)),
        "w_down": PM((E, f, d), fan_in_dims=(1,)),
    }


def ssm_meta(cfg: ArchConfig, di: Optional[int] = None,
             own_norm: bool = True) -> Dict[str, PM]:
    """The mamba2 block: projections kept unfused (wx, wz, wb, wc
    separate, one causal conv per tensor), as the reference lays them
    out. ``di`` is the inner width (``cfg.d_inner`` by default; the
    hybrid's SSM branch takes n_heads * hd), with di / head_dim SSM heads.
    ``own_norm=False`` (the hybrid) drops the block's ``ln1`` and
    ``wout``: the layer around it norms the input and projects the
    output."""
    s = cfg.ssm
    d = cfg.d_model
    di = di or cfg.d_inner
    H = di // s.head_dim
    GN = s.n_groups * s.d_state
    m = {
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
    }
    if own_norm:
        m["ln1"] = PM((d,), "ones")
        m["wout"] = PM((di, d))
    return m


def layer_meta(cfg: ArchConfig) -> Dict[str, PM]:
    check_family(cfg)
    if cfg.family == "ssm":
        return ssm_meta(cfg)
    if cfg.family == "moe":
        return {**attn_meta(cfg), **moe_meta(cfg)}
    if cfg.family == "hybrid":
        di = cfg.n_heads * cfg.hd
        m = {**attn_meta(cfg), **mlp_meta(cfg),
             **ssm_meta(cfg, di=di, own_norm=False)}
        m["norm_attn"] = PM((di,), "ones")
        m["norm_ssm"] = PM((di,), "ones")
        return m
    return {**attn_meta(cfg), **mlp_meta(cfg)}


def _stack(meta, L: int):
    """Every leaf of the (nested) ``meta`` stacked on a leading L axis."""
    if isinstance(meta, dict):
        return {k: _stack(m, L) for k, m in meta.items()}
    return PM((L,) + meta.shape, meta.init, meta.dtype,
              tuple(d + 1 for d in meta.fan_in_dims))


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


def _attention(p, xn, cfg: ArchConfig, opts: RunOptions, *,
               window: Optional[int], pos_offset: int = 0):
    """The attention of the normed input xn (B,S,d), before ``wo``:
    (o (B,S,H*hd), k, v) with RoPE applied to q and k."""
    q, k, v = _qkv(p, xn, cfg)
    B, S = xn.shape[:2]
    positions = pos_offset + torch.arange(S, device=xn.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = attend(q, k, v, causal=True, window=window,
               q_chunk=opts.q_chunk, kv_chunk=opts.kv_chunk)
    return o.reshape(B, S, -1), k, v


def attn_apply(p, x, cfg: ArchConfig, opts: RunOptions, *,
               window: Optional[int], pos_offset: int = 0,
               return_kv: bool = False):
    o, k, v = _attention(p, rms_norm(x, p["ln1"], cfg.norm_eps), cfg, opts,
                         window=window, pos_offset=pos_offset)
    out = x + o @ p["wo"]
    return (out, (k, v)) if return_kv else out


def write_slot(cache, slot, x) -> None:
    """cache[:, slot] = x in cache's dtype, in place; cache (B,Sc,G,hd),
    x (B,1,G,hd), slot (1,) integer tensor. ``index_copy_`` has no
    float8 kernel, so a float8 cache takes the codes of x's cast through
    uint8 views of both: the same bytes, and no wider copy."""
    x = x.to(cache.dtype)
    if cache.is_floating_point() and cache.element_size() == 1:
        cache, x = cache.view(torch.uint8), x.view(torch.uint8)
    cache.index_copy_(1, slot, x)


def _attention_step(p, xn, cfg: ArchConfig, *, window, kc, vc, slot_pos,
                    cur_pos):
    """One decode step's attention of the normed input xn (B,1,d), before
    ``wo``: (B,1,H*hd). kc, vc (B,Sc,G,hd) are written in place at slot
    ``cur_pos % Sc``; slot_pos (Sc,); cur_pos () integer tensor."""
    B = xn.shape[0]
    q, k, v = _qkv(p, xn, cfg)
    pos = cur_pos.reshape(1)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    slot = torch.remainder(pos, kc.shape[1]).long()
    write_slot(kc, slot, k)
    write_slot(vc, slot, v)
    o = decode_attend(q, kc, vc, slot_pos[None, :], cur_pos.expand(B),
                      window=window)
    return o.reshape(B, 1, -1)


def attn_decode(p, x, cfg: ArchConfig, *, window, kc, vc, slot_pos, cur_pos):
    """x (B,1,d); the caches as in ``_attention_step``."""
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    return x + _attention_step(p, xn, cfg, window=window, kc=kc, vc=vc,
                               slot_pos=slot_pos, cur_pos=cur_pos) @ p["wo"]


def _ssm_pre(p, xn):
    """Unfused projections. Returns x_in, z (…,di), b, c (…,GN),
    dt_raw (…,H)."""
    return (xn @ p["wx"], xn @ p["wz"], xn @ p["wb"], xn @ p["wc"],
            xn @ p["wdt"])


def ssm_apply(p, x, cfg: ArchConfig, opts: RunOptions, *, di: int,
              own_norm: bool = True, return_state: bool = False):
    """Mamba2 block over the full sequence. x (B,S,d); ``di`` the inner
    width, with di / head_dim heads. Returns (y, the decode cache or
    None): with ``return_state`` the final SSM state and the last cw-1
    positions of each conv input. ``own_norm=False`` (the hybrid's SSM
    branch): x is already normed, and y is the gated, normed (B,S,di)
    branch output, without ``wout`` or the residual."""
    s = cfg.ssm
    B, S, _ = x.shape
    H, P = di // s.head_dim, s.head_dim
    G, N = s.n_groups, s.d_state
    xn = rms_norm(x, p["ln1"], cfg.norm_eps) if own_norm else x
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
    if own_norm:
        y = x + y @ p["wout"]
    return y, cache


def ssm_decode(p, x, cfg: ArchConfig, cache_l, *, di: int,
               own_norm: bool = True):
    """One step. x (B,1,d); cache_l holds this layer's ssm (B,H,P,N)
    float32, conv_x (B,cw-1,di), conv_b and conv_c (B,cw-1,GN), all
    updated in place. ``di`` and ``own_norm`` as in ``ssm_apply``."""
    s = cfg.ssm
    B = x.shape[0]
    H, P = di // s.head_dim, s.head_dim
    G, N = s.n_groups, s.d_state
    xn = rms_norm(x, p["ln1"], cfg.norm_eps) if own_norm else x
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
    return x + y @ p["wout"] if own_norm else y


def _combine(p, o_attn, y_ssm, cfg: ArchConfig):
    """The hybrid's mix: each branch through its own RMSNorm, averaged,
    then the output projection."""
    comb = 0.5 * (rms_norm(o_attn, p["norm_attn"], cfg.norm_eps)
                  + rms_norm(y_ssm, p["norm_ssm"], cfg.norm_eps))
    return comb @ p["wo"]


def hybrid_parallel(p, x, cfg: ArchConfig, opts: RunOptions, *,
                    window: Optional[int], pos_offset: int = 0,
                    return_cache: bool = False):
    """Hymba: attention and mamba heads in parallel on the same normed
    input, their outputs normed and averaged, then the FFN. Returns (x,
    the layer's cache {k, v, ssm, conv_x, conv_b, conv_c} or None, aux)."""
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    o_attn, k, v = _attention(p, xn, cfg, opts, window=window,
                              pos_offset=pos_offset)
    y_ssm, ssm_cache = ssm_apply(p, xn, cfg, opts, di=cfg.n_heads * cfg.hd,
                                 own_norm=False, return_state=return_cache)
    x = x + _combine(p, o_attn, y_ssm, cfg)
    x, aux = _ffn(p, x, cfg, opts)
    cache = {"k": k, "v": v, **ssm_cache} if return_cache else None
    return x, cache, aux


def hybrid_decode(p, x, cfg: ArchConfig, opts: RunOptions, *, window,
                  cache_l, slot_pos, cur_pos):
    """One hybrid step. x (B,1,d); cache_l holds this layer's k, v (written
    at slot ``cur_pos % Sc``), ssm and conv caches, all updated in place."""
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    o_attn = _attention_step(p, xn, cfg, window=window, kc=cache_l["k"],
                             vc=cache_l["v"], slot_pos=slot_pos,
                             cur_pos=cur_pos)
    y_ssm = ssm_decode(p, xn, cfg, cache_l, di=cfg.n_heads * cfg.hd,
                       own_norm=False)
    x = x + _combine(p, o_attn, y_ssm, cfg)
    x, _ = _ffn(p, x, cfg, opts)
    return x


def _ffn(p, x, cfg: ArchConfig, opts: RunOptions):
    """The FFN block with its residual: (x + FFN(norm(x)), the float32 aux
    loss, 0 without experts)."""
    xn = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.moe is not None:
        y, aux = moe_ffn(p, xn, n_experts=cfg.moe.n_experts,
                         top_k=cfg.moe.top_k,
                         capacity_factor=opts.capacity_factor,
                         group_size=opts.moe_group)
        return x + y, aux
    return x + mlp(p, xn, cfg.mlp), torch.zeros((), dtype=torch.float32,
                                                 device=x.device)


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
        y, c = ssm_apply(lp, x, cfg, opts, di=cfg.d_inner,
                         return_state=return_cache)
        return y, c, torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "hybrid":
        return hybrid_parallel(lp, x, cfg, opts, window=window,
                               return_cache=return_cache)
    if return_cache:
        y, (k, v) = attn_apply(lp, x, cfg, opts, window=window,
                               return_kv=True)
        y, aux = _ffn(lp, y, cfg, opts)
        return y, {"k": k, "v": v}, aux
    y = attn_apply(lp, x, cfg, opts, window=window)
    y, aux = _ffn(lp, y, cfg, opts)
    return y, None, aux


# the products whose outputs ``remat="dots"`` keeps (the reference's
# ``checkpoint_dots`` policy): every matmul, einsum and linear lowers to one
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn, mode: str):
    """``fn`` under the reference's ``_wrap_remat``: ``none`` as it is,
    ``full`` recomputed in the backward from its inputs
    (``torch.utils.checkpoint``, non-reentrant), ``dots`` recomputed but
    for the products' outputs, which are kept (selective checkpointing).
    Only where autograd records: when no argument needs a gradient (a
    prefill, a forward under ``torch.no_grad``) ``fn`` runs as it is."""
    if mode not in ("none", "full", "dots"):
        raise ValueError(f"remat must be none, full or dots, not {mode!r}")
    if mode == "none":
        return fn
    kw = {} if mode == "full" else {"context_fn": functools.partial(
        ckpt.create_selective_checkpoint_contexts, _dots_policy)}

    def wrapped(*args, **kwargs):
        if not (torch.is_grad_enabled() and _needs_grad(args)):
            return fn(*args, **kwargs)
        return ckpt.checkpoint(fn, *args, use_reentrant=False, **kwargs,
                               **kw)
    return wrapped


def _needs_grad(args) -> bool:
    """A tensor among ``args`` (dicts searched) requires a gradient."""
    return any(_needs_grad(a.values()) if isinstance(a, dict) else
               isinstance(a, torch.Tensor) and a.requires_grad
               for a in args)


def unbind_layers(tree, L: int) -> list:
    """The L per-layer dicts of a (nested) dict of leaves stacked on a
    leading L axis, each leaf unbound once: autograd then stacks the
    layers' gradients in one step instead of adding one full-size stack
    per layer, as indexing each layer would."""
    cols = {k: (unbind_layers(v, L) if isinstance(v, dict)
                else torch.unbind(v)) for k, v in tree.items()}
    return [{k: c[li] for k, c in cols.items()} for li in range(L)]


def run_stack(params, x, cfg: ArchConfig, opts: RunOptions, *,
              return_cache: bool = False):
    """Forward through all layers; returns (x, cache | None, aux) with
    each cache entry (k and v, or the ssm state and conv caches) stacked
    on L. Each layer runs under ``remat(opts.remat)`` when there is no
    cache to return (training)."""
    check_family(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for li, lp in enumerate(unbind_layers(params["layers"], cfg.n_layers)):
        block = functools.partial(_block_fwd, cfg=cfg, opts=opts,
                                  window=_layer_window(cfg, li),
                                  return_cache=return_cache)
        if not return_cache:
            block = remat(block, opts.remat)
        x, c, a = block(lp, x)
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
        cache_l = {k: v[li] for k, v in layers.items()}
        if cfg.family == "ssm":
            x = ssm_decode(lp, x, cfg, cache_l, di=cfg.d_inner)
            continue
        if cfg.family == "hybrid":
            x = hybrid_decode(lp, x, cfg, opts, window=_layer_window(cfg, li),
                              cache_l=cache_l, slot_pos=slot_pos,
                              cur_pos=cur_pos)
            continue
        x = attn_decode(lp, x, cfg, window=_layer_window(cfg, li),
                        kc=cache_l["k"], vc=cache_l["v"],
                        slot_pos=slot_pos, cur_pos=cur_pos)
        x, _ = _ffn(lp, x, cfg, opts)
    return x, layers


# ===========================================================================
# Top-level LM functions
# ===========================================================================
def _head(params, cfg: ArchConfig):
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def _compute_params(params, dtype):
    """float32 matrices (every leaf of more than one dimension of the
    nested ``params``, stacked norms and biases included) in the compute
    dtype, as the reference casts them."""
    return {k: (_compute_params(v, dtype) if isinstance(v, dict) else
                v.to(dtype) if v.dtype == torch.float32 and v.ndim > 1
                else v)
            for k, v in params.items()}


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


def lm_loss(params, cfg: ArchConfig, opts: RunOptions, batch):
    """The reference's ``lm_loss``: batch {"tokens" (B,S), optional
    "embeds" (B,F,d)}; logit position F+i predicts tokens[:, i+1]; the
    mean cross entropy plus ``opts.aux_loss_weight`` times the MoE aux
    loss. A float32 scalar."""
    tokens = batch["tokens"]
    embeds = batch.get("embeds")
    logits, _, aux = lm_forward(params, cfg, opts, tokens, embeds)
    F_ = 0 if embeds is None else embeds.shape[1]
    S = tokens.shape[1]
    loss = softmax_xent(logits[:, F_:F_ + S - 1], tokens[:, 1:], cfg.vocab)
    return loss + opts.aux_loss_weight * aux


def lm_prefill(params, cfg: ArchConfig, opts: RunOptions, tokens,
               embeds=None, cache_len: Optional[int] = None):
    """Returns (last-position argmax token (B,) int32, cache), k and v
    in ``opts.kv_cache_dtype`` when it is set. A
    ``cache_len`` past the prompt reserves decode head-room in ``k`` and
    ``v`` (empty slots at position -1), as the reference's ``pad_kv``:
    the hybrid's SSM state and conv caches keep their shapes. The SSM
    family's cache has no positions, so it ignores ``cache_len`` and has
    no ``slot_pos``."""
    logits, layer_cache, _ = lm_forward(params, cfg, opts, tokens, embeds,
                                        return_cache=True)
    S_total = logits.shape[1]
    next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    dev = logits.device
    pos = torch.tensor(S_total, dtype=torch.int32, device=dev)
    if opts.kv_cache_dtype:
        kvdt = getattr(torch, opts.kv_cache_dtype)
        layer_cache = {k: (v.to(kvdt) if k in ("k", "v") else v)
                       for k, v in layer_cache.items()}
    if cfg.family == "ssm":
        return next_tok, {"layers": layer_cache, "pos": pos}
    Sc = layer_cache["k"].shape[2]
    slot_pos = torch.arange(Sc, dtype=torch.int32, device=dev)
    if cache_len is not None and cache_len > Sc:
        pad = cache_len - Sc
        layer_cache = {k: (F.pad(v, (0, 0, 0, 0, 0, pad))
                           if k in ("k", "v") else v)
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
