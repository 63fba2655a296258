"""Whisper-style encoder-decoder backbone: the port of
``repro/models/whisper.py`` (the encdec family, whisper-large-v3). The
conv/mel audio frontend is a stub, as in the reference: the caller
passes precomputed frame embeddings (B, S_enc, d_model).

LayerNorm, biased projections (``wk`` has no bias) and GELU MLPs,
sinusoidal positions on both sides. The parameter tree is the
reference's, names and nesting included (``embed``, ``enc_layers``,
``dec_layers``, ``enc_ln``, ``final_ln``, ``head``; in a layer ``ln``,
``wq``, ``bq``, ``wk``, ``wv``, ``bv``, ``wo``, ``bo``, the same with the
``x_`` prefix for cross-attention, ``ln2``, ``w_up``, ``b_up``,
``w_down``, ``b_down``), so ``convert.params_from_arrays`` carries a
reference tree across unchanged.

All attention goes through ``models/attention.py``, so on a CUDA tensor
it is kernel K3: the encoder's self-attention non-causal, the decoder's
causal, cross-attention non-causal over the encoder frames (a prompt's
queries in prefill, one query per step in decode). Decode's
self-attention is the plain ``decode_attend``, as for every family.

The cache is the reference's: top-level ``k``, ``v`` (L,B,Sc,H,hd) of
the decoder's self-attention, written in place at each step's slot,
``xk``, ``xv`` (L,B,S_enc,H,hd) of the cross-attention, read only,
``pos`` and ``slot_pos``.

The reference's ``forward_logits`` leaves float32 weights uncast, and
jnp promotes a bfloat16 activation times a float32 weight to float32;
``_mm`` does the same, where torch would refuse the mix.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import attend, decode_attend, mha
from repro_torch.models.layers import (embed_tokens, layer_norm, lm_logits,
                                       padded_vocab, sinusoid_div,
                                       sinusoidal_positions, softmax_xent)
from repro_torch.models.options import RunOptions
from repro_torch.models.transformer import (ParamMeta, _compute_params,
                                            _stack, remat, unbind_layers,
                                            write_slot)

PM = ParamMeta


# ===========================================================================
# Parameter metadata
# ===========================================================================
def _ln_meta(d):
    return {"w": PM((d,), "ones"), "b": PM((d,), "zeros")}


def _attn_meta(cfg: ArchConfig, prefix: str = "") -> Dict[str, Any]:
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
    return {
        prefix + "ln": _ln_meta(d),
        prefix + "wq": PM((d, H * hd)),
        prefix + "bq": PM((H * hd,), "zeros"),
        prefix + "wk": PM((d, H * hd)),
        prefix + "wv": PM((d, H * hd)),
        prefix + "bv": PM((H * hd,), "zeros"),
        prefix + "wo": PM((H * hd, d)),
        prefix + "bo": PM((d,), "zeros"),
    }


def _mlp_meta(cfg: ArchConfig) -> Dict[str, Any]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "ln2": _ln_meta(d),
        "w_up": PM((d, f)),
        "b_up": PM((f,), "zeros"),
        "w_down": PM((f, d)),
        "b_down": PM((d,), "zeros"),
    }


def model_meta(cfg: ArchConfig) -> Dict[str, Any]:
    d = cfg.d_model
    Vp = padded_vocab(cfg.vocab)
    enc_layer = {**_attn_meta(cfg), **_mlp_meta(cfg)}
    dec_layer = {**_attn_meta(cfg), **_attn_meta(cfg, "x_"),
                 **_mlp_meta(cfg)}
    return {
        "embed": PM((Vp, d), "embed"),
        "enc_layers": _stack(enc_layer, cfg.n_enc_layers),
        "dec_layers": _stack(dec_layer, cfg.n_layers),
        "enc_ln": _ln_meta(d),
        "final_ln": _ln_meta(d),
        "head": PM((d, Vp)),
    }


# ===========================================================================
# Blocks
# ===========================================================================
def _mm(x, w):
    """x @ w in the wider of their dtypes (jnp's promotion)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def _layer(tree, li: int):
    return {k: (_layer(v, li) if isinstance(v, dict) else v[li])
            for k, v in tree.items()}


def _remat(opts: RunOptions) -> str:
    """The reference checkpoints whisper's blocks whole for any remat
    other than none (``jax.checkpoint`` without a policy)."""
    return "full" if opts.remat == "dots" else opts.remat


def _ln(x, p, cfg: ArchConfig):
    return layer_norm(x, p["w"], p["b"], cfg.norm_eps)


def _proj_qkv(p, xq, xkv, cfg: ArchConfig, prefix: str = ""):
    B, Sq, _ = xq.shape
    Skv = xkv.shape[1]
    H, hd = cfg.n_heads, cfg.hd
    q = (_mm(xq, p[prefix + "wq"]) + p[prefix + "bq"]).reshape(B, Sq, H, hd)
    k = _mm(xkv, p[prefix + "wk"]).reshape(B, Skv, H, hd)
    v = (_mm(xkv, p[prefix + "wv"]) + p[prefix + "bv"]).reshape(B, Skv, H, hd)
    return q, k, v


def _out(p, o, prefix: str = ""):
    """The attention output o (B,S,H,hd) through ``wo`` and ``bo``."""
    B, S = o.shape[:2]
    return _mm(o.reshape(B, S, -1), p[prefix + "wo"]) + p[prefix + "bo"]


def _attn(p, xq, xkv, cfg: ArchConfig, opts: RunOptions, *, causal: bool,
          prefix: str = "", return_kv: bool = False):
    q, k, v = _proj_qkv(p, xq, xkv, cfg, prefix)
    o = attend(q, k, v, causal=causal, window=None,
               q_chunk=opts.q_chunk, kv_chunk=opts.kv_chunk)
    return (_out(p, o, prefix), k, v) if return_kv else _out(p, o, prefix)


def _ffn(p, x, cfg: ArchConfig):
    xn = _ln(x, p["ln2"], cfg)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(_mm(xn, p["w_up"]) + p["b_up"], approximate="tanh")
    return x + (_mm(h, p["w_down"]) + p["b_down"])


def encode(params, cfg: ArchConfig, opts: RunOptions, frames):
    """frames (B, S_enc, d) precomputed embeddings (frontend stub) ->
    the encoder's output (B, S_enc, d)."""
    cdt = getattr(torch, opts.compute_dtype)
    x = frames.to(cdt) + sinusoidal_positions(
        frames.shape[1], cfg.d_model, frames.device).to(cdt)

    def block(lp, x):
        xn = _ln(x, lp["ln"], cfg)
        x = x + _attn(lp, xn, xn, cfg, opts, causal=False)
        return _ffn(lp, x, cfg)

    block = remat(block, _remat(opts))
    for lp in unbind_layers(params["enc_layers"], cfg.n_enc_layers):
        x = block(lp, x)
    return _ln(x, params["enc_ln"], cfg)


def _dec_block(lp, x, enc_out, cfg: ArchConfig, opts: RunOptions, *,
               return_kv: bool = False):
    """One decoder layer: causal self-attention, cross-attention over
    ``enc_out``, the FFN. With ``return_kv`` also (k, v, xk, xv)."""
    xn = _ln(x, lp["ln"], cfg)
    o, k, v = _attn(lp, xn, xn, cfg, opts, causal=True, return_kv=True)
    x = x + o
    ox, kx, vx = _attn(lp, _ln(x, lp["x_ln"], cfg), enc_out, cfg, opts,
                       causal=False, prefix="x_", return_kv=True)
    x = _ffn(lp, x + ox, cfg)
    return (x, (k, v, kx, vx)) if return_kv else x


def decode_train(params, cfg: ArchConfig, opts: RunOptions, tokens,
                 enc_out):
    """tokens (B,S) integer, enc_out (B,S_enc,d) -> logits (B,S,Vp)."""
    cdt = getattr(torch, opts.compute_dtype)
    x = embed_tokens(params["embed"], tokens).to(cdt)
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model, x.device).to(cdt)
    block = remat(lambda lp, x, enc: _dec_block(lp, x, enc, cfg, opts),
                  _remat(opts))
    for lp in unbind_layers(params["dec_layers"], cfg.n_layers):
        x = block(lp, x, enc_out)
    x = _ln(x, params["final_ln"], cfg)
    return lm_logits(x, params["head"], cfg.vocab)


def loss_fn(params, cfg: ArchConfig, opts: RunOptions, batch):
    """The reference's ``loss_fn``: the weights cast to the compute
    dtype, the frames encoded, the decoder's logits at position i
    predicting tokens[:, i+1]; the mean cross entropy, float32."""
    params = _compute_params(params, getattr(torch, opts.compute_dtype))
    enc_out = encode(params, cfg, opts, batch["frames"])
    logits = decode_train(params, cfg, opts, batch["tokens"], enc_out)
    return softmax_xent(logits[:, :-1], batch["tokens"][:, 1:], cfg.vocab)


# ===========================================================================
# Serving: prefill and one decode step
# ===========================================================================
def prefill(params, cfg: ArchConfig, opts: RunOptions, batch,
            cache_len: Optional[int] = None):
    """batch {"frames" (B,S_enc,d), "tokens" (B,St)}: encode the frames,
    prefill the decoder prompt. Returns (last-position argmax token (B,)
    int32, cache). A ``cache_len`` past St reserves decode head-room in
    ``k`` and ``v`` (empty slots at position -1). The reference leaves
    ``opts.kv_cache_dtype`` to the decoder families, and so does this."""
    cdt = getattr(torch, opts.compute_dtype)
    params = _compute_params(params, cdt)
    enc_out = encode(params, cfg, opts, batch["frames"])
    tokens = batch["tokens"]
    St = tokens.shape[1]
    dev = enc_out.device
    x = embed_tokens(params["embed"], tokens).to(cdt)
    x = x + sinusoidal_positions(St, cfg.d_model, dev).to(cdt)
    kvs = []
    for li in range(cfg.n_layers):
        x, kv = _dec_block(_layer(params["dec_layers"], li), x, enc_out,
                           cfg, opts, return_kv=True)
        kvs.append(kv)
    x = _ln(x, params["final_ln"], cfg)
    logits = lm_logits(x[:, -1], params["head"], cfg.vocab)
    k, v, xk, xv = (torch.stack(t) for t in zip(*kvs))
    del kvs
    slot_pos = torch.arange(St, dtype=torch.int32, device=dev)
    if cache_len is not None and cache_len > St:
        pad = cache_len - St
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        slot_pos = torch.cat([slot_pos, torch.full(
            (pad,), -1, dtype=torch.int32, device=dev)])
    cache = {"k": k, "v": v, "xk": xk, "xv": xv,
             "pos": torch.tensor(St, dtype=torch.int32, device=dev),
             "slot_pos": slot_pos}
    return torch.argmax(logits, dim=-1).to(torch.int32), cache


def decode_step(params, cfg: ArchConfig, opts: RunOptions, cache, token):
    """token (B,) integer -> (next token (B,) int32, cache). ``k``, ``v``
    and ``slot_pos`` are written in place at slot ``pos % Sc``; ``pos``
    advances by one."""
    cdt = getattr(torch, opts.compute_dtype)
    params = _compute_params(params, cdt)
    cur = cache["pos"]
    B = token.shape[0]
    H, hd = cfg.n_heads, cfg.hd
    x = embed_tokens(params["embed"], token[:, None]).to(cdt)
    # the sinusoid at position ``cur``, in float32
    ang = cur.float() * sinusoid_div(cfg.d_model, x.device)
    pos_vec = torch.stack([torch.sin(ang), torch.cos(ang)], -1).reshape(-1)
    x = x + pos_vec.to(cdt)
    slot_pos = cache["slot_pos"]
    slot = torch.remainder(cur.reshape(1), slot_pos.shape[0]).long()
    slot_pos.index_copy_(0, slot, cur.reshape(1).to(slot_pos.dtype))
    for li in range(cfg.n_layers):
        lp = _layer(params["dec_layers"], li)
        kc, vc = cache["k"][li], cache["v"][li]
        xn = _ln(x, lp["ln"], cfg)
        q, k, v = _proj_qkv(lp, xn, xn, cfg)
        write_slot(kc, slot, k)
        write_slot(vc, slot, v)
        o = decode_attend(q, kc, vc, slot_pos[None, :], cur.expand(B))
        x = x + _out(lp, o)
        xn = _ln(x, lp["x_ln"], cfg)
        qx = (_mm(xn, lp["x_wq"]) + lp["x_bq"]).reshape(B, 1, H, hd)
        ox = mha(qx, cache["xk"][li], cache["xv"][li], causal=False,
                 q_chunk=1, kv_chunk=opts.kv_chunk)
        x = _ffn(lp, x + _out(lp, ox, "x_"), cfg)
    x = _ln(x, params["final_ln"], cfg)
    logits = lm_logits(x[:, 0], params["head"], cfg.vocab)
    new_cache = {**cache, "pos": cur + 1}
    return torch.argmax(logits, dim=-1).to(torch.int32), new_cache
