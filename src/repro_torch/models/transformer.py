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

A train step across ranks (a ``layout``, ``distribution/sharding``)
computes the ``"model"`` axis where the reference's ``shard()``
constraints split it (``split_plan``): each rank of a model group runs
its own H/m query heads (``_maybe_head_shard``'s rule, H % m == 0; the
kv heads G/m where G % m == 0, else the kv heads its query heads read),
its SSM heads, hidden columns, experts or capacity slots and vocab rows,
and joins them with ``f`` and ``g``. A block whose counts do not divide
keeps the gather at use (every rank computes it whole, as without the
split): a layout, not a fallback, and ``split_plan`` names it; hymba-1.5b
at its published width (25 heads, 25 SSM heads) keeps its mixer so at
any model axis of 2 or 4, and splits its FFN.

With ``RunOptions.seq_shard_activations`` a train step or a prefill is
sequence-split (``splits``' ``rows``): between the blocks each rank holds
its S/m rows of the residual stream and runs the norms on them, ``f``
gathers every row before the split products and ``g`` scatters the sums
back to rows, so K3 and K4 see the whole sequence at the same local
head counts; a block that does not split runs on every row
(``_rows_whole``). The reference names this layout but lowers it only
where no head split is asked for (its q, k and v would put ``"seq"``
and ``"tensor"`` on one mesh axis: ``DuplicateSpecError``); the port
computes both.

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
from repro_torch.models.attention import (apply_rope, attend, decode_attend,
                                          decode_attend_parts)
from repro_torch.models.layers import (embed_tokens, lm_logits, mlp,
                                       padded_vocab, rms_norm,
                                       rms_norm_split, softmax_xent)
from repro_torch.models.moe import moe_ffn
from repro_torch.models.options import RunOptions

PORTED_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")


@dataclass(frozen=True)
class ParamMeta:
    """Shape, init kind, dtype and logical axes of one parameter: the
    reference's ``ParamMeta`` with ``axes`` (a logical axis or None per
    dim, resolved onto a mesh by ``distribution/sharding.py``) moved to
    the last field, so positional calls keep their meaning."""
    shape: Tuple[int, ...]
    init: str = "normal"             # normal | zeros | ones | ssm_a | dt_bias | embed
    dtype: str = "float32"
    fan_in_dims: Tuple[int, ...] = (0,)   # dims contracted at use (scale)
    axes: Tuple = ()                 # logical axis (or None) per dim


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
        "ln1": PM((d,), "ones", axes=(None,)),
        "wq": PM((d, H * hd), axes=("fsdp", "tensor")),
        "wk": PM((d, G * hd), axes=("fsdp", "tensor")),
        "wv": PM((d, G * hd), axes=("fsdp", "tensor")),
        "wo": PM((H * hd, d), axes=("tensor", "fsdp")),
    }
    if cfg.qkv_bias:
        m["bq"] = PM((H * hd,), "zeros", axes=("tensor",))
        m["bk"] = PM((G * hd,), "zeros", axes=("tensor",))
        m["bv"] = PM((G * hd,), "zeros", axes=("tensor",))
    return m


def mlp_meta(cfg: ArchConfig) -> Dict[str, PM]:
    d, f = cfg.d_model, cfg.d_ff
    m = {"ln2": PM((d,), "ones", axes=(None,))}
    if cfg.mlp == "swiglu":
        m["w_gate"] = PM((d, f), axes=("fsdp", "tensor"))
        m["w_up"] = PM((d, f), axes=("fsdp", "tensor"))
    else:
        m["w_up"] = PM((d, f), axes=("fsdp", "tensor"))
        if cfg.mlp == "gelu":
            m["b_up"] = PM((f,), "zeros", axes=("tensor",))
            m["b_down"] = PM((d,), "zeros", axes=(None,))
    m["w_down"] = PM((f, d), axes=("tensor", "fsdp"))
    return m


def moe_meta(cfg: ArchConfig) -> Dict[str, PM]:
    """The expert FFN: a router and E experts' SwiGLU matrices, each
    expert's scaled by its own fan-in (dim 1: d, or f for ``w_down``)."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    return {
        "ln2": PM((d,), "ones", axes=(None,)),
        "router": PM((d, E), axes=("fsdp", None)),
        "w_gate": PM((E, d, f), fan_in_dims=(1,),
                     axes=("expert", "fsdp", "expert_ff")),
        "w_up": PM((E, d, f), fan_in_dims=(1,),
                   axes=("expert", "fsdp", "expert_ff")),
        "w_down": PM((E, f, d), fan_in_dims=(1,),
                     axes=("expert", "expert_ff", "fsdp")),
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
        "wx": PM((d, di), axes=("fsdp", "tensor")),
        "wz": PM((d, di), axes=("fsdp", "tensor")),
        "wb": PM((d, GN), axes=("fsdp", "tensor")),
        "wc": PM((d, GN), axes=("fsdp", "tensor")),
        "wdt": PM((d, H), axes=("fsdp", "tensor")),
        "dt_bias": PM((H,), "dt_bias", axes=(None,)),
        "A_log": PM((H,), "ssm_a", axes=(None,)),
        "Dskip": PM((H,), "ones", axes=(None,)),
        "conv_wx": PM((s.conv_width, di), axes=(None, "tensor")),
        "conv_bx": PM((di,), "zeros", axes=("tensor",)),
        "conv_wb": PM((s.conv_width, GN), axes=(None, "tensor")),
        "conv_bb": PM((GN,), "zeros", axes=("tensor",)),
        "conv_wc": PM((s.conv_width, GN), axes=(None, "tensor")),
        "conv_bc": PM((GN,), "zeros", axes=("tensor",)),
        "gln": PM((di,), "ones", axes=("tensor",)),
    }
    if own_norm:
        m["ln1"] = PM((d,), "ones", axes=(None,))
        m["wout"] = PM((di, d), axes=("tensor", "fsdp"))
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
        m["norm_attn"] = PM((di,), "ones", axes=("tensor",))
        m["norm_ssm"] = PM((di,), "ones", axes=("tensor",))
        return m
    return {**attn_meta(cfg), **mlp_meta(cfg)}


def _stack(meta, L: int):
    """Every leaf of the (nested) ``meta`` stacked on a leading L axis,
    whose logical axis is None."""
    if isinstance(meta, dict):
        return {k: _stack(m, L) for k, m in meta.items()}
    return PM((L,) + meta.shape, meta.init, meta.dtype,
              tuple(d + 1 for d in meta.fan_in_dims),
              (None,) + tuple(meta.axes))


def model_meta(cfg: ArchConfig) -> Dict[str, Any]:
    d = cfg.d_model
    meta: Dict[str, Any] = {
        "embed": PM((padded_vocab(cfg.vocab), d), "embed",
                    axes=("vocab", "fsdp")),
        "final_ln": PM((d,), "ones", axes=(None,)),
        "layers": _stack(layer_meta(cfg), cfg.n_layers),
    }
    if not cfg.tie_embeddings:
        meta["head"] = PM((d, padded_vocab(cfg.vocab)),
                          axes=("fsdp", "vocab"))
    return meta


# ===========================================================================
# The model axis's split
# ===========================================================================
@dataclass(frozen=True)
class SplitPlan:
    """Which blocks a model group of ``m`` ranks splits (each True where
    its counts divide by m): ``attn`` the query heads (and ``kv`` the kv
    heads too), ``ssm`` the SSM heads and the G N columns of B and C
    (the hybrid's mixer needs both ``attn`` and ``ssm``), ``mlp`` the
    hidden columns, ``moe`` the experts' part under
    ``RunOptions.moe_sharding``, ``vocab`` the vocab rows."""
    attn: bool = False
    kv: bool = False
    ssm: bool = False
    mlp: bool = False
    moe: bool = False
    vocab: bool = False


@functools.lru_cache(maxsize=None)
def split_plan(cfg: ArchConfig, opts: RunOptions, m: int) -> SplitPlan:
    """The blocks of ``cfg`` a model axis of ``m`` splits. The rule is
    the reference's: a dim splits where the mesh's ``"model"`` size
    divides it (the query heads as ``_maybe_head_shard`` asks); the SSM
    also needs its B and C groups to line up with its heads (G % m == 0
    or m % G == 0). Whatever does not split is gathered at use."""
    H, G = cfg.n_heads, cfg.n_kv_heads
    attn = bool(H) and H % m == 0
    ssm = False
    if cfg.ssm is not None:
        s = cfg.ssm
        di = cfg.d_inner if cfg.family == "ssm" else H * cfg.hd
        groups = s.n_groups
        ssm = ((di // s.head_dim) % m == 0 and (groups * s.d_state) % m == 0
               and (groups % m == 0 or m % groups == 0))
    if cfg.family == "ssm":
        attn = False
    if cfg.family == "hybrid":          # the mixer splits both or neither
        attn = ssm = attn and ssm
    moe = False
    if cfg.moe is not None:
        moe = {"tp": cfg.d_ff % m == 0, "ep": cfg.moe.n_experts % m == 0,
               "cap": True}[opts.moe_sharding]
    return SplitPlan(
        attn=attn, kv=attn and G % m == 0, ssm=ssm,
        mlp=cfg.family not in ("ssm", "moe") and cfg.d_ff % m == 0,
        moe=moe, vocab=padded_vocab(cfg.vocab) % m == 0)


_ATTN_LOCAL = ("wq", "bq", "wo", "x_wq", "x_bq", "x_wo")
_KV = ("wk", "wv", "bk", "bv", "x_wk", "x_wv", "x_bv")
_SSM_LOCAL = ("wx", "wz", "wb", "wc", "wdt", "conv_wx", "conv_bx",
              "conv_wb", "conv_bb", "conv_wc", "conv_bc", "gln", "wout",
              "norm_attn", "norm_ssm")
_SSM_PER_HEAD = ("dt_bias", "A_log", "Dskip")
_FFN = ("w_gate", "w_up", "w_down", "b_up")


def layer_modes(plan: Optional[SplitPlan], opts: RunOptions,
                seq: bool = False) -> Optional[Dict[str, str]]:
    """Each layer leaf's mode at its use (``sharding.MODES``) under
    ``plan``: its ``"model"`` dim kept local where a split block
    consumes its block; its gradient summed over the group where a split
    block reads a replicated leaf (or a gathered one) in part; else
    gathered whole. A sequence-split step (``seq``) reads a split
    block's norm (and the gelu MLP's ``b_down``, the MoE's router) on
    this rank's rows only: those gradients are summed over the group
    too. A block that does not split runs on every row alike
    (``_rows_whole``), so its leaves keep their mode."""
    if plan is None:
        return None
    modes: Dict[str, str] = {}
    if plan.attn:
        modes.update(dict.fromkeys(_ATTN_LOCAL, "local"))
        modes.update(dict.fromkeys(_KV, "local" if plan.kv else "shared"))
    if plan.ssm:
        modes.update(dict.fromkeys(_SSM_LOCAL, "local"))
        modes.update(dict.fromkeys(_SSM_PER_HEAD, "shared"))
    if plan.mlp:
        modes.update(dict.fromkeys(_FFN, "local"))
    if plan.moe:
        modes.update(dict.fromkeys(
            _FFN, "shared" if opts.moe_sharding == "cap" else "local"))
    if seq:
        rows = (("ln1",) if plan.attn or plan.ssm else ()) + (
            ("ln2", "b_down") if plan.mlp else ()) + (
            ("ln2", "router") if plan.moe else ())
        modes.update(dict.fromkeys(rows, "shared"))
    return modes


def top_modes(plan: Optional[SplitPlan], seq: bool = False
              ) -> Optional[Dict[str, str]]:
    """The embedding's and the head's modes: local where the vocab
    splits; a sequence-split step's final norm, on this rank's rows,
    shared."""
    if plan is None or not plan.vocab:
        return None
    return {"embed": "local", "head": "local",
            **({"final_ln": "shared"} if seq else {})}


@dataclass(frozen=True)
class Splits:
    """The ``sharding.ModelSplit`` each block runs under (None: whole),
    and ``rows``, the split of a sequence-split step's residual stream
    (None: every rank holds every row)."""
    plan: Optional[SplitPlan] = None
    attn: Any = None
    ssm: Any = None
    mlp: Any = None
    moe: Any = None
    vocab: Any = None
    rows: Any = None


def splits(layout, cfg: ArchConfig, opts: RunOptions,
           rows: Optional[int] = None) -> Splits:
    """The blocks' splits of a train step's ``layout`` (none without a
    layout or where ``"model"`` holds one rank). ``rows``: the step's
    sequence length, where it may be sequence-split (a train step or a
    prefill, not a decode step).

    The step is sequence-split (Megatron's sequence parallelism over
    ``"model"``) where ``opts.seq_shard_activations`` asks for it, the
    model axis divides ``rows`` and the vocab splits (the embedding's
    ``g`` is then a reduce-scatter of rows, the head's ``f`` their
    gather; a vocab padded to 256 splits over every power of two up to
    256). Else every rank keeps whole rows, as ``spec_for`` drops an
    axis that does not divide."""
    sp = None if layout is None else layout.split
    if sp is None:
        return Splits()
    plan = split_plan(cfg, opts, sp.m)
    seq = (rows is not None and opts.seq_shard_activations and plan.vocab
           and rows % sp.m == 0)
    if seq:
        sp = layout.seq_split
    return Splits(plan, rows=sp if seq else None,
                  **{k: sp if getattr(plan, k) else None
                     for k in ("attn", "ssm", "mlp", "moe", "vocab")})


def _rows_whole(sps: Splits, sp, fn, x):
    """``fn(x)``, a block whose first result is its output, or where the
    step is sequence-split (``sps.rows``) and the block does not split
    (``sp`` None) ``fn`` on every row: the rows gathered at entry, the
    block computed whole and alike on every rank of the group, and this
    rank's rows of its output kept. The backward gathers the output's
    row gradients, so every rank runs the block's backward on them all:
    the block's leaves get their whole gradient, no sum over the group
    (``layer_modes``), and its input's gradient, the same on every
    rank, is cut to this rank's rows."""
    sq = sps.rows
    if sq is None or sp is not None:
        return fn(x)
    out = fn(sq.gather_alike(x))
    if isinstance(out, tuple):
        return (sq.split_alike(out[0]),) + tuple(out[1:])
    return sq.split_alike(out)


def kv_heads(H: int, G: int, sp) -> list:
    """The kv heads this rank's H/m query heads read, in order, where the
    kv heads do not split over the group: each once where every one is
    read by a run of the same number of consecutive query heads (GQA
    over the local heads), else one per query head."""
    return _kv_heads_at(H, G, sp.m, sp.index)


def _kv_heads_at(H: int, G: int, m: int, i: int) -> list:
    R, n = H // G, H // m
    need = [h // R for h in range(i * n, (i + 1) * n)]
    uniq = sorted(set(need))
    run = len(need) // len(uniq)
    return uniq if need == [u for u in uniq for _ in range(run)] else need


def head_lists(H: int, G: int, m: int):
    """Every rank's query heads and kv heads under a split of the H
    heads over m ranks (``ModelSplit.heads_to``'s ``lists``): the query
    heads in m blocks, the kv heads in m blocks where G divides by m
    (``split_plan``'s ``kv``) and else the ones each rank's query heads
    read (``kv_heads``)."""
    q = [list(range(i * H // m, (i + 1) * H // m)) for i in range(m)]
    kv = ([list(range(i * G // m, (i + 1) * G // m)) for i in range(m)]
          if G % m == 0 else [_kv_heads_at(H, G, m, i) for i in range(m)])
    return q, kv


def slot_split(layout, Sc: int):
    """The ``ModelSplit`` whose ranks each hold a block of a serving
    cache's ``Sc`` slots (the reference's ``"cache_seq"`` on
    ``"model"``), or None where the cache is whole on every rank: no
    model axis, or ``Sc`` not a multiple of it (``spec_for`` drops the
    axis)."""
    sp = None if layout is None else layout.split
    return sp if sp is not None and Sc % sp.m == 0 else None


def _kv_cols(w, idx, hd: int):
    """The columns of the kv heads ``idx`` of a (..., G*hd) leaf."""
    return w.reshape(w.shape[:-1] + (-1, hd))[..., idx, :].reshape(
        w.shape[:-1] + (len(idx) * hd,))


# ===========================================================================
# Blocks: forward (prefill) and decode
# ===========================================================================
def _qkv(p, xn, cfg: ArchConfig, sp=None):
    """q, k, v of the normed input (entered through ``f`` by the caller
    when ``sp``: this rank's query heads, and its kv heads or the kv
    heads they read)."""
    B, S, _ = xn.shape
    H, G, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    wk, wv = p["wk"], p["wv"]
    bk, bv = p.get("bk"), p.get("bv")
    if sp is not None:
        if wk.shape[-1] == G * hd:       # whole: the kv heads to read
            idx = kv_heads(H, G, sp)
            wk, wv = _kv_cols(wk, idx, hd), _kv_cols(wv, idx, hd)
            if cfg.qkv_bias:
                bk, bv = _kv_cols(bk, idx, hd), _kv_cols(bv, idx, hd)
        H, G = H // sp.m, wk.shape[-1] // hd
    q, k, v = xn @ p["wq"], xn @ wk, xn @ wv
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + bk, v + bv
    return (q.reshape(B, S, H, hd), k.reshape(B, S, G, hd),
            v.reshape(B, S, G, hd))


def _attention(p, xn, cfg: ArchConfig, opts: RunOptions, *,
               window: Optional[int], pos_offset: int = 0, sp=None):
    """The attention of the normed input xn (B,S,d), before ``wo``:
    (o (B,S,H*hd), k, v) with RoPE applied to q and k (this rank's heads
    with ``sp``)."""
    q, k, v = _qkv(p, xn, cfg, sp)
    B, S = xn.shape[:2]
    positions = pos_offset + torch.arange(S, device=xn.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = attend(q, k, v, causal=True, window=window,
               q_chunk=opts.q_chunk, kv_chunk=opts.kv_chunk)
    return o.reshape(B, S, -1), k, v


def attn_apply(p, x, cfg: ArchConfig, opts: RunOptions, *,
               window: Optional[int], pos_offset: int = 0,
               return_kv: bool = False, sp=None):
    """x + attention(norm(x)) @ wo; with ``sp`` this rank's heads, the
    normed input through ``f`` and ``wo``'s row-parallel parts summed by
    ``g``."""
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    if sp is not None:
        xn = sp.f(xn)
    o, k, v = _attention(p, xn, cfg, opts, window=window,
                         pos_offset=pos_offset, sp=sp)
    y = o @ p["wo"]
    out = x + (y if sp is None else sp.g(y))
    return (out, (k, v)) if return_kv else out


def write_slot(cache, slot, x, mine=None) -> None:
    """cache[:, slot] = x in cache's dtype, in place; cache (B,Sc,G,hd),
    x (B,1,G,hd), slot (1,) integer tensor. ``index_copy_`` has no
    float8 kernel, so a float8 cache takes the codes of x's cast through
    uint8 views of both: the same bytes, and no wider copy. ``mine`` (a
    (1,) bool tensor, or None for True): where False the slot keeps what
    it holds (a rank that does not hold the step's slot, with ``slot``
    any of its own), without a host sync."""
    x = x.to(cache.dtype)
    if cache.is_floating_point() and cache.element_size() == 1:
        cache, x = cache.view(torch.uint8), x.view(torch.uint8)
    if mine is not None:
        x = torch.where(mine, x, cache.index_select(1, slot))
    cache.index_copy_(1, slot, x)


def _attention_step(p, xn, cfg: ArchConfig, *, window, kc, vc, slot_pos,
                    cur_pos, sp=None, ssp=None):
    """One decode step's attention of the normed input xn (B,1,d), before
    ``wo``: (B,1,H*hd). kc, vc (B,Sc,G,hd) are written in place at slot
    ``cur_pos % Sc``; slot_pos (Sc,); cur_pos () integer tensor.

    With ``sp`` (the heads split) q, k and v are this rank's heads,
    gathered over the group (``heads_to``), and the result this rank's
    heads. With ``ssp`` (the slots split, ``slot_split``) kc and vc are
    this rank's block of the slots: the rank that holds the step's slot
    writes it, each attends every head over its own slots, and the parts
    are merged over the group (``merge_softmax``)."""
    B = xn.shape[0]
    q, k, v = _qkv(p, xn, cfg, sp)
    pos = cur_pos.reshape(1)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    lists = (None if sp is None
             else head_lists(cfg.n_heads, cfg.n_kv_heads, sp.m))
    o = cache_attend(q, k, v, kc, vc, slot_pos, cur_pos, window=window,
                     sp=sp, ssp=ssp, lists=lists)
    return o.reshape(B, 1, -1)


def cache_attend(q, k, v, kc, vc, slot_pos, cur_pos, *, window=None,
                 sp=None, ssp=None, lists=None):
    """One decode step's q (B,1,H,hd), k and v (B,1,G,hd) against the
    cache: k and v written at slot ``cur_pos % Sc`` (in place), then
    ``decode_attend``; (B,1,H,hd). With ``sp`` q, k and v are this
    rank's heads, ``lists`` every rank's (``head_lists``): gathered
    first (``heads_to``), and the result is this rank's heads. With
    ``ssp`` kc and vc are this rank's block of the slots: the rank that
    holds the step's slot writes it, each attends over its own slots,
    and the parts are merged (``merge_softmax``)."""
    B = q.shape[0]
    pos = cur_pos.reshape(1)
    if sp is not None:
        q = sp.heads_to(q, lists[0], slots=False)
        k = sp.heads_to(k, lists[1], slots=False)
        v = sp.heads_to(v, lists[1], slots=False)
    if ssp is None:
        slot = torch.remainder(pos, kc.shape[1]).long()
        write_slot(kc, slot, k)
        write_slot(vc, slot, v)
        o = decode_attend(q, kc, vc, slot_pos[None, :], cur_pos.expand(B),
                          window=window)
    else:
        n = kc.shape[1]
        at = torch.remainder(pos, n * ssp.m) - ssp.index * n
        mine = (at >= 0) & (at < n)
        slot = at.clamp(0, n - 1).long()
        write_slot(kc, slot, k, mine)
        write_slot(vc, slot, v, mine)
        lo = ssp.index * n
        parts = decode_attend_parts(q, kc, vc, slot_pos[None, lo:lo + n],
                                    cur_pos.expand(B), window=window)
        o = ssp.merge_softmax(*parts).to(q.dtype)
    if sp is not None:
        h0, h1 = sp.part(o.shape[2])
        o = o[:, :, h0:h1]
    return o


def attn_decode(p, x, cfg: ArchConfig, *, window, kc, vc, slot_pos, cur_pos,
                sp=None, ssp=None):
    """x (B,1,d); the caches and splits as in ``_attention_step`` (with
    ``sp``, ``wo``'s row-parallel parts summed by ``g``)."""
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    y = _attention_step(p, xn, cfg, window=window, kc=kc, vc=vc,
                        slot_pos=slot_pos, cur_pos=cur_pos, sp=sp,
                        ssp=ssp) @ p["wo"]
    return x + (y if sp is None else sp.g(y))


def _ssm_pre(p, xn):
    """Unfused projections. Returns x_in, z (…,di), b, c (…,GN),
    dt_raw (…,H)."""
    return (xn @ p["wx"], xn @ p["wz"], xn @ p["wb"], xn @ p["wc"],
            xn @ p["wdt"])


def ssm_apply(p, x, cfg: ArchConfig, opts: RunOptions, *, di: int,
              own_norm: bool = True, return_state: bool = False, sp=None):
    """Mamba2 block over the full sequence. x (B,S,d); ``di`` the inner
    width, with di / head_dim heads. Returns (y, the decode cache or
    None): with ``return_state`` the final SSM state and the last cw-1
    positions of each conv input. ``own_norm=False`` (the hybrid's SSM
    branch): x is already normed, and y is the gated, normed (B,S,di)
    branch output, without ``wout`` or the residual.

    With ``sp`` this rank's H/m heads: its columns of the projections and
    the convs, K4 on its heads, the per-head leaves' rows; B and C (its
    G N / m columns) gathered over the group after their convs, since
    every head of a group reads all N (the gather's backward sums the
    ranks' parts); ``gln``'s norm over the split ``di`` (its sum of
    squares summed over the group); ``wout`` row-parallel, then ``g``.
    The block's own input enters through ``f``; the hybrid's branch
    (``own_norm=False``) takes it entered."""
    s = cfg.ssm
    H, P = di // s.head_dim, s.head_dim
    G, N = s.n_groups, s.d_state
    xn = rms_norm(x, p["ln1"], cfg.norm_eps) if own_norm else x
    if sp is not None and own_norm:
        xn = sp.f(xn)
    B, S, _ = xn.shape
    x_raw, z, b, c, dtr = _ssm_pre(p, xn)
    x_in = F.silu(ssd.causal_conv(x_raw, p["conv_wx"], p["conv_bx"]))
    b_c = F.silu(ssd.causal_conv(b, p["conv_wb"], p["conv_bb"]))
    c_c = F.silu(ssd.causal_conv(c, p["conv_wc"], p["conv_bc"]))
    dt_bias, A_log, Dskip = p["dt_bias"], p["A_log"], p["Dskip"]
    if sp is not None:
        h0, h1 = sp.part(H)
        R = H // G                       # heads per group
        g0, g1 = h0 // R, (h1 - 1) // R + 1
        b_c = sp.gather(b_c).reshape(B, S, G, N)[:, :, g0:g1]
        c_c = sp.gather(c_c).reshape(B, S, G, N)[:, :, g0:g1]
        dt_bias, A_log, Dskip = dt_bias[h0:h1], A_log[h0:h1], Dskip[h0:h1]
        H, G = h1 - h0, g1 - g0
    Bm = b_c.reshape(B, S, G, N)
    Cm = c_c.reshape(B, S, G, N)
    dt = F.softplus(dtr + dt_bias)
    A = -torch.exp(A_log.float())
    xh = x_in.reshape(B, S, H, P)
    y, state = ssd.ssd_scan(xh, dt, A, Bm, Cm, chunk=opts.ssd_chunk)
    y = y + Dskip[None, None, :, None] * xh
    if sp is None:
        y = rms_norm(y.reshape(B, S, di) * F.silu(z), p["gln"],
                     cfg.norm_eps)
    else:
        y = rms_norm_split(y.reshape(B, S, H * P) * F.silu(z), p["gln"], sp,
                           di, cfg.norm_eps)
    cache = None
    if return_state:
        cw = s.conv_width
        cache = {"ssm": state, "conv_x": x_raw[:, -(cw - 1):],
                 "conv_b": b[:, -(cw - 1):], "conv_c": c[:, -(cw - 1):]}
    if own_norm:
        y = y @ p["wout"]
        y = x + (y if sp is None else sp.g(y))
    return y, cache


def ssm_decode(p, x, cfg: ArchConfig, cache_l, *, di: int,
               own_norm: bool = True, sp=None):
    """One step. x (B,1,d); cache_l holds this layer's ssm (B,H,P,N)
    float32, conv_x (B,cw-1,di), conv_b and conv_c (B,cw-1,GN), all
    updated in place. ``di`` and ``own_norm`` as in ``ssm_apply``. With
    ``sp`` this rank's heads and columns, as ``ssm_apply`` splits them:
    its block of the state and of each conv cache, B and C gathered
    after their convs, ``gln``'s norm split, ``wout`` row-parallel."""
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
    b_c, c_c = F.silu(outs[1]), F.silu(outs[2])
    dt_bias, A_log, Dskip = p["dt_bias"], p["A_log"], p["Dskip"]
    if sp is not None:
        h0, h1 = sp.part(H)
        R = H // G
        g0, g1 = h0 // R, (h1 - 1) // R + 1
        b_c = sp.gather(b_c).reshape(B, G, N)[:, g0:g1]
        c_c = sp.gather(c_c).reshape(B, G, N)[:, g0:g1]
        dt_bias, A_log, Dskip = dt_bias[h0:h1], A_log[h0:h1], Dskip[h0:h1]
        H, G = h1 - h0, g1 - g0
    Bm = b_c.reshape(B, G, N)
    Cm = c_c.reshape(B, G, N)
    dt = F.softplus(dtr + dt_bias)                       # (B,H)
    A = -torch.exp(A_log.float())
    xh = x_in.reshape(B, H, P)
    y, new_state = ssd.ssd_decode_step(cache_l["ssm"], xh, dt, A, Bm, Cm)
    cache_l["ssm"].copy_(new_state)
    y = y + Dskip[None, :, None] * xh
    if sp is None:
        y = rms_norm(y.reshape(B, 1, di) * F.silu(z[:, None]), p["gln"],
                     cfg.norm_eps)
    else:
        y = rms_norm_split(y.reshape(B, 1, H * P) * F.silu(z[:, None]),
                           p["gln"], sp, di, cfg.norm_eps)
    if not own_norm:
        return y
    y = y @ p["wout"]
    return x + (y if sp is None else sp.g(y))


def _combine(p, o_attn, y_ssm, cfg: ArchConfig, sp=None):
    """The hybrid's mix: each branch through its own RMSNorm, averaged,
    then the output projection (with ``sp``: the norms over the split
    width, ``wo`` row-parallel, then ``g``)."""
    if sp is None:
        comb = 0.5 * (rms_norm(o_attn, p["norm_attn"], cfg.norm_eps)
                      + rms_norm(y_ssm, p["norm_ssm"], cfg.norm_eps))
        return comb @ p["wo"]
    di = cfg.n_heads * cfg.hd
    comb = 0.5 * (rms_norm_split(o_attn, p["norm_attn"], sp, di,
                                 cfg.norm_eps)
                  + rms_norm_split(y_ssm, p["norm_ssm"], sp, di,
                                   cfg.norm_eps))
    return sp.g(comb @ p["wo"])


def hybrid_parallel(p, x, cfg: ArchConfig, opts: RunOptions, *,
                    window: Optional[int], pos_offset: int = 0,
                    return_cache: bool = False, sps=None):
    """Hymba: attention and mamba heads in parallel on the same normed
    input, their outputs normed and averaged, then the FFN. Returns (x,
    the layer's cache {k, v, ssm, conv_x, conv_b, conv_c} or None, aux).
    ``sps`` (``Splits``): with its ``attn`` split the mixer runs this
    rank's attention and SSM heads on the normed input entered once
    through ``f``; with its ``mlp`` split the FFN its hidden columns.
    With ``sps.rows`` (sequence-split) a part that does not split runs
    on every row (``_rows_whole``)."""
    sps = sps or Splits()
    sp = sps.attn

    def mixer(x):
        xn = rms_norm(x, p["ln1"], cfg.norm_eps)
        if sp is not None:
            xn = sp.f(xn)
        o_attn, k, v = _attention(p, xn, cfg, opts, window=window,
                                  pos_offset=pos_offset, sp=sp)
        y_ssm, ssm_cache = ssm_apply(p, xn, cfg, opts,
                                     di=cfg.n_heads * cfg.hd,
                                     own_norm=False,
                                     return_state=return_cache, sp=sp)
        return x + _combine(p, o_attn, y_ssm, cfg, sp), k, v, ssm_cache
    x, k, v, ssm_cache = _rows_whole(sps, sp, mixer, x)
    x, aux = _rows_whole(sps, sps.mlp,
                         lambda x: _ffn(p, x, cfg, opts, sp=sps.mlp), x)
    cache = {"k": k, "v": v, **ssm_cache} if return_cache else None
    return x, cache, aux


def hybrid_decode(p, x, cfg: ArchConfig, opts: RunOptions, *, window,
                  cache_l, slot_pos, cur_pos, sps=None, ssp=None):
    """One hybrid step. x (B,1,d); cache_l holds this layer's k, v (written
    at slot ``cur_pos % Sc``), ssm and conv caches, all updated in place.
    ``sps`` and ``ssp`` as in ``hybrid_parallel`` and
    ``_attention_step``."""
    sps = sps or Splits()
    sp = sps.attn
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    o_attn = _attention_step(p, xn, cfg, window=window, kc=cache_l["k"],
                             vc=cache_l["v"], slot_pos=slot_pos,
                             cur_pos=cur_pos, sp=sp, ssp=ssp)
    y_ssm = ssm_decode(p, xn, cfg, cache_l, di=cfg.n_heads * cfg.hd,
                       own_norm=False, sp=sp)
    x = x + _combine(p, o_attn, y_ssm, cfg, sp)
    x, _ = _ffn(p, x, cfg, opts, sp=sps.mlp)
    return x


def _ffn(p, x, cfg: ArchConfig, opts: RunOptions, layout=None, sp=None):
    """The FFN block with its residual: (x + FFN(norm(x)), the float32 aux
    loss, 0 without experts; with a ``layout``, this rank's share of the
    global batch's aux loss, ``moe_ffn``). With ``sp`` this rank's part
    of the products (``mlp``, ``moe_ffn``)."""
    xn = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.moe is not None:
        y, aux = moe_ffn(p, xn, n_experts=cfg.moe.n_experts,
                         top_k=cfg.moe.top_k,
                         capacity_factor=opts.capacity_factor,
                         group_size=opts.moe_group, layout=layout, sp=sp,
                         sharding=opts.moe_sharding)
        return x + y, aux
    return x + mlp(p, xn, cfg.mlp, sp), torch.zeros((), dtype=torch.float32,
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


def _block_fwd(lp, x, cfg, opts, *, window, return_cache, sps,
               layout=None):
    if layout is not None:
        lp = layout.layer(lp, modes=layer_modes(sps.plan, opts,
                                                sps.rows is not None))
    if cfg.family == "ssm":
        y, c = _rows_whole(sps, sps.ssm, lambda x: ssm_apply(
            lp, x, cfg, opts, di=cfg.d_inner, return_state=return_cache,
            sp=sps.ssm), x)
        return y, c, torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "hybrid":
        return hybrid_parallel(lp, x, cfg, opts, window=window,
                               return_cache=return_cache, sps=sps)
    y, (k, v) = _rows_whole(sps, sps.attn, lambda x: attn_apply(
        lp, x, cfg, opts, window=window, return_kv=True, sp=sps.attn), x)
    # a prefill's aux loss is dropped: no batch sum for it
    ffn = sps.mlp or sps.moe
    y, aux = _rows_whole(sps, ffn, lambda y: _ffn(
        lp, y, cfg, opts, None if return_cache else layout, ffn), y)
    return y, ({"k": k, "v": v} if return_cache else None), aux


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


def run_stack(params, x, cfg: ArchConfig, opts: RunOptions, *, sps: Splits,
              return_cache: bool = False, layout=None):
    """Forward through all layers; returns (x, cache | None, aux) with
    each cache entry (k and v, or the ssm state and conv caches) stacked
    on L. Each layer runs under ``remat(opts.remat)`` when there is no
    cache to return (training). With a ``layout`` (a train step across
    ranks) each layer's leaves are this rank's blocks, gathered inside
    the remat region, so ``remat="full"`` gathers them again in the
    backward; ``sps`` its ``splits`` (with ``rows``, x is this rank's
    rows, and the rows' gathers run inside the remat region too, so the
    saved block input is this rank's rows)."""
    check_family(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for li, lp in enumerate(unbind_layers(params["layers"], cfg.n_layers)):
        block = functools.partial(_block_fwd, cfg=cfg, opts=opts,
                                  window=_layer_window(cfg, li),
                                  return_cache=return_cache, layout=layout,
                                  sps=sps)
        if not return_cache:
            block = remat(block, opts.remat)
        x, c, a = block(lp, x)
        aux = aux + a
        caches.append(c)
    cache = ({k: torch.stack([c[k] for c in caches]) for k in caches[0]}
             if return_cache else None)
    return x, cache, aux


def run_stack_decode(params, cache, x, cfg: ArchConfig, opts: RunOptions, *,
                     slot_pos, cur_pos, layout=None):
    """One decode step through all layers; ``cache["layers"]`` (stacked
    on L) is updated in place and returned. With a ``layout`` (serving
    across ranks) each layer's leaves are this rank's blocks, gathered
    at use as a train step's, the split blocks run this rank's part,
    and the kv cache is this rank's block of the slots where
    ``slot_split`` says so."""
    check_family(cfg)
    layers = cache["layers"]
    sps = splits(layout, cfg, opts)
    modes = layer_modes(sps.plan, opts)
    ssp = None if slot_pos is None else slot_split(layout,
                                                   slot_pos.shape[0])
    for li in range(cfg.n_layers):
        lp = _layer(params, li)
        if layout is not None:
            lp = layout.layer(lp, modes=modes)
        cache_l = {k: v[li] for k, v in layers.items()}
        if cfg.family == "ssm":
            x = ssm_decode(lp, x, cfg, cache_l, di=cfg.d_inner, sp=sps.ssm)
            continue
        if cfg.family == "hybrid":
            x = hybrid_decode(lp, x, cfg, opts, window=_layer_window(cfg, li),
                              cache_l=cache_l, slot_pos=slot_pos,
                              cur_pos=cur_pos, sps=sps, ssp=ssp)
            continue
        x = attn_decode(lp, x, cfg, window=_layer_window(cfg, li),
                        kc=cache_l["k"], vc=cache_l["v"],
                        slot_pos=slot_pos, cur_pos=cur_pos, sp=sps.attn,
                        ssp=ssp)
        x, _ = _ffn(lp, x, cfg, opts, sp=sps.mlp or sps.moe)
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
               embeds=None, *, return_cache: bool = False, layout=None):
    """tokens (B,S) integer; embeds (B,F,d) optional frontend stub output.
    Returns (logits (B,S,Vp), cache | None, aux). With a ``layout`` the
    params are this rank's blocks, gathered at use (``run_stack``).

    Sequence-split (``splits``' ``rows``): the embedding's ``g`` leaves
    each rank its F+S / m rows (the frontend's rows too: the rows are
    cut after the concatenation), the layers run on them, the final norm
    too, and the head's ``f`` gathers every row before the logits, so
    the logits and the loss are the step's without the split."""
    cdt = getattr(torch, opts.compute_dtype)
    params = _compute_params(params, cdt)
    F_ = 0 if embeds is None else embeds.shape[1]
    sps = splits(layout, cfg, opts, rows=F_ + tokens.shape[1])
    vsp = sps.vocab
    if layout is not None:
        params = layout.top(params, top_modes(sps.plan, sps.rows is not None))
    if sps.rows is not None and embeds is not None:
        x = embed_tokens(params["embed"], tokens, layout.split).to(cdt)
        x = sps.rows.split_alike(torch.cat([embeds.to(cdt), x], dim=1))
    else:
        x = embed_tokens(params["embed"], tokens, vsp).to(cdt)
        if embeds is not None:
            x = torch.cat([embeds.to(cdt), x], dim=1)
    x, cache, aux = run_stack(params, x, cfg, opts, return_cache=return_cache,
                              layout=layout, sps=sps)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return lm_logits(x, _head(params, cfg), cfg.vocab, vsp), cache, aux


def lm_loss(params, cfg: ArchConfig, opts: RunOptions, batch, layout=None):
    """The reference's ``lm_loss``: batch {"tokens" (B,S), optional
    "embeds" (B,F,d)}; logit position F+i predicts tokens[:, i+1]; the
    mean cross entropy plus ``opts.aux_loss_weight`` times the MoE aux
    loss. A float32 scalar. With a ``layout`` whose batch is split over
    n ranks, this rank's share: its rows' mean over n, plus its share of
    the global aux loss."""
    tokens = batch["tokens"]
    embeds = batch.get("embeds")
    logits, _, aux = lm_forward(params, cfg, opts, tokens, embeds,
                                layout=layout)
    F_ = 0 if embeds is None else embeds.shape[1]
    S = tokens.shape[1]
    loss = softmax_xent(logits[:, F_:F_ + S - 1], tokens[:, 1:], cfg.vocab,
                        splits(layout, cfg, opts).vocab)
    if layout is not None and layout.n_batch > 1:
        loss = loss / layout.n_batch
    return loss + opts.aux_loss_weight * aux


def next_token(logits, vsp=None):
    """The argmax of the last dim as int32; with ``vsp`` the logits are
    this rank's vocab columns and the argmax the global one
    (``ModelSplit.argmax``: ties to the lowest index, as here)."""
    if vsp is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return vsp.argmax(logits).to(torch.int32)


def kv_to_slots(k, v, layout, lists):
    """A prefill's stacked k and v (L,B,Sc,k,hd), as this rank computed
    them, into the cache the reference lays out (``"cache_seq"`` on
    ``"model"``): this rank's block of the Sc slots for every kv head,
    or every slot where Sc is not a multiple of the model axis
    (``slot_split``). Where the heads split (``lists``: every rank's kv
    heads, ``head_lists``) one all-to-all of k and v together over the
    group moves them (``heads_to``: a kv head computed on several ranks
    is taken from the first); where they do not (``lists`` None: a
    mixer gathered at use), each rank has every head and keeps its own
    slots."""
    sp = None if layout is None else layout.split
    if sp is None:
        return k, v
    L, B, Sc = k.shape[:3]
    slots = slot_split(layout, Sc) is not None
    if lists is None:
        if not slots:
            return k, v
        lo, hi = sp.part(Sc)
        return k[:, :, lo:hi].contiguous(), v[:, :, lo:hi].contiguous()
    both = torch.stack([k, v]).reshape((2 * L * B,) + k.shape[2:])
    out = sp.heads_to(both, lists, slots=slots)
    out = out.reshape((2, L, B) + out.shape[1:])
    return out[0], out[1]


def lm_prefill(params, cfg: ArchConfig, opts: RunOptions, tokens,
               embeds=None, cache_len: Optional[int] = None, layout=None,
               logits: bool = False):
    """Returns (last-position argmax token (B,) int32, cache), k and v
    in ``opts.kv_cache_dtype`` when it is set. A
    ``cache_len`` past the prompt reserves decode head-room in ``k`` and
    ``v`` (empty slots at position -1), as the reference's ``pad_kv``:
    the hybrid's SSM state and conv caches keep their shapes. The SSM
    family's cache has no positions, so it ignores ``cache_len`` and has
    no ``slot_pos``. With ``logits`` also the last position's logits
    (this rank's vocab columns where the vocab splits).

    With a ``layout`` (serving across ranks) the params are this rank's
    blocks and ``tokens`` its rows: the forward is the train step's
    split (``lm_forward``), the next token the argmax over the vocab
    split, k and v moved to the slots (``kv_to_slots``); the SSM state
    and conv caches stay as this rank computed them (its heads and
    columns where the SSM splits)."""
    out, layer_cache, _ = lm_forward(params, cfg, opts, tokens, embeds,
                                     return_cache=True, layout=layout)
    sps = splits(layout, cfg, opts)
    S_total = out.shape[1]
    last = out[:, -1]
    del out
    next_tok = next_token(last, sps.vocab)
    dev = last.device
    pos = torch.tensor(S_total, dtype=torch.int32, device=dev)
    if opts.kv_cache_dtype:
        kvdt = getattr(torch, opts.kv_cache_dtype)
        layer_cache = {k: (v.to(kvdt) if k in ("k", "v") else v)
                       for k, v in layer_cache.items()}
    if cfg.family == "ssm":
        cache = {"layers": layer_cache, "pos": pos}
        return (next_tok, cache, last) if logits else (next_tok, cache)
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
    lists = None if sps.attn is None else head_lists(
        cfg.n_heads, cfg.n_kv_heads, sps.attn.m)[1]
    layer_cache["k"], layer_cache["v"] = kv_to_slots(
        layer_cache["k"], layer_cache["v"], layout, lists)
    cache = {"layers": layer_cache, "pos": pos, "slot_pos": slot_pos}
    return (next_tok, cache, last) if logits else (next_tok, cache)


def lm_decode_step(params, cfg: ArchConfig, opts: RunOptions, cache, token,
                   layout=None, logits: bool = False):
    """token (B,) integer -> (next token (B,) int32, cache). The cache's
    layers and slot_pos (absent for the SSM family) are updated in
    place; ``pos`` advances by one. With ``logits`` also the step's
    logits. With a ``layout`` the params are this rank's blocks and the
    cache is ``lm_prefill``'s across ranks (``run_stack_decode``); the
    next token is the argmax over the vocab split."""
    cdt = getattr(torch, opts.compute_dtype)
    params = _compute_params(params, cdt)
    sps = splits(layout, cfg, opts)
    if layout is not None:
        params = layout.top(params, top_modes(sps.plan))
    cur = cache["pos"]
    x = embed_tokens(params["embed"], token[:, None], sps.vocab).to(cdt)
    slot_pos = cache.get("slot_pos")
    if slot_pos is not None:
        slot = torch.remainder(cur.reshape(1), slot_pos.shape[0]).long()
        slot_pos.index_copy_(0, slot, cur.reshape(1).to(slot_pos.dtype))
    x, layers = run_stack_decode(params, cache, x, cfg, opts,
                                 slot_pos=slot_pos, cur_pos=cur,
                                 layout=layout)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    out = lm_logits(x[:, 0], _head(params, cfg), cfg.vocab, sps.vocab)
    next_tok = next_token(out, sps.vocab)
    new_cache = {"layers": layers, "pos": cur + 1}
    if slot_pos is not None:
        new_cache["slot_pos"] = slot_pos
    return (next_tok, new_cache, out) if logits else (next_tok, new_cache)
