"""Attention: RoPE, full / causal GQA attention and one decode step, the
port of ``repro/models/attention.py``.

- ``mha``: training / prefill attention. On a CUDA tensor it is kernel
  K3 (``kernels/flash_attention.py``), which streams over kv tiles the
  way the reference's chunked scan streams over kv chunks, and K3's
  backward kernel when autograd needs the gradient; on the CPU it is
  K3's plain version, one masked softmax, which autograd differentiates.
- ``decode_attend``: one query step against a (possibly ring-buffer) kv
  cache with per-slot absolute positions, plain PyTorch (the reference
  has no kernel for it); ``decode_attend_parts`` the same over a rank's
  part of the slots, unnormalised, for a merge across ranks.
- ``banded_mha``: causal sliding-window prefill. On a CUDA tensor it is
  K3 with its window; on the CPU the reference's banded form, each query
  chunk against its gathered kv band ``[qs - W, qs + qc)``.
- ``attend``: the reference's dispatch, the banded path for a causal
  window and ``mha`` otherwise.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import (NEG_INF, flash_attention,
                                                 masked_attention)


# ------------------------------- RoPE --------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=device) / half
    return torch.pow(torch.tensor(theta, dtype=torch.float32, device=device),
                     exponent)


def apply_rope(x, positions, theta: float = 10_000.0):
    """x (..., S, H, D); positions broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)               # (D/2,)
    ang = positions[..., None].float() * freqs                  # (..., S, D/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------- full / causal MHA ------------------------------
def mha(q, k, v, *, causal: bool = True, q_offset: int = 0,
        q_chunk: int = 512, kv_chunk: int = 1024,
        scale: Optional[float] = None):
    """q (B,Sq,H,D); k, v (B,Skv,G,D) with H = G*R. Returns (B,Sq,H,D).

    ``q_chunk`` and ``kv_chunk`` are the reference's memory knobs: K3
    picks its own tiles and the plain version does not chunk. Off the
    CPU it is K3 (or its wrapper's error), which takes queries from
    position 0 at the default scale D^-0.5; other values raise there."""
    if k.dtype != q.dtype:            # e.g. a low-precision cache
        k, v = k.to(q.dtype), v.to(q.dtype)
    if q.device.type != "cpu":
        D = q.shape[-1]
        if q_offset != 0 or (scale is not None and scale != D ** -0.5):
            raise ValueError("the attention kernel takes q_offset=0 and the "
                             f"scale D^-0.5, not q_offset={q_offset}, "
                             f"scale={scale}")
        return flash_attention(q, k, v, causal=causal)
    return masked_attention(q, k, v, causal=causal, window=None,
                            q_offset=q_offset, scale=scale)


# ------------------------------- decode ------------------------------------
def _decode_scores(q, k_cache, slot_pos, cur_pos, window, scale):
    """The float32 scores (B,G,R,1,Sc) of one decode step, NEG_INF where
    a slot is not visible, and the (B,1,1,1,Sc) mask of those that are."""
    B, _, H, D = q.shape
    G = k_cache.shape[2]
    scale = scale or D ** -0.5
    qg = (q * scale).reshape(B, 1, G, H // G, D)
    s = torch.einsum("bqgrd,bsgd->bgrqs", qg, k_cache.to(q.dtype)).float()
    ok = (slot_pos >= 0) & (slot_pos <= cur_pos[:, None])
    if window is not None:
        ok &= slot_pos > (cur_pos[:, None] - window)
    ok = ok[:, None, None, None, :]
    return torch.where(ok, s, NEG_INF), ok


def decode_attend(q, k_cache, v_cache, slot_pos, cur_pos, *,
                  window: Optional[int] = None,
                  scale: Optional[float] = None):
    """One decode step. q (B,1,H,D); caches (B,Sc,G,D); slot_pos (B,Sc)
    absolute position per slot (-1 = empty); cur_pos (B,)."""
    B, _, H, D = q.shape
    s, _ = _decode_scores(q, k_cache, slot_pos, cur_pos, window, scale)
    p = torch.softmax(s, dim=-1)
    v_cache = v_cache.to(q.dtype)
    o = torch.einsum("bgrqs,bsgd->bgrqd", p.to(v_cache.dtype), v_cache)
    return o.reshape(B, 1, H, D).to(q.dtype)


def decode_attend_parts(q, k_cache, v_cache, slot_pos, cur_pos, *,
                        window: Optional[int] = None):
    """``decode_attend`` over a part of the cache's slots, before the
    softmax's normalisation: (o (B,1,H,D) float32, unnormalised; the row
    sums (B,1,H); the row maxima (B,1,H), NEG_INF where no slot of the
    part is visible, whose o and sums are then 0). Parts over disjoint
    slots merge into ``decode_attend`` (``ModelSplit.merge_softmax``)."""
    B, _, H, D = q.shape
    s, ok = _decode_scores(q, k_cache, slot_pos, cur_pos, window, None)
    mx = s.amax(-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - mx), torch.zeros((), dtype=s.dtype,
                                                       device=s.device))
    v_cache = v_cache.to(q.dtype)
    o = torch.einsum("bgrqs,bsgd->bgrqd", p.to(v_cache.dtype), v_cache)
    return (o.float().reshape(B, 1, H, D), p.sum(-1).reshape(B, 1, H),
            mx.reshape(B, 1, H))


def _gqa_scores(qg, kc):
    """qg (B,qc,G,R,D) x kc (B,kc,G,D) -> (B,G,R,qc,kc) in float32."""
    return torch.einsum("bqgrd,bsgd->bgrqs", qg.float(), kc.float())


def banded_mha(q, k, v, *, window: int, q_chunk: int = 512,
               scale: Optional[float] = None):
    """Causal sliding-window attention: query i sees keys (i - window,
    i]. q (B,Sq,H,D); k, v (B,Skv,G,D). Off the CPU it is K3 with
    ``window`` (the kernel skips the kv tiles outside the band and picks
    its own tiles; the scale must be D^-0.5). On the CPU, the reference's
    form: each query chunk [qs, qs + qc) attends to the kv band
    [qs - window, qs + qc) of kv left-padded by ``window`` and right-padded
    to whole chunks, masked to the causal window and the real keys."""
    B, Sq, H, D = q.shape
    _, Skv, G, _ = k.shape
    R = H // G
    if q.device.type != "cpu":          # K3 or its wrapper's error
        if scale is not None and scale != D ** -0.5:
            raise ValueError(f"the attention kernel takes the scale D^-0.5, "
                             f"not {scale}")
        return flash_attention(q, k, v, causal=True, window=window)
    scale = scale or D ** -0.5
    q_chunk = min(q_chunk, Sq)
    nq = -(-Sq // q_chunk)
    pad_q = nq * q_chunk - Sq
    q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    band = window + q_chunk
    kp = F.pad(k, (0, 0, 0, 0, window, pad_q))
    vp = F.pad(v, (0, 0, 0, 0, window, pad_q))
    qr = (q * scale).reshape(B, nq, q_chunk, G, R, D)
    outs = []
    for qi in range(nq):
        qs = qi * q_chunk
        s = _gqa_scores(qr[:, qi], kp[:, qs:qs + band])  # (B,G,R,qc,band)
        q_pos = qs + torch.arange(q_chunk, device=q.device)
        k_pos = qs - window + torch.arange(band, device=q.device)
        mask = ((k_pos[None, :] <= q_pos[:, None])
                & (k_pos[None, :] > q_pos[:, None] - window)
                & (k_pos[None, :] >= 0) & (k_pos[None, :] < Skv))
        s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        v_blk = vp[:, qs:qs + band]
        o = torch.einsum("bgrqs,bsgd->bgrqd", p.to(v_blk.dtype).float(),
                         v_blk.float())
        outs.append(o.permute(0, 3, 1, 2, 4))            # (B,qc,G,R,D)
    out = torch.stack(outs, 1).reshape(B, nq * q_chunk, H, D)
    return out[:, :Sq].to(q.dtype)


def attend(q, k, v, *, causal: bool, window: Optional[int],
           q_offset: int = 0, q_chunk: int = 512, kv_chunk: int = 1024):
    """Dispatch, as the reference's: the banded path for a causal window
    (chunks of at most the window past 2W queries, else at most Sq),
    ``mha`` otherwise."""
    Sq = q.shape[1]
    if window is not None and causal and Sq > 2 * window:
        return banded_mha(q, k, v, window=window,
                          q_chunk=min(q_chunk, window))
    if window is not None and causal:
        return banded_mha(q, k, v, window=window, q_chunk=min(q_chunk, Sq))
    return mha(q, k, v, causal=causal, q_offset=q_offset, q_chunk=q_chunk,
               kv_chunk=kv_chunk)
