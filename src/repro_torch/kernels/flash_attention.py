"""Causal and/or sliding-window GQA attention (kernel K3).

``flash_attention`` is the port of ``repro/kernels/flash_attention.py``'s
Pallas kernel: q (B,Sq,H,D), k and v (B,Skv,G,D) with H = G*R, head h
reading kv head h // R; scale D^-0.5; masked scores at -1e30; the output
(B,Sq,H,D). On a CUDA tensor the wrapper launches the hand-written
Hopper kernel ``csrc/flash_attention.cu`` (built with nvcc at first use,
bound through ctypes) or raises; it never falls back. On a CPU tensor it
runs the plain version ``flash_attention_ref``, the reference's
``ref.flash_attention_ref`` written in PyTorch: one masked softmax over
the whole score matrix. ``LAUNCHES`` counts kernel launches.

The kernel takes float32 only and computes on the FP32 CUDA cores (no
TF32), D up to ``MAX_HEAD_DIM``. It skips kv tiles the mask rules out,
which changes no row that sees at least one key; a row that sees none
is outside K3's contract (there the TPU kernel's value depends on its
block size, the plain version's is the mean of v, the kernel's is 0).
Tolerance against the plain version: both are float32 softmaxes summed
in other orders, so they agree to about 1e-6 relative on O(1) inputs.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

LAUNCHES = 0
MAX_HEAD_DIM = 128
NEG_INF = -1e30


def masked_attention(q, k, v, *, causal: bool, window: Optional[int],
                     q_offset: int = 0, scale: Optional[float] = None):
    """Naive masked softmax attention over the whole (Sq, Skv) score
    matrix, in float32: ``flash_attention_ref`` with the query positions
    starting at ``q_offset`` and an optional scale (``models.attention``
    uses both)."""
    B, Sq, H, D = q.shape
    _, Skv, G, _ = k.shape
    R = H // G
    scale = scale or D ** -0.5
    qg = q.reshape(B, Sq, G, R, D).float() * scale
    s = torch.einsum("bqgrd,bsgd->bgrqs", qg, k.float())
    qp = q_offset + torch.arange(Sq, device=q.device)
    kp = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp[None, :] <= qp[:, None]
    if window is not None:
        mask &= kp[None, :] > qp[:, None] - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrqs,bsgd->bgrqd", p, v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None):
    """The plain version (``ref.flash_attention_ref``)."""
    return masked_attention(q, k, v, causal=causal, window=window)


def _lib():
    from repro_torch.kernels import build
    fn = build.load("flash_attention").flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, window) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.float32:
            raise TypeError(f"the attention kernel takes float32; {name} is "
                            f"{x.dtype}")
        if x.ndim != 4:
            raise ValueError(f"{name} must be 4-D, not {tuple(x.shape)}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    B, Sq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    G, Skv = k.shape[2], k.shape[1]
    if G == 0 or H % G:
        raise ValueError(f"{H} query heads do not group over {G} kv heads")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"the attention kernel takes head dims up to "
                         f"{MAX_HEAD_DIM}, not {D}")
    if Skv == 0:
        raise ValueError("the attention kernel needs at least one key")
    if B > 65535 or H > 65535:
        raise ValueError(f"the attention kernel's grid takes up to 65535 "
                         f"batches and heads, not B={B}, H={H}")
    if window is not None and window < 1:
        raise ValueError(f"window must be at least 1, not {window}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None):
    """q (B,Sq,H,D); k, v (B,Skv,G,D). Returns (B,Sq,H,D)."""
    global LAUNCHES
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k, v, window)
    B, Sq, H, D = q.shape
    Skv, G = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Sq, Skv, H, G, D, int(causal), int(window or 0),
                 D ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    LAUNCHES += 1
    return out
