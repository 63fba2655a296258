"""Mamba2 SSD (state-space duality): the chunked scan, its sequential
oracle, one decode step and the causal convolutions; the port of
``repro/models/ssd.py``.

Math (per head h, state S in R^{P x N}):
    S_t = a_t * S_{t-1} + dt_t * x_t (x) B_t        a_t = exp(dt_t * A_h), A_h < 0
    y_t = C_t . S_t + D_h * x_t

``ssd_scan`` is kernel K4 (``kernels/ssd.py``): the hand-written Hopper
kernels (five passes, and the backward kernel's seven where a gradient
is needed) on a CUDA tensor, the plain chunked form (``ssd_chunk_body``
looped over chunks) on the CPU. ``ssd_decode_step``, ``causal_conv`` and
``causal_conv_step`` are plain PyTorch, as the reference has no kernel
for them; ``causal_conv`` keeps the reference's loop over the conv width
(not ``F.conv1d``), so its sums run in the reference's order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# the model path's scan, K4 (its chunked plain form, ``ssd_chunk_body``,
# lives beside the kernel's wrapper in ``kernels/ssd.py``)
from repro_torch.kernels.ssd import ssd_scan  # noqa: F401


def ssd_ref(x, dt, A, Bm, Cm, init_state=None):
    """O(S) sequential reference (the tests' oracle). Returns y in x's
    dtype and the final state (B,H,P,N) in float32 (float64 for float64
    inputs)."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    R = H // G
    ct = torch.promote_types(x.dtype, torch.float32)
    state = (torch.zeros((B, H, P, N), dtype=ct, device=x.device)
             if init_state is None else init_state.to(ct))
    ys = []
    for t in range(S):
        a = torch.exp(dt[:, t] * A[None, :])                 # (B,H)
        Bh = torch.repeat_interleave(Bm[:, t], R, dim=1)     # (B,H,N)
        Ch = torch.repeat_interleave(Cm[:, t], R, dim=1)
        state = (a[..., None, None] * state
                 + (dt[:, t, :, None] * x[:, t])[..., None]
                 * Bh[:, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch))
    return torch.stack(ys, 1).to(x.dtype), state


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t):
    """One decode step. state (B,H,P,N) float32; x_t (B,H,P); dt_t (B,H);
    B_t, C_t (B,G,N). Returns (y (B,H,P), new state)."""
    H = x_t.shape[1]
    R = H // B_t.shape[1]
    a = torch.exp(dt_t * A[None, :])
    Bh = torch.repeat_interleave(B_t, R, dim=1)
    Ch = torch.repeat_interleave(C_t, R, dim=1)
    state = (a[..., None, None] * state
             + (dt_t[..., None] * x_t.float())[..., None]
             * Bh[:, :, None, :].float())
    y = torch.einsum("bhpn,bhn->bhp", state, Ch.to(state.dtype))
    return y.to(x_t.dtype), state


def causal_conv(x, w, b):
    """Depthwise causal conv. x (B,S,C); w (cw,C); b (C,)."""
    cw = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, cw - 1, 0))
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(cw):
        y = y + xp[:, i:i + S].float() * w[i]
    return (y + b).to(x.dtype)


def causal_conv_step(conv_state, x_t, w, b):
    """conv_state (B,cw-1,C); x_t (B,C). Returns (y_t, new_state)."""
    hist = torch.cat([conv_state, x_t[:, None]], dim=1)      # (B,cw,C)
    # in float32, as the reference's einsum promotes bfloat16 weights
    y = torch.einsum("bic,ic->bc", hist.float(), w.float()) + b
    return y.to(x_t.dtype), hist[:, 1:]
