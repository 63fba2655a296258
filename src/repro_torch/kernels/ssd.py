"""The Mamba2 SSD chunked scan (kernel K4).

``ssd_scan`` is the port of ``repro/kernels/ssd.py``'s Pallas kernel with
the model path's signature (``repro/models/ssd.py:ssd_scan``): x
(B,S,H,P), dt (B,S,H) after softplus, A (H,) negative, Bm and Cm
(B,S,G,N) shared by the R = H/G heads of a group, an optional
``init_state`` (B,H,P,N); it returns y (B,S,H,P) and the final state
(B,H,P,N). S is cut into chunks of Q = min(chunk, S) positions, the last
one padded with dt = 0 and x = 0, which decays the state by exp(0) = 1
and adds nothing.

On a CUDA tensor the wrapper runs hand-written Hopper kernels (built
with nvcc at first use, bound through ctypes) or raises; it never falls
back: ``csrc/ssd_scan.cu`` for float32 x, B and C, ``csrc/ssd_scan_bf16.cu``
for bfloat16 ones (``_lib``). Each is five passes on the current stream
(``PASSES``): the chunk cumsum of dt * A, C.B^T once per (batch, chunk,
group), each chunk's contribution to the state, the state passed across
chunks, and the chunk scan that forms y (the first and the fourth are
shared, ``csrc/ssd_common.cuh``); the scratch between them is allocated
here with ``torch.empty``, in one layout for both, and each pass's
launch error is raised on. ``LAUNCHES`` counts ``ssd_scan`` calls that
launched the kernels, one per call, and ``BF16_LAUNCHES`` those of them
that took the bfloat16 library. On a CPU tensor it runs
the plain version ``ssd_scan_ref``, the reference model path's chunked
form written in PyTorch (einsums per chunk, a loop over chunks), so the
CPU path keeps the reference's arithmetic order.

Each pass has its plain version here (``cumsum_ref``, ``bmm_ref``,
``chunk_state_ref``, ``state_passing_ref``, ``chunk_scan_ref``), on the
kernels' scratch layouts; ``ssd_scan_passes`` composes them. The
kernels take x, Bm and Cm all in float32 or all in bfloat16 (the models'
default compute dtype), dt in float32 or in x's dtype, A in float32 and
``init_state`` in float32 or bfloat16 (the reference's kernel takes any
float dtype; float16 is still to come here and is refused by name); y
comes back in x's dtype and the final state in float32, as the
reference writes them. Both take P up to ``MAX_HEAD_DIM``, N up to
``MAX_STATE``, ``chunk`` up to ``MAX_CHUNK``, and run every product on
the tensor cores. float32: in 3xTF32 (each operand split into two TF32
numbers, three TF32 products per float32 one); ``ssd_scan_tf32`` is a
float64 model of that arithmetic. bfloat16: the tiles stay bfloat16 to
bf16 ``wgmma``; C.B^T is one bf16 product (exact products), and the
three products with a float32 operand (the decayed x times B, the
weights times x, C times S_in) two, that operand split into two
bfloat16 parts (``bf16_split``); ``ssd_scan_bf16`` is a float64 model
of that arithmetic. ``error_bound`` states how far each library may lie
from the exact scan (``chip_smoke.py`` and the card tests hold them so).

The gradient. On a CUDA tensor that needs one, ``ssd_scan`` runs
``SsdScanFn``: the five passes, their scratch (dts, cum, cb and S_in per
chunk) kept for the backward kernels, nine passes each (``BWD_PASSES``),
a group's heads spread over up to ``BWD_HEAD_SLICES`` slices whose
partial sums are added in a fixed order, which write dx, ddt, dA, dB,
dC and d(init_state) in their operands' dtypes (dA float32) with no
atomics, the same bits on every launch. Two libraries (``_bwd_lib``),
the four passes without products shared (``csrc/ssd_bwd_common.cuh``):
``csrc/ssd_scan_bwd.cu`` for float32 x, B, C and dy, every product in
3xTF32; ``csrc/ssd_scan_bwd_bf16.cu`` for bfloat16 ones, bf16 ``wgmma``
on the bfloat16 tiles as they land (TMA), D = dy . x^T one bf16 product
(exact) and every product with a float32 operand two, that operand
split into two bfloat16 parts; ``ssd_scan_bwd_bf16`` is a float64 model
of that arithmetic. ``BWD_LAUNCHES`` counts the backward's calls and
``BF16_BWD_LAUNCHES`` those of them that took the bfloat16 library. Its
plain version ``ssd_scan_bwd_ref`` composes the five passes reversed
(``chunk_scan_bwd_ref``, ``state_passing_bwd_ref``,
``chunk_state_bwd_ref``, ``bmm_bwd_ref``, ``cumsum_bwd_ref``), each the
vector-Jacobian product of its forward pass's plain version;
``bwd_error_bound`` states how far each library may lie from the exact
gradient. The one-pass entry ``launch`` still refuses a gradient.

On a ``meta`` tensor (the dry run's account, ``launch/dryrun.py``)
``ssd_scan`` and ``ssd_scan_bwd`` compute nothing: they return ``meta``
tensors of the kernels' output shapes and add the kernels' operation
count (``work``, the count of ``PERF.md``'s bounds) to ``META_OPS``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import (BF16_ROUND, DTYPES,
                                                 P_SPLIT_ERR, PRODUCT_ERR,
                                                 bf16_split, tf32_products)
from repro_torch.kernels.nograd import refuse_grad

LAUNCHES = 0
BF16_LAUNCHES = 0       # of LAUNCHES, those through csrc/ssd_scan_bf16.cu
MAX_HEAD_DIM = 64       # P: the kernels' x, y and state tiles
MAX_STATE = 128         # N: their B, C and state tiles
MAX_CHUNK = 256         # Q: the per-chunk cumsum
TILE = 64               # rows of a t or s tile; chunks are padded to it
PASSES = ("ssd_cumsum", "ssd_bmm", "ssd_chunk_state", "ssd_state_passing",
          "ssd_chunk_scan")


def ssd_chunk_body(x_c, dt_c, la_c, B_c, C_c, state):
    """One chunk. Shapes: x_c (B,Q,G,R,P); dt_c, la_c (B,Q,G,R); B_c, C_c
    (B,Q,G,N); state (B,G,R,P,N). Returns (y_c, new_state)."""
    cum = torch.cumsum(la_c, dim=1)                      # (B,Q,G,R)
    total = cum[:, -1]                                   # (B,G,R)
    Q = x_c.shape[1]
    # intra-chunk (quadratic in Q)
    CB = torch.einsum("bqgn,bsgn->bgqs", C_c, B_c)       # (B,G,Q,Q)
    seg = cum[:, :, None] - cum[:, None, :]              # (B,Q,S,G,R) t,s
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                device=x_c.device))[None, :, :, None, None]
    # masked before the exp, as the kernels do: above the diagonal seg may
    # overflow, and autograd's gradient there would be 0 * inf = NaN (the
    # same values forward)
    w = torch.where(tri, torch.exp(torch.where(tri, seg, 0.0)), 0.0)
    w = w * dt_c[:, None]                                # * dt_s
    y_intra = torch.einsum("bgts,btsgr,bsgrp->btgrp", CB, w, x_c)
    # inter-chunk
    y_inter = torch.einsum("bqgn,bgrpn->bqgrp", C_c, state)
    y_inter = y_inter * torch.exp(cum)[..., None]
    # state update
    decay_out = torch.exp(total[:, None] - cum) * dt_c   # (B,Q,G,R)
    new_state = (torch.exp(total)[..., None, None] * state
                 + torch.einsum("bqgrp,bqgn,bqgr->bgrpn", x_c, B_c,
                                decay_out))
    return y_intra + y_inter, new_state


def ssd_scan_ref(x, dt, A, Bm, Cm, *, chunk: int = 256, init_state=None):
    """The plain version: ``repro/models/ssd.py:ssd_scan`` in PyTorch.
    Computes in float32 (float64 for float64 inputs); y comes back in
    x's dtype, the state in the compute dtype."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    R = H // G
    ct = torch.promote_types(x.dtype, torch.float32)
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    xf, dtf, Bf, Cf = (t.to(ct) for t in (x, dt, Bm, Cm))
    if pad:
        xf = F.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = F.pad(dtf, (0, 0, 0, pad))
        Bf = F.pad(Bf, (0, 0, 0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, 0, 0, pad))
    la = dtf * A.to(ct)[None, None, :]                   # log decay
    xr = xf.reshape(B, nc, Q, G, R, P)
    dtr = dtf.reshape(B, nc, Q, G, R)
    lar = la.reshape(B, nc, Q, G, R)
    Br = Bf.reshape(B, nc, Q, G, N)
    Cr = Cf.reshape(B, nc, Q, G, N)
    if init_state is None:
        state = torch.zeros((B, G, R, P, N), dtype=ct, device=x.device)
    else:
        state = init_state.reshape(B, G, R, P, N).to(ct)
    ys = []
    for c in range(nc):
        y, state = ssd_chunk_body(xr[:, c], dtr[:, c], lar[:, c], Br[:, c],
                                  Cr[:, c], state)
        ys.append(y)
    y = torch.stack(ys, 1).reshape(B, nc * Q, H, P)[:, :S]
    return y.to(x.dtype), state.reshape(B, H, P, N)


# the operations the meta shape path reckoned: forward and backward
META_OPS = {"forward": 0, "backward": 0}


def work(x_shape, G: int, N: int, chunk: int, backward: bool = False
         ) -> int:
    """The operations the kernel does on x (B,S,H,P) with G groups of N
    states, 2 a multiply-add, per chunk of Q = min(chunk, S) positions
    (pairs = Q (Q + 1) / 2). Forward: the causal half of C.B^T per group
    (N a pair), of the scores times x per head (P a pair), C . state and
    the state update per head (Q P N each). Backward: per head D = dy . x
    and dx's intra term (P a pair each), dstates, dC's inter term, dB's
    state term and dx's state term (Q P N each); per group dcb times B
    and times C (N a pair each)."""
    B, S, H, P = x_shape
    Q, nc, _ = geometry(S, chunk)
    pairs = Q * (Q + 1) // 2
    if backward:
        macs = H * (4 * Q * P * N + 2 * P * pairs) + G * 2 * N * pairs
    else:
        macs = G * N * pairs + H * P * pairs + 2 * H * Q * N * P
    return 2 * macs * B * nc


def geometry(S: int, chunk: int):
    """(Q, nc, QP): the chunk length min(chunk, S), the number of chunks
    and Q rounded up to ``TILE``, the scratch's per-chunk length."""
    Q = min(chunk, S)
    return Q, -(-S // Q), -(-Q // TILE) * TILE


def _chunked(t, Q: int, nc: int, QP: int):
    """(B, S, ...) -> (B, nc, QP, ...): chunks of Q positions, the last
    padded with zeros, each padded with zeros to QP."""
    B, S = t.shape[:2]
    t = F.pad(t, (0, 0) * (t.ndim - 2) + (0, nc * Q - S))
    t = t.reshape(B, nc, Q, *t.shape[2:])
    return F.pad(t, (0, 0) * (t.ndim - 3) + (0, QP - Q))


# ``passes`` values of the bfloat16 library's arithmetic: the bfloat16
# parts a float32 operand is split into
BF16_PASSES = {"bf16x1": 1, "bf16x2": 2}


def bf16_products(a, b, parts: int, eq: str):
    """float64 sum of the bf16 products of ``a`` and ``b`` (float32), each
    split into ``parts`` bfloat16 parts (2: hi + lo, ``bf16_split``; 1: hi
    alone), every pair of parts multiplied exactly. An operand that holds
    bfloat16 values is its own hi (its lo is 0), so the products of a
    bfloat16 operand and a float32 one are the bfloat16 kernel's two."""
    def split(t):
        hi, lo = bf16_split(t)
        return (hi,) if parts == 1 else (hi, lo)
    out = 0
    for pa in split(a):
        for pb in split(b):
            out = out + torch.einsum(eq, pa.double(), pb.double())
    return out


def _prod(eq: str, a, b, passes):
    """einsum ``eq`` of a and b; with ``passes`` (1 or 3) the float64 sum
    of the TF32 products of their float32 values, as the float32
    kernels' tensor cores form it (3xTF32, or big*big alone); with
    "bf16x2" or "bf16x1" (``BF16_PASSES``) that of their bf16 products,
    as the bfloat16 kernels form them (``bf16_products``)."""
    if passes is None:
        return torch.einsum(eq, a, b)
    if passes in BF16_PASSES:
        return bf16_products(a.float(), b.float(), BF16_PASSES[passes], eq)
    return tf32_products(a.float(), b.float(), passes, eq)


def cumsum_ref(dt, A, *, chunk: int = 256):
    """Pass 1: dts and cum (B,H,nc,QP), dt and its inclusive cumsum of
    dt * A within each chunk; zeros of dt (a flat cum) past the chunk."""
    Q, nc, QP = geometry(dt.shape[1], chunk)
    d = _chunked(dt, Q, nc, QP).permute(0, 3, 1, 2).contiguous()
    return d, torch.cumsum(d * A.to(d.dtype)[None, :, None, None], -1)


def bmm_ref(Bm, Cm, *, chunk: int = 256, passes: Optional[int] = None):
    """Pass 2: cb (B,nc,G,QP,QP), C_t . B_s within each chunk and group
    (the kernel writes the 64 x 64 tiles on and below the diagonal)."""
    Q, nc, QP = geometry(Bm.shape[1], chunk)
    return _prod("bctgn,bcsgn->bcgts", _chunked(Cm, Q, nc, QP),
                 _chunked(Bm, Q, nc, QP), passes)


def chunk_state_ref(x, Bm, dts, cum, *, chunk: int = 256,
                    passes: Optional[int] = None):
    """Pass 3: upd (B,H,nc,P,N), each chunk's contribution to the state,
    sum_s x_s exp(total - cum_s) dt_s (x) B_s."""
    H, G = x.shape[2], Bm.shape[2]
    Q, nc, QP = geometry(x.shape[1], chunk)
    w = torch.exp(cum[..., -1:] - cum) * dts                  # (B,H,nc,QP)
    xw = _chunked(x, Q, nc, QP) * w.permute(0, 2, 3, 1)[..., None]
    Bh = _chunked(Bm, Q, nc, QP).repeat_interleave(H // G, dim=3)
    return _prod("bcshp,bcshn->bhcpn", xw, Bh, passes)


def state_passing_ref(upd, cum, init_state=None):
    """Pass 4: (s_in, final). s_in (B,H,nc,P,N) is the state entering
    each chunk, S_in[0] = init_state or 0, S_in[c+1] = exp(total_c)
    S_in[c] + upd_c; final is the state after the last chunk."""
    s = (torch.zeros_like(upd[:, :, 0]) if init_state is None
         else init_state.to(upd.dtype))
    decay = torch.exp(cum[..., -1])                           # (B,H,nc)
    s_in = []
    for c in range(upd.shape[2]):
        s_in.append(s)
        s = decay[:, :, c, None, None] * s + upd[:, :, c]
    return torch.stack(s_in, 2), s


def chunk_scan_ref(x, Cm, dts, cum, cb, s_in, *, chunk: int = 256,
                   passes: Optional[int] = None):
    """Pass 5: y (B,S,H,P) = exp(cum_t) C_t . S_in + sum_{s<=t} cb[t,s]
    exp(cum_t - cum_s) dt_s x_s, the weights masked before the exp (and
    cb above the diagonal, which the kernel leaves unwritten, never
    read)."""
    B, S, H, P = x.shape
    G = Cm.shape[2]
    Q, nc, QP = geometry(S, chunk)
    Ch = _chunked(Cm, Q, nc, QP).repeat_interleave(H // G, dim=3)
    inter = _prod("bcthn,bhcpn->bhctp", Ch, s_in, passes) \
        * torch.exp(cum)[..., None]
    mask = torch.tril(torch.ones((QP, QP), dtype=torch.bool,
                                 device=x.device))
    seg = torch.where(mask, cum[..., :, None] - cum[..., None, :], 0.0)
    cbh = cb.repeat_interleave(H // G, dim=2).transpose(1, 2)
    w = torch.where(mask, cbh * (torch.exp(seg) * dts[..., None, :]), 0.0)
    y = inter + _prod("bhcts,bcshp->bhctp", w, _chunked(x, Q, nc, QP),
                      passes)
    y = y[:, :, :, :Q].permute(0, 2, 3, 1, 4).reshape(B, nc * Q, H, P)
    return y[:, :S]


def ssd_scan_passes(x, dt, A, Bm, Cm, *, chunk: int = 256, init_state=None,
                    passes: Optional[int] = None):
    """The five passes' plain versions composed: ``ssd_scan_ref``'s
    function in the kernels' order of work. Returns (y, final state)."""
    dts, cum = cumsum_ref(dt, A, chunk=chunk)
    cb = bmm_ref(Bm, Cm, chunk=chunk, passes=passes)
    upd = chunk_state_ref(x, Bm, dts, cum, chunk=chunk, passes=passes)
    s_in, final = state_passing_ref(upd, cum, init_state)
    y = chunk_scan_ref(x, Cm, dts, cum, cb, s_in, chunk=chunk,
                       passes=passes)
    return y, final


def _unchunk(t, S: int, Q: int):
    """(B, nc, QP, ...) -> (B, S, ...): the inverse of ``_chunked``."""
    B, nc = t.shape[:2]
    return t[:, :, :Q].reshape(B, nc * Q, *t.shape[3:])[:, :S]


def _heads(t, R: int, Q: int, nc: int, QP: int):
    """(B, S, G, N) -> (B, H, nc, QP, N): chunked, each group's rows
    repeated for its R heads."""
    c = _chunked(t, Q, nc, QP).repeat_interleave(R, dim=3)
    return c.permute(0, 3, 1, 2, 4)


def _group_sum(t, G: int):
    """(B, H, nc, QP, N) -> (B, nc, QP, G, N): the sum over the R heads of
    each group, in head order."""
    B, H, nc, QP, N = t.shape
    return t.reshape(B, G, H // G, nc, QP, N).sum(2).permute(0, 2, 3, 1, 4)


def chunk_scan_bwd_ref(x, Cm, dts, cum, cb, s_in, dy, *, chunk: int = 256,
                       passes: Optional[int] = None, mag: bool = False):
    """The gradient of pass 5 (``chunk_scan_ref``) at dy: (dx (B,S,H,P),
    dCm (B,S,G,N) through the inter term, ddts and dcum (B,H,nc,QP), dcb
    (B,nc,G,QP,QP), ds_in (B,H,nc,P,N): the per-chunk dstates,
    sum_t exp(cum_t) dy_t (x) C_t). With the weights W = cb L dt_s, L =
    exp(cum_t - cum_s) masked before the exp, and D = dy_t . x_s: dx_s =
    sum_t W dy_t; dcb = sum over the group's heads of L dt_s D; ddts_s =
    sum_t cb L D; dcum_t = sum_{s<t} M - sum_{s>t} M^T (M = W D, the
    diagonal cancelling) plus I_t = dy_t . exp(cum_t) S_in C_t, the inter
    term. ``mag``: the same with the difference taken as a sum (the
    bound's sums of magnitudes)."""
    B, S, H, P = x.shape
    G = Cm.shape[2]
    Q, nc, QP = geometry(S, chunk)
    xc = _chunked(x, Q, nc, QP).permute(0, 3, 1, 2, 4)     # (B,H,nc,QP,P)
    dyc = _chunked(dy, Q, nc, QP).permute(0, 3, 1, 2, 4)
    Ch = _heads(Cm, H // G, Q, nc, QP)                      # (B,H,nc,QP,N)
    E = torch.exp(cum)[..., None]
    ds_in = _prod("bhctp,bhctn->bhcpn", dyc * E, Ch, passes)
    dch = _prod("bhctp,bhcpn->bhctn", dyc, s_in, passes) * E
    inter = (dch * Ch).sum(-1)                              # I_t
    mask = torch.tril(torch.ones((QP, QP), dtype=torch.bool,
                                 device=x.device))
    seg = torch.where(mask, cum[..., :, None] - cum[..., None, :], 0.0)
    L = torch.where(mask, torch.exp(seg), 0.0)              # (B,H,nc,t,s)
    cbh = cb.repeat_interleave(H // G, dim=2).transpose(1, 2)
    D = _prod("bhctp,bhcsp->bhcts", dyc, xc, passes)
    Z = torch.where(mask, cbh * L * D, 0.0)
    ddts = Z.sum(-2)
    M = torch.where(torch.tril(mask, -1), Z * dts[..., None, :], 0.0)
    dcum = (M.sum(-1) + M.sum(-2) if mag else M.sum(-1) - M.sum(-2)) + inter
    W = torch.where(mask, cbh * L * dts[..., None, :], 0.0)
    dxc = _prod("bhcts,bhctp->bhcsp", W, dyc, passes)
    dcbh = L * dts[..., None, :] * D
    dcb = dcbh.reshape(B, G, H // G, nc, QP, QP).sum(2).transpose(1, 2)
    dx = _unchunk(dxc.permute(0, 2, 3, 1, 4), S, Q)
    return (dx, _unchunk(_group_sum(dch, G), S, Q), ddts, dcum, dcb, ds_in)


def state_passing_bwd_ref(s_in, cum, dfinal, ds_in):
    """The gradient of pass 4 (``state_passing_ref``) given its output
    s_in, at ds_in (the chunks' dstates) and dfinal (d(final state), or
    None): (dupd (B,H,nc,P,N), dcum (B,H,nc,QP), dinit (B,H,P,N)). With
    G_c the gradient of the state leaving chunk c (G_{nc-1} = dfinal,
    G_{c-1} = exp(total_c) G_c + ds_in[c]): dupd_c = G_c, dcum at the
    chunk's last slot exp(total_c) <G_c, S_in[c]>, dinit = G_{-1}."""
    decay = torch.exp(cum[..., -1])                          # (B,H,nc)
    g = (torch.zeros_like(s_in[:, :, 0]) if dfinal is None
         else dfinal.to(s_in.dtype))
    dupd = torch.empty_like(s_in)
    dcum = torch.zeros_like(cum)
    for c in reversed(range(s_in.shape[2])):
        dupd[:, :, c] = g
        dcum[:, :, c, -1] = decay[:, :, c] * (g * s_in[:, :, c]).sum((-2, -1))
        g = decay[:, :, c, None, None] * g + ds_in[:, :, c]
    return dupd, dcum, g


def chunk_state_bwd_ref(x, Bm, dts, cum, dupd, *, chunk: int = 256,
                        passes: Optional[int] = None, mag: bool = False):
    """The gradient of pass 3 (``chunk_state_ref``) at dupd: (dx
    (B,S,H,P), dBm (B,S,G,N), ddts and dcum (B,H,nc,QP)). With w_s =
    exp(total - cum_s) dt_s and K_s = w_s x_s . (dupd B_s): dx_s = w_s
    dupd B_s, dB_s = sum over the group's heads of w_s dupd^T x_s, ddts_s
    = K_s / dt_s (formed without the division), dcum_s = -K_s and, at the
    chunk's last slot (total), + sum_s K_s. ``mag``: -K_s taken as +K_s."""
    B, S, H, P = x.shape
    G = Bm.shape[2]
    Q, nc, QP = geometry(S, chunk)
    decay = torch.exp(cum[..., -1:] - cum)
    w = (decay * dts)[..., None]
    xc = _chunked(x, Q, nc, QP).permute(0, 3, 1, 2, 4)     # (B,H,nc,QP,P)
    Bh = _heads(Bm, H // G, Q, nc, QP)
    xg = _prod("bhcsn,bhcpn->bhcsp", Bh, dupd, passes)      # dupd B_s
    bg = _prod("bhcsp,bhcpn->bhcsn", xc, dupd, passes)      # dupd^T x_s
    gw = (xg * xc).sum(-1)
    K = gw * w[..., 0]
    dcum = K if mag else -K
    dcum[..., -1] += K.sum(-1)
    dx = _unchunk((w * xg).permute(0, 2, 3, 1, 4), S, Q)
    return dx, _unchunk(_group_sum(w * bg, G), S, Q), gw * decay, dcum


def bmm_bwd_ref(Bm, Cm, dcb, *, chunk: int = 256,
                passes: Optional[int] = None):
    """The gradient of pass 2 (``bmm_ref``) at dcb: (dBm, dCm) (B,S,G,N),
    dC_t = sum_s dcb[t,s] B_s and dB_s = sum_t dcb[t,s] C_t."""
    S = Bm.shape[1]
    Q, nc, QP = geometry(S, chunk)
    Bc, Cc = _chunked(Bm, Q, nc, QP), _chunked(Cm, Q, nc, QP)
    dC = _prod("bcgts,bcsgn->bctgn", dcb, Bc, passes)
    dB = _prod("bcgts,bctgn->bcsgn", dcb, Cc, passes)
    return _unchunk(dB, S, Q), _unchunk(dC, S, Q)


def cumsum_bwd_ref(ddts, dcum, dt, A, *, chunk: int = 256,
                   mag: bool = False):
    """The gradient of pass 1 (``cumsum_ref``) at (ddts, dcum): (ddt
    (B,S,H), dA (H,)). dla = the reverse cumsum of dcum within each chunk
    (cum_t = sum_{u<=t} dt_u A), ddt = ddts + A dla, dA = sum over (b, s)
    of dt dla. ``mag``: |A| for A."""
    S = dt.shape[1]
    Q, nc, QP = geometry(S, chunk)
    d = _chunked(dt, Q, nc, QP).permute(0, 3, 1, 2).to(dcum.dtype)
    dla = torch.flip(torch.cumsum(torch.flip(dcum, [-1]), -1), [-1])
    a = (A.abs() if mag else A).to(dcum.dtype)[None, :, None, None]
    ddt = _unchunk((ddts + a * dla).permute(0, 2, 3, 1), S, Q)
    return ddt, (d * dla).sum((0, 2, 3))


def ssd_scan_bwd_ref(x, dt, A, Bm, Cm, dy, dstate=None, *, chunk: int = 256,
                     init_state=None, passes: Optional[int] = None,
                     mag: bool = False):
    """The plain backward: the gradient of ``ssd_scan_ref`` at (dy,
    dstate), dstate = d(final state) or None. The forward's passes
    (their plain versions) recomputed for cum, cb and S_in, then the
    five passes reversed: ``chunk_scan_bwd_ref`` (dx, dC, dcb, dW's
    share of dcum, the per-chunk dstates), ``state_passing_bwd_ref``
    (the states' gradients across chunks, d(init_state)),
    ``chunk_state_bwd_ref``, ``bmm_bwd_ref`` and ``cumsum_bwd_ref`` (ddt,
    dA). Computes in float32 (float64 for float64 inputs); returns (dx,
    ddt, dA, dBm, dCm, dinit) in the dtypes of x, dt, A, Bm, Cm and
    init_state (dinit None without one). ``passes``: every product as
    ``_prod`` forms it (the TF32 model); ``mag``: the sums of magnitudes
    (on |x|, |Bm|, |Cm|, |dy|, |dstate|, |init_state|, the real dt and A),
    which ``bwd_error_bound`` scales."""
    ct = torch.promote_types(x.dtype, torch.float32)
    xf, dtf, Af, Bf, Cf, dyf = (t.to(ct) for t in (x, dt, A, Bm, Cm, dy))
    init = None if init_state is None else init_state.to(ct)
    dts, cum = cumsum_ref(dtf, Af, chunk=chunk)
    cb = bmm_ref(Bf, Cf, chunk=chunk, passes=passes)
    upd = chunk_state_ref(xf, Bf, dts, cum, chunk=chunk, passes=passes)
    s_in, _ = state_passing_ref(upd, cum, init)
    dx1, dC1, ddts1, dcum1, dcb, ds_in = chunk_scan_bwd_ref(
        xf, Cf, dts, cum, cb, s_in, dyf, chunk=chunk, passes=passes, mag=mag)
    dupd, dcum2, dinit = state_passing_bwd_ref(
        s_in, cum, None if dstate is None else dstate.to(ct), ds_in)
    dx2, dB2, ddts2, dcum3 = chunk_state_bwd_ref(
        xf, Bf, dts, cum, dupd, chunk=chunk, passes=passes, mag=mag)
    dB3, dC3 = bmm_bwd_ref(Bf, Cf, dcb, chunk=chunk, passes=passes)
    ddt, dA = cumsum_bwd_ref(ddts1 + ddts2, dcum1 + dcum2 + dcum3, dtf, Af,
                             chunk=chunk, mag=mag)
    return ((dx1 + dx2).to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype),
            (dB2 + dB3).to(Bm.dtype), (dC1 + dC3).to(Cm.dtype),
            None if init_state is None else dinit.to(init_state.dtype))


def ssd_scan_tf32(x, dt, A, Bm, Cm, *, chunk: int = 256, init_state=None,
                  passes: int = 3):
    """A float64 model of the kernels' arithmetic: the passes in float64,
    every operand of the four products (C.B^T, the decayed x times B, C
    times S_in, the weights times x) rounded to float32 and split into
    TF32 parts, the ``passes`` TF32 products of each (3: 3xTF32, the
    kernels; 1: plain TF32) summed exactly. It leaves out the float32
    roundings of the sums, which ``error_bound`` counts separately.
    Returns (y (B,S,H,P), final state (B,H,P,N)) in float64."""
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, not {passes}")
    return ssd_scan_passes(
        *(t.double() for t in (x, dt, A, Bm, Cm)), chunk=chunk,
        init_state=None if init_state is None else init_state.double(),
        passes=passes)


def ssd_scan_bf16(x, dt, A, Bm, Cm, *, chunk: int = 256, init_state=None,
                  parts: int = 2):
    """A float64 model of the bfloat16 kernels' arithmetic on bfloat16 x,
    Bm and Cm (float32 ones holding bfloat16 values): the passes in
    float64; C.B^T from the values exactly (a product of two bfloat16
    numbers is exact in float32); each float32 operand of the other
    three products (the decayed x of the chunk states, S_in of the inter
    term, the weights W of the intra term) rounded to float32 and split
    into ``parts`` bfloat16 parts (2: hi + lo, the kernels; 1: hi alone,
    one bf16 product), the products with the bfloat16 operand summed
    exactly. It leaves out the float32 roundings of the sums, which
    ``error_bound`` counts separately. Returns (y (B,S,H,P), final state
    (B,H,P,N)) in float64."""
    if parts not in (1, 2):
        raise ValueError(f"parts must be 1 or 2, not {parts}")
    return ssd_scan_passes(
        *(t.double() for t in (x, dt, A, Bm, Cm)), chunk=chunk,
        init_state=None if init_state is None else init_state.double(),
        passes=f"bf16x{parts}")


def ssd_scan_bwd_bf16(x, dt, A, Bm, Cm, dy, dstate=None, *,
                      chunk: int = 256, init_state=None, parts: int = 2):
    """A float64 model of the bfloat16 backward kernels' arithmetic on
    bfloat16 x, Bm, Cm and dy (float32 ones holding bfloat16 values), the
    forward's scratch from the bfloat16 forward's model (``ssd_scan_bf16``'s
    products): the passes in float64; D = dy . x^T from the values exactly
    (a product of two bfloat16 numbers is exact in float32); each float32
    operand of every other product (exp(cum) dy of the dstates, S_in and
    G_c of the head terms, G_c of dx's state term, the weights W of its
    intra term, dcb of dB's and dC's intra terms) rounded to float32 and
    split into ``parts`` bfloat16 parts (2: hi + lo, the kernels; 1: hi
    alone), the products with the bfloat16 operand summed exactly. It
    leaves out the float32 roundings of the sums, which
    ``bwd_error_bound`` counts separately. Returns (dx, ddt, dA, dBm, dCm,
    dinit) in float64 (dinit None without ``init_state``)."""
    if parts not in (1, 2):
        raise ValueError(f"parts must be 1 or 2, not {parts}")

    def d64(t):
        return None if t is None else t.double()
    return ssd_scan_bwd_ref(*map(d64, (x, dt, A, Bm, Cm, dy, dstate)),
                            chunk=chunk, init_state=d64(init_state),
                            passes=f"bf16x{parts}")


def error_bound(x, dt, A, Bm, Cm, *, chunk: int = 256, init_state=None,
                ref_y=None):
    """The kernels' error against the exact scan, as (bound on y, bound
    on the final state): for float32 x, that of the 3xTF32 kernels, for
    bfloat16 x (pass the bfloat16 tensors: the bound and the plain
    version compute on their widened values) that of the bfloat16
    kernels. u * L * M with u = 2^-24, M the largest sum of magnitudes
    of the products that make up one output (the plain version in
    float64 on |x|, |Bm|, |Cm| and |init_state|: every decay weight and
    dt is positive) and L = N + 3 S' + 32 Lambda + 16 + 2 E / u, E =
    PRODUCT_ERR for float32 x, P_SPLIT_ERR for bfloat16 x.

    Derivation. A float32 sum of n terms is off by at most n u times its
    sum of magnitudes: C.B and C.S_in are sums of N terms, y and the
    state add up at most Q + S' + 2 S'/Q terms along their longest chain
    (S' the padded length; the passes sum a chunk's positions, then the
    chunks in order, then the inter and intra parts). Each decay weight
    exp(cum_t - cum_s) is off by the error of its exponent, at most
    27 u Lambda (each cumsum carries at most 13 roundings of partial
    sums no larger than Lambda, the largest sum of |dt * A| over one
    chunk), plus the exp's own and the few roundings of each product and
    weight (the 16; below the diagonal the kernels take the weight as
    exp(cum_t - ref) exp(ref - cum_s), ref between the two, whose
    exponents' errors add up to the same and which adds one exp's own
    and one product's rounding). 3xTF32: a product of float32 operands
    a and b drops the small*small term and the residuals of the two
    splits, at most
    PRODUCT_ERR = 3 * 2^-22 of |a||b| (12 u); every term of y or of the
    state passes through at most two such products in a row (C.B^T then
    the weights times x; the decayed x times B then C times S_in), so
    3xTF32 adds at most 2 PRODUCT_ERR times the term's magnitude, 24 u
    on M. A plain TF32 product (big*big, about 2^-10 of |a||b|) breaks
    this bound (``tests/test_torch_ssd.py``).

    The bfloat16 kernels (their own terms, the same steps). C.B^T's
    products are exact (two bfloat16 numbers), so it adds no product
    term. The other three products have one bfloat16 operand, exact, and
    one float32 operand split into hi + lo with |v - hi - lo| <=
    P_SPLIT_ERR |v| = 2^-16 |v| (``bf16_split``; below 2^-118 an absolute
    2^-133 more, as for K3, far below u L M at the sizes the models and
    the tests reach), multiplied
    exactly: each such product is off by at most P_SPLIT_ERR of its
    terms' |a||b|. A term of y passes through two in a row (the decayed
    x times B, then C times S_in; or C.B^T, exact, then the weights times
    x), a term of the state through one, so 2 P_SPLIT_ERR / u = 512
    takes the place of 2 PRODUCT_ERR / u = 24 in L (under 8% of L at
    mamba2-370m's prefill, where 3 S' = 6,144). One bfloat16 part (2^-8
    of each split value) breaks it (``tests/test_torch_ssd_bf16.py``).

    bfloat16 y. For a bfloat16 x the kernels round y to bfloat16, off by
    at most half an ulp, BF16_ROUND times its magnitude. With ``ref_y``,
    the exact y (the plain version in float64), the bound on y against
    it adds BF16_ROUND (|ref_y| + the float32 bound) per element, and is
    then a tensor of y's shape; the final state stays float32."""
    B, S, H, P = x.shape
    N = Bm.shape[3]
    Q = min(chunk, S)
    nc = -(-S // Q)
    la = F.pad((dt.double() * A.double()[None, None, :]).abs(),
               (0, 0, 0, nc * Q - S))
    lam = float(la.reshape(B, nc, Q, H).sum(2).max())
    mag_y, mag_state = ssd_scan_ref(
        x.double().abs(), dt.double(), A.double(), Bm.double().abs(),
        Cm.double().abs(), chunk=chunk,
        init_state=None if init_state is None else init_state.double().abs())
    u = 2.0 ** -24
    err = P_SPLIT_ERR if x.dtype == torch.bfloat16 else PRODUCT_ERR
    L = N + 3 * nc * Q + 32 * lam + 16 + 2 * err / u
    bound_y = u * L * float(mag_y.max())
    if ref_y is not None:
        bound_y = bound_y + BF16_ROUND * (ref_y.double().abs() + bound_y)
    return bound_y, u * L * float(mag_state.max())


def bwd_error_bound(x, dt, A, Bm, Cm, dy, dstate=None, *, chunk: int = 256,
                    init_state=None, refs=None):
    """Bounds on |backward kernel - exact gradient| for (dx, ddt, dA, dBm,
    dCm, dinit) (dinit None without ``init_state``), per element and in
    their shapes, float64; inputs in the kernel's dtypes (bfloat16 ones
    widened: the kernel widens them exactly). u * L * M, with u = 2^-24,
    M the sums of magnitudes of each gradient's terms
    (``ssd_scan_bwd_ref`` in float64 with ``mag``: |x|, |Bm|, |Cm|, |dy|,
    |dstate|, |init_state|, the real dt and A for the decays, |A| as a
    factor, each difference of dcum taken as a sum) and

        L = 2N + P + R + 3 S' + 2 QP + 72 Lambda + nc (13 Lambda + 6)
            + 104 + ceil(P N / 1024) + 2 PRODUCT_ERR / u,

    plus B nc + QP for dA (S' = nc Q, R = H / G, Lambda the largest sum
    of |dt * A| over one chunk, as ``error_bound``'s); for bfloat16 x the
    last term is 2 P_SPLIT_ERR / u + 2 (P_SPLIT_ERR - PRODUCT_ERR) / u
    instead (the bfloat16 library's products, below).

    Derivation, terms in units of u on a term's magnitude, every sum in
    float32 in any order (n - 1 roundings for n terms). The forward's
    scratch: cum within 13 Lambda (``error_bound``), so each decay
    exp(cum_t - cum_s) or exp(total - cum_s) within 26 Lambda + 4 (expf's
    2 ulp) + 1, exp(cum_t) and exp(total) within 13 Lambda + 5; cb within
    N + 14 (one 3xTF32 product, ``pass_errors``); S_in within the forward
    state's N + 3 S' + 32 Lambda + 40. The backward's sums: the dstates,
    Q-term sums (QP); the states' gradients G_c, one fma and one
    exp(total_c) a chunk, nc (13 Lambda + 6); dx, its intra sum over t
    (QP) and its state term over n (N); D over p (P) and dcb over the R
    heads (within a slice, then the slices in order); dB and dC their
    intra sums over QP terms and their per-head terms over P and R (the
    same way); dcum's row and column sums (QP each), I and K (N and P
    terms; I over 64 of N, then the halves), <G_c, S_in> (4-term runs,
    a warp's and a block's trees and ceil(P N / 1024) slices in order),
    and its reverse cumsum (QP). The longest chain of these is bounded
    by L: the forward's S_in into I and dC (N + 3 S' + 32 Lambda + 40,
    then P + N + R + 13 Lambda + 5 + 2 QP for the dcum sums and the
    cumsum), or the state term's chain (QP + 13 Lambda + 5, nc (13
    Lambda + 6), N + 26 Lambda + 5, R + P), with slack for the few
    products and adds that join the parts (dcb's decay below the
    diagonal is taken as exp(cum_t - ref) exp(ref - cum_s), ref between
    the two: its exponents' errors add up to the same, plus one more
    expf and one more product's rounding). dA adds its sum over the B
    nc chunks and, within one, its QP terms.

    The products, 3xTF32 in both directions: every product of the
    forward (cb, the chunk states) and of the backward (D, dstates, dx's
    two terms, dC's and dB's per-head and intra terms) drops at most
    PRODUCT_ERR = 3 * 2^-22 (12 u) of each term's |a||b|: the small*small
    term and the residuals of the two splits. Each gradient's terms pass
    through at most two products in a row: cb -> W -> W^T dy (dx's intra
    term) and cb . D into M (dcum); D -> dcb -> dcb . B and dcb^T . C (dC,
    dB); dstates -> G_c -> B G_c^T (dx's state term, K) and x . G_c (dB),
    and G_c . S_in (the last slot's dcum); x . B (S_in) -> dy . S_in
    (dC's inter term, I). A product whose input a term already carries
    e relative error adds e more, so 2 PRODUCT_ERR bounds each term's
    share, 2 PRODUCT_ERR / u = 24 in L. ``ssd_scan_bwd_ref(...,
    passes=3)`` models these products in float64 and lies within this
    bound; ``passes=1`` (one TF32 product, about 2^-10 of |a||b|) breaks
    it (``tests/test_torch_ssd_grad.py``).

    The bfloat16 library (``csrc/ssd_scan_bwd_bf16.cu``), its own terms
    in the same steps. Its products: D = dy . x^T has two bfloat16
    operands and is exact, so the chains through D (D -> dcb, cb . D
    into M) carry no product term. Every other product has one bfloat16
    operand, exact, and one float32 operand split into hi + lo with
    |v - hi - lo| <= P_SPLIT_ERR |v| = 2^-16 |v| (``bf16_split``; below
    2^-118 an absolute 2^-133 more, far below u L M at the sizes the
    models and the tests reach), multiplied exactly: each such product
    is off by at most P_SPLIT_ERR of its terms' |a||b|. On the chains
    above at most two of them follow each other: exp(cum) dy (split) ->
    dstates -> G_c (split) -> B G_c^T (dx's state term, K) and x . G_c
    (dB); D -> dcb (split) -> dcb . B and dcb^T . C (one); cb -> W
    (split) -> W^T dy (one); dy . S_in (S_in split: one, after the
    forward's); G_c . S_in (the last slot's dcum, elementwise, after one
    each). So 2 P_SPLIT_ERR / u = 512 takes the place of 2 PRODUCT_ERR /
    u = 24. The forward's scratch comes from the bfloat16 forward: cb
    exact, S_in within the forward state's bfloat16 bound, whose L is 2
    (P_SPLIT_ERR - PRODUCT_ERR) / u = 488 above the float32 one
    (``error_bound``); S_in enters each chain it starts additively, so L
    grows by the same 488, 976 above the float32 library's in all (under
    9% of L at mamba2-370m's training shape). ``ssd_scan_bwd_bf16``
    (parts=2) models these products in float64 and lies within this
    bound; one bfloat16 part (2^-8 of each split value) breaks it
    (``tests/test_torch_ssd_bwd_bf16.py``).

    bfloat16 outputs (dx, dB, dC for bfloat16 x; ddt for bfloat16 dt;
    dinit for a bfloat16 state in): the rounding to bfloat16, BF16_ROUND
    (|exact| + the float32 bound); the exact gradients are ``refs``
    (``ssd_scan_bwd_ref`` in float64 on the widened inputs), or computed
    here when needed."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q, nc, QP = geometry(S, chunk)
    la = F.pad((dt.double() * A.double()[None, None, :]).abs(),
               (0, 0, 0, nc * Q - S))
    lam = float(la.reshape(B, nc, Q, H).sum(2).max())

    def d64(t, mag=True):
        return None if t is None else (t.double().abs() if mag
                                       else t.double())
    mags = ssd_scan_bwd_ref(d64(x), d64(dt, False), d64(A, False), d64(Bm),
                            d64(Cm), d64(dy), d64(dstate), chunk=chunk,
                            init_state=d64(init_state), mag=True)
    u = 2.0 ** -24
    # the products' term: 3xTF32, or the split products and the bf16 S_in
    prod = (2 * P_SPLIT_ERR / u + 2 * (P_SPLIT_ERR - PRODUCT_ERR) / u
            if x.dtype == torch.bfloat16 else 2 * PRODUCT_ERR / u)
    L = (2 * N + P + H // G + 3 * nc * Q + 2 * QP + 72 * lam
         + nc * (13 * lam + 6) + 104 + -(-P * N // 1024) + prod)
    bounds = [None if m is None else u * L * m for m in mags]
    bounds[2] = u * (L + B * nc + QP) * mags[2]
    bf = [x.dtype, dt.dtype, None, x.dtype, x.dtype,
          None if init_state is None else init_state.dtype]
    if any(t == torch.bfloat16 for t in bf):
        if refs is None:
            refs = ssd_scan_bwd_ref(
                d64(x, False), d64(dt, False), d64(A, False),
                d64(Bm, False), d64(Cm, False), d64(dy, False),
                d64(dstate, False), chunk=chunk,
                init_state=d64(init_state, False))
        bounds = [bd if t != torch.bfloat16 else
                  bd + BF16_ROUND * (r.double().abs() + bd)
                  for bd, r, t in zip(bounds, refs, bf)]
    return tuple(bounds)


def bind(lib) -> Dict[str, object]:
    """The passes of a loaded ``ssd_scan`` library, typed for ctypes."""
    fns = {name: getattr(lib, name) for name in PASSES}
    for fn in fns.values():
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 10
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fns


_FNS: Dict[torch.dtype, Dict[str, object]] = {}


def _lib(dtype=torch.float32) -> Dict[str, object]:
    """The passes of the library for x of ``dtype``: ``csrc/ssd_scan.cu``
    (float32) or ``csrc/ssd_scan_bf16.cu`` (bfloat16)."""
    if dtype not in _FNS:
        from repro_torch.kernels import build
        _FNS[dtype] = bind(build.load(
            "ssd_scan_bf16" if dtype == torch.bfloat16 else "ssd_scan"))
    return _FNS[dtype]


BF16_SHAPE_KEYS = ("x_load", "bc_load", "n_halves", "bmm_smem_bytes",
                   "chunk_state_smem_bytes", "chunk_scan_smem_bytes")
BF16_LOADS = ("tma", "cp.async", "registers")


def bf16_launch_shape(x, Bm, Cm) -> dict:
    """The launch the bfloat16 kernels make for these CUDA tensors, as
    they report it (``ssd_bf16_shape``): how x lands and how B and C land
    (TMA, cp.async or registers), N's column halves and the shared memory
    bytes of a block of passes 2, 3 and 5."""
    from repro_torch.kernels import build
    fn = build.load("ssd_scan_bf16").ssd_bf16_shape
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p]
    fn.restype = None
    out = (ctypes.c_int * len(BF16_SHAPE_KEYS))()
    fn(x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), x.shape[3], Bm.shape[3],
       out)
    shape = dict(zip(BF16_SHAPE_KEYS, out))
    for k in ("x_load", "bc_load"):
        shape[k] = BF16_LOADS[shape[k]]
    return shape


def _check(x, dt, A, Bm, Cm, chunk, init_state) -> None:
    named = [("x", x, 4), ("dt", dt, 3), ("A", A, 1), ("Bm", Bm, 4),
             ("Cm", Cm, 4)]
    if init_state is not None:
        named.append(("init_state", init_state, 4))
    if x.dtype not in DTYPES:
        raise TypeError(f"the SSD kernel takes x in float32 or bfloat16, "
                        f"not {x.dtype}")
    allowed = {"x": (x.dtype,), "Bm": (x.dtype,), "Cm": (x.dtype,),
               "dt": (torch.float32, x.dtype), "A": (torch.float32,),
               "init_state": DTYPES}
    for name, t, ndim in named:
        if t.dtype not in allowed[name]:
            raise TypeError(f"the SSD kernel takes {name} in "
                            f"{' or '.join(map(str, allowed[name]))}, "
                            f"not {t.dtype}")
        if t.ndim != ndim:
            raise ValueError(f"{name} must be {ndim}-D, not "
                             f"{tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,):
        raise ValueError(f"dt {tuple(dt.shape)} and A {tuple(A.shape)} do "
                         f"not fit x {tuple(x.shape)}")
    if Bm.shape != Cm.shape or tuple(Bm.shape[:2]) != (B, S):
        raise ValueError(f"Bm {tuple(Bm.shape)} and Cm {tuple(Cm.shape)} "
                         f"do not fit x {tuple(x.shape)}")
    if init_state is not None and tuple(init_state.shape) != (B, H, P, N):
        raise ValueError(f"init_state must be {(B, H, P, N)}, not "
                         f"{tuple(init_state.shape)}")
    if G == 0 or H % G:
        raise ValueError(f"{H} heads do not group over {G} groups")
    if P > MAX_HEAD_DIM or N > MAX_STATE:
        raise ValueError(f"the SSD kernel takes head dims up to "
                         f"{MAX_HEAD_DIM} and states up to {MAX_STATE}, "
                         f"not P={P}, N={N}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"the SSD kernel takes chunks of 1 to {MAX_CHUNK} "
                         f"positions, not {chunk}")
    if S == 0:
        raise ValueError("the SSD kernel needs at least one position")
    if B > 65535:
        raise ValueError(f"the SSD kernel's grid takes up to 65535 "
                         f"batches, not {B}")


def scratch_shapes(x, Bm, chunk: int) -> Dict[str, tuple]:
    """The shapes of the passes' scratch: dts and cum (B,H,nc,QP), cb
    (B,nc,G,QP,QP) and states (B,H,nc,P,N)."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    _, nc, QP = geometry(S, chunk)
    return {"dts": (B, H, nc, QP), "cum": (B, H, nc, QP),
            "cb": (B, nc, G, QP, QP), "states": (B, H, nc, P, N)}


def scratch(x, Bm, chunk: int) -> Dict[str, torch.Tensor]:
    """The passes' scratch for one call (``scratch_shapes``), float32,
    uninitialised (``torch.empty``)."""
    return {k: torch.empty(v, dtype=torch.float32, device=x.device)
            for k, v in scratch_shapes(x, Bm, chunk).items()}


def launch(name: str, x, dt, A, Bm, Cm, init_state, y, state,
           scr: Dict[str, torch.Tensor], chunk: int) -> None:
    """Launch one pass (a name in ``PASSES``) on the current stream and
    raise on its launch error. Counts nothing (``ssd_scan`` counts).
    Refuses inputs that need a gradient (``refuse_grad``)."""
    refuse_grad("the SSD kernel (K4)", x, dt, A, Bm, Cm, init_state)
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    err = _lib(x.dtype)[name](
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), None if init_state is None else init_state.data_ptr(),
        y.data_ptr(), state.data_ptr(), scr["dts"].data_ptr(),
        scr["cum"].data_ptr(), scr["cb"].data_ptr(),
        scr["states"].data_ptr(), B, S, H, P, G, N, min(chunk, S),
        int(x.dtype == torch.bfloat16), int(dt.dtype == torch.bfloat16),
        int(init_state is not None and init_state.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        why = {-1: "a shape it does not take",
               -2: "a TMA tensor map was refused"}.get(err, f"cudaError {err}")
        raise RuntimeError(f"ssd_scan pass {name} failed: {why}")


def pass_errors(x, dt, A, Bm, Cm, *, chunk: int = 256,
                init_state=None) -> Dict[str, float]:
    """Run the passes one at a time on CUDA tensors and hold each against
    its plain version in float64 on the same inputs (the kernels' own
    outputs of the passes before it). Returns, per pass, the largest
    |kernel - plain| as a share of its bound u * L * M (u = 2^-24, M the
    plain version on magnitudes, per element): cumsum L = 16 (13
    roundings of partial sums, the products dt * A) and dts exact; bmm
    L = N + 14 (N-term sums, 3xTF32's PRODUCT_ERR = 12 u); chunk_state
    L = QP + 20 + Lambda (QP-term sums, 3xTF32, the decay's exponent off
    by u Lambda with Lambda the largest |cum|, expf and the products);
    state_passing L = 3 nc + 2 (one fma and expf per chunk); chunk_scan
    L = N + QP + 34 + Lambda (the two products' sums and 3xTF32, the
    weights' exponents, expf and their products). For bfloat16 x (the
    bfloat16 kernels): bmm L = N + 2 (exact products); chunk_state and
    chunk_scan the same with P_SPLIT_ERR / u = 256 for 3xTF32's 12 (one
    split operand in each product), and y's rounding to bfloat16,
    BF16_ROUND (|plain| + the bound), added to chunk_scan's. Only the
    lower tiles of cb that the scan reads are compared."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q, nc, QP = geometry(S, chunk)
    u = 2.0 ** -24
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    scr = scratch(x, Bm, chunk)

    def run(name):
        launch(name, x, dt, A, Bm, Cm, init_state, y, state, scr, chunk)
        torch.cuda.synchronize(x.device)

    def share(got, want, mag, L):
        return float(((got.double() - want).abs()
                      / (u * L * mag + 1e-300)).max())

    f64 = [t.double() for t in (x, dt, A, Bm, Cm)]
    bf16 = x.dtype == torch.bfloat16
    prod = P_SPLIT_ERR / u if bf16 else 12       # a product's share of L
    out = {}
    run("ssd_cumsum")
    dts, cum = scr["dts"].double(), scr["cum"].double()
    w_dts, w_cum = cumsum_ref(f64[1], f64[2], chunk=chunk)
    _, m_cum = cumsum_ref(f64[1], f64[2].abs(), chunk=chunk)
    if not torch.equal(dts, w_dts):
        raise AssertionError("ssd_cumsum: dts is not dt")
    out["ssd_cumsum"] = share(cum, w_cum, m_cum, 16)
    lam = float(cum.abs().max())

    run("ssd_bmm")
    t = torch.arange(QP, device=x.device)
    pos = torch.arange(nc, device=x.device)[:, None] * Q + t[None, :]
    live = (t[None, :] < Q) & (pos < S)                       # (nc, QP)
    read = ((t[:, None] // TILE >= t[None, :] // TILE)[None]
            & live[:, :, None])                               # (nc,QP,QP)
    cb = torch.where(read[None, :, None], scr["cb"].double(), 0.0)
    w_cb = torch.where(read[None, :, None], bmm_ref(f64[3], f64[4],
                                                    chunk=chunk), 0.0)
    m_cb = bmm_ref(f64[3].abs(), f64[4].abs(), chunk=chunk)
    out["ssd_bmm"] = share(cb, w_cb, m_cb, N + (2 if bf16 else 14))

    run("ssd_chunk_state")
    w_upd = chunk_state_ref(f64[0], f64[3], dts, cum, chunk=chunk)
    m_upd = chunk_state_ref(f64[0].abs(), f64[3].abs(), dts, cum,
                            chunk=chunk)
    out["ssd_chunk_state"] = share(scr["states"], w_upd, m_upd,
                                   QP + 8 + prod + lam)

    upd = scr["states"].double()
    init64 = None if init_state is None else init_state.double()
    run("ssd_state_passing")
    w_in, w_fin = state_passing_ref(upd, cum, init64)
    m_in, m_fin = state_passing_ref(upd.abs(), cum,
                                    None if init64 is None else init64.abs())
    out["ssd_state_passing"] = max(
        share(scr["states"], w_in, m_in, 3 * nc + 2),
        share(state, w_fin, m_fin, 3 * nc + 2))

    run("ssd_chunk_scan")
    s_in = scr["states"].double()
    w_y = chunk_scan_ref(f64[0], f64[4], dts, cum, cb, s_in, chunk=chunk)
    m_y = chunk_scan_ref(f64[0].abs(), f64[4].abs(), dts, cum, cb.abs(),
                         s_in.abs(), chunk=chunk)
    L = N + QP + 22 + prod + lam
    if bf16:                             # y rounded to bfloat16
        bound = u * L * m_y
        out["ssd_chunk_scan"] = float(((y.double() - w_y).abs() / (
            bound + BF16_ROUND * (w_y.abs() + bound) + 1e-300)).max())
    else:
        out["ssd_chunk_scan"] = share(y, w_y, m_y, L)
    return out


BWD_PASSES = ("ssd_bwd_dstates", "ssd_bwd_state_passing", "ssd_bwd_dcb",
              "ssd_bwd_dx", "ssd_bwd_heads", "ssd_bwd_sum", "ssd_bwd_dbc",
              "ssd_bwd_ddt", "ssd_bwd_dA")
# the most slices a group's heads are spread over: ssd_bwd_common.cuh's
# SSD_BWD_HSMAX, which sizes the partial sums' scratch here
BWD_HEAD_SLICES = 4
BWD_LAUNCHES = 0
BF16_BWD_LAUNCHES = 0   # of BWD_LAUNCHES, those through ssd_scan_bwd_bf16.cu
_BWD_FNS: Dict[torch.dtype, Dict[str, object]] = {}


def bind_bwd(lib) -> Dict[str, object]:
    """The passes of a loaded ``ssd_scan_bwd`` library, typed for
    ctypes."""
    fns = {name: getattr(lib, name) for name in BWD_PASSES}
    for fn in fns.values():
        fn.argtypes = ([ctypes.c_void_p] * 27 + [ctypes.c_int] * 10
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fns


def _bwd_lib(dtype=torch.float32) -> Dict[str, object]:
    """The passes of the backward library for x of ``dtype``:
    ``csrc/ssd_scan_bwd.cu`` (float32) or ``csrc/ssd_scan_bwd_bf16.cu``
    (bfloat16)."""
    if dtype not in _BWD_FNS:
        from repro_torch.kernels import build
        _BWD_FNS[dtype] = bind_bwd(build.load(
            "ssd_scan_bwd_bf16" if dtype == torch.bfloat16
            else "ssd_scan_bwd"))
    return _BWD_FNS[dtype]


BWD_BF16_SHAPE_KEYS = ("x_load", "bc_load", "n_halves", "dstates_smem_bytes",
                       "dcb_smem_bytes", "dx_smem_bytes", "heads_smem_bytes",
                       "dbc_smem_bytes")


def bwd_bf16_launch_shape(x, dy, Bm, Cm) -> dict:
    """The launch the bfloat16 backward kernels make for these CUDA
    tensors, as they report it (``ssd_bwd_bf16_shape``): how x and dy land
    and how B and C land (TMA, cp.async or registers), N's column halves
    and the shared memory bytes of a block of passes 1, 3, 4, 5 and 7."""
    from repro_torch.kernels import build
    fn = build.load("ssd_scan_bwd_bf16").ssd_bwd_bf16_shape
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p]
    fn.restype = None
    out = (ctypes.c_int * len(BWD_BF16_SHAPE_KEYS))()
    fn(x.data_ptr(), dy.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), x.shape[3],
       Bm.shape[3], out)
    shape = dict(zip(BWD_BF16_SHAPE_KEYS, out))
    for k in ("x_load", "bc_load"):
        shape[k] = BF16_LOADS[shape[k]]
    return shape


def bwd_scratch(x, Bm, chunk: int) -> Dict[str, torch.Tensor]:
    """The backward passes' scratch, uninitialised, float32: dst
    (B,H,nc,P,N); dcbp (HS,B,nc,G,QP,QP), dcb's partial sum over each of
    HS = min(H/G, ``BWD_HEAD_SLICES``) slices of a group's heads; rs and
    cs (B,H,nc,QP/64,QP); pI (NH,B,H,nc,QP), I_t by 64 of N (NH =
    ceil(N/64)); pK and pD (B,H,nc,QP); pbc (2,HS,B,nc,QP,G,N), dC's and
    dB's per-head terms summed over each slice; ep
    (B,H,nc,ceil(P*N/1024)) and dap (B,H,nc). At mamba2-370m's training
    shape (B=4, S=2,048, H=32, G=1, N=128, HS=4) dcbp and pbc take 34 MB
    each."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    _, nc, QP = geometry(S, chunk)
    HS = min(H // G, BWD_HEAD_SLICES)
    kw = dict(dtype=torch.float32, device=x.device)
    pos = torch.empty((2, B, H, nc, QP), **kw)
    return {"dst": torch.empty((B, H, nc, P, N), **kw),
            "dcbp": torch.empty((HS, B, nc, G, QP, QP), **kw),
            "rs": torch.empty((B, H, nc, QP // TILE, QP), **kw),
            "cs": torch.empty((B, H, nc, QP // TILE, QP), **kw),
            "pI": torch.empty((-(-N // TILE), B, H, nc, QP), **kw),
            "pK": pos[0], "pD": pos[1],
            "pbc": torch.empty((2, HS, B, nc, QP, G, N), **kw),
            "ep": torch.empty((B, H, nc, -(-P * N // 1024)), **kw),
            "dap": torch.empty((B, H, nc), **kw)}


def launch_bwd(name: str, x, dt, A, Bm, Cm, dy, dstate, scr, grads, work,
               chunk: int) -> None:
    """Launch one backward pass (a name in ``BWD_PASSES``) on the current
    stream and raise on its launch error: the forward's operands and
    scratch ``scr`` (after its five passes), dy and dstate (or None), the
    gradients ``grads`` (dx, ddt, dA, dBm, dCm, dinit or None) and the
    backward's scratch ``work`` (``bwd_scratch``). Counts nothing."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]

    def ptr(t):
        return None if t is None else t.data_ptr()
    err = _bwd_lib(x.dtype)[name](
        *(ptr(t) for t in (x, dt, A, Bm, Cm, dy, dstate, scr["dts"],
                           scr["cum"], scr["cb"], scr["states"], *grads)),
        *(work[k].data_ptr() for k in ("dst", "dcbp", "rs", "cs", "pI", "pK",
                                       "pD", "pbc", "ep", "dap")),
        B, S, H, P, G, N, min(chunk, S), int(x.dtype == torch.bfloat16),
        int(dt.dtype == torch.bfloat16),
        int(grads[5] is not None and grads[5].dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        why = {-1: "a shape it does not take",
               -2: "a TMA tensor map was refused"}.get(err, f"cudaError {err}")
        raise RuntimeError(f"ssd_scan backward pass {name} failed: {why}")


def ssd_scan_bwd(x, dt, A, Bm, Cm, dy, dstate=None, scr=None, *,
                 chunk: int = 256, init_state=None):
    """The gradient of ``ssd_scan`` at (dy, dstate) (dstate = d(final
    state) or None): (dx, ddt, dA, dBm, dCm, dinit) in the dtypes of x,
    dt, A, Bm, Cm and init_state (dinit None without one). On a CUDA
    tensor it launches the nine passes of ``_bwd_lib(x.dtype)``
    (``csrc/ssd_scan_bwd.cu`` for float32 x, ``csrc/ssd_scan_bwd_bf16.cu``
    for bfloat16) on the forward's scratch ``scr`` (``scratch``, after the
    five forward passes) or raises, naming the shape or dtype it refuses;
    on a CPU tensor it is ``ssd_scan_bwd_ref``."""
    global BWD_LAUNCHES, BF16_BWD_LAUNCHES
    if x.device.type == "cpu":
        return ssd_scan_bwd_ref(x, dt, A, Bm, Cm, dy, dstate, chunk=chunk,
                                init_state=init_state)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"no kernel for device {x.device}")
    _check(x, dt, A, Bm, Cm, chunk, init_state)
    B, S, H, P = x.shape
    N = Bm.shape[3]
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or not dy.is_contiguous():
        raise ValueError(f"dy must be a contiguous {x.dtype} tensor of x's "
                         f"shape {tuple(x.shape)} on {x.device}")
    if dstate is not None and (
            tuple(dstate.shape) != (B, H, P, N)
            or dstate.dtype != torch.float32 or dstate.device != x.device
            or not dstate.is_contiguous()):
        raise ValueError(f"dstate must be a contiguous float32 tensor of "
                         f"shape {(B, H, P, N)} on {x.device}")
    if scr is None or any(tuple(scr[k].shape) != v for k, v in
                          scratch_shapes(x, Bm, chunk).items()):
        raise ValueError("the backward needs the forward's scratch of this "
                         "call (ssd.scratch after its five passes)")
    grads = (torch.empty_like(x), torch.empty_like(dt), torch.empty_like(A),
             torch.empty_like(Bm), torch.empty_like(Cm),
             None if init_state is None else torch.empty_like(init_state))
    if x.device.type == "meta":
        META_OPS["backward"] += work(x.shape, Bm.shape[2], N, chunk, True)
        return grads
    ws = bwd_scratch(x, Bm, chunk)
    for name in BWD_PASSES:
        launch_bwd(name, x, dt, A, Bm, Cm, dy, dstate, scr, grads, ws, chunk)
    BWD_LAUNCHES += 1
    BF16_BWD_LAUNCHES += x.dtype == torch.bfloat16
    return grads


def _forward(x, dt, A, Bm, Cm, init_state, chunk: int):
    """The five passes: (y, state, their scratch). Counts one launch (and
    one bfloat16 launch for bfloat16 x)."""
    global LAUNCHES, BF16_LAUNCHES
    _check(x, dt, A, Bm, Cm, chunk, init_state)
    B, S, H, P = x.shape
    N = Bm.shape[3]
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    scr = scratch(x, Bm, chunk)
    if x.device.type == "meta":
        META_OPS["forward"] += work(x.shape, Bm.shape[2], N, chunk)
        return y, state, scr
    for name in PASSES:
        launch(name, x, dt, A, Bm, Cm, init_state, y, state, scr, chunk)
    LAUNCHES += 1
    BF16_LAUNCHES += x.dtype == torch.bfloat16
    return y, state, scr


class SsdScanFn(torch.autograd.Function):
    """K4 with its gradient: the five forward passes, keeping their
    scratch (dts, cum, cb and S_in per chunk) for the backward kernel. On
    CPU tensors the plain versions both ways (``ssd_scan_ref``,
    ``ssd_scan_bwd_ref``)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, init_state, chunk: int):
        ctx.set_materialize_grads(False)
        ctx.chunk = chunk
        if x.device.type == "cpu":
            y, state = ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk,
                                    init_state=init_state)
            ctx.save_for_backward(x, dt, A, Bm, Cm, init_state)
            return y, state
        y, state, scr = _forward(x, dt, A, Bm, Cm, init_state, chunk)
        ctx.save_for_backward(x, dt, A, Bm, Cm, init_state, scr["dts"],
                              scr["cum"], scr["cb"], scr["states"])
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, Bm, Cm, init, *saved = ctx.saved_tensors
        scr = dict(zip(("dts", "cum", "cb", "states"), saved)) or None
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        grads = ssd_scan_bwd(x, dt, A, Bm, Cm, dy,
                             None if dstate is None else dstate.contiguous(),
                             scr, chunk=ctx.chunk, init_state=init)
        return (*grads, None)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int = 256, init_state=None):
    """x (B,S,H,P); dt (B,S,H) post-softplus; A (H,) negative; Bm, Cm
    (B,S,G,N); init_state (B,H,P,N) or None. Returns y (B,S,H,P) in x's
    dtype and the final state (B,H,P,N) in float32. On a CUDA tensor
    that needs a gradient, through ``SsdScanFn``."""
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk,
                            init_state=init_state)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"no kernel for device {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, Bm, Cm, init_state)):
        return SsdScanFn.apply(x, dt, A, Bm, Cm, init_state, chunk)
    return _forward(x, dt, A, Bm, Cm, init_state, chunk)[:2]
