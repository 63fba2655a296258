"""The Mamba2 SSD chunked scan (kernel K4).

``ssd_scan`` is the port of ``repro/kernels/ssd.py``'s Pallas kernel with
the model path's signature (``repro/models/ssd.py:ssd_scan``): x
(B,S,H,P), dt (B,S,H) after softplus, A (H,) negative, Bm and Cm
(B,S,G,N) shared by the R = H/G heads of a group, an optional
``init_state`` (B,H,P,N); it returns y (B,S,H,P) and the final state
(B,H,P,N). S is cut into chunks of Q = min(chunk, S) positions, the last
one padded with dt = 0 and x = 0, which decays the state by exp(0) = 1
and adds nothing.

On a CUDA tensor the wrapper runs the hand-written Hopper kernels of
``csrc/ssd_scan.cu`` (built with nvcc at first use, bound through
ctypes) or raises; it never falls back. They are five passes on the
current stream (``PASSES``): the chunk cumsum of dt * A, C.B^T once per
(batch, chunk, group), each chunk's contribution to the state, the
state passed across chunks, and the chunk scan that forms y; the
scratch between them is allocated here with ``torch.empty``, and each
pass's launch error is raised on. ``LAUNCHES`` counts ``ssd_scan``
calls that launched the kernels, one per call. On a CPU tensor it runs
the plain version ``ssd_scan_ref``, the reference model path's chunked
form written in PyTorch (einsums per chunk, a loop over chunks), so the
CPU path keeps the reference's arithmetic order.

Each pass has its plain version here (``cumsum_ref``, ``bmm_ref``,
``chunk_state_ref``, ``state_passing_ref``, ``chunk_scan_ref``), on the
kernels' scratch layouts; ``ssd_scan_passes`` composes them. The
kernels take x, Bm and Cm all in float32 or all in bfloat16 (the models'
default compute dtype), dt in float32 or in x's dtype, A in float32 and
``init_state`` in float32 or bfloat16 (the reference's kernel takes any
float dtype; float16 is still to come here). A bfloat16 operand is
widened to float32 as its tile lands; y comes back in x's dtype and the
final state in float32, as the reference writes them. The kernels take
P up to ``MAX_HEAD_DIM``, N up to ``MAX_STATE``, ``chunk`` up to
``MAX_CHUNK``, and run every product on the tensor cores in 3xTF32 (each
operand split into two TF32 numbers, three TF32 products per float32
one); ``ssd_scan_tf32`` is a float64 model of that arithmetic and
``error_bound`` states how far the kernels may lie from the exact scan
(``chip_smoke.py`` and the card tests hold them so).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import (BF16_ROUND, DTYPES,
                                                 PRODUCT_ERR, tf32_products)

LAUNCHES = 0
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
                                device=x_c.device))
    w = torch.where(tri[None, :, :, None, None], torch.exp(seg), 0.0)
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


def _prod(eq: str, a, b, passes: Optional[int]):
    """einsum ``eq`` of a and b; with ``passes`` (1 or 3) the float64 sum
    of the TF32 products of their float32 values, as the kernels'
    tensor cores form it (3xTF32, or big*big alone)."""
    if passes is None:
        return torch.einsum(eq, a, b)
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


def error_bound(x, dt, A, Bm, Cm, *, chunk: int = 256, init_state=None,
                ref_y=None):
    """The kernels' error against the exact scan, as (bound on y, bound
    on the final state), on float32 inputs (bfloat16 ones widened: the
    kernels and the plain version both compute on the widened values):
    u * L * M with u = 2^-24, M the largest sum of
    magnitudes of the products that make up one output (the plain
    version in float64 on |x|, |Bm|, |Cm| and |init_state|: every decay
    weight and dt is positive) and L = N + 3 S' + 32 Lambda + 16 +
    2 PRODUCT_ERR / u.

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
    L = N + 3 * nc * Q + 32 * lam + 16 + 2 * PRODUCT_ERR / u
    bound_y = u * L * float(mag_y.max())
    if ref_y is not None:
        bound_y = bound_y + BF16_ROUND * (ref_y.double().abs() + bound_y)
    return bound_y, u * L * float(mag_state.max())


def bind(lib) -> Dict[str, object]:
    """The passes of a loaded ``ssd_scan`` library, typed for ctypes."""
    fns = {name: getattr(lib, name) for name in PASSES}
    for fn in fns.values():
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 10
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fns


_FNS: Dict[str, object] = {}


def _lib() -> Dict[str, object]:
    if not _FNS:
        from repro_torch.kernels import build
        _FNS.update(bind(build.load("ssd_scan")))
    return _FNS


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


def scratch(x, Bm, chunk: int) -> Dict[str, torch.Tensor]:
    """The passes' scratch for one call, uninitialised (``torch.empty``):
    dts and cum (B,H,nc,QP), cb (B,nc,G,QP,QP) and states
    (B,H,nc,P,N)."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    _, nc, QP = geometry(S, chunk)
    kw = dict(dtype=torch.float32, device=x.device)
    return {"dts": torch.empty((B, H, nc, QP), **kw),
            "cum": torch.empty((B, H, nc, QP), **kw),
            "cb": torch.empty((B, nc, G, QP, QP), **kw),
            "states": torch.empty((B, H, nc, P, N), **kw)}


def launch(name: str, x, dt, A, Bm, Cm, init_state, y, state,
           scr: Dict[str, torch.Tensor], chunk: int) -> None:
    """Launch one pass (a name in ``PASSES``) on the current stream and
    raise on its launch error. Counts nothing (``ssd_scan`` counts)."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    err = _lib()[name](
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), None if init_state is None else init_state.data_ptr(),
        y.data_ptr(), state.data_ptr(), scr["dts"].data_ptr(),
        scr["cum"].data_ptr(), scr["cb"].data_ptr(),
        scr["states"].data_ptr(), B, S, H, P, G, N, min(chunk, S),
        int(x.dtype == torch.bfloat16), int(dt.dtype == torch.bfloat16),
        int(init_state is not None and init_state.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan pass {name} failed: cudaError {err}")


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
    weights' exponents, expf and their products). Only the lower tiles
    of cb that the scan reads are compared."""
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
    out["ssd_bmm"] = share(cb, w_cb, m_cb, N + 14)

    run("ssd_chunk_state")
    w_upd = chunk_state_ref(f64[0], f64[3], dts, cum, chunk=chunk)
    m_upd = chunk_state_ref(f64[0].abs(), f64[3].abs(), dts, cum,
                            chunk=chunk)
    out["ssd_chunk_state"] = share(scr["states"], w_upd, m_upd,
                                   QP + 20 + lam)

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
    out["ssd_chunk_scan"] = share(y, w_y, m_y, N + QP + 34 + lam)
    return out


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int = 256, init_state=None):
    """x (B,S,H,P); dt (B,S,H) post-softplus; A (H,) negative; Bm, Cm
    (B,S,G,N); init_state (B,H,P,N) or None. Returns y (B,S,H,P) in x's
    dtype and the final state (B,H,P,N) in float32."""
    global LAUNCHES
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk,
                            init_state=init_state)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check(x, dt, A, Bm, Cm, chunk, init_state)
    B, S, H, P = x.shape
    N = Bm.shape[3]
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    scr = scratch(x, Bm, chunk)
    for name in PASSES:
        launch(name, x, dt, A, Bm, Cm, init_state, y, state, scr, chunk)
    LAUNCHES += 1
    return y, state
