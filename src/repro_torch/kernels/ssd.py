"""The Mamba2 SSD chunked scan (kernel K4).

``ssd_scan`` is the port of ``repro/kernels/ssd.py``'s Pallas kernel with
the model path's signature (``repro/models/ssd.py:ssd_scan``): x
(B,S,H,P), dt (B,S,H) after softplus, A (H,) negative, Bm and Cm
(B,S,G,N) shared by the R = H/G heads of a group, an optional
``init_state`` (B,H,P,N); it returns y (B,S,H,P) and the final state
(B,H,P,N). S is cut into chunks of Q = min(chunk, S) positions, the last
one padded with dt = 0 and x = 0, which decays the state by exp(0) = 1
and adds nothing.

On a CUDA tensor the wrapper launches the hand-written Hopper kernel
``csrc/ssd_scan.cu`` (built with nvcc at first use, bound through
ctypes) or raises; it never falls back. On a CPU tensor it runs the
plain version ``ssd_scan_ref``, the reference model path's chunked form
written in PyTorch (einsums per chunk, a loop over chunks), so the CPU
path keeps the reference's arithmetic order. ``LAUNCHES`` counts kernel
launches.

The kernel takes float32 only and computes on the FP32 CUDA cores (no
TF32); P up to ``MAX_HEAD_DIM``, N up to ``MAX_STATE``, ``chunk`` up to
``MAX_CHUNK``. The plain version computes in float32, or in float64 when
it is given float64 inputs; ``error_bound`` states how far the kernel
may lie from that exact scan (``chip_smoke.py`` and the card tests hold
it so).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

LAUNCHES = 0
MAX_HEAD_DIM = 64       # P: the kernel's x, y and state tiles
MAX_STATE = 128         # N: its B, C and state tiles
MAX_CHUNK = 256         # Q: its per-chunk cumsum


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


def error_bound(x, dt, A, Bm, Cm, *, chunk: int = 256, init_state=None):
    """The kernel's float32 error against the exact scan, as (bound on
    y, bound on the final state): u * L * M with u = 2^-24, M the largest
    sum of magnitudes of the products that make up one output (the plain
    version in float64 on |x|, |Bm|, |Cm| and |init_state|: every decay
    weight and dt is positive) and L = N + 3 S' + 32 Lambda + 16. A float32
    sum of n terms is off by at most n u times its sum of magnitudes: C.B
    and C.state are sums of N terms, y and the state add up at most
    Q + S' + 2 S'/Q terms along their longest chain (S' the padded
    length), and each decay weight exp(cum_t - cum_s) is off by the error
    of its exponent, at most 27 u Lambda (each cumsum carries at most 13
    roundings of partial sums no larger than Lambda, the largest
    sum of |dt * A| over one chunk), plus the exp's own and the few
    roundings of each product (the 16)."""
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
    L = N + 3 * nc * Q + 32 * lam + 16
    u = 2.0 ** -24
    return u * L * float(mag_y.max()), u * L * float(mag_state.max())


def _lib():
    from repro_torch.kernels import build
    fn = build.load("ssd_scan").ssd_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(x, dt, A, Bm, Cm, chunk, init_state) -> None:
    named = [("x", x, 4), ("dt", dt, 3), ("A", A, 1), ("Bm", Bm, 4),
             ("Cm", Cm, 4)]
    if init_state is not None:
        named.append(("init_state", init_state, 4))
    for name, t, ndim in named:
        if t.dtype != torch.float32:
            raise TypeError(f"the SSD kernel takes float32; {name} is "
                            f"{t.dtype}")
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


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int = 256, init_state=None):
    """x (B,S,H,P); dt (B,S,H) post-softplus; A (H,) negative; Bm, Cm
    (B,S,G,N); init_state (B,H,P,N) or None. Returns y (B,S,H,P) and the
    final state (B,H,P,N), float32."""
    global LAUNCHES
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk,
                            init_state=init_state)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check(x, dt, A, Bm, Cm, chunk, init_state)
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    err = _lib()(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(),
                 None if init_state is None else init_state.data_ptr(),
                 y.data_ptr(), state.data_ptr(), B, S, H, P, G, N,
                 min(chunk, S),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: cudaError {err}")
    LAUNCHES += 1
    return y, state
