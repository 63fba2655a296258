"""Causal and/or sliding-window GQA attention (kernel K3).

``flash_attention`` is the port of ``repro/kernels/flash_attention.py``'s
Pallas kernel: q (B,Sq,H,D), k and v (B,Skv,G,D) with H = G*R, head h
reading kv head h // R; scale D^-0.5; masked scores at -1e30; the output
(B,Sq,H,D). On a CUDA tensor the wrapper launches the hand-written
Hopper kernel ``csrc/flash_attention.cu`` (built with nvcc at first use,
bound through ctypes) or raises; it never falls back. On a CPU tensor it
runs the plain version ``flash_attention_ref``, the reference's
``ref.flash_attention_ref`` written in PyTorch: one masked softmax over
the whole score matrix. ``LAUNCHES`` counts kernel launches, and
``WINDOW_LAUNCHES`` those of them with a sliding window.

The kernel takes q, k and v all in float32 or all in bfloat16 (the
models' default compute dtype; the reference's kernel takes any float
dtype, float16 is still to come here), D up to ``MAX_HEAD_DIM``. A
bfloat16 operand is widened to float32 as its tile lands and the output
is written in the input dtype, as the reference widens inside and
writes ``o`` in q's dtype. Both products run on the tensor cores in
3xTF32: each operand is split into two TF32 numbers (``tf32_round``)
and each product is the sum of three TF32 products, accumulated in
float32 (a widened bfloat16 splits exactly, with a zero small half);
``attention_tf32`` is a float64 model of that arithmetic and
``error_bound`` the stated bound against the plain version. The switches
for ``torch.matmul`` stay off: only this kernel uses TF32, inside its
own code. It skips kv tiles the mask rules out, which changes no row
that sees at least one key; a row that sees none is outside K3's
contract (there the TPU kernel's value depends on
its block size, the plain version's is the mean of v, the kernel's is 0).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

LAUNCHES = 0
WINDOW_LAUNCHES = 0
MAX_HEAD_DIM = 128
NEG_INF = -1e30
DTYPES = (torch.float32, torch.bfloat16)      # the kernel's operand dtypes
# half an ulp of bfloat16 relative to the value, at most: the rounding of
# a float32 result written in bfloat16 (8 significant bits, so an ulp is
# up to 2^-7 of the value)
BF16_ROUND = 2.0 ** -8


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


def _visible(Sq: int, Skv: int, causal: bool, window: Optional[int],
             device) -> torch.Tensor:
    """(Sq, Skv) mask of the keys each query sees."""
    qp = torch.arange(Sq, device=device)[:, None]
    kp = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    return mask


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 explicit mantissa bits) to the
    nearest, ties away from zero, as ``cvt.rna.tf32.f32`` does: add half
    a unit of the 13 dropped bits to the magnitude, then clear them."""
    bits = x.to(torch.float32).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def _split(x: torch.Tensor):
    big = tf32_round(x)
    return big, tf32_round(x - big)


def tf32_products(a, b, passes: int, eq: str):
    """float64 sum of the TF32 products of ``a`` and ``b`` (float32):
    big*big with ``passes`` = 1, plus big*small + small*big with 3."""
    (ab, as_), (bb, bs) = _split(a), _split(b)
    out = torch.einsum(eq, ab.double(), bb.double())
    if passes == 3:
        out = out + torch.einsum(eq, ab.double(), bs.double()) \
            + torch.einsum(eq, as_.double(), bb.double())
    return out


def attention_tf32(q, k, v, *, causal: bool = True,
                   window: Optional[int] = None, passes: int = 3):
    """A float64 model of the kernel's arithmetic: q scaled in float32,
    every operand of S = q K^T and of O = P V split into TF32 parts, the
    ``passes`` TF32 products of each (3: 3xTF32, the kernel; 1: plain
    TF32) summed exactly, the softmax in float64 with the kernel's masks.
    It leaves out the float32 roundings of the sums, which
    ``error_bound`` counts separately. Returns (B,Sq,H,D) in float64."""
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, not {passes}")
    B, Sq, H, D = q.shape
    _, Skv, G, _ = k.shape
    R = H // G
    qg = q.reshape(B, Sq, G, R, D).float() * D ** -0.5
    s = tf32_products(qg, k.float(), passes, "bqgrd,bsgd->bgrqs")
    mask = _visible(Sq, Skv, causal, window, q.device)
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    o = tf32_products(p.float(), v.float(), passes, "bgrqs,bsgd->bgrqd") / l
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)


# 3xTF32 drops the small*small term and the two residuals of the split:
# at most about 3 * 2^-22 of |a||b| per product
PRODUCT_ERR = 3 * 2.0 ** -22


def error_bound(q, k, v, *, causal: bool = True,
                window: Optional[int] = None, ref=None) -> torch.Tensor:
    """Bound on |kernel - plain version| per output row, (B, Sq, H, 1)
    float32, broadcast over D, on float32 q, k, v (bfloat16 ones widened:
    the kernel and the plain version both compute on the widened values).

    Derivation. Let sigma_ij = sum_d |q_id k_jd| * D^-0.5 (the scaled
    magnitudes of one score). The kernel's score differs from the exact
    one by at most PRODUCT_ERR * sigma_ij (3xTF32) plus D * 2^-24 *
    sigma_ij (a float32 sum of D terms in any order), and the plain
    version's float32 score by the last term again, so the two scores
    differ by delta_ij = (PRODUCT_ERR + 2 D 2^-24) sigma_ij, and by at
    most Delta_i = max_j delta_ij over the keys row i sees. Moving every
    score of a row by at most Delta_i moves each softmax weight w_ij by
    a factor within exp(+-2 Delta_i) (numerator and normaliser), so the
    output sum_j w_ij v_j moves by at most (exp(2 Delta_i) - 1) max|v|.
    The PV product in 3xTF32 adds PRODUCT_ERR * sum_j w_ij |v_j| <=
    PRODUCT_ERR max|v|, and the float32 sums over Skv keys in another
    order Skv * 2^-24 * max|v| (the reordering term this kernel was held
    to before it used the tensor cores). 1e-6 absolute covers outputs
    near 0. A plain 1xTF32 kernel (about 2^-11 per operand) breaks this
    bound (``tests/test_torch_attention.py``).

    bfloat16 output. For bfloat16 q, k, v the kernel rounds its float32
    result to bfloat16, off by at most half an ulp, BF16_ROUND times the
    result's magnitude. With ``ref``, the plain version's float32 output
    on the widened inputs, the bound against ``ref`` adds BF16_ROUND
    (|ref| + the float32 bound) per element, and is then (B, Sq, H, D)."""
    B, Sq, H, D = q.shape
    _, Skv, G, _ = k.shape
    R = H // G
    qa = q.reshape(B, Sq, G, R, D).float().abs() * D ** -0.5
    sigma = torch.einsum("bqgrd,bsgd->bgrqs", qa, k.float().abs())
    mask = _visible(Sq, Skv, causal, window, q.device)
    sig_max = torch.where(mask, sigma, 0.0).amax(-1)        # (B,G,R,Sq)
    delta = (PRODUCT_ERR + 2 * D * 2.0 ** -24) * sig_max.double()
    vmax = float(v.abs().max()) if v.numel() else 0.0
    bound = (torch.expm1(2 * delta) + PRODUCT_ERR
             + Skv * 2.0 ** -24) * vmax + 1e-6
    bound = bound.permute(0, 3, 1, 2).reshape(B, Sq, H, 1).float()
    if ref is None:
        return bound
    return bound + BF16_ROUND * (ref.float().abs() + bound)


def _lib():
    from repro_torch.kernels import build
    fn = build.load("flash_attention").flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, window) -> None:
    if q.dtype not in DTYPES:
        raise TypeError(f"the attention kernel takes float32 or bfloat16; "
                        f"q is {q.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != q.dtype:
            raise TypeError(f"the attention kernel takes q, k and v in one "
                            f"dtype; q is {q.dtype}, {name} {x.dtype}")
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
    """q (B,Sq,H,D); k, v (B,Skv,G,D), all float32 or all bfloat16.
    Returns (B,Sq,H,D) in q's dtype."""
    global LAUNCHES, WINDOW_LAUNCHES
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
                 int(q.dtype == torch.bfloat16), D ** -0.5,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    LAUNCHES += 1
    WINDOW_LAUNCHES += window is not None
    return out
