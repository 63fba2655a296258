"""Causal and/or sliding-window GQA attention (kernel K3) and its gradient.

``flash_attention`` is the port of ``repro/kernels/flash_attention.py``'s
Pallas kernel: q (B,Sq,H,D), k and v (B,Skv,G,D) with H = G*R, head h
reading kv head h // R; scale D^-0.5; masked scores at -1e30; the output
(B,Sq,H,D). On a CUDA tensor the wrapper launches a hand-written Hopper
kernel (built with nvcc at first use, bound through ctypes) or raises; it
never falls back: ``csrc/flash_attention.cu`` for float32 q, k and v,
``csrc/flash_attention_bf16.cu`` for bfloat16 ones. When a gradient is
needed (grad mode on and an input that requires it) the launch goes
through ``FlashAttentionFn``: its forward has the kernel also write each
row's log-sum-exp, and its backward launches ``flash_attention_bwd``, a
kernel of this port (``csrc/flash_attention_bwd.cu`` for float32,
``csrc/flash_attention_bwd_bf16.cu`` for bfloat16): the reference
differentiates its jnp attention through XLA and has no Pallas backward.
Without a gradient nothing else is written. On a CPU tensor it runs the
plain version ``flash_attention_ref``, the reference's
``ref.flash_attention_ref`` written in PyTorch: one masked softmax over
the whole score matrix, which autograd differentiates. ``LAUNCHES``
counts forward launches, ``WINDOW_LAUNCHES`` those of them with a
sliding window, ``BF16_LAUNCHES`` those of the bfloat16 kernel,
``BWD_LAUNCHES`` backward launches and ``BF16_BWD_LAUNCHES`` those of
them by the bfloat16 backward kernel.

The kernels take q, k and v all in float32 or all in bfloat16 (the
models' default compute dtype; the reference's kernel takes any float
dtype, float16 is still to come here and is refused by name), D up to
``MAX_HEAD_DIM``; the output is in the input dtype, as the reference
writes ``o`` in q's dtype. float32: both products run on the tensor
cores in 3xTF32: each operand is split into two TF32 numbers
(``tf32_round``) and each product is the sum of three TF32 products,
accumulated in float32; ``attention_tf32`` is a float64 model of that
arithmetic. bfloat16: the tiles stay bfloat16 from device memory to
bf16 ``wgmma``; S = q K^T is one bf16 product on the unscaled values
(exact products, a float32 sum) scaled after in float32, and P V two,
P split into two bfloat16 parts (``bf16_split``); ``attention_bf16`` is
a float64 model of that arithmetic. ``error_bound`` states each
kernel's bound against the plain version. The switches for
``torch.matmul`` stay off: only the kernels use TF32 or bf16 products,
inside their own code. Both skip kv tiles the mask rules out, which
changes no row that sees at least one key. A row that sees none is 0 in
the plain version and, when the kernel writes the log-sum-exp (a
gradient is needed), in the kernel, with log-sum-exp +inf: no gradient
reaches its q, and it gives nothing to k and v. Without the log-sum-exp
(serving) the kernel leaves that row outside its contract, as before
(its value there depends on the block size, as the TPU kernel's does).

The backward (``flash_attention_bwd``) runs its seven products on the
tensor cores too. float32: 3xTF32, ``attention_bwd_tf32`` a float64
model of that arithmetic. bfloat16: the tiles stay bfloat16 from device
memory to bf16 ``wgmma``; S and dP are one bf16 product each on the
values as they are (exact products, float32 sums), S scaled after; P and
dS, float32, go into dV, dK and dQ in two bfloat16 parts
(``bf16_split``); ``attention_bwd_bf16`` is a float64 model of that
arithmetic. ``flash_attention_bwd_ref`` is the plain version (the
explicit formula, float64-capable) and ``bwd_error_bound`` states each
kernel's bound.

On a ``meta`` tensor (the dry run's account, ``launch/dryrun.py``) the
wrappers compute nothing: they return ``meta`` tensors of the kernels'
output shapes and add the kernels' operation count (``work``, the count
of ``PERF.md``'s bounds) to ``META_OPS``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.nograd import refuse_grad

LAUNCHES = 0
WINDOW_LAUNCHES = 0
BF16_LAUNCHES = 0
BWD_LAUNCHES = 0
BF16_BWD_LAUNCHES = 0
# the operations the meta shape path reckoned: forward and backward
META_OPS = {"forward": 0, "backward": 0}
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
    matrix, in float32 (float64 for float64 inputs): ``flash_attention_ref``
    with the query positions starting at ``q_offset`` and an optional
    scale (``models.attention`` uses both). A row that sees no key is 0."""
    B, Sq, H, D = q.shape
    _, Skv, G, _ = k.shape
    R = H // G
    scale = scale or D ** -0.5
    ct = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(B, Sq, G, R, D).to(ct) * scale
    s = torch.einsum("bqgrd,bsgd->bgrqs", qg, k.to(ct))
    qp = q_offset + torch.arange(Sq, device=q.device)
    kp = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp[None, :] <= qp[:, None]
    if window is not None:
        mask &= kp[None, :] > qp[:, None] - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if sees_no_key(Sq, Skv, causal, window, q_offset):     # those rows: 0
        p = p * mask.any(-1, keepdim=True)
    o = torch.einsum("bgrqs,bsgd->bgrqd", p, v.to(ct))
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def sees_no_key(Sq: int, Skv: int, causal: bool, window: Optional[int],
                q_offset: int = 0) -> bool:
    """Whether some query row of ``masked_attention``'s mask sees no key,
    from the positions alone (no read of a mask on the card). Row qp sees
    keys [max(0, qp - window + 1), min(Skv - 1, qp)] (causal) or up to
    Skv - 1: empty for a causal row before the first key, or a window
    that starts past the last key; the rows' positions rise, so the
    first and the last row decide."""
    if Sq == 0:
        return False
    last = q_offset + Sq - 1
    return (causal and q_offset < 0) or (
        window is not None and last - window + 1 > Skv - 1)


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


def visible_pairs(Sq: int, Skv: int, causal: bool,
                  window: Optional[int]) -> int:
    """The (query, key) pairs ``_visible``'s mask keeps, from the
    positions alone: query i sees keys max(0, i - window + 1) ..
    min(Skv - 1, i) (causal) or .. Skv - 1."""
    import numpy as np
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i, Skv - 1) if causal else np.full_like(i, Skv - 1)
    lo = np.maximum(i - window + 1, 0) if window is not None else 0
    return int(np.maximum(hi - lo + 1, 0).sum())


def work(q_shape, Skv: int, causal: bool, window: Optional[int],
         backward: bool = False) -> int:
    """The operations the kernel does on q (B,Sq,H,D) against Skv keys,
    2 a multiply-add: QK^T and PV over the visible pairs (4 D a pair and
    head), its backward's five products (10 D)."""
    B, Sq, H, D = q_shape
    return (10 if backward else 4) * D * H * B * visible_pairs(
        Sq, Skv, causal, window)


def bf16_split(p: torch.Tensor):
    """float32 ``p`` as hi + lo, both bfloat16 rounded to nearest even
    (returned in float32): hi = bf16(p), lo = bf16(p - hi), the bfloat16
    kernel's split of P. hi is off by at most 2^-8 |p| and p - hi is
    exact in float32, so |p - hi - lo| <= 2^-16 |p| for |p| >= 2^-118;
    below that, bfloat16's subnormals (2^-133 apart) add up to 2^-133."""
    p = p.float()
    hi = p.to(torch.bfloat16).float()
    return hi, (p - hi).to(torch.bfloat16).float()


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
    big*big with ``passes`` = 1, plus small*big (``a``'s small half) with
    2, plus big*small too with 3."""
    (ab, as_), (bb, bs) = _split(a), _split(b)
    out = torch.einsum(eq, ab.double(), bb.double())
    if passes == 3:
        out = out + torch.einsum(eq, ab.double(), bs.double())
    if passes >= 2:
        out = out + torch.einsum(eq, as_.double(), bb.double())
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


def attention_bf16(q, k, v, *, causal: bool = True,
                   window: Optional[int] = None, parts: int = 2):
    """A float64 model of the bfloat16 kernel's arithmetic on bfloat16 q,
    k, v (float32 ones holding bfloat16 values): S = q K^T from the
    values exactly (each product of two bfloat16 numbers is exact in
    float32; the model sums in float64), times the float32 scale after the
    product; the softmax in float64 with the kernel's masks; P rounded to
    float32 and split into ``parts`` bfloat16 parts (2: hi + lo, the
    kernel; 1: hi alone, one bf16 product); O = the parts' products with
    V summed exactly, over l, the float64 sum of the float32 P. It leaves
    out the float32 roundings of the sums, which ``error_bound`` counts
    separately. Returns (B,Sq,H,D) in float64."""
    if parts not in (1, 2):
        raise ValueError(f"parts must be 1 or 2, not {parts}")
    B, Sq, Skv, H, G, R, D = _groups(q, k)
    scale = float(torch.tensor(D ** -0.5, dtype=torch.float32))
    qg = q.reshape(B, Sq, G, R, D).double()
    s = torch.einsum("bqgrd,bsgd->bgrqs", qg, k.double()) * scale
    mask = _visible(Sq, Skv, causal, window, q.device)
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True)).float()
    hi, lo = bf16_split(p)
    w = hi.double() + lo.double() if parts == 2 else hi.double()
    o = torch.einsum("bgrqs,bsgd->bgrqd", w, v.double())
    o = o / p.double().sum(-1, keepdim=True)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)


def attention_bwd_tf32(q, k, v, o, do, lse, *, causal: bool = True,
                       window: Optional[int] = None, passes: int = 3):
    """A float64 model of the float32 backward kernel's arithmetic: (dq,
    dk, dv) in float64 from float32 q, k, v, o, do and the forward's lse.
    S = q K^T and dP = dO V^T (each computed by both of the kernel's
    passes, the same products), then dV = P^T dO, dK = scale dS^T Q and dQ
    = scale dS K with P and dS rounded to float32, as the kernel holds
    them; every product through ``tf32_products``. ``passes`` 3: 3xTF32
    throughout (the kernel); 1: one TF32 product throughout (plain TF32).
    P = exp(scale S - lse) where the mask lets the key through, else 0,
    and dS = P (dP - delta) in float64. It leaves out the float32
    roundings of the sums, of exp and of delta, which ``bwd_error_bound``
    counts separately. One batch row at a time."""
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, not {passes}")
    B, Sq, Skv, H, G, R, D = _groups(q, k)
    scale = D ** -0.5
    mask = _visible(Sq, Skv, causal, window, q.device)
    f64 = torch.float64
    dq = torch.empty((B, Sq, H, D), dtype=f64, device=q.device)
    dk = torch.empty((B, Skv, G, D), dtype=f64, device=q.device)
    dv = torch.empty_like(dk)
    for b in range(B):
        qb = q[b].float().reshape(Sq, G, R, D)
        dob = do[b].float().reshape(Sq, G, R, D)
        kb, vb = k[b].float(), v[b].float()
        s = tf32_products(qb, kb, passes, "qgrd,sgd->grqs") * scale
        lb = lse[b].to(f64).reshape(G, R, Sq, 1)
        p = torch.where(mask, torch.exp(torch.where(mask, s - lb, 0.0)), 0.0)
        dp = tf32_products(dob, vb, passes, "qgrd,sgd->grqs")
        delta = (do[b].to(f64) * o[b].to(f64)).sum(-1).T.reshape(G, R, Sq, 1)
        ds = (p * (dp - delta)).float()
        p = p.float()
        del s, dp
        dv[b] = tf32_products(p, dob, passes, "grqs,qgrd->sgd")
        dk[b] = scale * tf32_products(ds, qb, passes, "grqs,qgrd->sgd")
        dq[b] = (scale * tf32_products(ds, kb, passes, "grqs,sgd->qgrd")
                 ).reshape(Sq, H, D)
    return dq, dk, dv


def bf16_parts(x: torch.Tensor, parts: int) -> torch.Tensor:
    """float32 ``x`` as the sum of its first ``parts`` bfloat16 parts, in
    float64: hi = bf16(x) (1), + lo = bf16(x - hi) (2, ``bf16_split``), +
    bf16(x - hi - lo) (3). Each remainder is exact in float32."""
    x = x.float()
    out = torch.zeros_like(x, dtype=torch.float64)
    for _ in range(parts):
        part = x.to(torch.bfloat16).float()
        out += part.double()
        x = x - part
    return out


def attention_bwd_bf16(q, k, v, o, do, lse, *, causal: bool = True,
                       window: Optional[int] = None, parts: int = 2):
    """A float64 model of the bfloat16 backward kernel's arithmetic: (dq,
    dk, dv) in float64 from bfloat16 q, k, v, o, do (float32 ones holding
    bfloat16 values) and the forward's lse. S = q K^T and dP = dO V^T
    exactly (each product of two bfloat16 numbers is exact in float32;
    the model sums in float64), S times the float32 scale after the
    product; P = exp(scale S - lse) where the mask lets the key through,
    else 0, and dS = P (dP - delta), both rounded to float32 as the kernel
    holds them, then each as the sum of its first ``parts`` bfloat16 parts
    (``bf16_parts``; 2: the kernel's hi + lo; 1: hi alone, one bf16
    product; 3: a third part); dV = P^T dO, dK = scale dS^T Q and dQ =
    scale dS K from those parts, their products exact. It leaves out the
    float32 roundings of the sums, of exp and of delta, which
    ``bwd_error_bound`` counts separately. One batch row at a time."""
    if parts not in (1, 2, 3):
        raise ValueError(f"parts must be 1, 2 or 3, not {parts}")
    B, Sq, Skv, H, G, R, D = _groups(q, k)
    scale = float(torch.tensor(D ** -0.5, dtype=torch.float32))
    mask = _visible(Sq, Skv, causal, window, q.device)
    f64 = torch.float64
    dq = torch.empty((B, Sq, H, D), dtype=f64, device=q.device)
    dk = torch.empty((B, Skv, G, D), dtype=f64, device=q.device)
    dv = torch.empty_like(dk)
    for b in range(B):
        qb = q[b].to(f64).reshape(Sq, G, R, D)
        dob = do[b].to(f64).reshape(Sq, G, R, D)
        kb, vb = k[b].to(f64), v[b].to(f64)
        s = torch.einsum("qgrd,sgd->grqs", qb, kb) * scale
        lb = lse[b].to(f64).reshape(G, R, Sq, 1)
        p = torch.where(mask, torch.exp(torch.where(mask, s - lb, 0.0)), 0.0)
        dp = torch.einsum("qgrd,sgd->grqs", dob, vb)
        delta = (do[b].to(f64) * o[b].to(f64)).sum(-1).T.reshape(G, R, Sq, 1)
        ds = bf16_parts((p * (dp - delta)).float(), parts)
        p = bf16_parts(p.float(), parts)
        del s, dp
        dv[b] = torch.einsum("grqs,qgrd->sgd", p, dob)
        dk[b] = scale * torch.einsum("grqs,qgrd->sgd", ds, qb)
        dq[b] = (scale * torch.einsum("grqs,sgd->qgrd", ds, kb)
                 ).reshape(Sq, H, D)
    return dq, dk, dv


# 3xTF32 drops the small*small term and the two residuals of the split:
# at most about 3 * 2^-22 of |a||b| per product
PRODUCT_ERR = 3 * 2.0 ** -22
# the bfloat16 kernel's P in two bfloat16 parts: |p - hi - lo| <= 2^-16 p
# (``bf16_split``; the absolute 2^-133 below 2^-118 is inside error_bound's
# 1e-6)
P_SPLIT_ERR = 2.0 ** -16


def error_bound(q, k, v, *, causal: bool = True,
                window: Optional[int] = None, ref=None) -> torch.Tensor:
    """Bound on |kernel - plain version| per output row, (B, Sq, H, 1)
    float32, broadcast over D: for float32 q, k, v that of the 3xTF32
    kernel, for bfloat16 ones that of the bfloat16 kernel, both against
    the plain version in float32 on the same (widened) values.

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

    The bfloat16 kernel (its own terms, the same steps). Its S products
    are exact (two bfloat16 numbers multiply exactly in float32), so
    PRODUCT_ERR leaves the score term: its D-term float32 sum is off by
    D 2^-24 sigma_ij and its product by the scale, applied after, by 2^-24
    sigma_ij; the plain version's scaled q and its sum by D 2^-24 sigma_ij
    again: delta_ij = (2 D + 1) 2^-24 sigma_ij. On the output, P in two
    bfloat16 parts moves each weight by at most P_SPLIT_ERR of itself
    (its products with V are exact, their sum float32), so P_SPLIT_ERR
    max|v| takes PRODUCT_ERR's place, beside the same reordering term
    Skv 2^-24 max|v| and 1e-6. One bfloat16 part (2^-8 a weight) breaks
    it (``tests/test_torch_attention_bf16.py``).

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
    if q.dtype == torch.bfloat16:
        score_err, out_err = (2 * D + 1) * 2.0 ** -24, P_SPLIT_ERR
    else:
        score_err, out_err = PRODUCT_ERR + 2 * D * 2.0 ** -24, PRODUCT_ERR
    delta = score_err * sig_max.double()
    vmax = float(v.float().abs().max()) if v.numel() else 0.0
    bound = (torch.expm1(2 * delta) + out_err
             + Skv * 2.0 ** -24) * vmax + 1e-6
    bound = bound.permute(0, 3, 1, 2).reshape(B, Sq, H, 1).float()
    if ref is None:
        return bound
    return bound + BF16_ROUND * (ref.float().abs() + bound)


# ------------------------------ the backward ------------------------------
def _groups(q, k):
    B, Sq, H, D = q.shape
    _, Skv, G, _ = k.shape
    return B, Sq, Skv, H, G, H // G, D


def _scores(qb, kb, G, R, D, ct):
    """Scaled scores of one batch row: qb (Sq,H,D), kb (Skv,G,D) ->
    (G,R,Sq,Skv) in ``ct``."""
    qg = qb.reshape(qb.shape[0], G, R, D).to(ct) * D ** -0.5
    return torch.einsum("qgrd,sgd->grqs", qg, kb.to(ct))


def lse_ref(q, k, *, causal: bool = True, window: Optional[int] = None):
    """The plain version of the log-sum-exp the kernel's forward writes
    for its backward: (B,H,Sq) of the scaled, masked scores, in float32
    (float64 for float64 inputs); +inf for a row that sees no key."""
    B, Sq, Skv, H, G, R, D = _groups(q, k)
    ct = torch.promote_types(q.dtype, torch.float32)
    mask = _visible(Sq, Skv, causal, window, q.device)
    out = torch.empty((B, H, Sq), dtype=ct, device=q.device)
    for b in range(B):
        s = torch.where(mask, _scores(q[b], k[b], G, R, D, ct), -torch.inf)
        out[b] = torch.logsumexp(s, -1).reshape(H, Sq)
    return torch.where(mask.any(-1), out, torch.inf)


def flash_attention_bwd_ref(q, k, v, o, do, lse, *, causal: bool = True,
                            window: Optional[int] = None):
    """The plain version of the backward: the FlashAttention-2 formula,
    written out. P = exp(scale q k - lse) where the mask lets the key
    through (else 0), dP = dO V^T, delta = rowsum(dO * O), dS = P (dP -
    delta); dV = P^T dO, dK = scale dS^T Q, dQ = scale dS K, each kv head
    summing over its R query heads. q, o, do (B,Sq,H,D), k, v (B,Skv,G,D),
    lse (B,H,Sq) as the forward writes it (``lse_ref``). Computes in
    float32, or float64 for float64 inputs; returns (dq, dk, dv) in q's
    dtype. One batch row at a time, to bound the (G,R,Sq,Skv) temporaries."""
    B, Sq, Skv, H, G, R, D = _groups(q, k)
    ct = torch.promote_types(q.dtype, torch.float32)
    scale = D ** -0.5
    mask = _visible(Sq, Skv, causal, window, q.device)
    dq = torch.empty((B, Sq, H, D), dtype=ct, device=q.device)
    dk = torch.empty((B, Skv, G, D), dtype=ct, device=q.device)
    dv = torch.empty_like(dk)
    for b in range(B):
        s = _scores(q[b], k[b], G, R, D, ct)
        lb = lse[b].to(ct).reshape(G, R, Sq, 1)
        p = torch.where(mask, torch.exp(s - lb), 0.0)
        del s
        dob = do[b].to(ct).reshape(Sq, G, R, D)
        dp = torch.einsum("qgrd,sgd->grqs", dob, v[b].to(ct))
        delta = (do[b].to(ct) * o[b].to(ct)).sum(-1)       # (Sq, H)
        ds = p * (dp - delta.T.reshape(G, R, Sq, 1))
        del dp
        dv[b] = torch.einsum("grqs,qgrd->sgd", p, dob)
        qb = q[b].to(ct).reshape(Sq, G, R, D)
        dk[b] = scale * torch.einsum("grqs,qgrd->sgd", ds, qb)
        dq[b] = (scale * torch.einsum("grqs,sgd->qgrd", ds, k[b].to(ct))
                 ).reshape(Sq, H, D)
        del p, ds
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


# the float32 roundings of one operation, and expf's (2 ulp)
U32 = 2.0 ** -24
EXP_ERR = 4 * U32
# the smallest normal float32: expf's absolute error near underflow
TINY32 = 2.0 ** -126


def bwd_error_bound(q, k, v, o, do, lse, *, causal: bool = True,
                    window: Optional[int] = None, refs=None):
    """Bounds on |kernel - plain version| of the backward's (dq, dk, dv),
    per element and in their shapes, float64, the plain version on the
    same values (bfloat16 ones widened) and the same o and lse: for
    float32 q, k, v, o, do those of the 3xTF32 kernel, for bfloat16 ones
    those of the bfloat16 kernel (pass the bfloat16 tensors).

    Derivation (float32), u = 2^-24, e = PRODUCT_ERR (each term of a
    3xTF32 product is off by at most e of its magnitude), every sum in
    float32 in any order (u per term, the forward's model). Let sigma_ij =
    scale sum_d |q_id k_jd|, tau_ij = sum_d |do_id v_jd|, rho_i = sum_d
    |do_id o_id| and T = tau + rho.
    - P: the score is a D-term product on the tensor cores, (e + D u)
      sigma off, times scale in float32 (u sigma); minus lse, u |x| with x
      = s - lse; expf, 2 ulp (EXP_ERR) and TINY32 absolute where it leaves
      the normal range. So |P~ - P| <= pe = P e_p + TINY32, with e_p =
      exp((e + (D + 2) u) sigma + u |x|) (1 + EXP_ERR) - 1.
    - dP - delta: dP a D-term product, (e + D u) tau; delta a D-term fmaf
      chain (the delta pass), D u rho; the difference, u: within (e + (D +
      2) u) T.
    - dS = P (dP - delta) rounded: |dS~ - dS| <= E = (P + pe) T kk - P T,
      kk = (1 + e + (D + 2) u)(1 + u).
    - dV = sum_i P dO over n = Sq R terms (the R heads of the group), a
      product of P (float32, split) and dO: sum_i pe |dO| + (e + n u)
      sum_i (P + pe) |dO|.
    - dK = scale sum_i dS Q over n = Sq R terms, and dQ = scale sum_j dS K
      over n = Skv terms: scale (A + (e + (n + 2) u) (C + A)), with A the
      sum of E times the magnitudes and C that of |dS| (the product's
      terms, the sum, the product by scale and scale's own rounding).
    With e = 0 this is the bound of a kernel whose products are exact
    float32 fmaf chains (the first version of this kernel). All sums of
    magnitudes are taken in float64.

    The bfloat16 kernel (its own terms, the same steps). S and dP are
    products of bfloat16 values, exact in float32, summed in float32: e
    leaves the P and dS - delta terms (e = 0 there). P is 2^y for y =
    fmaf(S, c, -l), c = scale log2(e) and l = lse log2(e), each product
    rounded in float32 (c from the float32 scale and log2(e): 3 u of |S|
    scale <= sigma; l: 2 u |lse| <= 2 u (|x| + sigma)), the fmaf u |x|;
    2^y by ex2.approx.ftz (what exp2f reduces to, 2 ulp: EXP_ERR, the
    CUDA Math API's maximum for exp2f; a result below 2^-126 flushed to
    0: TINY32). The exponent is off by (D + 5) u sigma + 3 u |x| where
    the float32 kernel's is off by (e + (D + 2) u) sigma + u |x|.
    P and dS enter dV,
    dK and dQ in two bfloat16 parts whose sum is off by at most
    P_SPLIT_ERR of the float32 value, plus TINY32 where a part falls below
    the normal range (a part there is at most 2^-126, kept or flushed), and
    their products with dO, Q or K are exact: P_SPLIT_ERR takes e's place
    in the dV, dK and dQ terms, beside TINY32 times the sum of |dO|, |Q|
    or |K| over the pairs the mask lets through. One bfloat16 part (2^-8
    of each) breaks this bound (``tests/test_torch_attention_bwd_bf16.py``).
    For bfloat16 outputs, ``refs`` = the plain version's (dq, dk, dv) in
    float64 on the widened inputs, and each bound adds BF16_ROUND (|ref| +
    bound): the rounding of the float32 result to bfloat16."""
    B, Sq, Skv, H, G, R, D = _groups(q, k)
    f64 = torch.float64
    scale = D ** -0.5
    bf16 = q.dtype == torch.bfloat16
    # e: S and dP's products; e_out and tiny: those of dV, dK and dQ
    u, e = U32, 0.0 if bf16 else PRODUCT_ERR
    e_out, tiny = (P_SPLIT_ERR, TINY32) if bf16 else (PRODUCT_ERR, 0.0)
    mask = _visible(Sq, Skv, causal, window, q.device)
    maskd = mask.to(f64)
    bq = torch.empty((B, Sq, H, D), dtype=f64, device=q.device)
    bk = torch.empty((B, Skv, G, D), dtype=f64, device=q.device)
    bv = torch.empty_like(bk)
    kk = (1 + e + (D + 2) * u) * (1 + u)
    for b in range(B):
        qa = q[b].to(f64).reshape(Sq, G, R, D)
        ka, va = k[b].to(f64), v[b].to(f64)
        doa = do[b].to(f64).reshape(Sq, G, R, D)
        s = torch.einsum("qgrd,sgd->grqs", qa, ka) * scale
        sigma = torch.einsum("qgrd,sgd->grqs", qa.abs(), ka.abs()) * scale
        lb = lse[b].to(f64).reshape(G, R, Sq, 1)
        x = torch.where(mask, s - lb, 0.0)
        p = torch.where(mask, torch.exp(x), 0.0)
        arg = ((D + 5) * u * sigma + 3 * u * x.abs() if bf16
               else (e + (D + 2) * u) * sigma + u * x.abs())
        e_p = torch.expm1(arg) * (1 + EXP_ERR) + EXP_ERR
        pe = torch.where(mask, p * e_p + TINY32, 0.0)
        del s, sigma, x, arg, e_p
        rho = (do[b].to(f64) * o[b].to(f64)).abs().sum(-1)   # (Sq, H)
        T = torch.einsum("qgrd,sgd->grqs", doa.abs(), va.abs()) \
            + rho.T.reshape(G, R, Sq, 1)
        dp = torch.einsum("qgrd,sgd->grqs", doa, va)
        delta = (do[b].to(f64) * o[b].to(f64)).sum(-1).T.reshape(G, R, Sq, 1)
        ds = (p * (dp - delta)).abs()
        del dp
        E = (p + pe) * T * kk - p * T
        del T
        n = Sq * R
        m0 = torch.einsum("grqs,qgrd->sgd", p + pe, doa.abs())
        m1 = torch.einsum("grqs,qgrd->sgd", pe, doa.abs())
        bv[b] = m1 + (e_out + n * u) * m0 \
            + tiny * torch.einsum("qs,qgrd->sgd", maskd, doa.abs())
        A = torch.einsum("grqs,qgrd->sgd", E, qa.abs())
        C = torch.einsum("grqs,qgrd->sgd", ds, qa.abs())
        bk[b] = scale * (A + (e_out + (n + 2) * u) * (C + A) + tiny
                         * torch.einsum("qs,qgrd->sgd", maskd, qa.abs()))
        A = torch.einsum("grqs,sgd->qgrd", E, ka.abs()).reshape(Sq, H, D)
        C = torch.einsum("grqs,sgd->qgrd", ds, ka.abs()).reshape(Sq, H, D)
        km = torch.einsum("qs,sgd->qgd", maskd, ka.abs())
        km = km[:, :, None].expand(Sq, G, R, D).reshape(Sq, H, D)
        bq[b] = scale * (A + (e_out + (Skv + 2) * u) * (C + A) + tiny * km)
        del p, pe, E, ds, A, C, km
    if refs is None:
        return bq, bk, bv
    return tuple(bd + BF16_ROUND * (r.to(f64).abs() + bd)
                 for bd, r in zip((bq, bk, bv), refs))


def lse_error_bound(q, k, lse64, *, causal: bool = True,
                    window: Optional[int] = None):
    """Bound on |kernel's log-sum-exp - ``lse_ref`` in float64| per row,
    (B,H,Sq) float64, on float32 inputs (bfloat16 widened), ``lse64`` the
    float64 plain version. The kernel's scores are off by at most
    Delta_i (``error_bound``'s: 3xTF32 and the D-term sums; the bfloat16
    kernel's exact products, D-term sums and scale after the product are
    off by less), which moves
    a log-sum-exp by at most as much; its running sum over Skv keys in
    float32, the rescalings of each kv tile and expf's 2 ulp each move
    log l by at most (2 Skv + 8) u; the exponents' roundings u |s - m| by
    at most 2 u max|s|; logf and the final sum 4 u |lse|. Rows that see
    no key must be +inf on both sides: bound 0."""
    B, Sq, Skv, H, G, R, D = _groups(q, k)
    u = U32
    mask = _visible(Sq, Skv, causal, window, q.device)
    out = torch.empty((B, H, Sq), dtype=torch.float64, device=q.device)
    for b in range(B):
        qa = q[b].double().reshape(Sq, G, R, D).abs() * D ** -0.5
        sigma = torch.einsum("qgrd,sgd->grqs", qa, k[b].double().abs())
        sig_max = torch.where(mask, sigma, 0.0).amax(-1)   # (G,R,Sq)
        out[b] = ((PRODUCT_ERR + 2 * D * u) * sig_max
                  + 2 * u * sig_max).reshape(H, Sq)
    fin = torch.isfinite(lse64)
    return torch.where(fin, out + (2 * Skv + 8) * u
                       + 4 * u * torch.where(fin, lse64.abs(), 0.0), 0.0)


def _lib(dtype=torch.float32):
    """The forward kernel's C entry point for ``dtype``'s operands."""
    from repro_torch.kernels import build
    if dtype == torch.bfloat16:
        fn = build.load("flash_attention_bf16").flash_attention_bf16_fwd
    else:
        fn = build.load("flash_attention").flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


BF16_SHAPE_KEYS = ("head_dim_padded", "warpgroups", "q_rows", "kv_rows",
                   "stages", "load", "smem_bytes", "threads")
BF16_LOADS = ("tma", "cp.async", "registers")


def bf16_launch_shape(q, k, v) -> dict:
    """The launch the bfloat16 kernel makes for these CUDA tensors, as it
    reports it (``flash_attention_bf16_shape``): D padded, warpgroups, q
    rows a block, kv rows a tile, stages of its ring, how K and V land,
    shared memory bytes and threads a block."""
    from repro_torch.kernels import build
    fn = build.load("flash_attention_bf16").flash_attention_bf16_shape
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p]
    fn.restype = None
    out = (ctypes.c_int * len(BF16_SHAPE_KEYS))()
    fn(k.data_ptr(), v.data_ptr(), q.shape[1], q.shape[3], out)
    shape = dict(zip(BF16_SHAPE_KEYS, out))
    shape["load"] = BF16_LOADS[shape["load"]]
    return shape


def _bwd_lib(dtype=torch.float32):
    """The backward kernel's C entry point for ``dtype``'s operands."""
    from repro_torch.kernels import build
    if dtype == torch.bfloat16:
        fn = build.load("flash_attention_bwd_bf16").flash_attention_bwd_bf16
    else:
        fn = build.load("flash_attention_bwd").flash_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


BWD_BF16_SHAPE_KEYS = ("head_dim_padded", "stages", "load",
                       "dkdv_warpgroups", "dkdv_tile_rows", "dkdv_smem_bytes",
                       "dq_warpgroups", "dq_tile_rows", "dq_smem_bytes")


def bwd_bf16_launch_shape(q, k, v, do) -> dict:
    """The launches the bfloat16 backward kernel makes for these CUDA
    tensors, as it reports them (``flash_attention_bwd_bf16_shape``): D
    padded, stages of its ring, how the tiles land, then for the dK/dV
    pass and the dQ pass: warpgroups, streamed rows a tile (q rows in the
    first, kv rows in the second) and shared memory bytes a block."""
    from repro_torch.kernels import build
    fn = build.load("flash_attention_bwd_bf16").flash_attention_bwd_bf16_shape
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = None
    out = (ctypes.c_int * len(BWD_BF16_SHAPE_KEYS))()
    fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), q.shape[1],
       k.shape[1], q.shape[3], out)
    shape = dict(zip(BWD_BF16_SHAPE_KEYS, out))
    shape["load"] = BF16_LOADS[shape["load"]]
    return shape


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


def _forward(q, k, v, causal: bool, window: Optional[int], with_lse: bool):
    """One launch of the forward kernel: (o, lse or None)."""
    global LAUNCHES, WINDOW_LAUNCHES, BF16_LAUNCHES
    _check(q, k, v, window)
    B, Sq, H, D = q.shape
    Skv, G = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if q.device.type == "meta":
        META_OPS["forward"] += work(q.shape, Skv, causal, window)
        return out, lse
    err = _lib(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(),
                        None if lse is None else lse.data_ptr(),
                        B, Sq, Skv, H, G, D, int(causal), int(window or 0),
                        D ** -0.5,
                        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        why = "a TMA tensor map was refused" if err == -2 \
            else f"cudaError {err}"
        raise RuntimeError(f"flash_attention launch failed: {why}")
    LAUNCHES += 1
    WINDOW_LAUNCHES += window is not None
    BF16_LAUNCHES += q.dtype == torch.bfloat16
    return out, lse


def flash_attention_fwd_lse(q, k, v, *, causal: bool = True,
                            window: Optional[int] = None):
    """The forward kernel with its log-sum-exp: (o, lse (B,H,Sq) float32),
    no gradient. On a CPU tensor the plain versions."""
    if q.device.type == "cpu":
        return (flash_attention_ref(q, k, v, causal=causal, window=window),
                lse_ref(q, k, causal=causal, window=window))
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"no kernel for device {q.device}")
    refuse_grad("flash_attention_fwd_lse", q, k, v)
    return _forward(q, k, v, causal, window, True)


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True,
                        window: Optional[int] = None):
    """The gradient of ``flash_attention`` at (q, k, v) for the output
    gradient ``do``, given the forward's o and lse: (dq, dk, dv) in q's
    dtype. On a CUDA tensor it launches ``csrc/flash_attention_bwd.cu``
    (float32) or ``csrc/flash_attention_bwd_bf16.cu`` (bfloat16), or
    raises; on a CPU tensor it is ``flash_attention_bwd_ref``."""
    global BWD_LAUNCHES, BF16_BWD_LAUNCHES
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal,
                                       window=window)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k, v, window)
    for name, x in (("o", o), ("do", do)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {q.dtype} tensor "
                             f"of q's shape {tuple(q.shape)} on {q.device}")
    B, Sq, H, D = q.shape
    Skv, G = k.shape[1], k.shape[2]
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous float32 tensor of shape "
                         f"{(B, H, Sq)} on {q.device}")
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if q.device.type == "meta":
        META_OPS["backward"] += work(q.shape, Skv, causal, window, True)
        return dq, dk, dv
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    err = _bwd_lib(q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, Sq, Skv, H, G, D, int(causal),
        int(window or 0), D ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        why = "a TMA tensor map was refused" if err == -2 \
            else f"cudaError {err}"
        raise RuntimeError(f"flash_attention_bwd launch failed: {why}")
    BWD_LAUNCHES += 1
    BF16_BWD_LAUNCHES += q.dtype == torch.bfloat16
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """K3 with its gradient on CUDA tensors: the forward kernel writing
    the log-sum-exp, the backward kernel for the gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        o, lse = _forward(q, k, v, causal, window, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.contiguous(), lse,
                                         causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None):
    """q (B,Sq,H,D); k, v (B,Skv,G,D), all float32 or all bfloat16.
    Returns (B,Sq,H,D) in q's dtype. On a CUDA tensor that needs a
    gradient, through ``FlashAttentionFn``."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"no kernel for device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window)
    return _forward(q, k, v, causal, window, False)[0]
