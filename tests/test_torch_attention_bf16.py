"""Kernel K3's bfloat16 arithmetic against the reference on the CPU.

The bfloat16 kernel (``csrc/flash_attention_bf16.cu``) runs S = q K^T as
one bf16 product on the unscaled values, scales S after the product in
float32, and runs P V as two, P split into two bfloat16 parts.
``attention_bf16`` is a float64 model of that arithmetic; these tests hold
it, on bfloat16 inputs drawn from numpy seeds, to ``error_bound``'s
bfloat16 terms against:

- the reference's Pallas kernel in interpret mode
  (``repro.kernels.ops.flash_attention`` on the widened float32 inputs,
  with small blocks so that it walks several kv tiles), and
- the port's plain version (``flash_attention_ref`` on the widened
  inputs, float32),

on the cases of ``test_tf32_model_within_error_bound``: GQA, windows, D
= 8, 12, 16, 64 and 128, ragged Sq and Skv, and the stress case. The
bound is not vacuous: with P in one bfloat16 part (2^-8 a weight) the
model breaks it. The split itself is a property over float32 p in [0, 1];
and at D = 128, where the scale 128^-0.5 is not a power of two, scaling
the exact-product scores after the product stays within the bound's
score term of the reference's scale-first scores.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ops
from repro_torch.kernels import flash_attention as FA
from _torch_threads import cap_torch_threads

cap_torch_threads()

CASES = (
    # B, Sq, Skv, H, G, D, causal, window
    (2, 300, 300, 8, 2, 64, True, None),
    (2, 200, 333, 4, 4, 16, False, None),
    (1, 130, 197, 4, 2, 64, True, None),
    (1, 500, 500, 8, 4, 64, True, 32),
    (1, 600, 600, 4, 2, 64, True, 256),
    (4, 77, 77, 4, 4, 12, False, 32),
    (3, 130, 130, 4, 1, 128, True, None),
    (30, 16, 16, 4, 4, 8, True, None),
)
STRESS = (1, 256, 256, 4, 2, 64, True, None)        # |q|, |k| up to 8
U32 = 2.0 ** -24


def _bf16_qkv(B, Sq, Skv, H, G, D, seed=5, stress=False):
    """bfloat16 q, k, v from numpy draws: N(0, 1), or |q|, |k| up to 8."""
    rng = np.random.default_rng(seed)
    if stress:
        q = rng.uniform(-8, 8, (B, Sq, H, D))
        k = rng.uniform(-8, 8, (B, Skv, G, D))
    else:
        q = rng.normal(0, 1, (B, Sq, H, D))
        k = rng.normal(0, 1, (B, Skv, G, D))
    v = rng.normal(0, 1, (B, Skv, G, D))
    return [torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
            for x in (q, k, v)]


def _inputs(case):
    return _bf16_qkv(*case[:6], stress=case == STRESS)


@pytest.mark.parametrize("case", CASES + (STRESS,))
def test_bf16_model_within_error_bound(case):
    """The float64 model of the bfloat16 kernel lies within the bfloat16
    ``error_bound`` of the plain version (float32, on the widened
    inputs) and of the reference's Pallas kernel in interpret mode."""
    B, Sq, Skv, H, G, D, causal, window = case
    q, k, v = _inputs(case)
    bound = FA.error_bound(q, k, v, causal=causal, window=window)
    assert bound.shape == (B, Sq, H, 1)
    model = FA.attention_bf16(q, k, v, causal=causal, window=window)
    wide = [x.float() for x in (q, k, v)]
    plain = FA.flash_attention_ref(*wide, causal=causal,
                                   window=window).double()
    assert bool(((model - plain).abs() <= bound).all())
    pallas = torch.from_numpy(np.asarray(ops.flash_attention(
        *[jnp.asarray(x.numpy()) for x in wide], causal=causal,
        window=window, block_q=64, block_k=64))).double()
    assert bool(((model - pallas).abs() <= bound).all())


@pytest.mark.parametrize("case", (CASES[0], CASES[5], CASES[7]))
def test_bf16_error_bound_is_not_vacuous(case):
    """P in one bfloat16 part (one bf16 product for PV, 2^-8 a weight)
    breaks the bound that two parts meet."""
    B, Sq, Skv, H, G, D, causal, window = case
    q, k, v = _inputs(case)
    plain = FA.flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=causal, window=window).double()
    bound = FA.error_bound(q, k, v, causal=causal, window=window)
    one = FA.attention_bf16(q, k, v, causal=causal, window=window, parts=1)
    assert float(((one - plain).abs() / bound).max()) > 1.0


def test_bf16_bound_terms_differ_from_float32():
    """bfloat16 inputs take the bfloat16 kernel's terms: exact products
    make the score term smaller, P's split makes the output term larger,
    so neither bound is the other's."""
    q, k, v = _bf16_qkv(1, 64, 64, 2, 2, 8, seed=1)
    b16 = FA.error_bound(q, k, v)
    b32 = FA.error_bound(q.float(), k.float(), v.float())
    assert not torch.equal(b16, b32)
    vmax = float(v.float().abs().max())
    assert float(b16.min()) >= FA.P_SPLIT_ERR * vmax


@settings(max_examples=500, deadline=None)
@given(st.floats(0.0, 1.0, width=32))
def test_bf16_split_property(p):
    """hi and lo are bfloat16 values and hi + lo is p within 2^-16 p for
    p >= 2^-118 (hi off by at most 2^-8 p, p - hi exact, lo off by at
    most 2^-8 of it), and within 2^-16 p + 2^-133 for every p: below
    bfloat16's normal range each part's rounding is at most half the
    subnormals' spacing of 2^-133."""
    x = torch.tensor([p], dtype=torch.float32)
    hi, lo = FA.bf16_split(x)
    for part in (hi, lo):
        assert torch.equal(part.to(torch.bfloat16).float(), part)
    err = abs(float(x.double() - hi.double() - lo.double()))
    assert err <= 2.0 ** -16 * p + 2.0 ** -133
    if p >= 2.0 ** -118:
        assert err <= 2.0 ** -16 * p


def test_bf16_scale_after_product_at_d128():
    """At D = 128 the scale 128^-0.5 is not a power of two. The kernel's
    scores, float32 sums of exact products scaled after, and the
    reference's, float32 sums of (q * scale) k, lie within the bound's
    score term (2 D + 1) 2^-24 of the scaled sum of |q_d k_d| of each
    other and of the exact scores; the model built on them stays within
    ``error_bound`` of the plain version."""
    B, Sq, Skv, H, G, D = 2, 96, 80, 4, 2, 128
    q, k, v = _bf16_qkv(B, Sq, Skv, H, G, D, seed=9)
    scale = D ** -0.5
    assert scale * 2 ** 4 != round(scale * 2 ** 4)
    qg = q.float().reshape(B, Sq, G, H // G, D)
    kf = k.float()
    eq = "bqgrd,bsgd->bgrqs"
    after = torch.einsum(eq, qg, kf) * torch.tensor(scale)
    first = torch.einsum(eq, qg * scale, kf)
    exact = torch.einsum(eq, qg.double(), kf.double()) * scale
    sigma = torch.einsum(eq, qg.double().abs(), kf.double().abs()) * scale
    term = (2 * D + 1) * U32 * sigma
    assert after.dtype == first.dtype == torch.float32
    assert bool(((after.double() - first.double()).abs() <= term).all())
    assert bool(((after.double() - exact).abs() <= term).all())
    model = FA.attention_bf16(q, k, v, causal=True)
    plain = FA.flash_attention_ref(q.float(), kf, v.float(),
                                   causal=True).double()
    bound = FA.error_bound(q, k, v, causal=True)
    assert bool(((model - plain).abs() <= bound).all())
