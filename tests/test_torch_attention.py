"""Kernel K3 and the attention layer against the reference on the CPU.

- ``flash_attention`` (the plain version, which CPU tensors take) vs the
  reference's Pallas kernel in interpret mode (``ops.flash_attention``,
  with its small blocks so that it walks several kv tiles) and its
  oracle ``ref.flash_attention_ref``: causal and not, windows, GQA and
  ragged lengths.
- ``mha`` (with ``q_offset`` and chunk sizes below the sequence, so the
  reference streams over chunks), ``rope_freqs``, ``apply_rope`` and
  ``decode_attend`` (ring-buffer slots, empty slots, windows) vs
  ``repro/models/attention.py``.

Inputs are N(0,1) from numpy seeds. Tolerance: 2e-6 absolute against
the oracle (the same masked softmax, summed in another order), 1e-5
against the kernel and the chunked ``mha`` (online softmax rescales the
partial sums once per kv tile) and 2e-6 on RoPE (cos/sin of the same
float32 angles from two libraries).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.models import attention as RA
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import attention as PA
from _torch_threads import cap_torch_threads

cap_torch_threads()

CASES = (
    # B, Sq, Skv, H, G, D, bq, bk, causal, window
    (2, 64, 64, 4, 2, 32, 16, 16, True, None),
    (1, 100, 100, 4, 4, 64, 32, 32, True, None),
    (2, 64, 64, 8, 2, 32, 16, 16, True, 24),
    (1, 48, 48, 2, 1, 16, 16, 16, False, None),
    (2, 40, 40, 4, 2, 32, 16, 8, True, 16),
    (2, 37, 53, 4, 2, 16, 16, 16, False, None),     # ragged, Sq != Skv
    (1, 45, 70, 6, 3, 12, 16, 16, True, None),      # causal, Sq < Skv
    (1, 50, 50, 4, 4, 8, 16, 16, False, 9),         # window, not causal
)


def _qkv(B, Sq, Skv, H, G, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (B, Sq, H, D)).astype(np.float32),
            rng.normal(0, 1, (B, Skv, G, D)).astype(np.float32),
            rng.normal(0, 1, (B, Skv, G, D)).astype(np.float32))


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("case", CASES)
def test_flash_attention_matches_reference(case):
    B, Sq, Skv, H, G, D, bq, bk, causal, window = case
    q, k, v = _qkv(B, Sq, Skv, H, G, D)
    before = FA.LAUNCHES
    got = FA.flash_attention(*_t(q, k, v), causal=causal,
                             window=window).numpy()
    assert FA.LAUNCHES == before          # the CPU takes the plain version
    oracle = np.asarray(ref.flash_attention_ref(*_j(q, k, v), causal=causal,
                                                window=window))
    kernel = np.asarray(ops.flash_attention(*_j(q, k, v), causal=causal,
                                            window=window, block_q=bq,
                                            block_k=bk))
    assert got.shape == (B, Sq, H, D)
    np.testing.assert_allclose(got, oracle, rtol=0, atol=2e-6)
    np.testing.assert_allclose(got, kernel, rtol=0, atol=1e-5)


@pytest.mark.parametrize("causal,q_offset,G", [
    (True, 0, 4), (True, 0, 2), (False, 0, 1), (True, 24, 2)])
def test_mha_matches_reference(causal, q_offset, G):
    q, k, v = _qkv(2, 40, 64 if q_offset else 40, 4, G, 16, seed=1)
    got = PA.mha(*_t(q, k, v), causal=causal, q_offset=q_offset,
                 q_chunk=16, kv_chunk=16).numpy()
    want = np.asarray(RA.mha(*_j(q, k, v), causal=causal, q_offset=q_offset,
                             q_chunk=16, kv_chunk=16))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_rope_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 33, 4, 16)).astype(np.float32)
    pos = np.arange(33) + 1000
    for theta in (10_000.0, 1_000_000.0):
        np.testing.assert_allclose(PA.rope_freqs(16, theta).numpy(),
                                   np.asarray(RA.rope_freqs(16, theta)),
                                   rtol=2e-7, atol=0)
        got = PA.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            theta).numpy()
        want = np.asarray(RA.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                        theta))
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("window", (None, 5))
def test_decode_attend_matches_reference(window):
    rng = np.random.default_rng(3)
    B, Sc, H, G, D = 3, 12, 4, 2, 16
    q = rng.normal(0, 1, (B, 1, H, D)).astype(np.float32)
    kc = rng.normal(0, 1, (B, Sc, G, D)).astype(np.float32)
    vc = rng.normal(0, 1, (B, Sc, G, D)).astype(np.float32)
    # a ring buffer that has wrapped: slot s holds position 12 + s for
    # s < 3, s otherwise; slots 9.. are empty for the first row
    slot = np.tile(np.arange(Sc, dtype=np.int32), (B, 1))
    slot[:, :3] += 12
    slot[0, 9:] = -1
    cur = np.array([14, 14, 11], np.int32)
    got = PA.decode_attend(*_t(q, kc, vc, slot, cur), window=window).numpy()
    want = np.asarray(RA.decode_attend(*_j(q, kc, vc, slot, cur),
                                       window=window))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_attend_dispatch():
    q, k, v = _qkv(1, 24, 24, 4, 2, 16, seed=4)
    got = PA.attend(*_t(q, k, v), causal=True, window=None, q_chunk=8,
                    kv_chunk=8).numpy()
    want = np.asarray(RA.attend(*_j(q, k, v), causal=True, window=None,
                                q_chunk=8, kv_chunk=8))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # a window without causality goes to mha, which has no window
    got = PA.attend(*_t(q, k, v), causal=False, window=6).numpy()
    want = np.asarray(RA.attend(*_j(q, k, v), causal=False, window=6))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # a causal window takes the banded path: chunks of at most the window
    # past 2W queries (24 > 2 * 6), else of at most Sq
    for window in (6, 16, 30):
        got = PA.attend(*_t(q, k, v), causal=True, window=window, q_chunk=8,
                        kv_chunk=8).numpy()
        want = np.asarray(RA.attend(*_j(q, k, v), causal=True,
                                    window=window, q_chunk=8, kv_chunk=8))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ------------------------------------------- the kernel's 3xTF32 numbers ----
# the card tests' K3 shapes (tests/test_torch_cuda.py) and a stress case
K3_SHAPES = (
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


def _stress_qkv(seed=0):
    B, Sq, Skv, H, G, D, _, _ = STRESS
    rng = np.random.default_rng(seed)
    return _t(rng.uniform(-8, 8, (B, Sq, H, D)).astype(np.float32),
              rng.uniform(-8, 8, (B, Skv, G, D)).astype(np.float32),
              rng.normal(0, 1, (B, Skv, G, D)).astype(np.float32))


def _tf32_rna(x):
    """Round-to-nearest, ties away from zero, to 10 mantissa bits, by
    float64 arithmetic on the significand."""
    x = np.float64(x)
    if not np.isfinite(x) or x == 0:
        return x
    m, e = np.frexp(x)                      # x = m * 2^e, 0.5 <= |m| < 1
    scaled = m * 2.0 ** 11                  # 11 significant bits
    r = np.sign(scaled) * np.floor(np.abs(scaled) + 0.5)
    return float(np.float32(np.ldexp(r, e - 11)))


def test_tf32_round_is_rna():
    """``tf32_round`` against round-to-nearest-ties-away on values at,
    beside and between TF32 neighbours, signs, infinities and zeros."""
    ulp = 2.0 ** -10
    xs = [0.0, -0.0, 1.0, -1.0, float("inf"), float("-inf"), 3.14159,
          -2.71828, 1e-30, -1e30, 65504.0, 3.0e38]
    for k in range(6):
        for frac in (0.5, 0.25, 0.75, 0.4999, 0.5001):
            xs += [1.0 + (k + frac) * ulp, -(1.0 + (k + frac) * ulp)]
    xs += list(np.random.default_rng(0).normal(0, 100, 200))
    x = torch.tensor(np.array(xs, np.float32))
    got = FA.tf32_round(x).numpy()
    want = np.array([_tf32_rna(v) for v in x.numpy()], np.float32)
    np.testing.assert_array_equal(got, want)
    # the low 13 bits are clear, and the split is exact in float32
    assert not (FA.tf32_round(x).view(torch.int32) & 0x1FFF).any()
    big = FA.tf32_round(x[torch.isfinite(x)])
    small = FA.tf32_round(x[torch.isfinite(x)] - big)
    resid = (x[torch.isfinite(x)] - big - small).abs()
    assert bool((resid <= 2.0 ** -22 * x[torch.isfinite(x)].abs()).all())


@pytest.mark.parametrize("case", K3_SHAPES + (STRESS,))
def test_tf32_model_within_error_bound(case):
    """The float64 model of the kernel's 3xTF32 arithmetic lies within
    ``error_bound`` of the plain version (float32) on the card tests'
    shapes and the stress case."""
    B, Sq, Skv, H, G, D, causal, window = case
    q, k, v = _stress_qkv() if case == STRESS else \
        _t(*_qkv(B, Sq, Skv, H, G, D, seed=5))
    want = FA.flash_attention_ref(q, k, v, causal=causal,
                                  window=window).double()
    bound = FA.error_bound(q, k, v, causal=causal, window=window)
    assert bound.shape == (B, Sq, H, 1)
    model = FA.attention_tf32(q, k, v, causal=causal, window=window)
    assert bool(((model - want).abs() <= bound).all())


@pytest.mark.parametrize("case", (STRESS, K3_SHAPES[0], K3_SHAPES[-1]))
def test_error_bound_is_not_vacuous(case):
    """Plain TF32 products (one pass, about 2^-11 per operand) break the
    bound that 3xTF32 meets."""
    B, Sq, Skv, H, G, D, causal, window = case
    q, k, v = _stress_qkv() if case == STRESS else \
        _t(*_qkv(B, Sq, Skv, H, G, D, seed=5))
    want = FA.flash_attention_ref(q, k, v, causal=causal,
                                  window=window).double()
    bound = FA.error_bound(q, k, v, causal=causal, window=window)
    one = FA.attention_tf32(q, k, v, causal=causal, window=window, passes=1)
    assert float(((one - want).abs() / bound).max()) > 1.0
