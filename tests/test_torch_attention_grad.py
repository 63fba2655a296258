"""The gradient of the port's attention on the CPU.

- Autograd through the port's ``flash_attention_ref`` (K3's plain
  version, what CPU tensors take), ``models.attention.mha`` and
  ``banded_mha`` against ``jax.grad`` through the reference's
  ``ref.flash_attention_ref``, ``mha`` (chunked, so the reference's
  gradient goes through its streaming scans) and ``banded_mha``: causal,
  windowed, non-causal with Sq != Skv, GQA with R > 1, D of 64 and 128.
  The loss is sum(o * w) for a fixed random w, so every element of the
  output carries its own cotangent. Tolerance: 1e-5 absolute on each
  gradient (float32 sums in other orders, the reference's online
  softmax rescaling its partial sums once per chunk).
- ``flash_attention_bwd_ref`` (the written-out backward the kernel is
  held to on the card) against autograd through ``flash_attention_ref``,
  both in float64, given ``lse_ref``: within 1e-10, including rows that
  see no key (no gradient to their q, nothing to k and v, no NaN).
- ``attention_bwd_tf32``, the float64 model of the float32 backward
  kernel's 3xTF32 arithmetic, within ``bwd_error_bound`` of
  ``flash_attention_bwd_ref`` at the card tests' shapes (rows cut to at
  most 300); one TF32 product (``passes=1``) breaks the bound, so it is
  not vacuous. The bfloat16 kernel's arithmetic is
  ``tests/test_torch_attention_bwd_bf16.py``'s.

Inputs are N(0,1) from numpy seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.models import attention as RA
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import attention as PA
from _torch_threads import cap_torch_threads

cap_torch_threads()

TOL = 1e-5
TOL64 = 1e-10

CASES = (
    # B, Sq, Skv, H, G, D, causal, window
    (2, 48, 48, 4, 4, 64, True, None),          # causal
    (2, 40, 40, 8, 2, 64, True, 12),            # window, GQA R = 4
    (1, 37, 53, 4, 2, 64, False, None),         # Sq != Skv, not causal
    (1, 33, 33, 6, 3, 128, True, None),         # D = 128, R = 2
    (1, 32, 32, 4, 1, 128, True, 9),            # D = 128, window, MQA
)


def _inputs(B, Sq, Skv, H, G, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, D), dtype=np.float32)
    k = rng.standard_normal((B, Skv, G, D), dtype=np.float32)
    v = rng.standard_normal((B, Skv, G, D), dtype=np.float32)
    w = rng.standard_normal((B, Sq, H, D), dtype=np.float32)
    return q, k, v, w


def _ref_grads(fn, q, k, v, w):
    g = jax.jit(jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) * w),
                         argnums=(0, 1, 2)))(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v))
    return [np.asarray(x) for x in g]


def _port_grads(fn, q, k, v, w, dtype=torch.float32):
    t = [torch.tensor(x, dtype=dtype, requires_grad=True) for x in (q, k, v)]
    out = fn(*t)
    g = torch.autograd.grad((out * torch.tensor(w, dtype=dtype)).sum(), t)
    return [x.numpy() for x in g]


def _close(got, want, tol):
    for name, a, b in zip("qkv", got, want):
        err = float(np.abs(a - b).max())
        assert err <= tol, (name, err)


@pytest.mark.parametrize("case", CASES)
def test_plain_version_grads_match_reference(case):
    B, Sq, Skv, H, G, D, causal, window = case
    q, k, v, w = _inputs(B, Sq, Skv, H, G, D, 0)
    want = _ref_grads(lambda q, k, v: ref.flash_attention_ref(
        q, k, v, causal=causal, window=window), q, k, v, w)
    got = _port_grads(lambda q, k, v: FA.flash_attention_ref(
        q, k, v, causal=causal, window=window), q, k, v, w)
    _close(got, want, TOL)
    # the wrapper takes the plain version on the CPU, gradient and all
    via = _port_grads(lambda q, k, v: FA.flash_attention(
        q, k, v, causal=causal, window=window), q, k, v, w)
    _close(via, got, 0.0)


@pytest.mark.parametrize("case", [c for c in CASES if c[6] or c[1] != c[2]])
def test_model_attention_grads_match_reference(case):
    """``mha`` (no window: the reference chunks by 16) and, for a causal
    window, ``banded_mha`` (the reference's band over chunks of 8)."""
    B, Sq, Skv, H, G, D, causal, window = case
    q, k, v, w = _inputs(B, Sq, Skv, H, G, D, 1)
    if window is None:
        want = _ref_grads(lambda q, k, v: RA.mha(
            q, k, v, causal=causal, q_chunk=16, kv_chunk=16), q, k, v, w)
        got = _port_grads(lambda q, k, v: PA.mha(
            q, k, v, causal=causal, q_chunk=16, kv_chunk=16), q, k, v, w)
    else:
        want = _ref_grads(lambda q, k, v: RA.banded_mha(
            q, k, v, window=window, q_chunk=8), q, k, v, w)
        got = _port_grads(lambda q, k, v: PA.banded_mha(
            q, k, v, window=window, q_chunk=8), q, k, v, w)
    _close(got, want, TOL)


BWD_CASES = CASES + (
    (1, 40, 12, 4, 2, 16, False, 5),    # rows 16.. see no key
    (2, 30, 10, 2, 1, 8, True, 3),      # causal window past Skv: rows 12..
)


@pytest.mark.parametrize("case", BWD_CASES)
def test_bwd_ref_matches_autograd_in_float64(case):
    B, Sq, Skv, H, G, D, causal, window = case
    q, k, v, w = (torch.tensor(x, dtype=torch.float64)
                  for x in _inputs(B, Sq, Skv, H, G, D, 2))
    t = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = FA.flash_attention_ref(*t, causal=causal, window=window)
    want = torch.autograd.grad((o * w).sum(), t)
    lse = FA.lse_ref(q, k, causal=causal, window=window)
    got = FA.flash_attention_bwd_ref(q, k, v, o.detach(), w, lse,
                                     causal=causal, window=window)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == torch.float64
        assert bool(torch.isfinite(a).all()), name
        err = float((a - b).abs().max())
        assert err <= TOL64, (name, err)
    blind = ~FA._visible(Sq, Skv, causal, window, q.device).any(-1)
    if window is not None and Sq > Skv + window:
        assert bool(blind.any())
        # no key: output 0, lse +inf, no gradient to q; and k, v get
        # nothing from those rows (the same gradient without them)
        assert float(o.detach()[:, blind].abs().max()) == 0.0
        assert bool(torch.isinf(lse[:, :, blind]).all())
        assert float(got[0][:, blind].abs().max()) == 0.0
        w2 = w.clone()
        w2[:, blind] = 0
        o2 = FA.flash_attention_ref(q, k, v, causal=causal, window=window)
        again = FA.flash_attention_bwd_ref(q, k, v, o2, w2, lse,
                                           causal=causal, window=window)
        assert torch.equal(again[1], got[1]) and torch.equal(again[2],
                                                             got[2])


@pytest.mark.parametrize("window", (None, 1, 3, 8))
@pytest.mark.parametrize("causal", (True, False))
def test_sees_no_key_reads_the_mask_from_the_positions(causal, window):
    # the plain version zeroes rows that see no key only when this host
    # test says there are some: it must agree with the mask itself
    for Sq in range(0, 12):
        for Skv in range(1, 12):
            for q_offset in range(-3, 12):
                qp = q_offset + torch.arange(Sq)[:, None]
                kp = torch.arange(Skv)[None, :]
                mask = torch.ones((Sq, Skv), dtype=torch.bool)
                if causal:
                    mask &= kp <= qp
                if window is not None:
                    mask &= kp > qp - window
                want = not bool(mask.any(-1).all())
                assert FA.sees_no_key(Sq, Skv, causal, window,
                                      q_offset) == want, \
                    (Sq, Skv, q_offset)


def test_bwd_wrapper_on_the_cpu_is_the_plain_version():
    q, k, v, w = (torch.tensor(x) for x in _inputs(2, 20, 20, 4, 2, 16, 3))
    o, lse = FA.flash_attention_fwd_lse(q, k, v, causal=True, window=6)
    assert lse.shape == (2, 4, 20) and lse.dtype == torch.float32
    before = FA.BWD_LAUNCHES
    got = FA.flash_attention_bwd(q, k, v, o, w, lse, causal=True, window=6)
    want = FA.flash_attention_bwd_ref(q, k, v, o, w, lse, causal=True,
                                      window=6)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert FA.BWD_LAUNCHES == before


# tests/test_torch_cuda.py's K3_BWD_CASES, rows cut to at most 300
MODEL_CASES = (
    # B, Sq, Skv, H, G, D, causal, window
    (2, 300, 300, 8, 2, 64, True, None),
    (2, 200, 300, 4, 4, 16, False, None),
    (1, 300, 300, 8, 4, 64, True, 32),
    (3, 130, 130, 4, 1, 128, True, None),
    (1, 300, 300, 4, 2, 128, True, 100),
    (1, 90, 20, 2, 1, 32, False, 8),            # rows 27.. see no key
    (1, 300, 300, 4, 4, 64, False, None),       # whisper's encoder, cut
    (1, 77, 93, 10, 2, 32, True, 20),           # R = 5, ragged rows
    (1, 70, 50, 3, 3, 12, False, None),         # D = 12 in a 16-wide tile
    (1, 100, 100, 4, 2, 40, True, None),        # D = 40 in a 64-wide tile
)


def _bwd_inputs(case, seed):
    """q, k, v, do, the plain forward's o and lse (float32, as the
    forward kernel writes them) and the plain backward in float64."""
    B, Sq, Skv, H, G, D, causal, window = case
    rng = np.random.default_rng(seed)
    q, do = (torch.tensor(rng.standard_normal((B, Sq, H, D),
                                              dtype=np.float32))
             for _ in range(2))
    k, v = (torch.tensor(rng.standard_normal((B, Skv, G, D),
                                             dtype=np.float32))
            for _ in range(2))
    o, lse = FA.flash_attention_fwd_lse(q, k, v, causal=causal,
                                        window=window)
    ref = FA.flash_attention_bwd_ref(*(x.double() for x in (q, k, v, o, do)),
                                     lse.double(), causal=causal,
                                     window=window)
    return (q, k, v, o, do, lse), ref


def _model(args, case, passes):
    return FA.attention_bwd_tf32(*args, causal=case[6], window=case[7],
                                 passes=passes)


def _bound(args, case, **kw):
    return FA.bwd_error_bound(*args, causal=case[6], window=case[7], **kw)


def _ratio(got, want, bound):
    """The largest |got - want| / bound, 0 where the two agree (a kv row
    that no query sees: no gradient and a bound of 0)."""
    err = (got - want).abs()
    return float(torch.where(err == 0, 0.0, err / bound).max())


@pytest.mark.parametrize("case", MODEL_CASES)
def test_bwd_model_within_its_bound(case):
    args, ref = _bwd_inputs(case, 5)
    bound = _bound(args, case)
    for name, got, want, c in zip("qkv", _model(args, case, 3), ref, bound):
        assert bool(torch.isfinite(got).all()), name
        ratio = _ratio(got, want, c)
        assert ratio <= 1.0, (name, ratio)


@pytest.mark.parametrize("case", MODEL_CASES[:2] + MODEL_CASES[3:4])
def test_bwd_bound_is_not_vacuous(case):
    # one TF32 product (about 2^-11 of each operand) breaks the bound
    args, ref = _bwd_inputs(case, 6)
    bound = _bound(args, case)
    worst = max(_ratio(got, want, c)
                for got, want, c in zip(_model(args, case, 1), ref, bound))
    assert worst > 1.0, worst

