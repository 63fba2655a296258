"""Kernel K4's bfloat16 arithmetic against the reference on the CPU.

The bfloat16 kernels (``csrc/ssd_scan_bf16.cu``) run C.B^T as one bf16
product on the values as they are (exact products, float32 sums) and the
three products with a float32 operand (the decayed x times B, the
weights times x, C times S_in) as two, that operand split into two
bfloat16 parts. ``ssd_scan_bf16`` is a float64 model of that arithmetic;
these tests hold it, on bfloat16 inputs drawn from numpy seeds, to
``error_bound``'s bfloat16 terms against the exact scan (the plain
version in float64 on the widened inputs), on mamba2-like (P 64, N 128),
hymba-like (N 16), S % Q != 0, G > 1, Q 16 and state-in cases. The bound
is not vacuous: with one bfloat16 part (2^-8 a split value) the model
breaks it. The float32 bound is unchanged.

Against the reference: the model against ``repro.kernels.ops.ssd_scan``
(the Pallas kernel in interpret mode, y) and ``repro.models.ssd.ssd_scan``
(y and the final state) on the same bfloat16 values, widened. Both
compute in float32 on the CPU, within the float32 kernels' bound of the
exact scan (their sums are as long; their products no worse than
3xTF32's), so the tolerance is the sum of the two bounds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.models import ssd as RS
from repro_torch.kernels import ssd as K
from repro_torch.kernels.flash_attention import P_SPLIT_ERR, PRODUCT_ERR
from _torch_threads import cap_torch_threads

cap_torch_threads()

CASES = (                   # B, S, H, P, G, N, chunk, state in
    (1, 192, 2, 64, 1, 128, 64, False),      # mamba2-like widths
    (2, 128, 5, 64, 1, 16, 64, False),       # hymba-like: N 16
    (2, 100, 4, 16, 1, 32, 64, False),       # S % Q != 0
    (1, 96, 6, 16, 3, 32, 32, True),         # G > 1, a state in
    (2, 70, 4, 16, 2, 16, 16, False),        # Q 16
    (1, 130, 4, 32, 2, 64, 64, True),        # a state in, ragged
)
IDS = ["B{}_S{}_H{}_P{}_G{}_N{}_Q{}{}".format(*c[:7], "_init" * c[7])
       for c in CASES]
U32 = 2.0 ** -24


def _bf16_inputs(B, S, H, P, G, N, seed=3):
    """x, dt, A, Bm, Cm and a state, drawn as the model draws them (dt =
    softplus(dt_bias + z), A = -U[1, 16]); x, Bm, Cm, dt and the state
    rounded to bfloat16 (the model's bfloat16 prefill passes dt so), A
    float32."""
    rng = np.random.default_rng(seed)
    dt_bias = np.log(np.expm1(1e-3 + (1e-1 - 1e-3) * rng.random(H)))
    dt = np.log1p(np.exp(dt_bias + rng.standard_normal((B, S, H))))
    bf = torch.bfloat16

    def t(a, dtype=bf):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)
    return (t(rng.standard_normal((B, S, H, P))), t(dt),
            t(-(1.0 + 15.0 * rng.random(H)), torch.float32),
            t(rng.standard_normal((B, S, G, N))),
            t(rng.standard_normal((B, S, G, N))),
            t(rng.standard_normal((B, H, P, N)) * 0.5))


def _case(case, seed=3):
    B, S, H, P, G, N, chunk, with_init = case
    x, dt, A, Bm, Cm, init = _bf16_inputs(B, S, H, P, G, N, seed)
    return (x, dt, A, Bm, Cm), chunk, init if with_init else None


def _exact(args, chunk, init):
    return K.ssd_scan_ref(*(a.double() for a in args), chunk=chunk,
                          init_state=None if init is None else init.double())


def _shares(args, chunk, init, parts):
    """The model's largest error on y and on the state as shares of the
    bfloat16 bound."""
    exact_y, exact_state = _exact(args, chunk, init)
    tol_y, tol_state = K.error_bound(*args, chunk=chunk, init_state=init)
    y, state = K.ssd_scan_bf16(*args, chunk=chunk, init_state=init,
                               parts=parts)
    assert y.dtype == state.dtype == torch.float64
    return (float((y - exact_y).abs().max()) / tol_y,
            float((state - exact_state).abs().max()) / tol_state)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bf16_model_within_error_bound(case):
    """The float64 model of the bfloat16 kernels (two bfloat16 parts)
    lies within ``error_bound``'s bfloat16 terms of the exact scan, y and
    the final state."""
    args, chunk, init = _case(case)
    assert max(_shares(args, chunk, init, parts=2)) <= 1.0


@pytest.mark.parametrize("case", CASES[:3], ids=IDS[:3])
def test_bf16_error_bound_is_not_vacuous(case):
    """One bfloat16 part (hi alone: 2^-8 of each split value) breaks the
    bound that two parts meet: the second parts are what the bound
    allows for, not slack."""
    args, chunk, init = _case(case)
    assert max(_shares(args, chunk, init, parts=1)) > 1.0


def test_bf16_bound_terms_and_float32_bound_unchanged():
    """bfloat16 x takes the bfloat16 kernels' product term, 2 P_SPLIT_ERR
    / u in L for 3xTF32's 2 PRODUCT_ERR / u, on the same M; float32 x
    keeps the float32 bound bit for bit, u L M with L = N + 3 S' + 32
    Lambda + 16 + 2 PRODUCT_ERR / u."""
    B, S, H, P, G, N, chunk = 2, 90, 4, 16, 2, 32, 32
    args, _, init = _case((B, S, H, P, G, N, chunk, True), seed=7)
    wide = [a.float() for a in args]
    b16 = K.error_bound(*args, chunk=chunk, init_state=init)
    b32 = K.error_bound(*wide, chunk=chunk, init_state=init.float())
    la = (wide[1].double() * wide[2].double()).abs()
    nc = -(-S // chunk)
    la = torch.nn.functional.pad(la, (0, 0, 0, nc * chunk - S))
    lam = float(la.reshape(B, nc, chunk, H).sum(2).max())
    mag_y, mag_state = K.ssd_scan_ref(
        *(a.double().abs() if i not in (1, 2) else a.double()
          for i, a in enumerate(wide)), chunk=chunk,
        init_state=init.double().abs())
    L = N + 3 * nc * chunk + 32 * lam + 16 + 2 * PRODUCT_ERR / U32
    assert b32 == (U32 * L * float(mag_y.max()),
                   U32 * L * float(mag_state.max()))
    for got, want, m in zip(b16, b32, (mag_y, mag_state)):
        assert got > want
        assert got - want == pytest.approx(
            2 * (P_SPLIT_ERR - PRODUCT_ERR) * float(m.max()), rel=1e-12)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bf16_model_matches_reference(case):
    """The model against the reference's chunked scan (y and the final
    state) and its Pallas kernel in interpret mode (y) on the same
    bfloat16 values, within the sum of the bfloat16 and float32 bounds
    (see the module's docstring)."""
    args, chunk, init = _case(case)
    y, state = K.ssd_scan_bf16(*args, chunk=chunk, init_state=init)
    wide = [a.float() for a in args]
    init_w = None if init is None else init.float()
    b16 = K.error_bound(*args, chunk=chunk, init_state=init)
    b32 = K.error_bound(*wide, chunk=chunk, init_state=init_w)
    tol_y, tol_state = b16[0] + b32[0], b16[1] + b32[1]
    jargs = [jnp.asarray(a.numpy()) for a in wide]
    r_y, r_state = RS.ssd_scan(*jargs, chunk=chunk, init_state=(
        None if init_w is None else jnp.asarray(init_w.numpy())))
    assert float((y - torch.from_numpy(np.array(r_y)).double())
                 .abs().max()) <= tol_y
    assert float((state - torch.from_numpy(np.array(r_state)).double())
                 .abs().max()) <= tol_state
    if init is None:                # the Pallas kernel takes no state in
        p_y = ref_ops.ssd_scan(*jargs, chunk=chunk)
        assert float((y - torch.from_numpy(np.array(p_y)).double())
                     .abs().max()) <= tol_y


@pytest.mark.parametrize("case", CASES[2:4], ids=IDS[2:4])
def test_bf16_passes_compose_to_the_model(case):
    """The model is the five passes' plain versions with the bfloat16
    products (``_prod``'s "bf16x2"), and C.B^T in it is the exact product
    of the bfloat16 values: the kernels' pass 2 has no rounding but its
    float32 sum."""
    args, chunk, init = _case(case)
    y, state = K.ssd_scan_bf16(*args, chunk=chunk, init_state=init)
    y2, state2 = K.ssd_scan_passes(
        *(a.double() for a in args), chunk=chunk,
        init_state=None if init is None else init.double(), passes="bf16x2")
    assert torch.equal(y, y2) and torch.equal(state, state2)
    Bm, Cm = args[3], args[4]
    assert torch.equal(K.bmm_ref(Bm.double(), Cm.double(), chunk=chunk,
                                 passes="bf16x2"),
                       K.bmm_ref(Bm.double(), Cm.double(), chunk=chunk))
