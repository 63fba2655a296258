"""Kernel K4's plain path and the port's ``models/ssd.py`` against the
reference on the CPU, on inputs drawn with numpy from seeds.

- ``kernels/ssd.ssd_scan`` on CPU tensors (its plain version, the
  chunked form) against ``repro.models.ssd.ssd_scan`` (y and the final
  state, with and without ``init_state``), against the Pallas kernel
  ``repro.kernels.ops.ssd_scan`` in interpret mode (y; the Pallas kernel
  emits no state) and against the sequential oracle ``ssd_ref`` of both
  packages, on ``tests/test_kernels.py``'s four shapes (uneven S and
  G > 1 among them);
- ``ssd_decode_step``, ``causal_conv`` and ``causal_conv_step`` against
  the reference;
- the plain version in float64, and the state carried across two calls;
- the plain versions of the kernel's five passes (``cumsum_ref``,
  ``bmm_ref``, ``chunk_state_ref``, ``state_passing_ref``,
  ``chunk_scan_ref``), composed, against ``ssd_scan_ref`` and the
  reference's chunked scan;
- the restated ``error_bound`` against the float64 model of the
  kernel's 3xTF32 arithmetic (``ssd_scan_tf32``): the model lies within
  it, and the same model with plain TF32 products (one pass) does not,
  so the bound is not vacuous.

Tolerances: 1e-5 times max(1, the largest magnitude of the expected
output) against the reference's chunked scan and its decode step and
convolutions (the same float32 arithmetic; XLA's cumsum and einsums sum
in other orders than PyTorch's, a few float32 ulps of outputs up to
about 4 here); 2e-3 absolute against the
Pallas kernel (``test_kernels.py``'s own); 1e-4 between the chunked
scan and the sequential oracle (float32, up to 64 steps of a decaying
recurrence against one chunked sum, on outputs of magnitude up to about
10); 1e-10 between the two in float64.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.models import ssd as RS
from repro_torch.kernels import ssd as K
from repro_torch.models import ssd as PS
from _torch_threads import cap_torch_threads

cap_torch_threads()

SHAPES = [                   # B, S, H, P, G, N, chunk (test_kernels.py's)
    (2, 64, 4, 16, 2, 32, 8),
    (1, 48, 2, 8, 1, 16, 16),
    (2, 64, 4, 16, 2, 32, 64),
    (1, 33, 3, 8, 3, 16, 8),     # uneven seq / groups
]
IDS = ["B{}_S{}_H{}_P{}_G{}_N{}_Q{}".format(*s) for s in SHAPES]
TOL = 1e-5
PALLAS_TOL = 2e-3
SEQ_TOL = 1e-4


def _inputs(B, S, H, P, G, N, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {
        "x": (rng.standard_normal((B, S, H, P)) * 0.5).astype(dtype),
        "dt": np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(dtype),
        "A": (-np.exp(rng.standard_normal(H) * 0.3)).astype(dtype),
        "Bm": (rng.standard_normal((B, S, G, N)) * 0.3).astype(dtype),
        "Cm": (rng.standard_normal((B, S, G, N)) * 0.3).astype(dtype),
        "init": (rng.standard_normal((B, H, P, N)) * 0.5).astype(dtype),
    }


def _args(d, lib):
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    return [conv(d[k]) for k in ("x", "dt", "A", "Bm", "Cm")]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol)


def _near(got, want):
    """Within TOL of the expected output's scale (see the docstring)."""
    want = np.asarray(want)
    _close(got, want, TOL * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("with_init", [False, True], ids=["zero", "init"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_scan_matches_reference_chunked_scan(shape, with_init):
    B, S, H, P, G, N, chunk = shape
    d = _inputs(B, S, H, P, G, N, seed=1)
    r_init = jnp.asarray(d["init"]) if with_init else None
    p_init = torch.from_numpy(d["init"]) if with_init else None
    r_y, r_state = RS.ssd_scan(*_args(d, "jax"), chunk=chunk,
                               init_state=r_init)
    before = K.LAUNCHES
    p_y, p_state = K.ssd_scan(*_args(d, "torch"), chunk=chunk,
                              init_state=p_init)
    assert K.LAUNCHES == before
    assert p_y.shape == (B, S, H, P) and p_state.shape == (B, H, P, N)
    assert p_y.dtype == p_state.dtype == torch.float32
    _near(p_y, r_y)
    _near(p_state, r_state)


@pytest.mark.parametrize("with_init", [False, True], ids=["zero", "init"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_passes_compose_to_the_scan(shape, with_init):
    """The five passes' plain versions, composed in the kernel's order of
    work (chunk cumsum, C.B^T per group, chunk states, state passing,
    chunk scan), give the chunked scan of both packages."""
    B, S, H, P, G, N, chunk = shape
    d = _inputs(B, S, H, P, G, N, seed=9)
    p_init = torch.from_numpy(d["init"]) if with_init else None
    y, state = K.ssd_scan_passes(*_args(d, "torch"), chunk=chunk,
                                 init_state=p_init)
    assert y.shape == (B, S, H, P) and state.shape == (B, H, P, N)
    want_y, want_state = K.ssd_scan_ref(*_args(d, "torch"), chunk=chunk,
                                        init_state=p_init)
    _near(y, want_y)
    _near(state, want_state)
    r_y, r_state = RS.ssd_scan(*_args(d, "jax"), chunk=chunk,
                               init_state=(jnp.asarray(d["init"])
                                           if with_init else None))
    _near(y, r_y)
    _near(state, r_state)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_error_bound_holds_3xtf32_and_breaks_1xtf32(shape):
    """The float64 model of the kernel's arithmetic lies within
    ``error_bound`` of the exact scan with 3xTF32 products, and outside
    it with plain TF32 products: the 3xTF32 terms are what the bound
    allows for, not slack that would hide a one-pass kernel."""
    B, S, H, P, G, N, chunk = shape
    d = _inputs(B, S, H, P, G, N, seed=10)
    args = _args(d, "torch")
    init = torch.from_numpy(d["init"])
    exact_y, exact_state = K.ssd_scan_ref(
        *(a.double() for a in args), chunk=chunk, init_state=init.double())
    tol_y, tol_state = K.error_bound(*args, chunk=chunk, init_state=init)
    errs = {}
    for passes in (3, 1):
        y, state = K.ssd_scan_tf32(*args, chunk=chunk, init_state=init,
                                   passes=passes)
        assert y.dtype == state.dtype == torch.float64
        errs[passes] = (float((y - exact_y).abs().max()) / tol_y,
                        float((state - exact_state).abs().max()) / tol_state)
    assert max(errs[3]) <= 1.0, errs
    assert max(errs[1]) > 1.0, errs


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_scan_matches_pallas_kernel(shape):
    B, S, H, P, G, N, chunk = shape
    d = _inputs(B, S, H, P, G, N, seed=2)
    want = ref_ops.ssd_scan(*_args(d, "jax"), chunk=chunk)
    got, _ = K.ssd_scan(*_args(d, "torch"), chunk=chunk)
    _close(got, want, PALLAS_TOL)


@pytest.mark.parametrize("with_init", [False, True], ids=["zero", "init"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_scan_matches_sequential_oracle(shape, with_init):
    B, S, H, P, G, N, chunk = shape
    d = _inputs(B, S, H, P, G, N, seed=3)
    init = torch.from_numpy(d["init"]) if with_init else None
    y, state = K.ssd_scan(*_args(d, "torch"), chunk=chunk, init_state=init)
    o_y, o_state = PS.ssd_ref(*_args(d, "torch"), init_state=init)
    _close(y, o_y, SEQ_TOL)
    _close(state, o_state, SEQ_TOL)
    # the port's oracle is the reference's
    r_y, r_state = RS.ssd_ref(*_args(d, "jax"),
                              init_state=(jnp.asarray(d["init"])
                                          if with_init else None))
    _near(o_y, r_y)
    _near(o_state, r_state)


def test_plain_version_in_float64():
    """float64 inputs give a float64 scan that agrees with the float64
    sequential oracle to rounding (chip_smoke.py's check of K4 relies on
    it)."""
    B, S, H, P, G, N, chunk = 2, 45, 4, 8, 2, 16, 16
    d = _inputs(B, S, H, P, G, N, seed=4, dtype=np.float64)
    init = torch.from_numpy(d["init"])
    y, state = K.ssd_scan_ref(*_args(d, "torch"), chunk=chunk,
                              init_state=init)
    assert y.dtype == state.dtype == torch.float64
    o_y, o_state = PS.ssd_ref(*_args(d, "torch"), init_state=init)
    _close(y, o_y, 1e-10)
    _close(state, o_state, 1e-10)


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_state_carries_across_calls(chunk):
    """Scanning S positions at once equals scanning the first part, then
    the rest from its final state (decode caches rely on the state)."""
    B, S, H, P, G, N = 2, 40, 4, 8, 2, 16
    d = _inputs(B, S, H, P, G, N, seed=5)
    x, dt, A, Bm, Cm = _args(d, "torch")
    y, state = K.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    cut = 24
    y1, s1 = K.ssd_scan(x[:, :cut], dt[:, :cut], A, Bm[:, :cut],
                        Cm[:, :cut], chunk=chunk)
    y2, s2 = K.ssd_scan(x[:, cut:], dt[:, cut:], A, Bm[:, cut:],
                        Cm[:, cut:], chunk=chunk, init_state=s1)
    _close(torch.cat([y1, y2], 1), y, SEQ_TOL)
    _close(s2, state, SEQ_TOL)


@pytest.mark.parametrize("G", [1, 2])
def test_decode_step_matches_reference(G):
    B, H, P, N = 3, 4, 8, 16
    rng = np.random.default_rng(6)
    state = (rng.standard_normal((B, H, P, N)) * 0.5).astype(np.float32)
    x_t = rng.standard_normal((B, H, P)).astype(np.float32)
    dt_t = np.log1p(np.exp(rng.standard_normal((B, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    B_t = rng.standard_normal((B, G, N)).astype(np.float32)
    C_t = rng.standard_normal((B, G, N)).astype(np.float32)
    arrays = (state, x_t, dt_t, A, B_t, C_t)
    r_y, r_state = RS.ssd_decode_step(*map(jnp.asarray, arrays))
    p_y, p_state = PS.ssd_decode_step(*map(torch.from_numpy, arrays))
    _near(p_y, r_y)
    _near(p_state, r_state)


@pytest.mark.parametrize("cw", [2, 4])
def test_causal_conv_matches_reference(cw):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 19, 12)).astype(np.float32)
    w = rng.standard_normal((cw, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    want = RS.causal_conv(*map(jnp.asarray, (x, w, b)))
    got = PS.causal_conv(*map(torch.from_numpy, (x, w, b)))
    _near(got, want)
    # causal: position t reads positions t-cw+1..t only
    x2 = x.copy()
    x2[:, 10:] += 1.0
    got2 = PS.causal_conv(*map(torch.from_numpy, (x2, w, b)))
    assert torch.equal(got2[:, :10], got[:, :10])


def test_causal_conv_step_matches_reference_and_full_conv():
    rng = np.random.default_rng(8)
    cw, C = 4, 12
    x = rng.standard_normal((2, 9, C)).astype(np.float32)
    w = rng.standard_normal((cw, C)).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    full = PS.causal_conv(*map(torch.from_numpy, (x, w, b)))
    r_state = jnp.zeros((2, cw - 1, C), jnp.float32)
    p_state = torch.zeros((2, cw - 1, C))
    for t in range(x.shape[1]):
        r_y, r_state = RS.causal_conv_step(r_state, jnp.asarray(x[:, t]),
                                           jnp.asarray(w), jnp.asarray(b))
        p_y, p_state = PS.causal_conv_step(p_state, torch.from_numpy(x[:, t]),
                                           torch.from_numpy(w),
                                           torch.from_numpy(b))
        _near(p_y, r_y)
        _close(p_state, r_state, 0.0)
        _near(p_y, full[:, t])
