"""Kernel K4's plain backward on the CPU, against autograd and against
JAX's gradient of the reference scan, on inputs drawn with numpy from
seeds.

- each step of the plain backward (``chunk_scan_bwd_ref``,
  ``state_passing_bwd_ref``, ``chunk_state_bwd_ref``, ``bmm_bwd_ref``,
  ``cumsum_bwd_ref``: the five forward passes reversed) and their
  composition ``ssd_scan_bwd_ref`` against autograd through the
  forward's plain versions in float64;
- ``ssd_scan_bwd_ref`` in float32 against ``jax.vjp`` of
  ``repro.models.ssd.ssd_scan`` (the reference trains through XLA's
  gradient of it): padding (S not a multiple of the chunk), G of 1 and 2,
  an odd number of heads per group, with and without ``init_state`` and
  a d(final state);
- ``SsdScanFn`` on CPU tensors: the plain versions both ways, no kernel
  counted, and under the models' ``remat`` modes the gradients without
  remat;
- ``bwd_error_bound``: the plain backward in float32 (the kernel's
  arithmetic: float32 products and sums, in another order) lies within
  it, and the same backward with plain TF32 products does not, so the
  bound is not vacuous;
- ``examples/train_lm_torch.py --device cpu``: the loss falls.

Tolerances: 1e-10 of each gradient's largest magnitude against autograd
in float64 (the same function, other orders of float64 sums); 1e-5 of
each gradient's largest magnitude against JAX in float32 (float32 sums
of up to a few hundred terms in other orders, a few ulps of outputs of
magnitude up to about 10, as ``test_torch_ssd.py``'s tolerance).
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssd as RS
from repro_torch.kernels import ssd as K
from _torch_threads import cap_torch_threads

cap_torch_threads()

# B, S, H, P, G, N, chunk, init_state, d(final state)
CASES = [
    (2, 40, 4, 8, 2, 16, 16, True, True),    # padding, G = 2
    (1, 33, 3, 8, 1, 16, 8, False, False),   # padding, G = 1, R = 3
    (2, 48, 5, 8, 1, 8, 16, True, False),    # R = 5
    (1, 50, 6, 4, 2, 8, 64, False, True),    # one short chunk, R = 3
]
IDS = ["B{}_S{}_H{}_P{}_G{}_N{}_Q{}".format(*c[:7])
       + ("_init" if c[7] else "") + ("_dfinal" if c[8] else "")
       for c in CASES]
F64_TOL = 1e-10
JAX_TOL = 1e-5


def _inputs(B, S, H, P, G, N, seed=0):
    """x, dt, A, Bm, Cm, init_state, dy and d(final state) as numpy
    float32 arrays."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return {
        "x": (rng.standard_normal((B, S, H, P)) * 0.5).astype(f),
        "dt": np.log1p(np.exp(rng.standard_normal((B, S, H)) - 1)).astype(f),
        "A": (-np.exp(rng.standard_normal(H) * 0.3)).astype(f),
        "Bm": (rng.standard_normal((B, S, G, N)) * 0.3).astype(f),
        "Cm": (rng.standard_normal((B, S, G, N)) * 0.3).astype(f),
        "init": (rng.standard_normal((B, H, P, N)) * 0.5).astype(f),
        "dy": rng.standard_normal((B, S, H, P)).astype(f),
        "dfinal": rng.standard_normal((B, H, P, N)).astype(f),
    }


def _torch(d, dtype=torch.float64):
    return {k: torch.from_numpy(v).to(dtype) for k, v in d.items()}


def _near(got, want, tol):
    """Each of ``got`` within tol of the largest magnitude of its
    ``want``."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=tol * max(1e-30, np.abs(b).max()))


def _grads(outputs, inputs, cotangents):
    """Autograd's vector-Jacobian product."""
    return torch.autograd.grad(
        sum((o * c).sum() for o, c in zip(outputs, cotangents)), inputs)


def _leaf(t):
    return t.clone().requires_grad_(True)


def _scratch(t, Q):
    """The forward passes' plain scratch in float64: dts, cum, cb, s_in."""
    dts, cum = K.cumsum_ref(t["dt"], t["A"], chunk=Q)
    cb = K.bmm_ref(t["Bm"], t["Cm"], chunk=Q)
    upd = K.chunk_state_ref(t["x"], t["Bm"], dts, cum, chunk=Q)
    s_in, _ = K.state_passing_ref(upd, cum, t["init"])
    return dts, cum, cb, upd, s_in


STEPS = ("chunk_scan", "state_passing", "chunk_state", "bmm", "cumsum",
         "composed")


@pytest.mark.parametrize("case", CASES[:2], ids=IDS[:2])
@pytest.mark.parametrize("step", STEPS)
def test_plain_backward_matches_autograd_in_float64(step, case):
    """Each step of the plain backward is the vector-Jacobian product of
    its forward pass's plain version, and their composition that of
    ``ssd_scan_ref``."""
    B, S, H, P, G, N, Q, with_init, with_dfinal = case
    t = _torch(_inputs(B, S, H, P, G, N, seed=1))
    rng = np.random.default_rng(2)

    def cot(ref):
        return torch.from_numpy(rng.standard_normal(ref.shape))
    dts, cum, cb, upd, s_in = _scratch(t, Q)
    if step == "chunk_scan":
        ins = [_leaf(a) for a in (t["x"], t["Cm"], dts, cum, cb, s_in)]
        y = K.chunk_scan_ref(*ins, chunk=Q)
        dy = cot(y)
        # (dx, dCm, ddts, dcum, dcb, ds_in): the inputs' order
        got = K.chunk_scan_bwd_ref(*(a.detach() for a in ins), dy, chunk=Q)
        want = _grads([y], ins, [dy])
    elif step == "state_passing":
        ins = [_leaf(a) for a in (upd, cum, t["init"])]
        s, final = K.state_passing_ref(*ins)
        ds_in, dfinal = cot(s), cot(final)
        dupd, dcum, dinit = K.state_passing_bwd_ref(
            s.detach(), cum, dfinal, ds_in)
        got, want = (dupd, dcum, dinit), _grads([s, final], ins,
                                                [ds_in, dfinal])
    elif step == "chunk_state":
        ins = [_leaf(a) for a in (t["x"], t["Bm"], dts, cum)]
        u = K.chunk_state_ref(*ins, chunk=Q)
        du = cot(u)
        got = K.chunk_state_bwd_ref(*(a.detach() for a in ins), du, chunk=Q)
        want = _grads([u], ins, [du])
    elif step == "bmm":
        ins = [_leaf(a) for a in (t["Bm"], t["Cm"])]
        c = K.bmm_ref(*ins, chunk=Q)
        dc = cot(c)
        got, want = K.bmm_bwd_ref(t["Bm"], t["Cm"], dc, chunk=Q), \
            _grads([c], ins, [dc])
    elif step == "cumsum":
        ins = [_leaf(a) for a in (t["dt"], t["A"])]
        d, c = K.cumsum_ref(*ins, chunk=Q)
        dd, dc = cot(d), cot(c)
        got, want = K.cumsum_bwd_ref(dd, dc, t["dt"], t["A"], chunk=Q), \
            _grads([d, c], ins, [dd, dc])
    else:
        init = t["init"] if with_init else None
        dfinal = t["dfinal"] if with_dfinal else None
        ins = [_leaf(t[k]) for k in ("x", "dt", "A", "Bm", "Cm")]
        if with_init:
            ins.append(_leaf(init))
        y, final = K.ssd_scan_ref(*ins[:5], chunk=Q,
                                  init_state=ins[5] if with_init else None)
        outs, cots = [y], [t["dy"]]
        if with_dfinal:
            outs.append(final)
            cots.append(dfinal)
        want = _grads(outs, ins, cots)
        got = K.ssd_scan_bwd_ref(*(t[k] for k in ("x", "dt", "A", "Bm",
                                                  "Cm", "dy")), dfinal,
                                 chunk=Q, init_state=init)
        assert (got[5] is None) == (not with_init)
        got = [g for g in got if g is not None]
    _near(got, want, F64_TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_jax_vjp(case):
    """The plain backward in float32 against ``jax.vjp`` of the
    reference's chunked scan on the same float32 inputs (its XLA
    gradient, what ``python -m repro.launch.train`` trains with)."""
    B, S, H, P, G, N, Q, with_init, with_dfinal = case
    d = _inputs(B, S, H, P, G, N, seed=3)
    names = ["x", "dt", "A", "Bm", "Cm"] + (["init"] if with_init else [])

    def f(*a):
        return RS.ssd_scan(*a[:5], chunk=Q,
                           init_state=a[5] if with_init else None)
    (y, final), vjp = jax.vjp(f, *(jnp.asarray(d[k]) for k in names))
    dfinal = d["dfinal"] if with_dfinal else np.zeros(final.shape,
                                                      np.float32)
    want = vjp((jnp.asarray(d["dy"]), jnp.asarray(dfinal)))
    t = _torch(d, torch.float32)
    got = K.ssd_scan_bwd_ref(
        *(t[k] for k in ("x", "dt", "A", "Bm", "Cm", "dy")),
        t["dfinal"] if with_dfinal else None, chunk=Q,
        init_state=t["init"] if with_init else None)
    assert all(g.dtype == torch.float32 for g in got if g is not None)
    _near([g for g in got if g is not None], want, JAX_TOL)


def test_ssd_scan_fn_on_the_cpu_is_the_plain_version():
    """``SsdScanFn`` on CPU tensors: the forward is ``ssd_scan_ref``, the
    backward ``ssd_scan_bwd_ref`` (the same bits as a direct call), no
    kernel launch counted; ``ssd_scan`` on CPU tensors differentiates
    through ``ssd_scan_ref``."""
    B, S, H, P, G, N, Q = 2, 40, 4, 8, 2, 16, 16
    t = _torch(_inputs(B, S, H, P, G, N, seed=4), torch.float32)
    names = ("x", "dt", "A", "Bm", "Cm", "init")
    launches = (K.LAUNCHES, K.BWD_LAUNCHES)
    ins = [_leaf(t[k]) for k in names]
    y, final = K.SsdScanFn.apply(*ins, Q)
    want_y, want_final = K.ssd_scan_ref(*(t[k] for k in names[:5]), chunk=Q,
                                        init_state=t["init"])
    assert torch.equal(y, want_y) and torch.equal(final, want_final)
    got = _grads([y, final], ins, [t["dy"], t["dfinal"]])
    plain = K.ssd_scan_bwd_ref(*(t[k] for k in ("x", "dt", "A", "Bm", "Cm",
                                                "dy", "dfinal")),
                               chunk=Q, init_state=t["init"])
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    # and only the y gradient: the final state's is None, not zeros
    ins = [_leaf(t[k]) for k in names]
    y, _ = K.SsdScanFn.apply(*ins, Q)
    got = _grads([y], ins, [t["dy"]])
    plain = K.ssd_scan_bwd_ref(*(t[k] for k in ("x", "dt", "A", "Bm", "Cm",
                                                "dy")),
                               chunk=Q, init_state=t["init"])
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    ins = [_leaf(t[k]) for k in names]
    y, final = K.ssd_scan(*ins[:5], chunk=Q, init_state=ins[5])
    got = _grads([y, final], ins, [t["dy"], t["dfinal"]])
    ins = [_leaf(t[k]) for k in names]
    y, final = K.ssd_scan_ref(*ins[:5], chunk=Q, init_state=ins[5])
    want = _grads([y, final], ins, [t["dy"], t["dfinal"]])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (K.LAUNCHES, K.BWD_LAUNCHES) == launches


def _bound_ratios(case, models):
    """The largest |model - exact| / ``bwd_error_bound`` of each gradient,
    for each named model: "float32" (the plain backward in float32) or
    "tf32_<passes>" (``ssd_scan_bwd_ref`` with ``passes``, the float64
    model of the kernel's TF32 products)."""
    B, S, H, P, G, N, Q, with_init, with_dfinal = case
    d = _inputs(B, S, H, P, G, N, seed=5)
    t32 = _torch(d, torch.float32)
    init = t32["init"] if with_init else None
    dfinal = t32["dfinal"] if with_dfinal else None
    args = [t32[k] for k in ("x", "dt", "A", "Bm", "Cm", "dy")]

    def f64(a):
        return None if a is None else a.double()
    exact = K.ssd_scan_bwd_ref(*map(f64, args), f64(dfinal), chunk=Q,
                               init_state=f64(init))
    bound = K.bwd_error_bound(*args, dfinal, chunk=Q, init_state=init)
    ratios = {}
    for name in models:
        if name == "float32":
            model = K.ssd_scan_bwd_ref(*args, dfinal, chunk=Q,
                                       init_state=init)
        else:
            model = K.ssd_scan_bwd_ref(*map(f64, args), f64(dfinal),
                                       chunk=Q, init_state=f64(init),
                                       passes=int(name.split("_")[1]))
        ratios[name] = [float(((m.double() - e).abs() / b).max())
                        for m, e, b in zip(model, exact, bound)
                        if m is not None]
    return ratios


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bwd_error_bound_holds_float32_and_breaks_tf32(case):
    """The plain backward in float32 lies within ``bwd_error_bound`` of
    the exact gradient (float64), every gradient at every element; with
    plain TF32 products (one pass, the float64 model of a cruder kernel)
    it does not, so the bound is not slack that would hide one."""
    ratios = _bound_ratios(case, ("float32", "tf32_1"))
    assert max(ratios["float32"]) <= 1.0, ratios
    assert max(ratios["tf32_1"]) > 1.0, ratios


@pytest.mark.parametrize("dtype", ("float32",))
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bwd_error_bound_holds_3xtf32_and_breaks_tf32(case, dtype):
    """The float32 kernel's arithmetic, every product in 3xTF32 (the
    float64 model ``ssd_scan_bwd_ref(..., passes=3)``), lies within
    ``bwd_error_bound`` of the exact gradient, every gradient at every
    element; one TF32 product (``passes=1``) breaks it. (bfloat16
    operands take their own library and terms:
    ``tests/test_torch_ssd_bwd_bf16.py``.)"""
    ratios = _bound_ratios(case, ("tf32_3", "tf32_1"))
    assert max(ratios["tf32_3"]) <= 1.0, ratios
    assert max(ratios["tf32_1"]) > 1.0, ratios


@pytest.mark.parametrize("mode", ("full", "dots"))
def test_ssd_scan_fn_under_remat(mode):
    """``SsdScanFn`` inside the models' ``remat`` (``torch.utils.
    checkpoint``, full or keeping the products' outputs): the forward is
    run again in the backward, and the gradients are those without
    remat, bit for bit."""
    from repro_torch.models.transformer import remat
    B, S, H, P, G, N, Q = 2, 40, 4, 8, 2, 16, 16
    t = _torch(_inputs(B, S, H, P, G, N, seed=6), torch.float32)
    names = ("x", "dt", "A", "Bm", "Cm", "init")

    def f(*a):
        y, final = K.SsdScanFn.apply(*a, Q)
        return (y * t["dy"]).sum() + (final * t["dfinal"]).sum()
    ins = [_leaf(t[k]) for k in names]
    want = torch.autograd.grad(f(*ins), ins)
    ins = [_leaf(t[k]) for k in names]
    got = torch.autograd.grad(remat(f, mode)(*ins), ins)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _example():
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "train_lm_torch.py"
    spec = importlib.util.spec_from_file_location("train_lm_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ("qwen1.5-0.5b", "mamba2-370m"))
def test_train_lm_torch_example_on_the_cpu(arch, tmp_path, capsys):
    """``examples/train_lm_torch.py --device cpu`` trains a reduced model
    for 20 steps at the reference's batch, length and rate (its own
    assert: the loss falls) and checkpoints."""
    losses = _example().main(["--device", "cpu", "--arch", arch,
                              "--steps", "20", "--ckpt-dir", str(tmp_path)])
    assert len(losses) >= 2 and losses[-1] < losses[0]
    assert "OK: loss" in capsys.readouterr().out
    assert any(tmp_path.iterdir())
