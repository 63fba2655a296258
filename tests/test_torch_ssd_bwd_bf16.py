"""Kernel K4's bfloat16 backward arithmetic against the reference on the
CPU.

The bfloat16 backward kernel (``csrc/ssd_scan_bwd_bf16.cu``) runs D =
dy . x^T as one bf16 product on the values as they are (exact products,
float32 sums), and every product with a float32 operand (exp(cum) dy of
the dstates, the weights W and G_c of dx, S_in and G_c of the head
terms, dcb of dB and dC) as two, that operand split into two bfloat16
parts. ``ssd_scan_bwd_bf16`` is a float64 model of that arithmetic;
these tests hold it, on bfloat16 x, B, C and dy drawn from numpy seeds
(dt, A, the state in and d(final) float32), to ``bwd_error_bound``'s
bfloat16 terms (the bfloat16 tensors passed to it) against:

- the port's plain backward ``ssd_scan_bwd_ref`` in float64 on the
  widened inputs, with no state in and no d(final), with both, and with
  the case's own, and
- ``jax.vjp`` through the reference's ``repro.models.ssd.ssd_scan`` on
  the widened inputs (float32), as ``test_torch_ssd_grad.py``'s
  ``test_plain_backward_matches_jax_vjp`` holds the float32 plain
  backward,

at ``test_torch_ssd_grad.py``'s ``CASES`` and at the shapes of
``chip_smoke.py``'s bfloat16 ``_k4_bwd_cases`` with S cut to at most 300
(mamba2-370m's and hymba-1.5b's widths, S % Q != 0, R = 25, P 12 with N
20, Q 16 with G 3, Q 100 with G 2). The bound is not vacuous: with every
split operand in one bfloat16 part (2^-8 of each value) the model
breaks it, in the gradients ``ONE_PART_BREAKS`` names for each shape:
d(init) wherever there is one, dx and dC and dB at the small shapes.
At mamba2-370m's width with no state in (2 x 300 positions) one part
stays inside (dx at 0.88 of it): there 3 S' and the decays' 72 Lambda
dominate L. On a CPU tensor the wrapper is the plain version and counts
no launch.

The reduced mamba2-370m's loss and gradient at the models' default
RunOptions (float32 params, bfloat16 compute) against the reference's
``jax.value_and_grad`` at ``compute_dtype="bfloat16"``: the loss within
``LOSS_TOL`` relative and every gradient leaf within ``GRAD_TOL`` of its
largest magnitude. bfloat16 rounds at other places in the two frameworks
(XLA keeps float32 inside its fusions where the port rounds each
operation's output), each rounding moving a value by up to 2^-9 of
itself; at batch 2 x 64 tokens and ssd_chunk 16 the loss agreed to
3.7e-6 to 7.7e-6 relative on seeds 0-2 and the worst leaf to 3.3-4.4%
of its largest magnitude (``Dskip``, ``wc``, ``A_log``: sums over every
position of products that cancel), so the qwen1.5-0.5b test's
LOSS_TOL = 1e-3 and GRAD_TOL = 0.1 (``test_torch_attention_bwd_bf16.py``)
hold those with room.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get as ref_get
from repro.data.tokens import make_batch_iter as ref_batches
from repro.models import ssd as RS
from repro.models.model import Model as RefModel
from repro.models.options import RunOptions as RefOptions
from repro_torch.configs.base import get
from repro_torch.convert import params_from_arrays
from repro_torch.kernels import ssd as K
from repro_torch.models.model import Model
from repro_torch.models.options import RunOptions
from repro_torch.runtime import steps as S
from _torch_threads import cap_torch_threads

cap_torch_threads()

# B, S, H, P, G, N, chunk, init_state, d(final state): test_torch_ssd_grad
# 's CASES, then chip_smoke's bfloat16 _k4_bwd_cases with S cut to 300
CASES = [
    (2, 40, 4, 8, 2, 16, 16, True, True),      # padding, G = 2
    (1, 33, 3, 8, 1, 16, 8, False, False),     # padding, G = 1, R = 3
    (2, 48, 5, 8, 1, 8, 16, True, False),      # R = 5
    (1, 50, 6, 4, 2, 8, 64, False, True),      # one short chunk, R = 3
    (2, 300, 4, 64, 1, 128, 256, False, False),   # mamba2-370m's width
    (1, 300, 25, 64, 1, 16, 256, False, False),   # hymba-1.5b's
    (2, 300, 8, 64, 1, 128, 256, True, True),     # S % Q != 0
    (1, 300, 25, 64, 1, 16, 64, True, True),      # R = 25, Q 64
    (2, 200, 4, 12, 2, 20, 64, True, False),      # P 12, N 20
    (2, 300, 6, 64, 3, 128, 16, True, True),      # Q 16, G 3
    (2, 300, 8, 64, 2, 64, 100, True, True),      # Q 100, G 2
]
IDS = ["B{}_S{}_H{}_P{}_G{}_N{}_Q{}".format(*c[:7])
       + ("_init" if c[7] else "") + ("_dfinal" if c[8] else "")
       for c in CASES]
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dinit")
# the gradients one bfloat16 part puts past the bound at each shape, on
# the inputs of seed 7 (each at 1.29 to 17 times it)
ONE_PART_BREAKS = {
    0: {"dx", "ddt", "dB", "dC", "dinit"},
    1: {"dx", "dB", "dC"},
    2: {"dx", "ddt", "dB", "dC", "dinit"},
    3: {"dx", "dB", "dC"},
    5: {"dx"},
    6: {"dinit"},
    7: {"dx", "dinit"},
    8: {"dx", "dB", "dC", "dinit"},
    9: {"dx", "dB", "dC", "dinit"},
    10: {"dx", "dinit"},
}
OPTS = dict(remat="none", layer_loop="scan", compute_dtype="bfloat16",
            ssd_chunk=16)
LOSS_TOL = 1e-3
GRAD_TOL = 0.1


def _inputs(case, seed, state="case"):
    """bfloat16 x, Bm, Cm and dy, float32 dt, A, and the state in and
    d(final) (each None where ``state`` leaves it out: "case" as the case
    says, "none" neither, "both" both), from numpy draws."""
    B, S_, H, P, G, N, Q, with_init, with_dfinal = case
    if state != "case":
        with_init = with_dfinal = state == "both"
    rng = np.random.default_rng(seed)
    f = np.float32
    d = {"x": (rng.standard_normal((B, S_, H, P)) * 0.5).astype(f),
         "dt": np.log1p(np.exp(rng.standard_normal((B, S_, H)) - 1)).astype(f),
         "A": (-np.exp(rng.standard_normal(H) * 0.3)).astype(f),
         "Bm": (rng.standard_normal((B, S_, G, N)) * 0.3).astype(f),
         "Cm": (rng.standard_normal((B, S_, G, N)) * 0.3).astype(f),
         "init": (rng.standard_normal((B, H, P, N)) * 0.5).astype(f),
         "dy": rng.standard_normal((B, S_, H, P)).astype(f),
         "dfinal": rng.standard_normal((B, H, P, N)).astype(f)}
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    for k in ("x", "Bm", "Cm", "dy"):
        t[k] = t[k].bfloat16()
    args = [t[k] for k in ("x", "dt", "A", "Bm", "Cm", "dy")]
    return (args, t["dfinal"] if with_dfinal else None,
            t["init"] if with_init else None)


def _f64(a):
    return None if a is None else a.double()


def _ratios(got, want, bound):
    """{name: the largest |got - want| / bound} of each gradient there is."""
    return {n: float(((g.double() - w.double()).abs() / b).max())
            for n, g, w, b in zip(NAMES, got, want, bound) if g is not None}


def _model_and_bound(case, seed, state="case", parts=2):
    args, dfinal, init = _inputs(case, seed, state)
    Q = case[6]
    exact = K.ssd_scan_bwd_ref(*map(_f64, args), _f64(dfinal), chunk=Q,
                               init_state=_f64(init))
    bound = K.bwd_error_bound(*args, dfinal, chunk=Q, init_state=init,
                              refs=exact)
    model = K.ssd_scan_bwd_bf16(*args, dfinal, chunk=Q, init_state=init,
                                parts=parts)
    return model, exact, bound


@pytest.mark.parametrize("state", ("case", "none", "both"))
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bf16_bwd_model_within_bound_of_plain_version(case, state):
    """The model of the kernel's arithmetic (two parts) lies within
    ``bwd_error_bound``'s bfloat16 terms of the exact gradient, every
    gradient at every element."""
    model, exact, bound = _model_and_bound(case, 5, state)
    assert all(bool(torch.isfinite(m).all()) for m in model if m is not None)
    ratios = _ratios(model, exact, bound)
    assert max(ratios.values()) <= 1.0, ratios


@pytest.mark.parametrize("case", CASES[:4] + CASES[8:10], ids=IDS[:4]
                         + IDS[8:10])
def test_bf16_bwd_model_within_bound_of_reference_vjp(case):
    """The same bound against ``jax.vjp`` of the reference's chunked scan
    on the widened inputs (float32: its XLA gradient, what the reference
    trains with)."""
    args, dfinal, init = _inputs(case, 6)
    Q = case[6]
    wide = [a.float().numpy() for a in args]
    names = 5 + (init is not None)

    def f(*a):
        return RS.ssd_scan(*a[:5], chunk=Q,
                           init_state=a[5] if init is not None else None)
    ins = [jnp.asarray(w) for w in wide[:5]]
    if init is not None:
        ins.append(jnp.asarray(init.numpy()))
    (_, final), vjp = jax.vjp(f, *ins[:names])
    dfin = (dfinal.numpy() if dfinal is not None
            else np.zeros(final.shape, np.float32))
    want = [torch.from_numpy(np.array(g)).double()
            for g in vjp((jnp.asarray(wide[5]), jnp.asarray(dfin)))]
    model = K.ssd_scan_bwd_bf16(*args, dfinal, chunk=Q, init_state=init)
    bound = K.bwd_error_bound(*args, dfinal, chunk=Q, init_state=init)
    got = [m for m in model if m is not None]
    ratios = _ratios(got, want, [b for b in bound if b is not None])
    assert max(ratios.values()) <= 1.0, ratios


@pytest.mark.parametrize("index", sorted(ONE_PART_BREAKS),
                         ids=[IDS[i] for i in sorted(ONE_PART_BREAKS)])
def test_bf16_bwd_bound_is_not_vacuous(index):
    """Every split operand in one bfloat16 part breaks the bound, in the
    gradients ``ONE_PART_BREAKS`` names for the shape; two parts hold
    it."""
    model, exact, bound = _model_and_bound(CASES[index], 7, parts=1)
    ratios = _ratios(model, exact, bound)
    broken = {n for n, r in ratios.items() if r > 1.0}
    assert ONE_PART_BREAKS[index] <= broken, ratios
    model, _, _ = _model_and_bound(CASES[index], 7, parts=2)
    assert max(_ratios(model, exact, bound).values()) <= 1.0


def test_bf16_bwd_bound_takes_the_bf16_terms():
    """bfloat16 x takes the bfloat16 library's terms: on the same values
    L is 4 (P_SPLIT_ERR - PRODUCT_ERR) / u = 976 above the float32
    library's (dA, float32 in both, shows the ratio of the two), and dx,
    dB and dC add their rounding to bfloat16."""
    case = CASES[0]
    args, dfinal, init = _inputs(case, 1)
    B, S_, H, P, G, N, Q = case[:7]
    b16 = K.bwd_error_bound(*args, dfinal, chunk=Q, init_state=init)
    b32 = K.bwd_error_bound(*(a.float() for a in args), dfinal, chunk=Q,
                            init_state=init)
    u = 2.0 ** -24
    assert 4 * (K.P_SPLIT_ERR - K.PRODUCT_ERR) / u == 976.0
    Q, nc, QP = K.geometry(S_, Q)
    la = (args[1].double() * args[2].double()).abs()
    la = torch.nn.functional.pad(la, (0, 0, 0, nc * Q - S_))
    lam = float(la.reshape(B, nc, Q, H).sum(2).max())
    L32 = (2 * N + P + H // G + 3 * nc * Q + 2 * QP + 72 * lam
           + nc * (13 * lam + 6) + 104 + -(-P * N // 1024)
           + 2 * K.PRODUCT_ERR / u)
    da = B * nc + QP                           # dA's own sums
    torch.testing.assert_close(
        b16[2] / b32[2], torch.full_like(b32[2], (L32 + 976 + da)
                                         / (L32 + da)), rtol=1e-12, atol=0)
    for i in (0, 3, 4):                        # dx, dB, dC
        assert bool((b16[i] > b32[i]).all())


def test_bf16_bwd_wrapper_on_the_cpu_is_the_plain_version():
    """On CPU tensors ``ssd_scan_bwd`` is ``ssd_scan_bwd_ref``, in the
    operands' dtypes, and counts no launch."""
    case = CASES[0]
    args, dfinal, init = _inputs(case, 3)
    before = (K.BWD_LAUNCHES, K.BF16_BWD_LAUNCHES)
    got = K.ssd_scan_bwd(*args, dfinal, chunk=case[6], init_state=init)
    want = K.ssd_scan_bwd_ref(*args, dfinal, chunk=case[6], init_state=init)
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32,
                                      torch.float32, torch.bfloat16,
                                      torch.bfloat16, torch.float32]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (K.BWD_LAUNCHES, K.BF16_BWD_LAUNCHES) == before


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree.detach().cpu() if isinstance(
        tree, torch.Tensor) else tree)}


@pytest.mark.parametrize("seed", (0, 1))
def test_mamba2_bf16_loss_and_gradients_match_reference(seed):
    """The reduced mamba2-370m at bfloat16 compute: the port's
    ``value_and_grad`` against the reference's (``LOSS_TOL``,
    ``GRAD_TOL``: the module's note says why)."""
    arch = "mamba2-370m"
    refm = RefModel(ref_get(arch).reduced(), RefOptions(**OPTS))
    port = Model(get(arch).reduced(), RunOptions(**OPTS))
    assert port.opts.compute_dtype == "bfloat16"
    rp = refm.init(jax.random.PRNGKey(seed))
    batch = jax.tree.map(np.asarray, next(ref_batches(
        ref_get(arch).reduced(), global_batch=2, seq_len=64, seed=seed)))
    rloss, rgrads = jax.jit(jax.value_and_grad(refm.loss))(rp, batch)
    params = params_from_arrays(jax.tree.map(np.asarray, rp), "cpu")
    loss, grads = S.value_and_grad(port, params, batch)
    assert abs(float(loss) - float(rloss)) <= LOSS_TOL * abs(float(rloss))
    got = _flat(dict(zip(_flat(params), grads)))
    want = _flat(jax.tree.map(np.asarray, rgrads))
    assert got.keys() == want.keys()
    for name in want:
        scale = float(np.abs(want[name]).max())
        err = float(np.abs(got[name].astype(np.float64) - want[name]).max())
        assert err <= GRAD_TOL * max(scale, 1e-30), (name, err, scale)
