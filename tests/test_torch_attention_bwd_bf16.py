"""Kernel K3's bfloat16 backward arithmetic against the reference on the CPU.

The bfloat16 backward kernel (``csrc/flash_attention_bwd_bf16.cu``) runs
S = q K^T and dP = dO V^T as bf16 products on the values as they are
(exact products, float32 sums), and dV = P^T dO, dK = scale dS^T Q and
dQ = scale dS K with P and dS, float32, in two bfloat16 parts.
``attention_bwd_bf16`` is a float64 model of that arithmetic; these tests
hold it, on bfloat16 inputs drawn from numpy seeds, to
``bwd_error_bound``'s bfloat16 terms (the bfloat16 tensors passed to it)
against:

- the port's plain version ``flash_attention_bwd_ref`` in float64 on the
  widened inputs, given the plain forward's o and log-sum-exp, and
- ``jax.grad`` through the reference's ``ref.flash_attention_ref`` on the
  widened inputs (float32), for the output gradient dO, the model given
  the widened forward's float32 o and lse: the kernel is handed the
  forward's o rounded to bfloat16, which moves delta = rowsum(dO o), and
  so dS, by up to half an ulp of each |dO o| term (the plain version,
  given the same o, moves with it; ``jax.grad`` has no o to round, and
  with it the model's dq lies 2-36 times the bound from jax's),

at the shapes of ``tests/test_torch_cuda.py``'s ``K3_BWD_CASES`` with
rows cut to at most 300 (GQA, windows, rows that see no key, D of 12,
32, 40, 64 and 128, ragged Sq and Skv). The bound is not vacuous: with P
in one bfloat16 part the model's dV breaks it, with dS in one part its
dK and dQ do; a third part stays inside it. On a CPU tensor the wrapper
is the plain version and counts no launch.

The reduced qwen1.5-0.5b's loss and gradient at the models' default
RunOptions (float32 params, bfloat16 compute) against the reference's
``jax.value_and_grad`` at ``compute_dtype="bfloat16"``: the loss within
``LOSS_TOL`` relative and every gradient leaf within ``GRAD_TOL`` of its
largest magnitude. bfloat16 rounds at other places in the two frameworks
(XLA keeps float32 inside its fusions where the port rounds each
operation's output), each rounding moving a value by up to 2^-9 of
itself; the loss agrees to about 5e-5 (measured 1.3e-5 to 5.2e-5 on
three seeds) and the worst leaf to 2.2-2.8% of its largest magnitude
(``layers/bk``, whose gradient the softmax's shift invariance makes a
sum of cancelling terms), so LOSS_TOL = 1e-3 and GRAD_TOL = 0.1 hold
those with room.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs.base import get as ref_get
from repro.data.tokens import make_batch_iter as ref_batches
from repro.kernels import ref
from repro.models.model import Model as RefModel
from repro.models.options import RunOptions as RefOptions
from repro_torch.configs.base import get
from repro_torch.convert import params_from_arrays
from repro_torch.kernels import flash_attention as FA
from repro_torch.models.model import Model
from repro_torch.models.options import RunOptions
from repro_torch.runtime import steps as S
from _torch_threads import cap_torch_threads

cap_torch_threads()

# tests/test_torch_cuda.py's K3_BWD_CASES, rows cut to at most 300
CASES = (
    # B, Sq, Skv, H, G, D, causal, window
    (2, 300, 300, 8, 2, 64, True, None),
    (2, 200, 300, 4, 4, 16, False, None),
    (1, 300, 300, 8, 4, 64, True, 32),
    (3, 130, 130, 4, 1, 128, True, None),
    (1, 300, 300, 4, 2, 128, True, 100),
    (1, 90, 20, 2, 1, 32, False, 8),            # rows 27.. see no key
    (1, 300, 300, 4, 4, 64, False, None),       # whisper's encoder, cut
    (1, 77, 93, 10, 2, 32, True, 20),           # R = 5, ragged rows
    (1, 70, 50, 3, 3, 12, False, None),         # D = 12 in a 64-wide tile
    (1, 100, 100, 4, 2, 40, True, None),        # D = 40 in a 64-wide tile
    (1, 70, 50, 4, 2, 10, True, None),          # D = 10
)
OPTS = dict(remat="none", layer_loop="scan", compute_dtype="bfloat16",
            q_chunk=16, kv_chunk=16)
LOSS_TOL = 1e-3
GRAD_TOL = 0.1


def _inputs(case, seed):
    """bfloat16 q, k, v, do from numpy N(0, 1) draws, the plain forward's
    o (bfloat16) and lse (float32), and the plain backward in float64 on
    the widened values."""
    B, Sq, Skv, H, G, D, causal, window = case
    rng = np.random.default_rng(seed)
    q, do = (torch.tensor(rng.standard_normal((B, Sq, H, D),
                                              dtype=np.float32)).bfloat16()
             for _ in range(2))
    k, v = (torch.tensor(rng.standard_normal((B, Skv, G, D),
                                             dtype=np.float32)).bfloat16()
            for _ in range(2))
    o, lse = FA.flash_attention_fwd_lse(q, k, v, causal=causal,
                                        window=window)
    want = FA.flash_attention_bwd_ref(*(x.double() for x in (q, k, v, o, do)),
                                      lse.double(), causal=causal,
                                      window=window)
    return (q, k, v, o, do, lse), want


def _model(args, case, parts=2):
    return FA.attention_bwd_bf16(*args, causal=case[6], window=case[7],
                                 parts=parts)


def _bound(args, case):
    return FA.bwd_error_bound(*args, causal=case[6], window=case[7])


def _ratios(got, want, bound):
    """For dq, dk and dv: the largest |got - want| / bound, 0 where the
    two agree (a kv row no query sees: no gradient, a bound of 0)."""
    out = []
    for a, b, c in zip(got, want, bound):
        err = (a.double() - b.double()).abs()
        out.append(float(torch.where(err == 0, 0.0, err / c).max()))
    return out


@pytest.mark.parametrize("case", CASES)
def test_bf16_bwd_model_within_bound_of_plain_version(case):
    args, want = _inputs(case, 5)
    bound = _bound(args, case)
    for parts in (2, 3):
        got = _model(args, case, parts)
        assert all(bool(torch.isfinite(x).all()) for x in got)
        ratios = _ratios(got, want, bound)
        assert max(ratios) <= 1.0, (parts, ratios)


@pytest.mark.parametrize("case", CASES[:5] + CASES[6:])
def test_bf16_bwd_model_within_bound_of_reference_grad(case):
    """The same bound against ``jax.grad`` through the reference's plain
    attention on the widened inputs, for the output gradient dO, the
    model given the widened forward's float32 o and lse (rows that see no
    key left out: the reference's softmax gives them uniform weights)."""
    B, Sq, Skv, H, G, D, causal, window = case
    args, _ = _inputs(case, 6)
    q, k, v, o, do, lse = args
    o, lse = FA.flash_attention_fwd_lse(q.float(), k.float(), v.float(),
                                        causal=causal, window=window)
    wide = [jnp.asarray(x.float().numpy()) for x in (q, k, v)]
    cot = jnp.asarray(do.float().numpy())
    grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(ref.flash_attention_ref(
        q, k, v, causal=causal, window=window) * cot), argnums=(0, 1, 2)))(
            *wide)
    want = [torch.from_numpy(np.array(g)).double() for g in grads]
    model = _model((q, k, v, o, do, lse), case)
    ratios = _ratios(model, want, _bound(args, case))
    assert max(ratios) <= 1.0, ratios


@pytest.mark.parametrize("case", CASES[:1] + CASES[3:4] + CASES[5:6]
                         + CASES[8:9])
def test_bf16_bwd_bound_is_not_vacuous(case):
    """P in one bfloat16 part (2^-8 of each weight) breaks dV's bound, dS
    in one part dK's and dQ's."""
    args, want = _inputs(case, 7)
    dq, dk, dv = _ratios(_model(args, case, 1), want, _bound(args, case))
    assert dv > 1.0 and dk > 1.0 and dq > 1.0, (dq, dk, dv)


def test_bf16_bound_takes_the_bf16_terms():
    """bfloat16 inputs take the bfloat16 kernel's terms: exact S and dP
    products, P and dS in two parts (P_SPLIT_ERR where 3xTF32 has
    PRODUCT_ERR), so the bound differs from the float32 one on the same
    values and dV's is at least P_SPLIT_ERR times sum P |dO|."""
    case = (1, 64, 64, 2, 2, 16, True, None)
    args, want = _inputs(case, 1)
    b16 = _bound(args, case)
    b32 = _bound([x.float() for x in args], case)
    assert not any(torch.equal(a, b) for a, b in zip(b16, b32))
    q, k, v, o, do, lse = (x.double() for x in args)
    p = torch.exp(torch.einsum("bqhd,bshd->bhqs", q, k) * 16 ** -0.5
                  - lse[..., None])
    p = torch.where(FA._visible(64, 64, True, None, q.device), p, 0.0)
    floor = FA.P_SPLIT_ERR * torch.einsum("bhqs,bqhd->bshd", p, do.abs())
    assert bool((b16[2] >= floor).all())


@settings(max_examples=300, deadline=None)
@given(st.floats(-1e4, 1e4, width=32))
def test_bf16_parts_property(x):
    """``bf16_parts``: one part is bf16(x), two are ``bf16_split``'s hi +
    lo (within 2^-16 |x| + 2^-133), and each part brings the sum closer."""
    t = torch.tensor([x], dtype=torch.float32)
    hi, lo = FA.bf16_split(t)
    one, two, three = (FA.bf16_parts(t, n) for n in (1, 2, 3))
    assert torch.equal(one, hi.double())
    assert torch.equal(two, hi.double() + lo.double())
    errs = [abs(float(t.double() - p)) for p in (one, two, three)]
    assert errs[1] <= 2.0 ** -16 * abs(x) + 2.0 ** -133
    assert errs[2] <= errs[1] <= errs[0]


def test_bf16_bwd_wrapper_on_the_cpu_is_the_plain_version():
    case = (2, 20, 20, 4, 2, 16, True, 6)
    args, _ = _inputs(case, 3)
    before = (FA.BWD_LAUNCHES, FA.BF16_BWD_LAUNCHES)
    got = FA.flash_attention_bwd(*args, causal=True, window=6)
    want = FA.flash_attention_bwd_ref(*args, causal=True, window=6)
    assert all(a.dtype == torch.bfloat16 and torch.equal(a, b)
               for a, b in zip(got, want))
    assert (FA.BWD_LAUNCHES, FA.BF16_BWD_LAUNCHES) == before


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree.detach().cpu() if isinstance(
        tree, torch.Tensor) else tree)}


@pytest.mark.parametrize("seed", (0, 1))
def test_qwen_bf16_loss_and_gradients_match_reference(seed):
    """The reduced qwen1.5-0.5b at bfloat16 compute: the port's
    ``value_and_grad`` against the reference's (``LOSS_TOL``,
    ``GRAD_TOL``: the module's note says why)."""
    arch = "qwen1.5-0.5b"
    refm = RefModel(ref_get(arch).reduced(), RefOptions(**OPTS))
    port = Model(get(arch).reduced(), RunOptions(**OPTS))
    assert port.opts.compute_dtype == "bfloat16"
    rp = refm.init(jax.random.PRNGKey(seed))
    batch = jax.tree.map(np.asarray, next(ref_batches(
        ref_get(arch).reduced(), global_batch=2, seq_len=32, seed=seed)))
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
