"""The port's encoder-decoder family (``repro_torch.models.whisper``)
against the reference's ``repro.models.model.Model`` on the CPU, at
``get("whisper-large-v3").reduced()`` (2 encoder and 2 decoder layers,
d_model 64, 4 heads of 16, vocab 256, max_target_len 16) with the
reference's params carried across (``convert.params_from_arrays``),
every leaf moved off its init (biases and LayerNorm gains and offsets
are zeros and ones there) so that each one shows. Frames (2, 24, 64)
and tokens drawn with numpy from a seed; the reference unrolled
(``layer_loop="unroll"``) and not jitted.

Checked: ``layer_norm`` and ``sinusoidal_positions`` alone, the param
layout, ``encode``, ``forward_logits``, ``prefill`` (the token and every
cache leaf, with and without ``cache_len``) and 4 ``decode_step``s
(tokens, caches, slot positions; with no ``cache_len`` the cache is the
12-token prompt, so the steps wrap the ring buffer at once).

Tolerances. float32: 1e-5 absolute on encoder outputs, logits and caches
(the other families' bound: float32 matmuls and softmax sums in other
orders); tokens and slot positions exactly. ``layer_norm`` 1e-6 relative
to its output's magnitude. The sinusoids: torch's and XLA's float32
``exp`` put a frequency (at most 1) one ulp apart at some columns, at
most 2^-24 below 1, which moves the angle at position p by p 2^-24; the
angle's own float32 rounding (p 2^-23 at most) can then land on the
next float: within 2e-6 + 3 (n - 1) 2^-24 at n positions, sin and cos
being 1-Lipschitz (2e-6 for their own last bits). bfloat16 (the
models' default compute dtype): logits and caches within
``bf16_logit_tolerance(bf16_boundaries(cfg), max|ref|)``, the decoder's
layers plus the encoder's n_enc + 2 roundings (derived in
``bf16_boundaries``), tokens equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get as ref_get
from repro.models import layers as RL
from repro.models import whisper as RW
from repro.models.model import Model as RefModel
from repro.models.options import RunOptions as RefOptions
from repro_torch.configs.base import get
from repro_torch.convert import params_from_arrays
from repro_torch.models import layers as L
from repro_torch.models import whisper as W
from repro_torch.models.model import Model
from repro_torch.models.options import (RunOptions, bf16_boundaries,
                                        bf16_logit_tolerance)
from _torch_threads import cap_torch_threads

cap_torch_threads()

ARCH = "whisper-large-v3"
OPTS = dict(remat="none", layer_loop="unroll", compute_dtype="float32",
            q_chunk=16, kv_chunk=16)
TOL = 1e-5
B, S_ENC, ST = 2, 24, 12


def _moved(tree, rng):
    """Every leaf plus a draw of 0.1 standard deviations (of the leaf's
    own spread, or absolute for the constant inits)."""
    def move(a):
        a = np.asarray(a)
        scale = float(a.std()) or 0.1
        return (a + 0.1 * scale * rng.standard_normal(a.shape)
                ).astype(a.dtype)
    return jax.tree.map(move, tree)


def _pair(compute_dtype):
    opts = {**OPTS, "compute_dtype": compute_dtype}
    ref = RefModel(ref_get(ARCH).reduced(), RefOptions(**opts))
    port = Model(get(ARCH).reduced(), RunOptions(**opts))
    rng = np.random.default_rng(0)
    arrays = _moved(ref.init(jax.random.PRNGKey(0)), rng)
    rp = jax.tree.map(jnp.asarray, arrays)
    pp = params_from_arrays(arrays, device="cpu")
    frames = rng.standard_normal((B, S_ENC, 64)).astype(np.float32)
    tokens = rng.integers(0, 256, (B, ST)).astype(np.int32)
    return ref, port, rp, pp, frames, tokens


@pytest.fixture(scope="module")
def pair():
    return _pair("float32")


@pytest.fixture(scope="module")
def pair_bf16():
    return _pair("bfloat16")


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _batches(frames, tokens):
    return ({"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens)},
            {"frames": torch.from_numpy(frames),
             "tokens": torch.from_numpy(tokens)})


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("shape", ((3, 7, 64), (2, 1280)))
def test_layer_norm_matches_reference(dtype, shape):
    rng = np.random.default_rng(1)
    x = (3 * rng.standard_normal(shape) + 1).astype(np.float32)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    want = _np(RL.layer_norm(jnp.asarray(x).astype(dtype), jnp.asarray(w),
                             jnp.asarray(b), 1e-5))
    got = L.layer_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                       torch.from_numpy(w), torch.from_numpy(b), 1e-5)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-6 * float(np.abs(want).max()))
    else:      # the float32 results round to the same bfloat16 or one ulp
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                                   atol=0)


@pytest.mark.parametrize("n, d", ((24, 64), (448, 1280), (1500, 1280)))
def test_sinusoidal_positions_match_reference(n, d):
    want = np.asarray(RL.sinusoidal_positions(n, d))
    got = L.sinusoidal_positions(n, d)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-6 + 3 * (n - 1) * 2.0 ** -24)


def _shapes(tree):
    return {k: (_shapes(v) if isinstance(v, dict) else tuple(v.shape))
            for k, v in tree.items()}


def test_config_and_param_layout_match(pair):
    ref, port, rp, _, _, _ = pair
    full, full_ref = get(ARCH), ref_get(ARCH)
    for f in ("name", "family", "n_layers", "n_enc_layers", "d_model",
              "n_heads", "n_kv_heads", "d_ff", "vocab", "head_dim", "mlp",
              "max_target_len", "frontend", "source", "norm_eps"):
        assert getattr(full, f) == getattr(full_ref, f), f
        assert getattr(port.cfg, f) == getattr(ref.cfg, f), f
    assert (full.n_layers, full.n_enc_layers, full.d_model, full.n_heads,
            full.hd, full.d_ff, full.vocab) == (32, 32, 1280, 20, 64, 5120,
                                                51866)
    assert L.padded_vocab(full.vocab) == 51968      # 203 x 256
    assert full.param_count() == full_ref.param_count()
    params = port.init(torch.Generator().manual_seed(0), "cpu")
    assert _shapes(params) == _shapes(jax.tree.map(np.asarray, rp))
    assert set(params["dec_layers"]) == {
        "ln", "wq", "bq", "wk", "wv", "bv", "wo", "bo", "x_ln", "x_wq",
        "x_bq", "x_wk", "x_wv", "x_bv", "x_wo", "x_bo", "ln2", "w_up",
        "b_up", "w_down", "b_down"}
    assert "bk" not in params["enc_layers"]
    d = port.cfg.d_model
    assert bool((params["enc_layers"]["ln"]["w"] == 1).all())
    assert bool((params["dec_layers"]["bq"] == 0).all())
    assert abs(float(params["dec_layers"]["x_wk"].std()) - d ** -0.5) \
        < 0.1 * d ** -0.5


def test_encode_matches(pair):
    ref, port, rp, pp, frames, _ = pair
    want = np.asarray(RW.encode(rp, ref.cfg, ref.opts, jnp.asarray(frames)))
    got = W.encode(pp, port.cfg, port.opts, torch.from_numpy(frames))
    assert got.shape == (B, S_ENC, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_forward_logits_match(pair):
    ref, port, rp, pp, frames, tokens = pair
    rb, pb = _batches(frames, tokens)
    want = np.asarray(ref.forward_logits(rp, rb))
    got = port.forward_logits(pp, pb)
    assert got.shape == (B, ST, 256)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


CACHE = ("k", "v", "xk", "xv")


def _hold_cache(got, want, tol, err=""):
    for name in CACHE:
        w = _np(want[name])
        assert tuple(got[name].shape) == w.shape, name
        np.testing.assert_allclose(got[name].float().numpy(), w, rtol=0,
                                   atol=tol(w), err_msg=f"{name} {err}")
    np.testing.assert_array_equal(got["slot_pos"].numpy(),
                                  np.asarray(want["slot_pos"]))
    assert got["pos"].dtype == torch.int32
    assert int(got["pos"]) == int(want["pos"])


@pytest.mark.parametrize("cache_len", (None, 20))
def test_prefill_and_decode_match(pair, cache_len):
    ref, port, rp, pp, frames, tokens = pair
    rb, pb = _batches(frames, tokens)
    r_tok, r_cache = ref.prefill(rp, rb, cache_len=cache_len)
    p_tok, p_cache = port.prefill(pp, pb, cache_len=cache_len)
    np.testing.assert_array_equal(p_tok.numpy(), np.asarray(r_tok))
    assert p_tok.dtype == torch.int32
    assert set(p_cache) == set(r_cache)
    Sc = cache_len or ST
    assert p_cache["k"].shape == (2, B, Sc, 4, 16)
    assert p_cache["xk"].shape == (2, B, S_ENC, 4, 16)
    _hold_cache(p_cache, r_cache, lambda w: TOL)
    xk = p_cache["xk"].clone()
    for step in range(4):
        r_tok, r_cache = ref.decode_step(rp, r_cache, r_tok)
        p_tok, p_cache = port.decode_step(pp, p_cache, p_tok)
        np.testing.assert_array_equal(p_tok.numpy(), np.asarray(r_tok),
                                      err_msg=str(step))
        _hold_cache(p_cache, r_cache, lambda w: TOL, f"step {step}")
        assert int(p_cache["pos"]) == ST + 1 + step
    assert torch.equal(p_cache["xk"], xk)       # cross k, v are read only
    if cache_len is None:                        # slots 0..3 overwritten
        assert p_cache["slot_pos"][:4].tolist() == [12, 13, 14, 15]


def _bf16_tol(port):
    n = bf16_boundaries(port.cfg)
    assert n == 6
    return lambda w: bf16_logit_tolerance(n, float(np.abs(w).max()))


def test_forward_logits_match_in_bfloat16(pair_bf16):
    ref, port, rp, pp, frames, tokens = pair_bf16
    assert port.opts.compute_dtype == "bfloat16"
    rb, pb = _batches(frames, tokens)
    want = _np(ref.forward_logits(rp, rb))
    got = port.forward_logits(pp, pb)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=_bf16_tol(port)(want))
    assert np.array_equal(got.float().numpy().argmax(-1), want.argmax(-1))


def test_prefill_and_decode_match_in_bfloat16(pair_bf16):
    ref, port, rp, pp, frames, tokens = pair_bf16
    rb, pb = _batches(frames, tokens)
    r_tok, r_cache = ref.prefill(rp, rb, cache_len=16)
    p_tok, p_cache = port.prefill(pp, pb, cache_len=16)
    assert p_cache["k"].dtype == p_cache["xk"].dtype == torch.bfloat16
    np.testing.assert_array_equal(p_tok.numpy(), np.asarray(r_tok))
    tol = _bf16_tol(port)
    _hold_cache(p_cache, r_cache, tol)
    for step in range(4):
        r_tok, r_cache = ref.decode_step(rp, r_cache, r_tok)
        p_tok, p_cache = port.decode_step(pp, p_cache, p_tok)
        np.testing.assert_array_equal(p_tok.numpy(), np.asarray(r_tok),
                                      err_msg=str(step))
        _hold_cache(p_cache, r_cache, tol, f"step {step}")
