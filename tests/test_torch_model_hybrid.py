"""The port's hybrid family (``repro_torch.models``, hymba) against the
reference's ``repro.models.model.Model`` on the CPU, at
``get("hymba-1.5b").reduced()``: 2 layers of d_model 64, 4 attention
heads of 16 over 4 kv heads, layer 0 global and layer 1 with a window of
32, an SSM branch of 4 heads of 16 at di = n_heads * hd = 64 (not the
config's d_inner of 128), d_state 16, one group, with
``RunOptions(ssd_chunk=8, q_chunk=16, kv_chunk=16)`` in float32 and the
reference's random params carried across (``convert.params_from_arrays``).

Checked: the configs, ``reduced()``, ``param_count`` and the param
layout; ``forward_logits`` at S = 37 (between W and 2W: the
banded path with chunks of Sq) and S = 80 (past 2W: chunks of the
window); ``prefill``'s caches (k, v, ssm, conv_x, conv_b, conv_c,
``slot_pos``), with a ``cache_len`` that pads only k and v; 4
``decode_step``s past the window; greedy prefill -> decode against the
incremental full forward; ``cache_meta``; a GQA variant (10 heads over 2
kv heads, R = 5 as in hymba); the default RunOptions (bfloat16); and
``BackboneVETL`` over the hybrid backbone. ``banded_mha`` is held against
the reference's at several (S, W, q_chunk).

Tolerance: 2e-5 absolute on logits and every cache leaf (float32
matmuls, softmax sums and scans in other orders over two layers; the
largest measured differences are about 5e-6); 1e-5 on ``banded_mha``
(one layer) and on the Transform's qualities; tokens exactly. At the
default RunOptions the logits are held to
``models.options.bf16_logit_tolerance``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get as ref_get
from repro.models import attention as RA
from repro.models.model import Model as RefModel
from repro.models.options import RunOptions as RefOptions
from repro_torch.configs.base import get
from repro_torch.convert import params_from_arrays
from repro_torch.models import attention as PA
from repro_torch.models.model import Model
from repro_torch.models.options import RunOptions, bf16_logit_tolerance
from _torch_threads import cap_torch_threads

cap_torch_threads()

ARCH = "hymba-1.5b"
OPTS = dict(remat="none", layer_loop="scan", compute_dtype="float32",
            q_chunk=16, kv_chunk=16, ssd_chunk=8)
TOL = 2e-5
CACHES = ("k", "v", "ssm", "conv_x", "conv_b", "conv_c")
GQA = dict(n_heads=10, n_kv_heads=2)


def _pair(**replace):
    rc, pc = ref_get(ARCH).reduced(), get(ARCH).reduced()
    if replace:
        rc = dataclasses.replace(rc, **replace)
        pc = dataclasses.replace(pc, **replace)
    ref = RefModel(rc, RefOptions(**OPTS))
    port = Model(pc, RunOptions(**OPTS))
    rp = ref.init(jax.random.PRNGKey(0))
    pp = params_from_arrays(jax.tree.map(np.asarray, rp), device="cpu")
    return ref, port, rp, pp


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.fixture(scope="module")
def gqa():
    return _pair(**GQA)


def _shapes(tree):
    return {k: (_shapes(v) if isinstance(v, dict) else tuple(v.shape))
            for k, v in tree.items()}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=tol)


def _tokens(S, seed=0, B=3):
    return np.random.default_rng(seed).integers(0, 256, (B, S))


def test_config_and_param_layout_match(pair):
    ref, port, rp, _ = pair
    full_ref, full = ref_get(ARCH), get(ARCH)
    for f in ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "d_ff", "vocab", "hd", "mlp", "window",
              "global_layers", "rope_theta", "norm_eps", "tie_embeddings",
              "source", "d_inner", "ssm_heads"):
        assert getattr(full, f) == getattr(full_ref, f), f
        assert getattr(port.cfg, f) == getattr(ref.cfg, f), f
    for mine, theirs in ((full, full_ref), (port.cfg, ref.cfg)):
        assert dataclasses.asdict(mine.ssm) == dataclasses.asdict(theirs.ssm)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.hd, full.d_ff, full.vocab, full.window,
            full.global_layers) == (32, 1600, 25, 5, 64, 5504, 32001, 1024,
                                    (0, 15, 31))
    assert (full.ssm.d_state, full.ssm.head_dim, full.d_inner,
            full.ssm.chunk, full.ssm.n_groups) == (16, 64, 1600, 256, 1)
    # reduced: di = n_heads * hd = 64 (4 SSM heads), not d_inner = 128
    assert (port.cfg.n_layers, port.cfg.window, port.cfg.global_layers,
            port.cfg.d_inner) == (2, 32, (0,), 128)
    params = port.init(torch.Generator().manual_seed(0), "cpu")
    assert _shapes(params) == _shapes(jax.tree.map(np.asarray, rp))
    lay = params["layers"]
    assert tuple(lay["wx"].shape) == (2, 64, 64)
    assert tuple(lay["A_log"].shape) == (2, 4)
    assert "ln1" in lay and "wout" not in lay
    assert tuple(lay["norm_attn"].shape) == tuple(lay["norm_ssm"].shape) \
        == (2, 64)
    n = sum(v.numel() for v in [params["embed"], params["final_ln"],
                                params["head"], *lay.values()])
    assert n == sum(int(np.prod(v.shape)) for v in jax.tree.leaves(rp))


def test_full_config_param_count():
    """The published config's parameter count, from the port's meta and
    the reference's, without materialising either (about 1.3 B)."""
    from repro_torch.models.model import _leaves
    ref_meta = RefModel(ref_get(ARCH)).meta()
    want = sum(int(np.prod(m.shape)) for m in jax.tree.leaves(
        ref_meta, is_leaf=lambda x: hasattr(x, "shape")))
    got = sum(int(np.prod(m.shape)) for _, m in _leaves(Model(get(ARCH))
                                                       .meta()))
    assert got == want
    assert 1.2e9 < got < 1.5e9
    # the configs' analytic count (norms left out), full and reduced
    for mine, theirs in ((get(ARCH), ref_get(ARCH)),
                         (get(ARCH).reduced(), ref_get(ARCH).reduced())):
        assert mine.param_count() == theirs.param_count()
    assert get(ARCH).param_count() == 1_393_313_696


@pytest.mark.parametrize("S", (37, 80))
def test_forward_logits_match(pair, S):
    ref, port, rp, pp = pair
    tokens = _tokens(S)
    want = ref.forward_logits(rp, {"tokens": jnp.asarray(tokens)})
    got = port.forward_logits(pp, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (3, S, 256)
    _close(got, want)


def test_prefill_and_decode_match(pair):
    ref, port, rp, pp = pair
    tokens = _tokens(37)
    r_tok, r_cache = ref.prefill(rp, {"tokens": jnp.asarray(tokens)},
                                 cache_len=48)
    p_tok, p_cache = port.prefill(pp, {"tokens": torch.from_numpy(tokens)},
                                  cache_len=48)
    np.testing.assert_array_equal(p_tok.numpy(), np.asarray(r_tok))
    assert set(p_cache) == set(r_cache) == {"layers", "pos", "slot_pos"}
    assert set(p_cache["layers"]) == set(r_cache["layers"]) == set(CACHES)
    # head-room pads k and v only; the SSM state and conv caches keep
    # their shapes
    lay = p_cache["layers"]
    assert lay["k"].shape == lay["v"].shape == (2, 3, 48, 4, 16)
    assert lay["ssm"].shape == (2, 3, 4, 16, 16)
    assert lay["conv_x"].shape == (2, 3, 3, 64)
    assert lay["conv_b"].shape == lay["conv_c"].shape == (2, 3, 3, 16)
    assert bool((lay["k"][:, :, 37:] == 0).all())
    for name in CACHES:
        _close(lay[name], r_cache["layers"][name])
    np.testing.assert_array_equal(p_cache["slot_pos"].numpy(),
                                  np.asarray(r_cache["slot_pos"]))
    assert int(p_cache["pos"]) == int(r_cache["pos"]) == 37
    for step in range(4):             # positions 37..40, past the window
        r_tok, r_cache = ref.decode_step(rp, r_cache, r_tok)
        p_tok, p_cache = port.decode_step(pp, p_cache, p_tok)
        np.testing.assert_array_equal(p_tok.numpy(), np.asarray(r_tok),
                                      err_msg=str(step))
        for name in CACHES:
            _close(p_cache["layers"][name], r_cache["layers"][name])
        np.testing.assert_array_equal(p_cache["slot_pos"].numpy(),
                                      np.asarray(r_cache["slot_pos"]))
        assert int(p_cache["pos"]) == int(r_cache["pos"]) == 38 + step


def test_greedy_decode_equals_incremental_forward(pair):
    """Greedy decode after prefill == the argmax of the full forward over
    the growing sequence, across the window's edge."""
    _, port, _, pp = pair
    seq = torch.from_numpy(_tokens(30, seed=1)[:2])
    nxt, cache = port.prefill(pp, {"tokens": seq}, cache_len=36)
    gen = [nxt]
    for _ in range(5):
        nxt, cache = port.decode_step(pp, cache, nxt)
        gen.append(nxt)
    for step in range(6):
        logits = port.forward_logits(pp, {"tokens": seq})
        nt = torch.argmax(logits[:, -1], -1).to(torch.int32)
        assert torch.equal(gen[step], nt), step
        seq = torch.cat([seq, nt[:, None].to(seq.dtype)], 1)


def test_cache_meta_matches(pair):
    ref, port, _, _ = pair
    assert port.cache_len(100) == ref.cache_len(100) == 100
    want = ref.cache_meta(3, 48)
    got = port.cache_meta(3, 48)
    assert set(got) == set(want) == {"layers", "pos", "slot_pos"}
    assert set(got["layers"]) == set(want["layers"]) == set(CACHES)
    for name in CACHES:
        assert got["layers"][name].shape == want["layers"][name].shape
        assert got["layers"][name].dtype == want["layers"][name].dtype
    assert got["slot_pos"].shape == want["slot_pos"].shape == (48,)
    assert got["pos"].shape == () and got["pos"].dtype == "int32"


@pytest.mark.parametrize("S", (37, 80))
def test_gqa_variant_matches(gqa, S):
    """10 query heads over 2 kv heads (R = 5, hymba's ratio) and 10 SSM
    heads at di = 160: logits, the prefill's caches and two decode
    steps."""
    ref, port, rp, pp = gqa
    tokens = _tokens(S, seed=2)
    want = ref.forward_logits(rp, {"tokens": jnp.asarray(tokens)})
    got = port.forward_logits(pp, {"tokens": torch.from_numpy(tokens)})
    _close(got, want)
    r_tok, r_cache = ref.prefill(rp, {"tokens": jnp.asarray(tokens)},
                                 cache_len=S + 4)
    p_tok, p_cache = port.prefill(pp, {"tokens": torch.from_numpy(tokens)},
                                  cache_len=S + 4)
    assert p_cache["layers"]["ssm"].shape == (2, 3, 10, 16, 16)
    assert p_cache["layers"]["k"].shape == (2, 3, S + 4, 2, 16)
    for _ in range(2):
        r_tok, r_cache = ref.decode_step(rp, r_cache, r_tok)
        p_tok, p_cache = port.decode_step(pp, p_cache, p_tok)
        np.testing.assert_array_equal(p_tok.numpy(), np.asarray(r_tok))
        for name in CACHES:
            _close(p_cache["layers"][name], r_cache["layers"][name])


@pytest.mark.parametrize("seed", (0, 1))
def test_forward_logits_match_at_default_options(seed):
    """The default RunOptions: bfloat16 compute (the banded path and K4's
    plain version on bfloat16 operands), the default chunks. The port's
    logits against the reference's within ``bf16_logit_tolerance``."""
    ref = RefModel(ref_get(ARCH).reduced(), RefOptions())
    port = Model(get(ARCH).reduced(), RunOptions())
    assert port.opts.compute_dtype == ref.opts.compute_dtype == "bfloat16"
    rp = ref.init(jax.random.PRNGKey(0))
    pp = params_from_arrays(jax.tree.map(np.asarray, rp), device="cpu")
    tokens = _tokens(80, seed=seed)
    want = np.asarray(ref.forward_logits(rp, {"tokens": jnp.asarray(tokens)})
                      .astype(jnp.float32))
    got = port.forward_logits(pp, {"tokens": torch.from_numpy(tokens)})
    assert got.dtype == torch.bfloat16
    tol = bf16_logit_tolerance(port.cfg.n_layers, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_prefill_and_decode_run_at_default_options():
    ref = RefModel(ref_get(ARCH).reduced(), RefOptions())
    port = Model(get(ARCH).reduced(), RunOptions())
    rp = ref.init(jax.random.PRNGKey(0))
    pp = params_from_arrays(jax.tree.map(np.asarray, rp), device="cpu")
    tokens = _tokens(40, seed=3)
    _, r_cache = ref.prefill(rp, {"tokens": jnp.asarray(tokens)},
                             cache_len=48)
    nxt, cache = port.prefill(pp, {"tokens": torch.from_numpy(tokens)},
                              cache_len=48)
    for name, got in cache["layers"].items():
        want = np.asarray(r_cache["layers"][name].astype(jnp.float32))
        tol = bf16_logit_tolerance(port.cfg.n_layers,
                                   float(np.abs(want).max()))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=tol, err_msg=name)
    for _ in range(2):
        nxt, cache = port.decode_step(pp, cache, nxt)
        assert nxt.shape == (3,)
        assert bool(((nxt >= 0) & (nxt < port.cfg.vocab)).all())


# (B, S, H, G, D, window, q_chunk): S < W, S between W and 2W, S past 2W,
# S not a multiple of q_chunk, R = 5
BANDED = ((2, 10, 4, 4, 16, 32, 16), (1, 37, 4, 2, 16, 32, 16),
          (2, 80, 4, 4, 16, 32, 32), (1, 70, 10, 2, 8, 16, 12),
          (1, 33, 5, 1, 8, 7, 5), (2, 64, 4, 2, 16, 64, 64))


@pytest.mark.parametrize("case", BANDED)
def test_banded_mha_matches_reference(case):
    B, S, H, G, D, window, qc = case
    rng = np.random.default_rng(S + window)
    q = rng.normal(0, 1, (B, S, H, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, S, G, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, S, G, D)).astype(np.float32)
    got = PA.banded_mha(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), window=window, q_chunk=qc)
    want = RA.banded_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         window=window, q_chunk=qc)
    assert got.shape == (B, S, H, D)
    _close(got, want, tol=1e-5)


def test_backbone_vetl_with_the_hybrid_backbone():
    """``BackboneVETL(arch="hymba-1.5b")``: the reference's sizes and,
    with its params carried across, its certainty for every size."""
    from repro.core.vetl_serving import BackboneVETL as RefJob
    from repro_torch.convert import backbone_from_arrays
    from repro_torch.core.vetl_serving import SIZES, BackboneVETL
    ref = RefJob(arch=ARCH)
    port = BackboneVETL(arch=ARCH, device="cpu")
    backbone_from_arrays(port, {name: jax.tree.map(np.asarray, params)
                                for name, (_, params) in ref.models.items()},
                         device="cpu")
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, 200, (8, 16))
    frames = rng.normal(0, 1, (8, 32, 32, 3)).astype(np.float32)
    for name in SIZES:
        rc, pc = ref.models[name][0].cfg, port.models[name][0].cfg
        assert pc.family == rc.family == "hybrid"
        assert (pc.n_layers, pc.d_model, pc.n_heads, pc.window) == \
            (rc.n_layers, rc.d_model, rc.n_heads, rc.window)
        want = float(ref._forward(name)(ref.models[name][1],
                                        jnp.asarray(tokens)))
        _, got = port.proc_fn({"frames": frames, "tokens": tokens},
                              {"model_size": name})
        assert 0.0 < got <= 1.0
        assert abs(got - want) <= 1e-5, name


def test_serve_cli_serves_hymba_on_the_cpu():
    from repro_torch.launch.serve import main
    stats = main(["--arch", ARCH, "--requests", "3", "--batch", "2",
                  "--prompt-len", "40", "--gen", "3", "--device", "cpu"])
    assert stats["tokens"] == 3 * 3
    assert [o.shape for o in stats["outputs"]] == [(2, 3), (1, 3)]
