"""The port's SSM family (``repro_torch.models``, mamba2) against the
reference's ``repro.models.model.Model`` on the CPU, at
``get("mamba2-370m").reduced()`` (2 layers, d_model 64, d_inner 128, 8
heads of 16, d_state 16, 1 group, conv width 4, tied embeddings) with
``RunOptions(ssd_chunk=8)`` as ``tests/test_arch_smoke.py`` runs it, and
the reference's random params carried across
(``convert.params_from_arrays``).

Checked: the configs and the param layout, the ``ssm_a`` and
``dt_bias`` init kinds, ``forward_logits``, ``prefill`` (next tokens,
the SSM state and the three conv caches, no ``slot_pos``), 4
``decode_step``s, greedy prefill -> decode against the incremental full
forward, ``cache_meta``, the serve loop against the reference's CLI, and
the Transform stage's ``BackboneVETL`` over the SSM backbone against the
reference's certainty forward.

Tolerance: 2e-5 absolute on logits, states and conv caches (float32
matmuls, scans and cumsums in other orders, two layers; the largest
measured differences are 4e-7 on logits and 1.4e-6 on caches of
magnitude up to 3.4); 1e-5 on the Transform's qualities
(mean top-1 probabilities, as ``test_torch_vetl_serving.py``); tokens
exactly. At the default RunOptions (bfloat16 compute, the default SSD
chunk) the logits are held to ``models.options.bf16_logit_tolerance``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get as ref_get
from repro.models.model import Model as RefModel
from repro.models.options import RunOptions as RefOptions
from repro_torch.configs.base import get
from repro_torch.convert import params_from_arrays
from repro_torch.models.model import Model
from repro_torch.models.options import RunOptions, bf16_logit_tolerance
from _torch_threads import cap_torch_threads

cap_torch_threads()

ARCH = "mamba2-370m"
OPTS = dict(remat="none", layer_loop="scan", compute_dtype="float32",
            q_chunk=16, kv_chunk=16, ssd_chunk=8)
TOL = 2e-5
CACHES = ("ssm", "conv_x", "conv_b", "conv_c")


@pytest.fixture(scope="module")
def pair():
    ref = RefModel(ref_get(ARCH).reduced(), RefOptions(**OPTS))
    port = Model(get(ARCH).reduced(), RunOptions(**OPTS))
    rp = ref.init(jax.random.PRNGKey(0))
    pp = params_from_arrays(jax.tree.map(np.asarray, rp), device="cpu")
    tokens = np.random.default_rng(0).integers(0, 256, (3, 37))
    return ref, port, rp, pp, tokens


def _shapes(tree):
    return {k: (_shapes(v) if isinstance(v, dict) else tuple(v.shape))
            for k, v in tree.items()}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=tol)


def test_config_and_param_layout_match(pair):
    ref, port, rp, _, _ = pair
    full_ref, full = ref_get(ARCH), get(ARCH)
    for f in ("n_layers", "d_model", "vocab", "family", "tie_embeddings",
              "norm_eps", "source", "d_inner", "ssm_heads"):
        assert getattr(full, f) == getattr(full_ref, f), f
        assert getattr(port.cfg, f) == getattr(ref.cfg, f), f
    for mine, theirs in ((full, full_ref), (port.cfg, ref.cfg)):
        assert dataclasses.asdict(mine.ssm) == dataclasses.asdict(theirs.ssm)
    assert (full.n_layers, full.d_model, full.d_inner, full.ssm_heads,
            full.ssm.head_dim, full.ssm.d_state, full.ssm.n_groups,
            full.vocab) == (48, 1024, 2048, 32, 64, 128, 1, 50280)
    assert (port.cfg.d_inner, port.cfg.ssm_heads) == (128, 8)
    params = port.init(torch.Generator().manual_seed(0), "cpu")
    assert _shapes(params) == _shapes(jax.tree.map(np.asarray, rp))
    n = sum(v.numel() for v in [params["embed"], params["final_ln"],
                                *params["layers"].values()])
    assert n == sum(int(np.prod(v.shape)) for v in jax.tree.leaves(rp))


def test_ssm_init_kinds(pair):
    _, port, _, _, _ = pair
    p = port.init(torch.Generator().manual_seed(1), "cpu")
    again = port.init(torch.Generator().manual_seed(1), "cpu")
    assert torch.equal(p["layers"]["A_log"], again["layers"]["A_log"])
    a = torch.exp(p["layers"]["A_log"])              # U[1, 16]
    assert float(a.min()) >= 1.0 and float(a.max()) <= 16.0
    assert float(a.max() - a.min()) > 5.0
    dt = torch.nn.functional.softplus(p["layers"]["dt_bias"])  # U[1e-3, 0.1]
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 0.1 * (1 + 1e-5)
    assert bool((p["layers"]["Dskip"] == 1).all())
    assert bool((p["layers"]["conv_bx"] == 0).all())
    d = port.cfg.d_model
    assert abs(float(p["layers"]["wx"].std()) - d ** -0.5) < 0.1 * d ** -0.5


def test_forward_logits_match(pair):
    ref, port, rp, pp, tokens = pair
    want = ref.forward_logits(rp, {"tokens": jnp.asarray(tokens)})
    got = port.forward_logits(pp, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (3, 37, 256)
    _close(got, want)


def test_prefill_and_decode_match(pair):
    ref, port, rp, pp, tokens = pair
    r_tok, r_cache = ref.prefill(rp, {"tokens": jnp.asarray(tokens)},
                                 cache_len=48)
    p_tok, p_cache = port.prefill(pp, {"tokens": torch.from_numpy(tokens)},
                                  cache_len=48)
    np.testing.assert_array_equal(p_tok.numpy(), np.asarray(r_tok))
    assert set(p_cache) == set(r_cache) == {"layers", "pos"}
    assert set(p_cache["layers"]) == set(r_cache["layers"]) == set(CACHES)
    assert p_cache["layers"]["ssm"].shape == (2, 3, 8, 16, 16)
    assert p_cache["layers"]["conv_x"].shape == (2, 3, 3, 128)
    for name in CACHES:
        _close(p_cache["layers"][name], r_cache["layers"][name])
    assert int(p_cache["pos"]) == int(r_cache["pos"]) == 37
    for step in range(4):
        r_tok, r_cache = ref.decode_step(rp, r_cache, r_tok)
        p_tok, p_cache = port.decode_step(pp, p_cache, p_tok)
        np.testing.assert_array_equal(p_tok.numpy(), np.asarray(r_tok),
                                      err_msg=str(step))
        for name in CACHES:
            _close(p_cache["layers"][name], r_cache["layers"][name])
        assert "slot_pos" not in p_cache
        assert int(p_cache["pos"]) == int(r_cache["pos"]) == 38 + step


def test_greedy_decode_equals_incremental_forward(pair):
    """Greedy decode after prefill == the argmax of the full forward over
    the growing sequence (the reference's consistency check)."""
    _, port, _, pp, tokens = pair
    seq = torch.from_numpy(tokens[:2, :17])
    nxt, cache = port.prefill(pp, {"tokens": seq}, cache_len=23)
    gen = [nxt]
    for _ in range(4):
        nxt, cache = port.decode_step(pp, cache, nxt)
        gen.append(nxt)
    for step in range(5):
        logits = port.forward_logits(pp, {"tokens": seq})
        nt = torch.argmax(logits[:, -1], -1).to(torch.int32)
        assert torch.equal(gen[step], nt), step
        seq = torch.cat([seq, nt[:, None].to(seq.dtype)], 1)


def test_cache_meta_matches(pair):
    ref, port, _, _, _ = pair
    want = ref.cache_meta(3, 48)
    got = port.cache_meta(3, 48)
    assert set(got) == set(want) == {"layers", "pos"}
    for name in CACHES:
        assert got["layers"][name].shape == want["layers"][name].shape
        assert got["layers"][name].dtype == want["layers"][name].dtype
    assert got["pos"].shape == () and got["pos"].dtype == "int32"


def test_serve_loop_matches_reference(capsys):
    """The port's serve loop against the reference launcher's CLI with
    ``--arch mamba2-370m`` (reduced config, its params carried across):
    the same tokens generated for every batch, a ragged last batch
    included."""
    from repro.launch import serve as ref_serve
    from repro_torch.data.tokens import SyntheticCorpus
    from repro_torch.launch.serve import main, serve
    argv = ["--arch", ARCH, "--requests", "6", "--batch", "4",
            "--prompt-len", "12", "--gen", "4", "--seed", "0"]
    ref_serve.main(argv)
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("batch")]
    cfg = ref_get(ARCH).reduced()
    serve_opts = dict(OPTS, q_chunk=64, kv_chunk=64, ssd_chunk=256)
    rp = RefModel(cfg, RefOptions(**serve_opts)).init(jax.random.PRNGKey(0))
    port = Model(get(ARCH).reduced(), RunOptions(**serve_opts))
    lines = []
    stats = serve(port, params_from_arrays(jax.tree.map(np.asarray, rp),
                                           device="cpu"),
                  SyntheticCorpus(cfg.vocab, 0), requests=6, batch=4,
                  prompt_len=12, gen=4, log=lines.append)
    assert lines == want and len(want) == 2
    assert [o.shape for o in stats["outputs"]] == [(4, 4), (2, 4)]
    # the CLI itself, on the CPU
    cli = main(argv + ["--device", "cpu"])
    assert cli["tokens"] == 6 * 4


def test_backbone_vetl_with_the_ssm_backbone():
    """``BackboneVETL(arch="mamba2-370m")``: the reference's sizes and,
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
        assert pc.family == rc.family == "ssm"
        assert (pc.n_layers, pc.d_model, pc.d_inner, pc.ssm_heads) == \
            (rc.n_layers, rc.d_model, rc.d_inner, rc.ssm_heads)
        want = float(ref._forward(name)(ref.models[name][1],
                                        jnp.asarray(tokens)))
        _, got = port.proc_fn({"frames": frames, "tokens": tokens},
                              {"model_size": name})
        assert 0.0 < got <= 1.0
        assert abs(got - want) <= 1e-5, name


@pytest.mark.parametrize("seed", (0, 1))
def test_forward_logits_match_at_default_options(seed):
    """The models' default RunOptions: bfloat16 compute, so K4's plain
    version gets bfloat16 x, dt, B and C and float32 A. The port's logits
    against the reference's within ``bf16_logit_tolerance``."""
    ref = RefModel(ref_get(ARCH).reduced(), RefOptions())
    port = Model(get(ARCH).reduced(), RunOptions())
    assert port.opts.compute_dtype == ref.opts.compute_dtype == "bfloat16"
    rp = ref.init(jax.random.PRNGKey(0))
    pp = params_from_arrays(jax.tree.map(np.asarray, rp), device="cpu")
    tokens = np.random.default_rng(seed).integers(0, 256, (3, 40))
    want = np.asarray(ref.forward_logits(rp, {"tokens": jnp.asarray(tokens)})
                      .astype(jnp.float32))
    got = port.forward_logits(pp, {"tokens": torch.from_numpy(tokens)})
    assert got.dtype == torch.bfloat16
    tol = bf16_logit_tolerance(port.cfg.n_layers, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_prefill_and_decode_run_at_default_options():
    """bfloat16 prefill, then decode steps, on both sides (the decode
    step's caches and conv windows mix bfloat16 activations with float32
    state): the port's prefill caches within ``bf16_logit_tolerance``'s
    ulp rule of the reference's, every decoded token in the vocabulary."""
    ref = RefModel(ref_get(ARCH).reduced(), RefOptions())
    port = Model(get(ARCH).reduced(), RunOptions())
    rp = ref.init(jax.random.PRNGKey(0))
    pp = params_from_arrays(jax.tree.map(np.asarray, rp), device="cpu")
    tokens = np.random.default_rng(2).integers(0, 256, (3, 40))
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
