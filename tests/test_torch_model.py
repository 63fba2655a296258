"""The port's dense decoder (``repro_torch.models``) against the
reference's ``repro.models.model.Model`` on the CPU, at
``get("qwen1.5-0.5b").reduced()`` (2 layers, d_model 64, 4 heads of 16,
QKV bias, tied embeddings) with the reference's random params carried
across (``convert.params_from_arrays``).

Checked: the param layout, ``forward_logits``, ``prefill`` (next tokens
and the k/v caches, padded to a longer ``cache_len``) and 4
``decode_step``s (tokens, caches, slot positions). The reference chunks
its attention (q_chunk = kv_chunk = 16 below a 40-token prompt); the
port's CPU path is one masked softmax. Tolerance: 2e-5 absolute on
logits and caches (float32 matmuls and softmax sums in other orders);
tokens exactly. At the default RunOptions (bfloat16 compute) the logits
are held to ``models.options.bf16_logit_tolerance``.
"""
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
from repro_torch.models import layers as L
from repro_torch.models.model import Model
from repro_torch.models.options import RunOptions, bf16_logit_tolerance
from _torch_threads import cap_torch_threads

cap_torch_threads()

OPTS = dict(remat="none", layer_loop="scan", compute_dtype="float32",
            q_chunk=16, kv_chunk=16)
TOL = 2e-5


@pytest.fixture(scope="module")
def pair():
    ref = RefModel(ref_get("qwen1.5-0.5b").reduced(), RefOptions(**OPTS))
    port = Model(get("qwen1.5-0.5b").reduced(), RunOptions(**OPTS))
    rp = ref.init(jax.random.PRNGKey(0))
    pp = params_from_arrays(jax.tree.map(np.asarray, rp), device="cpu")
    tokens = np.random.default_rng(0).integers(0, 256, (3, 40))
    return ref, port, rp, pp, tokens


def _shapes(tree):
    return {k: (_shapes(v) if isinstance(v, dict) else tuple(v.shape))
            for k, v in tree.items()}


def test_config_and_param_layout_match(pair):
    ref, port, rp, _, _ = pair
    rc, pc = ref.cfg, port.cfg
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab", "hd", "qkv_bias", "mlp", "tie_embeddings",
              "rope_theta", "norm_eps", "window"):
        assert getattr(rc, f) == getattr(pc, f), f
    full_ref, full = ref_get("qwen1.5-0.5b"), get("qwen1.5-0.5b")
    assert (full.n_layers, full.d_model, full.n_heads, full.d_ff,
            full.vocab) == (24, 1024, 16, 2816, 151936)
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab", "head_dim", "qkv_bias", "tie_embeddings", "source"):
        assert getattr(full, f) == getattr(full_ref, f), f
    params = port.init(torch.Generator().manual_seed(0), "cpu")
    assert _shapes(params) == _shapes(jax.tree.map(np.asarray, rp))
    assert L.padded_vocab(151936) == 152064


def test_init_scales(pair):
    _, port, _, _, _ = pair
    p = port.init(torch.Generator().manual_seed(1), "cpu")
    again = port.init(torch.Generator().manual_seed(1), "cpu")
    assert torch.equal(p["layers"]["wq"], again["layers"]["wq"])
    d = port.cfg.d_model
    assert abs(float(p["embed"].std()) - 0.02) < 0.002
    assert abs(float(p["layers"]["wq"].std()) - d ** -0.5) < 0.1 * d ** -0.5
    assert abs(float(p["layers"]["w_down"].std())
               - port.cfg.d_ff ** -0.5) < 0.1 * port.cfg.d_ff ** -0.5
    assert bool((p["layers"]["ln1"] == 1).all())
    assert bool((p["layers"]["bq"] == 0).all())


def test_forward_logits_match(pair):
    ref, port, rp, pp, tokens = pair
    want = np.asarray(ref.forward_logits(rp, {"tokens": jnp.asarray(tokens)}))
    got = port.forward_logits(pp, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_prefill_and_decode_match(pair):
    ref, port, rp, pp, tokens = pair
    r_tok, r_cache = ref.prefill(rp, {"tokens": jnp.asarray(tokens)},
                                 cache_len=48)
    p_tok, p_cache = port.prefill(pp, {"tokens": torch.from_numpy(tokens)},
                                  cache_len=48)
    np.testing.assert_array_equal(p_tok.numpy(), np.asarray(r_tok))
    for name in ("k", "v"):
        assert p_cache["layers"][name].shape == (2, 3, 48, 4, 16)
        np.testing.assert_allclose(p_cache["layers"][name].numpy(),
                                   np.asarray(r_cache["layers"][name]),
                                   rtol=0, atol=TOL)
    np.testing.assert_array_equal(p_cache["slot_pos"].numpy(),
                                  np.asarray(r_cache["slot_pos"]))
    assert int(p_cache["pos"]) == int(r_cache["pos"]) == 40
    for step in range(4):
        r_tok, r_cache = ref.decode_step(rp, r_cache, r_tok)
        p_tok, p_cache = port.decode_step(pp, p_cache, p_tok)
        np.testing.assert_array_equal(p_tok.numpy(), np.asarray(r_tok),
                                      err_msg=str(step))
        for name in ("k", "v"):
            np.testing.assert_allclose(p_cache["layers"][name].numpy(),
                                       np.asarray(r_cache["layers"][name]),
                                       rtol=0, atol=TOL)
        np.testing.assert_array_equal(p_cache["slot_pos"].numpy(),
                                      np.asarray(r_cache["slot_pos"]))
        assert int(p_cache["pos"]) == int(r_cache["pos"]) == 41 + step


def test_cache_meta_and_families(pair):
    ref, port, _, _, _ = pair
    assert port.cache_len(100) == ref.cache_len(100) == 100
    meta = port.cache_meta(3, 48)
    assert meta["layers"]["k"].shape == (2, 3, 48, 4, 16)
    from repro_torch.configs.base import ArchConfig, MoECfg
    moe = ArchConfig(name="m", family="moe", n_layers=1, d_model=8,
                     n_heads=2, n_kv_heads=2, d_ff=8, vocab=16,
                     moe=MoECfg(n_experts=2, top_k=1))
    assert Model(moe).cfg.family == "moe"          # ported in its slice
    encdec = ArchConfig(name="e", family="encdec", n_layers=1, d_model=8,
                        n_heads=2, n_kv_heads=2, d_ff=8, vocab=16,
                        n_enc_layers=1)
    assert Model(encdec).cfg.family == "encdec"    # ported in its slice
    made_up = ArchConfig(name="x", family="retrieval", n_layers=1,
                         d_model=8, n_heads=2, n_kv_heads=2, d_ff=8,
                         vocab=16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(made_up)


def test_serve_loop_matches_reference(capsys):
    """The port's serve loop against the reference launcher's CLI on
    the same reduced model (its params carried across): the same
    tokens generated for every batch, a ragged last batch included."""
    from repro.launch import serve as ref_serve
    from repro_torch.data.tokens import SyntheticCorpus
    from repro_torch.launch.serve import serve
    argv = ["--requests", "6", "--batch", "4", "--prompt-len", "12",
            "--gen", "4", "--seed", "0"]
    ref_serve.main(argv)
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("batch")]
    cfg = ref_get("qwen1.5-0.5b").reduced()
    rp = RefModel(cfg, RefOptions(**OPTS)).init(jax.random.PRNGKey(0))
    port = Model(get("qwen1.5-0.5b").reduced(),
                 RunOptions(**{**OPTS, "q_chunk": 64, "kv_chunk": 64}))
    lines = []
    stats = serve(port, params_from_arrays(jax.tree.map(np.asarray, rp),
                                           device="cpu"),
                  SyntheticCorpus(cfg.vocab, 0), requests=6, batch=4,
                  prompt_len=12, gen=4, log=lines.append)
    assert lines == want and len(want) == 2
    assert stats["tokens"] == 6 * 4
    assert [o.shape for o in stats["outputs"]] == [(4, 4), (2, 4)]


def test_corpus_matches_reference():
    from repro.data.tokens import SyntheticCorpus as RefCorpus
    from repro_torch.data.tokens import SyntheticCorpus
    for vocab, seed in ((256, 0), (151936, 3)):
        np.testing.assert_array_equal(
            SyntheticCorpus(vocab, seed).batch(3, 20, 7),
            RefCorpus(vocab, seed).batch(3, 20, 7))


@pytest.mark.parametrize("vocab", (1000, 32001, 151936))
@pytest.mark.parametrize("seed", (0, 1, 2))
@pytest.mark.parametrize("step", (0, 1, 7))
def test_corpus_draw_pinned_to_reference(vocab, seed, step):
    """The port draws unigram tokens through a CDF built once
    (``searchsorted`` of uniform draws) where the reference calls
    ``rng.choice(vocab, p=unigram)`` at every position: the same tokens,
    which pins numpy's ``Generator.choice`` to that construction."""
    from repro.data.tokens import SyntheticCorpus as RefCorpus
    from repro_torch.data.tokens import SyntheticCorpus
    np.testing.assert_array_equal(
        SyntheticCorpus(vocab, seed).batch(4, 24, step),
        RefCorpus(vocab, seed).batch(4, 24, step))


@pytest.mark.parametrize("seed", (0, 1))
def test_forward_logits_match_at_default_options(seed):
    """The models' default RunOptions: bfloat16 compute. The port's logits
    against the reference's within ``bf16_logit_tolerance`` (derived in
    its docstring from the bfloat16 roundings at each layer boundary and
    the float32 accumulation inside each layer)."""
    arch = "qwen1.5-0.5b"
    ref = RefModel(ref_get(arch).reduced(), RefOptions())
    port = Model(get(arch).reduced(), RunOptions())
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
    arch = "qwen1.5-0.5b"
    ref = RefModel(ref_get(arch).reduced(), RefOptions())
    port = Model(get(arch).reduced(), RunOptions())
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
