"""The rest of the zoo and the ``Model`` surface against the reference
on the CPU: the port's configs (``repro_torch/configs``) field for field,
``configs/shapes.py``'s 40 (arch x shape) cells, reduced
``forward_logits`` of llama3-8b, nemotron-4-15b (squared-ReLU MLP),
qwen1.5-110b (QKV bias) and internvl2-26b (vlm: 8 stub patch embeddings
prepended), ``Model.init_cache`` and ``build``, and the float8 kv cache
(``RunOptions.kv_cache_dtype="float8_e4m3fn"``).

Params are the reference's, every leaf moved off its init (biases are
zeros there) and carried across (``convert.params_from_arrays``);
tokens and embeddings drawn with numpy from a seed.

Tolerances: logits 2e-5 absolute in float32 (``test_torch_model.py``'s
bound: float32 matmuls and softmax sums in other orders); cache shapes,
dtypes and cells exactly. The float8 cache: its codes bit for bit
(``.view(torch.uint8)`` against the reference's bytes) after the prefill
and after 4 decode steps, and the decoded tokens equal: both sides round
float32 k and v that agree to a few float32 ulps to the nearest float8,
whose steps are 2^20 times coarser.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_cells as ref_all_cells
from repro.configs import shapes as ref_shapes
from repro.configs.base import registry as ref_registry
from repro.models.model import Model as RefModel
from repro.models.model import build as ref_build
from repro.models.options import RunOptions as RefOptions
from repro_torch import configs as C
from repro_torch.configs import shapes
from repro_torch.convert import params_from_arrays
from repro_torch.models.model import Model, build
from repro_torch.models.options import RunOptions
from _torch_threads import cap_torch_threads

cap_torch_threads()

OPTS = dict(remat="none", layer_loop="scan", compute_dtype="float32",
            q_chunk=16, kv_chunk=16)
TOL = 2e-5
ARCHS = sorted(ref_registry())
FP8 = "float8_e4m3fn"


def _moved(tree, rng):
    def move(a):
        a = np.asarray(a)
        scale = float(a.std()) or 0.1
        return (a + 0.1 * scale * rng.standard_normal(a.shape)
                ).astype(a.dtype)
    return jax.tree.map(move, tree)


def test_registry_is_the_reference_zoo():
    assert sorted(C.registry()) == ARCHS and len(ARCHS) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    got, want = C.get(arch), ref_registry()[arch]
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(g):
            g, w = dataclasses.asdict(g), dataclasses.asdict(w)
        assert g == w, f.name
    assert got.param_count() == want.param_count()
    assert dataclasses.asdict(got.reduced()) == \
        dataclasses.asdict(want.reduced())


def test_all_cells_match_reference():
    got, want = list(C.all_cells()), list(ref_all_cells())
    assert got == want and len(got) == 40
    assert sum(not ok for _, _, ok, _ in got) == 6
    assert {k: dataclasses.astuple(v) for k, v in C.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in ref_shapes.SHAPES.items()}
    assert shapes.SUBQUADRATIC == ref_shapes.SUBQUADRATIC
    for arch in ARCHS:
        for name, spec in C.SHAPES.items():
            ref_spec = ref_shapes.SHAPES[name]
            assert shapes.skip_reason(C.get(arch), spec) == \
                ref_shapes.skip_reason(ref_registry()[arch], ref_spec)


@pytest.mark.parametrize("arch", ("llama3-8b", "nemotron-4-15b",
                                  "qwen1.5-110b", "internvl2-26b"))
def test_forward_logits_match_reference(arch):
    ref = RefModel(ref_registry()[arch].reduced(), RefOptions(**OPTS))
    port = Model(C.get(arch).reduced(), RunOptions(**OPTS))
    rng = np.random.default_rng(3)
    arrays = _moved(ref.init(jax.random.PRNGKey(0)), rng)
    rp = jax.tree.map(jnp.asarray, arrays)
    pp = params_from_arrays(arrays, device="cpu")
    F = port.cfg.frontend_tokens
    assert F == (8 if arch == "internvl2-26b" else 0)
    tokens = rng.integers(0, 256, (2, 32 - F))
    rb, pb = {"tokens": jnp.asarray(tokens)}, {
        "tokens": torch.from_numpy(tokens)}
    if F:
        embeds = rng.standard_normal((2, F, port.cfg.d_model)).astype(
            np.float32)
        rb["embeds"], pb["embeds"] = jnp.asarray(embeds), torch.from_numpy(
            embeds)
    want = np.asarray(ref.forward_logits(rp, rb))
    got = port.forward_logits(pp, pb)
    assert got.shape == want.shape == (2, 32, 256)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def _leaf_specs(tree):
    if isinstance(tree, dict):
        return {k: _leaf_specs(v) for k, v in tree.items()}
    return tuple(tree.shape), str(tree.dtype).replace("torch.", "")


@pytest.mark.parametrize("kv", ("", FP8))
@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference(arch, kv):
    opts = dict(OPTS, compute_dtype="bfloat16", kv_cache_dtype=kv)
    ref = RefModel(ref_registry()[arch].reduced(), RefOptions(**opts))
    port = Model(C.get(arch).reduced(), RunOptions(**opts))
    want = ref.init_cache(3, 40)
    got = port.init_cache(3, 40, device="cpu")
    assert _leaf_specs(got) == _leaf_specs(jax.tree.map(np.asarray, want))
    for leaf in jax.tree.leaves(got):
        assert not bool(leaf.float().abs().sum()), "a cache starts at zeros"
    meta = port.cache_meta(3, 40)
    if arch == "whisper-large-v3":
        assert got["xk"].shape == (2, 3, 1500, 4, 16)
        assert got["xk"].dtype == torch.bfloat16
    if "k" in meta.get("layers", meta):
        k = got.get("layers", got)["k"]
        assert k.dtype == getattr(torch, kv or "bfloat16")


@pytest.mark.parametrize("arch", ("qwen1.5-0.5b", "whisper-large-v3",
                                  "mamba2-370m"))
@pytest.mark.parametrize("reduced", (True, False))
def test_build_matches_reference(arch, reduced):
    opts = RunOptions(**OPTS)
    m = build(arch, opts, reduced=reduced)
    r = ref_build(arch, RefOptions(**OPTS), reduced=reduced)
    assert isinstance(m, Model) and m.opts is opts
    assert dataclasses.asdict(m.cfg) == dataclasses.asdict(r.cfg)
    assert build(arch).opts == RunOptions()


@pytest.mark.parametrize("arch", ("qwen1.5-0.5b", "hymba-1.5b"))
@pytest.mark.parametrize("cache_len", (None, 48))
def test_float8_kv_cache_matches_reference(arch, cache_len):
    opts = dict(OPTS, kv_cache_dtype=FP8)
    ref = RefModel(ref_registry()[arch].reduced(), RefOptions(**opts))
    port = Model(C.get(arch).reduced(), RunOptions(**opts))
    rng = np.random.default_rng(4)
    arrays = _moved(ref.init(jax.random.PRNGKey(0)), rng)
    rp = jax.tree.map(jnp.asarray, arrays)
    pp = params_from_arrays(arrays, device="cpu")
    tokens = rng.integers(0, 256, (3, 40))
    r_tok, r_cache = ref.prefill(rp, {"tokens": jnp.asarray(tokens)},
                                 cache_len=cache_len)
    p_tok, p_cache = port.prefill(pp, {"tokens": torch.from_numpy(tokens)},
                                  cache_len=cache_len)
    np.testing.assert_array_equal(p_tok.numpy(), np.asarray(r_tok))

    def codes(cache, name):
        return cache["layers"][name].view(torch.uint8).numpy()

    def ref_codes(cache, name):
        return np.asarray(cache["layers"][name]).view(np.uint8)

    for name in ("k", "v"):
        assert p_cache["layers"][name].dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(codes(p_cache, name),
                                      ref_codes(r_cache, name))
    for step in range(4):
        r_tok, r_cache = ref.decode_step(rp, r_cache, r_tok)
        p_tok, p_cache = port.decode_step(pp, p_cache, p_tok)
        np.testing.assert_array_equal(p_tok.numpy(), np.asarray(r_tok),
                                      err_msg=str(step))
    for name in ("k", "v"):
        assert p_cache["layers"][name].dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(codes(p_cache, name),
                                      ref_codes(r_cache, name))
    np.testing.assert_array_equal(p_cache["slot_pos"].numpy(),
                                  np.asarray(r_cache["slot_pos"]))
