"""The port's MoE family (``repro_torch.models.moe`` and the mixtral
configs) against the reference's on the CPU.

``moe_ffn`` alone, float32, against ``repro.models.moe.moe_ffn`` on the
same inputs: the plain case, token groups (``group_size``), a capacity
that drops tokens, routers that tie (every expert equal, and two equal
columns: ``jax.lax.top_k`` takes the lower index first, so the first and
second choices, and through the cumsum the dropped tokens, depend on
the order), and the Switch aux loss; y within 1e-5 (float32 expert
products summed in another order), the aux loss within 1e-6. In
bfloat16, y within two bfloat16 ulps of max|y|: the expert products
round to bfloat16 after float32 sums in another order.

The model at ``get("mixtral-8x7b").reduced()`` (2 layers of d_model 64,
4 heads of 16 over 4 kv heads, window 32, 4 experts top-2, d_ff 128)
with the reference's random params carried across: logits at S = 37
and 80 (the banded path in chunks of Sq and of the window), the
prefill's k and v and 4 decode steps past the window within 2e-5 (as
the other families), tokens exactly, a GQA variant (8 heads over 2, R =
4 as mixtral's), and each layer's routing (the experts every token
chose) equal to the reference's.

bfloat16 at the default RunOptions. The routing is a discrete choice:
two bfloat16 forwards whose residual streams differ by an ulp route a
token differently whenever its second and third expert probabilities
lie within that ulp, and a re-routed token's FFN output changes by the
size of an expert's output, far past ``bf16_logit_tolerance`` (whose
derivation assumes every step is continuous). The reference itself does
this: its scanned and its unrolled layer loops route tokens of this
test's inputs apart, and their logits differ by 1.9 and 1.6 (tolerance
0.13 and 0.14). So the logits are held to ``bf16_logit_tolerance`` with
the port's routing pinned to the reference's choices (the reference run
unrolled and eager, its ``jax.lax.top_k`` results recorded, the port's
``moe.route`` replaying them: the gates stay the port's own
probabilities; measured 0.047 and 0.043), and the free-running choices
agree on at least 97% of tokens a layer (measured: all in layer 0, 238
and 237 of 240 in layer 1).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get as ref_get
from repro.models import moe as RM
from repro.models.model import Model as RefModel
from repro.models.options import RunOptions as RefOptions
from repro_torch.configs.base import get
from repro_torch.convert import params_from_arrays
from repro_torch.models import moe as PM
from repro_torch.models.model import Model
from repro_torch.models.options import RunOptions, bf16_logit_tolerance
from _torch_threads import cap_torch_threads

cap_torch_threads()

ARCH = "mixtral-8x7b"
OPTS = dict(remat="none", layer_loop="scan", compute_dtype="float32",
            q_chunk=16, kv_chunk=16)
TOL = 2e-5
GQA = dict(n_heads=8, n_kv_heads=2)
BF16_ULP = 2.0 ** -7


def _pair(opts=OPTS, **replace):
    rc, pc = ref_get(ARCH).reduced(), get(ARCH).reduced()
    if replace:
        rc = dataclasses.replace(rc, **replace)
        pc = dataclasses.replace(pc, **replace)
    ref = RefModel(rc, RefOptions(**opts))
    port = Model(pc, RunOptions(**{k: v for k, v in opts.items()
                                   if k in RunOptions.__dataclass_fields__}))
    rp = ref.init(jax.random.PRNGKey(0))
    pp = params_from_arrays(jax.tree.map(np.asarray, rp), device="cpu")
    return ref, port, rp, pp


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _tokens(S, seed=0, B=3):
    return np.random.default_rng(seed).integers(0, 256, (B, S))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=tol)


# ------------------------------ routing hooks -------------------------------

def _ref_routes(ref_cfg, rp, tokens, compute_dtype, monkeypatch):
    """Each layer's top-k indices (B,S,K) in the reference's forward, run
    unrolled and eager so that ``jax.lax.top_k`` sees concrete arrays,
    and its logits."""
    ref = RefModel(ref_cfg, RefOptions(remat="none", layer_loop="unroll",
                                       compute_dtype=compute_dtype))
    seen = []
    top_k = jax.lax.top_k

    def record(x, k):
        vals, idx = top_k(x, k)
        seen.append(np.asarray(idx))
        return vals, idx

    with monkeypatch.context() as m:
        m.setattr(jax.lax, "top_k", record)
        logits = ref.forward_logits(rp, {"tokens": jnp.asarray(tokens)})
    return seen, np.asarray(logits.astype(jnp.float32))


def _port_routes(port, pp, tokens, monkeypatch, pinned=None):
    """The port's logits and each layer's indices; with ``pinned`` (a
    list of per-layer indices) the router takes those choices instead,
    its gates the port's own probabilities at them."""
    seen = []
    route = PM.route

    def hook(probs, k):
        if pinned is None:
            vals, idx = route(probs, k)
        else:
            idx = torch.as_tensor(np.array(pinned[len(seen)]),
                                  dtype=torch.int64)
            vals = torch.gather(probs, -1, idx)
        seen.append(idx.numpy())
        return vals, idx

    with monkeypatch.context() as m:
        m.setattr(PM, "route", hook)
        logits = port.forward_logits(pp, {"tokens": torch.from_numpy(tokens)})
    return seen, logits


# ------------------------------- moe_ffn ------------------------------------

def _moe_inputs(seed, B=2, S=24, d=32, E=4, f=48, router=None):
    rng = np.random.default_rng(seed)
    p = {"router": rng.normal(0, d ** -0.5, (d, E)),
         "w_gate": rng.normal(0, d ** -0.5, (E, d, f)),
         "w_up": rng.normal(0, d ** -0.5, (E, d, f)),
         "w_down": rng.normal(0, f ** -0.5, (E, f, d))}
    if router == "zeros":
        p["router"] = np.zeros((d, E))
    elif router == "twins":
        p["router"][:, 2] = p["router"][:, 1]
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(0, 1, (B, S, d)).astype(np.float32)
    return p, x


MOE_CASES = {
    "plain": dict(),
    "groups": dict(group_size=8),
    "groups_unused": dict(group_size=7),       # S % 7 != 0: no regroup
    "drops": dict(capacity_factor=0.5),
    "ties_all": dict(capacity_factor=0.75, router="zeros"),
    "ties_twins": dict(capacity_factor=0.5, router="twins"),
    "top1": dict(top_k=1, capacity_factor=1.0),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_ffn_matches_reference(case):
    kw = dict(MOE_CASES[case])
    p, x = _moe_inputs(len(case), router=kw.pop("router", None))
    kw.setdefault("top_k", 2)
    want, want_aux = RM.moe_ffn({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), n_experts=4, **kw)
    got, aux = PM.moe_ffn({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x), n_experts=4, **kw)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert aux.dtype == torch.float32 and aux.shape == ()
    _close(got, want, 1e-5)
    assert abs(float(aux) - float(want_aux)) <= 1e-6
    if case.startswith("ties"):
        # the tie really is one, and it dropped tokens (both choices)
        logits = torch.from_numpy(x) @ torch.from_numpy(p["router"])
        assert bool((logits[..., 1] == logits[..., 2]).all())
        dropped = (got.abs().sum(-1) == 0).sum()
        assert int(dropped) > 0


def test_route_breaks_ties_toward_the_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                          [0.3, 0.2, 0.3, 0.2]])
    vals, idx = PM.route(probs, 2)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(idx.numpy(), [[0, 1], [1, 3], [0, 2]])


def test_moe_ffn_bfloat16_within_two_ulps():
    p, x = _moe_inputs(7)
    want, want_aux = RM.moe_ffn({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x, jnp.bfloat16), n_experts=4,
                                top_k=2)
    got, aux = PM.moe_ffn({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x).to(torch.bfloat16),
                          n_experts=4, top_k=2)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    _close(got, want, 2 * BF16_ULP * float(np.abs(want).max()))
    assert abs(float(aux) - float(want_aux)) <= 1e-6


# ------------------------------- the model ----------------------------------

def test_configs_and_param_layout_match(pair):
    ref, port, rp, pp = pair
    for arch in ("mixtral-8x7b", "mixtral-8x22b"):
        mine, theirs = get(arch), ref_get(arch)
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab", "hd", "mlp", "window",
                  "global_layers", "rope_theta", "norm_eps",
                  "tie_embeddings", "source"):
            assert getattr(mine, f) == getattr(theirs, f), (arch, f)
        assert dataclasses.asdict(mine.moe) == dataclasses.asdict(theirs.moe)
        for m, t in ((mine, theirs), (mine.reduced(), theirs.reduced())):
            assert m.param_count() == t.param_count()
            assert m.param_count(active_only=True) == \
                t.param_count(active_only=True)
    full = get(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.hd, full.d_ff, full.vocab, full.window,
            full.moe.n_experts, full.moe.top_k) == (
                32, 4096, 32, 8, 128, 14336, 32000, 4096, 8, 2)
    assert (port.cfg.moe.n_experts, port.cfg.moe.top_k) == (4, 2)
    assert port.opts.capacity_factor == ref.opts.capacity_factor == 1.25
    assert port.opts.moe_group == ref.opts.moe_group == 0

    def shapes(tree):
        return {k: (shapes(v) if isinstance(v, dict) else tuple(v.shape))
                for k, v in tree.items()}
    params = port.init(torch.Generator().manual_seed(0), "cpu")
    assert shapes(params) == shapes(jax.tree.map(np.asarray, rp))
    lay = params["layers"]
    assert tuple(lay["router"].shape) == (2, 64, 4)
    assert tuple(lay["w_gate"].shape) == tuple(lay["w_up"].shape) \
        == (2, 4, 64, 128)
    assert tuple(lay["w_down"].shape) == (2, 4, 128, 64)
    # each expert's matrices at 1/sqrt(fan-in): d for w_gate, f for w_down
    assert abs(float(lay["w_gate"].std()) - 64 ** -0.5) < 0.01
    assert abs(float(lay["w_down"].std()) - 128 ** -0.5) < 0.01


def test_full_config_param_count():
    """mixtral-8x7b's 46.7 B parameters, from the port's meta and the
    reference's, without materialising either."""
    from repro_torch.models.model import _leaves
    ref_meta = RefModel(ref_get(ARCH)).meta()
    want = sum(int(np.prod(m.shape)) for m in jax.tree.leaves(
        ref_meta, is_leaf=lambda x: hasattr(x, "shape")))
    got = sum(int(np.prod(m.shape)) for _, m in _leaves(Model(get(ARCH))
                                                       .meta()))
    assert got == want
    assert 46e9 < got < 47.5e9


@pytest.mark.parametrize("S", (37, 80))
def test_forward_logits_and_routing_match(pair, S, monkeypatch):
    ref, port, rp, pp = pair
    tokens = _tokens(S)
    want = ref.forward_logits(rp, {"tokens": jnp.asarray(tokens)})
    got = port.forward_logits(pp, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (3, S, 256)
    _close(got, want)
    r_idx, _ = _ref_routes(ref.cfg, rp, tokens, "float32", monkeypatch)
    p_idx, _ = _port_routes(port, pp, tokens, monkeypatch)
    assert len(r_idx) == len(p_idx) == 2
    for a, b in zip(p_idx, r_idx):
        np.testing.assert_array_equal(a, b)


def test_prefill_and_decode_match(pair):
    ref, port, rp, pp = pair
    tokens = _tokens(37)
    r_tok, r_cache = ref.prefill(rp, {"tokens": jnp.asarray(tokens)},
                                 cache_len=48)
    p_tok, p_cache = port.prefill(pp, {"tokens": torch.from_numpy(tokens)},
                                  cache_len=48)
    np.testing.assert_array_equal(p_tok.numpy(), np.asarray(r_tok))
    assert set(p_cache["layers"]) == set(r_cache["layers"]) == {"k", "v"}
    assert p_cache["layers"]["k"].shape == (2, 3, 48, 4, 16)
    for name in ("k", "v"):
        _close(p_cache["layers"][name], r_cache["layers"][name])
    for step in range(4):             # positions 37..40, past the window
        r_tok, r_cache = ref.decode_step(rp, r_cache, r_tok)
        p_tok, p_cache = port.decode_step(pp, p_cache, p_tok)
        np.testing.assert_array_equal(p_tok.numpy(), np.asarray(r_tok),
                                      err_msg=str(step))
        for name in ("k", "v"):
            _close(p_cache["layers"][name], r_cache["layers"][name])
        np.testing.assert_array_equal(p_cache["slot_pos"].numpy(),
                                      np.asarray(r_cache["slot_pos"]))


def test_greedy_decode_equals_incremental_forward():
    """Greedy decode after prefill == the argmax of the full forward over
    the growing sequence, across the window's edge, at a capacity factor
    of E / K = 2, where no expert can overflow (C >= S). At the default
    1.25 the two differ, as the reference's do: a forward's tokens
    compete for C = ceil(K S 1.25 / E) slots and the last ones are the
    first dropped, while a decode step routes one token a row to one
    slot per expert."""
    _, port, _, pp = _pair(dict(OPTS, capacity_factor=2.0))
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


@pytest.mark.parametrize("S", (37, 80))
def test_gqa_variant_matches(S):
    """8 query heads over 2 kv heads (mixtral's R = 4)."""
    ref, port, rp, pp = _pair(**GQA)
    tokens = _tokens(S, seed=2)
    want = ref.forward_logits(rp, {"tokens": jnp.asarray(tokens)})
    got = port.forward_logits(pp, {"tokens": torch.from_numpy(tokens)})
    _close(got, want)
    r_tok, r_cache = ref.prefill(rp, {"tokens": jnp.asarray(tokens)},
                                 cache_len=S + 4)
    p_tok, p_cache = port.prefill(pp, {"tokens": torch.from_numpy(tokens)},
                                  cache_len=S + 4)
    assert p_cache["layers"]["k"].shape == (2, 3, S + 4, 2, 16)
    for _ in range(2):
        r_tok, r_cache = ref.decode_step(rp, r_cache, r_tok)
        p_tok, p_cache = port.decode_step(pp, p_cache, p_tok)
        np.testing.assert_array_equal(p_tok.numpy(), np.asarray(r_tok))


def test_token_groups_in_the_model(monkeypatch):
    """``moe_group`` 16 splits each 64-token row into 4 dispatch groups,
    on both sides."""
    opts = dict(OPTS, moe_group=16)
    ref, port, rp, pp = _pair(opts)
    tokens = _tokens(64, seed=4)
    want = ref.forward_logits(rp, {"tokens": jnp.asarray(tokens)})
    got = port.forward_logits(pp, {"tokens": torch.from_numpy(tokens)})
    _close(got, want)


@pytest.mark.parametrize("seed", (0, 1))
def test_logits_at_default_options_with_pinned_routing(seed, monkeypatch):
    """bfloat16 at the default RunOptions: the port's logits within
    ``bf16_logit_tolerance`` of the reference's, the port's routing
    pinned to the reference's choices; the free-running choices agree on
    at least 97% of tokens in each layer (see the module's docstring)."""
    ref_cfg, cfg = ref_get(ARCH).reduced(), get(ARCH).reduced()
    rp = RefModel(ref_cfg).init(jax.random.PRNGKey(0))
    pp = params_from_arrays(jax.tree.map(np.asarray, rp), device="cpu")
    port = Model(cfg, RunOptions())
    assert port.opts.compute_dtype == "bfloat16"
    tokens = _tokens(80, seed=seed)
    r_idx, want = _ref_routes(ref_cfg, rp, tokens, "bfloat16", monkeypatch)
    _, got = _port_routes(port, pp, tokens, monkeypatch, pinned=r_idx)
    assert got.dtype == torch.bfloat16
    tol = bf16_logit_tolerance(cfg.n_layers, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)
    free, _ = _port_routes(port, pp, tokens, monkeypatch)
    for a, b in zip(free, r_idx):
        same = (np.sort(a, -1) == np.sort(b, -1)).all(-1)
        assert same.mean() >= 0.97, same.mean()


def test_prefill_and_decode_run_at_default_options():
    ref = RefModel(ref_get(ARCH).reduced(), RefOptions())
    port = Model(get(ARCH).reduced(), RunOptions())
    rp = ref.init(jax.random.PRNGKey(0))
    pp = params_from_arrays(jax.tree.map(np.asarray, rp), device="cpu")
    nxt, cache = port.prefill(pp, {"tokens": torch.from_numpy(_tokens(40))},
                              cache_len=48)
    assert cache["layers"]["k"].dtype == torch.bfloat16
    for _ in range(3):
        nxt, cache = port.decode_step(pp, cache, nxt)
        assert nxt.shape == (3,)
        assert bool(((nxt >= 0) & (nxt < port.cfg.vocab)).all())


def test_serve_cli_serves_mixtral_on_the_cpu():
    from repro_torch.launch.serve import main
    stats = main(["--arch", ARCH, "--requests", "3", "--batch", "2",
                  "--prompt-len", "40", "--gen", "3", "--device", "cpu"])
    assert stats["tokens"] == 3 * 3
    assert [o.shape for o in stats["outputs"]] == [(2, 3), (1, 3)]
    for o in stats["outputs"]:
        assert ((o >= 0) & (o < 256)).all()
