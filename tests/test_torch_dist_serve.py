"""Serving across ranks (``runtime.steps.make_prefill_step`` /
``make_decode_step`` with a mesh, ``sharding.ModelSplit``'s
``heads_to``, ``merge_softmax`` and ``argmax``, ``launch.serve`` over a
world) on worlds of gloo ranks (``tests/_torch_dist.py``), against the
reference's ``Model.prefill`` / ``decode_step`` on the CPU.

Each case draws the port's params (reduced configs, seed 0), carries
them to the reference as arrays, and runs one prefill of a 4-row batch
with room for 12 more tokens, then 3 decode steps, float32: on every
rank of a world its rows and its blocks, and in the test process the
reference's steps on the whole batch. Held:

- tokens: equal to the reference's, every step, every rank;
- caches: each rank's blocks gathered whole (``TD.whole_cache``) after
  the prefill and after the last step, within TOL = 2e-5 absolute of
  the reference's (``tests/test_torch_model.py``'s tolerance: float32
  products and softmax sums in other orders; here also the row-parallel
  products' parts added by an all-reduce and the decode's softmax merged
  over the ranks' slots, another sum order of the same float32 terms);
- logits: the last position's, whole, within TOL of the port's steps
  without a mesh on the same params (the reference's steps return no
  logits);
- a world of one rank: bit for bit the steps without a mesh (tokens,
  logits, every cache leaf);
- the heads K3 and K4 saw: each rank's H/m (``TD.heads_seen``);
- bytes: ``StepLayout.bytes`` of the prefill and of one decode step
  against the reckoning written out in ``_reckoned``.

The cases: reduced qwen1.5-0.5b, mamba2-370m, hymba-1.5b, internvl2-26b
(embeds) and whisper-large-v3 at (1, 2), (1, 4) and (2, 2); mixtral-8x7b
at (1, 2) under moe_sharding tp, cap and ep; qwen with 15 prompt tokens
at (1, 2) (19 slots: the cache whole on both ranks, no merge); mixtral
(every layer windowed, W = 32) with 44 prompt tokens at (1, 4): rank 0's
12 slots hold positions 0-11, outside every decode step's window, so it
sees no key and must enter the merge with weight 0, not NaN. At (1, 4)
the default cases (24 slots, 6 a rank) leave rank 3's slots empty (-1)
through every decode step: the same trap.

With ``seq_shard_activations`` (``SEQ_CASES``: qwen, mamba2 and hymba at
(1, 2) and (1, 4)) the prefill splits its residual stream's rows over
``"model"``; the same reference (the flag changes no value there) and
TOL hold its tokens, caches and logits. A decode step, which ignores
the flag, is bit for bit the same with and without it from one cache,
and so is whisper's whole serving path (``FLAG_IGNORED``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as TD
from repro.configs.base import get as ref_get
from repro.models.model import Model as RefModel
from repro.models.options import RunOptions as RefOptions
from repro_torch.convert import params_from_arrays
from _torch_threads import cap_torch_threads

cap_torch_threads()

OPTS = dict(remat="none", layer_loop="scan", compute_dtype="float32",
            q_chunk=16, kv_chunk=16)
TOL = 2e-5
ROWS, PROMPT, GEN, STEPS, FRAMES = 4, 12, 12, 3, 24
FAMILIES = ("qwen1.5-0.5b", "mamba2-370m", "hymba-1.5b", "internvl2-26b",
            "whisper-large-v3")
# (world, mesh, arch, moe_sharding, prompt)
CASES = ([(2, (1, 2), a, "tp", PROMPT) for a in FAMILIES]
         + [(2, (1, 2), "mixtral-8x7b", r, PROMPT)
            for r in ("tp", "cap", "ep")]
         + [(2, (1, 2), "qwen1.5-0.5b", "tp", 15)]
         + [(4, (1, 4), a, "tp", PROMPT) for a in FAMILIES]
         + [(4, (2, 2), a, "tp", PROMPT) for a in FAMILIES]
         + [(4, (1, 4), "mixtral-8x7b", "tp", 44)])
ONE = FAMILIES + ("mixtral-8x7b",)
SEQ_OPTS = {"seq_shard_activations": True}
# sequence-split prefills: (world, mesh, arch)
SEQ_CASES = [(w, m, a) for w, m in ((2, (1, 2)), (4, (1, 4)))
             for a in ("qwen1.5-0.5b", "mamba2-370m", "hymba-1.5b")]
# with and without the flag, at (1, 2): a decode step from one cache
# (qwen, hymba), whisper's prefill and decode steps
FLAG_IGNORED = ("qwen1.5-0.5b", "hymba-1.5b", "whisper-large-v3")
# layouts on custom reduced configs at (1, 4), against the port's steps
# without a mesh (the reference has no such config): each rank's one
# query head reads one of 2 kv heads; 12 query heads over 3 kv heads (a
# rank's 3 read kv heads 0, 1, 1: a kv head computed on two ranks, moved
# from the first); hymba with 6 heads and 6 SSM heads, which do not split
# over 4 (its mixer gathered at use, every rank every head, its own slots)
LAYOUTS = {"kv_one": ("qwen1.5-0.5b", {"n_kv_heads": 2}),
           "kv_per_query_head": ("qwen1.5-0.5b",
                                 {"n_heads": 12, "n_kv_heads": 3}),
           "heads_gathered": ("hymba-1.5b", {"n_heads": 6,
                                             "n_kv_heads": 2})}


def _case_id(case):
    world, mesh, arch, moe, prompt = case
    return (f"{arch}-{mesh[0]}x{mesh[1]}"
            + (f"-{moe}" if arch == "mixtral-8x7b" else "")
            + ("" if prompt == PROMPT else f"-prompt{prompt}"))


def _inputs(arch, prompt, cfg=None):
    """The port's params (numpy) and the global batch of ``arch`` (its
    reduced config with ``cfg``'s fields replaced)."""
    model = TD.reduced_model(arch, OPTS, cfg)
    params = TD.host(model.init(torch.Generator().manual_seed(0), "cpu"))
    cfg = model.cfg
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab, (ROWS, prompt))
             .astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (ROWS, FRAMES, cfg.d_model)).astype(np.float32)
    if cfg.frontend_tokens:
        batch["embeds"] = rng.standard_normal(
            (ROWS, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return params, batch, cfg.frontend_tokens + prompt + GEN


def _case(case):
    world, mesh, arch, moe, prompt = case
    params, batch, cache_len = _inputs(arch, prompt)
    return {"arch": arch, "opts": {**OPTS, "moe_sharding": moe},
            "mesh": mesh, "params": params, "batch": batch,
            "cache_len": cache_len, "steps": STEPS}


def _layout_case(name):
    arch, cfg = LAYOUTS[name]
    params, batch, cache_len = _inputs(arch, PROMPT, cfg)
    return {"arch": arch, "opts": OPTS, "cfg": cfg, "mesh": (1, 4),
            "params": params, "batch": batch, "cache_len": cache_len,
            "steps": STEPS}


def _seq_case(case):
    world, mesh, arch = case
    c = _case((world, mesh, arch, "tp", PROMPT))
    c["opts"] = {**c["opts"], **SEQ_OPTS}
    return c


def _flag_case(arch):
    """Whisper's serving path with the flag (held against its ``CASES``
    run without it), or a decode step with and without it."""
    c = _case((2, (1, 2), arch, "tp", PROMPT))
    if arch == "whisper-large-v3":
        c["opts"] = {**c["opts"], **SEQ_OPTS}
        return c
    return {**c, "pair": True}


def _after_cases(worlds, world):
    """Every rank's runs after a world's ``CASES`` and ``LAYOUTS``."""
    first = (sum(c[0] == world for c in CASES)
             + (len(LAYOUTS) if world == 4 else 0))
    return [r[first:] for r in worlds[world]]


def _reference(arch, prompt):
    """The reference's tokens and caches (numpy) of the prefill and each
    decode step, on the port's params."""
    params, batch, cache_len = _inputs(arch, prompt)
    model = RefModel(ref_get(arch).reduced(), RefOptions(**OPTS))
    rp = jax.tree.map(jnp.asarray, params)
    tok, cache = model.prefill(rp, {k: jnp.asarray(v)
                                    for k, v in batch.items()},
                               cache_len=cache_len)
    toks, caches = [np.asarray(tok)], [jax.tree.map(np.asarray, cache)]
    for _ in range(STEPS):
        tok, cache = model.decode_step(rp, cache, tok)
        toks.append(np.asarray(tok))
    caches.append(jax.tree.map(np.asarray, cache))
    return {"tokens": toks, "caches": caches}


def _plain(case):
    """The port's steps without a mesh: each step's tokens and logits."""
    c = _case(case)
    model = TD.reduced_model(c["arch"], c["opts"])
    p = params_from_arrays(c["params"], "cpu")
    b = {k: torch.as_tensor(v) for k, v in c["batch"].items()}
    tok, cache, lg = model.prefill(p, b, cache_len=c["cache_len"],
                                   logits=True)
    out = [(tok.numpy(), lg.numpy())]
    for _ in range(STEPS):
        tok, cache, lg = model.decode_step(p, cache, tok, logits=True)
        out.append((tok.numpy(), lg.numpy()))
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every rank's ``serve_steps`` of every case, world by world, and a
    world of one rank that runs each family at (1, 1) and without a
    mesh."""
    out = {}
    for world in (2, 4):
        cases = [_case(c) for c in CASES if c[0] == world]
        if world == 4:
            cases += [_layout_case(n) for n in LAYOUTS]
        cases += [_seq_case(c) for c in SEQ_CASES if c[0] == world]
        if world == 2:
            cases += [_flag_case(a) for a in FLAG_IGNORED]
        out[world] = TD.run_world(TD.rank_serve, world,
                                  tmp_path_factory.mktemp(f"s{world}"),
                                  cases=cases)[0]
    ones = [{**_case((1, (1, 1), a, "tp", PROMPT)), "plain": True}
            for a in ONE]
    out[1] = TD.run_world(TD.rank_serve, 1, tmp_path_factory.mktemp("s1"),
                          cases=ones)[0]
    return out


@pytest.fixture(scope="module")
def refs():
    keys = {(c[2], c[4]) for c in CASES}
    return {k: _reference(*k) for k in sorted(keys)}


def _runs(worlds, case):
    world = case[0]
    at = [c for c in CASES if c[0] == world].index(case)
    return [r[at] for r in worlds[world]]


def _flat_cache(cache):
    """A cache's arrays by name (the layers' leaves and whisper's)."""
    return {k: np.asarray(v, dtype=np.float32)
            for k, v in {**cache.get("layers", {}), **cache}.items()
            if k != "layers"}


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_split_serving_matches_the_reference(worlds, refs, case):
    """Tokens equal to the reference's on every rank and step; the whole
    caches after the prefill and the last step within TOL of the
    reference's; the logits within TOL of the port's steps without a
    mesh; every value finite; K3 / K4 at this rank's heads."""
    runs = _runs(worlds, case)
    world, mesh, arch, moe, prompt = case
    ref = refs[(arch, prompt)]
    plain = _plain(case)
    for r in runs:
        for i, (st, want, (_, lg)) in enumerate(zip(r["steps"],
                                                    ref["tokens"], plain)):
            np.testing.assert_array_equal(st["tokens"], want,
                                          err_msg=f"{case} step {i}")
            assert np.isfinite(st["logits"]).all(), (case, i)
            np.testing.assert_allclose(st["logits"], lg, rtol=0, atol=TOL,
                                       err_msg=f"{case} step {i}")
    for got, want in zip(runs[0]["caches"], ref["caches"]):
        want = _flat_cache(want)
        for k, v in got.items():
            assert np.isfinite(v).all(), (case, k)
            np.testing.assert_allclose(v, want[k], rtol=0, atol=TOL,
                                       err_msg=f"{case} {k}")
    m = mesh[1]
    cfg = TD.reduced_model(arch, OPTS).cfg
    want = set()
    if cfg.family != "ssm":
        want.add(("attention", cfg.n_heads // m, cfg.n_kv_heads // m))
    if cfg.ssm is not None:
        di = cfg.d_inner if cfg.family == "ssm" else cfg.n_heads * cfg.hd
        want.add(("ssd", di // cfg.ssm.head_dim // m,
                  max(cfg.ssm.n_groups // m, 1)))
    assert set(runs[0]["heads"]) == want, (case, runs[0]["heads"])


@pytest.mark.parametrize("arch", ONE)
def test_a_world_of_one_is_the_path_without_a_mesh_bit_for_bit(worlds,
                                                               arch):
    """At (1, 1) the prefill and decode steps with a mesh give the steps
    without one, bit for bit: tokens, logits, every cache leaf."""
    r = worlds[1][0][ONE.index(arch)]
    p = r["plain"]
    for i, (got, want) in enumerate(zip(r["steps"] + r["caches"],
                                        p["steps"] + p["caches"])):
        TD.same_bits(got, want, (arch, i))
    assert r["bytes"]["prefill"] == r["bytes"]["decode"] == {
        "gathered": 0, "reduced": 0, "model": 0}


def _reckoned(arch, mesh, prompt):
    """The bytes a rank moves over ``"model"`` for the prefill and one
    decode step of a dense model (float32, 4 bytes a value), written
    out: the prefill's embedding ``g`` and two ``g`` a layer, each of
    the (B, S, d) activation; the split argmax's two all-reduces, the
    max (B,) float32 and the index (B,) int64; the all-to-all's output,
    k and v of every layer in this rank's slots (B, Sc / m, G, hd), or
    every slot where Sc % m != 0. A decode step: the embedding's ``g``
    and two ``g`` a layer of (B, 1, d); a layer's gathered q (B, 1, H,
    hd), k and v (B, 1, G, hd); where the slots split, the merge's max
    (B, 1, H) and its o and row sum (B, 1, H, hd + 1); the argmax."""
    cfg = TD.reduced_model(arch, OPTS).cfg
    n, m = mesh
    B, S, Sc = ROWS // n, prompt, prompt + GEN
    d, H, G, hd, L = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, \
        cfg.n_layers
    argmax = B * 4 + B * 8
    slots = Sc // m if Sc % m == 0 else Sc
    prefill = 4 * (B * S * d * (1 + 2 * L) + 2 * L * B * slots * G * hd) \
        + argmax
    merge = (B * H + B * H * (hd + 1)) if Sc % m == 0 else 0
    decode = 4 * (B * d * (1 + 2 * L)
                  + L * (B * H * hd + 2 * B * G * hd + merge)) + argmax
    return prefill, decode


@pytest.mark.parametrize("case", [c for c in CASES
                                  if c[2] == "qwen1.5-0.5b"],
                         ids=_case_id)
def test_bytes_equal_the_written_reckoning(worlds, case):
    """qwen's bytes over ``"model"`` a rank for the prefill and one
    decode step equal ``_reckoned``; gathered is ZeRO-3's over
    ``"data"`` (none at a data axis of 1), nothing is reduced."""
    world, mesh, arch, moe, prompt = case
    prefill, decode = _reckoned(arch, mesh, prompt)
    for r in _runs(worlds, case):
        assert r["bytes"]["prefill"]["model"] == prefill, case
        assert r["bytes"]["decode"]["model"] == decode * STEPS, case
        for step in ("prefill", "decode"):
            assert r["bytes"][step]["reduced"] == 0
            assert (r["bytes"][step]["gathered"] > 0) == (mesh[0] > 1)


def test_serve_across_ranks_gathers_every_request(tmp_path):
    """``launch.serve.serve(..., mesh=)`` on a (2, 2) world of the
    reduced qwen: every rank returns every request's tokens, equal to
    ``serve`` without a mesh on the same draws (``init_params``), and
    ``per_step_bytes`` divides the layouts' counts by the batches and
    steps."""
    res, _ = TD.run_world(TD.rank_serve_cli, 4, tmp_path)
    for r in res:
        for got, want in zip(r["outputs"], res[0]["plain"]):
            np.testing.assert_array_equal(got, want)
        assert r["per"]["decode"]["model"] > 0
        assert r["per"]["prefill"]["gathered"] > 0


@pytest.mark.parametrize("arch", ONE)
def test_init_params_draws_model_init_on_the_cpu(arch):
    """``init_params`` draws a layer slice at a time; on the CPU's
    generator that is ``Model.init``'s whole-leaf draw, bit for bit
    (every slice of the zoo holds a multiple of 16 values)."""
    from repro_torch.runtime.steps import init_params
    model = TD.reduced_model(arch, OPTS)
    want = model.init(torch.Generator().manual_seed(3), "cpu")
    got = init_params(model, torch.Generator().manual_seed(3), "cpu")
    TD.same_bits(TD.host(got), TD.host(want), arch)


@pytest.mark.parametrize("name", LAYOUTS)
def test_serving_layouts_the_heads_do_not_split(worlds, name):
    """Custom layouts at (1, 4) against the port's steps without a mesh
    (``TD.plain_serve``): tokens equal, logits and the whole caches
    within TOL; the heads K3 saw: one query head over one kv head, 3
    query heads over their kv heads (2 distinct on ranks 1 and 2), or
    every head where the mixer stays gathered."""
    at = len([c for c in CASES if c[0] == 4]) + list(LAYOUTS).index(name)
    case = _layout_case(name)
    want = TD.plain_serve(case)
    runs = [r[at] for r in worlds[4]]
    for r in runs:
        for st, w in zip(r["steps"], want["steps"]):
            np.testing.assert_array_equal(st["tokens"], w["tokens"])
            np.testing.assert_allclose(st["logits"], w["logits"], rtol=0,
                                       atol=TOL, err_msg=name)
    for got, w in zip(runs[0]["caches"], want["caches"]):
        for k, v in got.items():
            np.testing.assert_allclose(v, w[k], rtol=0, atol=TOL,
                                       err_msg=f"{name} {k}")
    heads = {a[1:] for r in runs for a in r["heads"] if a[0] == "attention"}
    arch, over = LAYOUTS[name]
    cfg = TD.reduced_model(arch, OPTS, over).cfg
    if name == "heads_gathered":
        assert heads == {(cfg.n_heads, cfg.n_kv_heads)}, heads
    else:
        assert {h for h, _ in heads} == {cfg.n_heads // 4}, heads



@pytest.mark.parametrize("case", SEQ_CASES,
                         ids=[f"{a}-{m[0]}x{m[1]}" for _, m, a in SEQ_CASES])
def test_sequence_split_prefill_matches_the_reference(worlds, refs, case):
    """A sequence-split prefill and the decode steps after it: tokens
    equal to the reference's on every rank and step, the whole caches
    within TOL of the reference's, the logits within TOL of the port's
    steps without a mesh; K3 / K4 at this rank's heads over every row;
    the prefill's bytes over ``"model"`` more than without the flag
    (each ``g`` a reduce-scatter and each ``f`` an all-gather, counted
    by their inputs and outputs), the decode steps' the same."""
    world, mesh, arch = case
    at = [c for c in SEQ_CASES if c[0] == world].index(case)
    runs = [r[at] for r in _after_cases(worlds, world)]
    ref = refs[(arch, PROMPT)]
    plain = _plain((world, mesh, arch, "tp", PROMPT))
    for r in runs:
        for i, (st, want, (_, lg)) in enumerate(zip(r["steps"],
                                                    ref["tokens"], plain)):
            np.testing.assert_array_equal(st["tokens"], want,
                                          err_msg=f"{case} step {i}")
            assert np.isfinite(st["logits"]).all(), (case, i)
            np.testing.assert_allclose(st["logits"], lg, rtol=0, atol=TOL,
                                       err_msg=f"{case} step {i}")
    for got, want in zip(runs[0]["caches"], ref["caches"]):
        want = _flat_cache(want)
        for k, v in got.items():
            assert np.isfinite(v).all(), (case, k)
            np.testing.assert_allclose(v, want[k], rtol=0, atol=TOL,
                                       err_msg=f"{case} {k}")
    without = _runs(worlds, (world, mesh, arch, "tp", PROMPT))
    assert set(runs[0]["heads"]) == set(without[0]["heads"])
    for r, w in zip(runs, without):
        assert r["bytes"]["decode"] == w["bytes"]["decode"]
        assert r["bytes"]["prefill"]["model"] > w["bytes"]["prefill"]["model"]


@pytest.mark.parametrize("arch", FLAG_IGNORED)
def test_decode_and_whisper_ignore_the_sequence_split(worlds, arch):
    """At (1, 2): a decode step from one cache gives the same token,
    logits, cache and bytes, bit for bit, with the flag and without it;
    whisper's prefill and decode steps with the flag are its ``CASES``
    run without it, bit for bit."""
    n = sum(c[0] == 2 for c in SEQ_CASES)
    runs = [r[n + FLAG_IGNORED.index(arch)] for r in _after_cases(worlds, 2)]
    if arch == "whisper-large-v3":
        without = _runs(worlds, (2, (1, 2), arch, "tp", PROMPT))
        for r, w in zip(runs, without):
            TD.same_bits(dict(enumerate(r["steps"])),
                         dict(enumerate(w["steps"])), arch)
            assert r["bytes"] == w["bytes"]
        TD.same_bits(dict(enumerate(runs[0]["caches"])),
                     dict(enumerate(without[0]["caches"])), arch)
        return
    for r in runs:
        TD.same_bits(r[True], r[False], arch)
        assert r[True]["bytes"]["model"] > 0
