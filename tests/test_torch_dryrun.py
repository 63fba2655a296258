"""The dry run's account (``repro_torch.launch.dryrun``): each cell's
step run on ``meta`` over an ``AccountMesh``, whose collectives only
count, with K3 and K4 on their ``meta`` shape paths.

Held:

- the CLI over ``--arch all --shape all --mesh single`` writes 40
  records, each a result or a named skip (the reference's skips), with
  ``params_b`` and the model FLOPs equal to the reference's
  ``ArchConfig.param_count`` and ``dryrun.py``'s formula (6 N tokens
  train, 2 N tokens prefill, 2 N B decode, N active);
- argument bytes: the train and prefill cells', and the decode cells' of
  the families whose cache the port lays out as the reference's specs
  do (dense, vlm, MoE: k and v on ``"cache_seq"``), equal the bytes of
  the reference's own ``spec_for`` blocks on a stand-in mesh, an object
  with only ``.shape`` (all ``_resolve`` reads); the SSM state and conv
  caches and whisper's cross-attention cache stay as each rank computed
  them (``runtime.steps.make_prefill_step``), so those decode cells are
  left out;
- collective bytes: for reduced qwen1.5-0.5b and mamba2-370m at (1, 2)
  and (2, 2), train (remat full, and for qwen at (2, 2) also none: the
  backward's re-gathers both ways), prefill and decode, the account's
  ``StepLayout.bytes`` equal those the same steps count on every rank of
  a gloo world;
- FLOPs at one rank: the account's products equal ``FlopCounterMode``
  over the same steps run on the CPU with the attention and the scan
  kept out of the count, and its K3 and K4 operations equal the
  kernels' ``work`` over the calls the CPU run made (forward and, for
  train, backward);
- the kernels' ``meta`` paths return the shapes and add their ``work``;
  ``visible_pairs`` counts ``_visible``'s mask.
"""
import json
import math
import os
import subprocess
import sys
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.flop_counter import FlopCounterMode

import _torch_dist as TD
from repro.configs.base import get as ref_get
from repro.configs.base import registry as ref_registry
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.distribution import sharding as RS
from repro.models.model import Model as RefModel
from repro.models.options import RunOptions as RefOptions
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ssd as SSD
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import AccountMesh
from repro_torch.models import ssd as models_ssd
from repro_torch.models import transformer, whisper
from repro_torch.optim.adamw import leaves, tree_map
from repro_torch.runtime import steps as S
from _torch_threads import cap_torch_threads

cap_torch_threads()

SRC = str(Path(__file__).resolve().parent.parent / "src")
OPTS = dict(remat="full", layer_loop="scan", compute_dtype="float32",
            q_chunk=16, kv_chunk=16)
SMALL = {"train": ShapeSpec("t", "train", 16, 4),
         "prefill": ShapeSpec("p", "prefill", 16, 4),
         "decode": ShapeSpec("d", "decode", 24, 4)}
# (world, mesh, arch, remat, seq_shard_activations): the train step's
# backward re-gathers its saved weights (and, sequence-split, the rows
# of its saved inputs) under remat full (the recompute) and none (the
# saved blocks, ``StepLayout.saved_as_shards``)
BYTES_CASES = ([(world, mesh, arch, "full", False) for world, mesh in
                ((2, (1, 2)), (4, (2, 2)))
                for arch in ("qwen1.5-0.5b", "mamba2-370m")]
               + [(4, (2, 2), "qwen1.5-0.5b", "none", False)]
               + [(world, mesh, arch, remat, True)
                  for world, mesh, remats in ((2, (1, 2), ("none", "full")),
                                              (4, (2, 2), ("full", "none")))
                  for arch, remat in zip(("qwen1.5-0.5b", "mamba2-370m"),
                                         remats)])
SEQ_OPTS = {"seq_shard_activations": True}


@pytest.fixture(scope="module", autouse=True)
def cli(tmp_path_factory):
    """Starts the CLI over every cell of the single mesh in two
    subprocesses at the module's start, without and with
    ``--seq-shard`` (they run while the module's other tests work: the
    tests that read their records come last); a callable that waits for
    them and returns each one's records."""
    tmp = tmp_path_factory.mktemp("dryrun")
    procs = {}
    for name, extra in (("cells", []), ("seq", ["--seq-shard", "--tag",
                                                 "seq"])):
        out = tmp / f"{name}.json"
        procs[name] = (out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "all", "--shape", "all", "--mesh", "single", "--out", str(out)]
            + extra, env={**os.environ, "PYTHONPATH": SRC},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    def wait(name):
        out, proc = procs[name]
        log, _ = proc.communicate(timeout=900)
        assert proc.returncode == 0, log
        return json.loads(out.read_text())
    yield wait
    for _, proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def records(cli):
    return cli("cells")


@pytest.fixture(scope="module")
def seq_records(cli):
    return cli("seq")


# --------------------------- collective bytes -------------------------------
def _opts(remat, seq):
    return {**OPTS, "remat": remat, **(SEQ_OPTS if seq else {})}


def _account_bytes(arch, mesh, rank, remat, seq):
    out = {}
    for kind, shape in SMALL.items():
        model = TD.reduced_model(arch, _opts(remat, seq))
        am = AccountMesh(mesh, ("data", "model"), rank=rank)
        out[kind] = DR.run_step(model, shape, am)["collectives"]
    return out


@pytest.fixture(scope="module")
def bytes_worlds(tmp_path_factory):
    out = {}
    for world in (2, 4):
        cases = [{"arch": a, "opts": _opts(r, q), "mesh": m,
                  "shapes": SMALL}
                 for w, m, a, r, q in BYTES_CASES if w == world]
        out[world] = TD.run_world(TD.rank_step_bytes, world,
                                  tmp_path_factory.mktemp(f"b{world}"),
                                  cases=cases)[0]
    return out


@pytest.mark.parametrize("case", BYTES_CASES,
                         ids=[f"{a}-{m[0]}x{m[1]}-remat_{r}"
                              + ("-seq" if q else "")
                              for _, m, a, r, q in BYTES_CASES])
def test_collective_bytes_equal_the_steps_counts(bytes_worlds, case):
    world, mesh, arch, remat, seq = case
    at = [c for c in BYTES_CASES if c[0] == world].index(case)
    for rank, res in enumerate(bytes_worlds[world]):
        got = _account_bytes(arch, mesh, rank, remat, seq)
        assert got == res[at], (case, rank, got, res[at])
        assert got["decode"]["model"] > 0 and got["prefill"]["model"] > 0
        assert (got["prefill"]["gathered"] > 0) == (mesh[0] > 1)


# ------------------------------ saved bytes ---------------------------------
class _KernelSaves(torch.autograd.Function):
    """``fn(*args)``'s value, saving what the kernel's own autograd
    function saves on the card and no more: K3's ``FlashAttentionFn``
    q, k, v, o and the (B, H, S) float32 log-sum-exp; K4's ``SsdScanFn``
    its inputs and the forward's four scratch tensors. The backward's
    values do not matter here (zeros)."""

    @staticmethod
    def forward(ctx, fn, kw, kind, *args):
        with torch.no_grad():
            out = fn(*args, **kw).contiguous()    # as a kernel writes it
        if kind == "attention":
            q = args[0]
            B, S_, H, _ = q.shape
            lse = torch.empty((B, H, S_), dtype=torch.float32)
            ctx.save_for_backward(*args, out, lse)
        else:
            x, Bm = args[0], args[3]
            scr = SSD.scratch(x, Bm, kw.get("chunk", 256))
            ctx.save_for_backward(*args, scr["dts"], scr["cum"], scr["cb"],
                                  scr["states"])
        ctx.n = len(args)
        return out

    @staticmethod
    def backward(ctx, *gs):
        args = ctx.saved_tensors[:ctx.n]
        return (None, None, None) + tuple(torch.zeros_like(a) for a in args)


class _Box:
    def __init__(self, t):
        self.t = t


def _cpu_saved(arch, shape):
    """The peak bytes the train step's saves hold on the CPU without a
    mesh, counted here by hooks of this test's own: each storage once,
    the params' storages not at all; K3 and K4 saving what their
    kernels' autograd functions save (``_KernelSaves``)."""
    model = TD.reduced_model(arch, _opts("none", False))
    params = S.init_train_state(model, torch.Generator().manual_seed(0),
                                "cpu")["params"]
    params = tree_map(lambda p: p.detach().requires_grad_(True), params)
    ps = leaves(params)
    skip = {p.untyped_storage().data_ptr() for p in ps}
    held, count = {}, {"live": 0, "peak": 0}

    def release(key):
        held[key][0] -= 1
        if not held[key][0]:
            count["live"] -= held.pop(key)[1]

    def pack(t):
        key = t.untyped_storage().data_ptr()
        if key in skip:
            return t
        if key not in held:
            held[key] = [0, t.untyped_storage().nbytes()]
            count["live"] += held[key][1]
            count["peak"] = max(count["peak"], count["live"])
        held[key][0] += 1
        box = _Box(t)
        weakref.finalize(box, release, key)
        return box

    attend, scan = transformer.attend, models_ssd.ssd_scan

    def attend_(q, k, v, **kw):
        return _KernelSaves.apply(attend, kw, "attention", q, k, v)

    def scan_(x, dt, A, Bm, Cm, **kw):
        y, state = scan(x.detach(), dt.detach(), A.detach(), Bm.detach(),
                        Cm.detach(), **kw)
        return (_KernelSaves.apply(lambda *a, **k: scan(*a, **k)[0], kw,
                                   "scan", x, dt, A, Bm, Cm), state)
    transformer.attend, models_ssd.ssd_scan = attend_, scan_
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(
        0, model.cfg.vocab, tuple(v.shape)).astype(np.int32))
        for k, v in model.input_specs(shape)["batch"].items()}
    try:
        with torch.autograd.graph.saved_tensors_hooks(
                pack, lambda b: b if isinstance(b, torch.Tensor) else b.t):
            loss = model.loss(params, batch)
        torch.autograd.grad(loss, ps, allow_unused=True)
    finally:
        transformer.attend, models_ssd.ssd_scan = attend, scan
    return count["peak"]


@pytest.mark.parametrize("arch", ("qwen1.5-0.5b", "mamba2-370m"))
def test_saved_bytes_at_one_rank_equal_the_cpu_steps(arch):
    """``memory.saved_bytes`` of a train step at one rank (remat none) is
    the CPU step's peak of saved bytes, counted apart; a prefill and a
    decode step save nothing."""
    shape = SMALL["train"]
    model = TD.reduced_model(arch, _opts("none", False))
    am = AccountMesh((1, 1), ("data", "model"))
    got = DR.run_step(model, shape, am)["memory"]["saved_bytes"]
    assert got == _cpu_saved(arch, shape) > 0, arch
    for kind in ("prefill", "decode"):
        assert DR.run_step(model, SMALL[kind], am)["memory"][
            "saved_bytes"] == 0


@pytest.mark.parametrize("arch", ("qwen1.5-0.5b", "mamba2-370m"))
def test_sequence_split_saves_fewer_bytes(arch):
    """At (1, 4) the sequence-split train step saves fewer bytes than the
    step without the split (the norms on a quarter of the rows, the
    gathered inputs kept as this rank's rows), and moves more over
    ``"model"``; at (1, 1) the flag changes neither."""
    shape = SMALL["train"]
    got = {}
    for mesh in ((1, 1), (1, 4)):
        for seq in (False, True):
            model = TD.reduced_model(arch, _opts("none", seq))
            got[mesh, seq] = DR.run_step(model, shape, AccountMesh(
                mesh, ("data", "model")))
    assert got[(1, 1), True]["memory"] == got[(1, 1), False]["memory"]
    on, off = got[(1, 4), True], got[(1, 4), False]
    assert on["memory"]["saved_bytes"] < off["memory"]["saved_bytes"]
    assert on["collectives"]["model"] > off["collectives"]["model"] > 0


# --------------------------------- FLOPs ------------------------------------
class _Uncounted(torch.autograd.Function):
    """``fn(*args)`` outside any dispatch mode (so outside the FLOP
    counter), its kernel's work added to ``ops``; the backward runs
    ``fn`` again under autograd, outside the modes too, as a kernel with
    its own backward would (the inputs saved as a kernel saves them)."""

    @staticmethod
    def forward(ctx, fn, kw, ops, *args):
        ctx.fn, ctx.kw, ops_ = fn, kw, ops
        ctx.ops = ops_
        with _disable_current_modes(), torch.no_grad():
            out = fn(*args, **kw)
        ctx.save_for_backward(*args)
        ctx.single = not isinstance(out, tuple)
        ops(args, kw, backward=False)
        return out

    @staticmethod
    def backward(ctx, *gs):
        args = ctx.saved_tensors
        with _disable_current_modes(), torch.enable_grad():
            xs = [a.detach().requires_grad_(True) for a in args]
            out = ctx.fn(*xs, **ctx.kw)
            outs = (out,) if ctx.single else out
            pairs = [(o, g) for o, g in zip(outs, gs) if g is not None]
            got = torch.autograd.grad([o for o, _ in pairs], xs,
                                      [g for _, g in pairs],
                                      allow_unused=True)
        ctx.ops(args, ctx.kw, backward=True)
        return (None, None, None) + tuple(got)


def _cpu_flops(arch, kind, shape):
    """The step of ``kind`` at ``shape`` on the CPU without a mesh, under
    ``FlopCounterMode`` with the attention and the scan run uncounted:
    (products, K3 work, K4 work)."""
    model = TD.reduced_model(arch, OPTS)
    state = S.init_train_state(model, torch.Generator().manual_seed(0),
                               "cpu")
    ops = {"attention": 0, "scan": 0}

    def attn_ops(args, kw, backward):
        q, k = args[0], args[1]
        causal = kw.get("causal", True)
        w = kw.get("window") if causal else None
        ops["attention"] += FA.work(q.shape, k.shape[1], causal, w, backward)

    def scan_ops(args, kw, backward):
        x, Bm = args[0], args[3]
        ops["scan"] += SSD.work(x.shape, Bm.shape[2], Bm.shape[3],
                                kw.get("chunk", 256), backward)

    attend, mha, scan = transformer.attend, whisper.mha, models_ssd.ssd_scan

    def attend_(q, k, v, **kw):
        return _Uncounted.apply(attend, kw, attn_ops, q, k, v)

    def mha_(q, k, v, **kw):
        kw = {"causal": kw.get("causal", True)}
        return _Uncounted.apply(lambda *a, **k: mha(*a, **k), kw, attn_ops,
                                q, k, v)

    def scan_(x, dt, A, Bm, Cm, **kw):
        return _Uncounted.apply(scan, kw, scan_ops, x, dt, A, Bm, Cm)
    transformer.attend = whisper.attend = attend_
    whisper.mha = mha_
    models_ssd.ssd_scan = scan_
    try:
        inputs = model.input_specs(shape)
        rng = np.random.default_rng(0)
        with FlopCounterMode(display=False) as fc:
            if kind == "train":
                batch = {k: torch.as_tensor(rng.integers(
                    0, model.cfg.vocab, tuple(v.shape)).astype(np.int32))
                    for k, v in inputs["batch"].items()}
                S.make_train_step(model)(state, batch)
            elif kind == "prefill":
                batch = {k: torch.as_tensor(rng.integers(
                    0, model.cfg.vocab, tuple(v.shape)).astype(np.int32))
                    for k, v in inputs["batch"].items()}
                S.make_prefill_step(model)(state["params"], batch)
            else:
                cache = model.init_cache(shape.global_batch, shape.seq_len,
                                         "cpu")
                tok = torch.zeros((shape.global_batch,), dtype=torch.int32)
                S.make_decode_step(model)(state["params"], cache, tok)
    finally:
        transformer.attend = whisper.attend = attend
        whisper.mha = mha
        models_ssd.ssd_scan = scan
    return fc.get_total_flops(), ops["attention"], ops["scan"]


@pytest.mark.parametrize("arch", ("qwen1.5-0.5b", "mamba2-370m",
                                  "hymba-1.5b"))
@pytest.mark.parametrize("kind", tuple(SMALL))
def test_flops_at_one_rank_equal_the_cpu_steps(arch, kind):
    model = TD.reduced_model(arch, OPTS)
    got = DR.run_step(model, SMALL[kind],
                      AccountMesh((1, 1), ("data", "model")))["flops"]
    products, attn, scan = _cpu_flops(arch, kind, SMALL[kind])
    assert got["products"] == products, (arch, kind)
    assert got["attention"] == attn and got["scan"] == scan, (arch, kind)
    assert (attn > 0) == (model.cfg.family != "ssm" and kind != "decode")


# ------------------------------- the kernels --------------------------------
@pytest.mark.parametrize("Sq,Skv,causal,window", [
    (16, 16, True, None), (16, 16, True, 5), (7, 12, False, None),
    (12, 7, True, 3), (9, 9, False, 4)])
def test_visible_pairs_counts_the_mask(Sq, Skv, causal, window):
    assert FA.visible_pairs(Sq, Skv, causal, window) == int(
        FA._visible(Sq, Skv, causal, window, "cpu").sum())


def test_meta_paths_return_shapes_and_add_work():
    FA.META_OPS.update(forward=0, backward=0)
    SSD.META_OPS.update(forward=0, backward=0)
    q = torch.empty((2, 16, 4, 8), device="meta", requires_grad=True)
    k = torch.empty((2, 16, 2, 8), device="meta", requires_grad=True)
    o = FA.flash_attention(q, k, k, causal=True, window=4)
    assert o.shape == q.shape and o.device.type == "meta"
    o.sum().backward()
    assert q.grad.shape == q.shape
    assert FA.META_OPS == {"forward": FA.work(q.shape, 16, True, 4),
                           "backward": FA.work(q.shape, 16, True, 4, True)}
    x = torch.empty((2, 32, 4, 8), device="meta")
    dt = torch.empty((2, 32, 4), device="meta")
    A = torch.empty((4,), device="meta")
    Bm = torch.empty((2, 32, 1, 16), device="meta")
    y, state = SSD.ssd_scan(x, dt, A, Bm, Bm, chunk=16)
    assert y.shape == x.shape and state.shape == (2, 4, 8, 16)
    assert SSD.META_OPS["forward"] == SSD.work(x.shape, 1, 16, 16)
    # a CPU tensor still takes the plain version and counts nothing
    FA.flash_attention(torch.randn(1, 4, 2, 8), torch.randn(1, 4, 2, 8),
                       torch.randn(1, 4, 2, 8))
    assert FA.META_OPS["forward"] == FA.work(q.shape, 16, True, 4)


def test_ssd_work_is_the_bounds_count():
    """``ssd.work`` at S a multiple of Q is ``PERF.md``'s count (the
    ``ssd_work`` / ``ssd_bwd_work`` of ``chip_smoke.py``), written out."""
    B, S_, H, P, G, N, Q = 2, 64, 4, 8, 2, 16, 16
    nc, pairs = S_ // Q, Q * (Q + 1) // 2
    fwd = (2 * N * pairs * B * G * nc + 2 * P * pairs * B * H * nc
           + 2 * 2 * Q * N * P * B * H * nc)
    bwd = 2 * (H * (4 * Q * P * N + 2 * P * pairs)
               + G * 2 * N * pairs) * B * nc
    assert SSD.work((B, S_, H, P), G, N, Q) == fwd
    assert SSD.work((B, S_, H, P), G, N, Q, backward=True) == bwd


# ---------------------------- the CLI's records ------------------------------
def test_the_cli_writes_a_record_or_a_named_skip_for_every_cell(records):
    assert len(records) == 40
    cells = {(r["arch"], r["shape"]) for r in records}
    assert cells == {(a, s) for a in ref_registry() for s in REF_SHAPES}
    for r in records:
        assert "error" not in r, r
        if "skipped" in r:
            assert r["shape"] == "long_500k" and r["skipped"], r
            continue
        assert r["mesh"] == "16x16" and r["n_devices"] == 256
        for k in ("memory", "collectives", "flops", "roofline"):
            assert k in r, (r["arch"], r["shape"], k)
        assert r["flops"]["total"] > 0 and r["roofline"]["bound_s"] > 0
    assert sum("skipped" in r for r in records) == 6


def test_params_and_model_flops_are_the_references(records):
    """``params_b`` and ``model_flops_*`` of every runnable cell against
    the reference's ``param_count`` and ``dryrun.py:101-116``."""
    for r in records:
        if "skipped" in r:
            continue
        cfg, shape = ref_get(r["arch"]), REF_SHAPES[r["shape"]]
        assert r["params_b"] == round(cfg.param_count() / 1e9, 3), r["arch"]
        na = cfg.param_count(active_only=True)
        n = shape.global_batch * (1 if shape.kind == "decode"
                                  else shape.seq_len)
        mf = (6.0 if shape.kind == "train" else 2.0) * na * n
        assert r["model_flops_global"] == mf, (r["arch"], r["shape"])
        assert r["model_flops_per_device"] == mf / 256


class _StandIn:
    """A mesh with only ``.shape``: what the reference's ``_resolve``
    reads."""

    def __init__(self, shape):
        self.shape = shape


def _ref_bytes(tree, specs, mesh):
    """The bytes of the blocks ``specs`` cut from ``tree`` (shapes and
    dtypes) on one rank of ``mesh``."""
    if isinstance(tree, dict):
        return sum(_ref_bytes(tree[k], specs[k], mesh) for k in tree)
    n = 1
    for dim, entry in zip(tree.shape, specs):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else entry)
        n *= dim // math.prod(mesh.shape[a] for a in axes)
    return n * np.dtype(tree.dtype).itemsize


def _ref_argument_bytes(arch, shape_name):
    """The reference's argument bytes of a cell on a rank of (16, 16),
    by its own ``spec_for``."""
    mesh = _StandIn({"data": 16, "model": 16})
    model = RefModel(ref_get(arch), RefOptions())
    rules = model.opts.rules()
    shape = REF_SHAPES[shape_name]
    params = _ref_bytes(model.abstract_params(), model.param_specs(mesh),
                        mesh)
    spec = model.input_specs(shape)
    if shape.kind == "decode":
        cm = spec["cache_meta"]
        import jax
        cache_specs = jax.tree.map(
            lambda m: RS.spec_for(m.shape, m.axes, mesh, rules), cm,
            is_leaf=lambda x: hasattr(x, "axes"))
        tok = RS.spec_for((shape.global_batch,), ("batch",), mesh, rules)
        return (params + _ref_bytes(spec["cache"], cache_specs, mesh)
                + _ref_bytes(spec["token"], tok, mesh))
    batch = _ref_bytes(spec["batch"], {
        k: RS.spec_for(v.shape, spec["axes"][k], mesh, rules)
        for k, v in spec["batch"].items()}, mesh)
    if shape.kind == "train":       # params, both moments, count and step
        return 3 * params + 8 + batch
    return params + batch


def test_argument_bytes_are_the_references_specs(records):
    for r in records:
        if "skipped" in r:
            continue
        fam = ref_get(r["arch"]).family
        if REF_SHAPES[r["shape"]].kind == "decode" and fam not in (
                "dense", "vlm", "moe"):
            continue
        assert r["memory"]["argument_bytes"] == _ref_argument_bytes(
            r["arch"], r["shape"]), (r["arch"], r["shape"])


def test_the_cli_writes_seq_shard_records_for_every_cell(records,
                                                         seq_records):
    """``--seq-shard``: a record or the same named skip for every cell,
    tagged, with ``saved_bytes``; a decode step and whisper ignore the
    flag (their collectives are the records' without it), the train
    steps and prefills of the other families move at least as many
    bytes over ``"model"`` (their f and g as gathers and scatters of
    rows) and llama3-8b's train step more."""
    assert len(seq_records) == len(records) == 40
    base = {(r["arch"], r["shape"]): r for r in records}
    for r in seq_records:
        b = base[r["arch"], r["shape"]]
        assert r["tag"] == "seq" and "error" not in r, r
        if "skipped" in b:
            assert r["skipped"] == b["skipped"]
            continue
        assert r["memory"]["saved_bytes"] >= 0
        kind = REF_SHAPES[r["shape"]].kind
        if kind == "decode" or ref_get(r["arch"]).family == "encdec":
            assert r["collectives"] == b["collectives"], r["arch"]
        else:
            assert r["collectives"]["model"] >= b["collectives"]["model"]
    on = {(r["arch"], r["shape"]): r for r in seq_records}
    assert on["llama3-8b", "train_4k"]["collectives"]["model"] > \
        base["llama3-8b", "train_4k"]["collectives"]["model"]
