"""Training across ranks (``runtime.steps.make_train_step(..., mesh=)``,
``distribution.sharding``, ``launch.mesh.TrainMesh``, the sharded
checkpoint, ``runtime.elastic``, the launcher over a world) on worlds of
gloo ranks (``tests/_torch_dist.py``), against the reference on the CPU.

The reference's step is jitted here unsharded, and in a subprocess that
forces 8 host devices (``--xla_force_host_platform_device_count`` must
be set before JAX starts) on a (2, 2) mesh with its in/out shardings;
that subprocess also saves a checkpoint from a (4, 2) mesh. The port's
ranks start from the reference's initial state (carried across with
``convert.params_from_arrays``) and run the same global batches, each
rank its own rows.

Tolerances, each with its reason:
- against the reference: ``tests/test_torch_train.py``'s train-step
  tolerances, LOSS_TOL = 1e-5 relative for the loss and the clipped
  global norm, one float32 ulp for the rate, GRAD_TOL = 1e-5 of each
  leaf's largest magnitude for the moments (linear in the gradients).
  Splitting the batch over W ranks only changes the order of the
  gradient's float32 sums (W partial sums added by the collectives), at
  most about W * 2^-24 of the sum of magnitudes, far inside those.
  The params: the runs make one update (the first step's rate is 0 at
  ``count`` 0), p - lr (s + wd p) with s = m^/(sqrt(v^) + eps), m^ and v^
  the moments over their bias corrections. With the moments within
  t_m and t_v of the reference's, an element's s moves by at most
  (t_m / bc1 + |m^| sqrt(t_v / bc2) / d) / d, d = max(sqrt(v^) -
  sqrt(t_v / bc2), 0) + eps, all from the reference's moments
  (``TD.update_bound``); so each param within GRAD_TOL of its leaf's
  largest magnitude (its rounding) plus lr times that. Where sqrt(v^)
  is near eps (a gradient of 1e-8 from a token seen once) this allows
  up to about lr: there the update follows the gradient's size, which
  float32 sums in another order move by a large share (seen: 4% of lr
  for the port's step without a mesh against the reference's on
  reduced internvl2-26b); elsewhere it is far tighter than lr.
- a world of one rank against the port's step without a mesh: bit for
  bit (every collective is the identity).
- where the reference's own step is not finite on these batches
  (reduced hymba-1.5b: its gradient is NaN on row 1 of the first batch,
  in the reference's layer scan, jitted or not; the port's is finite),
  the sharded step is held to the port's step without a mesh, whose
  agreement with the reference ``tests/test_torch_train.py`` holds on
  other rows, within the same tolerances, and must be finite.
- checkpoints and their restore: bit for bit.

The model axis's split (``"model"`` over more than one rank: each rank
its own heads, hidden columns, experts or slots and vocab rows, joined
by ``f`` and ``g``) only reorders float32 sums too (the row-parallel
products' parts added by an all-reduce, the vocab's log-sum-exp in
parts), so its steps are held to the same tolerances; each leaf's
gradient of one split step is held to GRAD_TOL of the leaf's largest
magnitude against the step without a mesh. Layouts the reference's
rules cannot split (heads that do not divide by the model axis), and the
kv heads that do not, run on custom reduced configs against the port's
step without a mesh (the reference has no such config).
"""
import dataclasses
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_dist as TD
from repro.checkpoint import ckpt as RCK
from repro.configs.base import get as ref_get
from repro.data.tokens import make_batch_iter as ref_batches
from repro.models.model import Model as RefModel
from repro.models.options import RunOptions as RefOptions
from repro.runtime import steps as RS
from repro_torch.checkpoint import ckpt
from repro_torch.convert import params_from_arrays
from repro_torch.distribution.sharding import tree_leaves
from repro_torch.launch.mesh import MeshShape
from repro_torch.models.model import Model
from repro_torch.configs.base import get
from repro_torch.models.options import RunOptions
from repro_torch.models.transformer import layer_modes, split_plan
from repro_torch.optim.adamw import leaves
from repro_torch.runtime import steps as S
from _torch_threads import cap_torch_threads

cap_torch_threads()

SRC = str(Path(__file__).resolve().parent.parent / "src")
OPTS = dict(remat="none", layer_loop="scan", compute_dtype="float32",
            q_chunk=16, kv_chunk=16)
KW = dict(peak_lr=1e-2, warmup=2, total_steps=10, clip=1.0,
          weight_decay=0.1)
ARCHS = ("qwen1.5-0.5b", "mixtral-8x7b", "mamba2-370m", "hymba-1.5b",
         "whisper-large-v3", "internvl2-26b")
BATCH, SEQ, STEPS = 4, 32, 2
# each family's mesh at 4 ranks: a model axis of 2 where it has one
MESH4 = {"qwen1.5-0.5b": (2, 2), "mixtral-8x7b": (4, 1),
         "mamba2-370m": (4, 1), "hymba-1.5b": (2, 2),
         "whisper-large-v3": (4, 1), "internvl2-26b": (2, 2)}
# the model axis's split: (world, mesh, arch, moe_sharding,
# seq_shard_activations), beside the (2, 2) cases of MESH4; the
# sequence-split steps of every family that reads the flag
SPLIT_ARCHS = ("qwen1.5-0.5b", "mamba2-370m", "whisper-large-v3",
               "internvl2-26b", "hymba-1.5b")
SEQ_ARCHS = ("qwen1.5-0.5b", "mamba2-370m", "internvl2-26b", "hymba-1.5b")
MOE = ("tp", "cap", "ep")
SPLIT = ([(2, (1, 2), a, "tp", False) for a in SPLIT_ARCHS]
         + [(2, (1, 2), "mixtral-8x7b", r, False) for r in MOE]
         + [(4, (1, 4), a, "tp", False) for a in SPLIT_ARCHS]
         + [(4, (2, 2), a, "tp", False) for a in ("mamba2-370m",
                                                  "whisper-large-v3")]
         + [(2, (1, 2), a, "tp", True) for a in SEQ_ARCHS]
         + [(2, (1, 2), "mixtral-8x7b", r, True) for r in MOE]
         + [(4, (1, 4), a, "tp", True) for a in SEQ_ARCHS]
         + [(4, (2, 2), "mamba2-370m", "tp", True)])
# layouts on custom reduced configs at (1, 4), against the port's step
# without a mesh: each rank's one query head reads one of 2 kv heads; 12
# query heads over 3 kv heads (a rank's 3 read kv heads 0, 1, 1: one
# kv head per query head); hymba with 6 heads and 6 SSM heads, which do
# not split over 4 (its mixer gathered at use, its FFN split)
LAYOUTS = {"kv_one": ("qwen1.5-0.5b", {"n_kv_heads": 2}),
           "kv_per_query_head": ("qwen1.5-0.5b",
                                 {"n_heads": 12, "n_kv_heads": 3}),
           "heads_gathered": ("hymba-1.5b", {"n_heads": 6,
                                             "n_kv_heads": 2})}
# sequence-split layouts at (1, 4), against the port's step without a
# mesh: hymba's mixer computed whole (its rows gathered at entry, its
# own rows kept), and 30 rows, which do not split over 4 (whole rows)
SEQ_LAYOUTS = {"heads_gathered": ("hymba-1.5b", {"n_heads": 6,
                                                 "n_kv_heads": 2}, SEQ),
               "rows_do_not_divide": ("qwen1.5-0.5b", {}, SEQ - 2)}
SEQ_OPTS = {"seq_shard_activations": True}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batches(arch, n=STEPS, microbatches=1):
    it = ref_batches(ref_get(arch).reduced(), global_batch=BATCH,
                     seq_len=SEQ, seed=3)
    return [_np(next(it)) for _ in range(n)]


def _reference(arch, microbatches=1):
    """The reference's initial state and its jitted step's metrics and
    final state over ``_batches``."""
    opts = RefOptions(**OPTS, microbatches=microbatches)
    model = RefModel(ref_get(arch).reduced(), opts)
    state = RS.init_train_state(model, jax.random.PRNGKey(0))
    init = _np(state)
    step = jax.jit(RS.make_train_step(model, **KW))
    metrics = []
    for b in _batches(arch):
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"init": init, "metrics": metrics, "state": _np(state)}


def _case(arch, ref, mesh, microbatches=1, **extra):
    return {"arch": arch, "opts": {**OPTS, "microbatches": microbatches},
            "mesh": mesh, "state": ref["init"], "batches": _batches(arch),
            "kw": KW, "plain": arch == "hymba-1.5b", **extra}


def _split_case(ref, mesh, arch, moe, seq=False):
    c = _case(arch, ref, mesh, grads=True)
    c["opts"].update(moe_sharding=moe, seq_shard_activations=seq)
    return c


def _layout_case(name, mesh=(1, 4), seq=False):
    """A ``LAYOUTS`` case, or with ``seq`` a ``SEQ_LAYOUTS`` one (its
    batches cut to its rows)."""
    arch, cfg, rows = SEQ_LAYOUTS[name] if seq else LAYOUTS[name] + (SEQ,)
    model = TD.reduced_model(arch, OPTS, cfg)
    init = S.init_train_state(model, torch.Generator().manual_seed(0), "cpu")
    batches = _batches(arch)
    if rows != SEQ:
        batches = [{"tokens": b["tokens"][:, :rows]} for b in batches]
    return {"arch": arch, "opts": {**OPTS, **(SEQ_OPTS if seq else {})},
            "cfg": cfg, "mesh": mesh, "state": TD.host(init),
            "batches": batches, "kw": KW, "plain": True}


# ------------------------------ the reference --------------------------------
def mesh_main(out_dir):
    """The reference on meshes of host devices (run in a subprocess whose
    ``XLA_FLAGS`` force 8 of them): qwen's jitted step with its in/out
    shardings on a (2, 2) mesh over ``_batches`` (``sharded.npz``), and a
    train state stepped once on a (4, 2) mesh and saved (zlib) under
    ``out_dir/ck42`` at step 1. Then with ``seq_shard_activations`` on
    a (2, 2) mesh (``seq.npz``): mamba2's step, and the error qwen's
    raises (its q, k and v ask for ``"seq"`` and ``"tensor"`` on the
    same mesh axis)."""
    import jax.numpy as jnp
    from repro.distribution import sharding as shd
    from repro.runtime.elastic import make_mesh_from
    assert len(jax.devices()) >= 8, jax.devices()
    RCK.zstd = None
    arch = "qwen1.5-0.5b"
    model = RefModel(ref_get(arch).reduced(), RefOptions(**OPTS))
    batches = _batches(arch)
    res = {}
    for shape, n in (((2, 2), 4), ((4, 2), 8)):
        mesh = make_mesh_from(jax.devices()[:n], model_axis=shape[1])
        with shd.use_mesh(mesh, model.opts.rules()):
            sh = RS.train_state_shardings(model, mesh)
            key = jax.random.PRNGKey(0 if n == 4 else 1)
            state = jax.device_put(RS.init_train_state(model, key), sh)
            step = jax.jit(RS.make_train_step(model, **KW),
                           in_shardings=(sh, None),
                           out_shardings=(sh, None))
            if n == 4:
                for i, b in enumerate(batches):
                    state, m = step(state, b)
                    for k, v in m.items():
                        res[f"metrics/{i}/{k}"] = np.asarray(v)
                for k, v in TD.flat(_np(state)).items():
                    res[f"state/{k}"] = v
            else:
                state, _ = step(state, batches[0])
                RCK.save(str(Path(out_dir) / "ck42"), jax.device_get(state),
                         step=1)
                assert jnp.isfinite(state["params"]["embed"]).all()
    np.savez(Path(out_dir) / "sharded.npz", **res)
    res = {}
    mesh = make_mesh_from(jax.devices()[:4], model_axis=2)
    for arch in ("mamba2-370m", "qwen1.5-0.5b"):
        model = RefModel(ref_get(arch).reduced(),
                         RefOptions(**OPTS, seq_shard_activations=True))
        with shd.use_mesh(mesh, model.opts.rules()):
            sh = RS.train_state_shardings(model, mesh)
            state = jax.device_put(
                RS.init_train_state(model, jax.random.PRNGKey(0)), sh)
            step = jax.jit(RS.make_train_step(model, **KW),
                           in_shardings=(sh, None),
                           out_shardings=(sh, None))
            try:
                for i, b in enumerate(_batches(arch)):
                    state, m = step(state, b)
                    for k, v in m.items():
                        res[f"{arch}/metrics/{i}/{k}"] = np.asarray(v)
            except Exception as e:      # noqa: BLE001 (recorded)
                res[f"{arch}/error"] = np.asarray(f"{type(e).__name__}: {e}")
                continue
            for k, v in TD.flat(_np(state)).items():
                res[f"{arch}/state/{k}"] = v
    np.savez(Path(out_dir) / "seq.npz", **res)


@pytest.fixture(scope="module")
def mesh_ref(tmp_path_factory):
    """Starts the reference's mesh subprocess (it runs while the module's
    other fixtures work); a callable that waits for it and returns its
    directory."""
    out = tmp_path_factory.mktemp("mesh")
    tests = Path(__file__).resolve().parent
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    code = (f"import sys; sys.path[:0] = [{str(tests)!r}, {SRC!r}]; "
            f"import test_torch_dist_train as T; T.mesh_main({str(out)!r})")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)

    def wait():
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, log
        return out
    yield wait
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def refs(mesh_ref):
    return {arch: _reference(arch) for arch in ARCHS}


@pytest.fixture(scope="module")
def worlds(refs, tmp_path_factory):
    """Each world's runs of every family (and, at 2 ranks, qwen with 2
    microbatches), then the split cases of that world (``SPLIT``, in
    order), and at 4 ranks the ``LAYOUTS`` and the ``SEQ_LAYOUTS``, at 2
    qwen at (2, 1) with the sequence split asked for (``_extra``)."""
    out = {}
    for world in (2, 4):
        cases = [_case(a, refs[a], (2, 1) if world == 2 else MESH4[a])
                 for a in ARCHS]
        if world == 2:
            cases.append(_case("qwen1.5-0.5b", refs["qwen1.5-0.5b"], (2, 1),
                               microbatches=2))
        cases += [_split_case(refs[a], mesh, a, moe, seq)
                  for w, mesh, a, moe, seq in SPLIT if w == world]
        if world == 4:
            cases += [_layout_case(n) for n in LAYOUTS]
            cases += [_layout_case(n, seq=True) for n in SEQ_LAYOUTS]
        else:
            c = _case("qwen1.5-0.5b", refs["qwen1.5-0.5b"], (2, 1))
            c["opts"].update(SEQ_OPTS)
            cases.append(c)
        out[world] = TD.run_world(TD.rank_train, world,
                                  tmp_path_factory.mktemp(f"w{world}"),
                                  cases=cases)[0]
    return out


def _split_runs(worlds, case):
    """Every rank's run of a ``SPLIT`` case."""
    world = case[0]
    at = [c for c in SPLIT if c[0] == world].index(case)
    first = len(ARCHS) + (1 if world == 2 else 0)
    return [r[first + at] for r in worlds[world]]


def _extra(worlds, world, at=0):
    """Every rank's run of the ``at``-th case after a world's ``SPLIT``
    cases and ``LAYOUTS``."""
    first = (len(ARCHS) + (1 if world == 2 else len(LAYOUTS))
             + sum(c[0] == world for c in SPLIT))
    return [r[first + at] for r in worlds[world]]


def _split_id(case):
    world, mesh, arch, moe, seq = case
    return (f"{arch}-{mesh[0]}x{mesh[1]}"
            + (f"-{moe}" if arch == "mixtral-8x7b" else "")
            + ("-seq" if seq else ""))


# ------------------------------- the step -----------------------------------
@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_the_reference(worlds, refs, world, arch):
    """One rank's whole state after two steps within the train-step
    tolerances of the reference's; every rank's loss, norm and rate the
    same, bit for bit (they are all-reduced); the mixtral aux loss is
    the global batch's (its loss holds only so)."""
    i = ARCHS.index(arch)
    runs = [r[i] for r in worlds[world]]
    ref = refs[arch]
    if not all(np.isfinite(m["gnorm"]) for m in ref["metrics"]):
        assert arch == "hymba-1.5b", arch       # the reference's NaN
        ref = runs[0]["plain"]
        assert all(np.isfinite(m["gnorm"]) for m in ref["metrics"])
    TD.held(runs[0], ref, (arch, world))
    for r in runs[1:]:
        assert r["metrics"] == runs[0]["metrics"] and r["state"] is None
    assert runs[0]["bytes"]["gathered"] > 0 and runs[0]["bytes"]["reduced"] > 0
    split = (world == 4 and MESH4[arch][1] > 1)
    assert (runs[0]["bytes"]["model"] > 0) == split


# ---------------------------- the model axis --------------------------------
@pytest.mark.parametrize("case", SPLIT, ids=_split_id)
def test_model_axis_split_matches_the_reference(worlds, refs, case):
    """Each family split over the model axis (mixtral under each of the
    three ``moe_sharding`` rules) within the train-step tolerances of the
    reference's step, with and without the sequence split (the
    reference's numbers without it: a sharding constraint changes no
    value); every rank's metrics the same. At (1, m) no leaf is gathered
    (each ``"model"`` dim is used where it lies), the activations'
    collectives move bytes over ``"model"``, and K3 and K4 see this
    rank's H/m heads (the kv heads G/m, the SSM's B and C one group),
    over every row. The residual stream between the blocks is each
    rank's (B / data, S, d), or with the sequence split its S/m rows,
    and then every gathered input that autograd saves is kept as those
    rows."""
    world, mesh, arch, moe, seq = case
    runs = _split_runs(worlds, case)
    ref = refs[arch]
    if arch == "hymba-1.5b":                   # the reference's NaN
        ref = runs[0]["plain"]
    TD.held(runs[0], ref, case)
    for r in runs[1:]:
        assert r["metrics"] == runs[0]["metrics"] and r["state"] is None
    m = mesh[1]
    got = runs[0]["bytes"]
    assert got["model"] > 0
    if mesh[0] == 1:
        assert got["gathered"] == 0, got
    cfg = get(arch).reduced()
    want = set()
    if cfg.family != "ssm":
        want.add(("attention", cfg.n_heads // m, cfg.n_kv_heads // m))
    if cfg.ssm is not None:
        di = cfg.d_inner if cfg.family == "ssm" else cfg.n_heads * cfg.hd
        want.add(("ssd", di // cfg.ssm.head_dim // m, 1))
    for r in runs:
        assert set(r["heads"]) == want, (r["heads"], want)
    rows = sum(v.shape[1] for v in _batches(arch, 1)[0].values())
    local = (BATCH // mesh[0], rows // m if seq else rows, cfg.d_model)
    for r in runs:
        if cfg.family == "encdec":      # its own layer loops, no flag
            break
        assert r["rows"]["stream"] == [local], (case, r["rows"])
        assert r["rows"]["kept"] == ([local] if seq else []), (case, r["rows"])


@pytest.mark.parametrize("case", SPLIT, ids=_split_id)
def test_model_axis_split_gradients_leaf_by_leaf(worlds, refs, case):
    """Every leaf's gradient of one split step (the first batch at the
    initial state, gathered whole) within GRAD_TOL of the leaf's largest
    magnitude of the step's without a mesh (and without the sequence
    split): a replicated leaf summed twice over the model group, or a
    per-head leaf not summed, is off by its whole size; so is a norm
    that a sequence-split step reads on its own rows, not summed."""
    world, mesh, arch, moe, seq = case
    got = _split_runs(worlds, case)[0]["grads"]
    model = Model(get(arch).reduced(), RunOptions(**OPTS, moe_sharding=moe))
    params = params_from_arrays(refs[arch]["init"], "cpu")["params"]
    names = list(TD.flat(params))
    _, want = S.value_and_grad(model, params, _batches(arch)[0])
    assert len(got) == len(want) == len(names)
    for name, g, w in zip(names, got, want):
        w = w.numpy()
        err = float(np.abs(g.astype(np.float64) - w).max())
        assert err <= TD.GRAD_TOL * float(np.abs(w).max()) + 1e-30, \
            (case, name, err, float(np.abs(w).max()))


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_model_axis_layouts_the_heads_do_not_split(worlds, name):
    """Custom reduced configs at (1, 4) against the port's step without a
    mesh: kv heads that do not divide by the model axis (each rank reads
    the kv heads its query heads read, their projections gathered and
    their gradients summed over the group), and heads that do not divide
    (hymba's mixer gathered at use and computed whole on every rank, its
    FFN split)."""
    at = len(ARCHS) + sum(c[0] == 4 for c in SPLIT) \
        + list(LAYOUTS).index(name)
    runs = [r[at] for r in worlds[4]]
    TD.held(runs[0], runs[0]["plain"], name)
    for r in runs[1:]:
        assert r["metrics"] == runs[0]["metrics"]
    arch, over = LAYOUTS[name]
    cfg = dataclasses.replace(get(arch).reduced(), **over)
    H, G = cfg.n_heads, cfg.n_kv_heads
    got = runs[0]["bytes"]
    if name == "heads_gathered":
        plan = split_plan(cfg, RunOptions(**OPTS), 4)
        assert (plan.attn, plan.ssm, plan.mlp, plan.vocab) == \
            (False, False, True, True)
        assert got["gathered"] > 0
        assert set(runs[0]["heads"]) == {("attention", H, G),
                                        ("ssd", H, 1)}
        return
    assert got["gathered"] > 0 and got["reduced"] > 0    # wk, wv: shared
    # (query heads, kv heads) on ranks 0-3: kv_one 1 over 1 each;
    # kv_per_query_head 3 over kv heads (0), (0, 1, 1), (1, 2, 2), (2)
    reads = ([{("attention", 1, 1)}] * 4 if name == "kv_one" else
             [{("attention", 3, 1)}, {("attention", 3, 3)},
              {("attention", 3, 3)}, {("attention", 3, 1)}])
    assert [set(r["heads"]) for r in runs] == reads


@pytest.mark.parametrize("name", list(SEQ_LAYOUTS))
def test_sequence_split_layouts(worlds, name):
    """Sequence-split custom layouts at (1, 4) against the port's step
    without a mesh: hymba's mixer, whose heads do not split, computed
    whole on every row between its rows' gather and its own rows' cut
    (its FFN split on the rows), and 30 rows, which do not split over 4:
    the step keeps whole rows, its bytes those of the step without the
    flag."""
    runs = _extra(worlds, 4, list(SEQ_LAYOUTS).index(name))
    TD.held(runs[0], runs[0]["plain"], name)
    for r in runs[1:]:
        assert r["metrics"] == runs[0]["metrics"]
    arch, over, rows = SEQ_LAYOUTS[name]
    cfg = dataclasses.replace(get(arch).reduced(), **over)
    d = cfg.d_model
    if name == "heads_gathered":
        assert set(runs[0]["heads"]) == {("attention", cfg.n_heads,
                                          cfg.n_kv_heads),
                                         ("ssd", cfg.n_heads, 1)}
        for r in runs:
            assert r["rows"] == {"stream": [(BATCH, rows // 4, d)],
                                 "kept": [(BATCH, rows // 4, d)]}
        return
    for r in runs:
        assert r["rows"] == {"stream": [(BATCH, rows, d)], "kept": []}
    assert set(runs[0]["heads"]) == {("attention", cfg.n_heads // 4,
                                      cfg.n_kv_heads // 4)}


def test_a_model_axis_of_one_ignores_the_sequence_split(worlds):
    """qwen at (2, 1) with the sequence split asked for: bit for bit the
    step without it (every metric, the whole state, the bytes)."""
    want = [r[ARCHS.index("qwen1.5-0.5b")] for r in worlds[2]]
    got = _extra(worlds, 2)
    for g, w in zip(got, want):
        assert g["metrics"] == w["metrics"] and g["bytes"] == w["bytes"]
    TD.same_bits(got[0]["state"], want[0]["state"], "(2, 1) seq")


@pytest.mark.parametrize("arch", SEQ_ARCHS)
def test_a_world_of_one_with_the_sequence_split_is_bit_for_bit(
        refs, arch, seq_one):
    """At (1, 1) the flag changes nothing: the step with it is the step
    without a mesh, bit for bit."""
    run = seq_one[SEQ_ARCHS.index(arch)]
    assert run["metrics"] == run["plain"]["metrics"]
    TD.same_bits(run["state"], run["plain"]["state"], arch)
    assert run["bytes"] == {"gathered": 0, "reduced": 0, "model": 0}


@pytest.fixture(scope="module")
def seq_one(refs, tmp_path_factory):
    cases = [_case(a, refs[a], (1, 1)) for a in SEQ_ARCHS]
    for c in cases:
        c["opts"].update(SEQ_OPTS)
    return TD.run_world(TD.rank_train, 1, tmp_path_factory.mktemp("seq1"),
                        cases=cases, plain=True)[0][0]


def test_sequence_split_matches_the_references_mesh_step(worlds, mesh_ref):
    """mamba2 at (2, 2) with the sequence split against the reference's
    own step with ``seq_shard_activations`` jitted with the train
    state's shardings on a (2, 2) mesh of host devices."""
    got = np.load(mesh_ref() / "seq.npz")
    arch = "mamba2-370m"
    ref = {"metrics": [{k: float(got[f"{arch}/metrics/{i}/{k}"])
                        for k in ("loss", "gnorm", "lr")}
                       for i in range(STEPS)],
           "state": {k[len(arch) + 7:]: got[k] for k in got.files
                     if k.startswith(f"{arch}/state/")}}
    run = _split_runs(worlds, (4, (2, 2), arch, "tp", True))[0]
    TD.held({"metrics": run["metrics"], "state": TD.flat(run["state"])},
            ref, "(2, 2) mesh, sequence split")


def test_the_references_sequence_split_refuses_split_heads(mesh_ref):
    """The reference lowers its sequence split only where no head split
    is asked for: qwen's q, k and v ask for ``"seq"`` and ``"tensor"``
    on ``"model"`` at once, and its step raises (a deliberate difference:
    the port computes both)."""
    got = np.load(mesh_ref() / "seq.npz")
    err = str(got["qwen1.5-0.5b/error"])
    assert err.startswith("DuplicateSpecError"), err
    assert "duplicate entries for `model`" in err, err
    assert "mamba2-370m/error" not in got.files


@pytest.mark.parametrize("m", (2, 4, 16))
def test_split_plan_names_what_stays_gathered(m):
    """The zoo at its published widths: every leaf a split block keeps
    local has its ``"model"`` dim in the reference's spec, and a leaf
    whose gradient is summed over the group is replicated there or
    gathered whole; hymba-1.5b (25 heads, 25 SSM heads) keeps its mixer
    gathered at any model axis of 2, 4 or 16, and llama3-8b at 16 reads
    its 8 kv heads in part (``"shared"``)."""
    from repro_torch.configs.base import registry
    from repro_torch.launch.mesh import MeshShape
    layout = MeshShape((1, m), ("data", "model"))
    for name, cfg in sorted(registry().items()):
        for moe in ("tp", "cap", "ep"):
            model = Model(cfg, RunOptions(moe_sharding=moe))
            plan = split_plan(cfg, model.opts, m)
            specs = model.param_specs(layout)
            modes = layer_modes(plan, model.opts)
            for key in ("layers", "enc_layers", "dec_layers"):
                for leaf, spec in specs.get(key, {}).items():
                    if isinstance(spec, dict):
                        continue
                    mode = modes.get(leaf)
                    if mode == "local":
                        assert "model" in spec[1:], (name, m, leaf, spec)
            if plan.vocab:
                assert specs["embed"][0] == "model", (name, m)
    hymba = split_plan(get("hymba-1.5b"), RunOptions(), m)
    assert not hymba.attn and not hymba.ssm and hymba.mlp == (5504 % m == 0)
    llama = split_plan(get("llama3-8b"), RunOptions(), m)
    assert llama.attn and llama.kv == (m <= 8) and llama.mlp and llama.vocab


def test_microbatches_match_the_reference(worlds):
    ref = _reference("qwen1.5-0.5b", microbatches=2)
    runs = [r[len(ARCHS)] for r in worlds[2]]
    TD.held(runs[0], ref, "microbatches")
    assert runs[1]["metrics"] == runs[0]["metrics"]


def test_model_axis_matches_the_references_mesh_step(worlds, mesh_ref):
    """qwen on a (2, 2) mesh (the model axis 2) against the reference's
    step jitted with the train state's shardings on a (2, 2) mesh of
    host devices."""
    got = np.load(mesh_ref() / "sharded.npz")
    ref = {"metrics": [{k: float(got[f"metrics/{i}/{k}"])
                        for k in ("loss", "gnorm", "lr")}
                       for i in range(STEPS)],
           "state": {k[6:]: got[k] for k in got.files
                     if k.startswith("state/")}}
    run = worlds[4][ARCHS.index("qwen1.5-0.5b")][0]
    state = {k: v for k, v in TD.flat(run["state"]).items()}
    TD.held({"metrics": run["metrics"], "state": state}, ref, "(2, 2) mesh")


@pytest.mark.parametrize("arch", ARCHS)
def test_a_world_of_one_is_the_unsharded_step_bit_for_bit(refs, arch,
                                                          tmp_path):
    cases = [_case(arch, refs[arch], (1, 1))]
    if arch == "qwen1.5-0.5b":
        cases.append(_case(arch, refs[arch], (1, 1), microbatches=2))
    runs = TD.run_world(TD.rank_train, 1, tmp_path, cases=cases,
                        plain=True)[0][0]
    for run in runs:
        assert run["metrics"] == run["plain"]["metrics"]
        TD.same_bits(run["state"], run["plain"]["state"], arch)
        assert run["bytes"] == {"gathered": 0, "reduced": 0, "model": 0}


# ------------------------- checkpoints and elastic ---------------------------
def test_elastic_save_on_four_ranks_restore_on_two(tmp_path):
    """The reference's elastic test mirrored: a state saved from 4 ranks
    on a (2, 2) mesh, restored and stepped on 2 ranks on (1, 2). The
    file holds the whole state; the restore is it, bit for bit; the step
    after it is the unsharded step's from the file."""
    arch = "qwen1.5-0.5b"
    batch = _batches(arch)[0]
    kw = dict(arch=arch, opts=OPTS, ckpt_dir=str(tmp_path / "ck"),
              batch=batch, kw=KW)
    saved = TD.run_world(TD.rank_elastic_save, 4, tmp_path / "w4",
                         mesh=(2, 2), **kw)[0]
    assert ckpt.latest_step(str(tmp_path / "ck")) == 1
    file = ckpt.restore(str(tmp_path / "ck"), 1, device="cpu")
    TD.same_bits(TD.host(file), saved[0], "the file")
    assert all(s is None for s in saved[1:])
    back = TD.run_world(TD.rank_elastic_restore, 2, tmp_path / "w2",
                        mesh=(1, 2), **kw)[0]
    model = Model(get(arch).reduced(), RunOptions(**OPTS))
    plain, m = S.make_train_step(model, **KW)(
        file, {k: torch.as_tensor(v) for k, v in batch.items()})
    for r, got in enumerate(back):
        assert got["step"] == 1 and got["metrics"] == back[0]["metrics"]
        assert got["refused"] == [
            "a (16, 16) mesh over ('data', 'model') needs 256 ranks; the "
            "world has 2", "a (2, 16, 16) mesh over ('pod', 'data', "
            "'model') needs 512 ranks; the world has 2"]
    TD.same_bits(back[0]["restored"], saved[0], "restored")
    TD.held({"metrics": [back[0]["metrics"]], "state": back[0]["state"]},
          {"metrics": [{k: float(v) for k, v in m.items()}],
           "state": TD.host(plain)}, "elastic")
    # a rank's block of wq (spec (None, data, model)) on (1, 2): the model
    # axis halves its columns
    wq = saved[0]["params"]["layers"]["wq"]
    h = wq.shape[2] // 2
    for r in range(2):
        np.testing.assert_array_equal(back[r]["local"]["params"]["layers"]
                                      ["wq"], wq[:, :, r * h:(r + 1) * h])


def test_references_mesh_checkpoint_restored_on_two_ranks(mesh_ref,
                                                          tmp_path):
    """A state the reference stepped on a (4, 2) mesh and saved, restored
    by the port on 2 ranks: each rank's blocks are the file's slices, bit
    for bit, and the step after it agrees on every rank."""
    ck = str(mesh_ref() / "ck42")
    theirs = _np(RCK.restore(ck, 1))
    arch = "qwen1.5-0.5b"
    back = TD.run_world(TD.rank_elastic_restore, 2, tmp_path, arch=arch,
                        opts=OPTS, mesh=(2, 1), ckpt_dir=ck,
                        batch=_batches(arch)[1], kw=KW)[0]
    TD.same_bits(back[0]["restored"], theirs, "restored")
    model = Model(get(arch).reduced(), RunOptions(**OPTS))
    layout = MeshShape((2, 1), ("data", "model"))
    specs = dict(zip(TD.flat(theirs), tree_leaves(
        S.train_state_shardings(model, layout))))
    for r, got in enumerate(back):
        at = layout.coords(r)
        for k, block in TD.flat(got["local"]).items():
            want = TD.flat(theirs)[k]
            for d, axes in specs[k].spec.dims():
                i = 0
                for a in axes:
                    i = i * layout.shape[a] + at[a]
                n = want.shape[d] // layout.axis_size(axes)
                want = np.take(want, range(i * n, (i + 1) * n), axis=d)
            np.testing.assert_array_equal(block, want, err_msg=k)
        assert got["metrics"] == back[0]["metrics"]
        assert np.isfinite(got["metrics"]["loss"])


# --------------------------------- launcher ---------------------------------
def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_launcher_fails_on_two_ranks_and_resumes_on_one(tmp_path):
    """The launcher on a world of 2 gloo ranks (the environment
    ``torchrun`` sets) fails at step 15 on every rank with exit code 42,
    after the checkpoint of step 10, written whole by rank 0; relaunched
    on one rank it resumes from step 10, resharded, and ends at step 30."""
    ck = str(tmp_path / "ck")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device",
           "cpu", "--arch", "qwen1.5-0.5b", "--reduced", "--steps", "30",
           "--batch", "4", "--seq", "32", "--ckpt-dir", ck, "--ckpt-every",
           "10", "--log-every", "10"]
    port = _free_port()
    procs = [subprocess.Popen(
        cmd + ["--simulate-failure", "15"],
        env={**os.environ, "PYTHONPATH": SRC, "RANK": str(r),
             "LOCAL_RANK": str(r), "WORLD_SIZE": "2",
             "MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
             "OMP_NUM_THREADS": "1"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 42, out
        assert "SIMULATED FAILURE at step 15" in out
    assert "fresh init" in outs[0] and "fresh init" not in outs[1]
    assert ckpt.latest_step(ck) == 10
    saved = ckpt.restore(ck, 10, device="cpu")
    assert int(saved["step"]) == 10 == int(saved["opt"]["count"])
    assert all(bool(torch.isfinite(x).all())
               for x in leaves(saved["params"]))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    p2 = subprocess.run(cmd, env={**env, "PYTHONPATH": SRC},
                        capture_output=True, text=True, timeout=300)
    assert p2.returncode == 0, p2.stdout + p2.stderr
    assert "resumed from step 10" in p2.stdout
    assert int(ckpt.restore(ck, 30, device="cpu")["step"]) == 30


def test_launcher_splits_the_model_axis_on_two_ranks():
    """``torchrun``'s environment on 2 gloo ranks with ``--model-axis 2``:
    finite losses, and the step line shows nothing gathered and the
    activations' bytes moved over ``"model"``."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device",
           "cpu", "--arch", "qwen1.5-0.5b", "--reduced", "--steps", "6",
           "--batch", "4", "--seq", "32", "--lr", "1e-2", "--log-every",
           "5", "--model-axis", "2"]
    port = _free_port()
    procs = [subprocess.Popen(
        cmd, env={**os.environ, "PYTHONPATH": SRC, "RANK": str(r),
                  "LOCAL_RANK": str(r), "WORLD_SIZE": "2",
                  "MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
                  "OMP_NUM_THREADS": "1"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    steps = [line for line in outs[0].splitlines()
             if line.startswith("step")]
    assert len(steps) == 2 and not outs[1].strip().startswith("step")
    for line in steps:
        assert "bytes/step gathered 0 reduced 0 model " in line, line
        assert int(line.split("model ")[1]) > 0
    losses = [float(line.split("loss")[1].split()[0]) for line in steps]
    assert all(np.isfinite(losses))


def test_launcher_sequence_split_on_two_ranks():
    """``--seq-shard`` on 2 gloo ranks with ``--model-axis 2``: finite
    losses equal to the launcher's without it within LOSS_TOL and the
    log's rounding (the same draws and batches), and more bytes over
    ``"model"`` a step (each f a
    gather and each g a scatter of rows, and the kept rows gathered
    again in the backward)."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device",
           "cpu", "--arch", "qwen1.5-0.5b", "--reduced", "--steps", "2",
           "--batch", "4", "--seq", "32", "--lr", "1e-2", "--log-every",
           "1", "--model-axis", "2"]
    got = {}
    for flag in ([], ["--seq-shard"]):
        port = _free_port()
        procs = [subprocess.Popen(
            cmd + flag, env={**os.environ, "PYTHONPATH": SRC,
                             "RANK": str(r), "LOCAL_RANK": str(r),
                             "WORLD_SIZE": "2", "MASTER_ADDR": "localhost",
                             "MASTER_PORT": str(port),
                             "OMP_NUM_THREADS": "1"},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        outs = [p.communicate(timeout=300)[0] for p in procs]
        for p, out in zip(procs, outs):
            assert p.returncode == 0, out
        steps = [line for line in outs[0].splitlines()
                 if line.startswith("step")]
        got[bool(flag)] = ([float(line.split("loss")[1].split()[0])
                            for line in steps],
                           [int(line.split("model ")[1]) for line in steps])
    (off, b_off), (on, b_on) = got[False], got[True]
    assert len(on) == len(off) == 2 and all(np.isfinite(on))
    for a, b in zip(on, off):       # the log prints 4 decimals: 1e-4
        assert abs(a - b) <= TD.LOSS_TOL * abs(b) + 1e-4
    assert all(x > y > 0 for x, y in zip(b_on, b_off))


def test_a_raising_rank_ends_its_world(tmp_path):
    """Rank 1 raises before the first step while rank 0 waits in its first
    gather: the world ends within a minute (its collectives time out
    after 5 s; the harness's deadline is 90 s), with rank 1's error when
    rank 1 is the one reported."""
    arch = "qwen1.5-0.5b"
    t0 = time.monotonic()
    with pytest.raises(mp.ProcessRaisedException) as err:
        TD.run_world(TD.rank_raises, 2, tmp_path, deadline=90, timeout_s=5,
                     arch=arch, opts=OPTS, batch=_batches(arch)[0], kw=KW)
    assert time.monotonic() - t0 < 60
    if err.value.error_index == 1:
        # else rank 0 saw its peer's connection close first and raised
        assert "rank 1 fails on purpose" in str(err.value)
