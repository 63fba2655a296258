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
"""
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
from repro_torch.distribution.sharding import tree_leaves
from repro_torch.launch.mesh import MeshShape
from repro_torch.models.model import Model
from repro_torch.configs.base import get
from repro_torch.models.options import RunOptions
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


def _case(arch, ref, mesh, microbatches=1):
    return {"arch": arch, "opts": {**OPTS, "microbatches": microbatches},
            "mesh": mesh, "state": ref["init"], "batches": _batches(arch),
            "kw": KW}


# ------------------------------ the reference --------------------------------
def mesh_main(out_dir):
    """The reference on meshes of host devices (run in a subprocess whose
    ``XLA_FLAGS`` force 8 of them): qwen's jitted step with its in/out
    shardings on a (2, 2) mesh over ``_batches`` (``sharded.npz``), and a
    train state stepped once on a (4, 2) mesh and saved (zlib) under
    ``out_dir/ck42`` at step 1."""
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
    microbatches)."""
    out = {}
    for world in (2, 4):
        cases = [_case(a, refs[a], (2, 1) if world == 2 else MESH4[a])
                 for a in ARCHS]
        if world == 2:
            cases.append(_case("qwen1.5-0.5b", refs["qwen1.5-0.5b"], (2, 1),
                               microbatches=2))
        out[world] = TD.run_world(TD.rank_train, world,
                                  tmp_path_factory.mktemp(f"w{world}"),
                                  cases=cases, plain=True)[0]
    return out


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
        assert run["bytes"] == {"gathered": 0, "reduced": 0}


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
