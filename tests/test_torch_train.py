"""The port's training path (``repro_torch.optim``, ``runtime.steps``,
``Model.loss``, ``data.tokens.make_batch_iter``, ``launch.train``)
against the reference's on the CPU, on inputs made from a seed with
numpy or drawn by the reference and carried across
(``convert.params_from_arrays``).

Tolerances, each with its reason:
- the optimizer's pieces: 1e-7 of each leaf's largest magnitude (the
  same float32 operations in the same order; XLA may contract a multiply
  and an add into one rounding, so a last-bit difference is allowed);
- ``Model.loss``: the loss within 1e-5 relative and every gradient leaf
  within 1e-5 of its largest magnitude (float32 matmuls and softmax sums
  in other orders; measured at most about 3e-6);
- the train step: the loss and the clipped global norm as
  ``Model.loss``'s, the learning rate within one float32 ulp (2^-23
  relative: inside the jitted step XLA's cosine may differ from torch's
  in the last bit), the moments within 1e-5 of each leaf's largest
  magnitude after 1 and 5 steps (linear in the gradients), the params
  within that plus 1e-3 of the learning rates summed over the steps:
  AdamW's step m / (sqrt(v) + eps) moves each element by about lr at
  most, and divides an element's gradient error by that element's own
  size, so a small gradient's update may differ by a larger share; 1e-3
  of the summed rates says the updates agree to a thousandth of their
  size (measured about 4e-5 of it);
- the batches: equal.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as RCK
from repro.configs.base import get as ref_get
from repro.data.tokens import make_batch_iter as ref_batches
from repro.models.model import Model as RefModel
from repro.models.options import RunOptions as RefOptions
from repro.optim import adamw as RA
from repro.runtime import steps as RS
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import get
from repro_torch.convert import params_from_arrays
from repro_torch.data.tokens import make_batch_iter
from repro_torch.launch import train as LT
from repro_torch.models.model import Model
from repro_torch.models.options import RunOptions
from repro_torch.optim import adamw as A
from repro_torch.runtime import steps as S
from _torch_threads import cap_torch_threads

cap_torch_threads()

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
OPTS = dict(remat="none", layer_loop="scan", compute_dtype="float32",
            q_chunk=16, kv_chunk=16)
ARCHS = ("qwen1.5-0.5b", "mixtral-8x7b", "internvl2-26b", "mamba2-370m",
         "hymba-1.5b", "whisper-large-v3")
OPT_TOL = 1e-7
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
ULP32 = 2.0 ** -23


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree.detach().cpu() if isinstance(
        tree, torch.Tensor) else tree)}


def _close_leaves(got, want, tol, what, slack=0.0):
    """Every leaf within ``tol`` of its largest magnitude, plus ``slack``."""
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys(), what
    for k in w:
        assert g[k].shape == w[k].shape, (what, k, g[k].shape, w[k].shape)
        scale = float(np.abs(w[k]).max()) if w[k].size else 0.0
        err = float(np.abs(g[k].astype(np.float64) - w[k]).max()) \
            if w[k].size else 0.0
        assert err <= tol * max(scale, 1e-30) + slack, (what, k, err, scale)


def _tree(rng, shapes):
    return {k: (_tree(rng, v) if isinstance(v, dict) else
                rng.normal(0, 1, v).astype(np.float32))
            for k, v in shapes.items()}


SHAPES = {"a": (7, 5), "b": {"c": (64,), "d": (3, 4, 6)}}


# --------------------------------- optimizer --------------------------------
def test_adamw_update_clip_and_schedule_match_reference():
    rng = np.random.default_rng(0)
    params, grads = _tree(rng, SHAPES), _tree(rng, SHAPES)
    m = _tree(rng, SHAPES)
    v = jax.tree.map(np.abs, _tree(rng, SHAPES))
    count = np.int32(3)
    for clip in (1.0, 100.0):                  # clipped, and not
        rg, rn = RA.clip_by_global_norm(grads, clip)
        pg = params_from_arrays(grads, "cpu")
        pg, pn = A.clip_by_global_norm(pg, clip)
        # the two norms sum the same squares in other orders (a float32
        # ulp apart); each clipped leaf is the reference's formula at the
        # port's own norm, x * min(1, clip / max(norm, 1e-9)) in float32,
        # bit for bit
        assert abs(float(pn) - float(rn)) <= OPT_TOL * float(rn)
        scale = np.minimum(np.float32(1.0), np.float32(clip) / np.maximum(
            np.float32(pn), np.float32(1e-9)))
        want = jax.tree.map(lambda x: x * scale, grads)
        _close_leaves(pg, want, 0.0, "clip")
    assert abs(float(A.global_norm(params_from_arrays(grads, "cpu")))
               - float(RA.global_norm(grads))) <= OPT_TOL * float(rn)
    lr = np.float32(3e-3)
    rp, ropt = RA.adamw_update(grads, {"m": m, "v": v, "count": count},
                               params, lr=lr)
    pp = params_from_arrays(params, "cpu")
    popt = params_from_arrays({"m": m, "v": v, "count": count}, "cpu")
    pp, popt = A.adamw_update(params_from_arrays(grads, "cpu"), popt, pp,
                              lr=torch.tensor(lr))
    _close_leaves(pp, _np(rp), OPT_TOL, "params")
    _close_leaves(popt["m"], _np(ropt["m"]), OPT_TOL, "m")
    _close_leaves(popt["v"], _np(ropt["v"]), OPT_TOL, "v")
    assert popt["count"].dtype == torch.int32 and int(popt["count"]) == 4
    for step in (0, 1, 7, 20, 21, 55, 100, 140):
        want = float(RA.warmup_cosine(jnp.int32(step), peak_lr=3e-4,
                                      warmup=20, total=100))
        got = A.warmup_cosine(torch.tensor(step, dtype=torch.int32),
                              peak_lr=3e-4, warmup=20, total=100)
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= OPT_TOL * 3e-4, (step, got, want)
    init = A.adamw_init(pp)
    assert set(init) == {"m", "v", "count"} and int(init["count"]) == 0
    assert all(float(x.abs().max()) == 0 for x in A.leaves(init["m"]))


# ---------------------------------- batches ---------------------------------
@pytest.mark.parametrize("arch", ("qwen1.5-0.5b", "internvl2-26b",
                                  "whisper-large-v3"))
def test_batch_iter_draws_the_references(arch):
    cfg = get(arch).reduced()
    mine = make_batch_iter(cfg, global_batch=3, seq_len=24, seed=5,
                           device="cpu")
    theirs = ref_batches(ref_get(arch).reduced(), global_batch=3,
                         seq_len=24, seed=5)
    for _ in range(3):
        a, b = next(mine), next(theirs)
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
            assert a[k].device.type == "cpu"


# ------------------------------- Model.loss ---------------------------------
def _pair(arch):
    ref = RefModel(ref_get(arch).reduced(), RefOptions(**OPTS))
    port = Model(get(arch).reduced(), RunOptions(**OPTS))
    return ref, port


def _batch(arch, batch=2, seq=32, seed=0):
    cfg = ref_get(arch).reduced()
    return _np(next(ref_batches(cfg, global_batch=batch, seq_len=seq,
                                seed=seed)))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    ref, port = _pair(arch)
    rp = ref.init(jax.random.PRNGKey(0))
    batch = _batch(arch)
    rloss, rgrads = jax.jit(jax.value_and_grad(ref.loss))(rp, batch)
    params = params_from_arrays(_np(rp), "cpu")
    loss, grads = S.value_and_grad(port, params, batch)
    assert abs(float(loss) - float(rloss)) <= LOSS_TOL * abs(float(rloss))
    assert loss.dtype == torch.float32
    assert len(grads) == len(jax.tree.leaves(rgrads))
    keys = list(_flat(params))          # in `leaves` order
    _close_leaves(dict(zip(keys, grads)), _np(_flat(rgrads)), GRAD_TOL,
                  arch)
    # the loss takes numpy batches and tensors alike
    again = port.loss(params, {k: torch.as_tensor(v)
                               for k, v in batch.items()})
    assert float(again) == float(loss)


@pytest.mark.parametrize("arch", ("qwen1.5-0.5b", "mixtral-8x7b",
                                  "whisper-large-v3"))
def test_remat_modes_give_identical_gradients(arch):
    cfg = get(arch).reduced()
    batch = _batch(arch, seed=1)
    params = Model(cfg, RunOptions(**OPTS)).init(
        torch.Generator().manual_seed(2), "cpu")
    out = {}
    for mode in ("none", "full", "dots"):
        model = Model(cfg, RunOptions(**{**OPTS, "remat": mode}))
        out[mode] = S.value_and_grad(model, params, batch)
    for mode in ("full", "dots"):
        assert torch.equal(out[mode][0], out["none"][0]), mode
        assert all(torch.equal(a, b) for a, b in
                   zip(out[mode][1], out["none"][1])), mode
    with pytest.raises(ValueError, match="remat"):
        S.value_and_grad(Model(cfg, RunOptions(**{**OPTS, "remat": "some"})),
                         params, batch)
    # the caller's leaves are left as they were, also when the loss raises
    assert not any(p.requires_grad for p in A.leaves(params))


# -------------------------------- train step --------------------------------
@pytest.mark.parametrize("microbatches", (1, 2))
def test_train_step_matches_reference(microbatches):
    arch = "qwen1.5-0.5b"
    opts = {**OPTS, "microbatches": microbatches}
    ref = RefModel(ref_get(arch).reduced(), RefOptions(**opts))
    port = Model(get(arch).reduced(), RunOptions(**opts))
    kw = dict(peak_lr=1e-2, warmup=2, total_steps=10, clip=1.0,
              weight_decay=0.1)
    rstep = jax.jit(RS.make_train_step(ref, **kw))
    pstep = S.make_train_step(port, **kw)
    rstate = RS.init_train_state(ref, jax.random.PRNGKey(0))
    pstate = params_from_arrays(_np(rstate), "cpu")
    assert pstate["step"].dtype == torch.int32
    rit = ref_batches(ref.cfg, global_batch=4, seq_len=32, seed=3)
    lr_sum = 0.0
    for n in range(1, 6):
        batch = _np(next(rit))
        rstate, rm = rstep(rstate, batch)
        pstate, pm = pstep(pstate, {k: torch.as_tensor(v)
                                    for k, v in batch.items()})
        if n not in (1, 5):
            lr_sum += float(rm["lr"])
            continue
        for key, tol in (("loss", LOSS_TOL), ("gnorm", LOSS_TOL),
                         ("lr", ULP32)):
            want = float(rm[key])
            assert abs(float(pm[key]) - want) <= tol * abs(want) + 1e-30, \
                (n, key, float(pm[key]), want)
        lr_sum += float(rm["lr"])
        _close_leaves({k: v for k, v in pstate["opt"].items()
                       if k != "count"},
                      {k: v for k, v in _np(rstate["opt"]).items()
                       if k != "count"}, GRAD_TOL, (n, "opt"))
        _close_leaves(pstate["params"], _np(rstate["params"]), GRAD_TOL,
                      (n, "params"), slack=1e-3 * lr_sum)
        assert int(pstate["opt"]["count"]) == int(rstate["opt"]["count"]) \
            == n == int(pstate["step"])


@pytest.mark.parametrize("arch", ("qwen1.5-0.5b", "whisper-large-v3"))
def test_prefill_and_decode_steps_match_reference(arch):
    ref, port = _pair(arch)
    rp = ref.init(jax.random.PRNGKey(0))
    params = params_from_arrays(_np(rp), "cpu")
    batch = _batch(arch, seq=16, seed=4)
    rpre, rdec = (jax.jit(RS.make_prefill_step(ref)),
                  jax.jit(RS.make_decode_step(ref)))
    ppre, pdec = S.make_prefill_step(port), S.make_decode_step(port)
    r_tok, r_cache = rpre(rp, batch)
    p_tok, p_cache = ppre(params, {k: torch.as_tensor(v)
                                   for k, v in batch.items()})
    for step in range(3):
        np.testing.assert_array_equal(p_tok.numpy(), np.asarray(r_tok),
                                      err_msg=str(step))
        _close_leaves(p_cache, _np(r_cache), GRAD_TOL, (arch, step))
        r_tok, r_cache = rdec(rp, r_cache, r_tok)
        p_tok, p_cache = pdec(params, p_cache, p_tok)


def test_train_state_checkpoints_cross_both_ways(tmp_path, monkeypatch):
    monkeypatch.setattr(RCK, "zstd", None)     # the reference writes zlib
    arch = "qwen1.5-0.5b"
    ref, port = _pair(arch)
    rstep = jax.jit(RS.make_train_step(ref))
    rstate = RS.init_train_state(ref, jax.random.PRNGKey(1))
    rstate, _ = rstep(rstate, _batch(arch, batch=2, seq=16))
    RCK.save(str(tmp_path / "r"), jax.device_get(rstate), step=1)
    mine = ckpt.restore(str(tmp_path / "r"), 1, device="cpu")
    _close_leaves(mine, _np(rstate), 0.0, "reference -> port")
    assert mine["opt"]["count"].dtype == torch.int32
    assert mine["step"].dtype == torch.int32 and mine["step"].ndim == 0
    pstate = S.init_train_state(port, torch.Generator().manual_seed(1),
                                "cpu")
    pstate, _ = S.make_train_step(port)(pstate, _batch(arch, batch=2,
                                                       seq=16))
    ckpt.save(str(tmp_path / "p"), pstate, step=1)
    theirs = RCK.restore(str(tmp_path / "p"), 1)
    _close_leaves(pstate, _np(theirs), 0.0, "port -> reference")
    assert theirs["step"].dtype == jnp.int32
    assert theirs["opt"]["count"].dtype == jnp.int32
    # and the reference steps on from the port's state
    theirs, m = rstep(theirs, _batch(arch, 2, 16, 2))
    assert np.isfinite(float(m["loss"])) and int(theirs["step"]) == 2


# --------------------------------- launcher ---------------------------------
def test_launcher_loss_decreases():
    losses = LT.main(["--device", "cpu", "--arch", "qwen1.5-0.5b",
                      "--reduced", "--steps", "60", "--batch", "8", "--seq",
                      "64", "--lr", "3e-3", "--log-every", "10"])
    assert len(losses) == 7 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.3, losses
    with pytest.raises(ValueError, match="does not divide by --model-axis 2"):
        LT.main(["--device", "cpu", "--model-axis", "2"])


def test_launcher_failure_and_resume(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC)
    ck = str(tmp_path / "ck")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device",
           "cpu", "--arch", "qwen1.5-0.5b", "--reduced", "--steps", "30",
           "--batch", "4", "--seq", "32", "--ckpt-dir", ck, "--ckpt-every",
           "10", "--log-every", "10"]
    p1 = subprocess.run(cmd + ["--simulate-failure", "15"], env=env,
                        capture_output=True, text=True, timeout=300)
    assert p1.returncode == 42, p1.stdout + p1.stderr
    assert "SIMULATED FAILURE at step 15" in p1.stdout
    assert ckpt.latest_step(ck) == 10
    saved = ckpt.restore(ck, 10, device="cpu")
    assert int(saved["step"]) == 10 == int(saved["opt"]["count"])
    p2 = subprocess.run(cmd, env=env, capture_output=True, text=True,
                        timeout=300)
    assert p2.returncode == 0, p2.stdout + p2.stderr
    assert "resumed from step 10" in p2.stdout
    assert ckpt.latest_step(ck) == 30
    assert int(ckpt.restore(ck, 30, device="cpu")["step"]) == 30
    # the reference resumes the port's run from its checkpoint
    theirs = RCK.restore(ck, 30)
    assert int(theirs["opt"]["count"]) == 30
