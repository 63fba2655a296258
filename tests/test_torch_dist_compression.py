"""The port's int8 all-reduce (``distribution.compression.compressed_psum``
and ``compress_grads_across_pods``) over worlds of gloo ranks against
the reference's, on the CPU.

The reference's program on a mesh is the one the port follows: a
subprocess forces 4 host devices (``--xla_force_host_platform_device_
count``, which must be set before JAX starts) and runs the reference's
``compressed_psum`` jitted under ``shard_map`` over a ``('pod',)`` mesh
of 2 and 4 of them, and its ``compress_grads_across_pods`` jitted (as a
train step would call it) on meshes of 1 and 2 devices. The port's ranks
(``tests/_torch_dist.py``) are given each pod's uniforms. The inputs
span six decades of magnitude a rank, with and without an
error-feedback residual.

- On the mesh: the mean and the new residual bit for bit at 2 ranks
  (the residual one fused multiply-add, as XLA compiles it; the scales
  summed by the ``psum`` collective, here in rank order); at 4 ranks the
  residual bit for bit and the mean within n * 2^-23 of the reference's,
  relative, the most another order of the n scales' sum (2 (n - 1)
  roundings of 2^-24) and the mean's own two roundings can move it.
- Under ``jax.vmap(..., axis_name="pod")``, jitted, at 2 and 4 ranks:
  the residual bit for bit, the mean within (n + 1) * 2^-23: there XLA
  fuses each pod's ``max|y| * (1/127)`` into the ``psum``'s reduction,
  one fused multiply-add a pod, which a sum of the ranks' rounded
  scales (the mesh's collective) cannot do.
- ``compress_grads_across_pods`` at 1 and 2 ranks: every leaf's mean and
  residual bit for bit, each leaf given the uniforms of its key from
  the reference's ``jax.random.split``.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist as TD
from repro.distribution.compression import compress_grads_across_pods
from repro.distribution.compression import compressed_psum as ref_psum
from _torch_threads import cap_torch_threads

cap_torch_threads()

SHAPES = ((5,), (3, 7), (64,), (2, 3, 4), (1000,), (1,))
WORLDS = (2, 4)


def _inputs(i, world, shape):
    """Rank-stacked x, the pods' keys and uniforms, and err."""
    rng = np.random.default_rng(100 * world + i)
    scale = 10 ** rng.uniform(-3, 3, (world,) + (1,) * len(shape))
    x = (rng.standard_normal((world,) + shape) * scale).astype(np.float32)
    err = ((rng.standard_normal((world,) + shape) * 1e-3 * scale)
           .astype(np.float32) * (i % 2))
    keys = jax.random.split(jax.random.PRNGKey(i), world)
    r = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape))(keys))
    return x, keys, r, err


def _grads(world):
    """Leaves, residuals, the key, and each leaf's uniforms (the
    reference's split, in ``jax.tree``'s sorted order)."""
    rng = np.random.default_rng(7 + world)
    grads = {"b": rng.standard_normal(17).astype(np.float32),
             "a": (rng.standard_normal((4, 6)) * 30).astype(np.float32),
             "c": np.float32([2.5e-4, -1e-3, 0.0])}
    errs = {k: (rng.standard_normal(v.shape) * 1e-3).astype(np.float32)
            for k, v in grads.items()}
    key = jax.random.PRNGKey(3)
    keys = jax.random.split(key, len(grads))
    draws = {k: np.asarray(jax.random.uniform(kk, grads[k].shape))
             for k, kk in zip(sorted(grads), keys)}
    return grads, errs, key, draws


def mesh_main(out):
    """The reference on meshes of host devices (run in a subprocess
    whose ``XLA_FLAGS`` force 4 of them); writes ``out`` (.npz)."""
    import functools
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P
    assert len(jax.devices()) >= 4, jax.devices()
    res = {}
    for world in (1, 2, 4):
        mesh = Mesh(np.asarray(jax.devices()[:world]), ("pod",))
        if world > 1:
            def body(x, k, e):
                m, ne = ref_psum(x[0], "pod", k[0], e[0])
                return m[None], ne[None]
            run = jax.jit(shard_map(body, mesh=mesh,
                                    in_specs=(P("pod"),) * 3,
                                    out_specs=(P("pod"),) * 2,
                                    check_rep=False))
            for i, shape in enumerate(SHAPES):
                x, keys, _, err = _inputs(i, world, shape)
                m, ne = run(jnp.asarray(x), keys, jnp.asarray(err))
                res[f"psum{world}/{i}/mean"] = np.asarray(m)
                res[f"psum{world}/{i}/err"] = np.asarray(ne)
        if world < 4:
            grads, errs, key, _ = _grads(world)
            g, e = jax.jit(functools.partial(compress_grads_across_pods,
                                             mesh=mesh))(
                {k: jnp.asarray(v) for k, v in grads.items()},
                {k: jnp.asarray(v) for k, v in errs.items()}, key)
            for k in grads:
                res[f"grads{world}/{k}/mean"] = np.asarray(g[k])
                res[f"grads{world}/{k}/err"] = np.asarray(e[k])
    np.savez(out, **res)


@pytest.fixture(scope="module")
def mesh_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh") / "ref.npz"
    tests = Path(__file__).resolve().parent
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    code = (f"import sys; sys.path[:0] = [{str(tests)!r}, "
            f"{str(tests.parent / 'src')!r}]; import "
            f"test_torch_dist_compression as T; T.mesh_main({str(out)!r})")
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=300)
    return dict(np.load(out))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each rank's ``(mean, residual)`` per case, per world."""
    out = {}
    for world in WORLDS:
        cases = [_inputs(i, world, s) for i, s in enumerate(SHAPES)]
        out[world] = TD.run_world(
            TD.rank_psum, world, tmp_path_factory.mktemp(f"psum{world}"),
            cases=[(x, r, e) for x, _, r, e in cases])[0]
    return out


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("i", range(len(SHAPES)))
def test_compressed_psum_against_the_mesh_program(worlds, mesh_ref, world,
                                                  i):
    mean = mesh_ref[f"psum{world}/{i}/mean"]
    new_err = mesh_ref[f"psum{world}/{i}/err"]
    for rank in range(world):
        m, e = worlds[world][rank][i]
        assert m.dtype == e.dtype == np.float32 and m.shape == SHAPES[i]
        np.testing.assert_array_equal(_bits(e), _bits(new_err[rank]))
        if world == 2:
            np.testing.assert_array_equal(_bits(m), _bits(mean[rank]))
        else:
            np.testing.assert_allclose(m, mean[rank],
                                       rtol=world * 2.0 ** -23, atol=0)
        np.testing.assert_array_equal(_bits(m), _bits(worlds[world][0][i][0]))


@pytest.mark.parametrize("world", WORLDS)
def test_compressed_psum_against_the_vmapped_reference(worlds, world):
    for i, shape in enumerate(SHAPES):
        x, keys, _, err = _inputs(i, world, shape)
        mean, new_err = jax.jit(jax.vmap(
            lambda x, k, e: ref_psum(x, "pod", k, e), axis_name="pod"))(
                jnp.asarray(x), keys, jnp.asarray(err))
        for rank in range(world):
            m, e = worlds[world][rank][i]
            np.testing.assert_array_equal(_bits(e), _bits(new_err[rank]))
            np.testing.assert_allclose(m, np.asarray(mean[rank]),
                                       rtol=(world + 1) * 2.0 ** -23, atol=0)


@pytest.mark.parametrize("world", (1, 2))
def test_compress_grads_across_pods(mesh_ref, tmp_path, world):
    grads, errs, _, draws = _grads(world)
    results, _ = TD.run_world(TD.rank_grads, world, tmp_path, grads=grads,
                              errs=errs, draws=draws)
    for got_g, got_e in results:
        assert list(got_g) == list(grads)
        for k in grads:
            np.testing.assert_array_equal(
                _bits(got_g[k]), _bits(mesh_ref[f"grads{world}/{k}/mean"]))
            np.testing.assert_array_equal(
                _bits(got_e[k]), _bits(mesh_ref[f"grads{world}/{k}/err"]))
