"""Kernel K2 (frame downsample) against the reference on the CPU.

The port's ``downsample`` takes its plain version on CPU tensors; it is
held against the reference's Pallas kernel in interpret mode
(``repro.kernels.ops.downsample``) and its oracle
(``ref.downsample_ref``) on the shapes of ``tests/test_kernels.py`` and
a 720p frame at factor 2, all drawn from numpy seeds.

Tolerance: float32 results within 1e-6 (a mean of at most 16 N(0,1)
terms summed in another order moves by a few ulps of values below 10);
bfloat16 within one bfloat16 ulp (2^-7 relative), where a last-bit
change of the float32 mean can flip the final rounding.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import frame_preproc as FP
from repro_torch.kernels import ops as port_ops
from _torch_threads import cap_torch_threads

cap_torch_threads()

SHAPES = (
    ((2, 96, 128, 3), 2, 16),
    ((1, 64, 64, 8), 4, 8),
    ((3, 32, 48, 1), 2, 32),
    ((720, 1280, 3), 2, 64),           # one 720p frame, (H, W, C)
)


def _frames(shape, seed=0):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("shape,factor,block", SHAPES)
def test_downsample_matches_reference(shape, factor, block):
    x = _frames(shape)
    before = FP.LAUNCHES
    got = FP.downsample(torch.from_numpy(x), factor, block=block).numpy()
    assert FP.LAUNCHES == before          # the CPU takes the plain version
    kernel = np.asarray(ops.downsample(jnp.asarray(x), factor=factor,
                                       block=block))
    oracle = np.asarray(ref.downsample_ref(jnp.asarray(x), factor))
    assert got.shape == kernel.shape == oracle.shape
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, kernel, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, oracle, rtol=0, atol=1e-6)


@pytest.mark.parametrize("factor", (2, 3, 4))
def test_downsample_bfloat16_matches_oracle(factor):
    x = _frames((2, 48, 72, 3), seed=factor)
    got = FP.downsample_ref(torch.from_numpy(x).bfloat16(), factor)
    want = ref.downsample_ref(jnp.asarray(x, jnp.bfloat16), factor)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7,
                               atol=0)


def test_strided_frame_axis_matches():
    x = _frames((8, 32, 48, 3), seed=4)
    got = FP.downsample(torch.from_numpy(x)[::2], 2).numpy()
    want = np.asarray(ref.downsample_ref(jnp.asarray(x[::2]), 2))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_refusals_name_the_limit():
    with pytest.raises(TypeError, match="floating"):
        FP.downsample(torch.zeros((4, 8, 3), dtype=torch.uint8), 2)
    with pytest.raises(ValueError, match="divide"):
        FP.downsample(torch.zeros((6, 8, 3)), 4)
    with pytest.raises(ValueError, match=r"\(H,W,C\)"):
        FP.downsample(torch.zeros((8, 3)), 2)


@pytest.mark.parametrize("tiles", (1, 4, 9))
def test_tile_frames_matches_reference(tiles):
    x = _frames((2, 12, 18, 3), seed=5)
    got = port_ops.tile_frames(torch.from_numpy(x), tiles).numpy()
    want = np.asarray(ops.tile_frames(jnp.asarray(x), tiles))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="square"):
        port_ops.tile_frames(torch.from_numpy(x), 2)
