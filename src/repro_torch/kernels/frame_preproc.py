"""Integer-factor box downsample of frames (kernel K2): the V-ETL
resolution knob.

``downsample`` is the port of ``repro/kernels/frame_preproc.py``'s
Pallas kernel. On a CUDA tensor the wrapper launches the hand-written
Hopper kernel ``csrc/frame_preproc.cu`` (built with nvcc at first use,
bound through ctypes) or raises; it never falls back. On a CPU tensor
it runs the plain version ``downsample_ref``, the reference's
``ref.downsample_ref`` written in PyTorch. ``LAUNCHES`` counts kernel
launches.

Both take ``(H,W,C)`` or ``(B,H,W,C)`` floating frames with H and W
divisible by the factor, average each f x f block in float32 and cast
back to the input dtype. Integer frames are refused on every device:
the reference's callers pass float32. The kernel takes float32 and
bfloat16, frames at any stride along B and contiguous within a frame.
Tolerance against the reference: the sum of the f^2 terms may be taken
in another order, so float32 results agree to a few ulps and bfloat16
results to one bfloat16 ulp.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.nograd import refuse_grad

LAUNCHES = 0
KERNEL_DTYPES = {torch.float32: "downsample_f32",
                 torch.bfloat16: "downsample_bf16"}


def _check(frame: torch.Tensor, factor: int) -> None:
    if frame.ndim not in (3, 4):
        raise ValueError(f"downsample takes (H,W,C) or (B,H,W,C) frames, "
                         f"not shape {tuple(frame.shape)}")
    if not frame.is_floating_point():
        raise TypeError(f"downsample takes floating frames, not "
                        f"{frame.dtype}")
    if int(factor) != factor or factor < 1:
        raise ValueError(f"factor must be a positive integer, not {factor}")
    H, W = frame.shape[-3], frame.shape[-2]
    if H % factor or W % factor:
        raise ValueError(f"H={H} and W={W} must divide by factor={factor}")


def downsample_ref(frame: torch.Tensor, factor: int) -> torch.Tensor:
    """The plain version: mean over each f x f block in float32, cast
    back to the input dtype."""
    _check(frame, factor)
    x = frame if frame.ndim == 4 else frame[None]
    B, H, W, C = x.shape
    out = x.float().reshape(B, H // factor, factor, W // factor, factor,
                            C).mean(dim=(2, 4)).to(frame.dtype)
    return out if frame.ndim == 4 else out[0]


def _lib(dtype):
    from repro_torch.kernels import build
    fn = getattr(build.load("frame_preproc"), KERNEL_DTYPES[dtype])
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                       + [ctypes.c_int64, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def downsample(frame: torch.Tensor, factor: int, *,
               block: int = 64) -> torch.Tensor:
    """Downsample ``frame`` by ``factor`` along H and W. ``block`` is the
    TPU kernel's tile size: it is accepted for the signature and has no
    effect here."""
    global LAUNCHES
    del block
    _check(frame, factor)
    if frame.device.type == "cpu":
        return downsample_ref(frame, factor)
    if frame.device.type != "cuda":
        raise ValueError(f"no kernel for device {frame.device}")
    refuse_grad("the downsample kernel (K2)", frame)
    if frame.dtype not in KERNEL_DTYPES:
        raise TypeError(f"the downsample kernel takes float32 and bfloat16 "
                        f"frames, not {frame.dtype}")
    x = frame if frame.ndim == 4 else frame[None]
    B, H, W, C = x.shape
    if x.stride()[1:] != (W * C, C, 1):
        raise ValueError("each frame must be contiguous (H, W, C); only "
                         "the frame axis may be strided")
    if B > 65535 or H // factor > 65535:
        raise ValueError(f"the downsample kernel's grid takes up to 65535 "
                         f"frames and output rows, not B={B}, "
                         f"H/f={H // factor}")
    out = torch.empty((B, H // factor, W // factor, C), dtype=x.dtype,
                      device=x.device)
    err = _lib(x.dtype)(x.data_ptr(), out.data_ptr(), B, H, W, C,
                        int(factor), x.stride()[0] if B > 1 else H * W * C,
                        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"downsample launch failed: cudaError {err}")
    LAUNCHES += 1
    return out if frame.ndim == 4 else out[0]
