#!/usr/bin/env python3
"""Where a kernel's time goes, by ablation, on one NVIDIA card.

    python3 scripts/chip_ablate.py        # from the repository root

The card's machine has no profiler that reads kernel counters, so this
script builds edited copies of a kernel source (a loop bound set to 0,
a product dropped), loads each with ctypes in place of the real library
and times it beside the real kernel at the main path's shape, in one
process on one card. An ablated kernel computes a wrong result; only
its time is read. The difference to the real kernel is the cost of the
part taken out.

- K3 (``csrc/flash_attention.cu``) at the serve prefill, B=4, S=2048,
  H=G=16, D=64, causal: ``no_split`` (tiles not split into TF32
  halves), ``no_softmax`` (scores go to PV as they are), ``one_pass``
  (big*big only, the two small 3xTF32 terms dropped).
- K1 (``csrc/warehouse_agg.cu``) on a window x category plan over a
  (rows, 9) column of 11,059,200 rows with the category changing from
  row to row: ``no_add`` (the wide value's reduction taken out),
  ``no_copy`` (the wide value's copy into shared memory taken out).

Prints one JSON line with the CUDA-event medians in ms and the card's
name and power limit. Edited sources and libraries go to
``build/ablate/``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as C                                     # noqa: E402
from repro_torch.kernels import build                      # noqa: E402
from repro_torch.kernels import flash_attention as FA      # noqa: E402
from repro_torch.kernels import warehouse_agg as K         # noqa: E402

OUT = ROOT / "build" / "ablate"
K3_CUTS = {
    "no_split": [("for (int i = threadIdx.x; i < W / 4; i += THREADS) {",
                  "for (int i = threadIdx.x; i < 0; i += THREADS) {")],
    "no_softmax": [("#pragma unroll\n    for (int r = 0; r < 2; ++r) {\n"
                    "      const int qpos = row0 + 8 * r;\n      float mx",
                    "for (int r = 0; r < 0; ++r) {\n"
                    "      const int qpos = row0 + 8 * r;\n      float mx")],
    "one_pass": [("      wgmma_ss<BK>(sc, qsd, kbd);\n"
                  "      wgmma_ss<BK>(sc, qbd, ksd);\n", ""),
                 ("      wgmma_rs<DP>(o, ps[j], vbd);\n"
                  "      wgmma_rs<DP>(o, pb[j], vsd);\n", "")],
}
K1_CUTS = {
    "no_add": [("  wide_add(sink, run, slab, order, gq, lane);\n"
                "  __syncwarp();               // the slabs",
                "  __syncwarp();               // the slabs")],
    "no_copy": [("      for (int f = lane; f < n4; f += 32) "
                 "cp_async16(slab4 + f, src4 + f);", "")],
}


def ablated(name: str, cut: str, edits) -> ctypes.CDLL:
    """Build csrc/<name>.cu with ``edits`` (old, new) applied."""
    src = (build.CSRC / f"{name}.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"{name}:{cut}: the source no longer has "
                               f"{old[:50]!r}")
        src = src.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{name}_{cut}.cu", OUT / f"{name}_{cut}.so"
    cu.write_text(src)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def k3(dev) -> dict:
    B, S, H, D = C.ATTN_TIME
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((B, S, H, D), generator=gen, device=dev)
               for _ in range(3))
    out = torch.empty_like(q)
    res = {"kernel": C.cuda_ms(lambda: FA.flash_attention(q, k, v), 20)}
    for cut, edits in K3_CUTS.items():
        fn = ablated("flash_attention", cut, edits).flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        res[cut] = C.cuda_ms(lambda: fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            S, H, H, D, 1, 0, D ** -0.5,
            torch.cuda.current_stream().cuda_stream), 20)
    return res


def k1(dev) -> dict:
    T, cams = 43_200, C.CAMERAS
    n = T * cams
    rng = np.random.default_rng(0)
    cols = {"t": torch.arange(T, dtype=torch.int32, device=dev).repeat(cams),
            "category": torch.as_tensor(rng.integers(0, 4, n, np.int32),
                                        device=dev),
            "out": torch.rand((n, 9), device=dev)}
    spec = K.FusedAggSpec((), (("t", 288, 150), ("category", 4, 0)), "out",
                          "mean")
    none = ((), (), (), ())
    res = {"kernel": C.cuda_ms(
        lambda: K.fused_segment_agg(cols, n, none, spec), 20)}
    real = K._lib
    try:
        for cut, edits in K1_CUTS.items():
            fn = ablated("warehouse_agg", cut, edits).warehouse_agg
            fn.argtypes, fn.restype = [ctypes.c_void_p] * 6, ctypes.c_int
            K._lib = lambda fn=fn: fn
            res[cut] = C.cuda_ms(
                lambda: K.fused_segment_agg(cols, n, none, spec), 20)
    finally:
        K._lib = real
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_ablate: no CUDA device is visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(json.dumps({"device": C.nvidia_smi(), "k3_ms": k3(dev),
                      "k1_window_x_category_ms": k1(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
