#!/usr/bin/env python3
"""Where a kernel's time goes, by ablation, on one NVIDIA card.

    python3 scripts/chip_ablate.py [k4 k3 k3_bf16 k3_bwd k4_bwd k1]

from the repository root. With no names it runs all six.

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
- K3 in bfloat16 (``csrc/flash_attention_bf16.cu``) at qwen1.5-0.5b's
  serve prefill (B=4, S=2048, H=G=16, D=64), qwen1.5-110b's local one
  at (1, 4) (H=16, G=2, D=128) and mixtral-8x7b's (H=32, G=8, D=128,
  window 4,096), all causal: ``one_part`` (P V in one bf16 product, the
  lo part dropped: the second part's cost), ``no_exp`` (the softmax's
  expf taken out: its cost), and the design's alternatives, each
  computing the same function: ``wg1`` (one warpgroup a block
  everywhere), ``stages2`` (a ring of 2 stages instead of 3) and
  ``blocks2`` (at D = 64, registers capped for two blocks an SM). Each
  reports whether it gave the kernel's bits.
- K4 (``csrc/ssd_scan.cu``) at the mamba2-370m serve prefill, B=4,
  S=2048, H=32, P=64, G=1, N=128, Q=256: each of its five passes timed
  alone, then the whole scan and each pass again with ``one_pass``
  (big*big only, the two small 3xTF32 terms dropped), ``no_split``
  (staged tiles not split into TF32 halves), ``no_inter`` (the C . S_in
  term dropped from the chunk scan), ``no_load`` (no tile loads after
  each block's first two steps: the copies' cost) and ``no_exp`` (the
  chunk scan's weights without their decay, CB as it stands).
- K3's backward (``csrc/flash_attention_bwd.cu``) at each shape of
  ``chip_smoke.K3_BWD_TIME`` (qwen1.5-0.5b's and mixtral-8x7b's training
  shapes, whisper-large-v3's encoder), float32 and bfloat16. Its cuts
  are the design's alternatives, each computing the same function:
  ``wg1`` (one warpgroup a block everywhere, no second warpgroup
  sharing the streamed tile), ``dead`` (a branch that skips a
  warpgroup's products on a tile the mask rules out for all its rows)
  and ``cvt_split`` (the TF32 split by two ``cvt.rna`` instead of
  ``split_bits``' integer arithmetic). Each reports whether it gave the
  kernel's bits.
- K4's backward (``csrc/ssd_scan_bwd.cu``) at each shape of
  ``chip_smoke.K4_BWD_TIME`` (mamba2-370m's and hymba-1.5b's training
  shapes), float32 and bfloat16, the whole gradient and each of its
  nine passes: ``hs1`` (one head slice a group: each block of the dcb
  and heads passes loops over all the group's heads, the same function
  summed in another order), ``one_pass`` (big*big only, the small
  3xTF32 terms dropped), ``no_exp`` (the decays of the dx pass's
  weights and of dcb taken as 1) and ``ring2`` (the dx pass with a
  2-stage ring of staging, 108 KB: two blocks an SM instead of three,
  the same function). Each reports whether it gave the kernel's bits.
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
from repro_torch.kernels import ssd as SSD                 # noqa: E402
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
K3_BF16_CUTS = {
    "one_part": [("        wgmma_bf16_rs<DP>(o, pl[j], vd);\n", "")],
    "no_exp": [("const float p = expf(sc[4 * j + 2 * r + c] - m_new);",
                "const float p = sc[4 * j + 2 * r + c] - m_new;")],
    "wg1": [("int warpgroups(int Sq) { return Sq >= 256 ? 2 : 1; }",
             "int warpgroups(int Sq) { return 1; }")],
    "stages2": [("constexpr int STAGES = 3; ", "constexpr int STAGES = 2; ")],
    "blocks2": [("__launch_bounds__(WG * 128 + 32, 1)",
                 "__launch_bounds__(WG * 128 + 32, DP == 64 ? 2 : 1)")],
}
# B, S, H, G, D, window: the shapes k3_bf16 times
K3_BF16_SHAPES = {"qwen": (4, 2048, 16, 16, 64, None),
                  "qwen110b_local": (4, 2048, 16, 2, 128, None),
                  "mixtral": (4, 2048, 32, 8, 128, 4096)}
K4_CUTS = {
    "one_pass": [("    wgmma_ss_n64(acc, as, bb);\n"
                  "    wgmma_ss_n64(acc, ab, bs);\n", ""),
                 ("      wgmma_rs_n64(acc, as[j], xb);\n"
                  "      wgmma_rs_n64(acc, ab[j], xsd);\n", ""),
                 ("      wgmma_rs_n64(acc, as[j], bb);\n"
                  "      wgmma_rs_n64(acc, ab[j], bsd);\n", "")],
    "no_split": [("for (int i = threadIdx.x; i < W / 4; i += NT) {",
                  "for (int i = threadIdx.x; i < 0; i += NT) {")],
    "no_inter": [("const int nk = (c == 0 && a.init == nullptr) ? 0 : "
                  "(a.N + KI - 1) / KI;", "const int nk = 0;")],
    "no_load": [("    if (it + 2 < steps) load(it + 2, st);\n", "")],
    "no_exp": [("v.x * (expf(ct - cumv[s]) * dtv[s])", "v.x"),
               ("v.y * (expf(ct - cumv[s + 1]) * dtv[s + 1])", "v.y"),
               ("v.x * (rf * colv[sl])", "v.x"),
               ("v.y * (rf * colv[sl + 1])", "v.y")],
}
K3_BWD_CUTS = {
    "wg1": [("constexpr int WG = sizeof(In) == 4 && DP == 128 ? 1 : 2;",
             "constexpr int WG = 1;")],
    "dead": [("    const int c0 = tile_row(it);\n",
              "    const int c0 = tile_row(it);\n"
              "    const bool dead = DKDV\n"
              "        ? f0 >= a.Skv || (a.causal && c0 + N - 1 < f0) ||\n"
              "              (a.window > 0 && c0 - a.window >= f0 + 63)\n"
              "        : f0 >= a.Sq || (a.causal && c0 > f0 + 63) ||\n"
              "              (a.window > 0 && c0 + N - 1 <= f0 - a.window);\n"
              "    if (dead) continue;\n")],
    "cvt_split": [("split_bits(", "split(")],
}
K4_BWD_CUTS = {
    "hs1": [("#define HSMAX 4 ", "#define HSMAX 1 ")],
    "one_pass": [
        ("  if constexpr (SA) wgmma_rs_n64(acc, as, bb);\n", ""),
        ("  if constexpr (SB) wgmma_rs_n64(acc, ab, smem_desc(sb + W, "
         "(T / 8) * 128,\n" + " " * 52 + "128));\n", ""),
        ("        wgmma_ss_n64(d, smem_desc(ay + W + o, (T / 8) * 128, "
         "128), bb);\n        wgmma_ss_n64(d, ab, smem_desc(bx + W + "
         "o, (T / 8) * 128, 128));\n", "")],
    "no_exp": [("st[tl * SPT + sl] * expf(cumv[t] - cumv[s])",
                "st[tl * SPT + sl]"),
               ("z = d[i] * (expf(ct - v[T + sl]) * v[2 * T + sl]);",
                "z = d[i] * v[2 * T + sl];"),
               ("const float rf = ti > si ? expf(ct - ref) : 0.f;",
                "const float rf = 1.f;"),
               ("expf(ref - v[T + threadIdx.x]) * v[2 * T + threadIdx.x]",
                "v[2 * T + threadIdx.x]")],
}
K4_BWD_CUTS["ring2"] = [
    ("  float* stage = (float*)(sp + 2 * W);       // [B or cb, G or dy]\n"
     "  float* cumv = stage + STAGE;               // [QP]",
     "  float* stage = (float*)(sp + 2 * W);\n"
     "  float* cumv = stage + 2 * STAGE;"),
    ("  float* st = stage;\n  load(0, st);\n  cp_commit();\n"
     "  for (int it = 0; it < steps; ++it) {\n"
     "    const bool state = it < ns;\n    cp_wait_all();\n"
     "    __syncthreads();                  // step it's tiles are in "
     "(cumv, dtv)",
     "  load(0, stage);\n  cp_commit();\n"
     "  if (steps > 1) load(1, stage + STAGE);\n  cp_commit();\n"
     "  for (int it = 0; it < steps; ++it) {\n"
     "    float* st = stage + (it & 1) * STAGE;\n"
     "    const bool state = it < ns;\n    cp_wait_all_but_one();\n"
     "    __syncthreads();"),
    ("    if (it + 1 < steps) load(it + 1, st);   // in flight with the "
     "products\n",
     "    __syncthreads();\n    if (it + 2 < steps) load(it + 2, st);\n"),
    ("return 4 * ((size_t)2 * PMAX * T + 2 * T * SPT + 2 * QMAX);",
     "return 4 * ((size_t)2 * PMAX * T + 2 * 2 * T * SPT + 2 * QMAX);"),
]
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
        src = src.replace(old, new)          # every occurrence
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{name}_{cut}.cu", OUT / f"{name}_{cut}.so"
    cu.write_text(src)
    subprocess.run(build.command(cu, so), check=True, capture_output=True)
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
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        res[cut] = C.cuda_ms(lambda: fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
            B, S,
            S, H, H, D, 1, 0, D ** -0.5,
            torch.cuda.current_stream().cuda_stream), 20)
    return res


def k3_bf16(dev) -> dict:
    fns = {}
    for cut, edits in K3_BF16_CUTS.items():
        fn = ablated("flash_attention_bf16", cut,
                     edits).flash_attention_bf16_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[cut] = fn
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, (B, S, H, G, D, window) in K3_BF16_SHAPES.items():
        q = torch.randn((B, S, H, D), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((B, S, G, D), generator=gen, device=dev)
                .bfloat16() for _ in range(2))
        want = FA.flash_attention(q, k, v, window=window)
        got = torch.empty_like(q)

        def cut_call(fn):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     got.data_ptr(), None, B, S, S, H, G, D, 1,
                     int(window or 0), D ** -0.5,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"K3 bf16 cut: cudaError {err}")
        res = {"kernel": C.cuda_ms(lambda: FA.flash_attention(
            q, k, v, window=window), 20)}
        for cut, fn in fns.items():
            cut_call(fn)
            C.sync()
            res[cut + "_same_bits"] = torch.equal(got, want)
            res[cut] = C.cuda_ms(lambda: cut_call(fn), 20)
        out[name] = res
        del q, k, v, want, got
    return out


def k3_bwd(dev) -> dict:
    fns = {}
    for cut, edits in K3_BWD_CUTS.items():
        fn = ablated("flash_attention_bwd", cut, edits).flash_attention_bwd
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[cut] = fn
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, (shape, _) in C.K3_BWD_TIME.items():
        B, Sq, Skv, H, G, D, causal, window = shape
        for dtype in (torch.float32, torch.bfloat16):
            q, do = (torch.randn((B, Sq, H, D), generator=gen, device=dev)
                     .to(dtype) for _ in range(2))
            k, v = (torch.randn((B, Skv, G, D), generator=gen, device=dev)
                    .to(dtype) for _ in range(2))
            o, lse = FA.flash_attention_fwd_lse(q, k, v, causal=causal,
                                                window=window)
            want = FA.flash_attention_bwd(q, k, v, o, do, lse,
                                          causal=causal, window=window)
            got = [torch.empty_like(x) for x in (q, k, v)]
            delta = torch.empty((B, H, Sq), device=dev)

            def cut_call(fn):
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                         delta.data_ptr(), *(x.data_ptr() for x in got), B,
                         Sq, Skv, H, G, D, int(causal), int(window or 0),
                         int(dtype == torch.bfloat16), D ** -0.5,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"K3 backward cut: cudaError {err}")
            res = {"kernel": C.cuda_ms(lambda: FA.flash_attention_bwd(
                q, k, v, o, do, lse, causal=causal, window=window), 20)}
            for cut, fn in fns.items():
                cut_call(fn)
                C.sync()
                same = all(torch.equal(a, b) for a, b in zip(got, want))
                res[cut] = C.cuda_ms(lambda: cut_call(fn), 20)
                res[cut + "_same_bits"] = same
            out[f"{name}_{str(dtype)[6:]}"] = res
            del q, k, v, o, do, lse, want, got, delta
    return out


def k4(dev) -> dict:
    B, S, H, P, G, N, Q = C.SSD_TIME
    gen = torch.Generator(device=dev).manual_seed(0)
    *args, _ = C.ssd_inputs(B, S, H, P, G, N, gen, dev)
    x, Bm = args[0], args[3]
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), device=dev)
    scr = SSD.scratch(x, Bm, Q)

    def times() -> dict:
        for name in SSD.PASSES:          # the scratch holds every input
            SSD.launch(name, *args, None, y, state, scr, Q)
        res = {"scan": C.cuda_ms(lambda: SSD.ssd_scan(*args, chunk=Q), 20)}
        for name in SSD.PASSES:
            res[name] = C.cuda_ms(lambda: SSD.launch(
                name, *args, None, y, state, scr, Q), 20)
        return res

    out = {"kernel": times()}
    real = SSD._lib
    try:
        for cut, edits in K4_CUTS.items():
            fns = SSD.bind(ablated("ssd_scan", cut, edits))
            SSD._lib = lambda fns=fns: fns
            out[cut] = times()
    finally:
        SSD._lib = real
    return out


def k4_bwd(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)
    cuts = {cut: SSD.bind_bwd(ablated("ssd_scan_bwd", cut, edits))
            for cut, edits in K4_BWD_CUTS.items()}
    out = {}
    real = SSD._bwd_lib
    try:
        for name, (B, S, H, P, G, N, Q) in C.K4_BWD_TIME.items():
            x, dt, A, Bm, Cm, _ = C.ssd_inputs(B, S, H, P, G, N, gen, dev)
            dy = torch.randn(x.shape, generator=gen, device=dev)
            for dtype in (torch.float32, torch.bfloat16):
                args = [a.to(dtype) if i != 2 else a
                        for i, a in enumerate((x, dt, A, Bm, Cm, dy))]
                _, _, scr = SSD._forward(*args[:5], None, Q)
                want = SSD.ssd_scan_bwd(*args, None, scr, chunk=Q)

                def times() -> dict:
                    got = SSD.ssd_scan_bwd(*args, None, scr, chunk=Q)
                    C.sync()
                    work = SSD.bwd_scratch(args[0], args[3], Q)
                    res = {"same_bits": all(a is None or torch.equal(a, b)
                                            for a, b in zip(got, want)),
                           "all": C.cuda_ms(lambda: SSD.ssd_scan_bwd(
                               *args, None, scr, chunk=Q), 20)}
                    for p in SSD.BWD_PASSES:
                        res[p] = C.cuda_ms(lambda p=p: SSD.launch_bwd(
                            p, *args, None, scr, got, work, Q), 20)
                    return res
                res = {"kernel": times()}
                for cut, fns in cuts.items():
                    SSD._bwd_lib = lambda fns=fns: fns
                    res[cut] = times()
                    SSD._bwd_lib = real
                out[f"{name}_{str(dtype)[6:]}"] = res
                del args, scr, want
    finally:
        SSD._bwd_lib = real
    return out


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
    parts = {"k4": ("k4_ms", k4), "k3": ("k3_ms", k3),
             "k3_bf16": ("k3_bf16_ms", k3_bf16),
             "k3_bwd": ("k3_bwd_ms", k3_bwd),
             "k4_bwd": ("k4_bwd_ms", k4_bwd),
             "k1": ("k1_window_x_category_ms", k1)}
    names = sys.argv[1:] or list(parts)
    if not set(names) <= set(parts):
        print(f"chip_ablate: unknown names {names}", file=sys.stderr)
        return 2
    out = {"device": C.nvidia_smi()}
    for name in names:
        key, fn = parts[name]
        out[key] = fn(dev)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
