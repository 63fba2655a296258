#!/usr/bin/env python3
"""Where a kernel's time goes, by ablation, on one NVIDIA card.

    python3 scripts/chip_ablate.py [k4 k4_bf16 k3 k3_bf16 k3_bwd k3_bwd_bf16
                                    k4_bwd k4_bwd_bf16 k1]

from the repository root. With no names it runs all nine.

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
- K4 in bfloat16 (``csrc/ssd_scan_bf16.cu``) at mamba2-370m's serve
  prefill and hymba-1.5b's (H=25, N=16), bfloat16 x, dt, B and C: the
  whole scan and each of its five passes, with ``one_part`` (every
  product with a split operand in one bf16 product, the lo parts
  dropped: their cost), ``three_parts`` (a third bf16 product beside
  each of those two, as a third part of the split operand would add: its
  cost), ``no_exp`` (the chunk scan's weights without their decay, cb as
  it stands) and ``no_inter`` (the C . S_in term dropped), and the
  design's alternative ``cp_async`` (every tile by 16-byte cp.async
  instead of TMA, the same function, with a flag for the kernel's
  bits).
- K3's float32 backward (``csrc/flash_attention_bwd.cu``) at each shape
  of ``chip_smoke.K3_BWD_TIME`` (qwen1.5-0.5b's and mixtral-8x7b's
  training shapes, whisper-large-v3's encoder). Its cuts are the
  design's alternatives, each computing the same function:
  ``wg1`` (one warpgroup a block everywhere, no second warpgroup
  sharing the streamed tile), ``dead`` (a branch that skips a
  warpgroup's products on a tile the mask rules out for all its rows)
  and ``cvt_split`` (the TF32 split by two ``cvt.rna`` instead of
  ``split_bits``' integer arithmetic). Each reports whether it gave the
  kernel's bits.
- K3's bfloat16 backward (``csrc/flash_attention_bwd_bf16.cu``) at the
  same shapes: ``one_part`` (P and dS in one bf16 part, the lo parts'
  products dropped: what the second part costs), and the design's
  alternatives, computing the same function: ``cp_async`` (every
  streamed tile by 16-byte cp.async from the producer warp instead of
  TMA) and ``wg1`` (one consumer warpgroup a block everywhere). Each
  reports whether it gave the kernel's bits.
- K4's float32 backward (``csrc/ssd_scan_bwd.cu``) at each shape of
  ``chip_smoke.K4_BWD_TIME`` (mamba2-370m's and hymba-1.5b's training
  shapes), the whole gradient and each of its nine passes: ``hs1``
  (one head slice a group: each block of the dcb and heads passes loops
  over all the group's heads, the same function summed in another
  order), ``one_pass`` (big*big only, the small
  3xTF32 terms dropped), ``no_exp`` (the decays of the dx pass's
  weights and of dcb taken as 1) and ``ring2`` (the dx pass with a
  2-stage ring of staging, 108 KB: two blocks an SM instead of three,
  the same function). Each reports whether it gave the kernel's bits.
- K4's bfloat16 backward (``csrc/ssd_scan_bwd_bf16.cu``) at the same
  shapes, the whole gradient and each pass: ``one_part`` (every split
  operand in one bf16 part, the lo parts' products dropped: what the
  second parts cost) and the design's alternative ``cp_async`` (every
  tile by 16-byte cp.async instead of TMA, the same function, with a
  flag for the kernel's bits).
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
P3_LO = "      wgmma_bf16_rs<64 * NH>(acc, al[kk], bd);\n"
P5_INTER_LO = ("        wgmma_bf16_ss_n64(acc, cd, sw128_desc(sa(sl) + o, 16, "
               "1024));\n")
P5_LO = "        wgmma_bf16_rs_n64(acc, wlo[kk], xd);\n"
K4_BF16_CUTS = {
    "one_part": [(P3_LO, ""), (P5_INTER_LO, ""), (P5_LO, "")],
    "three_parts": [(P3_LO, P3_LO * 2), (P5_INTER_LO, P5_INTER_LO * 2),
                    (P5_LO, P5_LO * 2)],
    "no_exp": [("v.x * (rf * colv[sc])", "v.x"),
               ("v.y * (rf * colv[sc + 1])", "v.y"),
               ("v.x * (expf(ct_ - cumv[sp]) * dtv[sp])", "v.x"),
               ("v.y * (expf(ct_ - cumv[sp + 1]) * dtv[sp + 1])", "v.y")],
    "no_inter": [("const bool inter = !(c == 0 && a.init == nullptr);",
                  "const bool inter = false;")],
    "cp_async": [("int x_route(const SsdArgs& a) { return route(a.x, a.P); }",
                  "int x_route(const SsdArgs& a) { return LOAD_CP_ASYNC; }"),
                 ("  const int b = route(a.Bm, a.N), c = route(a.Cm, a.N);\n"
                  "  return b > c ? b : c;",
                  "  return LOAD_CP_ASYNC;")],
}
# the cuts that compute the same function
K4_BF16_SAME = ("cp_async",)
K3_BWD_CUTS = {
    "wg1": [("constexpr int WG = DP == 128 ? 1 : 2;",
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
K3_BWD_BF16_CUTS = {
    "one_part": [("        wgmma_bf16_rs<DP>(acc1, dl[j], y1d);\n", ""),
                 ("          wgmma_bf16_rs<DP>(acc2, pl[j], y2d);\n", "")],
    "cp_async": [("  return D >= ATOM ? LOAD_TMA : LOAD_CP_ASYNC;",
                  "  return LOAD_CP_ASYNC;")],
    "wg1": [("  return rows >= 256 && (DKDV || DP == 128) ? 2 : 1;",
             "  return 1;")],
}
# the cuts that compute the same function
K3_BWD_BF16_SAME = ("cp_async", "wg1")
K4_BWD_CUTS = {
    "hs1": [("#define BWD_BF16_LIB 0 ",
             "#define SSD_BWD_HSMAX 1\n#define BWD_BF16_LIB 0 ")],
    "one_pass": [
        ("  wgmma_rs_n64(acc, as, bb);\n  wgmma_rs_n64(acc, ab, smem_desc("
         "sb + W, (T / 8) * 128, 128));\n", ""),
        ("      wgmma_ss_n64(d, smem_desc(ay + W + o, (T / 8) * 128, "
         "128), bb);\n      wgmma_ss_n64(d, ab, smem_desc(bx + W + "
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
# K4's bfloat16 backward (csrc/ssd_scan_bwd_bf16.cu): every lo part's
# product dropped (one_part), every tile by cp.async instead of TMA
K4_BWD_BF16_CUTS = {
    "one_part": [
        ("      wgmma_bf16_rs<64 * NH>(acc, al[kk], bd);\n", ""),
        ("      wgmma_bf16_ss_n64(acc, bd, sw128_desc(sa(gl) + o, 16, "
         "1024));\n", ""),
        ("      wgmma_bf16_rs_n64(acc, wlo[kk], d);\n", ""),
        ("      wgmma_bf16_ss_n64_bt(hacc, ad,\n" + " " * 27
         + "sw128_desc(sa(sl) + kk * 16 * 128, TILE, 1024));\n", ""),
        ("      wgmma_bf16_rs_n64(acc, al[kk], d);\n", "")],
    "cp_async": [
        ("  const int x = route(a.x, a.P), y = route(a.dy, a.P);\n"
         "  return x > y ? x : y;", "  return LOAD_CP_ASYNC;"),
        ("  const int b = route(a.Bm, a.N), c = route(a.Cm, a.N);\n"
         "  return b > c ? b : c;", "  return LOAD_CP_ASYNC;")],
}
# the cuts that compute the same function
K4_BWD_BF16_SAME = ("cp_async",)
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


def _k3_bwd_cuts(dev, lib: str, symbol: str, cuts, dtype, same=()) -> dict:
    """K3's backward in ``dtype`` (the real kernel through
    ``flash_attention_bwd``, each cut of ``cuts`` through its own build of
    ``csrc/<lib>.cu``) at each shape of ``chip_smoke.K3_BWD_TIME``:
    CUDA-event medians and whether each cut gave the kernel's bits (an
    error where a cut in ``same`` did not)."""
    fns = {}
    for cut, edits in cuts.items():
        fn = getattr(ablated(lib, cut, edits), symbol)
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[cut] = fn
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, (shape, _) in C.K3_BWD_TIME.items():
        B, Sq, Skv, H, G, D, causal, window = shape
        q, do = (torch.randn((B, Sq, H, D), generator=gen, device=dev)
                 .to(dtype) for _ in range(2))
        k, v = (torch.randn((B, Skv, G, D), generator=gen, device=dev)
                .to(dtype) for _ in range(2))
        o, lse = FA.flash_attention_fwd_lse(q, k, v, causal=causal,
                                            window=window)
        want = FA.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                      window=window)
        got = [torch.empty_like(x) for x in (q, k, v)]
        delta = torch.empty((B, H, Sq), device=dev)

        def cut_call(fn):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                     *(x.data_ptr() for x in got), B, Sq, Skv, H, G, D,
                     int(causal), int(window or 0), D ** -0.5,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"K3 backward cut: cudaError {err}")
        res = {"kernel": C.cuda_ms(lambda: FA.flash_attention_bwd(
            q, k, v, o, do, lse, causal=causal, window=window), 20)}
        for cut, fn in fns.items():
            cut_call(fn)
            C.sync()
            res[cut + "_same_bits"] = all(torch.equal(a, b)
                                          for a, b in zip(got, want))
            res[cut] = C.cuda_ms(lambda: cut_call(fn), 20)
            if cut in same and not res[cut + "_same_bits"]:
                raise AssertionError(f"{lib} {name}: {cut} changed the "
                                     f"kernel's bits")
        out[f"{name}_{str(dtype)[6:]}"] = res
        del q, k, v, o, do, lse, want, got, delta
    return out


def k3_bwd(dev) -> dict:
    return _k3_bwd_cuts(dev, "flash_attention_bwd", "flash_attention_bwd",
                        K3_BWD_CUTS, torch.float32)


def k3_bwd_bf16(dev) -> dict:
    return _k3_bwd_cuts(dev, "flash_attention_bwd_bf16",
                        "flash_attention_bwd_bf16", K3_BWD_BF16_CUTS,
                        torch.bfloat16, K3_BWD_BF16_SAME)


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
            SSD._lib = lambda dtype=None, fns=fns: fns
            out[cut] = times()
    finally:
        SSD._lib = real
    return out


def k4_bf16(dev) -> dict:
    cuts = {cut: SSD.bind(ablated("ssd_scan_bf16", cut, edits))
            for cut, edits in K4_BF16_CUTS.items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    real = SSD._lib
    try:
        for name, shape in (("mamba2", C.SSD_TIME), ("hymba", C.HYMBA_SSD)):
            B, S, H, P, G, N, Q = shape
            *args, _ = C.ssd_inputs(B, S, H, P, G, N, gen, dev)
            args = [a.to(torch.bfloat16) if i != 2 else a
                    for i, a in enumerate(args)]
            want = SSD.ssd_scan(*args, chunk=Q)

            def times() -> dict:
                got = SSD.ssd_scan(*args, chunk=Q)
                C.sync()
                res = {"same_bits": all(torch.equal(a, b)
                                        for a, b in zip(got, want)),
                       "scan": C.cuda_ms(lambda: SSD.ssd_scan(*args,
                                                              chunk=Q), 20)}
                res.update(C._ssd_pass_ms(SSD, args, Q))
                return res
            res = {"kernel": times()}
            for cut, fns in cuts.items():
                SSD._lib = lambda dtype=None, fns=fns: fns
                res[cut] = times()
                SSD._lib = real
                if cut in K4_BF16_SAME and not res[cut]["same_bits"]:
                    raise AssertionError(f"k4_bf16 {name}: {cut} changed "
                                         f"the kernel's bits")
            out[name] = res
            del args, want
    finally:
        SSD._lib = real
    return out


def _k4_bwd_cuts(dev, lib: str, cuts, dtype, same=()) -> dict:
    """K4's backward in ``dtype`` (the real library, then each cut of
    ``cuts``, a build of ``csrc/<lib>.cu``, in its place) at each shape of
    ``chip_smoke.K4_BWD_TIME``: the whole gradient and each pass alone,
    CUDA-event medians, and whether each cut gave the kernel's bits (an
    error where a cut in ``same`` did not)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    cuts = {cut: SSD.bind_bwd(ablated(lib, cut, edits))
            for cut, edits in cuts.items()}
    out = {}
    real = SSD._bwd_lib
    try:
        for name, (B, S, H, P, G, N, Q) in C.K4_BWD_TIME.items():
            x, dt, A, Bm, Cm, _ = C.ssd_inputs(B, S, H, P, G, N, gen, dev)
            dy = torch.randn(x.shape, generator=gen, device=dev)
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
                SSD._bwd_lib = lambda dtype=None, fns=fns: fns
                res[cut] = times()
                SSD._bwd_lib = real
                if cut in same and not res[cut]["same_bits"]:
                    raise AssertionError(f"{lib} {name}: {cut} changed the "
                                         f"kernel's bits")
            out[f"{name}_{str(dtype)[6:]}"] = res
            del args, scr, want
    finally:
        SSD._bwd_lib = real
    return out


def k4_bwd(dev) -> dict:
    return _k4_bwd_cuts(dev, "ssd_scan_bwd", K4_BWD_CUTS, torch.float32)


def k4_bwd_bf16(dev) -> dict:
    return _k4_bwd_cuts(dev, "ssd_scan_bwd_bf16", K4_BWD_BF16_CUTS,
                        torch.bfloat16, K4_BWD_BF16_SAME)


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
    parts = {"k4": ("k4_ms", k4), "k4_bf16": ("k4_bf16_ms", k4_bf16),
             "k3": ("k3_ms", k3),
             "k3_bf16": ("k3_bf16_ms", k3_bf16),
             "k3_bwd": ("k3_bwd_ms", k3_bwd),
             "k3_bwd_bf16": ("k3_bwd_bf16_ms", k3_bwd_bf16),
             "k4_bwd": ("k4_bwd_ms", k4_bwd),
             "k4_bwd_bf16": ("k4_bwd_bf16_ms", k4_bwd_bf16),
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
