#!/usr/bin/env python3
"""Profile one warm prefill of each serve model on one NVIDIA card:
where the device time goes, and how much of the prefill the device is
idle.

    python3 scripts/chip_profile.py [--arch NAME ...] [--dtype bfloat16]

For each model (qwen1.5-0.5b, mamba2-370m and hymba-1.5b at their
published configs, random weights from seed 0, ``RunOptions`` with the
given compute dtype, bfloat16 by default as the models run), the serve
phases' first batch of prompts (``chip_smoke.SERVE``: 4 x 2,048 tokens
of the corpus) goes through one prefill to warm up, three timed on the
host between two synchronisations, then one under ``torch.profiler``
(CPU and CUDA activity). Prints one JSON line per model:

- ``wall_ms``: the median of the three unprofiled prefills, host clock
  (``profiled_wall_ms``: the profiled one, which the profiler's host
  work slows);
- ``device_ms``: the kernels' device time summed by group: K3
  (``fa_fwd_kernel``), K4 (``ssd_*_kernel``), GEMMs (cuBLAS's, CUTLASS
  and ``nvjet`` kernels) and the rest (elementwise, norms, reductions, copies), with
  the rest's ten largest kernels;
- ``idle_share``: 1 - summed device time / ``wall_ms`` (one stream, so
  the kernels do not overlap; the device time is taken as the same with
  and without the profiler).

Then the card's name and power limit. Fails when the profiler records no
device time.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as C  # noqa: E402

ARCHS = ("qwen1.5-0.5b", "mamba2-370m", "hymba-1.5b")
GEMM = re.compile(r"gemm|xmma|cutlass|cublas|gemv|nvjet", re.I)


def group(name: str) -> str:
    if name.startswith("fa_fwd_kernel") or "fa_fwd_kernel" in name:
        return "k3"
    if re.search(r"ssd_\w+_kernel", name):
        return "k4"
    if GEMM.search(name):
        return "gemm"
    return "other"


def device_us(evt) -> float:
    """A kernel's device time; 0 for the CPU-side ops that launched it
    (their device time is their kernels', counted once here)."""
    if evt.device_type != torch.autograd.DeviceType.CUDA:
        return 0.0
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile_prefill(arch: str, dtype: str, dev) -> dict:
    from repro_torch.configs.base import get
    from repro_torch.data.tokens import SyntheticCorpus
    from repro_torch.models.model import Model
    from repro_torch.models.options import RunOptions
    cfg = get(arch)
    model = Model(cfg, RunOptions(compute_dtype=dtype))
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    toks = C.first_batch(SyntheticCorpus(cfg.vocab, 0), params)
    cache_len = C.SERVE["prompt_len"] + C.SERVE["gen"]

    def prefill():
        return model.prefill(params, {"tokens": toks},
                             cache_len=cache_len)[0].cpu()

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    with torch.no_grad():
        prefill()
        wall = statistics.median(timed() for _ in range(3))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            profiled = timed()
    groups = {"k3": 0.0, "k4": 0.0, "gemm": 0.0, "other": 0.0}
    other = {}
    for evt in prof.key_averages():
        us = device_us(evt)
        if us <= 0:
            continue
        g = group(evt.key)
        groups[g] += us
        if g == "other":
            other[evt.key] = other.get(evt.key, 0.0) + us
    total = sum(groups.values())
    if total <= 0:
        raise SystemExit(f"{arch}: the profiler recorded no device time")
    top = sorted(other.items(), key=lambda kv: -kv[1])[:10]
    del params
    torch.cuda.empty_cache()
    return {"arch": arch, "dtype": dtype, "layers": cfg.n_layers,
            "wall_ms": wall * 1e3, "profiled_wall_ms": profiled * 1e3,
            "device_ms": {k: v / 1e3 for k, v in groups.items()},
            "device_total_ms": total / 1e3,
            "idle_share": 1.0 - total / 1e3 / (wall * 1e3),
            "other_top_ms": [[k[:120], v / 1e3] for k, v in top]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="*", default=list(ARCHS))
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device is visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    for arch in args.arch:
        print(json.dumps(profile_prefill(arch, args.dtype, dev)),
              flush=True)
    print(C.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
