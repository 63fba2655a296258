#!/usr/bin/env python3
"""Serving across cards: ``chip_smoke.py``'s build and ``serve_dist``
phases, then, with four cards, its four-card parts; K3 at qwen1.5-110b's
local prefill shape; the dry run's account of the same cells beside what
they counted; and the ``cuda`` tests of the NCCL worlds.

    python3 scripts/chip_serve_dist.py       # from the repository root

On one card: part (a), llama3-8b cut to 2 layers and mamba2-370m over
two gloo ranks on the card (``phase_serve_dist``). With four cards also
(b), llama3-8b at full depth at (1, 4) and (2, 2), and (c), qwen1.5-110b
at its published width, 2 layers at (1, 4) against one card, then all
80 layers at (1, 4) (``phase_serve_dist_cards``). Then K3 (bfloat16) at
the local shape of qwen1.5-110b's prefill at (1, 4): B 4, S 2,048, 16
query heads over 2 kv heads of 128, against its plain version and SDPA.
Then ``launch.dryrun.run_step`` on ``meta`` (the host's CPU, no card)
at each part's model, mesh and shapes and at PR 30's llama3-8b train
step at (2, 2) (4 x 2,048 tokens, the launcher's options): its bytes a
rank beside the bytes the steps counted. Prints the phases' JSON lines,
the account's and the tests' summary, and the card's name and power
limit; exits non-zero on any failure.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def account(parts):
    """The account's bytes a rank for each measured part (its prefill
    with the decode steps' room, one decode step against that cache),
    beside the measured, and for llama3-8b's train step (the launcher's
    options, 4 x 2,048 tokens) at PR 30's (2, 2) and at (1, 4). Needs
    no card: ``account([])`` prints the train cells alone."""
    from repro_torch.configs.base import get
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import train as LT
    from repro_torch.launch.mesh import AccountMesh
    from repro_torch.models.model import Model
    from repro_torch.models.options import RunOptions
    import chip_smoke as C
    B, S, n_gen = (C.SERVE_DIST[k] for k in ("batch", "prompt_len", "gen"))
    out = []
    cells = [(p["arch"], p["layers"], tuple(p["mesh"]), p) for p in parts]
    cells += [("llama3-8b", 32, (2, 2), None), ("llama3-8b", 32, (1, 4),
                                                  None)]
    for arch, layers, mesh, measured in cells:
        cfg = dataclasses.replace(get(arch), n_layers=layers)
        am = AccountMesh(mesh, ("data", "model"))
        rec = {"arch": arch, "layers": layers, "mesh": list(mesh)}
        if measured is None:
            model = Model(cfg, LT.train_options(S))
            rec["train"] = DR.run_step(model, ShapeSpec(
                "train", "train", S, B), am)
        else:
            fp8 = "qwen" in arch
            model = Model(cfg, RunOptions(param_dtype="bfloat16",
                                          kv_cache_dtype=C.FP8 if fp8
                                          else ""))
            rec["prefill"] = DR.run_step(model, ShapeSpec(
                "prefill", "prefill", S, B), am, cache_len=S + n_gen)
            rec["decode"] = DR.run_step(model, ShapeSpec(
                "decode", "decode", S + n_gen, B), am)
            rec["measured"] = {"prefill": measured["bytes_prefill"],
                               "decode": measured["bytes_decode_step"]}
        out.append(rec)
        print("account", json.dumps(rec), flush=True)
    return out


def cuda_draws(dev):
    """Whether ``init_params``' layer-slice draws equal ``Model.init``'s
    whole-leaf draws on a CUDA generator (seed 0), leaf by leaf, for the
    reduced qwen1.5-0.5b and mamba2-370m."""
    import torch
    from repro_torch.configs.base import get
    from repro_torch.models.model import Model, _leaves
    from repro_torch.runtime.steps import init_params
    out = {}
    for arch in ("qwen1.5-0.5b", "mamba2-370m"):
        model = Model(get(arch).reduced())
        a = init_params(model, torch.Generator(device=dev).manual_seed(0),
                        dev)
        b = model.init(torch.Generator(device=dev).manual_seed(0), dev)
        same = [torch.equal(x, y) for (_, x), (_, y) in
                zip(_leaves(a), _leaves(b))]
        out[arch] = {"leaves": len(same), "equal": sum(same)}
    return out


def main() -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    import torch.nn.functional as F
    import chip_smoke as C
    if not torch.cuda.is_available():
        print("chip_serve_dist: no CUDA device is visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import flash_attention as FA
    t0 = time.perf_counter()
    smi = C.phase_device()
    C.phase_build()
    C.phase_serve_dist(smi)
    parts = []
    if torch.cuda.device_count() >= 4:
        parts = C.phase_serve_dist_cards(smi)["parts"]
    else:
        print("serve_dist_cards: skipped, parts (b) and (c) need 4 cards; "
              f"{torch.cuda.device_count()} visible", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(31)
    k3 = C._time_k3(FA, F, (4, 2048, 16, 128), gen, dev, reps=20,
                    dtype=torch.bfloat16, kv_heads=2)
    C.emit("time_k3_qwen110b_local", flash_attention=k3, nvidia_smi=smi)
    C.emit("init_params_cuda_draws", **cuda_draws(dev))
    account(parts)
    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-m", "cuda", "tests/test_torch_cuda.py", "-k", "nccl"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    print(f"seconds {time.perf_counter() - t0:.1f}", flush=True)
    print(smi, flush=True)
    return tests.returncode


if __name__ == "__main__":
    sys.exit(main())
