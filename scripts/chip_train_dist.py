#!/usr/bin/env python3
"""Training across cards alone: ``chip_smoke.py``'s build and
``train_dist`` phases, then the ``cuda`` tests of the NCCL worlds.

    python3 scripts/chip_train_dist.py       # from the repository root

One NCCL rank per visible card (as many as divide the global batch of
4 rows): on one card parts (a) and (c) of ``train_dist`` and part (d),
the model axis split over two gloo ranks on the card, and (d seq), the
same sequence-split (``seq_shard_activations``); with four cards also
(a) and (c) at (1, 4) and (2, 2), (e), mixtral-8x7b at (1, 4) under
``moe_sharding="ep"``, (b), llama3-8b at full depth at (2, 2), (b seq)
the same sequence-split, and (f), llama3-8b at full depth at (1, 4)
sequence-split; then ``time_split`` (K3 and K4 both ways at the split's
local shapes). Then the dry run's account (``launch.dryrun.run_step``
on ``meta``, the host's CPU) of each llama3-8b part beside what it
measured: bytes gathered, reduced and over ``"model"`` a rank a step,
and the bytes autograd saves (``saved_bytes``) beside the peak.
``chip_smoke.py`` runs the same phases among all the others; this script
is the short way to run them on a machine with several cards. Prints
the phases' JSON lines and the tests' summary; exits non-zero on any
failure.
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
    """The account of each measured llama3-8b part of ``train_dist``
    (its layers, mesh and flag, the launcher's options, 4 x 2,048
    tokens) beside what it measured; with no parts (``account({})``, no
    card needed) the four-card parts' cells alone."""
    from repro_torch.configs.base import get
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import train as LT
    from repro_torch.launch.mesh import AccountMesh
    from repro_torch.models.model import Model
    import chip_smoke as C
    B, S = C.TRAIN_DIST["batch"], C.TRAIN_DIST["seq"]
    cells = {"d": (C.TRAIN_DIST_SPLIT_LAYERS, (1, 2), False),
             "d seq": (C.TRAIN_DIST_SPLIT_LAYERS, (1, 2), True),
             "b": (32, C.TRAIN_DIST_B_MESH, False),
             "b seq": (32, C.TRAIN_DIST_B_MESH, True),
             "f": (32, (1, 4), True)}
    out = {}
    for name, (layers, mesh, seq) in cells.items():
        measured = parts.get(name)
        if parts and (measured is None or "losses" not in measured):
            continue
        cfg = dataclasses.replace(get("llama3-8b"), n_layers=layers)
        model = Model(cfg, dataclasses.replace(LT.train_options(S),
                                               seq_shard_activations=seq))
        rec = DR.run_step(model, ShapeSpec("train", "train", S, B),
                          AccountMesh(mesh, ("data", "model")))
        out[name] = {"layers": layers, "mesh": list(mesh), "seq": seq,
                     "account": {"bytes": rec["collectives"],
                                 "argument_bytes":
                                     rec["memory"]["argument_bytes"],
                                 "saved_bytes": rec["memory"]["saved_bytes"]}}
        if measured is not None:
            out[name]["measured"] = {
                k: measured[k] for k in ("step_s_median", "tok_per_s",
                                         "peak_mem_bytes", "bytes_per_step")}
        print("account", name, json.dumps(out[name]), flush=True)
    return out


def main() -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    import chip_smoke as C
    if not torch.cuda.is_available():
        print("chip_train_dist: no CUDA device is visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    smi = C.phase_device()
    C.phase_build()
    try:
        td = C.phase_train_dist(smi)
    finally:
        account(C.LAST_PARTS)
    print("launches", td, flush=True)
    C.phase_time_split(torch.device("cuda"), td)
    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-m", "cuda", "tests/test_torch_cuda.py", "-k", "nccl"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    print(f"seconds {time.perf_counter() - t0:.1f}", flush=True)
    print(smi, flush=True)
    return tests.returncode


if __name__ == "__main__":
    sys.exit(main())
