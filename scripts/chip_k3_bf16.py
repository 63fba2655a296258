#!/usr/bin/env python3
"""K3's times from two checkouts on one card, in turns.

    python3 scripts/chip_k3_bf16.py PARENT [CHANGE]     # repository root

PARENT and CHANGE are checkouts of the repository (CHANGE defaults to
the one this script is in), e.g. a parent commit unpacked with ``git
archive`` into a directory that ``.gitignore`` lists. The script runs,
in a fresh process for each and in the order parent, change, change,
parent, that checkout's own ``chip_smoke.py`` timing of K3 (its kernels
built into its own ``build/``): the phases ``time_k2_k3`` (qwen1.5-0.5b's
prefill shape and the Transform's, float32 and bfloat16),
``time_hybrid`` (hymba-1.5b's window and global layers), ``time_moe``
(mixtral-8x7b) and ``time_encdec`` (whisper-large-v3's four shapes and
a 2-layer llama3-8b bf16 prefill), then ``_time_k3`` at the model axis's
local shapes: llama3-8b's at (1, 4) in float32 (``SPLIT_K3``) and
qwen1.5-110b's at (1, 4) in bfloat16 (B 4, S 2,048, H 16, G 2, D 128).
Each run's phase lines go to ``build/k3_bf16/<i>_<label>.jsonl``.
It prints one JSON line: for every K3 shape and dtype, the kernel's
CUDA-event median in each run, SDPA's, the plain version's and the
bounds, and the card's name and power limit. Any failure of a run (a
kernel outside its bound included) fails the script.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "k3_bf16"
QWEN110B_LOCAL = (4, 2048, 16, 2, 128)       # B, S, H, G, D

# run inside the checkout, with its own chip_smoke and package
RUN = """
import json, sys, torch
sys.path[:0] = [{root!r}, {root!r} + "/src"]
import chip_smoke as C
import torch.nn.functional as F
from repro_torch.kernels import flash_attention as FA
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
C.phase_build()
C.phase_time_k2_k3(dev)
C.phase_time_hybrid(dev)
C.phase_time_moe(dev)
C.phase_time_encdec(dev)
gen = torch.Generator(device=dev).manual_seed(30)
B, S, H, G, D = C.SPLIT_K3
split = C._time_k3(FA, F, (B, S, H, D), gen, dev, reps=20, kv_heads=G)
B, S, H, G, D = {qwen110b!r}
serve = C._time_k3(FA, F, (B, S, H, D), gen, dev, reps=20, kv_heads=G,
                   dtype=torch.bfloat16)
C.emit("time_k3_split", flash_attention=split,
       flash_attention_serve_bf16=serve)
"""


def _rows(lines) -> dict:
    """{shape name: the _time_k3 record} of one run's phase lines."""
    ph = {}
    for line in lines:
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict) and "phase" in rec:
            ph[rec["phase"]] = rec
    rows = {}

    def add(name, rec):
        rows[name] = rec
        if "bf16" in rec:
            rows[name + " bf16"] = rec["bf16"]
    add("qwen", ph["time_k2_k3"]["flash_attention"])
    rows["transform"] = ph["time_k2_k3"]["flash_attention"][
        "transform_shape"]
    for kind in ("window", "global"):
        add(f"hymba {kind}", ph["time_hybrid"]["flash_attention"][kind])
    add("mixtral", ph["time_moe"]["flash_attention"])
    for name, rec in ph["time_encdec"]["flash_attention"].items():
        add(f"whisper {name}", rec)
    rows["llama3-8b split"] = ph["time_k3_split"]["flash_attention"]
    rows["qwen1.5-110b local bf16"] = ph["time_k3_split"][
        "flash_attention_serve_bf16"]
    return rows


def main() -> int:
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"parent": Path(sys.argv[1]).resolve(),
             "change": Path(sys.argv[2] if len(sys.argv) == 3
                            else ROOT).resolve()}
    OUT.mkdir(parents=True, exist_ok=True)
    runs = []
    for i, label in enumerate(("parent", "change", "change", "parent")):
        root = trees[label]
        code = RUN.format(root=str(root), qwen110b=QWEN110B_LOCAL)
        proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                              capture_output=True, text=True, timeout=900)
        (OUT / f"{i}_{label}.jsonl").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            print(proc.stdout[-3000:], proc.stderr[-6000:], file=sys.stderr)
            raise SystemExit(f"chip_k3_bf16: run {i} ({label}) failed")
        runs.append((label, _rows(proc.stdout.splitlines())))
    keys = ("kernel_ms", "library_ms", "plain_ms", "bound_ms",
            "bound_design_ms", "of_bound", "launch")
    table = {}
    for name in runs[1][1]:
        table[name] = {
            "kernel_ms": [[label, rows[name]["kernel_ms"]]
                          for label, rows in runs if name in rows],
            **{k: runs[1][1][name][k] for k in keys[1:]
               if k in runs[1][1][name]}}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"device": smi, "order": [r[0] for r in runs],
                      "k3": table}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
