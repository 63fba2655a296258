#!/usr/bin/env python3
"""K3's backward times from two checkouts on one card, in turns.

    python3 scripts/chip_k3_bwd_bf16.py PARENT [CHANGE]   # repository root

PARENT and CHANGE are checkouts of the repository (CHANGE defaults to
the one this script is in), e.g. a parent commit unpacked with ``git
archive`` into a directory that ``.gitignore`` lists. The script runs,
in a fresh process for each and in the order parent, change, change,
parent, that checkout's own ``flash_attention_bwd`` (its kernels built
into its own ``build/``) at each shape of the checkout's
``chip_smoke.K3_BWD_TIME`` (qwen1.5-0.5b's and mixtral-8x7b's training
shapes, whisper-large-v3's encoder), bfloat16 and float32, on inputs
drawn on the card from one seed, timed by ``chip_smoke.cuda_ms`` (a
CUDA-event median of 20 warm launches), and hashes each dtype's
gradients. Each run's lines go to ``build/k3_bwd_bf16/<i>_<label>.jsonl``.
It prints one JSON line: for every shape and dtype, the kernel's median
in each run, whether the two checkouts gave the same bits, and the
card's name and power limit. Any failure of a run fails the script.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "k3_bwd_bf16"

# run inside the checkout, with its own chip_smoke and package
RUN = """
import hashlib, json, sys, torch
sys.path[:0] = [{root!r}, {root!r} + "/src"]
import chip_smoke as C
from repro_torch.kernels import flash_attention as FA
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
for name, (shape, _) in C.K3_BWD_TIME.items():
    B, Sq, Skv, H, G, D, causal, window = shape
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(35)
        q, do = (torch.randn((B, Sq, H, D), generator=gen, device=dev)
                 .to(dtype) for _ in range(2))
        k, v = (torch.randn((B, Skv, G, D), generator=gen, device=dev)
                .to(dtype) for _ in range(2))
        o, lse = FA.flash_attention_fwd_lse(q, k, v, causal=causal,
                                            window=window)
        call = lambda: FA.flash_attention_bwd(q, k, v, o, do, lse,
                                              causal=causal, window=window)
        h = hashlib.sha256()
        for g in call():
            h.update(g.float().cpu().numpy().tobytes())
        print(json.dumps({{"shape": name, "dtype": str(dtype)[6:],
                          "kernel_ms": C.cuda_ms(call, 20),
                          "digest": h.hexdigest()[:16]}}), flush=True)
"""


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
        proc = subprocess.run([sys.executable, "-c",
                               RUN.format(root=str(root))], cwd=root,
                              capture_output=True, text=True, timeout=900)
        (OUT / f"{i}_{label}.jsonl").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            print(proc.stdout[-3000:], proc.stderr[-6000:], file=sys.stderr)
            raise SystemExit(f"chip_k3_bwd_bf16: run {i} ({label}) failed")
        rows = [json.loads(ln) for ln in proc.stdout.splitlines()
                if ln.startswith("{")]
        runs.append((label, {(r["shape"], r["dtype"]): r for r in rows}))
    table = {}
    for key in runs[1][1]:
        digests = {label: rows[key]["digest"] for label, rows in runs}
        table[f"{key[0]} {key[1]}"] = {
            "kernel_ms": [[label, rows[key]["kernel_ms"]]
                          for label, rows in runs],
            "same_bits_as_parent": digests["parent"] == digests["change"]}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"device": smi, "order": [r[0] for r in runs],
                      "k3_bwd": table}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
