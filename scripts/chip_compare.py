#!/usr/bin/env python3
"""Time K3 and K4 from two or more trees of this repository, in turns, on
one NVIDIA card.

    python3 scripts/chip_compare.py TREE [TREE ...]    # from the repo root

Each TREE is a checkout (for example a parent commit unpacked with
``git archive`` into a directory that ``.gitignore`` lists). Each runs
in a process of its own that imports that tree's ``repro_torch`` and
``chip_smoke`` and builds that tree's kernel sources into its own
``build/``, so two versions of a kernel never share a library. Give the
trees in turns (parent, change, change, parent) to see the spread
beside the difference.

Per tree, CUDA-event medians (``chip_smoke.cuda_ms``) in ms: K3 at the
serve prefill (B=4, S=2048, H=G=16, D=64, causal) and at the
Transform's shape (B=30, S=16, H=G=4, D=8), K4 at the mamba2-370m serve
prefill (B=4, S=2048, H=32, P=64, G=1, N=128, Q=256), each in float32
and, where the tree's wrapper takes them, with bfloat16 operands (K4:
x, dt, B and C). Then the serve path end to end: qwen1.5-0.5b at its
published config in float32 (random weights from seed 0), a warm prefill
of 4 x 2,048 tokens and 7 decode steps from its cache, each the median
of 3 on the host clock ending in a host read. Prints one JSON line per
tree, then the card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys

CHILD = r"""
import json, sys
root = sys.argv[1]
sys.path[:0] = [root + "/src", root]
import torch
import chip_smoke as C
from repro_torch.kernels import flash_attention as FA, ssd as SSD
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(5)
out = {"tree": root}


def time_or_none(fn, reps):
    try:
        fn()
    except TypeError:                 # a dtype the tree's wrapper refuses
        return None
    return C.cuda_ms(fn, reps)


for name, shape, reps in (("k3_serve", C.ATTN_TIME, 30),
                          ("k3_transform", C.ATTN_SMALL, 200)):
    B, S, H, D = shape
    q, k, v = (torch.randn((B, S, H, D), generator=gen, device=dev)
               for _ in range(3))
    out[name] = C.cuda_ms(lambda: FA.flash_attention(q, k, v), reps)
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    out[name + "_bf16"] = time_or_none(
        lambda: FA.flash_attention(qb, kb, vb), reps)
B, S, H, P, G, N, Q = C.SSD_TIME
*args, _ = C.ssd_inputs(B, S, H, P, G, N, gen, dev)
out["k4"] = C.cuda_ms(lambda: SSD.ssd_scan(*args, chunk=Q), 30)
bf = [a if i == 2 else a.bfloat16() for i, a in enumerate(args)]
out["k4_bf16"] = time_or_none(lambda: SSD.ssd_scan(*bf, chunk=Q), 30)
del args, bf

import statistics
import time
from repro_torch.configs.base import get
from repro_torch.models.model import Model
from repro_torch.models.options import RunOptions
cfg = get("qwen1.5-0.5b")
model = Model(cfg, RunOptions(remat="none", compute_dtype="float32",
                              q_chunk=64, kv_chunk=64))
params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
toks = torch.randint(0, cfg.vocab, (4, 2048), generator=gen, device=dev)


def host_s(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


with torch.no_grad():
    host_s(lambda: model.prefill(params, {"tokens": toks}, cache_len=2056))
    pre, dec = [], []
    for _ in range(3):
        s, (nxt, cache) = host_s(lambda: model.prefill(
            params, {"tokens": toks}, cache_len=2056))
        pre.append(s)

        def decode(nxt=nxt, cache=cache):
            for _ in range(7):
                nxt, cache = model.decode_step(params, cache, nxt)
            return nxt.cpu()
        dec.append(host_s(decode)[0])
out["serve_prefill_s"] = statistics.median(pre)
out["serve_decode7_s"] = statistics.median(dec)
print(json.dumps(out), flush=True)
"""


def main() -> int:
    trees = sys.argv[1:]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for tree in trees:
        r = subprocess.run([sys.executable, "-c", CHILD, tree],
                           capture_output=True, text=True, timeout=900)
        lines = r.stdout.strip().splitlines()
        if r.returncode != 0 or not lines:
            print(f"chip_compare: {tree} failed:\n{r.stderr[-3000:]}",
                  file=sys.stderr)
            rc = 1
            continue
        print(lines[-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(json.dumps({"nvidia_smi": smi.stdout.strip()}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
