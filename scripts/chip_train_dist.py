#!/usr/bin/env python3
"""Training across cards alone: ``chip_smoke.py``'s build and
``train_dist`` phases, then the ``cuda`` tests of the NCCL worlds.

    python3 scripts/chip_train_dist.py       # from the repository root

One NCCL rank per visible card (as many as divide the global batch of
4 rows): on one card parts (a) and (c) of ``train_dist`` and part (d),
the model axis split over two gloo ranks on the card; with four cards
also (a) and (c) at (1, 4) and (2, 2), (e), mixtral-8x7b at (1, 4)
under ``moe_sharding="ep"``, and (b), llama3-8b at full depth; then
``time_split`` (K3 and K4 both ways at the split's local shapes).
``chip_smoke.py`` runs the same phases among all the others; this script
is the short way to run them on a machine with several cards. Prints
the phases' JSON lines and the tests' summary; exits non-zero on any
failure.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


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
    td = C.phase_train_dist(smi)
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
