#!/usr/bin/env python3
"""Run each example of the PyTorch/CUDA port (``examples/*_torch.py``
but the training one) at its default size on the card, each in its own
process, and time it on the host clock (interpreter start-up and any
kernel build included).

    python3 scripts/chip_examples.py [NAME ...]

Prints one JSON line per example (``name``, ``rc``, ``seconds`` and its
last printed line), then the card's name and power limit; exits 1 if an
example failed. Each example's full output goes to
``chiprun_out/example_<name>.log``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

EXAMPLES = ("quickstart", "serve_vetl", "vetl_ingest", "vetl_query",
            "vetl_alerts", "vetl_observe", "vetl_pool_scale")


def main(argv=None) -> int:
    names = (argv if argv is not None else sys.argv[1:]) or EXAMPLES
    import chip_smoke as C
    logs = ROOT / "chiprun_out"
    logs.mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    failed = 0
    for name in names:
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, str(ROOT / "examples" / f"{name}_torch.py")],
            env=env, capture_output=True, text=True)
        secs = time.perf_counter() - t0
        (logs / f"example_{name}.log").write_text(p.stdout + p.stderr)
        last = (p.stdout.strip().splitlines() or [""])[-1]
        failed += p.returncode != 0
        print(json.dumps({"name": name, "rc": p.returncode,
                          "seconds": secs, "last": last[:200]}), flush=True)
    print(C.nvidia_smi(), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
