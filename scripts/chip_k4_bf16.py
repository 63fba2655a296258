#!/usr/bin/env python3
"""K4's times from two checkouts on one card, in turns.

    python3 scripts/chip_k4_bf16.py [--backward] PARENT [CHANGE]   # root

PARENT and CHANGE are checkouts of the repository (CHANGE defaults to
the one this script is in), e.g. a parent commit unpacked with ``git
archive`` into a directory that ``.gitignore`` lists. The script runs,
in a fresh process for each and in the order parent, change, change,
parent, that checkout's own ``chip_smoke.py`` timing of K4
(``_time_ssd``, its kernels built into its own ``build/``) at
mamba2-370m's serve prefill (``SSD_TIME``) and hymba-1.5b's
(``HYMBA_SSD``), float32 and bfloat16, and each of the five passes alone
in bfloat16; each bfloat16 run's y and final state are held first to
that checkout's ``error_bound`` against the plain version in float64, and
the float32 kernels' y and final state are hashed, so that the runs show
whether the float32 library's bits moved.
Each run's phase lines go to ``build/k4_bf16/<i>_<label>.jsonl``. It
prints one JSON line: for every shape and dtype, the kernel's CUDA-event
median in each run and the passes' in each bfloat16 run, the plain
version's and the bounds (the bfloat16 kernels' own floor too), and the
card's name and power limit. Any failure of a run (a kernel outside its
bound included) fails the script.

With ``--backward`` each run times K4's backward instead
(``ssd_scan_bwd`` on the checkout's own forward scratch) at the shapes of
its ``chip_smoke.K4_BWD_TIME`` (mamba2-370m's and hymba-1.5b's training
shapes), bfloat16 and float32 operands drawn on the card from one seed:
the nine passes together and each alone (CUDA-event medians), every
gradient held to that checkout's ``bwd_error_bound`` against the plain
backward in float64, and each dtype's gradients hashed, so that the runs
show whether the float32 library's bits moved. Its lines go to
``build/k4_bwd_bf16/<i>_<label>.jsonl``.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "k4_bf16"

# run inside the checkout, with its own chip_smoke and package
RUN = """
import hashlib, json, sys, torch
sys.path[:0] = [{root!r}, {root!r} + "/src"]
import chip_smoke as C
from repro_torch.kernels import build
from repro_torch.kernels import ssd as SSD
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
build.load_all([n for n in build.sources() if n.startswith("ssd_scan")])
gen = torch.Generator(device=dev).manual_seed(6)
out = {{}}
for name, shape in (("mamba2", C.SSD_TIME), ("hymba", C.HYMBA_SSD)):
    B, S, H, P, G, N, Q = shape
    *args, _ = C.ssd_inputs(B, S, H, P, G, N, gen, dev)
    bf = [a.to(torch.bfloat16) if i != 2 else a for i, a in enumerate(args)]
    y, state = SSD.ssd_scan(*args, chunk=Q)
    digest = hashlib.sha256(y.cpu().numpy().tobytes()
                            + state.cpu().numpy().tobytes()).hexdigest()
    y, state = SSD.ssd_scan(*bf, chunk=Q)
    C.sync()
    want_y, want_state = SSD.ssd_scan_ref(*(a.double() for a in bf),
                                          chunk=Q)
    tol_y, tol_state = SSD.error_bound(*bf, chunk=Q, ref_y=want_y)
    of_y = float(((y.double() - want_y).abs() / tol_y).max())
    of_state = float((state.double() - want_state).abs().max()) / tol_state
    if not (of_y <= 1.0 and of_state <= 1.0):
        raise AssertionError(f"K4 bf16 {{name}}: y at {{of_y}}, state at "
                             f"{{of_state}} of their bounds")
    del y, state, want_y, want_state, tol_y
    rec = C._time_ssd(SSD, args, shape)
    x, Bm = bf[0], bf[3]
    yb = torch.empty_like(x)
    sb = torch.empty((B, H, P, N), device=dev)
    scr = SSD.scratch(x, Bm, Q)
    for p in SSD.PASSES:
        SSD.launch(p, *bf, None, yb, sb, scr, Q)
    rec["bf16"]["pass_ms"] = {{p: C.cuda_ms(lambda p=p: SSD.launch(
        p, *bf, None, yb, sb, scr, Q), 20) for p in SSD.PASSES}}
    rec["bf16"]["of_bound"] = max(of_y, of_state)
    rec["float32_digest"] = digest
    out[name] = rec
    del args, bf, x, Bm, yb, sb, scr
C.emit("time_k4_bf16", ssd_scan=out)
"""


# --backward: run inside the checkout, with its own chip_smoke and package
RUN_BWD = """
import hashlib, json, sys, torch
sys.path[:0] = [{root!r}, {root!r} + "/src"]
import chip_smoke as C
from repro_torch.kernels import ssd as SSD
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
for name, shape in C.K4_BWD_TIME.items():
    B, S, H, P, G, N, Q = shape
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(36)
        x, dt, A, Bm, Cm, _ = C.ssd_inputs(B, S, H, P, G, N, gen, dev)
        dy = torch.randn(x.shape, generator=gen, device=dev)
        args = [a.to(dtype) if i != 2 else a
                for i, a in enumerate((x, dt, A, Bm, Cm, dy))]
        _, _, scr = SSD._forward(*args[:5], None, Q)
        call = lambda: SSD.ssd_scan_bwd(*args, None, scr, chunk=Q)
        got = call()
        C.sync()
        h = hashlib.sha256()
        for g in got:
            if g is not None:
                h.update(g.float().cpu().numpy().tobytes())
        want = SSD.ssd_scan_bwd_ref(*(a.double() for a in args), chunk=Q)
        bound = SSD.bwd_error_bound(*args, chunk=Q, refs=want)
        of_bound = max(float(((g.double() - w).abs() / b).max())
                       for g, w, b in zip(got, want, bound) if g is not None)
        if not of_bound <= 1.0:
            raise AssertionError(f"K4 backward {{name}} {{dtype}}: "
                                 f"{{of_bound}} of its bound")
        del want, bound
        work = SSD.bwd_scratch(args[0], args[3], Q)
        passes = {{p: C.cuda_ms(lambda p=p: SSD.launch_bwd(
            p, *args, None, scr, got, work, Q), 20) for p in SSD.BWD_PASSES}}
        print(json.dumps({{"shape": name, "dtype": str(dtype)[6:],
                          "kernel_ms": C.cuda_ms(call, 20),
                          "pass_ms": passes, "of_bound": of_bound,
                          "digest": h.hexdigest()[:16]}}), flush=True)
        del args, scr, got, work
"""


def _backward(trees) -> int:
    """``--backward``: the runs in turns, one JSON line."""
    out = ROOT / "build" / "k4_bwd_bf16"
    out.mkdir(parents=True, exist_ok=True)
    runs = []
    for i, label in enumerate(("parent", "change", "change", "parent")):
        root = trees[label]
        proc = subprocess.run([sys.executable, "-c",
                               RUN_BWD.format(root=str(root))], cwd=root,
                              capture_output=True, text=True, timeout=900)
        (out / f"{i}_{label}.jsonl").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            print(proc.stdout[-3000:], proc.stderr[-6000:], file=sys.stderr)
            raise SystemExit(f"chip_k4_bf16 --backward: run {i} ({label}) "
                             f"failed")
        rows = [json.loads(ln) for ln in proc.stdout.splitlines()
                if ln.startswith("{")]
        runs.append((label, {(r["shape"], r["dtype"]): r for r in rows}))
    table = {}
    for key in runs[1][1]:
        digests = {label: rows[key]["digest"] for label, rows in runs}
        table[f"{key[0]} {key[1]}"] = {
            "kernel_ms": [[label, rows[key]["kernel_ms"]]
                          for label, rows in runs],
            "pass_ms": [[label, rows[key]["pass_ms"]] for label, rows in runs],
            "of_bound": [[label, rows[key]["of_bound"]]
                         for label, rows in runs],
            "same_bits_as_parent": digests["parent"] == digests["change"]}
    print(json.dumps({"device": _smi(), "order": [r[0] for r in runs],
                      "k4_bwd": table}), flush=True)
    return 0


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def _rows(lines) -> dict:
    """{shape and dtype: the _time_ssd record} of one run's phase line."""
    for line in lines:
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict) and rec.get("phase") == "time_k4_bf16":
            rows = {}
            for name, r in rec["ssd_scan"].items():
                rows[name] = {k: v for k, v in r.items() if k != "bf16"}
                rows[name + " bf16"] = r["bf16"]
            return rows
    raise ValueError("no time_k4_bf16 line")


def main() -> int:
    argv = sys.argv[1:]
    backward = argv[:1] == ["--backward"]
    argv = argv[backward:]
    if len(argv) not in (1, 2):
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"parent": Path(argv[0]).resolve(),
             "change": Path(argv[1] if len(argv) == 2 else ROOT).resolve()}
    if backward:
        return _backward(trees)
    OUT.mkdir(parents=True, exist_ok=True)
    runs = []
    for i, label in enumerate(("parent", "change", "change", "parent")):
        root = trees[label]
        proc = subprocess.run([sys.executable, "-c",
                               RUN.format(root=str(root))], cwd=root,
                              capture_output=True, text=True, timeout=600)
        (OUT / f"{i}_{label}.jsonl").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            print(proc.stdout[-3000:], proc.stderr[-6000:], file=sys.stderr)
            raise SystemExit(f"chip_k4_bf16: run {i} ({label}) failed")
        runs.append((label, _rows(proc.stdout.splitlines())))
    keys = ("plain_ms", "bound_ms", "bound_by", "bound_design_ms",
            "bound_3xtf32_ms", "of_bound")
    table = {}
    for name in runs[1][1]:
        table[name] = {
            "kernel_ms": [[label, rows[name]["kernel_ms"]]
                          for label, rows in runs],
            **{k: runs[1][1][name][k] for k in keys
               if k in runs[1][1][name]}}
        if "pass_ms" in runs[1][1][name]:
            table[name]["pass_ms"] = [[label, rows[name]["pass_ms"]]
                                      for label, rows in runs]
    for name in runs[1][1]:
        if "float32_digest" in runs[1][1][name]:
            table[name]["float32_same_bits"] = len(
                {rows[name]["float32_digest"] for _, rows in runs}) == 1
    print(json.dumps({"device": _smi(), "order": [r[0] for r in runs],
                      "k4": table}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
